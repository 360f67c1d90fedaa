"""The paper's Fashion-MNIST CNN (§IV-A) — exactly 21 840 parameters.

conv1 1->10 (5x5) -> maxpool 2x2 -> ReLU
conv2 10->20 (5x5) [dropout] -> maxpool 2x2 -> ReLU
flatten (320) -> fc1 320->50 ReLU [dropout] -> fc2 50->10 -> log-softmax

Params: 260 + 5020 + 16050 + 510 = 21840; data size M = 21840 * 32 bits
= 698 880 bits, the paper's Eq. 3 message size.

Functional torch counterpart of ``repro.models.cnn``, in the JAX package's
parameter layout: a dict of dicts of tensors, conv weights (out, in, 5, 5)
(OIHW, images NCHW), fc weights (din, dout) — not ``nn.Linear``'s
(dout, din) — so parameters convert 1:1 and leaves flatten in the same
sorted-key order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["cnn_init", "cnn_apply", "cnn_loss", "cnn_accuracy", "PARAM_COUNT",
           "MODEL_BITS"]

PARAM_COUNT = 21_840
MODEL_BITS = PARAM_COUNT * 32


def cnn_init(generator: torch.Generator,
             device: str | torch.device = "cuda") -> dict:
    """Random parameters with the reference's shapes and scales, drawn from
    ``generator`` (a CPU generator gives the same values on every device).
    ``jax.random`` streams are not reproduced: parity tests carry the JAX
    package's parameters across with ``convert.params_from_numpy``."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(dev)

    def conv(cin, cout, ksz):
        scale = (cin * ksz * ksz) ** -0.5
        return {"w": normal(cout, cin, ksz, ksz) * scale,
                "b": torch.zeros(cout, device=dev)}

    def fc(din, dout):
        return {"w": normal(din, dout) * din**-0.5,
                "b": torch.zeros(dout, device=dev)}

    return {"conv1": conv(1, 10, 5), "conv2": conv(10, 20, 5),
            "fc1": fc(320, 50), "fc2": fc(50, 10)}


def _dropout(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Ratio 0.5 as in the paper; the mask is drawn on the generator's
    device and moved to ``x``'s."""
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device) < 0.5
    return x * keep.to(x.device) * 2.0


def cnn_apply(params: dict, images: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """images (B, 1, 28, 28) -> log-probs (B, 10). Dropout active iff a
    generator is passed (train mode)."""
    c1, c2 = params["conv1"], params["conv2"]
    x = F.relu(F.max_pool2d(F.conv2d(images, c1["w"], c1["b"]), 2))
    x = F.conv2d(x, c2["w"], c2["b"])
    if generator is not None:
        x = _dropout(x, generator)
    x = F.relu(F.max_pool2d(x, 2))
    x = x.reshape(x.shape[0], -1)  # (B, 320)
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    if generator is not None:
        x = _dropout(x, generator)
    x = x @ params["fc2"]["w"] + params["fc2"]["b"]
    return F.log_softmax(x, dim=-1)


def cnn_loss(params: dict, batch: dict,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean negative log-likelihood; labels may be int32 at the boundary."""
    logp = cnn_apply(params, batch["images"], generator)
    labels = batch["labels"].to(torch.int64)
    return -logp.gather(1, labels[:, None]).mean()


def cnn_accuracy(params: dict, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    pred = cnn_apply(params, images).argmax(dim=-1)
    return (pred == labels.to(pred.dtype)).to(torch.float32).mean()
