"""Uniform model facade: every architecture exposes the same five functions.

The torch counterpart of ``repro.models.api`` for the decoder-only
families (lm, hybrid, ssm, vlm):

* ``init(gen) -> params``                (drawn from a ``torch.Generator``)
* ``loss(params, batch) -> scalar``      (teacher-forced, forward only)
* ``prefill(params, batch) -> (logits, cache)``
* ``decode_step(params, token, cache, index) -> (logits, cache)``
* ``make_inputs(shape, gen) -> batch``   (synthetic, for smoke runs)

``batch`` layouts: {"tokens": (B, S)}, plus "patch_embeds" (B, P, d) for
the vision frontend. Encoder-decoder configs raise ``NotImplementedError``
(they come with a later slice), as do the layer kinds this slice does not
port (``transformer.check_supported``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import transformer
from .layers import torch_dtype

PyTree = Any

__all__ = ["ModelAPI", "build"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[torch.Generator], PyTree]
    loss: Callable[..., torch.Tensor]
    prefill: Callable[..., tuple[torch.Tensor, PyTree]]
    decode_step: Callable[..., tuple[torch.Tensor, PyTree]]
    make_inputs: Callable[..., dict]


def _lm_make_inputs(cfg: ModelConfig, shape: ShapeConfig,
                    gen: torch.Generator, device: str | torch.device,
                    batch_override: Optional[int] = None) -> dict:
    device = resolve_device(device)
    b = batch_override or shape.global_batch
    s = shape.seq_len
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=gen.device).to(device)
    out = {"tokens": tokens}
    if cfg.frontend == "vision":
        out["patch_embeds"] = torch.randn(
            (b, cfg.n_patches, cfg.d_model), generator=gen,
            device=gen.device).to(device=device, dtype=torch_dtype(cfg.dtype))
    return out


def build(cfg: ModelConfig, device: str | torch.device = "cuda") -> ModelAPI:
    """The facade of ``cfg`` with ``init`` and ``make_inputs`` placing
    tensors on ``device`` (checked when they are called)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet; they "
            "come with the mla/moe/encdec slice (ROADMAP Queue 1 item 3)")
    transformer.check_supported(cfg)

    def loss(params, batch):
        return transformer.lm_loss(cfg, params, batch)

    def prefill(params, batch, max_len=None):
        return transformer.prefill(cfg, params, batch["tokens"],
                                   max_len=max_len,
                                   patch_embeds=batch.get("patch_embeds"))

    def decode(params, token, cache, index):
        return transformer.decode_step(cfg, params, token, cache, index)

    return ModelAPI(
        cfg, lambda gen: transformer.init_params(cfg, gen, device), loss,
        prefill, decode,
        lambda shape, gen, batch_override=None: _lm_make_inputs(
            cfg, shape, gen, device, batch_override))
