"""Batched serving: prefill a prompt batch, decode N tokens.

The torch counterpart of ``repro.launch.serve``, on the card by default:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
      --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --arch deepseek-v2-lite-16b        # or seamless-m4t-large-v2

The default ``--arch`` is ``rwkv6-7b``, as in the JAX entry point.

Weights are random, drawn on the device from a ``torch.Generator`` seeded
with ``seed``. Every weight leaf that each use casts to ``cfg.dtype`` is
cast once, as it is drawn (bit-identical to casting at each use, and it
keeps eager decode from casting the fp32 weights every step; drawing a
layer and casting it before the next is drawn keeps the fp32 tree from
ever being whole: deepseek-v2-lite-16b's is 62 GB); the leaves whose uses
read them in fp32 stay fp32 (``_FP32_LEAVES``).
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Callable, Optional

import torch

from ..configs import get_config, reduce_for_smoke
from ..configs.base import ShapeConfig
from ..device import resolve_device
from ..models import build
from ..models.layers import torch_dtype

__all__ = ["main", "generate", "serving_params", "init_serving_params"]

# Leaves read in fp32 at use: a bf16 round trip would change results.
_FP32_LEAVES = frozenset({
    "scale", "bias",         # norms (layers.norm)
    "lam",                   # rglru.rglru_apply: softplus(lam) in fp32
    # rwkv6.rwkv_time_mix (the JAX package's rwkv6.py:179-180, 187, 202)
    "w_lora_a", "w_lora_b",  # the decay LoRA, :179-180
    "w0",                    # the decay's offset, :180
    "u",                     # the bonus, :187
    "ln_scale",              # the group norm's scale, :202
})


def serving_params(cfg, params):
    """``params`` with every leaf that each use casts to ``cfg.dtype``
    cast once; the leaves read in fp32 (``_FP32_LEAVES``) are kept."""
    dt = torch_dtype(cfg.dtype)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        return tree if key in _FP32_LEAVES else tree.to(dt)
    return walk(params)


def init_serving_params(api, gen: torch.Generator):
    """``serving_params(cfg, api.init(gen))``, bit for bit, with each piece
    cast as it is drawn: the same draws in the same order, so the peak is
    the cast tree and one fp32 layer."""
    return api.init(gen, cast=functools.partial(serving_params, api.cfg))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
             greedy: bool = True, clock: Optional[Callable[[], float]] = None,
             device: str | torch.device = "cuda") -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens (the first from the prefill's logits). ``clock``
    is injectable; it is read only after the device has finished
    (``torch.cuda.synchronize``). Returns the tokens (B, gen), the last
    step's logits (B, V), and the prefill / decode seconds."""
    clock = clock or time.perf_counter
    dev = resolve_device(device)
    api = build(cfg, dev)
    rng = torch.Generator(device=dev).manual_seed(seed)
    params = init_serving_params(api, rng)
    shape = ShapeConfig("serve", prompt_len, batch, "prefill")
    inputs = api.make_inputs(shape, rng, batch_override=batch)

    def pick(logits):
        if greedy:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits.to(torch.float32), -1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0]

    _sync(dev)
    t0 = clock()
    logits, cache = api.prefill(params, inputs, max_len=prompt_len + gen)
    _sync(dev)
    t_prefill = clock() - t0

    tokens = [pick(logits)]
    t0 = clock()
    base = inputs["tokens"].shape[1]
    for i in range(gen - 1):
        logits, cache = api.decode_step(params, tokens[-1], cache, base + i)
        tokens.append(pick(logits))
    out = torch.stack(tokens, dim=1)
    _sync(dev)
    t_decode = clock() - t0
    return {"tokens": out, "logits": logits, "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    out = generate(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, device=args.device)
    print(f"prefill {out['prefill_s']:.2f}s decode {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s), sample: "
          f"{out['tokens'][0][:16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
