"""Batched serving: prefill a prompt batch, decode N tokens.

The torch counterpart of ``repro.launch.serve``, on the card by default:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
      --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --arch deepseek-v2-lite-16b        # or seamless-m4t-large-v2

The default ``--arch`` is ``rwkv6-7b``, as in the JAX entry point.

Tensor parallelism over the ``model`` axis, one rank a card:
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --tp 4 \
      --arch phi3.5-moe-42b-a6.6b
(a world of W ranks is a (W / tp, tp) mesh; each model group serves the
same prompts). Every rank draws the whole model's weights in the same
order from the same seed and keeps its shard of each leaf as it is drawn
(``train.shardings.param_specs``), so no rank holds the whole tree: the
caches are the rank's shards (``train.shardings.cache_layout``), the last
position's logits are gathered whole and every rank picks the same
token. Rank 0 prints; every rank's tokens are held equal.

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
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..configs import get_config, reduce_for_smoke
from ..configs.base import ShapeConfig
from ..device import resolve_device
from ..models import build
from ..models import tp as _tp
from ..models.layers import torch_dtype
from .mesh import init_world, make_fleet_mesh
from .train import shard_cast

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


def init_serving_params(api, gen: torch.Generator,
                        model: _tp.Model = _tp.ONE):
    """``serving_params(cfg, api.init(gen))``, bit for bit, with each piece
    cast as it is drawn: the same draws in the same order, so the peak is
    the cast tree and one fp32 layer. ``model``: each piece then narrowed
    to the rank's shard (``train.shardings.param_specs`` of the piece, as
    ``launch.train.shard_cast``), so the rank holds its shards and one
    drawn layer."""
    cfg = api.cfg
    if not model.active:
        return api.init(gen, cast=functools.partial(serving_params, cfg))
    shard = shard_cast(cfg, model)
    return api.init(gen, cast=lambda piece: shard(serving_params(cfg, piece)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_axis(tp: int) -> _tp.Model:
    """This rank's place on a ``model`` axis of ``tp`` ranks: the started
    world as a (world / tp, tp) mesh (``launch.mesh.make_fleet_mesh``);
    ``tp`` 1 is one device. Without a world, ``tp`` > 1 raises."""
    if tp == 1:
        return _tp.ONE
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"tp={tp} needs a world of {tp} ranks, one a device (torchrun "
            f"--nproc-per-node {tp} -m repro_torch.launch.serve --tp {tp})")
    world = dist.get_world_size()
    if tp < 1 or world % tp:
        raise ValueError(f"a 'model' axis of {tp} does not divide the "
                         f"world's {world} ranks")
    return _tp.model_of(make_fleet_mesh(world // tp, tp))


def generate(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
             greedy: bool = True, clock: Optional[Callable[[], float]] = None,
             device: str | torch.device = "cuda",
             tp: int | _tp.Model = 1) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens (the first from the prefill's logits). ``clock``
    is injectable; it is read only after the device has finished
    (``torch.cuda.synchronize``). ``tp``: a ``model`` axis of that many
    ranks of the started world (``model_axis``), or a ``models.tp.Model``;
    every rank of it calls ``generate``. Returns the tokens (B, gen), the
    last step's logits (B, V, whole on every rank), and the prefill /
    decode seconds."""
    clock = clock or time.perf_counter
    dev = resolve_device(device)
    model = tp if isinstance(tp, _tp.Model) else model_axis(tp)
    api = build(cfg, dev, model=model)
    rng = torch.Generator(device=dev).manual_seed(seed)
    params = init_serving_params(api, rng, model)
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
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks of the 'model' axis (under torchrun)")
    args = ap.parse_args(argv)
    # under torchrun every rank starts its place in the world first
    in_world = "WORLD_SIZE" in os.environ
    device = args.device
    if in_world:
        device = init_world(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    out = generate(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, device=device, tp=args.tp)
    if in_world:
        tokens = [None] * dist.get_world_size()
        dist.all_gather_object(tokens, out["tokens"].tolist())
        if any(t != tokens[0] for t in tokens):
            raise RuntimeError("the ranks sampled different tokens")
    if not in_world or dist.get_rank() == 0:
        print(f"prefill {out['prefill_s']:.2f}s decode "
              f"{out['decode_s']:.2f}s ({out['tok_per_s']:.1f} tok/s), "
              f"sample: {out['tokens'][0][:16].tolist()}"
              + (f" (tp {args.tp}, every rank's tokens equal)"
                 if in_world else ""))
    if in_world:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
