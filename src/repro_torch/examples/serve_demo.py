"""Batched serving demo: prefill a prompt batch and greedy-decode, for one
attention arch and one recurrent (attention-free) arch.

The torch counterpart of ``examples/serve_demo.py``, on the card by
default; it prints the same lines.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""
from __future__ import annotations

import argparse

from ..configs import get_config, reduce_for_smoke
from ..launch.serve import generate

ARCHS = ("qwen2.5-14b", "rwkv6-7b")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        cfg = reduce_for_smoke(get_config(arch))
        out = generate(cfg, batch=4, prompt_len=32, gen=16,
                       device=args.device)
        print(f"{arch:14s} prefill {out['prefill_s']:.2f}s, "
              f"decode {out['decode_s']:.2f}s ({out['tok_per_s']:.0f} tok/s), "
              f"sample tokens: {out['tokens'][0][:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
