#!/usr/bin/env python3
"""How far the RWKV-6 scan kernel and its plain version are from exact.

Draws r, k, v, w, u, s0 with numpy from a seed in three decay regimes (the
draw of tests/test_kernels.py; the served one, log w = -exp(U(0.5, 2) +
N(0, 1)), where w's 1e-12 floor is live; a weak one, log w ~ -1e-3 with k
scaled by sqrt(1 - w^2)), runs the exact recurrence in float64 (w floored
at 1e-12 as the kernels floor it), the plain version in fp32 (chunk 32,
the model's) and, on a card, the kernel, and prints the max |difference|
of y and of the final state for each pair. On the CPU only the plain
version is held against float64.

Run from the repository root:
    python3 tools/rwkv6_accuracy.py [--device cuda] [--batch 4 --seq 4096
                                     --heads 64 --dim 64]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def draw(b, s, h, d, regime, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)) for _ in range(3))
    if regime == "served":
        lw = -np.exp(rng.uniform(0.5, 2.0, size=(b, s, h, d))
                     + rng.normal(size=(b, s, h, d)))
    elif regime == "weak":
        lw = -1e-3 * np.exp(0.1 * rng.normal(size=(b, s, h, d)))
        k = k * np.sqrt(-np.expm1(2 * lw))
    else:
        lw = -np.exp(rng.normal(size=(b, s, h, d)) * 0.5)
    u = rng.normal(size=(h, d)) * 0.1
    s0 = rng.normal(size=(b, h, d, d))
    return tuple(x.astype(np.float32) for x in (r, k, v, np.exp(lw), u, s0))


def exact(r, k, v, w, u, s0):
    """The recurrence step by step in float64 (inputs as the fp32 draws)."""
    import torch

    r, k, v, w, u, state = (x.double() for x in (r, k, v, w, u, s0))
    w = torch.clamp(w, min=1e-12)
    y = torch.empty_like(r)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        y[:, t] = torch.einsum("bhd,bhde->bhe", r[:, t],
                               state + u[None, :, :, None] * kv)
        state = w[:, t, :, :, None] * state + kv
    return y, state


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    import subprocess

    import torch

    from repro_torch.kernels import rwkv6_scan as rw

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("no CUDA card: pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        name = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(name.strip())
    shape = (args.batch, args.seq, args.heads, args.dim)

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    for regime in ("test", "served", "weak"):
        host = draw(*shape, regime, args.seed)
        r, k, v, w, u, s0 = (torch.from_numpy(x).to(dev) for x in host)
        ey, es = exact(r, k, v, w, u, s0)
        py, ps = rw.rwkv6_scan_plain(r, k, v, w, u, s0, 32)
        line = (f"{regime:6s} decays {shape}: |y| max "
                f"{float(ey.abs().max()):.1f}; plain (chunk 32) vs float64: "
                f"y {err(py, ey):.3e}, state {err(ps, es):.3e}")
        if dev.type == "cuda":
            ky, ks = rw.rwkv6_scan(r, k, v, w, u, s0)
            torch.cuda.synchronize()
            line += (f"; kernel vs float64: y {err(ky, ey):.3e}, state "
                     f"{err(ks, es):.3e}; kernel vs plain: y "
                     f"{err(ky, py):.3e}, state {err(ks, ps):.3e}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
