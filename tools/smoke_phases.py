#!/usr/bin/env python3
"""Chosen phases of chip_smoke.py alone, after its device and build phases.

The phases offered need no earlier phase's result: 14 and 15 (serving
seamless-m4t-large-v2's encoder-decoder at full width, and its
correctness against the plain reference at the smoke widths) and 27
(every family's tensor-parallel training: (a) on one card, (b) where four
cards are visible). Each prints what it prints inside chip_smoke.py; the
results go to ``--out`` as JSON, then the card's name and power limit.

Run from the repository root:
    python3 tools/smoke_phases.py [--phases 14,15,27]
                                  [--out results/smoke_phases.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


PHASES = {"14": cs.phase_encdec_serve, "15": cs.phase_encdec_correct,
          "27": cs.phase_tpf}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default="results/smoke_phases.json")
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    from repro_torch.kernels import cost
    from repro_torch.utils import profile

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: these phases need a "
                "card")
    cs.cost, cs.prof = cost, profile
    t0 = time.perf_counter()
    cs.phase_device(torch)
    cs.phase_build()
    results = {}
    for label in args.phases.split(","):
        t1 = time.perf_counter()
        results[label] = PHASES[label](torch)
        print(f"-- phase {label}: {time.perf_counter() - t1:.2f} s wall",
              flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, default=str))
    print(f"phases {args.phases} passed in {time.perf_counter() - t0:.1f} s")
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
