#!/usr/bin/env python3
"""Run one of chip_smoke.py's recurrent training phases from two
checkouts in turns on one CUDA card, and compare their round times.

chip_smoke.py phases 18 (recurrentgemma-2b) and 19 (rwkv6-7b) train at
published widths on a wireless trace and report one replay of the round's
CUDA graph (ms on the card) and the family loop's host ms a round; host
times move up to 2x between calls, so a change is only compared with its
parent inside one call. This tool runs the phase (``--phase``) from the
parent's checkout (``--parent``, e.g. unpacked with ``git archive``) and
from this one, each in a process of its own (parent, change, change,
parent over ``--pairs`` pairs), each process building what it launches
from its own sources, and prints every run's replay ms, host ms a round
and idle share, then each version's medians and the change's ratios, and
the card's ``nvidia-smi`` name and power limit. A run whose phase fails
its own checks fails the tool (exit 1).

Run from the repository root on a machine with a card and nvcc:
    python3 tools/train_phase_ab.py --parent <dir> --phase 19
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"18": "recurrentgemma-2b", "19": "rwkv6-7b"}

# run inside a fresh interpreter at a checkout's root: the phase as the
# smoke runs it, its numbers as one JSON line
RUNNER = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import chip_smoke as cs
sys.path.insert(0, str(cs.SRC))
import torch
cs.phase_device(torch)
arch = sys.argv[2]
layers, batch, peak = cs.REC_TRAIN[arch]
out = cs.phase_train_lm(torch, sys.argv[1], arch, layers, cs.REC_NODES,
                        batch, peak)
print("PHASE_AB " + json.dumps({k: out[k] for k in
                                ("replay_ms", "loop_ms", "idle")}))
"""


def run(root: Path, phase: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUNNER, phase, ARCHS[phase]],
                          cwd=root, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("PHASE_AB "):
            return json.loads(line[len("PHASE_AB "):])
    sys.stdout.write(proc.stdout[-4000:])
    sys.stderr.write(proc.stderr[-4000:])
    raise SystemExit(f"phase {phase} failed in {root} (exit "
                     f"{proc.returncode})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of the parent's checkout")
    ap.add_argument("--phase", choices=sorted(ARCHS), default="19")
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args(argv)
    roots = {"parent": args.parent.resolve(), "change": ROOT}
    got = {"parent": [], "change": []}
    for _ in range(args.pairs):
        for version in ("parent", "change", "change", "parent"):
            r = run(roots[version], args.phase)
            got[version].append(r)
            print(f"phase {args.phase} {version}: replay {r['replay_ms']:.4f}"
                  f" ms, host {r['loop_ms']:.4f} ms a round, idle "
                  f"{r['idle']:.4f}", flush=True)
    med = {v: {k: statistics.median(x[k] for x in got[v])
               for k in ("replay_ms", "loop_ms", "idle")} for v in got}
    for v in ("parent", "change"):
        print(f"{v} medians: replay {med[v]['replay_ms']:.4f} ms, host "
              f"{med[v]['loop_ms']:.4f} ms a round, idle "
              f"{med[v]['idle']:.4f}")
    print(f"change / parent: replay "
          f"{med['change']['replay_ms'] / med['parent']['replay_ms']:.4f}, "
          f"host {med['change']['loop_ms'] / med['parent']['loop_ms']:.4f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
