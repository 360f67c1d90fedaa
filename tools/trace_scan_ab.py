#!/usr/bin/env python3
"""Time the scan trace engine's round-loop kernel against an earlier
version of its source, in turns, on one CUDA card.

Builds a second copy of ``csrc/trace_scan.cu`` from another directory
(``--parent``, e.g. the sources as they were before a change, unpacked
with ``git archive``) with the same nvcc flags, and times both on two
traces: ``examples/sim_scenarios.py --scale 1024``'s (fading with Rayleigh
gains only, n = 1024, P 22, 4 passes, 30 rounds; its certified plan takes
~40 s on the host) and chip_smoke.py phase 21 (c)'s (fading, n = 256,
seed 0, 2 rounds). Each trace runs in turns, parent, change, change,
parent, over ``--pairs`` pairs, one launch a call timed by CUDA events,
after one untimed call of each. It prints each version's median, its
spread (max - min over its turns), the change's ratio, µs a transmitter
pass (the chain) and the change's exact-path decodes, then the card's
``nvidia-smi`` name and power limit. Both versions are called straight
through their ctypes entries on the same inputs; delivered, retx and the
counts (passes run, decodes decided) must be equal between them and the
times within 1e-12 relative, else the tool exits 1. The parent's entry
is the whole-trace layout's (receiver-list scratch only,
``PARENT_ARGS``); the change's takes the workspaces
``kernels.trace_scan.round_scan`` allocates.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/trace_scan_ab.py --parent <dir>/src/repro_torch/csrc
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

TRACES = [(1024, 30, 0), (256, 2, 0)]     # (n, rounds, seed)
TOL_TIME = 1e-12
# the parent's entry: no thresholds, workspaces or exact-path count
PARENT_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
               + (ctypes.c_double,) * 4 + (ctypes.c_uint64, ctypes.c_int)
               + (ctypes.c_void_p,) * 7 + (ctypes.c_void_p,))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory holding the earlier trace_scan.cu")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import trace_scan as ts
    from repro_torch.sim import WirelessSimulator, get_scenario, jit_trace
    from scan_bwd_ab import build_parent

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    parent = build_parent(args.parent / "trace_scan.cu").trace_scan
    parent.argtypes = PARENT_ARGS
    parent.restype = ctypes.c_int
    change = _build.load("trace_scan").trace_scan
    change.argtypes = (*ts._ARGS, ctypes.c_void_p)
    change.restype = ctypes.c_int

    ok = True
    print("trace | parent ms (spread) | change ms (spread) | change / "
          "parent | us a pass parent, change | passes, decodes | change's "
          "exact-path decodes | equal")
    for n, rounds, seed in TRACES:
        cfg = get_scenario("fading", n_nodes=n, seed=seed,
                           **{"fading.shadowing_sigma_db": 0.0})
        arrays, kw = jit_trace.scan_inputs(cfg, WirelessSimulator(cfg))
        rates, sizes, recv, chan, _ = (torch.as_tensor(a, device=dev)
                                       for a in arrays)
        p = kw["n_pkts"]
        tiled = ts._layout(n, p)[1]
        words = (p + 63) // 64
        i64 = dict(dtype=torch.int64, device=dev)
        scratch = {
            "lists": torch.empty((n, n + 1), dtype=torch.int32, device=dev),
            "thr": torch.empty((n, n, 2), **i64),
            "need": torch.empty((words, n), **i64) if tiled else None,
            "send": torch.empty((2, words), **i64) if tiled else None}
        outs = {}

        def call(version, outs=outs, n=n, rounds=rounds, kw=kw,
                 scratch=scratch, rates=rates, sizes=sizes, recv=recv,
                 chan=chan):
            o = {"delivered": torch.zeros((rounds, n, n), dtype=torch.bool,
                                          device=dev),
                 "t_start": torch.empty(rounds, dtype=torch.float64,
                                        device=dev),
                 "t_comm": torch.empty(rounds, dtype=torch.float64,
                                       device=dev),
                 "retx": torch.empty(rounds, **i64),
                 "t_end": torch.empty((), dtype=torch.float64, device=dev),
                 "counts": torch.zeros(2, **i64),
                 "exact": torch.zeros(1, **i64)}
            head = (rates.data_ptr(), sizes.data_ptr(), recv.data_ptr(),
                    chan.data_ptr(), 1, n, kw["n_pkts"], kw["passes"],
                    kw["coherence_s"], kw["bandwidth_hz"], kw["overhead_s"],
                    kw["compute_s"], kw["seed"] % (1 << 64), rounds,
                    o["delivered"].data_ptr(), o["t_start"].data_ptr(),
                    o["t_comm"].data_ptr(), o["retx"].data_ptr(),
                    o["t_end"].data_ptr(), scratch["lists"].data_ptr())
            ptr = (lambda t: None if t is None else t.data_ptr())
            tail = ((o["counts"].data_ptr(),) if version == "parent" else
                    (scratch["thr"].data_ptr(), ptr(scratch["need"]),
                     ptr(scratch["send"]), o["counts"].data_ptr(),
                     o["exact"].data_ptr()))
            fn = parent if version == "parent" else change
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream().cuda_stream
            start.record()
            err = fn(*head, *tail, stream)
            end.record()
            if err:
                raise RuntimeError(f"{version} launch failed: CUDA error "
                                   f"{err}")
            end.synchronize()
            outs[version] = o
            return start.elapsed_time(end)

        for version in ("parent", "change"):
            call(version)
        got, want = outs["change"], outs["parent"]
        same = all(torch.equal(got[k], want[k])
                   for k in ("delivered", "retx", "counts"))
        t_rel = max(float(((got[k] - want[k]).abs()
                           / want[k].abs().clamp_min(1e-300)).max())
                    for k in ("t_start", "t_comm", "t_end"))
        ok &= same and t_rel <= TOL_TIME
        times = {"parent": [], "change": []}
        for _ in range(args.pairs):
            for version in ("parent", "change", "change", "parent"):
                times[version].append(call(version))
        passes, decodes = (int(x) for x in outs["change"]["counts"].cpu())
        med = {k: statistics.median(x) for k, x in times.items()}
        spread = {k: max(x) - min(x) for k, x in times.items()}
        print(f"fading n={n} P={p} passes={kw['passes']} {rounds} rounds "
              f"({'tiled' if tiled else 'one tile'}) | "
              f"{med['parent']:.4f} ({spread['parent']:.4f}) | "
              f"{med['change']:.4f} ({spread['change']:.4f}) | "
              f"{med['change'] / med['parent']:.5f} | "
              f"{med['parent'] * 1e3 / passes:.4f}, "
              f"{med['change'] * 1e3 / passes:.4f} | {passes}, {decodes} | "
              f"{int(outs['change']['exact'].cpu()[0])} | delivered, retx, "
              f"counts {'equal' if same else 'DIFFER'}, times max rel "
              f"{t_rel:.3e} (tol {TOL_TIME:g})", flush=True)
        print(f"  every turn, ms: parent {times['parent']}, change "
              f"{times['change']}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    if not ok:
        print("the two versions differ (above)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
