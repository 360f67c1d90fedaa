#!/usr/bin/env python3
"""Time the two scans' backward kernels against earlier versions of their
sources, in turns, on one CUDA card.

Builds second copies of ``csrc/rglru_scan_bwd.cu`` and
``csrc/rwkv6_scan_bwd.cu`` from another directory (``--parent``, e.g. the
sources as they were before a change, unpacked with ``git archive``) with
the same nvcc flags, and times each pair at chip_smoke.py phase 3f's timed
shapes: the RG-LRU backward at (3, 512, 2560) (recurrentgemma-2b's
training, 3 nodes x batch 1) and (4, 4096, 2560) with h0; the RWKV-6
backward at (12, 512, 64, 64) with u per batch row (rwkv6-7b's training,
3 nodes x batch 4) and (4, 4096, 64, 64) with s0 and ds_final. Each shape
is timed in turns, parent, change, change, parent, over ``--pairs``
pairs: CUDA events around back-to-back calls, after a warm-up; it prints
each version's median, its spread (max - min over its turns), the
change's ratio and each version's share of the bound (bytes: every input
read once, every output written once, at 3.35 TB/s). Both versions are
called the same way, straight through their ctypes entries with the same
inputs and one workspace large enough for either (each entry zeroes what
it needs of it), so the two times differ by the kernels alone (the
RG-LRU entries' memset of their flags included). Each version's
gradients are held against the plain versions summed in float64
(``acc_dtype``), 1e-4 (RG-LRU) and 5e-4 (RWKV-6) of max(1, max
|oracle|), and two calls of each must be bit-equal. Then, for each
shape, the change's device time a call split by kernel (profiler), and
the card's ``nvidia-smi`` name and power limit. Exits 1 if a version
misses a bar.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/scan_bwd_ab.py --parent <dir>/src/repro_torch/csrc
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
# (B, S, D, h0) and (B, S, H, D, states, u per row)
RGLRU_SHAPES = [(3, 512, 2560, False), (4, 4096, 2560, True)]
RWKV_SHAPES = [(12, 512, 64, 64, False, True), (4, 4096, 64, 64, True, False)]
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = {"rglru_scan_bwd": (_P,) * 7 + (_I,) * 3 + (_P, _L, _P),
            "rwkv6_scan_bwd": (_P,) * 15 + (_I,) * 4 + (_L, _L, _P)}


def build_parent(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    digest = hashlib.sha256(src.read_bytes())
    for inc in _build._includes(src):
        digest.update(inc.read_bytes())
    so = _build.BUILD_DIR / f"{src.stem}_parent-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def entry(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, f"{name}_f32")
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def held(torch, got, want, bar) -> float:
    """The worst |got - want| over the gradients if each is within bar x
    max(1, max |want|), else inf."""
    worst = 0.0
    for g, w in zip(got, want):
        if g is None:
            continue
        e = float((g.double() - w.double()).abs().max())
        if e > bar * max(1.0, float(w.abs().max())):
            return float("inf")
        worst = max(worst, e)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory holding the earlier sources")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = {}
    for name in ("rglru_scan_bwd", "rwkv6_scan_bwd"):
        fns["parent", name] = entry(build_parent(args.parent / f"{name}.cu"),
                                    name)
        fns["change", name] = entry(_build.load(name), name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def time_call(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def ptr(x):
        return None if x is None else x.data_ptr()

    cases = []   # (label, bytes, calls by version, outputs, oracle, bar)
    for b, s, d, with_h0 in RGLRU_SHAPES:
        a = torch.sigmoid(randn(b, s, d))
        h0 = randn(b, d) if with_h0 else None
        h = rg.rglru_scan(a, randn(b, s, d), h0)
        dh = randn(b, s, d)
        ws = torch.empty(rg.workspace_bytes(b, s, d), dtype=torch.uint8,
                         device=dev)
        outs = {v: (torch.empty_like(a), torch.empty_like(a),
                    None if h0 is None else torch.empty_like(h0))
                for v in ("parent", "change")}

        def call(version, a=a, h=h, h0=h0, dh=dh, b=b, s=s, d=d, ws=ws,
                 outs=outs):
            da, db, dh0 = outs[version]
            err = fns[version, "rglru_scan_bwd"](
                a.data_ptr(), h.data_ptr(), ptr(h0), dh.data_ptr(),
                da.data_ptr(), db.data_ptr(), ptr(dh0), b, s, d,
                ws.data_ptr(), ws.numel(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{version} rglru launch failed: {err}")
        want = rg.rglru_scan_bwd_plain(a, h, dh, h0, acc_dtype=torch.float64)
        nbytes = 4 * (5 * b * s * d + (2 * b * d if with_h0 else 0))
        cases.append((f"rglru_scan_bwd ({b},{s},{d}) h0={with_h0}", nbytes,
                      call, outs, want, 1e-4))
    for b, s, hh, d, states, u_rows in RWKV_SHAPES:
        r, k, v, dy = (randn(b, s, hh, d) for _ in range(4))
        w = torch.exp(-torch.exp(randn(b, s, hh, d) * 0.5))
        u = randn(b, hh, d) * 0.1 if u_rows else randn(hh, d) * 0.1
        s0, dsf = (randn(b, hh, d, d), randn(b, hh, d, d)) if states else \
            (None, None)
        # the earlier kernel's workspace held a (DP, DP) state every 8 steps
        dp = next(x for x in (16, 32, 64, 128) if d <= x)
        ws = torch.empty(max(rw.bwd_workspace_bytes(b, s, hh, d),
                             4 * b * hh * -(-s // 8) * dp * dp) // 4,
                         dtype=torch.float32, device=dev)
        outs = {ver: (*(torch.empty_like(r) for _ in range(4)),
                      torch.empty((b, hh, d), device=dev),
                      None if s0 is None else torch.empty_like(s0))
                for ver in ("parent", "change")}

        def call(version, r=r, k=k, v=v, w=w, u=u, s0=s0, dy=dy, dsf=dsf,
                 b=b, s=s, hh=hh, d=d, ws=ws, outs=outs, u_rows=u_rows):
            dr, dk, dv, dw, du, ds0 = outs[version]
            err = fns[version, "rwkv6_scan_bwd"](
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), ptr(s0), dy.data_ptr(), ptr(dsf),
                dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                du.data_ptr(), ptr(ds0), ws.data_ptr(), b, s, hh, d,
                hh * d if u_rows else 0, 4 * ws.numel(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{version} rwkv6 launch failed: {err}")
        want = rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, s0, dsf, 64,
                                       acc_dtype=torch.float64)
        nbytes = 4 * (9 * b * s * hh * d + (u.numel() + b * hh * d)
                      + (3 * b * hh * d * d if states else 0))
        cases.append((f"rwkv6_scan_bwd ({b},{s},{hh},{d}) states={states} "
                      f"u per row={u_rows}", nbytes, call, outs, want, 5e-4))

    ok = True
    print("shape | parent ms (spread) | change ms (spread) | change / "
          "parent | share of the bound parent, change | max|err| parent, "
          "change | two calls bit-equal")
    for label, nbytes, call, outs, want, bar in cases:
        errs, same = {}, {}
        for version in ("parent", "change"):
            call(version)
            torch.cuda.synchronize()
            first = [None if x is None else x.clone() for x in outs[version]]
            call(version)
            torch.cuda.synchronize()
            same[version] = all(x is None or torch.equal(x, y)
                                for x, y in zip(first, outs[version]))
            errs[version] = held(torch, outs[version], want, bar)
            ok &= same[version] and errs[version] != float("inf")
        for _ in range(3):
            call("parent")
            call("change")
        torch.cuda.synchronize()
        times = {"parent": [], "change": []}
        for _ in range(args.pairs):
            for version in ("parent", "change", "change", "parent"):
                times[version].append(time_call(lambda: call(version),
                                                args.reps))
        med = {k_: statistics.median(x) for k_, x in times.items()}
        spread = {k_: max(x) - min(x) for k_, x in times.items()}
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"{label} | {med['parent']:.4f} ({spread['parent']:.4f}) | "
              f"{med['change']:.4f} ({spread['change']:.4f}) | "
              f"{med['change'] / med['parent']:.4f} | "
              f"{bound_ms / med['parent'] * 100:.1f} %, "
              f"{bound_ms / med['change'] * 100:.1f} % of {bound_ms:.4f} ms "
              f"| {errs['parent']:.3e}, {errs['change']:.3e} | "
              f"{same['parent']}, {same['change']}", flush=True)
    # the change's device operations a call, by kernel (profiler)
    from torch.profiler import ProfilerActivity, profile
    for label, nbytes, call, outs, want, bar in cases:
        call("change")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call("change")
            torch.cuda.synchronize()
        split = [(e.key, getattr(e, "self_device_time_total", 0.0) / 5e3)
                 for e in prof.key_averages()]
        names = [re.sub(r"^void ", "", k.replace("(anonymous namespace)::",
                                                 "")).split("(")[0]
                 for k, _ in split]
        print(f"{label}, change, device ms a call: " + "; ".join(
            f"{n[:48]} {ms:.4f}" for n, (_, ms) in zip(names, split)
            if ms > 0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    if not ok:
        print("a version missed a bar or two calls differed (above)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
