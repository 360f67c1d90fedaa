#!/usr/bin/env python3
"""Time flash attention's backward kernel against an earlier version of
its source, in turns, on one CUDA card.

Builds a second copy of the backward from another source file
(``--parent``, e.g. the file as it was before a change, unpacked with
``git archive``; headers it includes are read beside it) with the same
nvcc flags, and times both at chip_smoke.py's phase 16 shape (stablelm-3b:
q, k, v, do (24, 512, 32, 80), causal) in bf16 and fp32, and at the D 64
shapes of seamless-m4t-large-v2 ((4, 2048, 16, 64), causal and not) in
bf16. Each shape is timed in turns, parent, change, change, parent, over
``--pairs`` pairs: CUDA events around back-to-back calls, after a warm-up;
it prints each version's median, its spread (max - min over its turns)
and the change's ratio. Both versions are called the same way, straight
through their ctypes entries with the same arguments and the same fp32
scratch (as large as the change needs), on the forward kernel's o and lse,
so the two times differ by the kernels alone. Each version's dq, dk and dv
are held against the plain version summed in float64 (``acc_dtype``) at
the card tests' bars: fp32 2e-5; bf16 3e-2 and every row within 2^-6 of
its norm (dq's first query under a causal mask by the absolute bar only).
The two are compared bit for bit too: equal in fp32, where both run the
same CUDA-core body; in bf16 the change's tensor cores sum in another
order. Then the card's ``nvidia-smi`` name and power limit. Exits 1 if a
version misses a bar.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/flash_bwd_ab.py \
        --parent <dir>/src/repro_torch/csrc/flash_attention_bwd.cu
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (B, S, T, Hq, Hkv, D, causal, window, dtype name)
SHAPES = [(24, 512, 512, 32, 32, 80, True, 0, "bfloat16"),
          (24, 512, 512, 32, 32, 80, True, 0, "float32"),
          (4, 2048, 2048, 16, 16, 64, True, 0, "bfloat16"),
          (4, 2048, 2048, 16, 16, 64, False, 0, "bfloat16")]
BARS = {"float32": (2e-5, None), "bfloat16": (3e-2, 2.0 ** -6)}


def build_parent(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    digest = hashlib.sha256(src.read_bytes())
    for inc in _build._includes(src):
        digest.update(inc.read_bytes())
    so = _build.BUILD_DIR / \
        f"flash_attention_bwd_parent-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def errors(torch, got, want, causal):
    """max |got - want| over dq, dk, dv, and the worst row's relative
    error (dq's first query under a causal mask left to the first)."""
    worst, worst_row = 0.0, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        worst = max(worst, float((g.double() - w.double()).abs().max()))
        first = 1 if name == "dq" and causal else 0
        a = g[:, first:].double().flatten(0, -2)
        b = w[:, first:].double().flatten(0, -2)
        worst_row = max(worst_row, float(((a - b).norm(dim=-1) /
                                          b.norm(dim=-1).clamp_min(1e-30))
                                         .max()))
    return worst, worst_row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entries = {}
    for version, lib in (("parent", build_parent(args.parent)),
                         ("change", _build.load("flash_attention_bwd"))):
        for dname, name in (("float32", "flash_attention_bwd_f32"),
                            ("bfloat16", "flash_attention_bwd_bf16")):
            fn = getattr(lib, name)
            fn.argtypes = (p,) * 10 + (i,) * 6 + (f, i, i, p)
            fn.restype = ctypes.c_int
            entries[version, dname] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_call(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    ok = True
    print("shape | parent ms (spread) | change ms (spread) | change / "
          "parent | max|err| parent, change (rows) | bit-equal")
    for b, s, t, hq, hkv, d, causal, window, dname in SHAPES:
        dtype = getattr(torch, dname)
        q, do = (torch.randn((b, s, hq, d), generator=gen, device=dev)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, t, hkv, d), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        o, lse = fa._forward(q, k, v, causal, window, True)
        scratch = torch.empty(2 * b * hq * -(-s // 64) * 64,
                              dtype=torch.float32, device=dev)
        outs = {v_: tuple(torch.empty_like(x) for x in (q, k, v))
                for v_ in ("parent", "change")}

        def call(version):
            dq, dk, dv = outs[version]
            err = entries[version, dname](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), scratch.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, t, hq,
                hkv, d, d**-0.5, int(causal), int(window),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{version} launch failed: {err}")

        def parent():
            call("parent")

        def change():
            call("change")
        parent()
        change()
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal, window=window,
                                            acc_dtype=torch.float64)
        errs = {v_: errors(torch, outs[v_], want, causal) for v_ in outs}
        bar, row_bar = BARS[dname]
        for e, re_ in errs.values():
            ok &= e < bar and (row_bar is None or re_ <= row_bar)
        same = all(torch.equal(x, y) for x, y in zip(outs["parent"],
                                                     outs["change"]))
        del want
        reps = args.reps if dname == "bfloat16" else max(args.reps // 5, 2)
        for fn in (parent, change):
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        times = {"parent": [], "change": []}
        for _ in range(args.pairs):
            for name, fn in (("parent", parent), ("change", change),
                             ("change", change), ("parent", parent)):
                times[name].append(time_call(fn, reps))
        med = {k_: statistics.median(x) for k_, x in times.items()}
        spread = {k_: max(x) - min(x) for k_, x in times.items()}
        print(f"({b},{s}x{t},{hq}/{hkv},{d}) causal={causal} w={window} "
              f"{dname} | {med['parent']:.4f} ({spread['parent']:.4f}) | "
              f"{med['change']:.4f} ({spread['change']:.4f}) | "
              f"{med['change'] / med['parent']:.4f} | "
              f"{errs['parent'][0]:.3e}, {errs['change'][0]:.3e} "
              f"({errs['parent'][1]:.3e}, {errs['change'][1]:.3e}) | "
              f"{same}", flush=True)
        del q, k, v, o, lse, do, outs, scratch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    if not ok:
        print("a version missed a bar (above)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
