#!/usr/bin/env python3
"""Time the flash forward kernel against an earlier version of its source,
in turns, on one CUDA card.

The forward entries of ``src/repro_torch/csrc/flash_attention.cu`` take an
optional lse buffer (the backward kernel's input); serving passes null.
This script builds a second copy of the forward from another source file
(``--parent``, e.g. the file as it was before that change, unpacked with
``git archive``) with the same nvcc flags, and times both at chip_smoke's
phase 3b shapes, serving's way (no lse): the windowed D 256 prefill of
recurrentgemma-2b in bf16 and fp32, and the MLA (D 192, v padded from 128)
and encoder-decoder (D 64, non-causal and causal) prefills in bf16. Each
shape is timed in turns, parent, change, change, parent, over ``--pairs``
pairs: CUDA events around back-to-back calls, after a warm-up; it prints
each version's median, its spread (max - min over its turns) and the
change's ratio, and checks the two outputs bit-equal. Both versions are
called the same way, straight through their ctypes entries (the change's
with a null lse), so the two times differ by the kernels alone. Then the
card's ``nvidia-smi`` name and power limit.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/flash_fwd_ab.py --parent <dir>/src/repro_torch/csrc/flash_attention.cu
The parent's entries take (q, k, v, out, B, S, T, Hq, Hkv, D, scale,
causal, window, stream); give ``--parent-lse`` if the parent's take the
lse pointer after out.
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

# (B, S, T, Hq, Hkv, D, Dv, causal, window, dtype name): phase 3b's shapes
SHAPES = [(4, 4096, 4096, 10, 1, 256, 256, True, 2048, "bfloat16"),
          (4, 4096, 4096, 10, 1, 256, 256, True, 2048, "float32"),
          (4, 4096, 4096, 16, 16, 192, 128, True, 0, "bfloat16"),
          (4, 2048, 2048, 16, 16, 64, 64, False, 0, "bfloat16"),
          (4, 2048, 2048, 16, 16, 64, 64, True, 0, "bfloat16")]


def build_parent(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = _build.BUILD_DIR / f"flash_attention_parent-{digest}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--parent-lse", action="store_true")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entries = {}        # (version, dtype) -> (entry, takes an lse pointer)
    for version, lib, lse in (("parent", build_parent(args.parent),
                               args.parent_lse),
                              ("change", _build.load("flash_attention"),
                               True)):
        for dtype, name in ((torch.float32, "flash_attention_f32"),
                            (torch.bfloat16, "flash_attention_bf16")):
            fn = getattr(lib, name)
            fn.argtypes = (p,) * (5 if lse else 4) + (i,) * 6 + (f, i, i, p)
            fn.restype = ctypes.c_int
            entries[version, dtype] = (fn, lse)
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

    print("shape | parent ms (spread) | change ms (spread) | change / "
          "parent | outputs bit-equal")
    for b, s, t, hq, hkv, d, dv, causal, window, dname in SHAPES:
        dtype = getattr(torch, dname)
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(dtype)
        v = F.pad(torch.randn((b, t, hkv, dv), generator=gen, device=dev),
                  (0, d - dv)).to(dtype)
        outs = {"parent": torch.empty_like(q), "change": torch.empty_like(q)}

        def call(version):
            fn, lse = entries[version, dtype]
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     outs[version].data_ptr(), *((0,) if lse else ()), b, s,
                     t, hq, hkv, d, d**-0.5, int(causal), int(window),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{version} launch failed: {err}")

        def parent():
            call("parent")

        def change():
            call("change")
        parent()
        change()
        same = torch.equal(outs["parent"], outs["change"])
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
        print(f"({b},{s}x{t},{hq}/{hkv},{d}/{dv}) causal={causal} "
              f"w={window} {dname} | {med['parent']:.4f} "
              f"({spread['parent']:.4f}) | {med['change']:.4f} "
              f"({spread['change']:.4f}) | "
              f"{med['change'] / med['parent']:.4f} | {same}", flush=True)
        del q, k, v, outs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
