#!/usr/bin/env python3
"""Where the RWKV-6 scan kernel's time goes, phase by phase, on the card.

Builds a copy of ``src/repro_torch/csrc/rwkv6_scan.cu`` with ``clock64()``
stamps between the phases of its chunk loop (the producers' wait for a
stage, the wait for a free buffer with the next chunk's loads, the decay
products, the pairwise diagonal, the quadrant; the consumers' wait for a
full buffer, v's split with the inter product, the intra product with the
store of y, the state update), runs it at the served prefill shape, and
prints the mean cycles per chunk of each phase for every warp of the CTA
(averaged over the CTAs), beside the kernel's time with and without the
stamps (CUDA events, in turns). A warp's phases add up to its chunk; where
one role waits on the other, the wait shows which of the two binds.

Run from the repository root on an sm_90 card:
    python3 tools/rwkv6_phases.py [--batch 4 --seq 4096 --heads 64 --dim 64]
The instrumented copy goes to build/ (gitignored).
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

# (text in the source, text put in its place); PT(k) adds the cycles since
# the previous stamp to phase k
STAMPS = [
    ("namespace {\n",
     "namespace {\n__device__ long long g_prof[4096 * 16 * 16];\n"
     "#define PT(k) { long long now_ = clock64(); prof[k] += now_ - last_; "
     "last_ = now_; }\n"),
    ("  for (int i = tid; i < P::kFloats; i += NALL) sm[i] = 0.f;\n",
     "  long long prof[16] = {}; long long last_ = clock64();\n"
     "  for (int i = tid; i < P::kFloats; i += NALL) sm[i] = 0.f;\n"),
    ("      bar_sync(1, NP);                      // the stage is in\n",
     "      PT(0)\n      bar_sync(1, NP);                      "
     "// the stage is in\n      PT(1)\n"),
    ("      // 1. per channel d, with w' = max(w, 1e-12)",
     "      PT(2)\n      // 1. per channel d, with w' = max(w, 1e-12)"),
    ("      // 2. the two 8 x 8 diagonal sub-blocks",
     "      PT(3)\n      // 2. the two 8 x 8 diagonal sub-blocks"),
    ("      bar_sync(1, NP);   // Q2 is whole; the stage is read\n",
     "      PT(4)\n      bar_sync(1, NP);   // Q2 is whole; the stage is "
     "read\n      PT(5)\n"),
    ("      bar_arrive(4 + bb, NALL);   // buffer bb is full\n",
     "      PT(6)\n      bar_arrive(4 + bb, NALL);   // buffer bb is full\n"),
    ("      if (n >= 0) bar_sync(2 + (n & 1), NALL);\n    return;\n",
     "      if (n >= 0) bar_sync(2 + (n & 1), NALL);\n    if (lane == 0)\n"
     "      for (int q = 0; q < 16; ++q)\n"
     "        g_prof[(blockIdx.x * 16 + warp) * 16 + q] = prof[q];\n"
     "    return;\n"),
    ("    bar_sync(4 + bb, NALL);   // buffer bb is full\n",
     "    PT(7)\n    bar_sync(4 + bb, NALL);   // buffer bb is full\n"
     "    PT(8)\n"),
    ("    {\n      float part[2][4] = {};\n#pragma unroll\n"
     "      for (int kb = 0; kb < C / 8; ++kb) {",
     "    PT(9)\n    {\n      float part[2][4] = {};\n#pragma unroll\n"
     "      for (int kb = 0; kb < C / 8; ++kb) {"),
    ("    // the state: S^T <- S^T diag(e^{L_c}) + v^T Khat",
     "    PT(10)\n    // the state: S^T <- S^T diag(e^{L_c}) + v^T Khat"),
    ("    bar_arrive(2 + bb, NALL);   // buffer bb is free\n  }\n",
     "    PT(11)\n    bar_arrive(2 + bb, NALL);   // buffer bb is free\n  }\n"
     "  if (lane == 0)\n    for (int q = 0; q < 16; ++q)\n"
     "      g_prof[(blockIdx.x * 16 + warp) * 16 + q] = prof[q];\n"),
]
PRODUCER = [(0, "wait for the stage"), (1, "producer sync"),
            (2, "free buffer + loads"), (3, "decay products"),
            (4, "diagonal"), (5, "producer sync"), (6, "quadrant")]
CONSUMER = [(7, "loop"), (8, "wait for a full buffer"),
            (9, "v split + inter"), (10, "intra + y"), (11, "state")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.kernels import _build, rwkv6_scan as rw

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    src = (ROOT / "src/repro_torch/csrc/rwkv6_scan.cu").read_text()
    for old, new in STAMPS:
        if src.count(old) != 1:
            sys.exit(f"the source changed; no single anchor {old[:60]!r}")
        src = src.replace(old, new)
    src += ('\nextern "C" int read_prof(void* host) {\n  return (int)'
            'cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));\n}\n')
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "rwkv6_phases.cu").write_text(src)
    lib_path = out_dir / "rwkv6_phases.so"
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
         str(out_dir / "rwkv6_phases.cu")], capture_output=True, text=True)
    if done.returncode:
        sys.exit(done.stdout + done.stderr)
    lib = ctypes.CDLL(str(lib_path))
    stamped = lib.rwkv6_scan_f32
    stamped.argtypes = (*rw._ARGS, ctypes.c_void_p)
    stamped.restype = ctypes.c_int

    b, s, h, d = args.batch, args.seq, args.heads, args.dim
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    r, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, s, h, d), generator=gen,
                                         device=dev) * 0.5))
    u = torch.randn((h, d), generator=gen, device=dev) * 0.1
    s0 = torch.randn((b, h, d, d), generator=gen, device=dev)
    y, s_out = torch.empty_like(r), torch.empty_like(s0)

    def run_stamped():
        err = stamped(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                      s_out.data_ptr(), b, s, h, d, 0,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"launch failed: CUDA error {err}")

    def run_kernel():
        rw.rwkv6_scan(r, k, v, w, u, s0)

    times = {"kernel": [], "stamped": []}
    for f in (run_kernel, run_stamped):
        f()
    torch.cuda.synchronize()
    for i in range(6):
        for name in (("kernel", "stamped") if i % 2 == 0
                     else ("stamped", "kernel")):
            f = run_kernel if name == "kernel" else run_stamped
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(5):
                f()
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1) / 5)
    run_stamped()
    torch.cuda.synchronize()
    buf = np.zeros(4096 * 16 * 16, dtype=np.int64)
    if lib.read_prof(ctypes.c_void_p(buf.ctypes.data)):
        sys.exit("reading the stamps failed")
    chunks = -(-s // 16)
    prof = buf.reshape(4096, 16, 16)[: b * h] / chunks
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{name.strip()}; r, k, v, w ({b},{s},{h},{d}) fp32")
    print(f"kernel {statistics.median(times['kernel']):.4f} ms, with the "
          f"stamps {statistics.median(times['stamped']):.4f} ms (events, "
          f"median of 6 runs of 5 calls in turns)")
    dp = 32 if d <= 32 else 64 if d <= 64 else 128
    n_warps = 4 + dp // 16
    print("cycles per chunk, mean over the CTAs:")
    for wi in range(n_warps):
        phases = PRODUCER if wi < 4 else CONSUMER
        role = "producer" if wi < 4 else "consumer"
        total = sum(prof[:, wi, i].mean() for i, _ in phases)
        print(f"  {role} warp {wi}: " + ", ".join(
            f"{label} {prof[:, wi, i].mean():.0f}" for i, label in phases)
            + f" (sum {total:.0f})")


if __name__ == "__main__":
    main()
