#!/usr/bin/env python3
"""Cycles per stage of the RWKV-6 backward's chunk kernel, from clock64()
stamps, on one CUDA card.

``csrc/rwkv6_scan_bwd.cu``'s second launch (``rwkv6_bwd_chunk_kernel``, a
CTA per (batch, head, group of four 16-step chunks)) runs each chunk as
stages ended by ``__syncthreads()``. This tool copies the source into
``build/``, puts a ``clock64()`` stamp of thread 0 after every barrier of
that kernel (and one at its start), builds the copy with the port's nvcc
flags and calls its entry at rwkv6-7b's training shape (B 12 = 3 nodes x
batch 4, S 512, H 64, D 64, u per batch row) with random inputs. It reads
the stamps of 64 CTAs from CTA ``--first`` on (0: the first wave, which
loads its rows together; a later one sees the steady state) and prints
the median cycles from each stamp to the next, labelled with the barrier
that ends the stage (its number in the kernel's text, 1 the first) and
the source line before it. The stamps cost a few cycles each; the
kernel's results are not checked here (tools/scan_bwd_ab.py holds them).

Run from the repository root on a machine with a card and nvcc:
    python3 tools/rwkv6_bwd_stages.py [--first 3000]
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SOURCE = ROOT / "src/repro_torch/csrc/rwkv6_scan_bwd.cu"
SLOTS = 96        # stamps kept a CTA
CTAS = 64         # CTAs read


def instrument(src: str, first: int) -> tuple[str, list[str]]:
    """The source with stamps in the chunk kernel, and per barrier number
    the line before it."""
    start = src.index("rwkv6_bwd_chunk_kernel(const float* __restrict__ r,")
    end = src.index("// 3. du")
    body, labels = src[start:end], []

    def stamp(m):
        labels.append(body[:m.start()].rstrip().splitlines()[-1].strip())
        return f"__syncthreads(); STAMP({len(labels)});"
    body = re.sub(r"__syncthreads\(\);", stamp, body)
    body = body.replace(
        "  using P = ChunkPlan<DP>;\n",
        "  using P = ChunkPlan<DP>;\n  long long st_[SLOTS]; int id_[SLOTS];"
        " int ns_ = 1; id_[0] = 0; st_[0] = clock64();\n", 1)
    close = body.rstrip().rfind("}")
    body = (body[:close]
            + "  if (threadIdx.x == 0 && blockIdx.x >= FIRST && blockIdx.x <"
              " FIRST + CTAS) {\n    const int c = blockIdx.x - FIRST;\n"
              "    for (int i = 0; i < ns_; ++i) g_stamp[c][i] = st_[i],"
              " g_id[c][i] = id_[i];\n    g_n[c] = ns_;\n  }\n"
            + body[close:])
    head = (f"#define SLOTS {SLOTS}\n#define CTAS {CTAS}\n#define FIRST {first}"
            "\n__device__ long long g_stamp[CTAS][SLOTS];\n"
            "__device__ int g_id[CTAS][SLOTS];\n__device__ int g_n[CTAS];\n"
            "#define STAMP(i) do { if (ns_ < SLOTS) { id_[ns_] = (i); "
            "st_[ns_++] = clock64(); } } while (0)\n")
    out = src[:start] + body + src[end:]
    out = out.replace("namespace {\n", "namespace {\n" + head, 1)
    out = out.replace(
        'extern "C" {\n',
        'extern "C" {\nint read_stamps(void* s, void* ids, void* n) {\n'
        "  cudaMemcpyFromSymbol(s, g_stamp, sizeof(g_stamp));\n"
        "  cudaMemcpyFromSymbol(ids, g_id, sizeof(g_id));\n"
        "  return (int)cudaMemcpyFromSymbol(n, g_n, sizeof(g_n));\n}\n", 1)
    return out, labels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first", type=int, default=3000,
                    help="the first CTA read (0: the first wave)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_scan as rw

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    text, labels = instrument(SOURCE.read_text(), args.first)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "rwkv6_bwd_stages.cu"
    so = cu.with_suffix(".so")
    cu.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.rwkv6_scan_bwd_f32
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = (p,) * 15 + (i,) * 4 + (ll, ll, p)
    fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, h, d = 12, 512, 64, 64
    r, k, v, dy = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   for _ in range(4))
    w = torch.exp(-torch.exp(torch.randn((b, s, h, d), generator=gen,
                                         device=dev) * 0.5))
    u = torch.randn((b, h, d), generator=gen, device=dev) * 0.1
    outs = [torch.empty_like(r) for _ in range(4)]
    du = torch.empty((b, h, d), device=dev)
    ws = torch.empty(rw.bwd_workspace_bytes(b, s, h, d) // 4, device=dev)
    for _ in range(3):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None, dy.data_ptr(), None,
                 *(x.data_ptr() for x in outs), du.data_ptr(), None,
                 ws.data_ptr(), b, s, h, d, h * d, 4 * ws.numel(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    st = np.zeros((CTAS, SLOTS), np.int64)
    ids = np.zeros((CTAS, SLOTS), np.int32)
    n = np.zeros(CTAS, np.int32)
    lib.read_stamps(st.ctypes.data, ids.ctypes.data, n.ctypes.data)
    m = int(n.min())
    if m < 2:
        raise SystemExit(f"CTAs {args.first}.. were not stamped (grid too "
                         "small?)")
    dt = np.diff(st[:, :m], axis=1)
    print(f"CTAs {args.first} .. {args.first + CTAS - 1} at ({b}, {s}, {h},"
          f" {d}): median {int(np.median(st[:, m - 1] - st[:, 0]))} cycles "
          f"a CTA, {m - 1} stages")
    for j in range(m - 1):
        bar = int(ids[0, j + 1])
        print(f"  stage {j:2d}: {int(np.median(dt[:, j])):6d} cycles, to "
              f"barrier {bar:2d} (after: {labels[bar - 1][:60]})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
