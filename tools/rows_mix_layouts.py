#!/usr/bin/env python3
"""Time layouts of the D-PSGD rows mix ``out = W @ X`` on one CUDA card.

The rows mix of ``src/repro_torch/csrc/gossip_mix.cu`` at the paper's
shape (W 6 x 6, X 6 x 21 840 fp32) is a few microseconds of device time,
bound by how many loads a layout keeps in flight more than by bytes. This
script builds one templated kernel in which each thread owns V adjacent
lanes (V = 1, 2, 4: 4-, 8- or 16-byte loads) of R consecutive output rows
(R = 1, 2, 3, 6; R = 6 reads every input byte in one thread, R = 1 is one
output row per thread) at 64, 128 and 256 threads a block, holds each
against the plain version (1e-5), and times each as 100 back-to-back calls
captured into one CUDA graph, replayed between CUDA events (median of 7
replays), beside the port's own wrapper, ``torch.matmul`` and a plain copy
of X, all captured the same way. Prints the layouts fastest first, then the
card's ``nvidia-smi`` name and power limit.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/rows_mix_layouts.py
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KERNEL = r"""
#include <cuda_runtime.h>
template <int V> struct Vec;
template <> struct Vec<1> { typedef float T; };
template <> struct Vec<2> { typedef float2 T; };
template <> struct Vec<4> { typedef float4 T; };
template <int M, int V, int R>
__global__ void layout_kernel(const float* __restrict__ w,
                              const float* __restrict__ x,
                              float* __restrict__ out, int K, long long n) {
  typedef typename Vec<V>::T VT;
  __shared__ float ws[M * 8];
  for (int i = threadIdx.x; i < M * K; i += blockDim.x) ws[i] = w[i];
  __syncthreads();
  const int r0 = blockIdx.y * R;
  const long long lane0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (lane0 >= n) return;
  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  VT raw[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < K) raw[k] = __ldg(reinterpret_cast<const VT*>(x + k * n + lane0));
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < K) {
      const float* xv = reinterpret_cast<const float*>(&raw[k]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float wk = ws[(r0 + r) * K + k];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(wk, xv[v], acc[r][v]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    VT o;
    float* of = reinterpret_cast<float*>(&o);
#pragma unroll
    for (int v = 0; v < V; ++v) of[v] = acc[r][v];
    *reinterpret_cast<VT*>(out + (r0 + r) * n + lane0) = o;
  }
}
template <int V, int R>
int run(const void* w, const void* x, void* out, int K, long long n,
        int threads, void* s) {
  dim3 grid((unsigned)((n / V + threads - 1) / threads), 6 / R);
  layout_kernel<6, V, R><<<grid, threads, 0, (cudaStream_t)s>>>(
      (const float*)w, (const float*)x, (float*)out, K, n);
  return (int)cudaGetLastError();
}
extern "C" int layout(int v, int r, const void* w, const void* x, void* out,
                      int K, long long n, int threads, void* s) {
#define L(V, R) if (v == V && r == R) return run<V, R>(w, x, out, K, n, threads, s);
  L(1, 1) L(1, 2) L(1, 3) L(1, 6) L(2, 1) L(2, 2) L(2, 3) L(2, 6)
  L(4, 1) L(4, 2) L(4, 3) L(4, 6)
  return -1;
}
"""


def graph_us(torch, fn, reps: int = 100, rounds: int = 7) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps * 1e3)
    return statistics.median(times)


def main() -> None:
    import torch

    from repro_torch.kernels import _build, gossip_mix as gm

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    src, lib_path = build / "rows_mix_layouts.cu", build / "rows_mix_layouts.so"
    src.write_text(KERNEL)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.layout.argtypes = (i, i, p, p, p, i, ll, i, p)

    n = 21_840
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, n), generator=g).cuda()
    w = torch.softmax(torch.randn((6, 6), generator=g), -1).cuda()
    out = torch.empty_like(x)
    want = gm.gossip_mix_rows_plain(w, x)

    def stream():
        return torch._C._cuda_getCurrentRawStream(x.device.index)
    rows = []
    for v in (1, 2, 4):
        for r in (1, 2, 3, 6):
            for threads in (64, 128, 256):
                def call(v=v, r=r, threads=threads):
                    return lib.layout(v, r, w.data_ptr(), x.data_ptr(),
                                      out.data_ptr(), 6, n, threads, stream())
                out.zero_()
                if call() != 0:
                    sys.exit(f"launch failed: V={v} R={r} threads={threads}")
                torch.cuda.synchronize()
                e = float((out - want).abs().max())
                if e > 1e-5:
                    sys.exit(f"V={v} R={r} threads={threads}: max|err| {e}")
                rows.append((graph_us(torch, call),
                             f"V={v} lanes ({4 * v}-byte loads), R={r} rows, "
                             f"{threads} threads"))
    rows.append((graph_us(torch, lambda: gm.gossip_mix_rows(w, x)),
                 "the port's gossip_mix_rows"))
    rows.append((graph_us(torch, lambda: torch.matmul(w, x)), "torch.matmul"))
    rows.append((graph_us(torch, lambda: out.copy_(x)), "copy of X (0.52 MB)"))
    print(f"W (6x6) @ X (6x{n}) fp32, us per call, 100 calls in a CUDA graph:")
    for us, label in sorted(rows):
        print(f"   {us:7.3f}  {label}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
