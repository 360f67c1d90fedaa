// RG-LRU linear recurrence for Hopper (sm_90a): the time scan of the port's
// `rglru` layers, in prefill and in decode.
//
// Replaces the TPU (Pallas) kernel of src/repro/kernels/rglru_scan.py
// (_rglru_scan, pallas_call at :59), reached through ops.rglru:
//
//   h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + b[b, t, d],
//   h[b, -1, d] = h0[b, d] (0 without h0)
//
//   a, b (B, S, D) fp32 contiguous, h0 (B, D) fp32 or null, out (B, S, D)
//   fp32. Elementwise over channels, sequential over time, fp32 carry; one
//   fused multiply-add per step.
//
// What bounds it on an H100: bytes, and below them latency. At the served
// prefill (B = 4, S = 4096, D = 2560) a, b and h are 167.8 MB each: 503 MB
// per launch, 0.150 ms at 3.35 TB/s. A decode launch (S = 1) moves 123 KB
// and is bound by the launch itself.
//
// What the design does about it: one thread per (batch, channel) carries h
// in a register and walks time; neighbouring threads hold neighbouring
// channels, so every load and store of a warp is one coalesced 128-byte
// row segment. Each thread starts the loads of kAhead steps before it
// uses them, so kAhead * 2 loads per thread are in flight while the chain
// of dependent multiply-adds runs. At the served shape that is only
// B * D = 10 240 threads (160 blocks of 64), fewer than the card needs to
// cover memory latency; a chunked two-pass scan (local scans of time
// chunks, then a carry pass) is later work. The TPU's 128-lane channel
// blocks and padding of S are not carried over: the kernel masks the
// ragged edge itself. Nothing is allocated here: the Python wrapper
// allocates the output; the launch goes on the caller's stream and every
// entry returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kAhead = 16;

// grid (ceil(D / kThreads), B)
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ out,
                      int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long base = (long long)blockIdx.y * S * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = out + base;
  float h = h0 != nullptr ? h0[(long long)blockIdx.y * D + d] : 0.f;
  int t = 0;
  for (; t + kAhead <= S; t += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      av[i] = __ldg(ap + (long long)(t + i) * D);
      bv[i] = __ldg(bp + (long long)(t + i) * D);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      h = fmaf(av[i], h, bv[i]);
      op[(long long)(t + i) * D] = h;
    }
  }
  for (; t < S; ++t) {
    h = fmaf(__ldg(ap + (long long)t * D), h, __ldg(bp + (long long)t * D));
    op[(long long)t * D] = h;
  }
}

}  // namespace

extern "C" {

// a, b, out: contiguous (B, S, D) fp32 device buffers; h0: (B, D) fp32 or
// null. The Python wrapper checks shapes, types and devices first.
int rglru_scan_f32(const void* a, const void* b, const void* h0, void* out,
                   int B, int S, int D, void* stream) {
  const dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  rglru_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), S, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
