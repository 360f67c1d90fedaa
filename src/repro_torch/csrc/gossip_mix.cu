// Gossip mixing kernels for Hopper (sm_90a): the device step of D-PSGD.
//
// Replaces the two TPU (Pallas) kernels of src/repro/kernels/gossip_mix.py:
//
//   gossip_mix_rows_{f32,bf16}  <- _gossip_mix     (pallas_call at :62)
//       out[m, j] = sum_k W[m, k] * bufs[k, j]
//       W (M, K) fp32, bufs (K, N) fp32 or bf16, fp32 accumulation, output
//       (M, N) in the buffer dtype (bf16 rounds to nearest even). The TPU
//       signature gossip_mix(bufs, w) is the M = 1 case; the D-PSGD mix
//       X <- W X is M = K = n.
//
//   gossip_mix_q8_rows          <- _gossip_mix_q8  (pallas_call at :109)
//       out[m, j] = w_self[m] * self[m, j]
//                 + sum_k W_off[m, k] * q[k, j] * scales[k, j / 2048]
//       self (M, N) fp32 exact, q (K, Np) int8 with Np = N padded to whole
//       2048-lane blocks, scales (K, Np / 2048) fp32; output (M, N) fp32.
//       The TPU signature is M = 1 with w_self = w[0], W_off = w[1:]; the
//       D-PSGD int8 receive is M = K = n with w_self = diag(W) and
//       W_off = W - diag(diag(W)).
//
// What bounds them on an H100: memory, then launch latency. Each output
// lane costs 2K flops against (K + 1) * 4 bytes (q8: K + 8 bytes), far
// below the ~20 flop/byte where fp32 FMA throughput would bind. At the
// paper's sizes (n = 6 nodes, N = 21 840 parameters) the rows mix moves
// 6 * 21 840 * 4 B in and the same out, 1.05 MB, i.e. ~0.31 us at 3.35 TB/s;
// the q8 receive moves 524 KB self + 135 KB int8 + 524 KB out, ~0.35 us.
// Both are far below a kernel launch (a few us), so at these sizes they are
// bound by launch latency, not by bytes.
//
// What the design does about it: one pass over the inputs, every byte read
// once per output row and written once (the TPU kernel's VMEM fusion, here
// in registers). The weight row sits in shared memory; each thread owns a
// few adjacent lanes and loads them 16 bytes at a time where the rows are
// aligned (scalar loads on a ragged tail), loops over k, and writes its
// lanes once. The TPU's 8192-lane tiling and padding are not carried over:
// the kernel masks the ragged edge itself. In the q8 kernel a thread's 4
// lanes never straddle a 2048-lane scale block (4 divides 2048), so one
// scale load serves them, and int8 lanes are dequantized in registers and
// never written back at fp32 width. Nothing is allocated here: the Python
// wrapper allocates the output; the launch goes on the caller's stream and
// every entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kScaleBlock = 2048;  // == core.compression._BLOCK

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid (ceil(n / (kThreads * V)), M); V = 16 / sizeof(T) lanes per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_rows_kernel(const float* __restrict__ w,
                           const T* __restrict__ bufs, T* __restrict__ out,
                           int k_total, long long n, bool vec) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float w_row[];
  const int m = blockIdx.y;
  for (int k = threadIdx.x; k < k_total; k += blockDim.x)
    w_row[k] = w[(long long)m * k_total + k];
  __syncthreads();

  const long long lane0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (lane0 >= n) return;
  T* dst = out + (long long)m * n + lane0;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  if (vec && lane0 + V <= n) {
    for (int k = 0; k < k_total; ++k) {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(bufs + (long long)k * n + lane0));
      const T* x = reinterpret_cast<const T*>(&raw);
      const float wk = w_row[k];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(wk, to_f32(x[v]), acc[v]);
    }
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int v = 0; v < V; ++v) store(o + v, acc[v]);
    *reinterpret_cast<uint4*>(dst) = packed;
  } else {
    const long long left = n - lane0;
    for (int k = 0; k < k_total; ++k) {
      const T* src = bufs + (long long)k * n + lane0;
      const float wk = w_row[k];
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < left) acc[v] = fmaf(wk, to_f32(src[v]), acc[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < left) store(dst + v, acc[v]);
  }
}

// grid (ceil(n / (kThreads * 4)), M); 4 lanes per thread (one float4 of
// self / out, one char4 of each payload).
__global__ void __launch_bounds__(kThreads)
    gossip_mix_q8_rows_kernel(const float* __restrict__ w_self,
                              const float* __restrict__ w_off,
                              const float* __restrict__ self,
                              const int8_t* __restrict__ q,
                              const float* __restrict__ scales,
                              float* __restrict__ out, int k_total,
                              long long n, long long np, bool vec) {
  constexpr int V = 4;
  extern __shared__ float w_row[];  // [0]: self weight, [1 + k]: payload k
  const int m = blockIdx.y;
  if (threadIdx.x == 0) w_row[0] = w_self[m];
  for (int k = threadIdx.x; k < k_total; k += blockDim.x)
    w_row[k + 1] = w_off[(long long)m * k_total + k];
  __syncthreads();

  const long long lane0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (lane0 >= n) return;
  const long long blk = lane0 / kScaleBlock;  // shared by all V lanes
  const long long n_blocks = np / kScaleBlock;
  const float* x = self + (long long)m * n + lane0;
  float* dst = out + (long long)m * n + lane0;
  float acc[V];

  if (vec && lane0 + V <= n) {
    const float4 xs = __ldg(reinterpret_cast<const float4*>(x));
    acc[0] = w_row[0] * xs.x;
    acc[1] = w_row[0] * xs.y;
    acc[2] = w_row[0] * xs.z;
    acc[3] = w_row[0] * xs.w;
    for (int k = 0; k < k_total; ++k) {
      const char4 qv =
          *reinterpret_cast<const char4*>(q + (long long)k * np + lane0);
      const float s = __ldg(scales + (long long)k * n_blocks + blk);
      const float wk = w_row[k + 1];
      acc[0] = fmaf(wk, (float)qv.x * s, acc[0]);
      acc[1] = fmaf(wk, (float)qv.y * s, acc[1]);
      acc[2] = fmaf(wk, (float)qv.z * s, acc[2]);
      acc[3] = fmaf(wk, (float)qv.w * s, acc[3]);
    }
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    const long long left = n - lane0;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = v < left ? w_row[0] * x[v] : 0.f;
    for (int k = 0; k < k_total; ++k) {
      const int8_t* qk = q + (long long)k * np + lane0;
      const float s = scales[(long long)k * n_blocks + blk];
      const float wk = w_row[k + 1];
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < left) acc[v] = fmaf(wk, (float)qk[v] * s, acc[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < left) dst[v] = acc[v];
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch_rows(const void* w, const void* bufs, void* out, int m, int k,
                long long n, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (n % V == 0) && aligned16(bufs) && aligned16(out);
  const long long lanes = (long long)kThreads * V;
  const dim3 grid((unsigned)((n + lanes - 1) / lanes), (unsigned)m);
  gossip_mix_rows_kernel<T>
      <<<grid, kThreads, k * sizeof(float), (cudaStream_t)stream>>>(
          static_cast<const float*>(w), static_cast<const T*>(bufs),
          static_cast<T*>(out), k, n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry: pointers to contiguous device buffers on the stream's
// device; the Python wrapper checks shapes, types and devices first.
int gossip_mix_rows_f32(const void* w, const void* bufs, void* out, int m,
                        int k, long long n, void* stream) {
  return launch_rows<float>(w, bufs, out, m, k, n, stream);
}

int gossip_mix_rows_bf16(const void* w, const void* bufs, void* out, int m,
                         int k, long long n, void* stream) {
  return launch_rows<__nv_bfloat16>(w, bufs, out, m, k, n, stream);
}

int gossip_mix_q8_rows(const void* w_self, const void* w_off,
                       const void* self, const void* q, const void* scales,
                       void* out, int m, int k, long long n, long long np,
                       void* stream) {
  constexpr int V = 4;
  const bool vec = (n % V == 0) && aligned16(self) && aligned16(out) &&
                   (reinterpret_cast<uintptr_t>(q) & 3u) == 0;
  const long long lanes = (long long)kThreads * V;
  const dim3 grid((unsigned)((n + lanes - 1) / lanes), (unsigned)m);
  gossip_mix_q8_rows_kernel<<<grid, kThreads, (k + 1) * sizeof(float),
                              (cudaStream_t)stream>>>(
      static_cast<const float*>(w_self), static_cast<const float*>(w_off),
      static_cast<const float*>(self), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<float*>(out), k, n, np,
      vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
