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
// What bounds them on an H100: launch latency, then bytes. Each output
// lane costs 2K flops against (K + 1) * 4 bytes (q8: K + 8 bytes), far
// below the ~20 flop/byte where fp32 FMA throughput would bind. At the
// paper's sizes (n = 6 nodes, N = 21 840 parameters) the rows mix moves
// 6 * 21 840 * 4 B in and the same out, 1.05 MB, i.e. ~0.31 us at 3.35 TB/s;
// the q8 receive moves 524 KB self + 135 KB int8 + 524 KB out, ~0.35 us.
// Both are far below a kernel launch (a few us): what a call costs is its
// launch, on the host (the wrapper and ctypes, 30+ us before the lean path
// of kernels/_build.py) and on the device (~2 us from launch to the last
// store). Replayed in a CUDA graph (core/dpsgd.py), the host cost goes and
// the device time is what is left; there a kernel must reach its bytes in
// one short wave.
//
// What the design does about it. The rows mix is one kernel form
// (gossip_mix_rows_kernel) for every M: each thread owns V = 8 / sizeof(T)
// adjacent lanes (one 8-byte load per input row: 2 fp32 or 4 bf16 lanes)
// of R = 2 consecutive output rows (R = 1 when M = 1, the TPU signature),
// keeps acc[R][V] in registers, loads its lanes of up to 8 input rows
// before it uses them (8 loads in flight per thread), and writes each of
// its output lanes once. The grid is (ceil(N / (128 V)), ceil(M / R)),
// 128 threads a block, and a block's R weight rows sit in shared memory.
// At the paper's mix (M = K = 6, N = 21 840 fp32) that is 86 x 3 = 258
// blocks of 128 threads: X (0.52 MB) crosses L2 three times but is read
// from HBM once, as the output is written once. Why not one pass over all
// M rows per thread (every input byte read by one thread only): on the
// card the mix is bound by how many loads are in flight, not by L2
// traffic. Timed as 100 calls in a CUDA graph on one H100 (the script
// tools/rows_mix_layouts.py; PERF.md), all six rows per thread with
// 16-byte loads took 2.33-2.73 us per call, one row per thread with
// 16-byte loads in blocks of 256 (the earlier grid (ceil(N / 1024), M))
// 2.10 us, two rows of two lanes in blocks of 128 1.92 us, and a plain
// copy of X 1.28 us. The sum over k runs in order k = 0 .. K-1 in fp32
// (fmaf), and bf16 output rounds to nearest even. Loads are 8 bytes where the rows are aligned
// (scalar loads on a ragged tail or a misaligned view); the TPU's
// 8192-lane tiling and padding are not carried over: the kernels mask the
// ragged edge themselves. In the q8 kernel a thread's 4 lanes never
// straddle a 2048-lane scale block (4 divides 2048), so one scale load
// serves them, and int8 lanes are dequantized in registers and never
// written back at fp32 width. Nothing is allocated here: the Python
// wrapper allocates the output; the launch goes on the caller's stream and
// every entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // threads of a q8 block
constexpr long long kScaleBlock = 2048;  // == core.compression._BLOCK

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kRowThreads = 128;  // threads of a rows-mix block
constexpr int kChunk = 8;         // input rows loaded before their FMAs

// grid (ceil(n / (kRowThreads * V)), ceil(m / R)); V = 8 / sizeof(T) lanes
// of R consecutive output rows per thread.
template <typename T, int R>
__global__ void __launch_bounds__(kRowThreads)
    gossip_mix_rows_kernel(const float* __restrict__ w,
                           const T* __restrict__ bufs, T* __restrict__ out,
                           int m_total, int k_total, long long n, bool vec) {
  constexpr int V = 8 / sizeof(T);
  extern __shared__ float w_s[];  // this block's rows of W, (rows, K)
  const int r0 = blockIdx.y * R;
  const int rows = min(R, m_total - r0);
  for (int i = threadIdx.x; i < rows * k_total; i += blockDim.x)
    w_s[i] = w[(long long)r0 * k_total + i];
  __syncthreads();

  const long long lane0 =
      ((long long)blockIdx.x * kRowThreads + threadIdx.x) * V;
  if (lane0 >= n) return;
  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;

  if (vec && lane0 + V <= n) {
    for (int k0 = 0; k0 < k_total; k0 += kChunk) {
      uint2 raw[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (k0 + j < k_total)
          raw[j] = __ldg(reinterpret_cast<const uint2*>(
              bufs + (long long)(k0 + j) * n + lane0));
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + j < k_total) {
          const T* x = reinterpret_cast<const T*>(&raw[j]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < rows) {
              const float wk = w_s[r * k_total + k0 + j];
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[r][v] = fmaf(wk, to_f32(x[v]), acc[r][v]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        uint2 packed;
        T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
        for (int v = 0; v < V; ++v) store(o + v, acc[r][v]);
        *reinterpret_cast<uint2*>(out + (long long)(r0 + r) * n + lane0) =
            packed;
      }
    }
  } else {
    const long long left = n - lane0;
    for (int k = 0; k < k_total; ++k) {
      const T* src = bufs + (long long)k * n + lane0;
      float x[V];
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = v < left ? to_f32(src[v]) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const float wk = w_s[r * k_total + k];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = fmaf(wk, x[v], acc[r][v]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (r < rows && v < left)
          store(out + (long long)(r0 + r) * n + lane0 + v, acc[r][v]);
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

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, int R>
int launch_rows(const void* w, const void* bufs, void* out, int m, int k,
                long long n, void* stream) {
  constexpr int V = 8 / sizeof(T);
  const bool vec = (n % V == 0) && aligned(bufs, 8) && aligned(out, 8);
  const long long lanes = (long long)kRowThreads * V;
  const dim3 grid((unsigned)((n + lanes - 1) / lanes),
                  (unsigned)((m + R - 1) / R));
  gossip_mix_rows_kernel<T, R>
      <<<grid, kRowThreads, R * k * sizeof(float), (cudaStream_t)stream>>>(
          static_cast<const float*>(w), static_cast<const T*>(bufs),
          static_cast<T*>(out), m, k, n, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* w, const void* bufs, void* out, int m, int k,
                long long n, void* stream) {
  return m == 1 ? launch_rows<T, 1>(w, bufs, out, m, k, n, stream)
                : launch_rows<T, 2>(w, bufs, out, m, k, n, stream);
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
  const bool vec = (n % V == 0) && aligned(self, 16) && aligned(out, 16) &&
                   aligned(q, 4);
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
