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
//       The weights are read in place: w_self[m] at w_self + m * ss and
//       W_off[m, k] at w_off + m * ldw + k, and with skip_diag set the
//       entry k = m reads as 0. The D-PSGD int8 receive (M = K = n) passes
//       W whole: w_self = w_off = W, ss = n + 1 (the diagonal's stride),
//       ldw = n, skip_diag = 1, so the round builds no diag(W) and no
//       W - diag(diag(W)). The TPU signature is M = 1 with weights = [w_self,
//       w_off...]: w_self = weights, w_off = weights + 1, stride 1, no skip.
//
// What bounds them on an H100: launch latency, then bytes. Each output
// lane costs 2K flops against (K + 1) * 4 bytes (q8: K + 8 bytes), far
// below the ~20 flop/byte where fp32 FMA throughput would bind. At the
// paper's sizes (n = 6 nodes, N = 21 840 parameters) the rows mix moves
// 6 * 21 840 * 4 B in and the same out, 1.05 MB, i.e. ~0.31 us at 3.35 TB/s;
// the q8 receive moves 524 KB self + 131 KB int8 + 524 KB out, ~0.35 us.
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
// (fmaf), and bf16 output rounds to nearest even. Loads are 8 bytes where
// the rows are aligned (scalar loads on a ragged tail or a misaligned
// view); the TPU's 8192-lane tiling and padding are not carried over: the
// kernels mask the ragged edge themselves.
//
// The q8 receive runs right behind the int8 send (csrc/quantize.cu,
// quantize_int8_ef) in every int8 round, so it is shaped for the gap
// between two launches. Each thread owns 8 adjacent lanes of one output
// row: two 16-byte loads of self, one 8-byte load per payload (8 | 2048,
// so one scale serves the 8 lanes), two 16-byte stores. Its weights come
// straight from global memory into registers (a warp reads the same
// address, one broadcast), with no barrier ahead of any load, and all the
// payload and scale loads of a group of up to 8 payloads are issued
// before its FMAs (K > 8 in groups of 8, as the rows mix does). The grid is
// (ceil(N / 1024), M) blocks of 128: 22 x 6 = 132 blocks at the paper's
// receive, one per SM. It is launched as a programmatic dependent
// (cudaLaunchAttributeProgrammaticStreamSerialization): its blocks may
// start while the kernel ahead of it on the stream finishes and execute
// griddepcontrol.wait before they read what that kernel wrote; the wait
// returns once it has completed and its writes are visible. Every block
// waits, also one with no lanes. In the int8 round the kernel ahead is the
// send, which writes q, the scales and the residual and only reads flat
// (the receive's self): there the blocks load their weights and self
// before the wait (after_send), and only q and the scales after it. Any
// other caller gets the wait first, right whatever ran ahead. The sum runs self first, then k = 0 .. K-1 in fp32 (fmaf
// of the weight and q * scale, the product rounded first); int8 lanes are
// dequantized in registers and never written back at fp32 width.
//
// Nothing is allocated here: the Python wrapper allocates the output; the
// launch goes on the caller's stream and every entry returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

constexpr int kQ8Threads = 128;  // threads of a q8 block
constexpr int kQ8Lanes = 8;      // lanes per thread
constexpr int kQ8Group = 8;      // payloads loaded before their FMAs

// kQ8Group weights of row m from payload k0 on (0 past K and on the
// skipped diagonal), straight into registers.
__device__ __forceinline__ void q8_weights(const float* __restrict__ w_row,
                                           int k0, int k_total, int diag,
                                           float* wk) {
#pragma unroll
  for (int j = 0; j < kQ8Group; ++j) {
    const int k = k0 + j;
    wk[j] = (k < k_total && k != diag) ? __ldg(w_row + k) : 0.f;
  }
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// grid (ceil(n / (kQ8Threads * kQ8Lanes)), M); 8 lanes of row m a thread.
// kEarly: the weights and self are loaded ahead of the wait (the caller
// guarantees that the kernel ahead writes neither); otherwise the wait
// comes first, right for any kernel ahead.
template <bool kEarly>
__global__ void __launch_bounds__(kQ8Threads)
    gossip_mix_q8_rows_kernel(const float* __restrict__ w_self,
                              long long self_stride,
                              const float* __restrict__ w_off, long long ldw,
                              int skip_diag, const float* __restrict__ self,
                              const int8_t* __restrict__ q,
                              const float* __restrict__ scales,
                              float* __restrict__ out, int k_total,
                              long long n, long long np, bool vec,
                              bool q_vec) {
  constexpr int V = kQ8Lanes;
  const int m = blockIdx.y;
  const long long lane0 =
      ((long long)blockIdx.x * kQ8Threads + threadIdx.x) * V;
  const bool active = lane0 < n;
  const bool full = vec && lane0 + V <= n;
  const float* w_row = w_off + (long long)m * ldw;
  const int diag = skip_diag ? m : -1;

  if constexpr (!kEarly) grid_dependency_wait();
  // with kEarly, ahead of the wait: what the kernel in front does not write
  const float ws = __ldg(w_self + (long long)m * self_stride);
  float wk[kQ8Group];
  q8_weights(w_row, 0, k_total, diag, wk);
  float acc[V];
  const float* x = self + (long long)m * n + lane0;
  if (full) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + 4));
    acc[0] = a.x; acc[1] = a.y; acc[2] = a.z; acc[3] = a.w;
    acc[4] = b.x; acc[5] = b.y; acc[6] = b.z; acc[7] = b.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = lane0 + v < n ? __ldg(x + v) : 0.f;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = __fmul_rn(ws, acc[v]);
  // q and the scales come from the kernel in front: wait for its end
  if constexpr (kEarly) grid_dependency_wait();
  if (!active) return;

  const long long blk = lane0 / kScaleBlock;  // shared by all V lanes
  const long long n_blocks = np / kScaleBlock;
  for (int k0 = 0; k0 < k_total; k0 += kQ8Group) {
    if (k0 > 0) q8_weights(w_row, k0, k_total, diag, wk);
    uint2 raw[kQ8Group];
    float s[kQ8Group];
#pragma unroll
    for (int j = 0; j < kQ8Group; ++j) {
      const int k = k0 + j;
      if (k < k_total) {
        // lane0 + 8 <= Np: the payload's padding lies inside its row
        const int8_t* src = q + (long long)k * np + lane0;
        if (q_vec) {
          raw[j] = __ldg(reinterpret_cast<const uint2*>(src));
        } else {
          int8_t* b = reinterpret_cast<int8_t*>(&raw[j]);
#pragma unroll
          for (int v = 0; v < V; ++v) b[v] = src[v];
        }
        s[j] = __ldg(scales + (long long)k * n_blocks + blk);
      }
    }
#pragma unroll
    for (int j = 0; j < kQ8Group; ++j) {
      if (k0 + j < k_total) {
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw[j]);
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = fmaf(wk[j], __fmul_rn((float)b[v], s[j]), acc[v]);
      }
    }
  }
  float* dst = out + (long long)m * n + lane0;
  if (full) {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (lane0 + v < n) dst[v] = acc[v];
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

// The q8 receive (see the kernel): w_self read at stride ss, W_off at row
// stride ldw, its diagonal read as 0 with skip_diag; q (k, np) int8 with
// np a multiple of 2048, scales (k, np / 2048). Launched as a programmatic
// dependent of the kernel ahead of it on the stream; after_send = 1 (the
// int8 round: the send just launched, nothing since, and it wrote neither
// the weights nor self) loads the weights and self before the wait.
int gossip_mix_q8_rows(const void* w_self, long long ss, const void* w_off,
                       long long ldw, int skip_diag, const void* self,
                       const void* q, const void* scales, void* out, int m,
                       int k, long long n, long long np, int after_send,
                       void* stream) {
  const bool vec = (n % 4 == 0) && aligned(self, 16) && aligned(out, 16);
  const bool q_vec = aligned(q, 8);
  const long long lanes = (long long)kQ8Threads * kQ8Lanes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + lanes - 1) / lanes), (unsigned)m);
  cfg.blockDim = dim3(kQ8Threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg,
      after_send ? gossip_mix_q8_rows_kernel<true>
                 : gossip_mix_q8_rows_kernel<false>,
      static_cast<const float*>(w_self), ss,
      static_cast<const float*>(w_off), ldw, skip_diag,
      static_cast<const float*>(self), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<float*>(out), k, n, np,
      vec, q_vec);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // extern "C"
