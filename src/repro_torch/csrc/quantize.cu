// Block-scaled int8 codec kernels for Hopper (sm_90a).
//
// Replaces the two TPU (Pallas) kernels of src/repro/kernels/quantize.py:
//
//   quantize_int8_{f32,bf16}_b{256,2048}     <- _quantize_int8   (:53)
//       per row r and scale block b of BLOCK lanes:
//         scale[r, b] = max_j |x[r, j]| / 127, with 0 mapped to 1
//         q[r, j]     = clamp(round_half_even(x[r, j] / scale), -127, 127)
//       x (R, L) fp32 or bf16 read in place; q (R, Lp) int8 and
//       scale (R, Lp / BLOCK) fp32 with Lp = L rounded up to whole blocks.
//       Lanes L <= j < Lp read as 0 and write q = 0: the zero padding of
//       the wire format, without padding x in device memory.
//
//   dequantize_int8_{f32,bf16}_b{256,2048}   <- _dequantize_int8 (:85)
//       out[r, j] = q[r, j] * scale[r, j / BLOCK] for j < L, one fp32
//       multiply, written as fp32 or bf16 (round to nearest even).
//
// BLOCK = 256 is the TPU kernel's own contract (kernels.ops.quantize_int8);
// BLOCK = 2048 is core.compression's wire format, the codec every int8
// D-PSGD round runs (dpsgd._compress_and_mix: one quantize of the (n, L)
// message, one dequantize for the error-feedback residual).
//
// Bit-equality with the plain versions (and with the JAX package's oracle,
// ref.quantize_int8_ref) is the contract, so both divisions are IEEE
// round-to-nearest (__fdiv_rn, which --use_fast_math cannot turn into a
// multiply by the reciprocal) and rounding is half to even (rintf, never
// roundf). The max of |x| is exact in any order. Non-finite inputs are not
// part of the contract: a NaN propagates into the block's scale, as
// torch.amax propagates it.
//
// What bounds them on an H100: bytes, then launch latency. Quantize reads
// 4 (bf16: 2) bytes per lane and writes 1 plus 4 per block; dequantize reads
// 1 and writes 4 (2). A handful of operations per lane is far below the card's
// fp32 rate. At the paper's message, (6, 21 840) fp32 into 11 blocks of 2048
// per row, quantize moves 0.66 MB (~0.20 us at 3.35 TB/s): launch latency
// binds there; only a message of tens of MB reads the HBM rate.
//
// What the design does about it: one pass, every byte read once and written
// once, the block's max kept in registers and shared memory (the TPU kernel's
// VMEM tile). In quantize each thread owns 8 adjacent lanes, loaded as
// 16-byte vectors where the row is aligned (scalar loads on a ragged or
// misaligned row), so 256 lanes are one warp and 2048 lanes are one block
// of 256 threads; a 256-thread block carries eight 256-lane scale blocks,
// one per warp. The max is a warp shuffle (plus a shared-memory step across
// the 8 warps at 2048). Dequantize writes 4 times the bytes it reads, so
// each thread there owns two 4-lane slots 1024 lanes apart, and every warp
// store covers one contiguous span of the output. The grid is flat over (row, group of scale blocks), so the row
// count has no grid limit. Nothing is allocated here: the Python wrapper
// allocates q, the scales and the output; the launch goes on the caller's
// stream and every entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;  // lanes per thread

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 lanes of a row starting at lane j0 (< len), 0 past len.
__device__ __forceinline__ void load8(const float* row, long long j0,
                                      long long len, bool vec, float* v) {
  if (vec && j0 + kLanes <= len) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + j0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + j0 + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kLanes; ++i)
      v[i] = j0 + i < len ? __ldg(row + j0 + i) : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, long long j0,
                                      long long len, bool vec, float* v) {
  if (vec && j0 + kLanes <= len) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + j0));
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kLanes; ++i) v[i] = __bfloat162float(x[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kLanes; ++i)
      v[i] = j0 + i < len ? __bfloat162float(row[j0 + i]) : 0.f;
  }
}

// max that keeps a NaN, as torch.amax does (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// grid: rows * ceil(nb / SB_PER_CTA) blocks of kThreads, flat; block g of
// row r covers scale blocks [g * SB_PER_CTA, (g + 1) * SB_PER_CTA).
template <typename T, int BLOCK>
__global__ void __launch_bounds__(kThreads)
    quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scales, long long len,
                         long long nb, long long groups, bool vec) {
  constexpr int kThreadsPerSB = BLOCK / kLanes;            // 32 or 256
  constexpr int kSBPerCTA = kThreads / kThreadsPerSB;      // 8 or 1
  constexpr int kWarpsPerSB = kThreadsPerSB / 32;          // 1 or 8
  const long long row = blockIdx.x / groups;
  const long long sb =
      (blockIdx.x % groups) * kSBPerCTA + threadIdx.x / kThreadsPerSB;
  const int t = threadIdx.x % kThreadsPerSB;
  const long long j0 = sb * BLOCK + (long long)t * kLanes;
  const bool active = sb < nb;

  float v[kLanes];
  if (active) {
    load8(x + row * len, j0, len, vec, v);
  } else {
#pragma unroll
    for (int i = 0; i < kLanes; ++i) v[i] = 0.f;
  }
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) m = max_nan(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if constexpr (kWarpsPerSB > 1) {
    __shared__ float warp_max[kWarpsPerSB];
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarpsPerSB; ++w) m = max_nan(m, warp_max[w]);
  }
  if (!active) return;

  float scale = __fdiv_rn(m, 127.f);
  if (scale == 0.f) scale = 1.f;
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const float r = rintf(__fdiv_rn(v[i], scale));
    const int qi = (int)fminf(fmaxf(r, -127.f), 127.f);
    packed[i / 4] |= ((uint32_t)qi & 0xffu) << (8 * (i % 4));
  }
  // Lp = nb * BLOCK: the 8-byte store is aligned and inside the row
  *reinterpret_cast<uint2*>(q + row * nb * BLOCK + j0) =
      make_uint2(packed[0], packed[1]);
  if (t == 0) scales[row * nb + sb] = scale;
}

// 4 fp32 lanes as one 16-byte store, 4 bf16 lanes as one 8-byte store
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// grid: rows * ceil(len / (kThreads * kLanes)) blocks of kThreads, flat.
// A block covers kThreads * kLanes lanes of a row as kLanes / 4 slots of
// 4 lanes per thread, slot s at lanes base + (s * kThreads + t) * 4: each
// warp store writes one contiguous span (the output is the bulk of the
// bytes), and the 4 lanes of a slot share one scale (4 | BLOCK).
template <typename OutT, int BLOCK>
__global__ void __launch_bounds__(kThreads)
    dequantize_int8_kernel(const int8_t* __restrict__ q,
                           const float* __restrict__ scales,
                           OutT* __restrict__ out, long long ldq,
                           long long nb, long long len, long long chunks,
                           bool vec) {
  const long long row = blockIdx.x / chunks;
  const long long base = (blockIdx.x % chunks) * (long long)kThreads * kLanes;
#pragma unroll
  for (int slot = 0; slot < kLanes / 4; ++slot) {
    const long long j0 = base + ((long long)slot * kThreads + threadIdx.x) * 4;
    if (j0 >= len) return;  // later slots lie further right
    const float s = __ldg(scales + row * nb + j0 / BLOCK);
    const int8_t* src = q + row * ldq + j0;
    OutT* dst = out + row * len + j0;
    if (vec && j0 + 4 <= len) {
      const char4 c = __ldg(reinterpret_cast<const char4*>(src));
      store4(dst, (float)c.x * s, (float)c.y * s, (float)c.z * s,
             (float)c.w * s);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j0 + i < len) store(dst + i, (float)src[i] * s);
    }
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, int BLOCK>
int launch_quantize(const void* x, void* q, void* scales, long long rows,
                    long long len, void* stream) {
  constexpr int kSBPerCTA = kThreads / (BLOCK / kLanes);
  const long long nb = (len + BLOCK - 1) / BLOCK;
  const long long groups = (nb + kSBPerCTA - 1) / kSBPerCTA;
  const bool vec = aligned(x, 16) && (len * (long long)sizeof(T)) % 16 == 0;
  quantize_int8_kernel<T, BLOCK>
      <<<(unsigned)(rows * groups), kThreads, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scales), len, nb, groups, vec);
  return (int)cudaGetLastError();
}

template <typename OutT, int BLOCK>
int launch_dequantize(const void* q, const void* scales, void* out,
                      long long rows, long long ldq, long long nb,
                      long long len, void* stream) {
  const long long per_block = (long long)kThreads * kLanes;
  const long long chunks = (len + per_block - 1) / per_block;
  const bool vec = aligned(q, 4) && ldq % 4 == 0 &&
                   aligned(out, 4 * sizeof(OutT)) && len % 4 == 0;
  dequantize_int8_kernel<OutT, BLOCK>
      <<<(unsigned)(rows * chunks), kThreads, 0, (cudaStream_t)stream>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(scales),
          static_cast<OutT*>(out), ldq, nb, len, chunks, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry: pointers to contiguous device buffers on the stream's
// device; the Python wrapper checks shapes, types, devices and the grid
// size (rows * groups < 2^31) first. q and scales of quantize are (rows,
// nb * BLOCK) and (rows, nb) with nb = ceil(len / BLOCK); dequantize reads
// q with row stride ldq >= len and scales (rows, nb), nb >= ceil(len / BLOCK).
#define QUANTIZE_ENTRY(NAME, T, BLOCK)                                     \
  int NAME(const void* x, void* q, void* scales, long long rows,           \
           long long len, void* stream) {                                  \
    return launch_quantize<T, BLOCK>(x, q, scales, rows, len, stream);     \
  }
#define DEQUANTIZE_ENTRY(NAME, OutT, BLOCK)                                \
  int NAME(const void* q, const void* scales, void* out, long long rows,   \
           long long ldq, long long nb, long long len, void* stream) {     \
    return launch_dequantize<OutT, BLOCK>(q, scales, out, rows, ldq, nb,   \
                                          len, stream);                    \
  }

QUANTIZE_ENTRY(quantize_int8_f32_b256, float, 256)
QUANTIZE_ENTRY(quantize_int8_f32_b2048, float, 2048)
QUANTIZE_ENTRY(quantize_int8_bf16_b256, __nv_bfloat16, 256)
QUANTIZE_ENTRY(quantize_int8_bf16_b2048, __nv_bfloat16, 2048)
DEQUANTIZE_ENTRY(dequantize_int8_f32_b256, float, 256)
DEQUANTIZE_ENTRY(dequantize_int8_f32_b2048, float, 2048)
DEQUANTIZE_ENTRY(dequantize_int8_bf16_b256, __nv_bfloat16, 256)
DEQUANTIZE_ENTRY(dequantize_int8_bf16_b2048, __nv_bfloat16, 2048)

}  // extern "C"
