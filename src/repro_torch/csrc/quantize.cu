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
//   quantize_int8_ef_f32_b2048               <- _quantize_int8   (:53)
//       the int8 D-PSGD round's send (dpsgd._compress_and_mix), with its
//       error feedback in the same launch. Per row r of flat, res (R, L)
//       fp32 and live (R,) bool:
//         carried = flat + res            (flat alone without feedback)
//         scale, q of carried             as quantize_int8 at 2048 lanes
//         new_res = live[r] ? carried - q * scale : +0
//                   (live[r] ? res : +0 without feedback)
//       q (R, Lp) int8, scale (R, Lp / 2048), new_res (R, L) fp32: the
//       unfused sequence flat + res, quantize, dequantize, subtract and
//       the masking torch.where, five launches and two (R, L)
//       temporaries, in one pass that reads flat and res once.
//
//   dequantize_int8_{f32,bf16}_b{256,2048}   <- _dequantize_int8 (:85)
//       out[r, j] = q[r, j] * scale[r, j / BLOCK] for j < L, one fp32
//       multiply, written as fp32 or bf16 (round to nearest even).
//
// BLOCK = 256 is the TPU kernel's own contract (kernels.ops.quantize_int8);
// BLOCK = 2048 is core.compression's wire format: quantize_int8_rows and
// dequantize_int8_rows, and the error-feedback entry the int8 round runs.
//
// Bit-equality with the plain versions (and with the JAX package's oracle,
// ref.quantize_int8_ref) is the contract, so the divisions are IEEE
// round-to-nearest (__fdiv_rn, which --use_fast_math cannot turn into a
// multiply by the reciprocal) and rounding is half to even (rintf, never
// roundf). The error-feedback entry divides by one reciprocal of the
// block's scale where that provably rounds to the same integer, and by
// __fdiv_rn where it might not (rint_quotient below: the proof); it writes
// its add, multiply and subtract as __fadd_rn, __fmul_rn and __fsub_rn, so
// nvcc cannot contract carried - q * scale into one FMA (torch rounds the
// product first). The max of |x| is exact in any order. Non-finite inputs
// are not part of the contract: a NaN propagates into the block's scale,
// as torch.amax propagates it.
//
// What bounds them on an H100: bytes, then launch latency. Quantize reads
// 4 (bf16: 2) bytes per lane and writes 1 plus 4 per block; dequantize reads
// 1 and writes 4 (2). A handful of operations per lane is far below the
// card's fp32 rate. At the paper's message, (6, 21 840) fp32 into 11 blocks
// of 2048 per row, quantize moves 0.66 MB (~0.20 us at 3.35 TB/s) and the
// error-feedback entry 1.71 MB (~0.51 us): launch latency binds there; only
// a message of tens of MB reads the HBM rate.
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
// store covers one contiguous span of the output. The grid is flat over
// (row, group of scale blocks), so the row count has no grid limit.
//
// The error-feedback entry is shaped for the round's message, 66 scale
// blocks of 2048 lanes, where what counts is the chain from launch to the
// last store: a 2-D grid (scale block, row), so no index division stands
// before the first load; every thread loads its lanes of flat and res and
// the row's live flag before anything waits; the lanes stay in registers
// from the loads to the stores of q and new_res; one reciprocal per
// thread instead of an IEEE division per lane. One CTA of 512 threads,
// 4 lanes a thread, per scale block: timed in a CUDA graph on one H100
// against clusters of 2, 4 and 8 CTAs a block (the max crossing the cluster
// through distributed shared memory) and 2 or 8 lanes a thread
// (tools/int8_round_layouts.py, PERF.md), it was among the fastest and is
// the simplest: the cluster barrier (it compiles to a GPU-wide memory
// barrier) costs what the second half of the SMs would bring. Once its
// loads are in, every thread signals griddepcontrol.launch_dependents, so
// the q8 receive behind it on the stream (csrc/gossip_mix.cu, a
// programmatic dependent) can start and load W and flat, which the send
// does not write.
//
// Nothing is allocated here: the Python wrapper allocates q, the scales
// and the outputs; the launch goes on the caller's stream and every entry
// returns cudaGetLastError().
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

// ---------------------------------------------------------------------------
// The int8 round's send: quantize with error feedback in the same launch
// ---------------------------------------------------------------------------

constexpr int kWire = 2048;  // == core.compression._BLOCK

constexpr int kEfLanes = 4;                   // lanes a thread
constexpr int kEfThreads = kWire / kEfLanes;  // one CTA per scale block

// 4 lanes of a fp32 row starting at lane j0, 0 past len; one 16-byte load
// where the row is aligned and the 4 lanes lie inside it.
__device__ __forceinline__ void load4(const float* row, long long j0,
                                      long long len, bool vec, float* v) {
  if (vec && j0 + kEfLanes <= len) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + j0));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < kEfLanes; ++i)
      v[i] = j0 + i < len ? __ldg(row + j0 + i) : 0.f;
  }
}

// rint(x / scale), equal to rintf(__fdiv_rn(x, scale)) for every x of the
// block, from one reciprocal per thread (the divisor is the block's).
// Proof: for scale in [2^-125, 2^125] (tame), rcp = fl(1 / scale) is
// normal and within a factor (1 + u) of 1 / scale (u = 2^-24), and
// t = fl(x * rcp) within (1 + u)^2 of x / scale, or 2^-150 where x * rcp is
// subnormal. Every |x| of the block is at most its max m and scale =
// fl(m / 127) >= (m / 127) / (1 + u), so |x / scale| <= 127 (1 + u) and
// |t - x / scale| <= 128 (2u + u^2) + 2^-150 < 1.53e-5, while the IEEE
// quotient q is within 128 u = 7.7e-6 of x / scale: t and q differ by less
// than 2.3e-5 < 2^-15. So where t lies farther than 2^-15 from every
// half-integer, no half-integer lies between t and q or on q, and rint(t)
// = rint(q) (both round within the same (k - 1/2, k + 1/2)). Near a
// half-integer (a chance of ~6e-5 a lane), or for a scale out of that
// range (scale 0 is already 1; NaN and inf fail the test), the lane takes
// the IEEE division itself. t - rint(t) is exact for |t| < 2^23.
__device__ __forceinline__ float rint_quotient(float x, float scale,
                                               float rcp, bool tame) {
  const float t = __fmul_rn(x, rcp);
  const float r = rintf(t);
  if (tame && fabsf(__fsub_rn(t, r)) < 0.5f - 0x1p-15f) return r;
  return rintf(__fdiv_rn(x, scale));
}

// grid (nb, rows): CTA (sb, row) is scale block sb of that row, 4
// adjacent lanes a thread.
__global__ void __launch_bounds__(kEfThreads)
    quantize_int8_ef_kernel(const float* __restrict__ flat,
                            const float* __restrict__ res,
                            const uint8_t* __restrict__ live,
                            int8_t* __restrict__ q,
                            float* __restrict__ scales,
                            float* __restrict__ new_res, long long len,
                            bool ef, bool vec) {
  constexpr int kWarps = kEfThreads / 32;
  const unsigned sb = blockIdx.x;
  const unsigned row = blockIdx.y;
  const long long nb = gridDim.x;
  const long long j0 = (long long)sb * kWire + (long long)threadIdx.x *
                                                   kEfLanes;
  const long long at = (long long)row * len;

  // every load before anything waits
  const bool alive = __ldg(live + row) != 0;
  float c[kEfLanes], r[kEfLanes];
  load4(flat + at, j0, len, vec, c);
  load4(res + at, j0, len, vec, r);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kEfLanes; ++i) {
    if (ef) c[i] = __fadd_rn(c[i], r[i]);
    m = max_nan(m, fabsf(c[i]));
  }
  // the receive behind this launch may start: its reads of what this
  // kernel writes wait on griddepcontrol.wait, i.e. on this grid's end
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float part[kWarps];  // every warp's max of the scale block
  if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = max_nan(m, part[w]);

  float scale = __fdiv_rn(m, 127.f);
  if (scale == 0.f) scale = 1.f;
  const bool tame = scale >= 0x1p-125f && scale <= 0x1p125f;
  const float rcp = __frcp_rn(scale);
  uint32_t packed = 0u;
#pragma unroll
  for (int i = 0; i < kEfLanes; ++i) {
    const float rq = rint_quotient(c[i], scale, rcp, tame);
    const int qi = (int)fminf(fmaxf(rq, -127.f), 127.f);
    packed |= ((uint32_t)qi & 0xffu) << (8 * i);
    // new_res: carried - deq with deq rounded first, as torch computes it
    r[i] = !alive ? 0.f : ef ? __fsub_rn(c[i], __fmul_rn((float)qi, scale))
                             : r[i];
  }
  // Lp = nb * 2048: the 4-byte store is aligned and inside the row
  *reinterpret_cast<uint32_t*>(q + row * nb * kWire + j0) = packed;
  float* out = new_res + at;
  if (vec && j0 + kEfLanes <= len) {
    store4(out + j0, r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kEfLanes; ++i)
      if (j0 + i < len) out[j0 + i] = r[i];
  }
  if (threadIdx.x == 0) scales[row * nb + sb] = scale;
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


int launch_quantize_ef(const void* flat, const void* res, const void* live,
                       void* q, void* scales, void* new_res, long long rows,
                       long long len, int ef, void* stream) {
  const long long nb = (len + kWire - 1) / kWire;
  const bool vec = aligned(flat, 16) && aligned(res, 16) &&
                   aligned(new_res, 16) && len % kEfLanes == 0;
  const dim3 grid((unsigned)nb, (unsigned)rows);
  quantize_int8_ef_kernel<<<grid, kEfThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(flat), static_cast<const float*>(res),
      static_cast<const uint8_t*>(live), static_cast<int8_t*>(q),
      static_cast<float*>(scales), static_cast<float*>(new_res), len,
      ef != 0, vec);
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

// The int8 round's send: flat, res and new_res (rows, len) fp32, live
// (rows,) bool (one byte each), q (rows, nb * 2048) int8 and scales (rows,
// nb) fp32 with nb = ceil(len / 2048), rows <= 65535 (gridDim.y); q 4-byte
// aligned. ef = 0 quantizes flat alone and passes res through (zeroed on
// dead rows).
int quantize_int8_ef_f32_b2048(const void* flat, const void* res,
                               const void* live, void* q, void* scales,
                               void* new_res, long long rows, long long len,
                               int ef, void* stream) {
  return launch_quantize_ef(flat, res, live, q, scales, new_res, rows, len,
                            ef, stream);
}

}  // extern "C"
