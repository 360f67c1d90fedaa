// Flash attention for Hopper (sm_90a): the prefill attention of the port's
// `global` and `local` layers.
//
// Replaces the TPU (Pallas) kernel of src/repro/kernels/flash_attention.py
// (_flash_attention, pallas_call at :105), reached through
// ops.flash_attention_gqa:
//
//   out[b, s, h, :] = softmax_t(q[b, s, h] . k[b, t, h / g] * D^-1/2
//                               masked) @ v[b, t, h / g]
//
//   q (B, S, Hq, D), k / v (B, T, Hkv, D), g = Hq / Hkv (GQA: the kv head
//   of q head h is h / g), all in one dtype (fp32 or bf16), contiguous in
//   the JAX layout. The rows are read in place: no copy to (B*H, S, D) and
//   no padding of S or D in memory. Masks on absolute positions: t < T;
//   causal: t <= s; window w > 0: s - t < w. fp32 online softmax (running
//   max m, denominator l, accumulator acc), out = acc / max(l, 1e-30),
//   written in q's dtype (bf16 rounds to nearest even). Where the caller
//   passes an lse buffer (training: the backward kernel of
//   flash_attention_bwd.cu recomputes P from it), each query row's
//   log-sum-exp of its scaled scores, lse[b, h, s] = m + log(l) in fp32
//   ((B, Hq, S), +inf for a row with no live key), is written from the
//   running max and sum the kernel already holds, by an instance of its
//   own (template LSE); serving passes null and runs the instance without
//   the write.
//
// What bounds it on an H100: operations. At the served prefill (B = 4,
// S = 4096, Hq = 10, Hkv = 1, D = 256, window 2048, bf16) the band holds
// 6 292 480 (query, key) pairs per (batch, head): 4 * D * pairs * B * Hq
// = 2.58e11 flops, 0.261 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 184.5 MB of q, k, v and out, 0.055 ms at 3.35 TB/s.
//
// Both kernels keep the saving the TPU kernel exists for: key tiles
// outside the causal / window band are never loaded or multiplied. A block
// (a tile of query rows, a q head, a batch) loops only over the key tiles
// from floor(max(0, q0 - w + 1) / BK) to the tile of its last query row.
//
// bf16 (flash_attention_bf16_kernel): the tensor cores. A block of 384
// threads holds 128 query rows: two consumer warpgroups of 64 rows each and
// one producer warpgroup, which gives its registers to the consumers
// (setmaxnreg 24 / 240). One producer thread loads q once and then every
// key tile of the band, k and v (64 keys x DP), with TMA
// (cp.async.bulk.tensor over the (D, H, S, B) view of each tensor, 64 x 64
// boxes, 128-byte swizzle; lanes past D and rows past S or T arrive as
// zeros) into a 2-stage ring, each stage with a "full" mbarrier (the TMA's
// byte count) and an "empty" one (all 256 consumer threads). Each consumer
// warpgroup computes S = q k^T with wgmma m64n64k16 from shared memory
// (both operands K-major, DP / 16 k-steps); masks only the key tiles that
// cross the diagonal, the window's edge or T (two compares a score against
// the row's live columns), and skips those wholly outside its own 64 rows'
// band; runs the online softmax in registers on the accumulator layout (a
// row's 64 scores lie in the 4 threads of a quad; exp2 of the scores scaled
// by D^-1/2 log2(e) in one FFMA; masked scores are a finite -1e30 that never
// reaches exp2 as 0 - 0); rescales its 64 x DP fp32 accumulator only where
// a row's max moved; rounds P to bf16 in registers and adds P v with wgmma
// m64nDPk16, P the register operand and v MN-major from shared memory (the
// transpose bit). The tensor maps are encoded on the host per call
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: no
// -lcuda) and passed as __grid_constant__ parameters; these Hopper helpers
// live in flash_hopper.cuh, shared with the backward. DP = D rounded up to
// 64, 128 or 256; the entry needs D % 8 == 0 (TMA's 16-byte strides).
//
// fp32 (flash_attention_kernel<DP, LSE>): CUDA cores (67 TFLOP/s peak);
// the fp32 path is held at 2e-5, which TF32 (10-bit mantissa) cannot meet.
// Register-tiled: each of the 256 threads owns 4 query rows x 2 keys of a
// 64 x 32 score tile and the same 4 rows x D/16 lanes of the accumulator,
// so a row's max and sum reduce over the 16 threads of a half warp with
// shuffles. q (pre-scaled) and k tiles sit transposed in shared memory, so
// a thread's 4 rows (keys) are one float4 (float2) load; v and the
// probability tile feed the P.V product the same way. Lanes past D and rows
// past S / T are zero-filled, never read from device memory.
//
// Nothing is allocated here: the Python wrapper allocates the output; the
// launch goes on the caller's stream and every entry returns a CUDA error
// code (cudaGetLastError() after the launch).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;  // 16 (ty: 4 rows each) x 16 (tx)
constexpr int kQS = kBQ + 4;   // padded row strides of the transposed
constexpr int kKS = kBK + 4;   // tiles (multiples of 4: float4 aligned)
constexpr float kNeg = -1e30f;
constexpr int kInfBits = 0x7f800000;  // +inf: the lse of a row with no key

// DP = D rounded up to 64, 128 or 256 (lanes past D are zeros).
template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)DP * kQS + (size_t)DP * kKS +
                          (size_t)kBK * DP + (size_t)kBK * kQS);
}

// grid (ceil(S / kBQ), Hq, B), kThreads threads, smem_bytes<DP>() dynamic.
// LSE: write each row's log-sum-exp (an instance apart, so that serving's
// instance is the code it was before the backward needed lse).
template <int DP, bool LSE>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out,
                           float* __restrict__ lse, int S, int T_len,
                           int Hq, int Hkv, int D, float scale, int causal,
                           int window) {
  constexpr int NC = DP / 16;  // accumulator lanes per thread and row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [DP][kQS]  q tile, transposed, scaled
  float* ks = qs + DP * kQS;    // [DP][kKS]  k tile, transposed
  float* vs = ks + DP * kKS;    // [kBK][DP]  v tile
  float* ps = vs + kBK * DP;    // [kBK][kQS] probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const long long q_step = (long long)Hq * D;   // one sequence position
  const long long k_step = (long long)Hkv * D;
  const float* qb = q + ((long long)b * S * Hq + h) * D;
  const float* kb = k + ((long long)b * T_len * Hkv + hk) * D;
  const float* vb = v + ((long long)b * T_len * Hkv + hk) * D;

  // q tile: element (r, d) -> qs[d][r], d fastest across threads
  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    const int s = q0 + r;
    qs[d * kQS + r] =
        (s < S && d < D) ? qb[s * q_step + d] * scale : 0.f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the band: keys [k_begin, k_end) hold every live pair of this q tile
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int c = i / DP, d = i % DP;
      const int t = k0 + c;
      const bool in = t < T_len && d < D;
      ks[d * kKS + c] = in ? kb[t * k_step + d] : 0.f;
      vs[c * DP + d] = in ? vb[t * k_step + d] : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4 + i against keys tx*2 + j
    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kQS + ty * 4);
      const float2 kv = *reinterpret_cast<const float2*>(ks + d * kKS + tx * 2);
      sc[0][0] = fmaf(qv.x, kv.x, sc[0][0]);
      sc[0][1] = fmaf(qv.x, kv.y, sc[0][1]);
      sc[1][0] = fmaf(qv.y, kv.x, sc[1][0]);
      sc[1][1] = fmaf(qv.y, kv.y, sc[1][1]);
      sc[2][0] = fmaf(qv.z, kv.x, sc[2][0]);
      sc[2][1] = fmaf(qv.z, kv.y, sc[2][1]);
      sc[3][0] = fmaf(qv.w, kv.x, sc[3][0]);
      sc[3][1] = fmaf(qv.w, kv.y, sc[3][1]);
    }

    // mask, then the online-softmax update of each row (16 threads share
    // a row: one half warp, so xor-shuffles of 8, 4, 2, 1 reduce it)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[2];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx * 2 + j;
        ok[j] = kp < T_len && (!causal || kp <= qp) &&
                (window <= 0 || qp - kp < window);
        if (ok[j]) mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float p[2], rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p[j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 2; ++j) ps[(tx * 2 + j) * kQS + ty * 4 + i] = p[j];
    }
    __syncthreads();

    // acc[rows ty*4 + i][lanes j*64 + tx*4 + e] += P . V
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + c * kQS + ty * 4);
#pragma unroll
      for (int j = 0; j < DP / 64; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + c * DP + j * 64 + tx * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j * 4 + 0] = fmaf(pr[i], vv.x, acc[i][j * 4 + 0]);
          acc[i][j * 4 + 1] = fmaf(pr[i], vv.y, acc[i][j * 4 + 1]);
          acc[i][j * 4 + 2] = fmaf(pr[i], vv.z, acc[i][j * 4 + 2]);
          acc[i][j * 4 + 3] = fmaf(pr[i], vv.w, acc[i][j * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    // m and l are the half warp's (reduced by the shuffles above)
    if constexpr (LSE)
      if (tx == 0)
        lse[((long long)b * Hq + h) * S + s] =
            l[i] > 0.f ? m[i] + logf(l[i]) : __int_as_float(kInfBits);
    float* o = out + ((long long)b * S + s) * q_step + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DP / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = j * 64 + tx * 4 + e;
        if (d < D) o[d] = acc[i][j * 4 + e] / den;
      }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int S, int T_len, int Hq, int Hkv, int D, float scale,
           int causal, int window, void* stream) {
  const size_t smem = smem_bytes<DP>();
  const auto kernel = lse ? flash_attention_kernel<DP, true>
                          : flash_attention_kernel<DP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), S, T_len, Hq, Hkv, D, scale, causal, window);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out,
             void* lse, int B, int S, int T_len, int Hq, int Hkv, int D,
             float scale, int causal, int window, void* stream) {
  if (D <= 64)
    return launch<64>(q, k, v, out, lse, B, S, T_len, Hq, Hkv, D, scale,
                      causal, window, stream);
  if (D <= 128)
    return launch<128>(q, k, v, out, lse, B, S, T_len, Hq, Hkv, D, scale,
                       causal, window, stream);
  if (D <= 256)
    return launch<256>(q, k, v, out, lse, B, S, T_len, Hq, Hkv, D, scale,
                       causal, window, stream);
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, a 2-stage ring, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kTQ = 128;          // query rows per block (2 x 64)
constexpr int kTK = 64;           // keys per tile
constexpr int kStages = 2;        // ring depth
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreadsH = 384;    // + the producer warpgroup
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one block, in bytes from a 1024-aligned base (128-byte
// swizzle atoms are 1024 bytes): q [2 warpgroups][DP / 64 boxes], then k
// and v [stage][DP / 64 boxes], then the mbarriers (q, full[], empty[]).
template <int DP>
struct Smem {
  static constexpr int kChunks = DP / 64;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kChunks * kBox;
  static constexpr int kV = kK + kStages * kChunks * kBox;
  static constexpr int kBar = kV + kStages * kChunks * kBox;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// grid (ceil(S / kTQ), Hq, B), kThreadsH threads, Smem<DP>::kBytes dynamic.
// Accumulator layout (wgmma m64nN, fp32): thread t of a warpgroup holds rows
// r = 16 (t / 32) + (t % 32) / 4 and r + 8; register 4j + e is column
// 8j + 2 (t % 4) + (e & 1) of row r (e < 2) or r + 8 (e >= 2). LSE as in
// flash_attention_kernel.
template <int DP, bool LSE>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                __nv_bfloat16* __restrict__ out,
                                float* __restrict__ lse, int S, int T_len,
                                int Hq, int Hkv, int D, float scale_log2,
                                int causal, int window) {
  using L = Smem<DP>;
  constexpr int NC = L::kChunks;
  constexpr uint32_t kStageBytes = 2 * NC * kBox;  // k and v of one tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;

  // the heaviest q tiles (latest rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  // the band: key tiles [t_begin, t_begin + n_tiles) hold every live pair
  const int q_last = min(q0 + kTQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int t_begin = k_begin / kTK;
  const int n_tiles = max(0, (k_end + kTK - 1) / kTK - t_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, 2 * NC * kBox);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load(sq + (w * NC + c) * kBox, &tm_q, bar_q, c * 64, h,
                   q0 + 64 * w, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kStageBytes);
        const int k0 = (t_begin + i) * kTK;
        for (int c = 0; c < NC; ++c) {
          tma_load(sk + (st * NC + c) * kBox, &tm_k, full, c * 64, hk, k0, b);
          tma_load(sv + (st * NC + c) * kBox, &tm_v, full, c * 64, hk, k0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroups 0 and 1: query rows r0 .. r0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = q0 + 64 * wg;
  const int row_a = r0 + 16 * warp + lane / 4;  // and row_a + 8
  const int col_t = 2 * (lane % 4);
  const bool live = r0 < S;
  const uint32_t qa = sq + wg * NC * kBox;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
    const int k0 = (t_begin + i) * kTK;
    // tiles wholly outside this warpgroup's band are skipped
    const bool skip = !live || (causal && k0 > r0 + 63) ||
                      (window > 0 && k0 + kTK - 1 <= r0 - window);
    if (!skip) {
      const uint32_t ka = sk + st * NC * kBox, va = sv + st * NC * kBox;
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_n64(s, sw128_desc(qa + off, 16, 1024),
                     sw128_desc(ka + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // masks only on tiles that cross T, the diagonal or the window's
      // edge: row r's live keys are the columns [lo, hi], counted from this
      // thread's first column of the tile
      if (k0 + kTK > T_len || (causal && k0 + kTK - 1 > r0) ||
          (window > 0 && k0 <= r0 + 63 - window)) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_a + 8 * r, c0 = k0 + col_t;
          const int hi = (causal ? min(row, T_len - 1) : T_len - 1) - c0;
          const int lo = window > 0 ? row - window + 1 - c0 : -kTK;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int c = 8 * (j / 4) + (j & 1);
            if (((j >> 1) & 1) == r && (c < lo || c > hi)) s[j] = kNeg;
          }
        }
      }

      // online softmax, row by row (the quad's 4 threads hold a row), on
      // the raw scores; p = exp2(s * D^-1/2 log2(e) - m * D^-1/2 log2(e))
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (((j >> 1) & 1) == r) mx = fmaxf(mx, s[j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row with no live key yet keeps p = exp2(-1e30 * scale) = 0
        const float m_use = mx == kNeg ? 0.f : mx;
        const float m_scaled = m_use * scale_log2;
        const float corr = exp2f(m[r] * scale_log2 - m_scaled);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (((j >> 1) & 1) == r) {
            s[j] = exp2f(fmaf(s[j], scale_log2, -m_scaled));
            sum += s[j];
          }
        l[r] = l[r] * corr + sum;
        if (corr != 1.f) {
#pragma unroll
          for (int j = 0; j < DP / 8; ++j) {
            o[4 * j + 2 * r] *= corr;
            o[4 * j + 2 * r + 1] *= corr;
          }
        }
      }

      // P (bf16) as wgmma's register operand: k-step kk covers keys
      // 16 kk .. 16 kk + 15, accumulator registers 8 kk .. 8 kk + 7. All of
      // P is packed before the first product (no register writes between
      // the wgmmas of one group).
      uint32_t p[kTK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)
        wgmma_rs<DP>(o, p[kk],
                     sw128_desc(va + kk * 16 * 128, 64 * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    mbar_arrive(bar_empty + 8 * st);
  }

  // out = o / max(l, 1e-30) in bf16; rows past S are never written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    // lse = (m D^-1/2 log2(e) + log2 l) ln 2: m and l are the quad's
    if constexpr (LSE)
      if ((lane & 3) == 0)
        lse[((long long)b * Hq + h) * S + row] =
            l[r] > 0.f ? (m[r] * scale_log2 + log2f(l[r])) * kLn2
                       : __int_as_float(kInfBits);
    __nv_bfloat16* dst = out + ((long long)b * S + row) * Hq * D +
                         (long long)h * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col_t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            __fdiv_rn(o[4 * j + 2 * r], den),
            __fdiv_rn(o[4 * j + 2 * r + 1], den));
    }
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int S, int T_len, int Hq, int Hkv, int D,
                float scale, int causal, int window, void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_map(encode, &tm_q, q, D, Hq, S, B) ||
      !encode_map(encode, &tm_k, k, D, Hkv, T_len, B) ||
      !encode_map(encode, &tm_v, v, D, Hkv, T_len, B))
    return (int)cudaErrorInvalidValue;
  const int smem = Smem<DP>::kBytes;
  const auto kernel = lse ? flash_attention_bf16_kernel<DP, true>
                          : flash_attention_bf16_kernel<DP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kTQ - 1) / kTQ), (unsigned)Hq, (unsigned)B);
  kernel<<<grid, kThreadsH, smem, (cudaStream_t)stream>>>(
          tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out),
          static_cast<float*>(lse), S, T_len, Hq, Hkv, D, scale * kLog2e,
          causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry: contiguous device buffers q (B, S, Hq, D), k / v
// (B, T, Hkv, D), out (B, S, Hq, D) on the stream's device, Hq % Hkv == 0,
// T >= 1, 0 < D <= 256; lse, a fp32 (B, Hq, S) buffer or null; the bf16
// entry also needs D % 8 == 0 and 16-byte aligned buffers. The Python
// wrapper checks shapes, types and devices first.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int S, int T_len,
                        int Hq, int Hkv, int D, float scale, int causal,
                        int window, void* stream) {
  return dispatch(q, k, v, out, lse, B, S, T_len, Hq, Hkv, D, scale, causal,
                  window, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int S, int T_len,
                         int Hq, int Hkv, int D, float scale, int causal,
                         int window, void* stream) {
  if (D % 8 || T_len < 1) return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_bf16<64>(q, k, v, out, lse, B, S, T_len, Hq, Hkv, D, scale,
                           causal, window, stream);
  if (D <= 128)
    return launch_bf16<128>(q, k, v, out, lse, B, S, T_len, Hq, Hkv, D,
                            scale, causal, window, stream);
  if (D <= 256)
    return launch_bf16<256>(q, k, v, out, lse, B, S, T_len, Hq, Hkv, D,
                            scale, causal, window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
