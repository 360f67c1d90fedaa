// RWKV-6 WKV scan for Hopper (sm_90a) in the chunked form, its products on
// the tensor cores: the time-mix scan of the port's `rwkv` layers in prefill
// (and in teacher-forced `apply`).
//
// Replaces the TPU (Pallas) kernel of src/repro/kernels/rwkv6_scan.py
// (_rwkv6_scan, `_kernel`, pallas_call at :87), reached through ops.rwkv6:
//
//   per (b, h), with the (D, D) fp32 state S (row d = key channel, column
//   e = value channel), S_{-1} = s0[b, h] (0 without s0):
//     y[b, t, h, e] = sum_d r_t[d] * (S_{t-1}[d, e] + u[h, d] k_t[d] v_t[e])
//     S_t[d, e]     = w_t[d] * S_{t-1}[d, e] + k_t[d] v_t[e]
//   and s_out[b, h] = S_{S-1}.
//
//   r, k, v, w, y (B, S, H, D) fp32 contiguous, read and written in place
//   (the TPU wrapper's transposes to (B*H, S, D) and its padding of S are
//   not carried over); u (H, D), or one per batch row; s0, s_out (B, H,
//   D, D), s0 may be null.
//   Decays enter as lw = log(max(w, 1e-12)), the TPU kernel's floor
//   (rwkv6_scan.py:85); w <= 1, as the model's exp(-exp(.)) gives it.
//
// What bounds it on an H100: bytes, at first sight. At the served prefill
// (B = 4, S = 4096, H = 64, D = 64) r, k, v, w and y are 268.4 MB each,
// s0 and s_out 4.2 MB each: 1.3506 GB, 0.403 ms at 3.35 TB/s. This
// kernel's first form, the exact recurrence, walked 4096 dependent steps
// per (b, h) and idled on latency at 4.6x that bound. The chunked form
// walks S / 16 chunk steps; its products in 3xTF32 are 6.1e10 flops (456
// mma of m16n8k8 per chunk and head), and with the CUDA-core work of each
// chunk (decay products, the hi/lo splits, the pairwise diagonal) it is
// the SM's instruction issue and latency that bind, not the bytes
// (tools/rwkv6_phases.py times the phases; PERF.md).
//
// The design. One CTA per (b, h): 4 producer warps and D / 16 consumer
// warps (8 warps at D = 64, two CTAs an SM: the served 256 CTAs in one
// wave), named barriers between them, chunks of 16 steps (one mma row
// tile). The producers run a chunk ahead of the consumers:
//   ring      r, k, v, w rows (D floats at stride H D) by cp.async into a
//             3-stage ring; a ragged last chunk is zero-filled, w' = 1;
//   operands  per channel, with w' = max(w, 1e-12), one thread forms the
//             prefix products Rin_t = r_t prod_{j<t} w'_j and the chunk's
//             decay prod w', another the suffix products
//             Khat_i = k_i prod_{j>i} w'_j, each split into (hi, lo);
//   diagonal  att_ti = sum_d r_td k_id prod_{i<j<t} w'_jd for i < t in one
//             8-step half, pairwise on the CUDA cores (a thread per two
//             steps and a channel quad, shuffles to sum), att_tt = r_t .
//             (u k_t) (the bonus);
//   quadrant  att_ti for t >= 8 > i on the tensor cores, from factors
//             referenced at the midpoint: (r_t prod_{8<=j<t} w'_j) .
//             (k_i prod_{i<j<8} w'_j);
// and each consumer warp holds 16 value channels e of the state, S^T, in
// its accumulator registers and per chunk computes
//   y         y_t = Rin_t . S + sum_{i<=t} att_ti v_i
//             (16 x D x 16 and 16 x 16 x 16 a warp)
//   state     S^T <- S^T diag(prod w') + v^T Khat   (16 x 16 x D a warp)
// with its v split from the ring itself, then frees the chunk's buffers.
// Every factor is a product of w' <= 1 between two points of the chunk,
// i.e. e^{sum lw} with lw = log w' <= 0 referenced at the chunk's start,
// end or midpoint: nothing overflows, no exponent is a difference of two
// long sums (the plain version's L_t - L_i loses digits to cancellation at
// the served decays: tools/rwkv6_accuracy.py), and what underflows is what
// exp(<= 0) sends to 0. A chunk of 16 is one mma row tile and keeps two
// CTAs on an SM (chunks of 32 and 64 were slower in an earlier,
// single-role version of this kernel).
//
// Precision: every product is 3xTF32 on mma.sync.m16n8k8: x = hi + lo and
// a b = al bh + ah bl + ah bh, summed two k-steps at a time into a zeroed
// partial that is then added in fp32 (the tensor cores truncate as they
// accumulate; into the state, carried over thousands of steps, that
// biased it). One TF32 pass keeps ~3 digits and misses the 5e-4 bar at
// outputs of ~8. mma.sync, not wgmma: the inter product's B operand is
// the state in the consumers' registers (taken in the k order (2 tl,
// 2 tl + 1) for slots (tl, tl + 4), the same permutation on the A side),
// and the chunk's tiles are 16 rows, below wgmma's 64.
//
// Nothing is allocated here: the Python wrapper allocates y and s_out; the
// launch goes on the caller's stream and the entry returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 16;     // time steps a chunk: one mma row tile
constexpr int kProducers = 4;  // warps preparing the chunks
constexpr float kFloorW = 1e-12f;

// x = hi + lo for 3xTF32: the tensor cores read the top 10 mantissa bits
// of a .tf32 operand and drop the low 13, so hi is x itself (read as
// trunc(x)) and lo = x - trunc(x), exact in fp32 (|lo| < 2^-10 |x|, read to
// 10 bits in turn: hi + lo keeps ~20 bits). One logic operation and a
// subtraction per element.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Recursive halving over the lanes l ^ X, l ^ X/2, .., l ^ 1 (X a power of
// two): N partial sums per lane become whole sums; for N >= 2X lane l keeps
// sums l N / (2X) + m in v[m], for N < 2X lanes l and l ^ (2X / N - 1) ..
// share sum l N / (2X) in v[0].
template <int N, int X, int M>
__device__ __forceinline__ void halve(float (&v)[M], int l) {
  if constexpr (X >= 1) {
    if constexpr (N == 1) {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], X);
      halve<1, X / 2>(v, l);
    } else {
      constexpr int H = N / 2;
      const bool up = l & X;
#pragma unroll
      for (int m = 0; m < H; ++m) {
        const float keep = up ? v[m + H] : v[m];
        const float send = up ? v[m] : v[m + H];
        v[m] = keep + __shfl_xor_sync(0xffffffffu, send, X);
      }
      halve<H, X / 2>(v, l);
    }
  }
}

__device__ __forceinline__ float2 split2(float x) {
  uint32_t hi, lo;
  split(x, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// A fragment (rows g, g + 8; k columns tl, tl + 4) of a pre-split operand
// stored [row][k] as (hi, lo) pairs
__device__ __forceinline__ void frag_a(const float2* p, int ld, int g, int tl,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 x0 = p[g * ld + tl], x1 = p[(g + 8) * ld + tl];
  const float2 x2 = p[g * ld + tl + 4], x3 = p[(g + 8) * ld + tl + 4];
  ah[0] = __float_as_uint(x0.x), al[0] = __float_as_uint(x0.y);
  ah[1] = __float_as_uint(x1.x), al[1] = __float_as_uint(x1.y);
  ah[2] = __float_as_uint(x2.x), al[2] = __float_as_uint(x2.y);
  ah[3] = __float_as_uint(x3.x), al[3] = __float_as_uint(x3.y);
}

// d += a b in 3xTF32 from split operands, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

template <int N>
__device__ __forceinline__ void add_to(float (&d)[N][4],
                                       const float (&part)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[j][c] += part[j][c];
}

// Shared-memory plan of one CTA. The consumers' operands are kept split,
// as (hi, lo) pairs, in two buffers (chunk n in buffer n % 2): Khat in the
// order of the mma fragments (Frag), the others in rows padded so that
// fragment reads hit every bank once: Rin is read 16 bytes a lane (rows of
// DP + 8 pairs, = 8 mod 16), the attention tile and the quadrant's
// operands 8 bytes a lane (C + 4 and DP + 4 pairs, = 4 mod 16). The ring of
// raw rows has 3 stages: chunk n's stays until the consumers, who read its
// v, are done with it; its rows are DP + 8 floats (= 8 mod 32) for the
// consumers' column reads of v. The quadrant's operands (producers only)
// have one buffer.
template <int DP>
struct Plan {
  static constexpr int NC = DP / 16;           // consumer warps
  static constexpr int kWarpsAll = kProducers + NC;
  static constexpr int kThreadsAll = 32 * kWarpsAll;
  static constexpr int kStages = 3;            // the ring of raw rows
  static constexpr int LD = DP + 8;            // fp32 ring rows (= 8 mod 32)
  static constexpr int LDR = DP + 8;           // Rin rows (float2)
  static constexpr int LD2 = DP + 4;           // other float2 rows
  static constexpr int LDA2 = kChunk + 4;      // attention rows (float2)
  // offsets in floats
  static constexpr int kRing = kStages * 4 * kChunk * LD;
  static constexpr int kRin = kRing;                      // [2][C][LDR]
  static constexpr int kKhat = kRin + 2 * 2 * kChunk * LDR;   // [2][Frag]
  static constexpr int kQ = kKhat + 2 * 2 * kChunk * DP;      // [C][LD2]
  static constexpr int kAtt = kQ + 2 * kChunk * LD2;          // [2][C][LDA2]
  static constexpr int kDec = kAtt + 2 * 2 * kChunk * LDA2;
  static constexpr int kU = kDec + 2 * DP;
  static constexpr int kFloats = kU + DP;
  static constexpr size_t kBytes = sizeof(float) * (size_t)kFloats;
  static constexpr int DP4 = DP / 4;                 // float4 per row
  static constexpr int LPT = DP4 < 16 ? DP4 : 16;    // diagonal: lanes a pair
  static constexpr int KT = DP / 8;                  // 8-wide d tiles
};

// Where element (step i, channel d) of Khat, the B operand of the state
// update, lives: in the order of the mma fragments, hi b0, b1 then lo b0,
// b1 in one 16-byte slot a lane (lane L = 4 g + tl holds k = tl, tl + 4 of
// column g of an 8 x 8 tile; tiles [i / 8][d / 8] of 32 slots), so a
// fragment is one 16-byte read with no register moves. Lane L's slot is
// L ^ ((L >> 3) & 3): a quarter-warp's reads still hit 8 different bank
// groups, and a producer's 4-byte stores of one step for 8 neighbouring
// channels hit 8 different banks (not 2).
struct Frag {
  static __device__ __forceinline__ int slot(int L) {
    return L ^ ((L >> 3) & 3);
  }
  template <int KT>
  static __device__ __forceinline__ int khat(int i, int d) {
    return (((i >> 3) * KT + (d >> 3)) * 32 + slot((d & 7) * 4 + (i & 3))) *
               4 + ((i >> 2) & 1);
  }
};

__device__ __forceinline__ void put_split(float* base, int at, int lo_at,
                                          float x) {
  uint32_t hi, lo;
  split(x, hi, lo);
  base[at] = __uint_as_float(hi);
  base[at + lo_at] = __uint_as_float(lo);
}

__device__ __forceinline__ void as_u32(const float4& f, uint32_t (&u)[4]) {
  u[0] = __float_as_uint(f.x), u[1] = __float_as_uint(f.y);
  u[2] = __float_as_uint(f.z), u[3] = __float_as_uint(f.w);
}

// Named barriers: 0 __syncthreads, 1 the producers, 2 + b "buffer b is
// free" (consumers arrive, producers wait), 4 + b "buffer b is full"
// (producers arrive, consumers wait).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// grid (B * H), block Plan<DP>::kThreadsAll, dynamic shared memory
// Plan<DP>::kBytes. DP: D rounded up to 32, 64 or 128 (the padding columns
// stay 0).
template <int DP>
__global__ void __launch_bounds__(Plan<DP>::kThreadsAll, DP <= 64 ? 2 : 1)
    rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ s_out, int S,
                      int H, int D, long long u_bstride) {
  using P = Plan<DP>;
  constexpr int C = kChunk, LD = P::LD, LDR = P::LDR, LD2 = P::LD2;
  constexpr int LDA2 = P::LDA2, NP = 32 * kProducers, NALL = P::kThreadsAll;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Us = sm + P::kU;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tl = lane % 4;   // mma fragment coordinates
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long step = (long long)H * D;            // floats per time step
  const long long base = (long long)b * S * step + (long long)h * D;
  const int nchunks = (S + C - 1) / C;

  for (int i = tid; i < P::kFloats; i += NALL) sm[i] = 0.f;
  __syncthreads();
  for (int d = tid; d < D; d += NALL)
    Us[d] = u[b * u_bstride + (long long)h * D + d];
  __syncthreads();

  // buffer b's arrays
  auto rin = [&](int bb) {
    return reinterpret_cast<float2*>(sm + P::kRin) + bb * C * LDR;
  };
  auto khat = [&](int bb) { return sm + P::kKhat + bb * 2 * C * DP; };
  float2* Q2 = reinterpret_cast<float2*>(sm + P::kQ);   // producers only
  auto stage = [&](int n, int a) {   // array a (r, k, v, w) of chunk n
    return sm + ((n % P::kStages) * 4 + a) * C * LD;
  };
  auto att = [&](int bb) {
    return reinterpret_cast<float2*>(sm + P::kAtt) + bb * C * LDA2;
  };
  auto dec = [&](int bb) { return sm + P::kDec + bb * DP; };

  if (warp < kProducers) {
    // ------------------------------------------------------------------
    // Producers: the ring of raw r, k, v, w rows and, per chunk, the split
    // operands and the attention tile of the chunk.
    // ------------------------------------------------------------------
    // a chunk's rows by cp.async, 16 bytes a copy: thread tid copies
    // float4 lq of rows lrow + j kRows of each of r, k, v, w
    constexpr int kRows = NP / P::DP4;
    const int lq = tid % P::DP4, lrow = tid / P::DP4;
    auto load_chunk = [&](int n, int stage) {   // one commit group each
      if (n < nchunks && 4 * lq < D) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : w;
#pragma unroll
          for (int row = lrow; row < C; row += kRows) {
            const int t = n * C + row;
            cp_async16(sm + ((stage * 4 + a) * C + row) * LD + 4 * lq,
                       src + base + (t < S ? t * step : 0) + 4 * lq, t < S);
          }
        }
      }
      cp_async_commit();
    };
    for (int n = 0; n < P::kStages; ++n) load_chunk(n, n);
    for (int n = 0; n < nchunks; ++n) {
      const int bb = n & 1;
      const float *R = stage(n, 0), *K = stage(n, 1), *W = stage(n, 3);
      float2 *Rin = rin(bb), *At = att(bb);
      float* Khat = khat(bb);
      float* Dec = dec(bb);
      // chunk n's rows are in once at most kStages - 1 - n (n < 2) or 0
      // later groups are in flight
      if (n == 0) cp_async_wait<2>();
      else if (n == 1) cp_async_wait<1>();
      else cp_async_wait<0>();
      bar_sync(1, NP);                      // the stage is in
      if (n >= 2) {
        bar_sync(2 + bb, NALL);   // the consumers are done with chunk n - 2:
        load_chunk(n + 1, (n + 1) % P::kStages);   // its stage takes n + 1
      }

      // 1. per channel d, with w' = max(w, 1e-12) (1 on masked rows): on
      // one thread the prefix products Rin_t = r_t prod_{j<t} w'_j (and,
      // from the midpoint, Q_t = r_t prod_{8<=j<t} w'_j for t >= 8) and
      // the chunk's decay prod w'; on another the suffix products
      // Khat_i = k_i prod_{j>i} w'_j (and Q_i = k_i prod_{i<j<8} w'_j for
      // i < 8): e^{sum lw} of the decays lw = log w' <= 0, as products.
      // Then v, split.
      for (int job = tid; job < 2 * DP; job += NP) {
        const bool suffix = job >= DP;
        const int d = job % DP;
        float wv[C];
#pragma unroll
        for (int j = 0; j < C; ++j)
          wv[j] = n * C + j < S ? fmaxf(W[j * LD + d], kFloorW) : 1.f;
        float p = 1.f, p8 = 1.f;
        if (!suffix) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const float x = R[j * LD + d];
            Rin[j * LDR + d] = split2(x * p);
            if (j >= 8) Q2[j * LD2 + d] = split2(x * p8);
            p *= wv[j];
            if (j >= 8) p8 *= wv[j];
          }
          Dec[d] = p;
        } else {
#pragma unroll
          for (int j = C - 1; j >= 0; --j) {
            const float x = K[j * LD + d];
            put_split(Khat, Frag::khat<P::KT>(j, d), 2, x * p);
            if (j < 8) Q2[j * LD2 + d] = split2(x * p8);
            p *= wv[j];
            if (j < 8) p8 *= wv[j];
          }
        }
      }

      // 2. the two 8 x 8 diagonal sub-blocks, pairwise on the CUDA cores:
      // one thread per (pair of steps t, t + 1; channel lane l) over the
      // channel quads l + LPT j (float4 reads, each k and w row read once
      // for both steps); att_tt takes the bonus r_t . (u k_t). A warp holds
      // 64 / LPT neighbouring steps and skips the keys above its last
      // one; each step's 8 sums are reduced and scattered over its LPT
      // lanes by recursive halving.
      {
        constexpr int LPT = P::LPT, QPL = P::DP4 / LPT;
        for (int job = tid; job < C / 2 * LPT; job += NP) {
          const int ta = job / LPT * 2, l = job % LPT;
          const int T0 = ta / 8 * 8, tr = ta % 8;
          const int tmax = tr | (64 / LPT - 1);
          float acc[2][8], bonus[2] = {0.f, 0.f};
          float4 q[2][QPL];
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[s2][i] = 0.f;
#pragma unroll
            for (int j = 0; j < QPL; ++j) {
              const int d = 4 * (l + LPT * j), t = ta + s2;
              const float4 rt =
                  *reinterpret_cast<const float4*>(R + t * LD + d);
              const float4 kt =
                  *reinterpret_cast<const float4*>(K + t * LD + d);
              const float4 ut = *reinterpret_cast<const float4*>(Us + d);
              q[s2][j] = rt;
              bonus[s2] += rt.x * ut.x * kt.x + rt.y * ut.y * kt.y +
                           rt.z * ut.z * kt.z + rt.w * ut.w * kt.w;
            }
          }
          // q = r_t prod_{i<j'<t} w'_j' as i walks down from t - 1; keys at
          // or above a lane's step leave its q and (unused) sums alone
#pragma unroll
          for (int i = 7; i >= 0; --i) {
            if (i >= tmax) continue;   // the same for the whole warp
#pragma unroll
            for (int j = 0; j < QPL; ++j) {
              const int row = (T0 + i) * LD + 4 * (l + LPT * j);
              const float4 ki = *reinterpret_cast<const float4*>(K + row);
              float4 wi = *reinterpret_cast<const float4*>(W + row);
              wi.x = fmaxf(wi.x, kFloorW), wi.y = fmaxf(wi.y, kFloorW);
              wi.z = fmaxf(wi.z, kFloorW), wi.w = fmaxf(wi.w, kFloorW);
#pragma unroll
              for (int s2 = 0; s2 < 2; ++s2) {
                float4& qq = q[s2][j];
                acc[s2][i] += qq.x * ki.x + qq.y * ki.y + qq.z * ki.z +
                              qq.w * ki.w;
                const bool live = i < tr + s2;
                qq.x *= live ? wi.x : 1.f;
                qq.y *= live ? wi.y : 1.f;
                qq.z *= live ? wi.z : 1.f;
                qq.w *= live ? wi.w : 1.f;
              }
            }
          }
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            float bs[1] = {bonus[s2]};
            halve<1, LPT / 2>(bs, l);
            halve<8, LPT / 2>(acc[s2], l);
            const int t = ta + s2, tt = tr + s2;
            constexpr int KPL = 8 / LPT > 0 ? 8 / LPT : 1;   // keys a lane
            constexpr int SHARE = LPT > 8 ? LPT / 8 : 1;     // lanes a key
            if (l % SHARE == 0) {
#pragma unroll
              for (int m = 0; m < KPL; ++m) {
                const int i = l / SHARE * KPL + m;
                At[t * LDA2 + T0 + i] = split2(
                    i < tt ? acc[s2][m] : i == tt ? bs[0] : 0.f);
              }
            }
          }
        }
      }
      bar_sync(1, NP);   // Q2 is whole; the stage is read

      // 3. the quadrant of the chunk's diagonal block below its midpoint
      // (steps t >= 8 against keys i < 8) on the tensor cores, one warp:
      // (r e^{L_{t-1} - L_7})_t . (k e^{L_7 - L_i})_i, rows t < 8 zero
      if (warp == kProducers - 1) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k2 = 0; k2 < DP / 8; k2 += 2) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = k2; kk < k2 + 2; ++kk) {
            uint32_t ah[4], al[4], bhi[2], blo[2];
            frag_a(Q2 + 8 * kk, LD2, g, tl, ah, al);
            ah[0] = al[0] = ah[2] = al[2] = 0u;     // rows g < 8
            const float2* p = Q2 + g * LD2 + 8 * kk;  // keys g: [n][k]
            const float2 x0 = p[tl], x1 = p[tl + 4];
            bhi[0] = __float_as_uint(x0.x), blo[0] = __float_as_uint(x0.y);
            bhi[1] = __float_as_uint(x1.x), blo[1] = __float_as_uint(x1.y);
            mma3(part, ah, al, bhi, blo);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] += part[c];
        }
        At[(g + 8) * LDA2 + 2 * tl] = split2(acc[2]);
        At[(g + 8) * LDA2 + 2 * tl + 1] = split2(acc[3]);
      }
      bar_arrive(4 + bb, NALL);   // buffer bb is full
    }
    // the consumers' last two "free" arrivals
    for (int n = nchunks > 2 ? nchunks - 2 : 0; n < nchunks; ++n)
      if (n >= 0) bar_sync(2 + (n & 1), NALL);
    return;
  }

  // --------------------------------------------------------------------
  // Consumers: warp c holds S^T[16 c .. 16 c + 15][all d] in registers,
  // tile j = d-columns 8 j .. 8 j + 7 in the accumulator layout (rows e =
  // 16 c + g, + 8; columns d = 8 j + 2 tl, + 1), and computes y's columns
  // e of its rows for every chunk.
  // --------------------------------------------------------------------
  const int c = warp - kProducers, e0 = 16 * c + g, e1 = e0 + 8;
  float st[P::KT][4];
#pragma unroll
  for (int j = 0; j < P::KT; ++j) {
    const int d = 8 * j + 2 * tl;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int e = x < 2 ? e0 : e1, dd = d + (x & 1);
      st[j][x] = s0 != nullptr && e < D && dd < D
                     ? s0[((long long)bh * D + dd) * D + e]
                     : 0.f;
    }
  }
  for (int n = 0; n < nchunks; ++n) {
    const int bb = n & 1;
    const float2 *Rin = rin(bb), *At = att(bb);
    const float4* Khat = reinterpret_cast<const float4*>(khat(bb));
    const int fl = Frag::slot(lane);
    const float* Dec = dec(bb);
    const float* V = stage(n, 2);   // v, raw: this warp splits its part
    bar_sync(4 + bb, NALL);   // buffer bb is full

    // this warp's v (steps 8 kk + tl, + 4; channels e0, e1), split: A^T of
    // the state update, and B of the intra product for its two n-tiles
    uint32_t vh[C / 8][4], vl[C / 8][4];
#pragma unroll
    for (int kk = 0; kk < C / 8; ++kk) {
      const float* p = V + (8 * kk + tl) * LD;
      split(p[e0], vh[kk][0], vl[kk][0]);
      split(p[e1], vh[kk][1], vl[kk][1]);
      split(p[4 * LD + e0], vh[kk][2], vl[kk][2]);
      split(p[4 * LD + e1], vh[kk][3], vl[kk][3]);
    }

    // y = Rin . S + att . v over this warp's two n-tiles (e0 - g + 0..7,
    // + 8): B of the inter product is S^T's registers, k in the
    // (2 tl, 2 tl + 1) order on both sides
    float yacc[2][4] = {};
#pragma unroll
    for (int k2 = 0; k2 < P::KT; k2 += 2) {
      float part[2][4] = {};
#pragma unroll
      for (int kk = k2; kk < k2 + 2; ++kk) {
        const float4 x0 = *reinterpret_cast<const float4*>(
            Rin + g * LDR + 8 * kk + 2 * tl);
        const float4 x1 = *reinterpret_cast<const float4*>(
            Rin + (g + 8) * LDR + 8 * kk + 2 * tl);
        const uint32_t ah[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                                __float_as_uint(x0.z), __float_as_uint(x1.z)};
        const uint32_t al[4] = {__float_as_uint(x0.y), __float_as_uint(x1.y),
                                __float_as_uint(x0.w), __float_as_uint(x1.w)};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t bhi[2], blo[2];
          split(st[kk][2 * half], bhi[0], blo[0]);
          split(st[kk][2 * half + 1], bhi[1], blo[1]);
          mma3(part[half], ah, al, bhi, blo);
        }
      }
      add_to(yacc, part);
    }
    {
      float part[2][4] = {};
#pragma unroll
      for (int kb = 0; kb < C / 8; ++kb) {
        uint32_t ah[4], al[4];
        frag_a(At + 8 * kb, LDA2, g, tl, ah, al);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t bhi[2] = {vh[kb][half], vh[kb][2 + half]};
          const uint32_t blo[2] = {vl[kb][half], vl[kb][2 + half]};
          mma3(part[half], ah, al, bhi, blo);
        }
      }
      add_to(yacc, part);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = 16 * c + 8 * half + 2 * tl;
      if (e < D) {
        if (n * C + g < S)
          *reinterpret_cast<float2*>(y + base + (n * C + g) * step + e) =
              make_float2(yacc[half][0], yacc[half][1]);
        if (n * C + g + 8 < S)
          *reinterpret_cast<float2*>(y + base + (n * C + g + 8) * step + e) =
              make_float2(yacc[half][2], yacc[half][3]);
      }
    }

    // the state: S^T <- S^T diag(e^{L_c}) + v^T Khat, a tile at a time
#pragma unroll
    for (int j = 0; j < P::KT; ++j) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < C / 8; ++kk) {
        uint32_t q[4];
        as_u32(Khat[(kk * P::KT + j) * 32 + fl], q);
        const uint32_t bhi[2] = {q[0], q[1]}, blo[2] = {q[2], q[3]};
        mma3(part, vh[kk], vl[kk], bhi, blo);
      }
      const float2 f = *reinterpret_cast<const float2*>(Dec + 8 * j + 2 * tl);
      st[j][0] = fmaf(st[j][0], f.x, part[0]);
      st[j][1] = fmaf(st[j][1], f.y, part[1]);
      st[j][2] = fmaf(st[j][2], f.x, part[2]);
      st[j][3] = fmaf(st[j][3], f.y, part[3]);
    }
    bar_arrive(2 + bb, NALL);   // buffer bb is free
  }

#pragma unroll
  for (int j = 0; j < P::KT; ++j) {
    const int d = 8 * j + 2 * tl;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int e = x < 2 ? e0 : e1, dd = d + (x & 1);
      if (e < D && dd < D) s_out[((long long)bh * D + dd) * D + e] = st[j][x];
    }
  }
}

template <int DP>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int S, int H, int D, long long u_bstride, cudaStream_t stream) {
  constexpr size_t smem = Plan<DP>::kBytes;
  static bool ready = false;   // the opt-in above 48 KB, once per kernel
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  rwkv6_scan_kernel<DP>
      <<<(unsigned)(B * H), Plan<DP>::kThreadsAll, smem, stream>>>(
          r, k, v, w, u, s0, y, s_out, S, H, D, u_bstride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, w, y: contiguous (B, S, H, D) fp32 device buffers, 16-byte
// aligned; u (H, D) with u_bstride 0 (every batch row's), or (B, H, D)
// with u_bstride H * D (one a row: the node axis folded into B in
// training); s0 (B, H, D, D) fp32 or null; s_out (B, H, D, D).
// D % 8 == 0 and 8 <= D <= 128. The Python wrapper checks shapes, types
// and devices first (and returns without a launch for an empty batch).
int rwkv6_scan_f32(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int B, int S, int H, int D,
                   long long u_bstride, void* stream) {
  const float *rf = static_cast<const float*>(r),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *wf = static_cast<const float*>(w),
              *uf = static_cast<const float*>(u),
              *s0f = static_cast<const float*>(s0);
  float *yf = static_cast<float*>(y), *sf = static_cast<float*>(s_out);
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 != 0 || D < 8 || D > 128) return (int)cudaErrorInvalidValue;
  if (D <= 32)
    return launch<32>(rf, kf, vf, wf, uf, s0f, yf, sf, B, S, H, D,
                      u_bstride, st);
  if (D <= 64)
    return launch<64>(rf, kf, vf, wf, uf, s0f, yf, sf, B, S, H, D,
                      u_bstride, st);
  return launch<128>(rf, kf, vf, wf, uf, s0f, yf, sf, B, S, H, D,
                      u_bstride, st);
}

}  // extern "C"
