// The backward pass of flash attention for Hopper (sm_90a): the gradients
// the port's training path takes through the `global` and `local` layers.
//
// The TPU (Pallas) kernel of src/repro/kernels/flash_attention.py
// (_flash_attention, pallas_call at :105) has no backward: the JAX package
// trains through the plain `chunked_attention` and `jax.grad`
// differentiates that. The port's models run every prefill attention in
// the forward kernel of flash_attention.cu, so their gradient is this
// kernel, reached through the autograd Functions of
// kernels/flash_attention.py. With P = softmax(q k^T D^-1/2, masked) and
// out = P v (the forward's masks: t < T; causal t <= s; window w > 0:
// s - t < w; GQA: q head h reads kv head h / g):
//
//   delta[s]  = sum_d dout[s, d] out[s, d]
//   P[s, t]   = exp(q[s] . k[t] D^-1/2 - lse[s])           (recomputed)
//   dP[s, t]  = dout[s] . v[t]
//   dS[s, t]  = P[s, t] (dP[s, t] - delta[s])
//   dv[t]     = sum_{s, h in group} P[s, t] dout[s]
//   dk[t]     = D^-1/2 sum_{s, h in group} dS[s, t] q[s]
//   dq[s]     = D^-1/2 sum_t dS[s, t] k[t]
//
//   q, out, dout (B, S, Hq, D); k, v, dk, dv (B, T, Hkv, D); dq like q;
//   lse fp32 (B, Hq, S): the forward's log-sum-exp of each query row (+inf
//   for a row with no live key: P = 0 there). Inputs fp32 or bf16, all in
//   one dtype, contiguous in the JAX layout; every sum in fp32, the
//   gradients written once in the inputs' dtype.
//
// On the caller's stream, a dk / dv kernel over key tiles, looping over
// the g query heads of its group and the query tiles of its band with its
// dk and dv accumulators in registers, and a dq kernel over query tiles,
// looping over the key tiles of its band; each recomputes P from q, k and
// lse, and reads delta from a pass that precedes it (the CUDA-core path:
// a pre-pass launch; the tensor cores: the dq kernel, launched first). No
// atomics: every gradient element is summed by one thread in a fixed
// order, so the result is deterministic (two calls are bit-equal; fp32
// atomics in dq would give that up for a gain that bytes cap at 0.15 ms at
// phase 16's shape). Only the tiles of the causal or window band are
// visited (the forward's band, seen from either side).
//
// What bounds it on an H100. The work is 5 products of D multiply-adds
// per (query, key) pair of the band (q.k, dout.v, P^T dout, dS^T q,
// dS k: 10 D flops; both kernels recompute q.k and dout.v, 14 D executed,
// and the tensor cores run each D-side product twice, below: 20 D).
// At phase 16 of chip_smoke.py (stablelm-3b: B = 24, S = T = 512, 32 heads
// of D = 80, causal, bf16) that is 8.07e10 flops, 0.082 ms at the 989
// TFLOP/s bf16 tensor-core peak, against 505 MB of inputs and gradients,
// 0.151 ms at 3.35 TB/s: bytes bound it in bf16, operations in fp32 (1.20
// ms at 67 TFLOP/s).
//
// bf16 at D <= 128 (D % 8 == 0): the tensor cores, on the forward's
// machinery (flash_hopper.cuh). Both kernels have the forward's shape: a
// block of 384 threads, one producer warpgroup (setmaxnreg 24) whose one
// thread issues TMA loads (64 x 64 boxes of the (D, H, L, B) view, 128-byte
// swizzle, lanes past D and rows past S or T zero-filled) into a 3-stage
// ring under full / empty mbarriers, and two consumer warpgroups
// (setmaxnreg 240) of 64 rows each. Every product is wgmma: S (or S^T) and
// dP (or dP^T) as m64n64k16 with both operands K-major in shared memory,
// over the k-steps that hold D only (KS: 5 of D = 80's 8); P and dS built
// in registers on the accumulator layout, P = exp2(S D^-1/2 log2 e - lse
// log2 e) in one FFMA and an exp2, and fed to the D-side products as the
// register operand against an MN-major tile (the transpose bit; the
// forward's P v), m64nNk16 with N = DP: 64, 80 (D 72 and 80: stablelm-3b)
// or 128. P and dS enter as two bf16 terms each, hi = bf16(x) and lo =
// bf16(x - hi), two products apiece, every sum in fp32: one rounding to
// bf16 moved a gradient of magnitude 4 to 8 onto the bf16 neighbour of the
// float64 oracle's, 2^-5 away, past the 3e-2 bar (tests/
// test_torch_kernels.py emulates both on the CPU). The dk / dv kernel (a
// block per 128 keys of a kv head; at DP 128 per 64 keys, the two
// warpgroups splitting D, since 64 x 128 dk and dv would not fit in 240
// registers beside the tiles) holds k and v and streams (q, dout) tiles
// with each tile's 64 lse and delta values beside them (one bulk copy
// each): S^T = k q^T, dP^T = v dout^T, dv += P^T dout, dk += dS^T q; its
// dk and dv stay in fp32 registers across the loop. The dq kernel (a block
// per 128 query rows of a q head, the latest rows first) runs first: it
// holds q, dout and out, sums each row's delta from the out and dout
// tiles it loaded anyway, and writes it with lse log2 e over the query
// rows padded to a multiple of 64 (+inf and 0 on the padding) into the
// wrapper's scratch, so each of the dk / dv kernel's tiles takes its run
// in one aligned bulk copy (no pre-pass launch); then it streams (k, v)
// tiles: S = q k^T, dP = dout v^T, dq += dS k. Masks only on tiles that
// cross the diagonal, the window's edge or T (query rows past S carry lse
// = +inf: P = 0). The gradients are written from registers, in bf16,
// scaled once.
//
// fp32, and bf16 at D 192 / 256 (DP 256, where dk and dv alone would take
// 256 registers a thread; no path trains at those widths yet): CUDA cores,
// register-tiled: 256 threads, each 4 query rows x 2 keys of a 64 x 32
// score tile (q, dout, k and v tiles in fp32 shared memory, rows padded
// to D + 4 floats: float4 loads, no bank conflicts), then 2 keys (dk / dv)
// or 4 query rows (dq) x D / 16 lanes of the accumulators, summed in two
// levels (a tile's rows or keys, then the tiles). D is padded to DP = 64,
// 128 or 256 in shared memory (zeros past D). fp32 stays there: TF32
// cannot meet its 2e-5 bar. The dk / dv kernel is a block per (key tile of
// 32, kv head, batch), the dq kernel a block per (query tile of 64, q
// head, batch); their pre-pass writes delta (B, Hq, S) at the scratch's
// start.
//
// Nothing is allocated here: the Python wrapper allocates dq, dk, dv and
// the fp32 scratch; every entry returns a CUDA error code
// (cudaGetLastError() after each launch).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32, and bf16 at DP 256: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;  // 16 (ty) x 16 (tx)
constexpr int kPS = kBK + 1;   // row stride of the P and dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared memory of both kernels, in floats: k, v tiles [kBK][DP + 4]; q
// (scaled by D^-1/2) and dout tiles [kBQ][DP + 4]; P and dS [kBQ][kPS];
// each query row's lse and delta.
template <int DP>
struct Smem {
  static constexpr int kLD = DP + 4;  // float4 rows; row r on banks 4r..
  static constexpr int kK = 0;
  static constexpr int kV = kK + kBK * kLD;
  static constexpr int kQ = kV + kBK * kLD;
  static constexpr int kDO = kQ + kBQ * kLD;
  static constexpr int kP = kDO + kBQ * kLD;
  static constexpr int kDS = kP + kBQ * kPS;
  static constexpr int kL = kDS + kBQ * kPS;
  static constexpr int kDL = kL + kBQ;
  static constexpr size_t kBytes = sizeof(float) * (kDL + kBQ);
};

// ROWS rows of one head into an fp32 tile [ROWS][DP + 4], times `scale`:
// row r of the tile is row r of `src` (`step` elements apart); rows from
// `valid` on and lanes past D read as zeros.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int valid, long long step, int D,
                                          float scale) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    dst[r * (DP + 4) + d] =
        (r < valid && d < D) ? to_f(src[r * step + d]) * scale : 0.f;
  }
}

// acc[i][j] = a[ty + 16 i] . b[tx + 16 j] over DP lanes: a 64 x 32 tile of
// products of the rows of `a` ([kBQ][DP + 4]) and `b` ([kBK][DP + 4]).
template <int DP>
__device__ __forceinline__ void tile_dot(float (&acc)[4][2], const float* a,
                                         const float* b) {
  constexpr int LD = DP + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 av[4], bv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// The query rows' lse and delta for rows q0 .. q0 + kBQ - 1 of head h.
__device__ __forceinline__ void load_rows(float* ls, float* dl,
                                          const float* lse,
                                          const float* delta, long long base,
                                          int q0, int S) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < S;
    ls[r] = in ? lse[base + q0 + r] : 0.f;
    dl[r] = in ? delta[base + q0 + r] : 0.f;
  }
}

// P and dS of the current (query tile q0, key tile k0) pair from the
// scores and dP of this thread's 4 x 2 entries, into shared memory.
__device__ __forceinline__ void p_and_ds(float* ps, float* dss,
                                         const float (&sc)[4][2],
                                         const float (&dp)[4][2],
                                         const float* ls, const float* dl,
                                         int q0, int k0, int S, int T_len,
                                         int causal, int window) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j, t = k0 + c;
      const bool ok = s < S && t < T_len && (!causal || t <= s) &&
                      (window <= 0 || s - t < window);
      const float p = ok ? expf(sc[i][j] - ls[r]) : 0.f;
      if (ps) ps[r * kPS + c] = p;
      dss[r * kPS + c] = p * (dp[i][j] - dl[r]);
    }
  }
}

// delta[b, h, s] = sum_d dout . out, one warp a (b, s, h) row;
// grid ceil(B S Hq / 8), 256 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ out,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int S,
                           int Hq, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp: one row
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(o[d]), to_f(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % Hq);
    const long long bs = row / Hq;
    const long long b = bs / S;
    delta[(b * Hq + h) * S + bs % S] = acc;
  }
}

// dk, dv of keys k0 .. k0 + kBK - 1 of kv head hk, batch b;
// grid (ceil(T / kBK), Hkv, B), kThreads threads, Smem<DP>::kBytes.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S,
                          int T_len, int Hq, int Hkv, int D, float scale,
                          int causal, int window) {
  using L = Smem<DP>;
  constexpr int LD = L::kLD, NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float *ks = smem + L::kK, *vs = smem + L::kV, *qs = smem + L::kQ;
  float *dos = smem + L::kDO, *ps = smem + L::kP, *dss = smem + L::kDS;
  float *ls = smem + L::kL, *dl = smem + L::kDL;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hk = blockIdx.y, b = blockIdx.z, g = Hq / Hkv;
  const int k0 = blockIdx.x * kBK;
  const long long q_step = (long long)Hq * D, k_step = (long long)Hkv * D;
  const long long k_off = ((long long)b * T_len + k0) * k_step +
                          (long long)hk * D;
  load_tile<T, DP, kBK>(ks, k + k_off, T_len - k0, k_step, D, 1.f);
  load_tile<T, DP, kBK>(vs, v + k_off, T_len - k0, k_step, D, 1.f);

  // the band seen from the keys: query rows [s_begin, s_end)
  const int k_last = min(k0 + kBK, T_len) - 1;
  const int s_begin = causal ? k0 : 0;
  const int s_end = window > 0 ? min(S, k_last + window) : S;

  float adk[2][NC], adv[2][NC];  // keys ty * 2 + i, lanes 64 j + 4 tx + e
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int h = hk * g; h < (hk + 1) * g; ++h) {
    const long long row_base = ((long long)b * Hq + h) * S;
    for (int q0 = s_begin / kBQ * kBQ; q0 < s_end; q0 += kBQ) {
      __syncthreads();  // the previous tile's q, dout, P, dS are consumed
      const long long q_off = ((long long)b * S + q0) * q_step +
                              (long long)h * D;
      load_tile<T, DP, kBQ>(qs, q + q_off, S - q0, q_step, D, scale);
      load_tile<T, DP, kBQ>(dos, dout + q_off, S - q0, q_step, D, 1.f);
      load_rows(ls, dl, lse, delta, row_base, q0, S);
      __syncthreads();

      float sc[4][2], dp[4][2];
      tile_dot<DP>(sc, qs, ks);
      tile_dot<DP>(dp, dos, vs);
      p_and_ds(ps, dss, sc, dp, ls, dl, q0, k0, S, T_len, causal, window);
      __syncthreads();

      // dv += P^T dout, dk += dS^T (q D^-1/2), summed in two levels: the
      // tile's 64 rows into tdv / tdk, then the tile into adv / adk (a key
      // sums up to g x S products; one running sum over all of them lost
      // ~n ulps at D 256 with 10 heads a group)
      float tdk[2][NC], tdv[2][NC];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) tdk[i][c] = tdv[i][c] = 0.f;
      for (int r = 0; r < kBQ; ++r) {
        const float p0 = ps[r * kPS + ty * 2], p1 = ps[r * kPS + ty * 2 + 1];
        const float d0 = dss[r * kPS + ty * 2],
                    d1 = dss[r * kPS + ty * 2 + 1];
#pragma unroll
        for (int j = 0; j < DP / 64; ++j) {
          const float4 gv =
              *reinterpret_cast<const float4*>(dos + r * LD + 64 * j + 4 * tx);
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + r * LD + 64 * j + 4 * tx);
          const float ge[4] = {gv.x, gv.y, gv.z, gv.w};
          const float qe[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tdv[0][4 * j + e] = fmaf(p0, ge[e], tdv[0][4 * j + e]);
            tdv[1][4 * j + e] = fmaf(p1, ge[e], tdv[1][4 * j + e]);
            tdk[0][4 * j + e] = fmaf(d0, qe[e], tdk[0][4 * j + e]);
            tdk[1][4 * j + e] = fmaf(d1, qe[e], tdk[1][4 * j + e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          adk[i][c] += tdk[i][c];
          adv[i][c] += tdv[i][c];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + ty * 2 + i;
    if (t >= T_len) continue;
    const long long off = ((long long)b * T_len + t) * k_step +
                          (long long)hk * D;
#pragma unroll
    for (int j = 0; j < DP / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * j + 4 * tx + e;
        if (d < D) {
          dk[off + d] = from_f<T>(adk[i][4 * j + e]);
          dv[off + d] = from_f<T>(adv[i][4 * j + e]);
        }
      }
  }
}

// dq of query rows q0 .. q0 + kBQ - 1 of q head h, batch b;
// grid (ceil(S / kBQ), Hq, B), kThreads threads, Smem<DP>::kBytes.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int T_len, int Hq, int Hkv, int D,
                        float scale, int causal, int window) {
  using L = Smem<DP>;
  constexpr int LD = L::kLD, NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float *ks = smem + L::kK, *vs = smem + L::kV, *qs = smem + L::kQ;
  float *dos = smem + L::kDO, *dss = smem + L::kDS;
  float *ls = smem + L::kL, *dl = smem + L::kDL;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const long long q_step = (long long)Hq * D, k_step = (long long)Hkv * D;
  const long long q_off = ((long long)b * S + q0) * q_step + (long long)h * D;
  load_tile<T, DP, kBQ>(qs, q + q_off, S - q0, q_step, D, scale);
  load_tile<T, DP, kBQ>(dos, dout + q_off, S - q0, q_step, D, 1.f);
  load_rows(ls, dl, lse, delta, ((long long)b * Hq + h) * S, q0, S);

  // the band: keys [k_begin, k_end) hold every live pair of this q tile
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;

  float acc[4][NC];  // query rows ty * 4 + i, lanes 64 j + 4 tx + e
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's k, v and dS are consumed
    const long long k_off = ((long long)b * T_len + k0) * k_step +
                            (long long)hk * D;
    load_tile<T, DP, kBK>(ks, k + k_off, T_len - k0, k_step, D, 1.f);
    load_tile<T, DP, kBK>(vs, v + k_off, T_len - k0, k_step, D, 1.f);
    __syncthreads();

    float sc[4][2], dp[4][2];
    tile_dot<DP>(sc, qs, ks);
    tile_dot<DP>(dp, dos, vs);
    p_and_ds(nullptr, dss, sc, dp, ls, dl, q0, k0, S, T_len, causal, window);
    __syncthreads();

    // dq += dS k (the D^-1/2 at the end), the tile's 32 keys into tdq,
    // then the tile into acc (two levels, as dk and dv)
    float tdq[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) tdq[i][c] = 0.f;
    for (int c = 0; c < kBK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DP / 64; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + c * LD + 64 * j + 4 * tx);
        const float ke[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tdq[i][4 * j + e] = fmaf(ds[i], ke[e], tdq[i][4 * j + e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] += tdq[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    T* dst = dq + ((long long)b * S + s) * q_step + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DP / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * j + 4 * tx + e;
        if (d < D) dst[d] = from_f<T>(acc[i][4 * j + e] * scale);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* lse, const void* dout, void* delta, void* dq,
           void* dk, void* dv, int B, int S, int T_len, int Hq, int Hkv,
           int D, float scale, int causal, int window, cudaStream_t stream) {
  const long long rows = (long long)B * S * Hq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), kThreads, 0,
                              stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, S, Hq, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem = (int)Smem<DP>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_kv((unsigned)((T_len + kBK - 1) / kBK), (unsigned)Hkv,
                     (unsigned)B);
  flash_bwd_dkdv_kernel<T, DP><<<grid_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, T_len, Hq, Hkv, D, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_q((unsigned)((S + kBQ - 1) / kBQ), (unsigned)Hq,
                    (unsigned)B);
  flash_bwd_dq_kernel<T, DP><<<grid_q, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, T_len, Hq, Hkv, D, scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D <= 128: wgmma, TMA, a 3-stage ring, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kT = 64;            // rows of a tile: keys or query rows
constexpr int kStages = 3;        // ring depth
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreadsH = 384;    // + the producer warpgroup
constexpr int kRowBytes = kT * 4; // one tile's lse or delta, fp32

// Shared memory of the dk / dv kernel, in bytes from a 1024-aligned base:
// k and v [key tiles][ceil(DP / 64) boxes], loaded once; q and dout
// [stage][ceil(DP / 64) boxes]; each stage's 64 query rows' lse (times
// log2 e) and delta; the mbarriers (kv, full[], empty[]).
template <int DP>
struct SmemKV {
  static constexpr bool kSplit = DP > 80;  // 64 keys a block, D split
  static constexpr int kChunks = (DP + 63) / 64;
  static constexpr int kKeyTiles = kSplit ? 1 : 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKeyTiles * kChunks * kBox;
  static constexpr int kQ = kV + kKeyTiles * kChunks * kBox;
  static constexpr int kDO = kQ + kStages * kChunks * kBox;
  static constexpr int kRow = kDO + kStages * kChunks * kBox;
  static constexpr int kBar = kRow + kStages * 2 * kRowBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// Shared memory of the dq kernel: q, dout and out [2 warpgroups]
// [ceil(DP / 64) boxes], loaded once; k and v [stage][ceil(DP / 64)
// boxes]; the mbarriers (q, full[], empty[]).
template <int DP>
struct SmemQ {
  static constexpr int kChunks = (DP + 63) / 64;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + 2 * kChunks * kBox;
  static constexpr int kO = kDO + 2 * kChunks * kBox;
  static constexpr int kK = kO + 2 * kChunks * kBox;
  static constexpr int kV = kK + kStages * kChunks * kBox;
  static constexpr int kBar = kV + kStages * kChunks * kBox;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// S^T (or S) = a b^T over the first KS 16-lane k-steps of two K-major
// tiles of swizzled 64-lane boxes (lanes past D are zeros, so the k-steps
// wholly past D are left out); the product is left in flight (committed by
// the caller).
template <int KS>
__device__ __forceinline__ void wgmma_tile_ss(float (&d)[32], uint32_t a,
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(a + off, 16, 1024),
                 sw128_desc(b + off, 16, 1024), kk > 0);
  }
}

// acc (64 x DP) += A (64 x 64, bf16 in registers, 4 k-steps) . B (64 x DP
// rows of an MN-major tile of swizzled 64-lane boxes).
template <int DP>
__device__ __forceinline__ void wgmma_tile_rs(float (&acc)[DP / 2],
                                              const uint32_t (&a)[4][4],
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
    wgmma_rs<DP>(acc, a[kk], sw128_desc(b + kk * 16 * 128, 64 * 128, 1024));
}

// Two fp32 values as two bf16 terms each, one register of wgmma's bf16
// register operand per term: hi = bf16(x), lo = bf16(x - hi) (x - hi is
// exact in fp32), so hi + lo carries 16 bits of x's mantissa. In a 64 x 64
// accumulator, k-step kk covers columns 16 kk .. 16 kk + 15, registers
// 8 kk .. 8 kk + 7, register e of the operand the pair 8 kk + 2 e, + 1.
__device__ __forceinline__ void split2(uint32_t& hi, uint32_t& lo, float x0,
                                       float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// One tile of the dk / dv kernel once its S^T and dP^T are in: P^T =
// exp2(S^T D^-1/2 log2 e - lse2) and dS^T = P^T (dP^T - delta) of each
// (key, query) pair, the query's lse2 and delta from shared memory (ls,
// dl), as two bf16 terms each (registers 8 kk + 2 e and + 1: key key_a +
// 8 (e & 1), queries q0 + c and c + 1); the causal and window masks only
// on tiles that cross them (query rows past S have lse2 = +inf: P = 0;
// keys past T are never written). Then dv += P^T dout and dk += dS^T q
// (the D^-1/2 at the end) are issued, P^T and dS^T the register operand
// (a: P^T hi, lo, dS^T hi, lo), dout and q MN-major (doa, qa).
template <int KN>
__device__ __forceinline__ void dkdv_tile(
    float (&adk)[KN / 2], float (&adv)[KN / 2], const float (&s)[32],
    const float (&dp)[32], uint32_t (&a)[4][4][4], const float* ls,
    const float* dl, uint32_t qa, uint32_t doa, int q0, int kr0, int key_a,
    int col_t, float scale_log2, int causal, int window) {
  const bool edge = (causal && q0 < kr0 + kT - 1) ||
                    (window > 0 && q0 + kT - 1 - kr0 >= window);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * kk + 2 * e, c = 16 * kk + 8 * (e >> 1) + col_t;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
      float p0 = exp2f(fmaf(s[n], scale_log2, -l2.x));
      float p1 = exp2f(fmaf(s[n + 1], scale_log2, -l2.y));
      if (edge) {
        const int t = key_a + 8 * (e & 1), qs = q0 + c;
        if ((causal && qs < t) || (window > 0 && qs - t >= window))
          p0 = 0.f;
        if ((causal && qs + 1 < t) || (window > 0 && qs + 1 - t >= window))
          p1 = 0.f;
      }
      split2(a[0][kk][e], a[1][kk][e], p0, p1);
      split2(a[2][kk][e], a[3][kk][e], p0 * (dp[n] - d2.x),
             p1 * (dp[n + 1] - d2.y));
    }
  wgmma_fence();
  wgmma_tile_rs<KN>(adv, a[0], doa);
  wgmma_tile_rs<KN>(adv, a[1], doa);
  wgmma_tile_rs<KN>(adk, a[2], qa);
  wgmma_tile_rs<KN>(adk, a[3], qa);
}

// One tile of the dq kernel once its S and dP are in: dS = P (dP - delta),
// P = exp2(S D^-1/2 log2 e - lse2), the row's lse2 and delta in l2, d2, as
// two bf16 terms (registers 8 kk + 2 e and + 1: row row_a + 8 (e & 1),
// keys k0 + c and c + 1); the masks only on tiles that cross T, the
// diagonal or the window's edge. Then dq += dS k is issued, dS the
// register operand (a[0], a[1]: hi, lo), k MN-major (ka).
template <int DP>
__device__ __forceinline__ void dq_tile(
    float (&acc)[DP / 2], const float (&s)[32], const float (&dp)[32],
    uint32_t (&a)[2][4][4], const float (&l2)[2], const float (&d2)[2],
    uint32_t ka, int k0, int r0, int row_a, int col_t, int T_len,
    float scale_log2, int causal, int window) {
  const bool edge = k0 + kT > T_len || (causal && k0 + kT - 1 > r0) ||
                    (window > 0 && k0 <= r0 + kT - 1 - window);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * kk + 2 * e, r = e & 1;
      float p0 = exp2f(fmaf(s[n], scale_log2, -l2[r]));
      float p1 = exp2f(fmaf(s[n + 1], scale_log2, -l2[r]));
      if (edge) {
        const int row = row_a + 8 * r;
        const int t = k0 + 16 * kk + 8 * (e >> 1) + col_t;
        if (t >= T_len || (causal && t > row) ||
            (window > 0 && row - t >= window))
          p0 = 0.f;
        if (t + 1 >= T_len || (causal && t + 1 > row) ||
            (window > 0 && row - t - 1 >= window))
          p1 = 0.f;
      }
      split2(a[0][kk][e], a[1][kk][e], p0 * (dp[n] - d2[r]),
             p1 * (dp[n + 1] - d2[r]));
    }
  wgmma_fence();
  wgmma_tile_rs<DP>(acc, a[0], ka);
  wgmma_tile_rs<DP>(acc, a[1], ka);
}

// dk, dv of the keys of one block of kv head hk, batch b, over every (q
// head of the group, query tile of the band); grid (ceil(T / kKeys), Hkv,
// B), kThreadsH threads, SmemKV<DP>::kBytes dynamic; S^T and dP^T over KS
// >= ceil(D / 16) k-steps. DP <= 80: a block holds 128 keys, consumer
// warpgroup w the 64 keys k0 + 64 w .. + 63 with their 64 x DP dk and dv
// in registers. DP 128 (64 x 128 dk and dv would not fit beside the tiles
// in 240 registers a thread): a block holds 64 keys, both warpgroups
// compute their S^T and dP^T, and warpgroup w holds lanes 64 w .. + 63 of
// their dk and dv. Accumulator layout as the forward's: thread t of a
// warpgroup holds rows r = 16 (t / 32) + (t % 32) / 4 and r + 8 (keys
// here); register 4j + e is column 8j + 2 (t % 4) + (e & 1) of row r (e <
// 2) or r + 8 (e >= 2). Each warpgroup's tile runs its four products as
// two wgmma stages, each issued, committed and waited for within the tile
// (a stage left in flight across the loop's back edge made ptxas serialise
// every wgmma); tiles wholly outside the warpgroup's band are skipped.
template <int DP, int KS>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse2,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int S,
                               int S_pad, int T_len, int Hq, int Hkv, int D,
                               float scale, float scale_log2, int causal,
                               int window) {
  using L = SmemKV<DP>;
  constexpr int NC = L::kChunks;
  constexpr int kN = L::kSplit ? 64 : DP;      // dk / dv lanes a warpgroup
  constexpr int kKeys = L::kSplit ? kT : 2 * kT;
  constexpr uint32_t kStageBytes = 2 * NC * kBox + 2 * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = base + L::kK, sv = base + L::kV, sq = base + L::kQ;
  const uint32_t sdo = base + L::kDO, srow = base + L::kRow;
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * kStages;
  const float* rows = reinterpret_cast<const float*>(
      smem_raw + (srow - smem_addr(smem_raw)));

  const int k0 = blockIdx.x * kKeys;
  const int hk = blockIdx.y, b = blockIdx.z, g = Hq / Hkv;
  // the band seen from the keys: query tiles [qt_begin, qt_begin + nq) of
  // each q head of the group hold every live pair of this block's keys
  const int k_last = min(k0 + kKeys, T_len) - 1;
  const int s_begin = causal ? k0 : 0;
  const int s_end = window > 0 ? min(S, k_last + window) : S;
  const int qt_begin = s_begin / kT;
  const int nq = max(0, (s_end + kT - 1) / kT - qt_begin);
  const int n_tiles = g * nq;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
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
      mbar_expect_tx(bar_kv, 2 * (kKeys / kT) * NC * kBox);
      for (int w = 0; w < kKeys / kT; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load(sk + (w * NC + c) * kBox, &tm_k, bar_kv, c * 64, hk,
                   k0 + kT * w, b);
          tma_load(sv + (w * NC + c) * kBox, &tm_v, bar_kv, c * 64, hk,
                   k0 + kT * w, b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kStageBytes);
        const int h = hk * g + i / nq, q0 = (qt_begin + i % nq) * kT;
        for (int c = 0; c < NC; ++c) {
          tma_load(sq + (st * NC + c) * kBox, &tm_q, full, c * 64, h, q0, b);
          tma_load(sdo + (st * NC + c) * kBox, &tm_do, full, c * 64, h, q0,
                   b);
        }
        const long long r0 = ((long long)b * Hq + h) * S_pad + q0;
        bulk_load(srow + st * 2 * kRowBytes, lse2 + r0, kRowBytes, full);
        bulk_load(srow + st * 2 * kRowBytes + kRowBytes, delta + r0,
                  kRowBytes, full);
      }
    }
    return;
  }

  // consumer warpgroups 0 and 1: keys kr0 .. kr0 + 63, lanes lane0 ..
  // lane0 + kN - 1 of their dk and dv
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int kr0 = L::kSplit ? k0 : k0 + kT * wg;
  const int lane0 = L::kSplit ? 64 * wg : 0;
  const int key_a = kr0 + 16 * warp + lane / 4;  // and key_a + 8
  const int col_t = 2 * (lane % 4);
  const uint32_t ka = sk + (L::kSplit ? 0 : wg) * NC * kBox;
  const uint32_t va = sv + (L::kSplit ? 0 : wg) * NC * kBox;
  const uint32_t lane_off = (lane0 / 64) * kBox;  // the B tiles' first box

  float adk[kN / 2], adv[kN / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) adk[i] = adv[i] = 0.f;
  uint32_t a[4][4][4];  // P^T hi, lo, dS^T hi, lo: wgmma's register operand

  mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
    const int q0 = (qt_begin + i % nq) * kT;
    // tiles wholly outside this warpgroup's band are skipped
    const bool skip = kr0 >= T_len || (causal && q0 + kT - 1 < kr0) ||
                      (window > 0 && q0 - (kr0 + kT - 1) >= window);
    if (!skip) {
      wgmma_fence();
      wgmma_tile_ss<KS>(s, ka, sq + st * NC * kBox);
      wgmma_tile_ss<KS>(dp, va, sdo + st * NC * kBox);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      dkdv_tile<kN>(adk, adv, s, dp, a, rows + st * 2 * kT,
                    rows + st * 2 * kT + kT, sq + st * NC * kBox + lane_off,
                    sdo + st * NC * kBox + lane_off, q0, kr0, key_a, col_t,
                    scale_log2, causal, window);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adk);
      fence_regs(adv);
    }
    mbar_arrive(bar_empty + 8 * st);
  }

  // dk (times D^-1/2) and dv in bf16; keys past T are never written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = key_a + 8 * r;
    if (t >= T_len) continue;
    const long long off = (((long long)b * T_len + t) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = lane0 + 8 * j + col_t;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
            __floats2bfloat162_rn(adk[4 * j + 2 * r] * scale,
                                  adk[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            __floats2bfloat162_rn(adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dq of query rows q0 .. q0 + 127 of q head h, batch b: consumer warpgroup
// w owns rows q0 + 64 w .. + 63, its 64 x DP accumulator in registers over
// the key tiles of its band, the forward's loop (two wgmma stages a tile,
// as the dk / dv kernel's); grid (ceil(S / 128), Hq, B), kThreadsH
// threads, SmemQ<DP>::kBytes dynamic; KS as the dk / dv kernel's.
template <int DP, int KS>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_o,
                             const float* __restrict__ lse,
                             float* __restrict__ lse2,
                             float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int S,
                             int S_pad, int T_len, int Hq, int Hkv, int D,
                             float scale, float scale_log2, int causal,
                             int window) {
  using L = SmemQ<DP>;
  constexpr int NC = L::kChunks;
  constexpr uint32_t kStageBytes = 2 * NC * kBox;  // k and v of one tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base + L::kQ, sdo = base + L::kDO, so = base + L::kO;
  const uint32_t sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;

  // the heaviest q tiles (latest rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 2 * kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  // the band: key tiles [t_begin, t_begin + n_tiles) hold every live pair
  const int q_last = min(q0 + 2 * kT, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int t_begin = k_begin / kT;
  const int n_tiles = max(0, (k_end + kT - 1) / kT - t_begin);

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
      mbar_expect_tx(bar_q, 6 * NC * kBox);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load(sq + (w * NC + c) * kBox, &tm_q, bar_q, c * 64, h,
                   q0 + kT * w, b);
          tma_load(sdo + (w * NC + c) * kBox, &tm_do, bar_q, c * 64, h,
                   q0 + kT * w, b);
          tma_load(so + (w * NC + c) * kBox, &tm_o, bar_q, c * 64, h,
                   q0 + kT * w, b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kStageBytes);
        const int k0 = (t_begin + i) * kT;
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
  const int r0 = q0 + kT * wg;
  const int row_a = r0 + 16 * warp + lane / 4;  // and row_a + 8
  const int col_t = 2 * (lane % 4);
  const uint32_t qa = sq + wg * NC * kBox, doa = sdo + wg * NC * kBox;

  float acc[DP / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  uint32_t a[2][4][4];  // dS hi, lo: wgmma's register operand

  // each of the thread's two rows' delta = sum_d dout . out from the
  // tiles (a row's 4 quad threads take every 4th 16-byte chunk of it; the
  // 128-byte swizzle puts chunk c of row r at c ^ (r % 8)) and lse log2 e
  // (rows past S: +inf and 0, so P = 0), written to the scratch for the
  // dk / dv kernel too, padding rows included
  mbar_wait(bar_q, 0);
  const uint8_t* tiles = smem_raw + (base - smem_addr(smem_raw));
  const long long bh = (long long)b * Hq + h;
  float l2[2], d2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = row_a - r0 + 8 * r, row = row_a + 8 * r;
    float sum = 0.f;
    for (int c = lane % 4; 8 * c < D; c += 4) {
      const int off = (wg * NC + c / 8) * kBox + rl * 128 +
                      ((c % 8) ^ (rl % 8)) * 16;
      const uint4 ov = *reinterpret_cast<const uint4*>(tiles + L::kO + off);
      const uint4 gv = *reinterpret_cast<const uint4*>(tiles + L::kDO + off);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 gf = __bfloat1622float2(g2[e]);
        sum = fmaf(of.x, gf.x, sum);
        sum = fmaf(of.y, gf.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l2[r] = row < S ? lse[bh * S + row] * kLog2e : __int_as_float(0x7f800000);
    d2[r] = row < S ? sum : 0.f;
    if ((lane & 3) == 0 && row < S_pad) {
      lse2[bh * S_pad + row] = l2[r];
      delta[bh * S_pad + row] = d2[r];
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
    const int k0 = (t_begin + i) * kT;
    // tiles wholly outside this warpgroup's band are skipped
    const bool skip = r0 >= S || (causal && k0 > r0 + kT - 1) ||
                      (window > 0 && k0 + kT - 1 <= r0 - window);
    if (!skip) {
      wgmma_fence();
      wgmma_tile_ss<KS>(s, qa, sk + st * NC * kBox);
      wgmma_tile_ss<KS>(dp, doa, sv + st * NC * kBox);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      dq_tile<DP>(acc, s, dp, a, l2, d2, sk + st * NC * kBox, k0, r0, row_a,
                  col_t, T_len, scale_log2, causal, window);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty + 8 * st);
  }

  // dq = D^-1/2 acc in bf16; rows past S are never written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* dst = dq + (((long long)b * S + row) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col_t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

template <int DP, int KS>
int launch_bf16(const void* q, const void* k, const void* v, const void* out,
                const void* lse, const void* dout, void* scratch, void* dq,
                void* dk, void* dv, int B, int S, int T_len, int Hq, int Hkv,
                int D, float scale, int causal, int window,
                cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_o;
  if (!encode_map(encode, &tm_q, q, D, Hq, S, B) ||
      !encode_map(encode, &tm_k, k, D, Hkv, T_len, B) ||
      !encode_map(encode, &tm_v, v, D, Hkv, T_len, B) ||
      !encode_map(encode, &tm_do, dout, D, Hq, S, B) ||
      !encode_map(encode, &tm_o, out, D, Hq, S, B))
    return (int)cudaErrorInvalidValue;
  const int S_pad = (S + kT - 1) / kT * kT;
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + (long long)B * Hq * S_pad;
  const float scale_log2 = scale * kLog2e;
  const int smem_kv = SmemKV<DP>::kBytes, smem_q = SmemQ<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16_kernel<DP, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DP, KS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;

  // dq first: it writes the rows' lse log2 e and delta the dk / dv kernel
  // reads
  const dim3 grid_q((unsigned)((S + 2 * kT - 1) / (2 * kT)), (unsigned)Hq,
                    (unsigned)B);
  flash_bwd_dq_bf16_kernel<DP, KS>
      <<<grid_q, kThreadsH, smem_q, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_o, static_cast<const float*>(lse), lse2,
      delta, static_cast<__nv_bfloat16*>(dq), S, S_pad, T_len, Hq, Hkv, D,
      scale, scale_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int keys = SmemKV<DP>::kSplit ? kT : 2 * kT;  // a block's
  const dim3 grid_kv((unsigned)((T_len + keys - 1) / keys), (unsigned)Hkv,
                     (unsigned)B);
  flash_bwd_dkdv_bf16_kernel<DP, KS>
      <<<grid_kv, kThreadsH, smem_kv, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse2, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S,
      S_pad, T_len, Hq, Hkv, D, scale, scale_log2, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* lse, const void* dout, void* delta, void* dq,
             void* dk, void* dv, int B, int S, int T_len, int Hq, int Hkv,
             int D, float scale, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, S,
                         T_len, Hq, Hkv, D, scale, causal, window, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, S,
                          T_len, Hq, Hkv, D, scale, causal, window, st);
  if (D <= 256)
    return launch<T, 256>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, S,
                          T_len, Hq, Hkv, D, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Every entry: contiguous device buffers q, out, dout, dq (B, S, Hq, D),
// k, v, dk, dv (B, T, Hkv, D) and lse fp32 (B, Hq, S), on the stream's
// device; Hq % Hkv == 0, S >= 1, T >= 1, 0 < D <= 256; scratch, fp32, 2 B
// Hq S_pad floats the call fills (S_pad = S rounded up to a multiple of
// 64: the tensor-core path's lse log2 e and delta over padded rows; the
// CUDA-core path writes delta (B, Hq, S) at its start). The bf16 entry
// also needs D % 8 == 0 and 16-byte aligned q, k, v, out and dout (TMA and
// 16-byte loads). The Python wrapper checks shapes, types, alignment and
// devices first.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* out, const void* lse,
                            const void* dout, void* scratch, void* dq,
                            void* dk, void* dv, int B, int S, int T_len,
                            int Hq, int Hkv, int D, float scale, int causal,
                            int window, void* stream) {
  return dispatch<float>(q, k, v, out, lse, dout, scratch, dq, dk, dv, B, S,
                         T_len, Hq, Hkv, D, scale, causal, window, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* out, const void* lse,
                             const void* dout, void* scratch, void* dq,
                             void* dk, void* dv, int B, int S, int T_len,
                             int Hq, int Hkv, int D, float scale, int causal,
                             int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  // (DP, KS): D 80 (stablelm-3b) takes the 80-lane products (wgmma N = 80)
  // and 5 k-steps of its two 64-lane boxes
  if (D <= 64)
    return launch_bf16<64, 4>(q, k, v, out, lse, dout, scratch, dq, dk, dv,
                              B, S, T_len, Hq, Hkv, D, scale, causal, window,
                              st);
  if (D <= 80)
    return launch_bf16<80, 5>(q, k, v, out, lse, dout, scratch, dq, dk, dv,
                               B, S, T_len, Hq, Hkv, D, scale, causal,
                               window, st);
  if (D <= 128)
    return launch_bf16<128, 8>(q, k, v, out, lse, dout, scratch, dq, dk, dv,
                               B, S, T_len, Hq, Hkv, D, scale, causal,
                               window, st);
  return launch<__nv_bfloat16, 256>(q, k, v, out, lse, dout, scratch, dq, dk,
                                    dv, B, S, T_len, Hq, Hkv, D, scale,
                                    causal, window, st);
}

}  // extern "C"
