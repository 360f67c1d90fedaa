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
//   delta[s]  = sum_d dout[s, d] out[s, d]                 (pre-pass)
//   P[s, t]   = exp(q[s] . k[t] D^-1/2 - lse[s])           (recomputed)
//   dP[s, t]  = dout[s] . v[t]
//   dS[s, t]  = P[s, t] (dP[s, t] - delta[s])
//   dv[t]     = sum_{s, h in group} P[s, t] dout[s]
//   dk[t]     = D^-1/2 sum_{s, h in group} dS[s, t] q[s]
//   dq[s]     = D^-1/2 sum_t dS[s, t] k[t]
//
//   q, out, dout (B, S, Hq, D); k, v, dk, dv (B, T, Hkv, D); dq like q;
//   lse, delta fp32 (B, Hq, S): lse is the forward's log-sum-exp of each
//   query row (+inf for a row with no live key: P = 0 there). Inputs fp32
//   or bf16, all in one dtype, contiguous in the JAX layout; every sum in
//   fp32, the gradients written once in the inputs' dtype.
//
// Three launches on the caller's stream: the delta pre-pass (one warp a
// query row); the dk / dv kernel, one block per (key tile of 32, kv head,
// batch), looping over the g query heads of its group and the query tiles
// of its band, its 32 x D dk and dv accumulators in registers; the dq
// kernel, one block per (query tile of 64, q head, batch), looping over
// the key tiles of its band. Each recomputes P from q, k and lse. No
// atomics: every gradient element is summed by one thread in a fixed
// order, so the result is deterministic. Only the tiles of the causal or
// window band are visited (the forward's band, seen from either side).
//
// What bounds it on an H100. The work is 5 products of D multiply-adds
// per (query, key) pair of the band (q.k, dout.v, P^T dout, dS^T q,
// dS k: 10 D flops); this kernel recomputes q.k and dout.v in both passes
// (14 D flops a pair). At phase 16 of chip_smoke.py (stablelm-3b: B = 24,
// S = T = 512, 32 heads of D = 80, causal, bf16) that is 8.07e10 flops,
// 0.082 ms at the 989 TFLOP/s bf16 tensor-core peak, against 505 MB of
// inputs and gradients, 0.151 ms at 3.35 TB/s: bytes bound it in bf16,
// operations in fp32 (1.20 ms at 67 TFLOP/s). This first kernel runs on
// the CUDA cores in fp32, register-tiled: 256 threads, each 4 query rows
// x 2 keys of a 64 x 32 score tile (q, dout, k and v tiles in fp32 shared
// memory, rows padded to D + 4 floats: float4 loads, no bank conflicts),
// then 2 keys (dk / dv) or 4 query rows (dq) x D / 16 lanes of the
// accumulators, summed in two levels (a tile's rows or keys, then the
// tiles). D is padded to DP = 64, 128 or 256 in shared memory (zeros past
// D). A tensor-core (wgmma / mma.sync) design is later work.
//
// Nothing is allocated here: the Python wrapper allocates dq, dk, dv and
// delta; every entry returns a CUDA error code (cudaGetLastError() after
// each launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// k, v, dk, dv (B, T, Hkv, D), lse and delta fp32 (B, Hq, S), on the
// stream's device; Hq % Hkv == 0, S >= 1, T >= 1, 0 < D <= 256. delta is
// scratch the call fills. The Python wrapper checks shapes, types and
// devices first.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* out, const void* lse,
                            const void* dout, void* delta, void* dq,
                            void* dk, void* dv, int B, int S, int T_len,
                            int Hq, int Hkv, int D, float scale, int causal,
                            int window, void* stream) {
  return dispatch<float>(q, k, v, out, lse, dout, delta, dq, dk, dv, B, S,
                         T_len, Hq, Hkv, D, scale, causal, window, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* out, const void* lse,
                             const void* dout, void* delta, void* dq,
                             void* dk, void* dv, int B, int S, int T_len,
                             int Hq, int Hkv, int D, float scale, int causal,
                             int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, lse, dout, delta, dq, dk, dv,
                                 B, S, T_len, Hq, Hkv, D, scale, causal,
                                 window, stream);
}

}  // extern "C"
