// The gradient of the RWKV-6 WKV scan for Hopper (sm_90a): the backward of
// the port's `rwkv` time-mix layers in training.
//
// The JAX package has no Pallas kernel for it: jax.grad differentiates the
// plain chunked scan (src/repro/models/rwkv6.py, wkv_chunked). It belongs
// to the forward kernel of src/repro/kernels/rwkv6_scan.py (_rwkv6_scan,
// pallas_call at :87), whose port is csrc/rwkv6_scan.cu.
//
// Per (b, h), with the forward's (D, D) state S (row d = key channel,
// column e = value channel), w' = max(w, 1e-12), S_{-1} = s0 (or 0),
// S_t = diag(w'_t) S_{t-1} + k_t v_t^T and y_t = S_{t-1}^T r_t +
// (r_t . u k_t) v_t, and G_t = dL/dS_t carried backwards from
// G_{S-1} = ds_final (or 0) by G_{t-1} = diag(w'_t) G_t + r_t dy_t^T:
//
//   dr_t = S_{t-1} dy_t + c_t u k_t,      c_t = dy_t . v_t
//   dk_t = G_t v_t + c_t u r_t
//   dv_t = G_t^T k_t + (r_t . u k_t) dy_t
//   dw_t = sum_e G_t[., e] S_{t-1}[., e]   (0 where w < 1e-12)
//   du   = sum_t c_t r_t k_t               (per batch row)
//   ds0  = G_{-1}
//
// r, k, v, w, dy and dr, dk, dv, dw (B, S, H, D) fp32 contiguous, 16-byte
// aligned; u (H, D) shared (u_bstride 0) or per batch row (u_bstride H D);
// s0, ds_final, ds0 (B, H, D, D) or null; du (B, H, D).
//
// The chunked form, the forward's run backwards. In chunks of C = 16 steps
// (one mma row tile), with S_c the state before the chunk, G_e the
// gradient of the state after its last step, P_{<t} and P_{>t} the prefix
// and suffix products of w' inside the chunk, P_(i,t) = prod_{i<j<t} w'_j
// and Khat_t = k_t P_{>t}, Rin_t = r_t P_{<t} (the forward's factors):
//
//   dr_t = P_{<t} (S_c dy_t) + sum_{i<t} M_ti P_(i,t) k_i + c_t u k_t
//   dk_t = P_{>t} (G_e v_t) + sum_{t'>t} M_t't P_(t,t') r_t' + c_t u r_t
//   dv_t = G_e^T Khat_t + sum_{t'>=t} att_t't dy_t'   (att: the forward's,
//                                                      the bonus on its
//                                                      diagonal)
//   dw_t = P_{<t} P_{>t} rowsum(G_e o S_c) + P_{>t} x_t + P_{<t} y_t
//          + sum_{t'>t} P_(t,t') r_t' z_t(t'),
//     x_{t+1} = w'_t x_t + k_t (G_e v_t),  y_{t-1} = w'_t y_t + r_t (S_c dy_t),
//     z_{t+1}(t') = w'_t z_t(t') + k_t M_t't,   M = dY V^T, c_t = M_tt.
//
// The sums over i < t and t' > t split at the chunk's midpoint h = 8: the
// quadrant (i < 8 <= t) on the tensor cores with factors referenced there,
// P_(i,t) = A_i B_t, A_i = prod_{i<j<8} w'_j, B_t = prod_{8<=j<t} w'_j,
// so (M_[t>=8, i<8] (k A)) B and (M^T (r B)) A, and att's quadrant
// (r B)(k A)^T; the pairs inside one half pairwise on the CUDA cores (a
// Horner walk over products of w'). The z term likewise: within a half by
// its recurrence, across the midpoint B_t sum_{t'>t} P_(t,t') r_t' (M (k
// A))_t' for t >= 8 and A_t sum_{i<t} P_(i,t) k_i (M^T (r B))_i for t < 8,
// from the quadrant products already formed. Every factor is a product of
// w' <= 1 between two points of the chunk: nothing overflows and no factor
// divides by w (the gated-linear-attention identity's d log w / w loses
// eps / w in fp32 at the decays the model draws). dw stays the product of
// G and S: its four terms are that product expanded.
//
// Three launches, no atomics (two calls are bit-equal):
//   1. rwkv6_bwd_walk_kernel, grid (B H, 2): CTA (bh, 0) walks S forward
//      (S <- diag(prod w') S + Khat^T V a chunk), saving S before every
//      group of kGroup chunks; CTA (bh, 1) walks G backward (G <-
//      diag(prod w') G + Rin^T dY), saving G after every group's last
//      chunk, and writes ds0. The state lives in the mma accumulator
//      registers, a 16-row band a warp (its A fragments split once a
//      chunk); the rows come by cp.async two chunks ahead.
//   2. rwkv6_bwd_chunk_kernel, a CTA of 8 warps per (b, h, group): all the
//      group's rows by cp.async at once (a commit group a chunk, S with
//      the first); forward over its chunks, S_c kept in shared memory:
//        S_c dY^T and dr's quadrant on every warp, then
//        dr, dw's y and z terms and du's part on the CUDA cores (a thread
//        pair a channel, one 8-step half each, a warp a half of 32
//        channels) beside the next S_c (a 16-row band a warp, its column
//        tiles in flight together) and the next chunk's M and k A;
//      backward over them, G_e in the slot of the S_c it follows:
//        G_e V^T (two tiles a warp sharing A), M^T's and att's quadrants,
//        att's halves and rowsum(G_e o S_c) on every thread, then
//        dk and dw's other terms (dw's forward terms kept in shared
//        memory) beside dv = Khat G_e + att^T dY, then
//        the previous G_e on every warp beside the previous chunk's
//        factors.
//   3. rwkv6_bwd_du_kernel: du, the groups' parts summed in order.
// At D = 128 (kGroup 1) the group is one chunk: kernel 2 reads S_c and
// G_e from the workspace and rebuilds nothing.
//
// Every product is 3xTF32 on mma.sync.m16n8k8 (x = hi + lo, a b = al bh +
// ah bl + ah bh), summed two k-steps at a time into a zeroed partial that
// is then added in fp32, as in the forward: the tensor cores truncate as
// they accumulate.
//
// What bounds it on an H100: bytes. At rwkv6-7b's training shape on 3
// nodes (B = 12, S = 512, H = 64, D = 64) r, k, v, w, dy in and dr, dk,
// dv, dw out are 9 x 100.7 MB, 0.271 ms at 3.35 TB/s; the flops (8 D^2 a
// step and head in the plain recurrences, 1.29e10) take 0.192 ms at 67
// TFLOP/s fp32. This design moves more: walk 1 reads k, v, w and r, dy, w
// (604 MB), the workspace holds S and G every 64 steps (100.7 MB each,
// written once and read once: 403 MB), kernel 2 reads the five inputs
// once and writes the four outputs once: 1.9 GB, 0.57 ms at 3.35 TB/s.
// It runs far from that: the walks at ~2.1 TB/s, kernel 2 at one CTA an
// SM (its shared memory: 4 chunks of rows and 5 states, 217 KB at D 64)
// through five barrier-separated stages a chunk, whose two sides both
// cost time and which 16 warps instead of 8 do not shorten: the SM's
// issue and shared-memory throughput, not latency (PERF.md).
//
// The launches go on the caller's stream and the entry returns
// cudaGetLastError(); the wrapper allocates every output and the
// workspace.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kC = 16;          // steps a chunk: one mma row tile
constexpr int kHalf = 8;        // the quadrants' midpoint
constexpr float kFloorW = 1e-12f;
constexpr int kWarps = 8;       // kernel 2's warps
constexpr int kThreads = 32 * kWarps;

__host__ __device__ constexpr int pow2_floor(int x) {
  return x >= 2 ? 2 * pow2_floor(x / 2) : 1;
}

// chunks a workspace group: S and G are saved every kGroup chunks; at D =
// 128 four rebuilt states do not fit in shared memory
template <int DP>
struct Grp {
  static constexpr int NG = DP <= 64 ? 4 : 1;
};

// x = hi + lo for 3xTF32: the tensor cores read the top 10 mantissa bits
// of a .tf32 operand, so hi is x itself and lo = x - trunc(x) (exact).
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

// d += a b in 3xTF32 from split operands, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
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

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

// acc (a 16 x 8 tile in the mma accumulator layout: rows g, g + 8, columns
// 2 tl, 2 tl + 1) += A (16 x K) B (K x 8) in 3xTF32, one warp. A(m, k) =
// a[m sam + k sak] for its live rows, the others 0: LIVE 3 all 16, LIVE 1
// rows 0-7, LIVE 2 rows 8-15 (row m stored at a + (m - 8) sam); B(k, n) =
// b[k sbk + n sbn]. a and b may point to shared or global memory.
template <int K, int LIVE = 3>
__device__ __forceinline__ void mma_tile(float (&acc)[4], const float* a,
                                         int sam, int sak, const float* b,
                                         int sbk, int sbn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tl = lane & 3;
  const int r0 = g, r1 = LIVE == 2 ? g : g + 8;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = k0; kk < k0 + 16 && kk < K; kk += 8) {
      const int ka = kk + tl, kb = ka + 4;
      uint32_t ah[4], al[4], bh[2], bl[2];
      split((LIVE & 1) ? a[r0 * sam + ka * sak] : 0.f, ah[0], al[0]);
      split((LIVE & 2) ? a[r1 * sam + ka * sak] : 0.f, ah[1], al[1]);
      split((LIVE & 1) ? a[r0 * sam + kb * sak] : 0.f, ah[2], al[2]);
      split((LIVE & 2) ? a[r1 * sam + kb * sak] : 0.f, ah[3], al[3]);
      split(b[ka * sbk + g * sbn], bh[0], bl[0]);
      split(b[kb * sbk + g * sbn], bh[1], bl[1]);
      mma3(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += part[c];
  }
}

// NTL tiles of 16 x 8 sharing A: acc[q] += A B_q, B_q = b + q bstep (as
// mma_tile), the A fragments split once a k-step
template <int K, int NTL, int LIVE = 3>
__device__ __forceinline__ void mma_tiles(float (&acc)[NTL][4], const float* a,
                                          int sam, int sak, const float* b,
                                          int sbk, int sbn, int bstep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tl = lane & 3;
  const int r0 = g, r1 = LIVE == 2 ? g : g + 8;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    float part[NTL][4] = {};
#pragma unroll
    for (int kk = k0; kk < k0 + 16 && kk < K; kk += 8) {
      const int ka = kk + tl, kb = ka + 4;
      uint32_t ah[4], al[4];
      split((LIVE & 1) ? a[r0 * sam + ka * sak] : 0.f, ah[0], al[0]);
      split((LIVE & 2) ? a[r1 * sam + ka * sak] : 0.f, ah[1], al[1]);
      split((LIVE & 1) ? a[r0 * sam + kb * sak] : 0.f, ah[2], al[2]);
      split((LIVE & 2) ? a[r1 * sam + kb * sak] : 0.f, ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < NTL; ++q) {
        uint32_t bh[2], bl[2];
        split(b[q * bstep + ka * sbk + g * sbn], bh[0], bl[0]);
        split(b[q * bstep + kb * sbk + g * sbn], bh[1], bl[1]);
        mma3(part[q], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int q = 0; q < NTL; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][c] += part[q][c];
  }
}

// a tile's rows g and g + 8 into out (row-major, ld), from row m0, col n0
__device__ __forceinline__ void store_tile(const float (&acc)[4], float* out,
                                           int ld, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tl = lane & 3;
  out[(m0 + g) * ld + n0 + 2 * tl] = acc[0];
  out[(m0 + g) * ld + n0 + 2 * tl + 1] = acc[1];
  out[(m0 + g + 8) * ld + n0 + 2 * tl] = acc[2];
  out[(m0 + g + 8) * ld + n0 + 2 * tl + 1] = acc[3];
}

// A state update's band: rows m0 .. m0 + 15 of OP^T X over one chunk,
// A(m, t) = op[t ld + m0 + m], B(t, n) = x[t ld + n], one warp. The A
// fragments are split once (band_a) and serve every column tile
// (band_tile: tile j's 16 x 8 partial, two k-steps).
__device__ __forceinline__ void band_a(const float* op, int ld, int m0,
                                       uint32_t (&ah)[2][4],
                                       uint32_t (&al)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tl = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float* p = op + (8 * ks + tl) * ld + m0 + g;
    split(p[0], ah[ks][0], al[ks][0]);
    split(p[8], ah[ks][1], al[ks][1]);
    split(p[4 * ld], ah[ks][2], al[ks][2]);
    split(p[4 * ld + 8], ah[ks][3], al[ks][3]);
  }
}

__device__ __forceinline__ void band_tile(float (&part)[4],
                                          const uint32_t (&ah)[2][4],
                                          const uint32_t (&al)[2][4],
                                          const float* x, int ld, int j) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tl = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float* q = x + (8 * ks + tl) * ld + 8 * j + g;
    uint32_t bh[2], bl[2];
    split(q[0], bh[0], bl[0]);
    split(q[4 * ld], bh[1], bl[1]);
    mma3(part, ah[ks], al[ks], bh, bl);
  }
}

// ---------------------------------------------------------------------------
// 1. The walks
// ---------------------------------------------------------------------------

// DP / 16 warps, each a 16-row band of the (DP, DP) state in registers;
// rows of raw r / k, v / dy, w in a 3-stage ring, = 8 mod 32 (read along
// m and n by the state update)
template <int DP>
struct WalkPlan {
  static constexpr int kWarpsW = DP / 16;
  static constexpr int kThreadsW = 32 * kWarpsW;
  static constexpr int kStages = 3;             // the ring: two chunks ahead
  static constexpr int LD = DP + 8;
  static constexpr int kOp = kStages * 3 * kC * LD;   // Khat or Rin [kC][LD]
  static constexpr int kDec = kOp + kC * LD;
  static constexpr int kFloats = kDec + DP;
  static constexpr size_t kBytes = sizeof(float) * (size_t)kFloats;
};

// grid (B H, 2), block WalkPlan<DP>::kThreadsW, dynamic shared memory
// WalkPlan<DP>::kBytes
template <int DP>
__global__ void __launch_bounds__(WalkPlan<DP>::kThreadsW)
    rwkv6_bwd_walk_kernel(const float* __restrict__ r,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ w,
                          const float* __restrict__ dy,
                          const float* __restrict__ s0,
                          const float* __restrict__ ds_final,
                          float* __restrict__ ds0, float* __restrict__ ws_s,
                          float* __restrict__ ws_g, int S, int H, int D) {
  using P = WalkPlan<DP>;
  constexpr int LD = P::LD, NG = Grp<DP>::NG, NT = P::kThreadsW;
  constexpr int KT = DP / 8, DP4 = DP / 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* OP = sm + P::kOp;
  float* DEC = sm + P::kDec;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tl = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const bool back = blockIdx.y == 1;   // the G walk
  const long long step = (long long)H * D;
  const long long base = (long long)b * S * step + (long long)h * D;
  const int nchunks = (S + kC - 1) / kC, ngroups = (nchunks + NG - 1) / NG;
  const float* src_a = back ? r : k;
  const float* src_b = back ? dy : v;
  const float* init = back ? ds_final : s0;
  float* ws = (back ? ws_g : ws_s) + (long long)bh * ngroups * DP * DP;

  if (D < DP) {   // the padding columns of the ring stay 0
    for (int i = tid; i < P::kOp / 4; i += NT)
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

  // this warp's rows d0 + g (x = 0, 1) and d0 + g + 8 (x = 2, 3), columns
  // 8 j + 2 tl (+ 1)
  const int d0 = 16 * warp;
  float st[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = d0 + g + (x >= 2 ? 8 : 0), e = 8 * j + 2 * tl + (x & 1);
      st[j][x] = init != nullptr && d < D && e < D
                     ? init[((long long)bh * D + d) * D + e]
                     : 0.f;
    }

  auto xs = [&](int buf, int a) { return sm + (buf * 3 + a) * kC * LD; };
  auto load = [&](int c, int buf) {   // chunk c's rows: one commit group
    if (c >= 0 && c < nchunks) {
      for (int idx = tid; idx < 3 * kC * DP4; idx += NT) {
        const int a = idx / (kC * DP4), t = idx / DP4 % kC, q = idx % DP4;
        if (4 * q < D) {
          const int tt = c * kC + t;
          const float* src = a == 0 ? src_a : a == 1 ? src_b : w;
          cp_async16(xs(buf, a) + t * LD + 4 * q,
                     src + base + (long long)(tt < S ? tt : 0) * step + 4 * q,
                     tt < S);
        }
      }
    }
    cp_async_commit();
  };

  const int first = back ? nchunks - 1 : 0, dir = back ? -1 : 1;
  load(first, 0);
  load(first + dir, 1);
  for (int it = 0; it < nchunks; ++it) {
    const int c = first + dir * it, buf = it % P::kStages;
    // two chunks ahead: into the stage that chunk it - 1 left
    load(first + dir * (it + 2), (it + 2) % P::kStages);
    cp_async_wait<2>();
    __syncthreads();                          // chunk c's rows are in
    if (tid < DP) {
      // per channel, with w' = max(w, 1e-12) (1 past S): S walk the
      // suffix products Khat_t = k_t prod_{j>t} w'_j, G walk the prefix
      // products Rin_t = r_t prod_{j<t} w'_j; the chunk's decay prod w'
      const int d = tid;
      const float* A = xs(buf, 0);
      const float* W = xs(buf, 2);
      float p = 1.f;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const int t = back ? i : kC - 1 - i;
        const float wv =
            c * kC + t < S ? fmaxf(W[t * LD + d], kFloorW) : 1.f;
        OP[t * LD + d] = A[t * LD + d] * p;
        p *= wv;
      }
      DEC[d] = p;
    }
    // the checkpoint: S before a group's first chunk, G after its last
    const bool save = back ? c == min((c / NG + 1) * NG, nchunks) - 1
                           : c % NG == 0;
    if (save) {
      float* dst = ws + (long long)(c / NG) * DP * DP;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int e = 8 * j + 2 * tl;
        *reinterpret_cast<float2*>(dst + (d0 + g) * DP + e) =
            make_float2(st[j][0], st[j][1]);
        *reinterpret_cast<float2*>(dst + (d0 + g + 8) * DP + e) =
            make_float2(st[j][2], st[j][3]);
      }
    }
    __syncthreads();
    // the update: st <- diag(prod w') st + OP^T X_b (A(d, t) = OP[t][d],
    // B(t, e) = X_b[t][e])
    const float da = DEC[d0 + g], db = DEC[d0 + g + 8];
    uint32_t ah[2][4], al[2][4];
    band_a(OP, LD, d0, ah, al);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      band_tile(part, ah, al, xs(buf, 1), LD, j);
      st[j][0] = fmaf(da, st[j][0], part[0]);
      st[j][1] = fmaf(da, st[j][1], part[1]);
      st[j][2] = fmaf(db, st[j][2], part[2]);
      st[j][3] = fmaf(db, st[j][3], part[3]);
    }
    __syncthreads();   // OP, DEC and this buffer are free
  }
  if (back && ds0 != nullptr) {
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = d0 + g + (x >= 2 ? 8 : 0), e = 8 * j + 2 * tl + (x & 1);
        if (d < D && e < D) ds0[((long long)bh * D + d) * D + e] = st[j][x];
      }
  }
}

// ---------------------------------------------------------------------------
// 2. The chunks of a group
// ---------------------------------------------------------------------------

// Shared-memory plan, in floats. Rows read along k by the products are
// DP + 4 (= 4 mod 32) apart.
template <int DP>
struct ChunkPlan {
  static constexpr int NG = Grp<DP>::NG;
  static constexpr int LX = DP + 4;     // [kC][LX] rows of the inputs etc.
  static constexpr int LS = DP + 4;     // S_c and G_e rows
  static constexpr int LM = kC + 4;     // M and att rows
  static constexpr int kX = 0;          // [NG][5][kC][LX]: r, k, v, w, dy
  // [NG + 1][DP][LS]: S_c of chunk j in slot j; G_e of chunk j in slot
  // j + 1 (G_e of the last chunk loaded there, each earlier one written
  // into the slot its S_c leaves)
  static constexpr int kS = kX + NG * 5 * kC * LX;
  static constexpr int kRin = kS + (NG > 1 ? (NG + 1) * DP * LS : 0);
  static constexpr int kKhat = kRin + kC * LX;                  // [kC][LX]
  static constexpr int kO1 = kKhat + kC * LX;   // S_c dy_t, then G_e v_t
  static constexpr int kKq = kO1 + kC * LX;     // [kHalf][LX]: k_i A_i
  static constexpr int kRq = kKq + kHalf * LX;  // r_t B_t (t >= 8)
  static constexpr int kO4 = kRq + kHalf * LX;  // dr's quadrant, then dk's
  static constexpr int kM = kO4 + kHalf * LX;   // [NG][kC][LM]: M a chunk
  static constexpr int kAtt = kM + NG * kC * LM;   // [kC][LM]
  static constexpr int kDw = kAtt + kC * LM;    // [NG][kC][DP]: dw's part
  static constexpr int kZ = kDw + NG * kC * DP;     // rowsum(G_e o S_c)
  static constexpr int kDu = kZ + DP;           // du's part, second halves
  static constexpr int kDec = kDu + DP;
  static constexpr int kU = kDec + DP;
  static constexpr int kFloats = kU + DP;
  static constexpr size_t kBytes = sizeof(float) * (size_t)kFloats;
};

// grid (B H ngroups), block kThreads, dynamic shared memory
// ChunkPlan<DP>::kBytes
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    rwkv6_bwd_chunk_kernel(const float* __restrict__ r,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ w,
                           const float* __restrict__ u,
                           const float* __restrict__ dy,
                           float* __restrict__ dr, float* __restrict__ dk,
                           float* __restrict__ dv, float* __restrict__ dw,
                           const float* __restrict__ ws_s,
                           const float* __restrict__ ws_g,
                           float* __restrict__ ws_du, int S, int H, int D,
                           long long u_bstride) {
  using P = ChunkPlan<DP>;
  constexpr int NG = P::NG, LX = P::LX, LS = P::LS, LM = P::LM;
  constexpr int DP4 = DP / 4, NT = kThreads, KT = DP / 8;
  // a thread pair a channel, one half of the chunk each, in warps < W0;
  // the state updates and dv on the others (at D 128, kGroup 1, there are
  // none: no state is updated, and dv takes a stage of its own)
  constexpr int W0 = 2 * DP / 32;
  constexpr bool kDvBeside = W0 < kWarps;
  static_assert(kDvBeside || NG == 1, "the updates need warps of their own");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* RIN = sm + P::kRin;
  float* KHAT = sm + P::kKhat;
  float* O1 = sm + P::kO1;
  float* KQ = sm + P::kKq;
  float* RQ = sm + P::kRq;
  float* O4 = sm + P::kO4;
  float* ATT = sm + P::kAtt;
  float* ZS = sm + P::kZ;
  float* DEC = sm + P::kDec;
  float* U = sm + P::kU;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nchunks = (S + kC - 1) / kC, ngroups = (nchunks + NG - 1) / NG;
  const int bh = blockIdx.x / ngroups, gi = blockIdx.x % ngroups;
  const int b = bh / H, h = bh % H;
  const int c0 = gi * NG, nc = min(NG, nchunks - c0);
  const long long step = (long long)H * D;
  const long long base = (long long)b * S * step + (long long)h * D;
  const float* ck_s = ws_s + ((long long)bh * ngroups + gi) * DP * DP;
  const float* ck_g = ws_g + ((long long)bh * ngroups + gi) * DP * DP;

  if (D < DP) {   // the inputs' padding columns stay 0
    for (int i = tid; i < P::kS / 4; i += NT)
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  for (int d = tid; d < DP; d += NT)
    U[d] = d < D ? u[b * u_bstride + (long long)h * D + d] : 0.f;

  // array a (0 r, 1 k, 2 v, 3 w, 4 dy) of the group's chunk j
  auto X = [&](int j, int a) { return sm + P::kX + (j * 5 + a) * kC * LX; };
  // every row of the group by cp.async, a commit group a chunk (S and G
  // with the first)
  for (int j = 0; j < NG; ++j) {
    if (j < nc) {
      for (int idx = tid; idx < 5 * kC * DP4; idx += NT) {
        const int a = idx / (kC * DP4), t = idx / DP4 % kC, q = idx % DP4;
        if (4 * q < D) {
          const int tt = (c0 + j) * kC + t;
          const float* src = a == 0   ? r
                             : a == 1 ? k
                             : a == 2 ? v
                             : a == 3 ? w
                                      : dy;
          cp_async16(X(j, a) + t * LX + 4 * q,
                     src + base + (long long)(tt < S ? tt : 0) * step + 4 * q,
                     tt < S);
        }
      }
    }
    if (NG > 1 && j == 0) {
      for (int idx = tid; idx < 2 * DP * DP4; idx += NT) {
        const int m = idx / (DP * DP4), d = idx / DP4 % DP, q = idx % DP4;
        cp_async16(sm + P::kS + (m == 0 ? 0 : nc) * DP * LS + d * LS + 4 * q,
                   (m == 0 ? ck_s : ck_g) + d * DP + 4 * q, true);
      }
    }
    cp_async_commit();
  }

  // w' of chunk j's step t (1 past S)
  auto wprime = [&](int j, int t, int d) {
    return (c0 + j) * kC + t < S ? fmaxf(X(j, 3)[t * LX + d], kFloorW) : 1.f;
  };
  // per channel, on count threads from thread first: Rin and the chunk's
  // decay (kRinDec), r B for t >= 8 (kRq) from the prefix products; Khat
  // (kKhat) and k A for i < 8 (kKq) from the suffix products
  enum : int { kRinDec = 1, kRq = 2, kKhat = 4, kKq = 8 };
  auto prep = [&](int j, int what, int first, int count) {
    for (int job = tid - first; job >= 0 && job < 2 * DP; job += count) {
      const int d = job % DP;
      float p = 1.f, p8 = 1.f;
      if (job < DP && (what & (kRinDec | kRq))) {
        const float* R = X(j, 0);
#pragma unroll
        for (int t = 0; t < kC; ++t) {
          const float x = R[t * LX + d], wv = wprime(j, t, d);
          if (what & kRinDec) RIN[t * LX + d] = x * p;
          if (t >= kHalf && (what & kRq)) RQ[(t - kHalf) * LX + d] = x * p8;
          p *= wv;
          if (t >= kHalf) p8 *= wv;
        }
        if (what & kRinDec) DEC[d] = p;
      } else if (job >= DP && (what & (kKhat | kKq))) {
        const float* K = X(j, 1);
#pragma unroll
        for (int t = kC - 1; t >= 0; --t) {
          const float x = K[t * LX + d], wv = wprime(j, t, d);
          if (what & kKhat) KHAT[t * LX + d] = x * p;
          if (t < kHalf && (what & kKq)) KQ[t * LX + d] = x * p8;
          p *= wv;
          if (t < kHalf) p8 *= wv;
        }
      }
    }
  };
  // M = dY V^T of chunk j, 2 tiles on nw warps from warp w0
  auto m_tiles = [&](int j, int w0, int nw) {
    for (int tile = warp - w0; tile >= 0 && tile < 2; tile += nw) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tile<DP>(acc, X(j, 4), LX, 1, X(j, 2) + 8 * tile * LX, 1, LX);
      store_tile(acc, sm + P::kM + j * kC * LM, LM, 0, 8 * tile);
    }
  };
  // S_c and G_e of chunk j: in shared memory, or at kGroup 1 the workspace
  auto s_of = [&](int j) {
    return NG > 1 ? sm + P::kS + j * DP * LS : ck_s;
  };
  auto g_of = [&](int j) {
    return NG > 1 ? sm + P::kS + (j + 1) * DP * LS : ck_g;
  };
  const int lds = NG > 1 ? LS : DP;
  // a state update in shared memory, dst = diag(DEC) src + OP^T X over
  // the chunk, on NW warps from warp w0: each warp a 16-row band and TPW
  // of its column tiles, their products in flight together
  auto update = [&](auto nw_tag, float* dst, const float* src,
                    const float* op, const float* x, int w0) {
    constexpr int NW = decltype(nw_tag)::value, bands = DP / 16;
    constexpr int per = pow2_floor(NW / bands < KT ? NW / bands : KT);
    constexpr int TPW = KT / per;
    const int ww = warp - w0, g = lane / 4, tl = lane % 4;
    if (ww < 0 || ww >= bands * per) return;
    const int m0 = 16 * (ww / per), j0 = ww % per * TPW;
    uint32_t ah[2][4], al[2][4];
    band_a(op, LX, m0, ah, al);
    float part[TPW][4];
#pragma unroll
    for (int jj = 0; jj < TPW; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) part[jj][c] = 0.f;
      band_tile(part[jj], ah, al, x, LX, j0 + jj);
    }
#pragma unroll
    for (int jj = 0; jj < TPW; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = m0 + g + (c >= 2 ? 8 : 0);
        const int e = 8 * (j0 + jj) + 2 * tl + (c & 1);
        dst[d * LS + e] = fmaf(DEC[d], src[d * LS + e], part[jj][c]);
      }
  };
  using Beside = std::integral_constant<int, kWarps - W0>;

  // a thread pair a channel pd, steps s0 .. s0 + 7 each: the first halves
  // on threads 0 .. DP - 1, the second on DP .. 2 DP - 1, so that a warp's
  // row reads meet 32 banks once (each half computes the few sums it needs
  // of the other)
  const int hf = tid >= DP, pd = tid - hf * DP, s0 = kHalf * hf;
  const int s1 = kHalf - s0;   // the other half's first step

  // -------------------------------------------------------------------
  // Forward over the group: S_c, dr, dw's y and z terms, du's part
  // -------------------------------------------------------------------
  float du_acc = 0.f;
  // M and k A of the first chunk; each later chunk's come beside the
  // chunk before it
  cp_async_wait_upto(NG - 1);
  __syncthreads();   // chunk 0's rows (and S, G) are in
  prep(0, kKq, 0, NT);
  m_tiles(0, 0, kWarps);
  __syncthreads();
  for (int j = 0; j < nc; ++j) {
    cp_async_wait_upto(NG - 2 - j);   // chunk j + 1's rows, for its M
    prep(j, kKhat | kRinDec, 0, NT);
    const float* Sj = s_of(j);
    const float* Mj = sm + P::kM + j * kC * LM;
    const float* V = X(j, 2);
    const float* DY = X(j, 4);
    // S_c dy_t = dY S_c^T (DP / 8 tiles); dr's quadrant, rows t >= 8 of
    // M[., i < 8] (k A) (DP / 8 tiles)
    for (int tile = warp; tile < 2 * KT; tile += kWarps) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (tile < KT) {
        mma_tile<DP>(acc, DY, LX, 1, Sj + 8 * tile * lds, 1, lds);
        store_tile(acc, O1, LX, 0, 8 * tile);
      } else {
        const int n0 = 8 * (tile - KT), g = lane / 4, tl = lane % 4;
        mma_tile<kHalf, 2>(acc, Mj + kHalf * LM, LM, 1, KQ + n0, LX, 1);
        O4[g * LX + n0 + 2 * tl] = acc[2];
        O4[g * LX + n0 + 2 * tl + 1] = acc[3];
      }
    }
    __syncthreads();
    if (warp < W0) {
      // a thread pair a channel pd, steps s0 .. s0 + 7 each: dr; dw's y
      // and z terms (kept for the backward pass); du's part
      const int d = pd, t0 = (c0 + j) * kC;
      const float* R = X(j, 0);
      const float* K = X(j, 1);
      const float ud = U[d];
      float rv[kHalf], kv[kHalf], wv[kHalf], pl[kHalf], al[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        rv[i] = R[(s0 + i) * LX + d];
        kv[i] = K[(s0 + i) * LX + d];
        wv[i] = wprime(j, s0 + i, d);
      }
      float p = 1.f;   // the half's own prefix products
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        pl[i] = p;
        p *= wv[i];
      }
      float q = 1.f;   // its suffix products: A_t in the first half
#pragma unroll
      for (int i = kHalf - 1; i >= 0; --i) {
        al[i] = q;
        q *= wv[i];
      }
      float lead = 1.f;   // P_{<t} = lead pl: the first half's decay
      if (hf)
#pragma unroll
        for (int i = 0; i < kHalf; ++i) lead *= wprime(j, i, d);
      const float bsel = hf ? 1.f : 0.f;   // B_t = pl: the second half's
      float part[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int t = s0 + i;
        const float ct = Mj[t * LM + t];
        float acc = 0.f;   // sum_{s0<=i'<t} M_ti' k_i' P_(i',t), Horner
#pragma unroll
        for (int i2 = 0; i2 < i; ++i2)
          acc = fmaf(acc, wv[i2], Mj[t * LM + s0 + i2] * kv[i2]);
        float x = fmaf(lead * pl[i], O1[t * LX + d], acc);
        x = fmaf(bsel * pl[i], O4[i * LX + d], x);
        x = fmaf(ct * ud, kv[i], x);
        if (d < D && t0 + t < S) dr[base + (long long)(t0 + t) * step + d] = x;
        du_acc = fmaf(ct * rv[i], kv[i], du_acc);
      }
      // z inside the half: z_t(t') = sum_{s0<=i<t} P_(i,t) k_i M_t'i for
      // t' > t; sum_{t'>t} P_(t,t') r_t' z_t(t') by Horner from the top
      float z[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) z[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int i2 = kHalf - 1; i2 > i; --i2)
          acc = fmaf(acc, wv[i2], rv[i2] * z[i2]);
        part[i] = acc;
#pragma unroll
        for (int i2 = i + 1; i2 < kHalf; ++i2)
          z[i2] = fmaf(wv[i], z[i2], kv[i] * Mj[(s0 + i2) * LM + s0 + i]);
      }
      // across the midpoint, t >= 8: B_t sum_{t'>t} P_(t,t') r_t' (M (k
      // A))_t' (the second half only); and y, y_{t-1} = w'_t y_t + r_t (S_c
      // dy_t), the second half's handed down to the first
      float eta = 0.f, y = 0.f, yl[kHalf];
#pragma unroll
      for (int i = kHalf - 1; i >= 0; --i) {
        const int t = s0 + i;
        part[i] = fmaf(bsel * pl[i], eta, part[i]);
        eta = fmaf(wv[i], eta, rv[i] * O4[i * LX + d]);
        yl[i] = y;
        y = fmaf(wv[i], y, rv[i] * O1[t * LX + d]);
      }
      float y7 = 0.f;   // the first half's: y_7 from the second half
      if (!hf)
#pragma unroll
        for (int t = kC - 1; t >= kHalf; --t)
          y7 = fmaf(wprime(j, t, d), y7, R[t * LX + d] * O1[t * LX + d]);
      float* dwp = sm + P::kDw + j * kC * DP;
#pragma unroll
      for (int i = 0; i < kHalf; ++i)
        dwp[(s0 + i) * DP + d] =
            fmaf(lead * pl[i], fmaf(al[i], y7, yl[i]), part[i]);
    } else if (j + 1 < nc) {
      // beside them, S of chunk j + 1: diag(prod w') S_c + Khat^T V; and
      // M and k A of chunk j + 1
      if (NG > 1)
        update(Beside{}, sm + P::kS + (j + 1) * DP * LS, Sj, KHAT, V, W0);
      m_tiles(j + 1, W0, kWarps - W0);
      prep(j + 1, kKq, 32 * W0, NT - 32 * W0);
    }
    __syncthreads();
  }
  // du's part: the pair's halves summed
  if (warp < W0 && hf) sm[P::kDu + pd] = du_acc;

  // -------------------------------------------------------------------
  // Backward over the group: G_e, dv, dk, dw's other terms
  // -------------------------------------------------------------------
  // the first chunk's r B (its Khat and k A are still there)
  prep(nc - 1, kRq, 0, NT);
  __syncthreads();
  if (warp < W0 && !hf && pd < D)
    ws_du[((long long)bh * ngroups + gi) * DP + pd] = du_acc + sm[P::kDu + pd];
  for (int j = nc - 1; j >= 0; --j) {
    prep(j, kRinDec, 0, NT);   // for G_e of chunk j - 1
    const float* Sj = s_of(j);
    const float* G = g_of(j);
    const float* Mj = sm + P::kM + j * kC * LM;
    const float* R = X(j, 0);
    const float* K = X(j, 1);
    const float* V = X(j, 2);
    const float* DY = X(j, 4);
    {
      // att within each half, pairwise: thread (t2, l) over channels l +
      // 16 m; att_t2i = sum_d r_t2d k_id prod_{i<j<t2} w'_jd, and the
      // bonus r_t2 . (u k_t2) on the diagonal; the 16 lanes of a row
      // summed by shuffles
      constexpr int CPL = DP / 16;
      const int t2 = tid / 16, l = tid % 16, hs = t2 / kHalf * kHalf;
      float q[CPL], acc[kHalf], bonus = 0.f;
#pragma unroll
      for (int m = 0; m < CPL; ++m) {
        const int d = l + 16 * m;
        q[m] = R[t2 * LX + d];
        bonus = fmaf(q[m] * U[d], K[t2 * LX + d], bonus);
      }
#pragma unroll
      for (int ii = kHalf - 1; ii >= 0; --ii) {
        acc[ii] = 0.f;
        const int i = hs + ii;
        if (i < t2) {
#pragma unroll
          for (int m = 0; m < CPL; ++m) {
            const int d = l + 16 * m;
            acc[ii] = fmaf(q[m], K[i * LX + d], acc[ii]);
            q[m] *= wprime(j, i, d);
          }
        }
      }
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1) {
        bonus += __shfl_xor_sync(0xffffffffu, bonus, o);
#pragma unroll
        for (int ii = 0; ii < kHalf; ++ii)
          acc[ii] += __shfl_xor_sync(0xffffffffu, acc[ii], o);
      }
      // lane l writes column l of row t2, past the quadrant's columns
      if (l >= hs) {
        float val = 0.f;
#pragma unroll
        for (int ii = 0; ii < kHalf; ++ii)
          if (hs + ii == l && l < t2) val = acc[ii];
        if (l == t2) val = bonus;
        ATT[t2 * LM + l] = val;
      }
    }
    {
      // rowsum(G_e o S_c): NT / DP threads a row, columns strided, summed
      // by shuffles
      constexpr int TPR = NT / DP;
      const int row = tid / TPR, c = tid % TPR;
      float zs = 0.f;
      for (int e = c; e < DP; e += TPR)
        zs = fmaf(G[row * lds + e], Sj[row * lds + e], zs);
#pragma unroll
      for (int o = TPR / 2; o >= 1; o >>= 1)
        zs += __shfl_xor_sync(0xffffffffu, zs, o);
      if (c == 0) ZS[row] = zs;
    }
    // G_e v_t = V G_e^T -> O1, TPW tiles a warp sharing their A fragments
    // from warp 0; dk's quadrant, rows t < 8 of M[t' >= 8, .]^T (r B),
    // likewise from warp 4 (round the warps); att's quadrant (r B)(k A)^T
    // (1 tile) on the last warp
    {
      constexpr int TPW = KT >= 8 ? 2 : 1;
      const int g = lane / 4, tl = lane % 4;
      const int j0 = warp * TPW, jq = (warp + 4) % kWarps * TPW;
      float acc[TPW][4] = {};
      if (j0 < KT) {
        mma_tiles<DP, TPW>(acc, V, LX, 1, G + 8 * j0 * lds, 1, lds, 8 * lds);
#pragma unroll
        for (int q = 0; q < TPW; ++q)
          store_tile(acc[q], O1, LX, 0, 8 * (j0 + q));
      }
      if (jq < KT) {
        float dq[TPW][4] = {};
        mma_tiles<kHalf, TPW, 1>(dq, Mj + kHalf * LM, 1, LM, RQ + 8 * jq, LX,
                                 1, 8);
#pragma unroll
        for (int q = 0; q < TPW; ++q) {
          O4[g * LX + 8 * (jq + q) + 2 * tl] = dq[q][0];
          O4[g * LX + 8 * (jq + q) + 2 * tl + 1] = dq[q][1];
        }
      }
      if (warp == kWarps - 1) {
        float aq[1][4] = {};
        mma_tiles<DP, 1, 2>(aq, RQ, LX, 1, KQ, 1, LX, 0);
        ATT[(kHalf + g) * LM + 2 * tl] = aq[0][2];
        ATT[(kHalf + g) * LM + 2 * tl + 1] = aq[0][3];
      }
    }
    __syncthreads();
    const int t0 = (c0 + j) * kC;
    // dv = Khat G_e + att^T dY, a tile of 16 steps x 8 value channels
    auto dv_tiles = [&](int w0, int nw) {
      const int g = lane / 4, tl = lane % 4;
      for (int tile = warp - w0; tile >= 0 && tile < KT; tile += nw) {
        const int n0 = 8 * tile;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tile<DP>(acc, KHAT, LX, 1, G + n0, lds, 1);
        mma_tile<kC>(acc, ATT, 1, LM, DY + n0, LX, 1);
        const int e = n0 + 2 * tl;
        if (e < D) {
          if (t0 + g < S)
            *reinterpret_cast<float2*>(dv + base + (long long)(t0 + g) * step
                                       + e) = make_float2(acc[0], acc[1]);
          if (t0 + g + 8 < S)
            *reinterpret_cast<float2*>(dv + base +
                                       (long long)(t0 + g + 8) * step + e) =
                make_float2(acc[2], acc[3]);
        }
      }
    };
    if (warp < W0) {
      // a thread pair a channel pd, steps s0 .. s0 + 7 each: dk, and dw =
      // its forward terms + P_{<t} P_{>t} rowsum(G_e o S_c) + P_{>t} x_t
      // (+ A_t sum_{i<t} P_(i,t) k_i (M^T (r B))_i, t < 8)
      const int d = pd;
      const float ud = U[d], zs = ZS[d];
      float rv[kHalf], kv[kHalf], wv[kHalf], pl[kHalf], al[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        rv[i] = R[(s0 + i) * LX + d];
        kv[i] = K[(s0 + i) * LX + d];
        wv[i] = wprime(j, s0 + i, d);
      }
      float p = 1.f, q = 1.f;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        pl[i] = p;
        p *= wv[i];
      }
#pragma unroll
      for (int i = kHalf - 1; i >= 0; --i) {
        al[i] = q;
        q *= wv[i];
      }
      float other = 1.f;   // the other half's decay
#pragma unroll
      for (int i = 0; i < kHalf; ++i) other *= wprime(j, s1 + i, d);
      const float lead = hf ? other : 1.f;    // P_{<t} = lead pl
      const float tail = hf ? 1.f : other;    // P_{>t} = al tail
      const float asel = hf ? 0.f : 1.f;      // A_t = al: the first half's
      // x inside the half, the first half's handed up to the second
      float x = 0.f, xl[kHalf], xi = 0.f, cross[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int t = s0 + i;
        xl[i] = x;
        x = fmaf(wv[i], x, kv[i] * O1[t * LX + d]);
        cross[i] = asel * al[i] * xi;
        xi = fmaf(wv[i], xi, kv[i] * O4[i * LX + d]);
      }
      float x8 = 0.f;   // the second half's: x_8 from the first half
      if (hf)
#pragma unroll
        for (int t = 0; t < kHalf; ++t)
          x8 = fmaf(wprime(j, t, d), x8, K[t * LX + d] * O1[t * LX + d]);
      const float* dwp = sm + P::kDw + j * kC * DP;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int t = s0 + i;
        const float ct = Mj[t * LM + t];
        float acc = 0.f;   // sum_{t<t'<s0+8} M_t't r_t' P_(t,t'), Horner
#pragma unroll
        for (int i2 = kHalf - 1; i2 > i; --i2)
          acc = fmaf(acc, wv[i2], Mj[(s0 + i2) * LM + t] * rv[i2]);
        const float pout = al[i] * tail, gv = O1[t * LX + d];
        float dkx = fmaf(pout, gv, acc);
        dkx = fmaf(asel * al[i], O4[i * LX + d], dkx);
        dkx = fmaf(ct * ud, rv[i], dkx);
        const float xt = fmaf(pl[i], x8, xl[i]);
        const float t12 = fmaf(lead * pl[i] * pout, zs, pout * xt);
        if (d < D && t0 + t < S) {
          const long long at = base + (long long)(t0 + t) * step + d;
          dk[at] = dkx;
          const float wraw = X(j, 3)[t * LX + d];
          dw[at] = wraw >= kFloorW ? dwp[t * DP + d] + t12 + cross[i] : 0.f;
        }
      }
    } else if (kDvBeside) {
      dv_tiles(W0, kWarps - W0);
    }
    if (!kDvBeside) {
      __syncthreads();
      dv_tiles(0, kWarps);
    }
    if (j > 0) {
      __syncthreads();
      // G_e of chunk j - 1, diag(prod w') G_e + Rin^T dY, into the slot
      // S_c of chunk j leaves; and Khat, k A, r B of chunk j - 1
      if (NG > 1)
        update(std::integral_constant<int, kWarps>{},
               sm + P::kS + j * DP * LS, G, RIN, DY, 0);
      prep(j - 1, kKhat | kKq | kRq, 0, NT);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 3. du: the groups' parts, in order
// ---------------------------------------------------------------------------

// grid (B H), block DP
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ ws_du,
                                    float* __restrict__ du, int ngroups,
                                    int D, int DP) {
  const int bh = blockIdx.x, d = threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int gi = 0; gi < ngroups; ++gi)
    s += ws_du[((long long)bh * ngroups + gi) * DP + d];
  du[(long long)bh * D + d] = s;
}

template <int DP>
long long groups(int S) {
  const int nchunks = (S + kC - 1) / kC;
  return (nchunks + Grp<DP>::NG - 1) / Grp<DP>::NG;
}

// The workspace's bytes: per (b, h) and group, S and G (DP, DP) fp32 and
// du's part (DP) fp32
template <int DP>
long long workspace_bytes(int B, int S, int H) {
  return 4LL * B * H * groups<DP>(S) * DP * (2LL * DP + 1);
}

template <int DP>
int launch(const float* const* in, float* const* out, int B, int S, int H,
           int D, long long u_bstride, long long ws_bytes,
           cudaStream_t stream) {
  if (ws_bytes < workspace_bytes<DP>(B, S, H))
    return (int)cudaErrorInvalidValue;
  constexpr size_t walk_smem = WalkPlan<DP>::kBytes;
  constexpr size_t chunk_smem = ChunkPlan<DP>::kBytes;
  static bool ready = false;   // the opt-in above 48 KB, once per kernel
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_bwd_walk_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)walk_smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(rwkv6_bwd_chunk_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)chunk_smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const long long ng = groups<DP>(S);
  float* ws_s = out[6];
  float* ws_g = ws_s + (long long)B * H * ng * DP * DP;
  float* ws_du = ws_g + (long long)B * H * ng * DP * DP;
  // in: r, k, v, w, u, s0, dy, ds_final; out: dr, dk, dv, dw, du, ds0, ws
  rwkv6_bwd_walk_kernel<DP>
      <<<dim3((unsigned)(B * H), 2), WalkPlan<DP>::kThreadsW, walk_smem,
         stream>>>(in[0], in[1], in[2], in[3], in[6], in[5], in[7], out[5],
                   ws_s, ws_g, S, H, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rwkv6_bwd_chunk_kernel<DP>
      <<<(unsigned)(B * H * ng), kThreads, chunk_smem, stream>>>(
          in[0], in[1], in[2], in[3], in[4], in[6], out[0], out[1], out[2],
          out[3], ws_s, ws_g, ws_du, S, H, D, u_bstride);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rwkv6_bwd_du_kernel<<<(unsigned)(B * H), DP, 0, stream>>>(
      ws_du, out[4], (int)ng, D, DP);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, w, dy, dr, dk, dv, dw: contiguous (B, S, H, D) fp32 device
// buffers, 16-byte aligned; u (H, D) with u_bstride 0, or (B, H, D) with
// u_bstride H * D; s0, ds_final, ds0 (B, H, D, D) fp32 or null (ds0 written
// only when given); du (B, H, D); ws: ws_bytes >= 4 B H G DP (2 DP + 1)
// bytes (DP = D rounded up to 16, 32, 64 or 128; G = ceil(ceil(S / 16) /
// kGroup) groups, kGroup 4 up to DP 64 and 1 at 128), 16-byte aligned.
// D % 8 == 0 and 8 <= D <= 128, S >= 1. The Python wrapper checks shapes,
// types and devices first.
int rwkv6_scan_bwd_f32(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0,
                       const void* dy, const void* ds_final, void* dr,
                       void* dk, void* dv, void* dw, void* du, void* ds0,
                       void* ws, int B, int S, int H, int D,
                       long long u_bstride, long long ws_bytes,
                       void* stream) {
  if (D % 8 != 0 || D < 8 || D > 128 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const float* in[8] = {static_cast<const float*>(r),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(w),
                        static_cast<const float*>(u),
                        static_cast<const float*>(s0),
                        static_cast<const float*>(dy),
                        static_cast<const float*>(ds_final)};
  float* out[7] = {static_cast<float*>(dr), static_cast<float*>(dk),
                   static_cast<float*>(dv), static_cast<float*>(dw),
                   static_cast<float*>(du), static_cast<float*>(ds0),
                   static_cast<float*>(ws)};
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 16) return launch<16>(in, out, B, S, H, D, u_bstride, ws_bytes, st);
  if (D <= 32) return launch<32>(in, out, B, S, H, D, u_bstride, ws_bytes, st);
  if (D <= 64) return launch<64>(in, out, B, S, H, D, u_bstride, ws_bytes, st);
  return launch<128>(in, out, B, S, H, D, u_bstride, ws_bytes, st);
}

}  // extern "C"
