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
//   dr_t = S_{t-1} dy_t + (dy_t . v_t) u k_t
//   dk_t = G_t v_t + (dy_t . v_t) u r_t
//   dv_t = G_t^T k_t + (r_t . u k_t) dy_t
//   dw_t = sum_e G_t[., e] S_{t-1}[., e]   (0 where w < 1e-12)
//   du   = sum_t (dy_t . v_t) r_t k_t      (per batch row)
//   ds0  = G_{-1}
//
// r, k, v, w, dy and dr, dk, dv, dw (B, S, H, D) fp32 contiguous, 16-byte
// aligned; u (H, D) shared (u_bstride 0) or per batch row (u_bstride H D);
// s0, ds_final, ds0 (B, H, D, D) or null; du (B, H, D).
//
// dw is the product of G_t and S_{t-1} itself, as in the plain version.
// The gated-linear-attention identity (what jax.grad of the chunked scan
// computes) forms d log w as a sum of terms of the size of G S and then
// divides by w: in fp32 that loses eps / w of the result, all of it at the
// decays the model draws (w down to the 1e-12 floor). The product divides
// by nothing. Neither does anything else here: S_{t-1} is never recovered
// from S_t.
//
// What bounds it on an H100: bytes. At rwkv6-7b's training shape on 3
// nodes (B = 12, S = 512, H = 64, D = 64) r, k, v, w, dy in and dr, dk,
// dv, dw out are 9 x 100.7 MB, 0.271 ms at 3.35 TB/s, against twice the
// forward's 4 D^2 flops a step, 1.29e10 flops, 0.192 ms at 67 TFLOP/s
// fp32. This first kernel does ~2.5x those flops (it rebuilds S_{t-1}
// from a checkpoint) and walks 3 S dependent steps.
//
// The design, simple first: exact sequential recurrences on the CUDA
// cores, three walks over time for each (b, h) in two CTAs (grid (B H, 2)),
// each thread holding kEpt entries of one row of a (D, D) matrix in
// registers, the kEpt-wide partial dot products summed over the kL lanes of
// the row by shuffles. The time steps come through shared memory kCk at a
// time (r, k, v, w and dy rows of the chunk, coalesced float4 loads).
//   CTA (bh, 0), walk 1, forward: S, row d; dr, du; S before each chunk of
//     kCk steps saved to a workspace (the checkpoints).
//   CTA (bh, 0), walk 2, backward: G, row d; dk; dw, with S_{t-1} rebuilt
//     in registers from the chunk's checkpoint (t mod kCk steps); ds0.
//   CTA (bh, 1), backward: G^T, row e; dv.
// The launch goes on the caller's stream and the entry returns
// cudaGetLastError(); the wrapper allocates every output and the
// workspace.
#include <cuda_runtime.h>

namespace {

constexpr int kCk = 8;            // steps a chunk: staging and checkpoints
constexpr float kFloorW = 1e-12f;

// DP: D rounded up to 16, 32, 64 or 128 (padding rows and columns stay 0);
// kEpt entries of a row a thread, kL threads a row
template <int DP>
struct Cfg {
  static constexpr int kEpt = DP <= 64 ? 16 : 32;
  static constexpr int kL = DP / kEpt;
  static constexpr int kThreads = DP * kL;
};

template <int L>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the chunk's rows of r, k, v, w, dy (steps t0 .. t0 + kCk - 1, channels
// 0 .. DP - 1; zero past S and D, w = 1 there)
template <int DP>
struct Stage {
  float r[kCk][DP], k[kCk][DP], v[kCk][DP], w[kCk][DP], dy[kCk][DP];
};

template <int DP>
__device__ __forceinline__ void stage_chunk(Stage<DP>& sm, const float* r,
                                            const float* k, const float* v,
                                            const float* w, const float* dy,
                                            long long row0, long long step,
                                            int t0, int S, int D) {
  constexpr int Q = DP / 4;
  for (int idx = threadIdx.x; idx < kCk * Q; idx += Cfg<DP>::kThreads) {
    const int i = idx / Q, d = 4 * (idx % Q);
    const bool in = t0 + i < S && d < D;
    const long long at = row0 + (long long)(t0 + i) * step + d;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
    *reinterpret_cast<float4*>(&sm.r[i][d]) =
        in ? __ldg(reinterpret_cast<const float4*>(r + at)) : z;
    *reinterpret_cast<float4*>(&sm.k[i][d]) =
        in ? __ldg(reinterpret_cast<const float4*>(k + at)) : z;
    *reinterpret_cast<float4*>(&sm.v[i][d]) =
        in ? __ldg(reinterpret_cast<const float4*>(v + at)) : z;
    *reinterpret_cast<float4*>(&sm.w[i][d]) =
        in ? __ldg(reinterpret_cast<const float4*>(w + at)) : one;
    *reinterpret_cast<float4*>(&sm.dy[i][d]) =
        in ? __ldg(reinterpret_cast<const float4*>(dy + at)) : z;
  }
}

// grid (B * H, 2), block Cfg<DP>::kThreads
template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads)
    rwkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s0,
                     const float* __restrict__ dy,
                     const float* __restrict__ ds_final,
                     float* __restrict__ dr, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dw,
                     float* __restrict__ du, float* __restrict__ ds0,
                     float* __restrict__ ckpt, int S, int H, int D,
                     long long u_bstride) {
  using C = Cfg<DP>;
  constexpr int E = C::kEpt, L = C::kL;
  __shared__ __align__(16) Stage<DP> sm;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row = threadIdx.x / L, lane = threadIdx.x % L, c0 = lane * E;
  const bool live = row < D;
  const long long step = (long long)H * D;
  const long long row0 = (long long)b * S * step + (long long)h * D;
  const int nck = (S + kCk - 1) / kCk;
  const float* ub = u + b * u_bstride + (long long)h * D;
  const long long mat = (long long)bh * D * D;   // (b, h)'s (D, D) matrix

  if (blockIdx.y == 1) {
    // ------------------------------------------------------------------
    // G^T backwards: this thread holds G[c0 .. c0 + E - 1][row], row = e;
    // dv_t[e] = sum_d G_t[d][e] k_t[d] + (r_t . u k_t) dy_t[e]
    // ------------------------------------------------------------------
    float g[E], uk[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int d = c0 + j;
      g[j] = ds_final != nullptr && live && d < D
                 ? ds_final[mat + (long long)d * D + row]
                 : 0.f;
      uk[j] = d < D ? ub[d] : 0.f;
    }
    for (int n = nck - 1; n >= 0; --n) {
      __syncthreads();
      stage_chunk<DP>(sm, r, k, v, w, dy, row0, step, n * kCk, S, D);
      __syncthreads();
      for (int i = min(kCk, S - n * kCk) - 1; i >= 0; --i) {
        float pdv = 0.f, pb = 0.f;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float kd = sm.k[i][c0 + j];
          pdv = fmaf(g[j], kd, pdv);
          pb = fmaf(sm.r[i][c0 + j] * uk[j], kd, pb);
        }
        pdv = row_sum<L>(pdv);
        pb = row_sum<L>(pb);
        const float dye = sm.dy[i][row];
        if (lane == 0 && live)
          dv[row0 + (long long)(n * kCk + i) * step + row] =
              fmaf(pb, dye, pdv);
#pragma unroll
        for (int j = 0; j < E; ++j)
          g[j] = fmaf(fmaxf(sm.w[i][c0 + j], kFloorW), g[j],
                      sm.r[i][c0 + j] * dye);
      }
    }
    return;
  }

  // --------------------------------------------------------------------
  // Walk 1, forward: this thread holds S[row][c0 .. c0 + E - 1], row = d
  // --------------------------------------------------------------------
  const float ud = live ? ub[row] : 0.f;
  float st[E];
#pragma unroll
  for (int j = 0; j < E; ++j)
    st[j] = s0 != nullptr && live && c0 + j < D
                ? s0[mat + (long long)row * D + c0 + j]
                : 0.f;
  float du_acc = 0.f;
  float* ck_row = ckpt + ((long long)bh * nck * DP + row) * DP + c0;
  for (int n = 0; n < nck; ++n) {
    __syncthreads();
    stage_chunk<DP>(sm, r, k, v, w, dy, row0, step, n * kCk, S, D);
#pragma unroll
    for (int j = 0; j < E; j += 4)   // S before the chunk
      *reinterpret_cast<float4*>(ck_row + (long long)n * DP * DP + j) =
          make_float4(st[j], st[j + 1], st[j + 2], st[j + 3]);
    __syncthreads();
    const int steps = min(kCk, S - n * kCk);
    for (int i = 0; i < steps; ++i) {
      float pc = 0.f, pdr = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float gy = sm.dy[i][c0 + j];
        pc = fmaf(sm.v[i][c0 + j], gy, pc);
        pdr = fmaf(st[j], gy, pdr);
      }
      pc = row_sum<L>(pc);
      pdr = row_sum<L>(pdr);
      const float kd = sm.k[i][row], wd = fmaxf(sm.w[i][row], kFloorW);
      if (lane == 0 && live)
        dr[row0 + (long long)(n * kCk + i) * step + row] =
            fmaf(ud * kd, pc, pdr);
      du_acc = fmaf(sm.r[i][row] * kd, pc, du_acc);
#pragma unroll
      for (int j = 0; j < E; ++j)
        st[j] = fmaf(wd, st[j], kd * sm.v[i][c0 + j]);
    }
  }
  if (lane == 0 && live) du[(long long)bh * D + row] = du_acc;

  // --------------------------------------------------------------------
  // Walk 2, backward: G[row][c0 ..], S_{t-1} rebuilt from the checkpoint
  // --------------------------------------------------------------------
  float g[E];
#pragma unroll
  for (int j = 0; j < E; ++j)
    g[j] = ds_final != nullptr && live && c0 + j < D
               ? ds_final[mat + (long long)row * D + c0 + j]
               : 0.f;
  for (int n = nck - 1; n >= 0; --n) {
    __syncthreads();
    stage_chunk<DP>(sm, r, k, v, w, dy, row0, step, n * kCk, S, D);
    float ck[E];
#pragma unroll
    for (int j = 0; j < E; j += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(ck_row + (long long)n * DP * DP + j);
      ck[j] = x.x, ck[j + 1] = x.y, ck[j + 2] = x.z, ck[j + 3] = x.w;
    }
    __syncthreads();
    for (int i = min(kCk, S - n * kCk) - 1; i >= 0; --i) {
      float sp[E];   // S_{t-1}: the checkpoint advanced i steps
#pragma unroll
      for (int j = 0; j < E; ++j) sp[j] = ck[j];
      for (int m = 0; m < i; ++m) {
        const float km = sm.k[m][row], wm = fmaxf(sm.w[m][row], kFloorW);
#pragma unroll
        for (int j = 0; j < E; ++j)
          sp[j] = fmaf(wm, sp[j], km * sm.v[m][c0 + j]);
      }
      float pdk = 0.f, pdw = 0.f, pc = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float ve = sm.v[i][c0 + j];
        pdk = fmaf(g[j], ve, pdk);
        pdw = fmaf(g[j], sp[j], pdw);
        pc = fmaf(ve, sm.dy[i][c0 + j], pc);
      }
      pdk = row_sum<L>(pdk);
      pdw = row_sum<L>(pdw);
      pc = row_sum<L>(pc);
      const float rd = sm.r[i][row], wraw = sm.w[i][row];
      if (lane == 0 && live) {
        const long long at = row0 + (long long)(n * kCk + i) * step + row;
        dk[at] = fmaf(ud * rd, pc, pdk);
        dw[at] = wraw >= kFloorW ? pdw : 0.f;
      }
      const float wd = fmaxf(wraw, kFloorW);
#pragma unroll
      for (int j = 0; j < E; ++j)
        g[j] = fmaf(wd, g[j], rd * sm.dy[i][c0 + j]);
    }
  }
  if (ds0 != nullptr && live) {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (c0 + j < D) ds0[mat + (long long)row * D + c0 + j] = g[j];
  }
}

template <int DP>
int launch(const float* const* in, float* const* out, int B, int S, int H,
           int D, long long u_bstride, cudaStream_t stream) {
  rwkv6_bwd_kernel<DP>
      <<<dim3((unsigned)(B * H), 2), Cfg<DP>::kThreads, 0, stream>>>(
          in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0],
          out[1], out[2], out[3], out[4], out[5], out[6], S, H, D,
          u_bstride);
  return (int)cudaGetLastError();
}

// The checkpoint workspace's bytes: B H ceil(S / kCk) (DP, DP) fp32
// states, DP = D rounded up to 16, 32, 64 or 128.
long long workspace_bytes(int B, int S, int H, int D) {
  const long long dp = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
  return 4LL * B * H * ((S + kCk - 1) / kCk) * dp * dp;
}

}  // namespace

extern "C" {

// r, k, v, w, dy, dr, dk, dv, dw: contiguous (B, S, H, D) fp32 device
// buffers, 16-byte aligned; u (H, D) with u_bstride 0, or (B, H, D) with
// u_bstride H * D; s0, ds_final, ds0 (B, H, D, D) fp32 or null (ds0 written
// only when given); du (B, H, D); ws: ws_bytes >= workspace_bytes(B, S, H,
// D), 16-byte aligned. D % 8 == 0 and 8 <= D <= 128, S >= 1. The Python
// wrapper checks shapes, types and devices first.
int rwkv6_scan_bwd_f32(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0,
                       const void* dy, const void* ds_final, void* dr,
                       void* dk, void* dv, void* dw, void* du, void* ds0,
                       void* ws, int B, int S, int H, int D,
                       long long u_bstride, long long ws_bytes,
                       void* stream) {
  if (D % 8 != 0 || D < 8 || D > 128 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (ws == nullptr || ws_bytes < workspace_bytes(B, S, H, D))
    return (int)cudaErrorInvalidValue;
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
  if (D <= 16) return launch<16>(in, out, B, S, H, D, u_bstride, st);
  if (D <= 32) return launch<32>(in, out, B, S, H, D, u_bstride, st);
  if (D <= 64) return launch<64>(in, out, B, S, H, D, u_bstride, st);
  return launch<128>(in, out, B, S, H, D, u_bstride, st);
}

}  // extern "C"
