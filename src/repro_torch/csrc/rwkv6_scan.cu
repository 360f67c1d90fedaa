// RWKV-6 WKV recurrence for Hopper (sm_90a): the time-mix scan of the
// port's `rwkv` layers in prefill (and in teacher-forced `apply`).
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
//   (the TPU wrapper's transposes to (B*H, S, D) are not carried over: at
//   the served shape each would move 268 MB); u (H, D); s0, s_out
//   (B, H, D, D) fp32, s0 may be null. The exact sequential recurrence in
//   fp32, in the order of ref.rwkv6_ref: no log or exp is formed, so the
//   chunked form's 1e-12 clamp of log w does not arise, and a ragged S
//   needs no padding (the kernel walks exactly S steps).
//
// What bounds it on an H100: bytes. At the served prefill (B = 4,
// S = 4096, H = 64, D = 64) r, k, v, w and y are 268.4 MB each, s0 and
// s_out 4.2 MB each: 1.3506 GB, 0.403 ms at 3.35 TB/s, against 4 D^2
// flops per (b, h, t) = 1.72e10, 0.256 ms at 67 TFLOP/s fp32.
//
// What the design does about it: a state column e evolves on its own,
// given r_t, k_t, w_t (shared by all columns) and v_t[e]. One block per
// (b, h) holds the whole state in registers. Each thread owns CE columns
// (2 where D % 16 == 0 and D > 32, else 1) and the rows d of the float4
// chunks q = 4 j + p (p the thread's quarter, j < NJ): kSplit = 4
// threads share a column group, 4 D / CE threads in all. One step is NJ
// float4 reads of each of r, k, w from shared memory (the 4 quarters read
// 4 neighbouring chunks: no bank conflict), each reused for the CE
// columns, 4 fused multiply-adds per state element, and a 2-step
// xor-shuffle that sums a column's four partial dots into y_t[e]. The
// shared-memory reads of r, k and w, repeated by every column group,
// bind the step before the FMAs do (3 D^2 floats per step and block with
// one column per thread), so a thread takes two columns where the warp
// stays whole. kT time steps of r, k, v, w are staged in shared memory at
// a time, loaded as float4 rows (D contiguous floats per (b, t, h)); the
// next span's loads are issued into registers before the current span is
// computed, so they are in flight during it. y is staged too and written
// back as float4 rows. At the served shape that is 256 blocks of 128
// threads, 32 state registers each. The chunked tensor-core form (the TPU
// kernel's c x c and c x D products on wgmma, TMA loads) is later work.
// Nothing is allocated here: the Python wrapper allocates y and s_out;
// the launch goes on the caller's stream and the entry returns
// cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kSplit = 4;   // threads per column group
constexpr int kMaxD = 128;  // NJ = 8 chunks of 4 rows per thread

__device__ __forceinline__ float get(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// grid (B * H), block 4 D / CE threads, dynamic shared memory
// (4 kT D + kT D) floats: r, k, w, v spans, then the y span.
template <int NJ, int CE, int kT>
__global__ void __launch_bounds__(64 * NJ / CE)
    rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ s_out, int S,
                      int H, int D) {
  extern __shared__ float4 smem[];
  const int D4 = D / 4;               // float4 chunks per row
  float4* sr = smem;                  // [kT][D4]
  float4* sk = sr + kT * D4;
  float4* sw = sk + kT * D4;
  float4* sv = sw + kT * D4;          // [kT][D4], read as floats [kT][D]
  float4* sy = sv + kT * D4;          // [kT][D4], written as floats
  const float* svf = reinterpret_cast<const float*>(sv);
  float* syf = reinterpret_cast<float*>(sy);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthreads = blockDim.x;  // 4 D / CE
  const int e0 = (tid / kSplit) * CE, p = tid % kSplit;
  const long long row_stride = (long long)H * D;       // one time step
  const long long base = ((long long)b * S * H + h) * D;

  float st[NJ][4][CE], uu[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int q = j * kSplit + p;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * q + c;
      const bool live = q < D4;
      uu[j][c] = live ? u[(long long)h * D + d] : 0.f;
#pragma unroll
      for (int ce = 0; ce < CE; ++ce)
        st[j][c][ce] = live && s0 != nullptr
                           ? s0[((long long)bh * D + d) * D + e0 + ce]
                           : 0.f;
    }
  }

  // a span's loads: 4 arrays x kT rows x D4 chunks = kT CE / 4 float4 per
  // thread (nthreads = 16 D4 / CE)
  constexpr int kPer = kT * CE / 4;
  float4 pre[kPer];
  auto load_span = [&](int t0) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int i = tid + m * nthreads;       // < 4 kT D4
      const int a = i / (kT * D4), rem = i % (kT * D4);
      const int tt = rem / D4, q = rem % D4;
      const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? w : v;
      pre[m] = t0 + tt < S
                   ? __ldg(reinterpret_cast<const float4*>(src) +
                           (base + (t0 + tt) * row_stride) / 4 + q)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_span = [&]() {
#pragma unroll
    for (int m = 0; m < kPer; ++m) smem[tid + m * nthreads] = pre[m];
  };

  load_span(0);
  for (int t0 = 0; t0 < S; t0 += kT) {
    store_span();
    __syncthreads();
    if (t0 + kT < S) load_span(t0 + kT);      // in flight during the span
    const int nt = min(kT, S - t0);
    for (int tt = 0; tt < nt; ++tt) {
      float ve[CE], acc[CE];
#pragma unroll
      for (int ce = 0; ce < CE; ++ce) {
        ve[ce] = svf[tt * D + e0 + ce];
        acc[ce] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int q = j * kSplit + p;
        if (q < D4) {
          const float4 rr = sr[tt * D4 + q], kk = sk[tt * D4 + q],
                       ww = sw[tt * D4 + q];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int ce = 0; ce < CE; ++ce) {
              const float kv = get(kk, c) * ve[ce];
              acc[ce] = fmaf(get(rr, c), fmaf(uu[j][c], kv, st[j][c][ce]),
                             acc[ce]);
              st[j][c][ce] = fmaf(get(ww, c), st[j][c][ce], kv);
            }
          }
        }
      }
#pragma unroll
      for (int ce = 0; ce < CE; ++ce) {
        acc[ce] += __shfl_xor_sync(0xffffffffu, acc[ce], 1);
        acc[ce] += __shfl_xor_sync(0xffffffffu, acc[ce], 2);
        if (p == 0) syf[tt * D + e0 + ce] = acc[ce];
      }
    }
    __syncthreads();
    for (int i = tid; i < nt * D4; i += nthreads) {
      const int tt = i / D4, q = i % D4;
      reinterpret_cast<float4*>(y)[(base + (t0 + tt) * row_stride) / 4 + q] =
          sy[i];
    }
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int q = j * kSplit + p;
    if (q < D4) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int ce = 0; ce < CE; ++ce)
          s_out[((long long)bh * D + 4 * q + c) * D + e0 + ce] =
              st[j][c][ce];
    }
  }
}

template <int NJ, int CE, int kT>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int S, int H, int D, cudaStream_t stream) {
  // at most 5 * 32 * 64 or 5 * 16 * 128 floats: 40 KB, under the 48 KB
  // that needs no opt-in
  const size_t smem = (size_t)5 * kT * D * sizeof(float);
  rwkv6_scan_kernel<NJ, CE, kT>
      <<<(unsigned)(B * H), 4 * D / CE, smem, stream>>>(r, k, v, w, u, s0, y,
                                                        s_out, S, H, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, w, y: contiguous (B, S, H, D) fp32 device buffers; u (H, D);
// s0 (B, H, D, D) fp32 or null; s_out (B, H, D, D). D % 8 == 0 and
// D <= 128, so that 4 D / CE threads fill whole warps for the shuffles;
// the Python wrapper checks shapes, types and devices first (and returns
// without a launch for an empty batch).
int rwkv6_scan_f32(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int B, int S, int H, int D, void* stream) {
  const float *rf = static_cast<const float*>(r),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *wf = static_cast<const float*>(w),
              *uf = static_cast<const float*>(u),
              *s0f = static_cast<const float*>(s0);
  float *yf = static_cast<float*>(y), *sf = static_cast<float*>(s_out);
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 8 != 0 || D < 8 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const bool two = D % 16 == 0;        // 2 D threads are whole warps
  if (D <= 16)
    return launch<1, 1, 32>(rf, kf, vf, wf, uf, s0f, yf, sf, B, S, H, D, st);
  if (D <= 32)
    return launch<2, 1, 32>(rf, kf, vf, wf, uf, s0f, yf, sf, B, S, H, D, st);
  if (D <= 64)
    return two ? launch<4, 2, 16>(rf, kf, vf, wf, uf, s0f, yf, sf, B, S, H,
                                  D, st)
               : launch<4, 1, 32>(rf, kf, vf, wf, uf, s0f, yf, sf, B, S, H,
                                  D, st);
  return two ? launch<8, 2, 16>(rf, kf, vf, wf, uf, s0f, yf, sf, B, S, H, D,
                                st)
             : launch<8, 1, 16>(rf, kf, vf, wf, uf, s0f, yf, sf, B, S, H, D,
                                st);
}

}  // extern "C"
