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
//   the JAX layout. The rows are read in place by strides: no copy to
//   (B*H, S, D) and no padding of S or D. Masks on absolute positions:
//   t < T; causal: t <= s; window w > 0: s - t < w. fp32 online softmax
//   (running max m, denominator l, accumulator acc), out = acc / max(l,
//   1e-30), written in q's dtype (bf16 rounds to nearest even).
//
// What bounds it on an H100: operations. At the served prefill (B = 4,
// S = 4096, Hq = 10, Hkv = 1, D = 256, window 2048) the band holds
// 6 292 480 (query, key) pairs per (batch, head): 4 * D * pairs * B * Hq
// = 2.58e11 flops, 0.261 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 184.5 MB of q, k, v and out, 0.055 ms at 3.35 TB/s.
//
// What the design does about it: the only saving this first kernel takes
// is the one the TPU kernel exists for: key tiles outside the causal /
// window band are never loaded or multiplied. Block (q tile of kBQ rows,
// q head, batch) loops only over the key tiles from
// floor(max(0, q0 - w + 1) / kBK) to the last query row of the tile. The
// arithmetic runs in fp32 on CUDA cores (67 TFLOP/s peak), register-tiled:
// each of the 256 threads owns 4 query rows x 2 keys of the score tile and
// the same 4 rows x D/16 lanes of the accumulator, so a row's max and sum
// reduce over the 16 threads of a half warp with shuffles, and each thread
// rescales only its own accumulator rows. q (pre-scaled) and k tiles sit
// transposed in shared memory, so a thread's 4 rows (keys) are one float4
// (float2) load; v and the probability tile feed the P.V product the same
// way. Lanes past D and rows past S / T are zero-filled, never read from
// device memory. Tensor cores (wgmma), TMA and a pipelined ring of tiles
// are later work. Nothing is allocated here: the Python wrapper allocates
// the output; the launch goes on the caller's stream and every entry
// returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;  // 16 (ty: 4 rows each) x 16 (tx)
constexpr int kQS = kBQ + 4;   // padded row strides of the transposed
constexpr int kKS = kBK + 4;   // tiles (multiples of 4: float4 aligned)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// DP = D rounded up to 64, 128 or 256 (lanes past D are zeros).
template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)DP * kQS + (size_t)DP * kKS +
                          (size_t)kBK * DP + (size_t)kBK * kQS);
}

// grid (ceil(S / kBQ), Hq, B), kThreads threads, smem_bytes<DP>() dynamic.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int T_len, int Hq, int Hkv, int D,
                           float scale, int causal, int window) {
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
  const T* qb = q + ((long long)b * S * Hq + h) * D;
  const T* kb = k + ((long long)b * T_len * Hkv + hk) * D;
  const T* vb = v + ((long long)b * T_len * Hkv + hk) * D;

  // q tile: element (r, d) -> qs[d][r], d fastest across threads
  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    const int s = q0 + r;
    qs[d * kQS + r] =
        (s < S && d < D) ? to_f32(qb[s * q_step + d]) * scale : 0.f;
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
      ks[d * kKS + c] = in ? to_f32(kb[t * k_step + d]) : 0.f;
      vs[c * DP + d] = in ? to_f32(vb[t * k_step + d]) : 0.f;
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
    T* o = out + ((long long)b * S + s) * q_step + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DP / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = j * 64 + tx * 4 + e;
        if (d < D) store(o + d, acc[i][j * 4 + e] / den);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int Hq, int Hkv, int D, float scale, int causal,
           int window, void* stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  flash_attention_kernel<T, DP><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, Hq, Hkv, D,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int Hq, int Hkv, int D, float scale,
             int causal, int window, void* stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, S, T_len, Hq, Hkv, D, scale, causal,
                         window, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, S, T_len, Hq, Hkv, D, scale,
                          causal, window, stream);
  if (D <= 256)
    return launch<T, 256>(q, k, v, out, B, S, T_len, Hq, Hkv, D, scale,
                          causal, window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Every entry: contiguous device buffers q (B, S, Hq, D), k / v
// (B, T, Hkv, D), out (B, S, Hq, D) on the stream's device, Hq % Hkv == 0,
// 0 < D <= 256; the Python wrapper checks shapes, types and devices first.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int T_len, int Hq, int Hkv,
                        int D, float scale, int causal, int window,
                        void* stream) {
  return dispatch<float>(q, k, v, out, B, S, T_len, Hq, Hkv, D, scale, causal,
                         window, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int T_len, int Hq, int Hkv,
                         int D, float scale, int causal, int window,
                         void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, S, T_len, Hq, Hkv, D, scale,
                                 causal, window, stream);
}

}  // extern "C"
