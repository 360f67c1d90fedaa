// The gradient of the RG-LRU linear recurrence for Hopper (sm_90a): the
// backward of the port's `rglru` layers in training.
//
// The JAX package has no Pallas kernel for it: jax.grad differentiates the
// plain associative scan (src/repro/models/rglru.py, linear_recurrence).
// It belongs to the forward kernel of src/repro/kernels/rglru_scan.py
// (_rglru_scan, pallas_call at :59), whose port is csrc/rglru_scan.cu.
//
// The forward h_t = a_t h_{t-1} + b_t (h_{-1} = h0, or 0) and the output's
// gradient dh give, with g_t the gradient reaching h_t:
//
//   g_t  = dh_t + a_{t+1} g_{t+1},   g_{S-1} = dh_{S-1}
//   db_t = g_t,   da_t = g_t h_{t-1},   dh0 = a_0 g_0
//
// a reverse linear recurrence whose coefficient is a shifted by one step,
// then an elementwise epilogue that reads the forward's output one step
// back. a, h, dh, da, db (B, S, D) fp32 contiguous; h0, dh0 (B, D) or null.
//
// What bounds it on an H100: bytes. a, h and dh are read once, da and db
// written once: 20 bytes a lane. At the training shape of recurrentgemma-2b
// on 3 nodes (B = 3, S = 512, D = 2560) that is 78.6 MB, 0.0235 ms at
// 3.35 TB/s; the workspace adds 12 bytes a lane of every 32-step chunk's
// 128 channels (the aggregate's A and B and the end value, written once,
// read back from L2 by up to kReach later chunks) and a 4-byte flag a
// record: 0.47 MB there.
//
// The design is the forward's, run backwards in time. S <= kChunk (one
// decode-sized call): one thread per (batch, channel) walks time down.
// S > kChunk: a single-pass chained scan over chunks of kChunk steps taken
// in reverse order. A CTA per (batch, tile of kTile channels, chunk) takes
// its place from an atomic ticket, latest chunk first. Its prologue puts
// every load in flight at once: the chunk's shifted h rows (h_{t-1}; h0 or
// 0 before the first step) by cp.async into shared memory, for the
// epilogue, and a_{t+1} and dh into registers, 16 bytes a load: a thread
// holds 4 channels of 8 steps, the chunk's 32 steps in four segments on
// lanes c, c + 8, c + 16, c + 24 of a warp. Each segment's aggregate (the
// map from the gradient after its last step to the one at its first) is
// composed with the later segments' through shuffles into the chunk's,
// which is published; the carry-in g_{t1+1} comes by look-back over the
// later chunks of its (batch, tile) (the aggregates of the next kReach - 1
// composed onto the end value of the kReach-th: a fixed reach, where the
// forward stops at the first end value it finds, so that two calls round
// alike and are bit-equal; a chain of S / (kChunk kReach) waits); each
// segment walks from the carry-in composed with the later segments' maps;
// the chunk's end value g_{t0} is published, and the epilogue writes db
// and da = g h_{t-1} from the rows already in shared memory, 16 bytes a
// store. D % 4 != 0 (rows not 16-byte aligned) takes the same kernel with
// 4-byte accesses. The flags and the ticket live in a workspace of the
// forward's layout (its flags padded to 16 bytes) that this entry zeroes
// on the stream before the kernel, so a captured CUDA graph is right on
// every replay. Nothing is allocated
// here; the launches go on the caller's stream and the entry returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;    // the per-channel walk
constexpr int kTile = 128;      // chained scan: channels per CTA
constexpr int kChunk = 32;      // chained scan: steps per chunk
constexpr int kReach = 8;       // chained scan: chunks a carry-in composes
constexpr int kSeg = 8;         // chained scan: steps a thread (a segment)
constexpr int kCta = 128;       // chained scan: 32 channel quads x 4 segments

constexpr unsigned kNone = 0, kAggregate = 1, kEnd = 2;

// grid (ceil(D / kThreads), B)
__global__ void __launch_bounds__(kThreads)
    rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                     const float* __restrict__ h0,
                     const float* __restrict__ dh, float* __restrict__ da,
                     float* __restrict__ db, float* __restrict__ dh0, int S,
                     int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long base = (long long)blockIdx.y * S * D + d;
  const float hin = h0 != nullptr ? h0[(long long)blockIdx.y * D + d] : 0.f;
  float g = 0.f, next_a = 0.f;
  for (int t = S - 1; t >= 0; --t) {
    const long long at = base + (long long)t * D;
    g = fmaf(next_a, g, __ldg(dh + at));
    db[at] = g;
    da[at] = g * (t > 0 ? __ldg(h + at - D) : hin);
    next_a = __ldg(a + at);
  }
  if (dh0 != nullptr) dh0[(long long)blockIdx.y * D + d] = next_a * g;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float4 f4(float x) {
  return make_float4(x, x, x, x);
}

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 shfl4(float4 x, int src) {
  return make_float4(__shfl_sync(0xffffffffu, x.x, src),
                     __shfl_sync(0xffffffffu, x.y, src),
                     __shfl_sync(0xffffffffu, x.z, src),
                     __shfl_sync(0xffffffffu, x.w, src));
}

// channels d .. d + 3 of a row (p at channel d): one 16-byte access when
// VEC (D % 4 == 0, rows 16-byte aligned), else four, each inside D
template <bool VEC>
__device__ __forceinline__ float4 ld4(const float* p, int d, int D) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(d < D ? __ldg(p) : 0.f, d + 1 < D ? __ldg(p + 1) : 0.f,
                     d + 2 < D ? __ldg(p + 2) : 0.f,
                     d + 3 < D ? __ldg(p + 3) : 0.f);
}

template <bool VEC>
__device__ __forceinline__ void st4(float* p, int d, int D, float4 x) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = x;
    return;
  }
  if (d < D) p[0] = x.x;
  if (d + 1 < D) p[1] = x.y;
  if (d + 2 < D) p[2] = x.z;
  if (d + 3 < D) p[3] = x.w;
}

// The forward's workspace: a ticket, then per record a flag and kTile
// floats each of the aggregate's A and B and the end value. Record rec =
// rev * lanes + (batch, tile), rev = 0 for the latest chunk in time.
struct Workspace {
  unsigned* ticket;
  unsigned* flag;
  float* agg_a;
  float* agg_b;
  float* end;
};

// grid (B * ceil(D / kTile) * ceil(S / kChunk)), block kCta: thread (warp
// w, lane 8 q + c) holds channels 4 (8 w + c) .. + 3 of the tile and steps
// 8 q .. 8 q + 7 of the chunk
template <bool VEC>
__global__ void __launch_bounds__(kCta)
    rglru_bwd_kernel_chained(const float* __restrict__ a,
                             const float* __restrict__ h,
                             const float* __restrict__ h0,
                             const float* __restrict__ dh,
                             float* __restrict__ da, float* __restrict__ db,
                             float* __restrict__ dh0, int B, int S, int D,
                             Workspace ws) {
  __shared__ __align__(16) float hs[kChunk][kTile];   // h_{t-1} a step
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ws.ticket, 1u);
  __syncthreads();
  const int tiles = (D + kTile - 1) / kTile;
  const int lanes = B * tiles;
  const int nchunks = (S + kChunk - 1) / kChunk;
  const int rec = (int)s_ticket;
  const int rev = rec / lanes, bt = rec % lanes;
  const int chunk = nchunks - 1 - rev;
  const int bb = bt / tiles, d0 = bt % tiles * kTile;
  const int t0 = chunk * kChunk, n = min(kChunk, S - t0);
  const int lane = threadIdx.x % 32, q = lane / 8;
  const int c4 = 4 * (8 * (threadIdx.x / 32) + lane % 8);   // in the tile
  const int d = d0 + c4;
  const bool live = d < D;
  const long long row = (long long)bb * S * D;

  // h_{t-1} of the chunk's steps (h0 or 0 before the first) into shared
  // memory, first: nothing after the look-back waits on device memory
  for (int idx = threadIdx.x; idx < kChunk * (kTile / 4); idx += kCta) {
    const int i = idx / (kTile / 4), dd = 4 * (idx % (kTile / 4));
    const int t = t0 + i - 1;
    const bool ok = i < n && (t >= 0 || h0 != nullptr);
    const float* src = t >= 0 ? h + row + (long long)t * D + d0 + dd
                              : h0 + (long long)bb * D + d0 + dd;
    if (VEC) {
      const bool in = ok && d0 + dd < D;
      cp_async16(&hs[i][dd], in ? src : h, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = ok && d0 + dd + j < D;
        cp_async4(&hs[i][dd + j], in ? src + j : h, in);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // step 8 q + i's coefficient a_{t+1} (0 past the end: g_S = 0) and dh;
  // steps past S pass g through unchanged
  float4 cv[kSeg], gv[kSeg];
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    const int s = kSeg * q + i, t = t0 + s;
    const bool in = live && s < n;
    cv[i] = !in ? f4(1.f)
            : t + 1 < S ? ld4<VEC>(a + row + (long long)(t + 1) * D + d, d, D)
                        : f4(0.f);
    gv[i] = in ? ld4<VEC>(dh + row + (long long)t * D + d, d, D) : f4(0.f);
  }

  // the segment's aggregate, from its end down to its start; then the
  // chunk's (segments 3, 2, 1, 0 composed in turn) and this segment's
  // offset (the segments after it), from the four lanes of its channels
  float4 sa = f4(1.f), sb = f4(0.f);
#pragma unroll
  for (int i = kSeg - 1; i >= 0; --i) {
    sb = fma4(cv[i], sb, gv[i]);
    sa = mul4(sa, cv[i]);
  }
  float4 ca = f4(1.f), cb = f4(0.f), oa = ca, ob = cb;
#pragma unroll
  for (int qq = 3; qq >= 0; --qq) {
    if (qq == q) oa = ca, ob = cb;
    const float4 pa = shfl4(sa, 8 * qq + lane % 8);
    const float4 pb = shfl4(sb, 8 * qq + lane % 8);
    cb = fma4(pa, cb, pb);
    ca = mul4(ca, pa);
  }
  const size_t slot = (size_t)rec * kTile + c4;
  if (q == 0) {
    *reinterpret_cast<float4*>(ws.agg_a + slot) = ca;
    *reinterpret_cast<float4*>(ws.agg_b + slot) = cb;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(ws.flag + rec, kAggregate);
  // the carry-in g_{t1+1}: the aggregates of the next kReach - 1 later
  // chunks, composed onto the end value of the kReach-th (or, near the
  // last chunk, onto g_S = 0). A fixed reach, not the first end value
  // found, so every call rounds alike: two calls are bit-equal.
  float4 acc_a = f4(1.f), acc_b = f4(0.f);
  const int stop = rev - kReach;
  for (int p = rev - 1; p > stop && p >= 0; --p) {
    const int prec = p * lanes + bt;
    while (load_acquire(ws.flag + prec) == kNone) __nanosleep(32);
    const size_t ps = (size_t)prec * kTile + c4;
    const float4 pa = __ldcg(reinterpret_cast<const float4*>(ws.agg_a + ps));
    const float4 pb = __ldcg(reinterpret_cast<const float4*>(ws.agg_b + ps));
    acc_b = fma4(acc_a, pb, acc_b);
    acc_a = mul4(acc_a, pa);
  }
  float4 g = acc_b;
  if (stop >= 0) {
    const int prec = stop * lanes + bt;
    while (load_acquire(ws.flag + prec) != kEnd) __nanosleep(32);
    g = fma4(acc_a,
             __ldcg(reinterpret_cast<const float4*>(
                 ws.end + (size_t)prec * kTile + c4)),
             acc_b);
  }
  // the segment from its carry-in, in registers; the chunk's end value is
  // segment 0's
  g = fma4(oa, g, ob);
#pragma unroll
  for (int i = kSeg - 1; i >= 0; --i) {
    g = fma4(cv[i], g, gv[i]);
    gv[i] = g;
  }
  if (q == 0) *reinterpret_cast<float4*>(ws.end + slot) = g;
  __threadfence();
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();   // and the h rows are in
  if (threadIdx.x == 0) store_release(ws.flag + rec, kEnd);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    const int s = kSeg * q + i;
    if (s < n) {
      const long long at = row + (long long)(t0 + s) * D + d;
      const float4 hp = *reinterpret_cast<const float4*>(&hs[s][c4]);
      st4<VEC>(db + at, d, D, gv[i]);
      st4<VEC>(da + at, d, D, mul4(gv[i], hp));
    }
  }
  if (chunk == 0 && q == 0 && dh0 != nullptr)
    st4<VEC>(dh0 + (long long)bb * D + d, d, D,
             mul4(ld4<VEC>(a + row + d, d, D), gv[0]));
}

}  // namespace

extern "C" {

// a, h, dh, da, db: contiguous (B, S, D) fp32 device buffers; h0 and dh0:
// (B, D) fp32 or null (dh0 is written only when given). For S > kChunk, ws
// holds ws_bytes >= 16 + F + 12 R kTile bytes (R = B * ceil(D / kTile) *
// ceil(S / kChunk) chunk records, F = 4 R rounded up to 16: the forward's
// layout with the flags padded so that the float4 slots after them are
// aligned), 16-byte aligned; for S <= kChunk it is not read and may be
// null. The Python wrapper checks shapes, types and devices first.
int rglru_scan_bwd_f32(const void* a, const void* h, const void* h0,
                       const void* dh, void* da, void* db, void* dh0, int B,
                       int S, int D, void* ws, long long ws_bytes,
                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* af = static_cast<const float*>(a);
  const float* hf = static_cast<const float*>(h);
  const float* h0f = static_cast<const float*>(h0);
  const float* dhf = static_cast<const float*>(dh);
  float* daf = static_cast<float*>(da);
  float* dbf = static_cast<float*>(db);
  float* dh0f = static_cast<float*>(dh0);
  if (S <= kChunk) {
    const dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
    rglru_bwd_kernel<<<grid, kThreads, 0, st>>>(af, hf, h0f, dhf, daf, dbf,
                                                dh0f, S, D);
    return (int)cudaGetLastError();
  }
  const long long recs = (long long)B * ((D + kTile - 1) / kTile) *
                         ((S + kChunk - 1) / kChunk);
  const long long flags = (4 * recs + 15) / 16 * 16;   // float4 slots after
  if (ws == nullptr || ws_bytes < 16 + flags + 12 * recs * kTile)
    return (int)cudaErrorInvalidValue;
  char* p = static_cast<char*>(ws);
  Workspace w;
  w.ticket = reinterpret_cast<unsigned*>(p);
  w.flag = reinterpret_cast<unsigned*>(p + 16);
  w.agg_a = reinterpret_cast<float*>(p + 16 + flags);
  w.agg_b = w.agg_a + recs * kTile;
  w.end = w.agg_b + recs * kTile;
  const cudaError_t e = cudaMemsetAsync(ws, 0, 16 + flags, st);
  if (e != cudaSuccess) return (int)e;
  const uintptr_t any = (uintptr_t)a | (uintptr_t)h | (uintptr_t)h0 |
                        (uintptr_t)dh | (uintptr_t)da | (uintptr_t)db |
                        (uintptr_t)dh0;
  if (D % 4 == 0 && any % 16 == 0)
    rglru_bwd_kernel_chained<true><<<(unsigned)recs, kCta, 0, st>>>(
        af, hf, h0f, dhf, daf, dbf, dh0f, B, S, D, w);
  else
    rglru_bwd_kernel_chained<false><<<(unsigned)recs, kCta, 0, st>>>(
        af, hf, h0f, dhf, daf, dbf, dh0f, B, S, D, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
