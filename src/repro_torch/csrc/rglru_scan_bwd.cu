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
// on 3 nodes (B = 6, S = 512, D = 2560) that is 157 MB, 0.047 ms at
// 3.35 TB/s.
//
// The design is the forward's, run backwards in time. S <= kChunk (one
// decode-sized call): one thread per (batch, channel) walks time down.
// S > kChunk: a single-pass chained scan over chunks of kChunk steps taken
// in reverse order. A CTA per (batch, tile of kTile channels, chunk) takes
// its place from an atomic ticket, latest chunk first, loads its chunk's
// coefficients a_{t+1} and dh into registers, publishes the chunk's
// aggregate (the map g_{t1+1} -> g_{t0}), takes its carry-in g_{t1+1} by
// look-back over the later chunks of its (batch, tile) (the aggregates of
// the next kReach - 1 composed onto the end value of the kReach-th: a
// fixed reach, where the forward stops at the first end value it finds,
// so that two calls round alike and are bit-equal; a chain of S / (kChunk
// kReach) waits), walks the chunk from it, publishes its own end value
// g_{t0} and runs the epilogue:
// db, and da from h_{t-1} (the chunk's h shifted by one step: h0 or 0
// before the first). The flags and the ticket live in a workspace of the
// forward's layout that this entry zeroes on the stream before the kernel,
// so a captured CUDA graph is right on every replay. Nothing is allocated
// here; the launches go on the caller's stream and the entry returns
// cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;    // the per-channel walk
constexpr int kTile = 128;      // chained scan: channels per CTA
constexpr int kChunk = 32;      // chained scan: steps per chunk
constexpr int kReach = 8;       // chained scan: chunks a carry-in composes

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

// grid (B * ceil(D / kTile) * ceil(S / kChunk)), block kTile
__global__ void __launch_bounds__(kTile)
    rglru_bwd_kernel_chained(const float* __restrict__ a,
                             const float* __restrict__ h,
                             const float* __restrict__ h0,
                             const float* __restrict__ dh,
                             float* __restrict__ da, float* __restrict__ db,
                             float* __restrict__ dh0, int B, int S, int D,
                             Workspace ws) {
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ws.ticket, 1u);
  __syncthreads();
  const int tiles = (D + kTile - 1) / kTile;
  const int lanes = B * tiles;
  const int nchunks = (S + kChunk - 1) / kChunk;
  const int rec = (int)s_ticket;
  const int rev = rec / lanes, bt = rec % lanes;
  const int chunk = nchunks - 1 - rev;
  const int bb = bt / tiles, d = bt % tiles * kTile + threadIdx.x;
  const int t0 = chunk * kChunk, n = min(kChunk, S - t0);
  const bool live = d < D;
  const long long base = ((long long)bb * S + t0) * D + d;

  // step i's coefficient a_{t0+i+1} (0 past the end: g_S = 0) and dh;
  // rows past S pass g through unchanged
  float cv[kChunk], gv[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const bool in = live && i < n;
    cv[i] = !in ? 1.f : t0 + i + 1 < S ? __ldg(a + base + (long long)(i + 1) * D)
                                       : 0.f;
    gv[i] = in ? __ldg(dh + base + (long long)i * D) : 0.f;
  }

  // the aggregate, from the chunk's end down to its start: published for
  // the kReach - 1 earlier chunks that compose it
  const size_t slot = (size_t)rec * kTile + threadIdx.x;
  float agg_a = 1.f, agg_b = 0.f;
#pragma unroll
  for (int i = kChunk - 1; i >= 0; --i) {
    agg_b = fmaf(cv[i], agg_b, gv[i]);
    agg_a *= cv[i];
  }
  ws.agg_a[slot] = agg_a;
  ws.agg_b[slot] = agg_b;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(ws.flag + rec, kAggregate);
  // the carry-in g_{t1+1}: the aggregates of the next kReach - 1 later
  // chunks, composed onto the end value of the kReach-th (or, near the
  // last chunk, onto g_S = 0). A fixed reach, not the first end value
  // found, so every call rounds alike: two calls are bit-equal.
  float acc_a = 1.f, acc_b = 0.f;
  const int stop = rev - kReach;
  for (int p = rev - 1; p > stop && p >= 0; --p) {
    const int prec = p * lanes + bt;
    while (load_acquire(ws.flag + prec) == kNone) __nanosleep(32);
    const size_t ps = (size_t)prec * kTile + threadIdx.x;
    const float pa = __ldcg(ws.agg_a + ps), pb = __ldcg(ws.agg_b + ps);
    acc_b = fmaf(acc_a, pb, acc_b);
    acc_a *= pa;
  }
  float g = acc_b;
  if (stop >= 0) {
    const int prec = stop * lanes + bt;
    while (load_acquire(ws.flag + prec) != kEnd) __nanosleep(32);
    g = fmaf(acc_a, __ldcg(ws.end + (size_t)prec * kTile + threadIdx.x),
             acc_b);
  }
  // the chunk from its carry-in, in registers; its end value first
#pragma unroll
  for (int i = kChunk - 1; i >= 0; --i) {
    g = fmaf(cv[i], g, gv[i]);
    gv[i] = g;
  }
  ws.end[slot] = g;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(ws.flag + rec, kEnd);
  if (!live) return;
  const float hin = h0 != nullptr ? h0[(long long)bb * D + d] : 0.f;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (i < n) {
      const long long at = base + (long long)i * D;
      const float hp = t0 + i > 0 ? __ldg(h + at - D) : hin;
      db[at] = gv[i];
      da[at] = gv[i] * hp;
    }
  }
  if (chunk == 0 && dh0 != nullptr)
    dh0[(long long)bb * D + d] = __ldg(a + base) * gv[0];
}

}  // namespace

extern "C" {

// a, h, dh, da, db: contiguous (B, S, D) fp32 device buffers; h0 and dh0:
// (B, D) fp32 or null (dh0 is written only when given). For S > kChunk, ws
// holds ws_bytes >= 16 + 4 R + 12 R kTile bytes (R = B * ceil(D / kTile) *
// ceil(S / kChunk) chunk records: the forward's workspace), 16-byte
// aligned; for S <= kChunk it is not read and may be null. The Python
// wrapper checks shapes, types and devices first.
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
  if (ws == nullptr || ws_bytes < 16 + 4 * recs + 12 * recs * kTile)
    return (int)cudaErrorInvalidValue;
  char* p = static_cast<char*>(ws);
  Workspace w;
  w.ticket = reinterpret_cast<unsigned*>(p);
  w.flag = reinterpret_cast<unsigned*>(p + 16);
  w.agg_a = reinterpret_cast<float*>(p + 16 + 4 * recs);
  w.agg_b = w.agg_a + recs * kTile;
  w.end = w.agg_b + recs * kTile;
  const cudaError_t e = cudaMemsetAsync(ws, 0, 16 + 4 * recs, st);
  if (e != cudaSuccess) return (int)e;
  rglru_bwd_kernel_chained<<<(unsigned)recs, kTile, 0, st>>>(
      af, hf, h0f, dhf, daf, dbf, dh0f, B, S, D, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
