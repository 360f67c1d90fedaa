// RG-LRU linear recurrence for Hopper (sm_90a): the time scan of the port's
// `rglru` layers, in prefill and in decode.
//
// Replaces the TPU (Pallas) kernel of src/repro/kernels/rglru_scan.py
// (_rglru_scan, pallas_call at :59), reached through ops.rglru:
//
//   h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + b[b, t, d],
//   h[b, -1, d] = h0[b, d] (0 without h0)
//
//   a, b (B, S, D) fp32 contiguous, h0 (B, D) fp32 or null, out (B, S, D)
//   fp32. Elementwise over channels, sequential over time, fp32 carry; one
//   fused multiply-add per step.
//
// What bounds it on an H100: bytes. At the served prefill (B = 4,
// S = 4096, D = 2560) a, b and h are 167.8 MB each: 503 MB per launch,
// 0.150 ms at 3.35 TB/s. A decode launch (S = 1) moves 123 KB and is
// bound by the launch itself.
//
// Two kernels, chosen by S:
//
// * S <= kChunk (decode): one thread per (batch, channel) carries h in a
//   register and walks time, kAhead steps of loads in flight. One launch,
//   no workspace.
//
// * S > kChunk (prefill): a single-pass chained scan. One thread per
//   (batch, channel) of a tile of kTile channels per CTA, over a time chunk
//   of kChunk steps: B * ceil(D / kTile) * ceil(S / kChunk) CTAs (10 240 at
//   the served shape, where one thread per channel had 160 CTAs and too few
//   loads in flight to cover memory latency). Each thread loads its
//   chunk's a and b once into registers (coalesced rows of the tile),
//   forms the chunk's aggregate (A = prod a, B = the scan from 0) and
//   publishes it, takes its carry-in h_in by decoupled look-back over the
//   preceding chunks of the same (batch, tile) (composing aggregates
//   (A1, B1) then (A2, B2) into (A1 A2, A2 B1 + B2) until it meets a
//   published end value, or h0 before the first chunk), walks the chunk's
//   fmaf(a_t, h, b_t) from h_in in registers, publishes its end value and
//   writes h. So a and b are read once and h written once; within a chunk
//   the order of operations is the sequential one, and the composition
//   touches only h_in's rounding. A chunk's CTA takes its index from an
//   atomic ticket, chunk-major, so every predecessor it waits for was
//   scheduled before it (forward progress). The flags and the ticket live
//   in a workspace from the wrapper that this entry zeroes itself
//   (cudaMemsetAsync on the same stream, before the kernel), so a CUDA
//   graph that captured one call is right on every replay.
//
// The TPU's 128-lane channel blocks and padding of S (a padded with 1) are
// not carried over: the kernels mask the ragged edges. Nothing is
// allocated here; the launches go on the caller's stream and every entry
// returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;    // decode kernel
constexpr int kAhead = 16;
constexpr int kTile = 128;      // chained scan: channels per CTA
constexpr int kChunk = 32;      // chained scan: steps per chunk

// flag values of a chunk's record
constexpr unsigned kNone = 0, kAggregate = 1, kEnd = 2;

// grid (ceil(D / kThreads), B)
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ out,
                      int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long base = (long long)blockIdx.y * S * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = out + base;
  float h = h0 != nullptr ? h0[(long long)blockIdx.y * D + d] : 0.f;
  int t = 0;
  for (; t + kAhead <= S; t += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      av[i] = __ldg(ap + (long long)(t + i) * D);
      bv[i] = __ldg(bp + (long long)(t + i) * D);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      h = fmaf(av[i], h, bv[i]);
      op[(long long)(t + i) * D] = h;
    }
  }
  for (; t < S; ++t) {
    h = fmaf(__ldg(ap + (long long)t * D), h, __ldg(bp + (long long)t * D));
    op[(long long)t * D] = h;
  }
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

// The workspace: one ticket, then per chunk record c (= chunk-major index
// over (chunk, batch, tile)) a flag, and kTile floats each of A, B and the
// end value h.
struct Workspace {
  unsigned* ticket;
  unsigned* flag;      // [records]
  float* agg_a;        // [records][kTile]
  float* agg_b;
  float* end;
};

// grid (B * ceil(D / kTile) * ceil(S / kChunk)), block kTile
__global__ void __launch_bounds__(kTile)
    rglru_scan_kernel_chained(const float* __restrict__ a,
                              const float* __restrict__ b,
                              const float* __restrict__ h0,
                              float* __restrict__ out, int B, int S, int D,
                              Workspace ws) {
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ws.ticket, 1u);
  __syncthreads();
  const int tiles = (D + kTile - 1) / kTile;
  const int lanes = B * tiles;                 // records per chunk
  const int rec = (int)s_ticket;
  const int chunk = rec / lanes, bt = rec % lanes;
  const int bb = bt / tiles, d = bt % tiles * kTile + threadIdx.x;
  const int t0 = chunk * kChunk, n = min(kChunk, S - t0);
  const bool live = d < D;
  const long long base = ((long long)bb * S + t0) * D + d;

  float av[kChunk], bv[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const bool in = live && i < n;
    av[i] = in ? __ldg(a + base + (long long)i * D) : 1.f;
    bv[i] = in ? __ldg(b + base + (long long)i * D) : 0.f;
  }

  const size_t slot = (size_t)rec * kTile + threadIdx.x;
  float h;
  if (chunk == 0) {
    h = live && h0 != nullptr ? h0[(long long)bb * D + d] : 0.f;
  } else {
    // the aggregate, published before the look-back
    float agg_a = 1.f, agg_b = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      agg_b = fmaf(av[i], agg_b, bv[i]);
      agg_a *= av[i];
    }
    ws.agg_a[slot] = agg_a;
    ws.agg_b[slot] = agg_b;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) store_release(ws.flag + rec, kAggregate);
    // look-back: (acc_a, acc_b) is the map from the end of chunk p to the
    // start of this one
    float acc_a = 1.f, acc_b = 0.f;
    int p = chunk - 1;
    for (;;) {
      const int prec = p * lanes + bt;
      unsigned f;
      while ((f = load_acquire(ws.flag + prec)) == kNone) __nanosleep(32);
      const size_t ps = (size_t)prec * kTile + threadIdx.x;
      if (f == kEnd) {
        h = fmaf(acc_a, __ldcg(ws.end + ps), acc_b);
        break;
      }
      const float pa = __ldcg(ws.agg_a + ps), pb = __ldcg(ws.agg_b + ps);
      acc_b = fmaf(acc_a, pb, acc_b);
      acc_a *= pa;
      if (--p < 0) {
        h = fmaf(acc_a, live && h0 != nullptr ? h0[(long long)bb * D + d]
                                              : 0.f,
                 acc_b);
        break;
      }
    }
  }
  // the chunk from h_in, in registers; its end value published first
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    h = fmaf(av[i], h, bv[i]);
    bv[i] = h;
  }
  ws.end[slot] = h;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(ws.flag + rec, kEnd);
  if (live) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < n) out[base + (long long)i * D] = bv[i];
  }
}

}  // namespace

extern "C" {

// a, b, out: contiguous (B, S, D) fp32 device buffers; h0: (B, D) fp32 or
// null. For S > kChunk, ws holds ws_bytes >= 16 + 4 R + 12 R kTile bytes
// (R = B * ceil(D / kTile) * ceil(S / kChunk) chunk records), 16-byte
// aligned; for S <= kChunk it is not read and may be null. The Python
// wrapper checks shapes, types and devices first.
int rglru_scan_f32(const void* a, const void* b, const void* h0, void* out,
                   int B, int S, int D, void* ws, long long ws_bytes,
                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* hf = static_cast<const float*>(h0);
  float* of = static_cast<float*>(out);
  if (S <= kChunk) {
    const dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
    rglru_scan_kernel<<<grid, kThreads, 0, st>>>(af, bf, hf, of, S, D);
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
  // the ticket and the flags, zeroed on the stream before every launch
  const cudaError_t e = cudaMemsetAsync(ws, 0, 16 + 4 * recs, st);
  if (e != cudaSuccess) return (int)e;
  rglru_scan_kernel_chained<<<(unsigned)recs, kTile, 0, st>>>(af, bf, hf, of,
                                                              B, S, D, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
