// The scan trace engine's round loop for Hopper (sm_90a), in float64.
//
// Replaces no Pallas kernel. It is the lowering of the compiled lax.scan
// that src/repro/sim/jit_trace.py:123 (_round_scan) builds: every TDM
// round of a trace, an outer scan over rounds, an inner one over
// transmitters, the broadcast passes unrolled. Per transmitter i with
// rate r_i and intended receivers recv_i, need (P packets x receivers)
// starts as recv_i; pass 0 airs every packet, pass p > 0 the packets an
// intended receiver still needs; a packet airs at
//     t_tx[k] = clock + (cumsum(d)[k] - d[k]),  d[k] = send[k] ? dur[i, k] : 0
// (dur[i, k] = size[k] / r_i + overhead), the clock then advances by the
// running sum's last element; receiver j decodes packet k iff
//     B log2(1 + snr[i, j] g / B) >= r_i   (fading: g = -log1p(-u) an
//     Exp(1) gain, u = m 2^-53, m = h >> 11, h from splitmix64 of (seed,
//     floor(t_tx[k] / coherence), {i, j}))
// or the static decode table says so; retx counts the packets of passes
// p > 0. delivered[r, i, j] = recv[i, j] and j needs nothing any more.
// Each round closes with + compute_s. The Python wrapper
// (kernels/trace_scan.py) builds the mixing matrices from delivered.
//
// What bounds it on an H100. Bytes are nothing: snr n^2 float64, recv
// n^2 and delivered R n^2 bools, ~12 us at n = 1024, R = 30 and 3.35
// TB/s. The decodes are the work, and the real floor is the chain: the
// clock carried from pass to pass makes R x n x passes steps that depend
// on one another, so the trace is one thread block and each step costs
// at least its barriers.
//
// What the design does about it.
// * Integer-filtered decodes. The exact decision is monotone in u, so
//   each intended pair (i, j) has a threshold u* = -expm1(-g*), g* = B
//   (2^{r_i / B} - 1) / snr[i, j]. A prologue turns it into two integers
//   m_lo <= m_hi on the grid of m (the band kBand around u*, below), and
//   a decode is a hash and two compares: m < m_lo fails, m > m_hi
//   decodes, and only an m inside the band runs the exact float64 code
//   (exact_decode, the formula above with round-to-nearest intrinsics).
//   Every decision is the one the exact code makes; no float64 is left
//   in the common path. Why the band is sound: u outside [u*(1 - kBand),
//   u*(1 + kBand)] moves g by at least kBand relative (g is convex with
//   g(0) = 0) and the capacity by at least kBand x / ((1 + x) ln(1 + x))
//   relative, x = snr g / B. The float64 formulas (this kernel's and the
//   plain version's) err by a few ulps plus 2^-53 / ((1 + x) ln(1 + x))
//   from rounding 1 + x. For x* >= kMinX the margin is ~900 times the
//   error or more (x* = kMinX: 1e-9 against 1.1e-12; ln(1 + x) <= 710:
//   1.4e-12 against ~1e-15). A pair with snr <= 0, x* < kMinX or any
//   value not finite takes the whole range [0, 2^53): every decode
//   exact. A random u lands in a band with probability ~2e-9.
// * Tiles of packets. Shared memory is bounded for every (n, P): when a
//   transmitter's need words (each receiver's need bits as words of 64
//   packets, word-major, stride n), the two send masks and the per-packet
//   arrays of all P packets fit in kSingleBudget, they all live in shared
//   memory (one tile: --scale's P 22). Otherwise the need words and send
//   masks live in a device workspace beside the receiver lists (L2), and
//   a pass walks the packets tile by tile, kTileWords words a tile, the
//   tile's send words, durations, launch times and block hashes in
//   shared memory. A decode reads and writes its need word once a pass,
//   so a tile's need words gain nothing from a copy in shared memory. The
//   receivers' lists and thresholds are staged in shared memory while 20
//   n bytes fit in kStageMax, else read from the workspace.
// * One block of 512 threads per trace, one launch: a loop inside the
//   block takes the place of the sequential scan. A prologue lists each
//   row's intended receivers (a warp a row, ballots) and their
//   thresholds. Per pass and tile: thread 0 runs the running sum over the
//   tile's packets in packet order, carried across tiles (the plain
//   version's association: an unsent packet adds +0.0, which changes no
//   bit), eight adds back to back; so launch times, and with them the
//   coherence blocks, are bit-equal to the CPU's. The block hashes go to
//   warp 0 on a one-word tile and to every thread on a longer one. Then
//   each thread owns need words (receiver-consecutive lanes), decides
//   only the set bits (need only loses bits, so a receiver outside recv_i
//   never matters and the work is the packets still needed, not P x n),
//   writes the word back, and ORs it, segmented by a warp's shuffles,
//   into its warp's partial of the next pass's send mask; warp 0 folds
//   the partials (no atomics on one shared word). A pass whose send
//   mask is empty ends the transmitter's passes (later ones would add
//   0.0 to the clock and change nothing); the last pass marks a
//   receiver left needing a packet as not delivered. Every add, product
//   and division that feeds a time or an exact decode is an explicit
//   round-to-nearest intrinsic, so nvcc contracts none into an FMA and
//   the division is IEEE (the plain version divides by tensors for the
//   same reason).
// * What bounds it now: the decodes' latency. A thread walks its word's
//   set bits one after another (a hash and two compares each), and 16
//   warps hide little of it; on --scale's trace the decodes and their
//   barrier are ~79 % of a pass (H100). Tried and dropped
//   (tools/trace_scan_stages.py times them in turns): two decodes
//   interleaved, G lanes a word chosen from the word count, and a warp a
//   word; the last two win on a trace with few receivers and lose on
//   --scale's.
//
// trace_decide is a second, small entry: the threshold and the decision
// of each (snr, rate, m), through the filter and through the exact code,
// so tests can drive the band's exact path, which random hashes almost
// never reach.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr double kBand = 1e-9;          // relative half-width around u*
constexpr double kMinX = 1e-4;          // smallest x* the band is sound at
constexpr long long kLastM = (1LL << 53) - 1;
constexpr long long kSingleBudget = 160 * 1024;
constexpr int kTileWords = 32;          // 2048 packets a tile
constexpr long long kStageMax = 64 * 1024;
constexpr long long kSmemMax = 227 * 1024;

// The shared-memory layout of one launch; kernels/trace_scan.py:_layout
// mirrors it.
struct Layout {
  int tile_words;    // words of 64 packets a tile
  int need_global;   // need words and send masks in the workspace
  int staged;        // receiver lists and thresholds in shared memory
  long long smem;    // bytes
};

__host__ __device__ Layout layout(int n, int P) {
  const long long W = (P + 63) / 64;
  Layout L;
  L.staged = 20LL * n <= kStageMax;
  const long long stage = L.staged ? 20LL * n : 0;
  const long long single = stage + 8LL * n * W + 16 * W + 1672 * W + 16;
  if (single <= kSingleBudget) {
    L.tile_words = (int)W;
    L.need_global = 0;
    L.smem = single;
  } else {
    L.tile_words = (int)(W < kTileWords ? W : kTileWords);
    L.need_global = 1;
    L.smem = stage + 1672LL * L.tile_words + 16;
  }
  return L;
}

__device__ __forceinline__ u64 mix64(u64 z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// (m_lo, m_hi) of a pair with mean SNR snr and rate rate: see the header.
__device__ longlong2 fade_threshold(double snr, double rate, double bw) {
  longlong2 t = make_longlong2(0, kLastM);
  const double x = expm1(__dmul_rn(__ddiv_rn(rate, bw), 0.69314718055994531));
  if (!(snr > 0.0) || !isfinite(snr) || !(x >= kMinX) || !isfinite(x))
    return t;
  const double g = __ddiv_rn(__dmul_rn(bw, x), snr);
  const double u = -expm1(-g);
  const double lo = floor(__dmul_rn(__dmul_rn(u, 1.0 - kBand), 0x1p53));
  const double hi = ceil(__dmul_rn(__dmul_rn(u, 1.0 + kBand), 0x1p53));
  if (!isfinite(g) || !isfinite(lo) || !isfinite(hi)) return t;
  t.x = (long long)fmax(lo, 0.0);
  t.y = (long long)fmin(hi, (double)kLastM);
  return t;
}

// The exact decision of a decode at m = h >> 11: the formula above, each
// operation round-to-nearest.
__device__ __forceinline__ bool exact_decode(u64 m, double snr, double rate,
                                             double bw) {
  const double u = __dmul_rn((double)m, 0x1p-53);
  const double g = -log1p(-u);
  const double cap = __dmul_rn(
      bw, log2(__dadd_rn(1.0, __ddiv_rn(__dmul_rn(snr, g), bw))));
  return cap >= rate;
}

// The filtered decision: the two compares, the exact code inside the band
// (counted in banded). snr is read only there.
__device__ __forceinline__ bool decide(longlong2 th, u64 m,
                                       const double* snr, double rate,
                                       double bw, long long& banded) {
  const long long mm = (long long)m;
  const bool above = mm > th.y;
  if (above || mm < th.x) return above;
  ++banded;
  return exact_decode(m, *snr, rate, bw);
}

// The coherence block's hash of each sent packet of a tile (sent null:
// every packet), packets first, first + stride, ...
__device__ __forceinline__ void hash_blocks(const u64* sent,
                                            const double* ttx, u64* bk,
                                            int tp, int first, int stride,
                                            double coh, u64 seed) {
  for (int k = first; k < tp; k += stride) {
    if (sent != nullptr && !((sent[k >> 6] >> (k & 63)) & 1)) continue;
    const long long block = (long long)floor(__ddiv_rn(ttx[k], coh));
    bk[k] = mix64(seed ^ mix64((u64)block));
  }
}

template <bool kFading>
__global__ void __launch_bounds__(kThreads, 1)
trace_scan_kernel(const double* __restrict__ rates,
                  const double* __restrict__ sizes,
                  const bool* __restrict__ recv, const void* __restrict__ chan,
                  int n, int P, int passes, double coh, double bw,
                  double overhead, double compute_s, u64 seed, int R,
                  bool* __restrict__ delivered, double* __restrict__ t_start,
                  double* __restrict__ t_comm, long long* __restrict__ retx_out,
                  double* __restrict__ t_end, int* __restrict__ lists,
                  longlong2* __restrict__ thr, u64* need_ws, u64* send_ws,
                  long long* __restrict__ counts,
                  long long* __restrict__ exact) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(n, P);
  const int W = (P + 63) >> 6, TW = L.tile_words, TP = TW << 6;
  const int tiles = (W + TW - 1) / TW;
  unsigned char* s = smem;
  longlong2* sthr = reinterpret_cast<longlong2*>(s);                // n
  s += L.staged ? 16 * (size_t)n : 0;
  u64* need = L.need_global ? need_ws : reinterpret_cast<u64*>(s);  // W n
  s += L.need_global ? 0 : 8 * (size_t)n * W;
  u64* send_a = L.need_global ? send_ws : reinterpret_cast<u64*>(s);  // 2 W
  s += L.need_global ? 0 : 16 * (size_t)W;
  double* durs = reinterpret_cast<double*>(s);                      // TP
  double* ttx = durs + TP;                                          // TP
  u64* bk = reinterpret_cast<u64*>(ttx + TP);                       // TP
  u64* red = bk + TP;                                               // warps TW
  u64* scur = red + kWarps * TW;                                    // TW
  int* any = reinterpret_cast<int*>(scur + TW);                     // 2
  int* slst = any + 4;                                              // n

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const u64 last = (P & 63) ? ((1ull << (P & 63)) - 1) : ~0ull;
  const double* snr_g = static_cast<const double*>(chan);
  const bool* table = static_cast<const bool*>(chan);

  // prologue: row i's intended receivers, in order, at lists[i][1..],
  // and their thresholds (fading) or decode flags (static) at thr[i][..]
  for (int i = warp; i < n; i += kWarps) {
    int cnt = 0;
    int* row = lists + (size_t)i * (n + 1);
    const double rate = rates[i];
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      const bool f = j < n && recv[(size_t)i * n + j];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) {
        const int q = cnt + __popc(m & ((1u << lane) - 1));
        row[1 + q] = j;
        thr[(size_t)i * n + q] =
            kFading ? fade_threshold(snr_g[(size_t)i * n + j], rate, bw)
                    : make_longlong2(table[(size_t)i * n + j] ? 1 : 0, 0);
      }
      cnt += __popc(m);
    }
    if (lane == 0) row[0] = cnt;
  }
  __syncthreads();

  double clock = 0.0;                   // thread 0's
  long long pairs = 0, steps = 0, banded = 0, retx = 0;
  for (int r = 0; r < R; ++r) {
    const double round_start = clock;
    retx = 0;
    for (int i = 0; i < n; ++i) {
      const double rate = rates[i];
      if (!(isfinite(rate) && rate > 0.0)) continue;   // sends nothing
      const int* row = lists + (size_t)i * (n + 1);
      const int deg = row[0];
      const int* lst = L.staged ? slst : row + 1;
      const longlong2* th = L.staged ? sthr : thr + (size_t)i * n;
      const double* snr_i = snr_g + (size_t)i * n;
      bool* drow = delivered + ((size_t)r * n + i) * n;
      const bool one_tile = tiles == 1;
      for (int q = tid; q < deg; q += kThreads) {
        const int j = row[1 + q];
        if (L.staged) {
          slst[q] = j;
          sthr[q] = thr[(size_t)i * n + q];
        }
        drow[j] = true;   // the last pass clears it where a packet is left
      }
      const long long words = (long long)deg * W;
      for (long long e = tid; e < words; e += kThreads) {
        const int w = (int)(e / deg);
        need[(size_t)w * n + (e - (long long)w * deg)] =
            w == W - 1 ? last : ~0ull;
      }
      if (one_tile)
        for (int k = tid; k < P; k += kThreads)
          durs[k] = __dadd_rn(__ddiv_rn(sizes[k], rate), overhead);
      // this thread's first (word, receiver) of a tile and its stride
      const int q0 = deg ? tid % deg : 0, wl0 = deg ? tid / deg : 0;
      const int q_step = deg ? kThreads % deg : 0;
      const int w_step = deg ? kThreads / deg : 0;
      __syncthreads();

      u64* cur = send_a;
      u64* nxt = send_a + W;
      for (int p = 0; p < passes; ++p) {
        if (p > 0 && !any[p & 1]) break;   // nothing left to send
        const bool last_pass = p == passes - 1;
        if (tid == 0) any[(p + 1) & 1] = 0;
        double cs = 0.0;                   // thread 0's running sum
        for (int t = 0; t < tiles; ++t) {
          const int k0 = t * TP, w0 = t * TW;
          const int tp = min(TP, P - k0), tw = (tp + 63) >> 6;
          if (!one_tile) {
            for (int k = tid; k < tp; k += kThreads)
              durs[k] = __dadd_rn(__ddiv_rn(sizes[k0 + k], rate), overhead);
            if (p > 0)                     // the tile's send words, fetched
              for (int w = tid; w < tw; w += kThreads) scur[w] = cur[w0 + w];
            __syncthreads();
          }
          // the tile's send words (null on pass 0: every packet)
          const u64* sent = p == 0 ? nullptr : one_tile ? cur : scur;
          if (tid == 0) {                  // the running sum, packet order
            for (int w = 0; w < tw; ++w) {
              const u64 sw = p == 0 ? (w0 + w == W - 1 ? last : ~0ull)
                                    : sent[w];
              if (p > 0) retx += __popcll(sw);
              if (!sw) continue;           // 64 packets that add +0.0
              const int kw = w << 6, nk = min(64, tp - kw);
              for (int b0 = 0; b0 < nk; b0 += 8) {
                // eight adds back to back: in-order issue would otherwise
                // wait on each launch time's two operations in between
                double d[8], c[8];
#pragma unroll
                for (int x = 0; x < 8; ++x)
                  d[x] = b0 + x < nk && ((sw >> (b0 + x)) & 1)
                             ? durs[kw + b0 + x] : 0.0;
#pragma unroll
                for (int x = 0; x < 8; ++x) c[x] = cs = __dadd_rn(cs, d[x]);
#pragma unroll
                for (int x = 0; x < 8; ++x)
                  if (b0 + x < nk)
                    ttx[kw + b0 + x] = __dadd_rn(clock, __dsub_rn(c[x], d[x]));
              }
            }
          }
          if (kFading) {                   // a block hash per sent packet
            if (TP <= 64) {                // one word: warp 0 after the sum
              if (warp == 0) {
                __syncwarp();
                hash_blocks(sent, ttx, bk, tp, lane, 32, coh, seed);
              }
            } else {
              __syncthreads();
              hash_blocks(sent, ttx, bk, tp, tid, kThreads, coh, seed);
            }
          }
          __syncthreads();
          u64* part = red + warp * TW;     // this warp's OR of its words
          if (!last_pass) {
            for (int w = lane; w < tw; w += 32) part[w] = 0;
            __syncwarp();
          }
          const long long total = (long long)deg * tw;
          int q = q0, wl = wl0;
          for (long long base = warp * 32; base < total; base += kThreads) {
            const bool valid = base + lane < total;
            u64 word = 0;
            if (valid) {
              u64* slot = need + (size_t)(w0 + wl) * n + q;
              word = *slot;
              if (word) {
                pairs += __popcll(word);
                if (kFading) {
                  const int j = lst[q];
                  const longlong2 tq = th[q];
                  const u64 pair = (u64)min(i, j) * n + max(i, j);
                  u64 bits = word, clear = 0;
                  while (bits) {
                    const int b = __ffsll(bits) - 1;
                    bits &= bits - 1;
                    const u64 h = mix64(bk[(wl << 6) + b] ^ pair);
                    if (decide(tq, h >> 11, snr_i + j, rate, bw, banded))
                      clear |= 1ull << b;
                  }
                  if (clear) *slot = word &= ~clear;
                } else if (th[q].x) {
                  *slot = word = 0;
                }
                if (last_pass && word) drow[lst[q]] = false;
              }
            }
            if (!last_pass) {
              // the next pass's send mask: OR of the words of one packet
              // word, lanes of consecutive receivers, segmented at q = 0
              u64 v = word;
              for (int o = 1; o < 32; o <<= 1) {
                const u64 other = __shfl_down_sync(0xffffffffu, v, o);
                if (lane + o < 32 && q + o < deg) v |= other;
              }
              if (valid && v && (lane == 0 || q == 0)) {
                part[wl] |= v;
                any[(p + 1) & 1] = 1;
              }
              __syncwarp();
            }
            q += q_step;
            wl += w_step;
            if (q >= deg) {
              q -= deg;
              ++wl;
            }
          }
          __syncthreads();
          if (!last_pass && warp == 0) {   // the next send mask: fold
            for (int w = lane; w < tw; w += 32) {
              u64 v = 0;
              for (int x = 0; x < kWarps; ++x) v |= red[x * TW + w];
              nxt[w0 + w] = v;
            }
            __syncwarp();
          }
        }
        if (tid == 0) {
          clock = __dadd_rn(clock, cs);
          ++steps;
        }
        u64* swap = cur;
        cur = nxt;
        nxt = swap;
      }
    }
    if (tid == 0) {
      t_start[r] = round_start;
      t_comm[r] = __dsub_rn(clock, round_start);
      retx_out[r] = retx;
    }
    clock = __dadd_rn(clock, compute_s);
  }
  if (tid == 0) *t_end = clock;
  if (counts != nullptr) {
    if (tid == 0) atomicAdd(reinterpret_cast<u64*>(counts), (u64)steps);
    if (pairs) atomicAdd(reinterpret_cast<u64*>(counts + 1), (u64)pairs);
  }
  if (exact != nullptr && banded)
    atomicAdd(reinterpret_cast<u64*>(exact), (u64)banded);
}

__global__ void trace_decide_kernel(const double* __restrict__ snr,
                                    const double* __restrict__ rate,
                                    const long long* __restrict__ m, int N,
                                    double bw, longlong2* __restrict__ thr,
                                    bool* __restrict__ filtered,
                                    bool* __restrict__ exact,
                                    bool* __restrict__ banded) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < N;
       e += gridDim.x * blockDim.x) {
    const longlong2 th = fade_threshold(snr[e], rate[e], bw);
    long long b = 0;
    filtered[e] = decide(th, (u64)m[e], snr + e, rate[e], bw, b);
    exact[e] = exact_decode((u64)m[e], snr[e], rate[e], bw);
    banded[e] = b != 0;
    thr[e] = th;
  }
}

template <bool kFading>
int launch(const double* rates, const double* sizes, const bool* recv,
           const void* chan, int n, int P, int passes, double coh, double bw,
           double overhead, double compute_s, u64 seed, int R,
           bool* delivered, double* t_start, double* t_comm, long long* retx,
           double* t_end, int* lists, longlong2* thr, u64* need_ws,
           u64* send_ws, long long* counts, long long* exact,
           cudaStream_t st) {
  const Layout L = layout(n, P);
  if (L.smem > kSmemMax || (L.need_global && (!need_ws || !send_ws)))
    return (int)cudaErrorInvalidValue;
  if (L.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_scan_kernel<kFading>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
    if (e != cudaSuccess) return (int)e;
  }
  trace_scan_kernel<kFading><<<1, kThreads, (size_t)L.smem, st>>>(
      rates, sizes, recv, chan, n, P, passes, coh, bw, overhead, compute_s,
      seed, R, delivered, t_start, t_comm, retx, t_end, lists, thr, need_ws,
      send_ws, counts, exact);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rates (n,), sizes (P,) float64; recv (n, n) bool; chan (n, n) float64
// mean SNR when fading, else the (n, n) bool decode table; delivered (R,
// n, n) bool zeroed by the caller; t_start, t_comm (R,) float64; retx
// (R,) int64; t_end a float64 scalar; lists (n, n + 1) int32 and thr (n,
// n, 2) int64 scratch; need_ws (W, n) and send_ws (2, W) int64 scratch,
// W = ceil(P / 64), needed only where trace_scan_layout says so (else
// may be null); counts (2,) int64 or null (gains the passes run and the
// decodes decided); exact (1,) int64 or null (gains the decodes decided
// on the exact path). All contiguous device buffers; the Python wrapper
// checks shapes, types and devices first.
int trace_scan(const void* rates, const void* sizes, const void* recv,
               const void* chan, int fading, int n, int P, int passes,
               double coh, double bw, double overhead, double compute_s,
               unsigned long long seed, int R, void* delivered, void* t_start,
               void* t_comm, void* retx, void* t_end, void* lists, void* thr,
               void* need_ws, void* send_ws, void* counts, void* exact,
               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  auto* f = fading ? launch<true> : launch<false>;
  return f(static_cast<const double*>(rates),
           static_cast<const double*>(sizes), static_cast<const bool*>(recv),
           chan, n, P, passes, coh, bw, overhead, compute_s, seed, R,
           static_cast<bool*>(delivered), static_cast<double*>(t_start),
           static_cast<double*>(t_comm), static_cast<long long*>(retx),
           static_cast<double*>(t_end), static_cast<int*>(lists),
           static_cast<longlong2*>(thr), static_cast<u64*>(need_ws),
           static_cast<u64*>(send_ws), static_cast<long long*>(counts),
           static_cast<long long*>(exact), st);
}

// The layout of a launch at (n, P): out[0..3] = words a tile, need words
// in the workspace (0 / 1), receivers staged (0 / 1), shared bytes.
void trace_scan_layout(int n, int P, long long* out) {
  const Layout L = layout(n, P);
  out[0] = L.tile_words;
  out[1] = L.need_global;
  out[2] = L.staged;
  out[3] = L.smem;
}

// snr, rate (N,) float64, m (N,) int64 in [0, 2^53) -> thr (N, 2) int64
// (m_lo, m_hi), and bool (N,) each: the filtered decision, the exact
// code's, whether m fell in the band.
int trace_decide(const void* snr, const void* rate, const void* m, int N,
                 double bw, void* thr, void* filtered, void* exact,
                 void* banded, void* stream) {
  if (N <= 0) return 0;
  const int blocks = (N + 255) / 256 < 132 ? (N + 255) / 256 : 132;
  trace_decide_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const double*>(snr), static_cast<const double*>(rate),
      static_cast<const long long*>(m), N, bw, static_cast<longlong2*>(thr),
      static_cast<bool*>(filtered), static_cast<bool*>(exact),
      static_cast<bool*>(banded));
  return (int)cudaGetLastError();
}

}  // extern "C"
