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
//     B log2(1 + snr[i, j] g / B) >= r_i   (fading: g an Exp(1) gain from
//     splitmix64 of (seed, floor(t_tx[k] / coherence), {i, j}))
// or the static decode table says so; retx counts the packets of passes
// p > 0. delivered[r, i, j] = recv[i, j] and j needs nothing any more.
// Each round closes with + compute_s. The Python wrapper
// (kernels/trace_scan.py) builds the mixing matrices from delivered.
//
// What bounds it on an H100. Bytes are nothing: snr n^2 float64, recv
// n^2 and delivered R n^2 bools, ~12 us at n = 1024, R = 30 and 3.35
// TB/s. The float64 decodes (a hash, log1p, log2 and a division a
// (packet, receiver) pair) are the work, and the real floor is the
// chain: the clock carried from pass to pass makes R x n x passes steps
// that depend on one another, so the trace is one thread block and each
// step costs at least its barriers.
//
// What the design does about it. One block of 512 threads per trace, one
// launch: a loop inside the block takes the place of the sequential
// scan. A prologue lists each row's intended receivers (a warp a row,
// ballots; scratch (n, n + 1) int32 in device memory). Per transmitter
// the block stages its receivers, their mean SNR and its packet
// durations in shared memory, and keeps each receiver's need bits as
// words of 64 packets (any P). Per pass: the OR of the need words
// (shuffles, then one partial a warp) is the send mask; thread 0 runs
// the running sum over the packets sequentially (the plain version's
// association, so the times are bit-equal to it on the CPU), warp 0
// hashes each sent packet's coherence block; then the threads share
// out the (packet, receiver) pairs, packet-major so that a warp's lanes
// clear bits of different receivers' words, and decide only pairs whose
// need bit is set: need only loses bits, so a receiver outside recv_i
// never matters and the work is P x deg(i), not P x n. A pass with
// nothing to send ends the transmitter's passes (later ones would add
// 0.0 to the clock and change nothing). Every add, product and division
// that feeds a time or a decode is an explicit round-to-nearest
// intrinsic, so nvcc contracts none into an FMA and the division is
// IEEE (the plain version divides by tensors for the same reason).
// Batching a family of traces over blocks, or one trace over a cluster,
// is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int n, int P) {
  const size_t W = (P + 63) / 64;
  return (size_t)n * 8            // mean SNR (or the decode flag) a receiver
         + (size_t)n * W * 8      // need words
         + (size_t)P * 24         // durations, launch times, block hashes
         + (size_t)(kWarps + 1) * W * 8   // OR partials, the send mask
         + 16                     // the pass's airtime and its flag
         + (size_t)n * 4;         // receiver indices
}

template <bool kFading>
__global__ void __launch_bounds__(kThreads, 1)
trace_scan_kernel(const double* __restrict__ rates,
                  const double* __restrict__ sizes,
                  const bool* __restrict__ recv, const void* __restrict__ chan,
                  int n, int P, int passes, double coh, double bw,
                  double overhead, double compute_s, unsigned long long seed,
                  int R, bool* __restrict__ delivered,
                  double* __restrict__ t_start, double* __restrict__ t_comm,
                  long long* __restrict__ retx_out, double* __restrict__ t_end,
                  int* __restrict__ lists, long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (P + 63) >> 6;
  double* snr = reinterpret_cast<double*>(smem);                    // n
  unsigned long long* need =
      reinterpret_cast<unsigned long long*>(snr + n);               // n W
  double* durs = reinterpret_cast<double*>(need + (size_t)n * W);   // P
  double* ttx = durs + P;                                           // P
  unsigned long long* bk = reinterpret_cast<unsigned long long*>(ttx + P);
  unsigned long long* red = bk + P;                                 // warps W
  unsigned long long* send = red + kWarps * W;                      // W
  double* airtime = reinterpret_cast<double*>(send + W);
  int* flag = reinterpret_cast<int*>(airtime + 1);
  int* lst = flag + 2;                                              // n

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long last =
      (P & 63) ? ((1ull << (P & 63)) - 1) : ~0ull;

  // prologue: row i's intended receivers, in order, at lists[i][1..]
  for (int i = warp; i < n; i += kWarps) {
    int cnt = 0;
    int* row = lists + (size_t)i * (n + 1);
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      const bool f = j < n && recv[(size_t)i * n + j];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) row[1 + cnt + __popc(m & ((1u << lane) - 1))] = j;
      cnt += __popc(m);
    }
    if (lane == 0) row[0] = cnt;
  }
  __syncthreads();

  double clock = 0.0;
  long long pairs = 0, steps = 0;
  for (int r = 0; r < R; ++r) {
    const double round_start = clock;
    long long retx = 0;
    for (int i = 0; i < n; ++i) {
      const double rate = rates[i];
      if (!(isfinite(rate) && rate > 0.0)) continue;   // sends nothing
      const int* row = lists + (size_t)i * (n + 1);
      const int deg = row[0];
      for (int q = tid; q < deg; q += kThreads) {
        const int j = row[1 + q];
        lst[q] = j;
        snr[q] = kFading
            ? static_cast<const double*>(chan)[(size_t)i * n + j]
            : (static_cast<const bool*>(chan)[(size_t)i * n + j] ? 1.0 : 0.0);
        for (int w = 0; w < W; ++w) need[q * W + w] = w == W - 1 ? last : ~0ull;
      }
      for (int k = tid; k < P; k += kThreads)
        durs[k] = __dadd_rn(__ddiv_rn(sizes[k], rate), overhead);

      for (int p = 0; p < passes; ++p) {
        if (p > 0) {
          for (int w = 0; w < W; ++w) {
            unsigned long long acc = 0;
            for (int q = tid; q < deg; q += kThreads) acc |= need[q * W + w];
            acc = warp_or(acc);
            if (lane == 0) red[warp * W + w] = acc;
          }
        }
        __syncthreads();
        if (warp == 0) {
          if (lane == 0) {
            int any = 0;
            for (int w = 0; w < W; ++w) {
              unsigned long long s = w == W - 1 ? last : ~0ull;
              if (p > 0) {
                s = 0;
                for (int v = 0; v < kWarps; ++v) s |= red[v * W + w];
              }
              send[w] = s;
              any |= s != 0;
              if (p > 0) retx += __popcll(s);
            }
            *flag = any;
            if (any) {
              double cs = 0.0;
              for (int k = 0; k < P; ++k) {
                const double d = (send[k >> 6] >> (k & 63)) & 1 ? durs[k] : 0.0;
                cs = __dadd_rn(cs, d);
                ttx[k] = __dadd_rn(clock, __dsub_rn(cs, d));
              }
              *airtime = cs;
              ++steps;
            }
          }
          __syncwarp();
          if (kFading && *flag) {
            for (int k = lane; k < P; k += 32) {
              if (!((send[k >> 6] >> (k & 63)) & 1)) continue;
              const long long block =
                  (long long)floor(__ddiv_rn(ttx[k], coh));
              bk[k] = mix64(seed ^ mix64((unsigned long long)block));
            }
          }
        }
        __syncthreads();
        if (!*flag) break;              // nothing left to send
        clock = __dadd_rn(clock, *airtime);
        if (kFading) {
          for (int q = tid; q < P * deg; q += kThreads) {
            const int k = q / deg, jj = q - k * deg;
            const int w = k >> 6;
            const unsigned long long bit = 1ull << (k & 63);
            if (!(send[w] & bit) || !(need[jj * W + w] & bit)) continue;
            ++pairs;
            const int j = lst[jj];
            const unsigned long long pair =
                (unsigned long long)min(i, j) * n + max(i, j);
            const unsigned long long h = mix64(bk[k] ^ pair);
            const double u = __dmul_rn((double)(h >> 11), 0x1p-53);
            const double g = -log1p(-u);
            const double cap = __dmul_rn(
                bw, log2(__dadd_rn(1.0, __ddiv_rn(__dmul_rn(snr[jj], g),
                                                  bw))));
            if (cap >= rate) atomicAnd(&need[jj * W + w], ~bit);
          }
        } else {
          for (int q = tid; q < deg; q += kThreads) {
            for (int w = 0; w < W; ++w) {
              pairs += __popcll(need[q * W + w] & send[w]);
              if (snr[q] != 0.0) need[q * W + w] &= ~send[w];
            }
          }
        }
        __syncthreads();
      }
      for (int q = tid; q < deg; q += kThreads) {
        unsigned long long left = 0;
        for (int w = 0; w < W; ++w) left |= need[q * W + w];
        if (!left) delivered[((size_t)r * n + i) * n + lst[q]] = true;
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
    if (tid == 0) atomicAdd(reinterpret_cast<unsigned long long*>(counts),
                            (unsigned long long)steps);
    if (pairs) atomicAdd(reinterpret_cast<unsigned long long*>(counts + 1),
                         (unsigned long long)pairs);
  }
}

template <bool kFading>
int launch(const double* rates, const double* sizes, const bool* recv,
           const void* chan, int n, int P, int passes, double coh, double bw,
           double overhead, double compute_s, unsigned long long seed, int R,
           bool* delivered, double* t_start, double* t_comm, long long* retx,
           double* t_end, int* lists, long long* counts, cudaStream_t st) {
  const size_t smem = smem_bytes(n, P);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_scan_kernel<kFading>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  trace_scan_kernel<kFading><<<1, kThreads, smem, st>>>(
      rates, sizes, recv, chan, n, P, passes, coh, bw, overhead, compute_s,
      seed, R, delivered, t_start, t_comm, retx, t_end, lists, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rates (n,), sizes (P,) float64; recv (n, n) bool; chan (n, n) float64
// mean SNR when fading, else the (n, n) bool decode table; delivered (R,
// n, n) bool zeroed by the caller; t_start, t_comm (R,) float64; retx
// (R,) int64; t_end a float64 scalar; lists (n, n + 1) int32 scratch;
// counts (2,) int64 or null (gains the passes run and the decodes
// decided). All contiguous device buffers; the Python wrapper checks
// shapes, types and devices first.
int trace_scan(const void* rates, const void* sizes, const void* recv,
               const void* chan, int fading, int n, int P, int passes,
               double coh, double bw, double overhead, double compute_s,
               unsigned long long seed, int R, void* delivered, void* t_start,
               void* t_comm, void* retx, void* t_end, void* lists,
               void* counts, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  auto* f = fading ? launch<true> : launch<false>;
  return f(static_cast<const double*>(rates),
           static_cast<const double*>(sizes), static_cast<const bool*>(recv),
           chan, n, P, passes, coh, bw, overhead, compute_s, seed, R,
           static_cast<bool*>(delivered), static_cast<double*>(t_start),
           static_cast<double*>(t_comm), static_cast<long long*>(retx),
           static_cast<double*>(t_end), static_cast<int*>(lists),
           static_cast<long long*>(counts), st);
}

}  // extern "C"
