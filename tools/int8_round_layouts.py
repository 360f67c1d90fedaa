#!/usr/bin/env python3
"""Time layouts of the int8 D-PSGD round's two kernels on one CUDA card.

The round's send (``quantize_int8_ef`` of ``src/repro_torch/csrc/
quantize.cu``: quantize ``flat + res`` in 2048-lane blocks and form the new
error-feedback residual) and its receive (``gossip_mix_q8_rows`` of
``csrc/gossip_mix.cu`` with W taken whole) at the paper's message, 6 nodes x
21 840 fp32, are a few microseconds each: launch-bound, not byte-bound. This
script compiles the send's candidate layouts (its own kernel, with the
port's arithmetic from ``csrc/quantize.cu``) and the port's receive with a
small dispatcher beside it (so it times the very kernel the port launches),
and prints, all inside CUDA graphs on one card:

1. the send in twelve layouts, kept in this script beside the port's one
   (CS = 1, V = 4): clusters of CS = 1, 2, 4 or 8 CTAs per scale block,
   V = 2, 4 or 8 lanes a thread, each held bit-equal to the plain version
   first; beside them the port's own send, the codec's quantize
   (``quantize_int8`` at 2048 lanes) and a plain copy of flat;
2. the receive alone, launched as a programmatic dependent (PDL) or
   plainly, loading W and self before or after its grid-dependency wait;
3. the pair (send, then receive) as the round runs it, in three forms:
   no PDL, PDL with the wait first, PDL with W and self loaded ahead of the
   wait; graphs replayed in turns (a, b, c, c, b, a, ...), so that the
   three share the card's state, in two sets to show the spread.

Each time is 100 calls (or rounds) captured into one graph, replayed
between CUDA events; the median over the replays. Ends with the card's
``nvidia-smi`` name and power limit.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/int8_round_layouts.py
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "csrc"

# the send in every (CS, V) layout: the port's send kernel with its one
# layout (CS = 1, V = 4) opened up, clusters of CS CTAs per scale block
# (the block's max crossing the cluster through distributed shared memory)
# and V lanes a thread; the port's source is included for the helpers it
# shares (max_nan, rint_quotient, aligned), so the arithmetic is the same
SEND = r"""
#include "@QUANTIZE@"
#include <cooperative_groups.h>
namespace {

template <int V>
__device__ __forceinline__ void load_lanes(const float* row, long long j0,
                                           long long len, bool vec,
                                           float* v) {
  if (vec && j0 + V <= len) {
    if constexpr (V == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(row + j0));
      v[0] = a.x; v[1] = a.y;
    } else {
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(row + j0 + i));
        v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = j0 + i < len ? __ldg(row + j0 + i) : 0.f;
  }
}

template <int V>
__device__ __forceinline__ void store_lanes(float* row, long long j0,
                                            long long len, bool vec,
                                            const float* v) {
  if (vec && j0 + V <= len) {
    if constexpr (V == 2) {
      *reinterpret_cast<float2*>(row + j0) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(row + j0 + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (j0 + i < len) row[j0 + i] = v[i];
  }
}

// grid (nb * CS, rows) in clusters of CS along x: cluster blockIdx.x / CS
// is scale block sb of row blockIdx.y, and CTA rank c of it owns lanes
// [c * 2048 / CS, (c + 1) * 2048 / CS) of that block, V lanes a thread.
template <int CS, int V>
__global__ void __cluster_dims__(CS, 1, 1)
    __launch_bounds__(kWire / (CS * V))
    ef_layout_kernel(const float* __restrict__ flat,
                     const float* __restrict__ res,
                     const uint8_t* __restrict__ live,
                     int8_t* __restrict__ q, float* __restrict__ scales,
                     float* __restrict__ new_res, long long len, bool ef,
                     bool vec) {
  constexpr int kThr = kWire / (CS * V);
  constexpr int kWarpsSB = kWire / (V * 32);  // warps of one scale block
  static_assert(kThr >= 32 && kThr <= 1024, "a CTA is 1 to 32 warps");
  const unsigned sb = blockIdx.x / CS;
  const unsigned rank = blockIdx.x % CS;
  const unsigned row = blockIdx.y;
  const long long nb = gridDim.x / CS;
  const long long j0 =
      (long long)sb * kWire + (long long)(rank * kThr + threadIdx.x) * V;
  const long long at = (long long)row * len;

  const bool alive = __ldg(live + row) != 0;
  float c[V], r[V];
  load_lanes<V>(flat + at, j0, len, vec, c);
  load_lanes<V>(res + at, j0, len, vec, r);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (ef) c[i] = __fadd_rn(c[i], r[i]);
    m = max_nan(m, fabsf(c[i]));
  }
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float part[kWarpsSB];
  const unsigned warp = rank * (kThr / 32) + threadIdx.x / 32;
  if constexpr (CS == 1) {
    if ((threadIdx.x & 31) == 0) part[warp] = m;
    __syncthreads();
  } else {
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < CS; ++k) *cluster.map_shared_rank(&part[warp], k) = m;
    }
    cluster.sync();
  }
  m = 0.f;
#pragma unroll
  for (int w = 0; w < kWarpsSB; ++w) m = max_nan(m, part[w]);

  float scale = __fdiv_rn(m, 127.f);
  if (scale == 0.f) scale = 1.f;
  const bool tame = scale >= 0x1p-125f && scale <= 0x1p125f;
  const float rcp = __frcp_rn(scale);
  uint32_t packed[(V + 3) / 4];
#pragma unroll
  for (int i = 0; i < (V + 3) / 4; ++i) packed[i] = 0u;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float rq = rint_quotient(c[i], scale, rcp, tame);
    const int qi = (int)fminf(fmaxf(rq, -127.f), 127.f);
    packed[i / 4] |= ((uint32_t)qi & 0xffu) << (8 * (i % 4));
    r[i] = !alive ? 0.f : ef ? __fsub_rn(c[i], __fmul_rn((float)qi, scale))
                             : r[i];
  }
  int8_t* q_at = q + row * nb * kWire + j0;
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(q_at) = make_uint2(packed[0], packed[1]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(q_at) = packed[0];
  } else {
    *reinterpret_cast<uint16_t*>(q_at) = (uint16_t)packed[0];
  }
  store_lanes<V>(new_res + at, j0, len, vec, r);
  if (rank == 0 && threadIdx.x == 0) scales[row * nb + sb] = scale;
}

template <int CS, int V>
int launch_layout(const void* flat, const void* res, const void* live,
                  void* q, void* scales, void* new_res, long long rows,
                  long long len, int ef, void* stream) {
  const long long nb = (len + kWire - 1) / kWire;
  constexpr int kVec = V < 4 ? V : 4;  // lanes of one vector load
  const bool vec = aligned(flat, 4 * kVec) && aligned(res, 4 * kVec) &&
                   aligned(new_res, 4 * kVec) && len % kVec == 0;
  const dim3 grid((unsigned)(nb * CS), (unsigned)rows);
  ef_layout_kernel<CS, V>
      <<<grid, kWire / (CS * V), 0, (cudaStream_t)stream>>>(
          static_cast<const float*>(flat), static_cast<const float*>(res),
          static_cast<const uint8_t*>(live), static_cast<int8_t*>(q),
          static_cast<float*>(scales), static_cast<float*>(new_res), len,
          ef != 0, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ef_layout(int cs, int v, const void* flat, const void* res,
                         const void* live, void* q, void* scales,
                         void* new_res, long long rows, long long len,
                         int ef, void* stream) {
#define L(CS, V) if (cs == CS && v == V) return launch_layout<CS, V>( \
    flat, res, live, q, scales, new_res, rows, len, ef, stream);
  L(1, 2) L(1, 4) L(1, 8) L(2, 2) L(2, 4) L(2, 8) L(4, 2) L(4, 4) L(4, 8)
  L(8, 2) L(8, 4) L(8, 8)
  return -1;
}
""".replace("@QUANTIZE@", str(CSRC / "quantize.cu"))

# the receive launched plainly (no PDL attribute; its wait returns at once)
RECEIVE = r"""
#include "%s"
extern "C" int q8_plain(int early, const void* w, long long ss,
                        const void* w_off, long long ldw, int skip_diag,
                        const void* self, const void* q, const void* scales,
                        void* out, int m, int k, long long n, long long np,
                        void* stream) {
  const long long lanes = (long long)kQ8Threads * kQ8Lanes;
  const dim3 grid((unsigned)((n + lanes - 1) / lanes), (unsigned)m);
  const bool vec = (n %% 4 == 0) && aligned(self, 16) && aligned(out, 16);
  const bool q_vec = aligned(q, 8);
#define ARGS (const float*)w, ss, (const float*)w_off, ldw, skip_diag, \
    (const float*)self, (const int8_t*)q, (const float*)scales, \
    (float*)out, k, n, np, vec, q_vec
  if (early)
    gossip_mix_q8_rows_kernel<true>
        <<<grid, kQ8Threads, 0, (cudaStream_t)stream>>>(ARGS);
  else
    gossip_mix_q8_rows_kernel<false>
        <<<grid, kQ8Threads, 0, (cudaStream_t)stream>>>(ARGS);
  return (int)cudaGetLastError();
}
""" % (CSRC / "gossip_mix.cu")


def build(name: str, text: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    src, lib = out / f"{name}.cu", out / f"{name}.so"
    src.write_text(text)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if done.returncode != 0:
        sys.exit(f"nvcc failed on {name}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib))


def capture(torch, fn, reps: int = 100):
    """``reps`` calls of ``fn`` captured into one CUDA graph (after warm-up
    calls on the capture stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def in_turns(torch, graphs: list, reps: int = 100,
             rounds: int = 9) -> list[float]:
    """Replay the graphs in turns (forward, then backward, ...), one CUDA
    event pair around each replay: the median us per call of each."""
    times = [[] for _ in graphs]
    for r in range(rounds):
        order = range(len(graphs)) if r % 2 == 0 else \
            reversed(range(len(graphs)))
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[i].replay()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / reps * 1e3)
    return [statistics.median(t) for t in times]


def main() -> None:
    import torch

    from repro_torch.kernels import _build, gossip_mix as gm
    from repro_torch.kernels import quantize as qz

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    send = build("int8_round_send", SEND)
    receive = build("int8_round_receive", RECEIVE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    send.ef_layout.argtypes = (i, i, p, p, p, p, p, p, ll, ll, i, p)
    receive.q8_plain.argtypes = (i, p, ll, p, ll, i, p, p, p, p, i, i, ll,
                                 ll, p)
    _build.build(["quantize", "gossip_mix"])

    n_nodes, n = 6, 21_840
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator().manual_seed(0)
    flat = (torch.randn((n_nodes, n), generator=g) * 0.3).to(dev)
    res = (torch.randn((n_nodes, n), generator=g) * 1e-3).to(dev)
    live = torch.tensor([True] * (n_nodes - 1) + [False], device=dev)
    w = torch.softmax(torch.randn((n_nodes, n_nodes), generator=g), -1).to(dev)
    nb = -(-n // 2048)
    q = torch.empty((n_nodes, nb * 2048), dtype=torch.int8, device=dev)
    scales = torch.empty((n_nodes, nb), device=dev)
    new_res = torch.empty_like(flat)
    mixed = torch.empty_like(flat)
    want = qz.quantize_int8_ef_plain(flat, res, live)

    def stream():
        return torch._C._cuda_getCurrentRawStream(dev.index)

    def send_call(cs, v):
        return send.ef_layout(cs, v, flat.data_ptr(), res.data_ptr(),
                              live.data_ptr(), q.data_ptr(),
                              scales.data_ptr(), new_res.data_ptr(),
                              n_nodes, n, 1, stream())

    rows = []
    for cs in (1, 2, 4, 8):
        for v in (2, 4, 8):
            q.zero_(), scales.zero_(), new_res.zero_()
            if send_call(cs, v) != 0:
                sys.exit(f"send CS={cs} V={v}: launch failed")
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in
                       zip((q, scales, new_res), want)):
                sys.exit(f"send CS={cs} V={v}: not bit-equal to the plain "
                         "version")
            rows.append((f"send CS={cs} V={v} ({2048 // (cs * v)} threads "
                         f"a CTA, {n_nodes * nb * cs} CTAs)",
                         capture(torch, lambda cs=cs, v=v: send_call(cs, v))))
    rows.append(("the port's quantize_int8_ef", capture(
        torch, lambda: qz.quantize_int8_ef(flat, res, live))))
    rows.append(("quantize_int8 at 2048 lanes (the quantize alone)",
                 capture(torch, lambda: qz.quantize_int8(flat, 2048))))
    rows.append(("plain copy of flat (0.52 MB)",
                 capture(torch, lambda: new_res.copy_(flat))))
    times = in_turns(torch, [gr for _, gr in rows])
    print(f"the send, flat and res ({n_nodes}x{n}) fp32, 2048-lane blocks, "
          "us per call, 100 calls in a CUDA graph:")
    for us, (label, _) in sorted(zip(times, rows), key=lambda r: r[0]):
        print(f"   {us:7.3f}  {label}")

    qs, ss = qz.quantize_int8_ef_plain(flat, res, live)[:2]
    q.copy_(qs), scales.copy_(ss)
    ref = gm.gossip_mix_q8_w_plain(w, flat, q, scales)

    def q8_plain(early):
        return receive.q8_plain(early, w.data_ptr(), n_nodes + 1,
                                w.data_ptr(), n_nodes, 1, flat.data_ptr(),
                                q.data_ptr(), scales.data_ptr(),
                                mixed.data_ptr(), n_nodes, n_nodes, n,
                                q.shape[1], stream())

    def q8_pdl(early):
        _build.launch("gossip_mix", "gossip_mix_q8_rows", gm._Q8_ARGS, dev,
                      w.data_ptr(), n_nodes + 1, w.data_ptr(), n_nodes, 1,
                      flat.data_ptr(), q.data_ptr(), scales.data_ptr(),
                      mixed.data_ptr(), n_nodes, n_nodes, n, q.shape[1],
                      early)
    for label, fn in (("plain", q8_plain), ("PDL", q8_pdl)):
        for early in (0, 1):
            mixed.zero_()
            fn(early)
            torch.cuda.synchronize()
            e = float((mixed - ref).abs().max())
            if e > 1e-5:
                sys.exit(f"receive {label} early={early}: max|err| {e}")
    rows = [(f"receive, {label} launch, W and self loaded "
             f"{'before' if early else 'after'} the wait",
             capture(torch, lambda fn=fn, early=early: fn(early)))
            for label, fn in (("plain", q8_plain), ("PDL", q8_pdl))
            for early in (0, 1)]
    rows.append(("the port's gossip_mix_q8_w", capture(
        torch, lambda: gm.gossip_mix_q8_w(w, flat, q, scales))))
    times = in_turns(torch, [gr for _, gr in rows])
    print(f"the receive, W ({n_nodes}x{n_nodes}) whole, self ({n_nodes}x{n}) "
          f"fp32, q ({n_nodes}x{q.shape[1]}) int8, us per call, 100 calls "
          "in a CUDA graph:")
    for us, (label, _) in sorted(zip(times, rows), key=lambda r: r[0]):
        print(f"   {us:7.3f}  {label}")

    def send_port():
        _build.launch("quantize", "quantize_int8_ef_f32_b2048", qz._EF_ARGS,
                      dev, flat.data_ptr(), res.data_ptr(), live.data_ptr(),
                      q.data_ptr(), scales.data_ptr(), new_res.data_ptr(),
                      n_nodes, n, 1)
    pairs = (("no PDL", lambda: (send_port(), q8_plain(0))),
             ("PDL, wait first", lambda: (send_port(), q8_pdl(0))),
             ("PDL, W and self ahead of the wait",
              lambda: (send_port(), q8_pdl(1))))
    for label, fn in pairs:
        mixed.zero_()
        fn()
        torch.cuda.synchronize()
        e = float((mixed - ref).abs().max())
        if e > 1e-5 or not torch.equal(new_res, want[2]):
            sys.exit(f"pair {label}: wrong (max|err| {e})")
    graphs = [capture(torch, fn) for _, fn in pairs]
    sets = [in_turns(torch, graphs, rounds=21) for _ in range(2)]
    print("the pair (the port's send, then receive), us per round, 100 "
          "rounds in a CUDA graph, replayed in turns (two sets of 21):")
    for i, (label, _) in enumerate(pairs):
        print(f"   {sets[0][i]:7.3f}  {sets[1][i]:7.3f}  {label}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
