#!/usr/bin/env python3
"""The round-loop kernel's time split by stage (clock64 stamps), and the
decode layouts tried against it, in turns, on one CUDA card.

Copies ``csrc/trace_scan.cu`` into ``build/`` as variants, builds each
with the port's nvcc flags and calls its ``trace_scan`` entry on two
traces: ``examples/sim_scenarios.py --scale 1024``'s (fading with Rayleigh
gains only, n 1024, P 22, 4 passes, ``--rounds`` rounds; its plan takes
~45 s on the host) and stablelm-3b's 1-layer cut (chip_smoke.py phase 16's
model, ~329 000 packets, past one tile) on fading at n 6, 2 rounds.

Variants (text edits of the current source; each must give the
current source's delivered, times, retx and counts):
  kernel       the source as it is;
  interleave2  two of a word's decodes hashed before either is decided;
  lanes        G lanes a need word, the most (up to 32) keeping a tile's
               words x G within the block, lane g deciding bits g, g + G,
               ... and the group's decodes ORed by shuffles;
  warp_word    a warp a need word, its lanes deciding 32 bits at a time
               and a ballot gathering them;
  stamps       the source with thread 0's clock64 stamps after staging,
               the running sum, the block hashes and the decodes (a tiled
               trace's decodes but the last tile's fall into the next
               tile's running sum).
Each trace runs every variant once, then ``--pairs`` times in turns,
forward and backward through the list (CUDA events around one launch);
the tool prints each variant's median, µs a transmitter pass, the stamps'
split (cycles by stage, a pass, a transmitter-round, the first pass's
decodes apart) and the card's ``nvidia-smi`` name, power limit and SM
clock. Exits 1 if a variant's outputs differ from the kernel's.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/trace_scan_stages.py [--rounds 30] [--pairs 2]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SOURCE = ROOT / "src/repro_torch/csrc/trace_scan.cu"

DECODE_LOOP = """                  while (bits) {
                    const int b = __ffsll(bits) - 1;
                    bits &= bits - 1;
                    const u64 h = mix64(bk[(wl << 6) + b] ^ pair);
                    if (decide(tq, h >> 11, snr_i + j, rate, bw, banded))
                      clear |= 1ull << b;
                  }"""
INTERLEAVE2 = """                  while (bits) {
                    int bb[2];
                    u64 hh[2];
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                      bb[x] = bits ? __ffsll(bits) - 1 : -1;
                      bits &= bits - 1;
                      hh[x] = mix64(bk[(wl << 6) + (bb[x] < 0 ? 0 : bb[x])]
                                    ^ pair);
                    }
#pragma unroll
                    for (int x = 0; x < 2; ++x)
                      if (bb[x] >= 0 &&
                          decide(tq, hh[x] >> 11, snr_i + j, rate, bw, banded))
                        clear |= 1ull << bb[x];
                  }"""
MAPPING = """      const int q0 = deg ? tid % deg : 0, wl0 = deg ? tid / deg : 0;
      const int q_step = deg ? kThreads % deg : 0;
      const int w_step = deg ? kThreads / deg : 0;
"""
LANES_MAPPING = """      int lg = 0;
      while (lg < 5 && (long long)deg * TW << (lg + 1) <= kThreads) ++lg;
      const int G = 1 << lg, g = lane & (G - 1);
      const u64 gmask = (~0ull / ((1ull << G) - 1)) << g;
      const int units = kThreads >> lg, u0 = tid >> lg;
      const int q0 = deg ? u0 % deg : 0, wl0 = deg ? u0 / deg : 0;
      const int q_step = deg ? units % deg : 0;
      const int w_step = deg ? units / deg : 0;
"""
DECODE_START = "          const long long total = (long long)deg * tw;"
DECODE_END = ("          __syncthreads();\n          if (!last_pass && warp == 0)"
              " {   // the next send mask: fold")
LANES_DECODE = """          const long long total = (long long)deg * tw << lg;
          int q = q0, wl = wl0;
          for (long long base = warp * 32; base < total; base += kThreads) {
            const bool valid = base + lane < total;
            u64* slot = need + (size_t)(w0 + wl) * n + q;
            u64 word = valid ? *slot : 0, clear = 0;
            if (word) {
              if (kFading) {
                const int j = lst[q];
                const longlong2 tq = th[q];
                const u64 pair = (u64)min(i, j) * n + max(i, j);
                u64 bits = word & gmask;
                while (bits) {
                  const int b = __ffsll(bits) - 1;
                  bits &= bits - 1;
                  const u64 h = mix64(bk[(wl << 6) + b] ^ pair);
                  if (decide(tq, h >> 11, snr_i + j, rate, bw, banded))
                    clear |= 1ull << b;
                }
              } else if (th[q].x) {
                clear = word;
              }
            }
            for (int o = 1; o < G; o <<= 1)
              clear |= __shfl_xor_sync(0xffffffffu, clear, o);
            if (word) {
              if (g == 0) {
                pairs += __popcll(word);
                if (clear) *slot = word & ~clear;
                if (last_pass && (word & ~clear)) drow[lst[q]] = false;
              }
              word &= ~clear;
            }
            if (!last_pass) {
              u64 v = word;
              for (int o = 1; o < 32; o <<= 1) {
                const u64 other = __shfl_down_sync(0xffffffffu, v, o);
                if (lane + o < 32 && q + ((g + o) >> lg) < deg) v |= other;
              }
              if (valid && v && (lane == 0 || (q == 0 && g == 0))) {
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
"""
WARP_DECODE = """          for (int e = warp; e < deg * tw; e += kWarps) {
            const int wl = e / deg, q = e - wl * deg;
            u64* slot = need + (size_t)(w0 + wl) * n + q;
            const u64 word = *slot;
            if (!word) continue;
            u64 left = word;
            if (kFading) {
              const int j = lst[q];
              const longlong2 tq = th[q];
              const u64 pair = (u64)min(i, j) * n + max(i, j);
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const unsigned bits = (unsigned)(word >> (32 * half));
                if (!bits) continue;
                bool ok = false;
                if ((bits >> lane) & 1) {
                  const u64 h = mix64(bk[(wl << 6) + 32 * half + lane] ^ pair);
                  ok = decide(tq, h >> 11, snr_i + j, rate, bw, banded);
                }
                left &= ~((u64)__ballot_sync(0xffffffffu, ok) << (32 * half));
              }
            } else if (th[q].x) {
              left = 0;
            }
            if (lane == 0) {
              pairs += __popcll(word);
              if (left != word) *slot = left;
              if (last_pass) {
                if (left) drow[lst[q]] = false;
              } else if (left) {
                part[wl] |= left;
                any[(p + 1) & 1] = 1;
              }
            }
          }
"""
STAGES = ("staging", "running sum", "block hashes + barrier",
          "decodes + barrier")


def replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit("csrc/trace_scan.cu changed: a variant's anchor "
                         f"is gone ({old.strip()[:60]!r}...)")
    return src.replace(old, new)


def decode_block(src: str, new: str) -> str:
    a, b = src.find(DECODE_START), src.find(DECODE_END)
    if a < 0 or b < a:
        raise SystemExit("csrc/trace_scan.cu changed: the decode block's "
                         "anchors are gone")
    return src[:a] + new + src[b:]


def stamped(src: str) -> str:
    def stamp(slot: int) -> str:
        return (f"if (tid == 0) {{ long long t = clock64(); st[{slot}] += "
                f"t - t0; t0 = t; }}\n")
    edits = [
        ("namespace {\n\ntypedef",
         "__device__ long long g_stamps[6];\nnamespace {\n\ntypedef"),
        ("  double clock = 0.0;                   // thread 0's\n",
         "  double clock = 0.0;                   // thread 0's\n"
         "  long long st[6] = {0, 0, 0, 0, 0, 0}, t0 = clock64();\n"),
        ("continue;   // sends nothing\n",
         "continue;   // sends nothing\n      if (tid == 0) t0 = clock64();\n"),
        ("      __syncthreads();\n\n      u64* cur = send_a;",
         "      __syncthreads();\n      " + stamp(0)
         + "      u64* cur = send_a;"),
        ("          if (kFading) {                   // a block",
         "          " + stamp(1)
         + "          if (kFading) {                   // a block"),
        ("          u64* part = red + warp * TW;",
         "          " + stamp(2) + "          u64* part = red + warp * TW;"),
        ("        if (tid == 0) {\n          clock = __dadd_rn(clock, cs);",
         "        if (tid == 0) { long long t = clock64(); st[3] += t - t0;"
         " if (p == 0) st[5] += t - t0; t0 = t; st[4] += p == 0; }\n"
         "        if (tid == 0) {\n          clock = __dadd_rn(clock, cs);"),
        ("  if (tid == 0) *t_end = clock;",
         "  if (tid == 0) for (int x = 0; x < 6; ++x) g_stamps[x] = st[x];\n"
         "  if (tid == 0) *t_end = clock;")]
    for old, new in edits:
        src = replace(src, old, new)
    return src + ('\nextern "C" int trace_scan_stamps(long long* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_stamps, '
                  '6 * sizeof(long long));\n}\n')


VARIANTS = {
    "kernel": lambda s: s,
    "interleave2": lambda s: replace(s, DECODE_LOOP, INTERLEAVE2),
    "lanes": lambda s: decode_block(replace(s, MAPPING, LANES_MAPPING),
                                    LANES_DECODE),
    "warp_word": lambda s: decode_block(s, WARP_DECODE),
    "stamps": stamped,
}


def build(name: str, src: str):
    from repro_torch.kernels import _build
    from repro_torch.kernels import trace_scan as ts

    digest = hashlib.sha256((src + " ".join(_build.NVCC_FLAGS)).encode())
    so = _build.BUILD_DIR / f"trace_scan_{name}-{digest.hexdigest()[:16]}.so"
    if not so.exists():
        cu = so.with_suffix(".cu")
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.trace_scan.argtypes = (*ts._ARGS, ctypes.c_void_p)
    lib.trace_scan.restype = ctypes.c_int
    return lib


def traces(rounds: int):
    """(label, scan inputs, keywords, rounds) of the two traces."""
    import dataclasses

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.core import dpsgd
    from repro_torch.models import transformer
    from repro_torch.sim import WirelessSimulator, get_scenario, jit_trace

    no_shadow = {"fading.shadowing_sigma_db": 0.0}
    cfg = dataclasses.replace(get_config("stablelm-3b"), n_layers=1)
    with FakeTensorMode():
        tree = transformer.init_params(cfg, torch.Generator(), "cpu")
    bits = float(sum(32 * x.numel() for x in dpsgd._leaves(tree)))
    out = []
    for label, sc, r in (
            ("--scale n=1024", get_scenario("fading", n_nodes=1024,
                                            **no_shadow), rounds),
            ("stablelm-3b 1 layer, fading n=6",
             get_scenario("fading", model_bits=bits, **no_shadow), 2)):
        arrays, kw = jit_trace.scan_inputs(sc, WirelessSimulator(sc))
        out.append((label, arrays, kw, r))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import trace_scan as ts

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    base = SOURCE.read_text()
    libs = {name: build(name, make(base)) for name, make in VARIANTS.items()}
    dev = torch.device("cuda")
    i64 = dict(dtype=torch.int64, device=dev)
    ok = True
    for label, arrays, kw, rounds in traces(args.rounds):
        rates, sizes, recv, chan, _ = (torch.as_tensor(a, device=dev)
                                       for a in arrays)
        n, p = len(arrays[0]), kw["n_pkts"]
        words = (p + 63) // 64
        tiled = ts._layout(n, p)[1]
        scratch = [torch.empty((n, n + 1), dtype=torch.int32, device=dev),
                   torch.empty((n, n, 2), **i64),
                   torch.empty((words, n), **i64) if tiled else None,
                   torch.empty((2, words), **i64) if tiled else None]
        outs = {}

        def call(name, n=n, p=p, kw=kw, rounds=rounds, scratch=scratch,
                 rates=rates, sizes=sizes, recv=recv, chan=chan):
            o = [torch.zeros((rounds, n, n), dtype=torch.bool, device=dev),
                 torch.empty(rounds, dtype=torch.float64, device=dev),
                 torch.empty(rounds, dtype=torch.float64, device=dev),
                 torch.empty(rounds, **i64),
                 torch.empty((), dtype=torch.float64, device=dev),
                 torch.zeros(2, **i64), torch.zeros(1, **i64)]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = libs[name].trace_scan(
                rates.data_ptr(), sizes.data_ptr(), recv.data_ptr(),
                chan.data_ptr(), 1, n, p, kw["passes"], kw["coherence_s"],
                kw["bandwidth_hz"], kw["overhead_s"], kw["compute_s"],
                kw["seed"] % (1 << 64), rounds,
                *(x.data_ptr() for x in o[:5]),
                *(None if x is None else x.data_ptr() for x in scratch),
                o[5].data_ptr(), o[6].data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            end.record()
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            end.synchronize()
            outs[name] = [x.cpu() for x in o]
            return start.elapsed_time(end)

        names = list(VARIANTS)
        for name in names:
            call(name)
        times = {name: [] for name in names}
        for _ in range(args.pairs):
            for name in names + names[::-1]:
                times[name].append(call(name))
        passes, decodes = (int(x) for x in outs["kernel"][5])
        print(f"== {label}: P {p}, {rounds} rounds, "
              f"{'tiled' if tiled else 'one tile'}, {passes} passes, "
              f"{decodes} decodes")
        for name in names:
            same = all(torch.equal(a, b)
                       for a, b in zip(outs[name][:6], outs["kernel"][:6]))
            ok &= same
            med = statistics.median(times[name])
            print(f"{name}: median {med:.3f} ms ({med * 1e3 / passes:.3f} us "
                  f"a pass), turns {[round(t, 3) for t in times[name]]}, "
                  f"outputs {'equal' if same else 'DIFFER'}", flush=True)
        stamps = (ctypes.c_longlong * 6)()
        call("stamps")
        if libs["stamps"].trace_scan_stamps(stamps):
            raise RuntimeError("reading the stamps failed")
        st = list(stamps)
        tx, total = st[4], sum(st[:4])
        print(f"stamps over one call ({tx} transmitter-rounds):")
        for stage, cycles in zip(STAGES, st[:4]):
            print(f"  {stage}: {cycles} cycles, {cycles / total * 100:.1f} %,"
                  f" {cycles / passes:.0f} a pass, {cycles / tx:.0f} a "
                  f"transmitter-round")
        print(f"  the first pass's decodes + barrier: {st[5] / tx:.0f} cycles "
              f"a transmitter-round; later passes' "
              f"{(st[3] - st[5]) / max(passes - tx, 1):.0f} a pass",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
