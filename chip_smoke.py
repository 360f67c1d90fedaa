#!/usr/bin/env python3
"""Chip smoke of the PyTorch / H100 port (``src/repro_torch``).

Drives the port's four paths on one NVIDIA Hopper card, through the
entry points a user calls:

* the paper's wireless D-PSGD run: Eq. 2 capacities, Algorithm 2 rates at
  λ targets {0.1, 0.8}, then the full 21 840-parameter CNN trained with
  D-PSGD on 6 nodes at batch 25 over the 60 000-image synthetic set, each
  step replayed as one CUDA graph, with every gossip mix in the CUDA
  kernels of ``csrc/gossip_mix.cu``;
* serving recurrentgemma-2b at its published widths and full depth
  (``launch.serve.generate``: a 4096-token prompt at batch 4, then 32
  greedy tokens), with local attention's prefill in the CUDA kernel of
  ``csrc/flash_attention.cu`` and the RG-LRU recurrence in that of
  ``csrc/rglru_scan.cu``;
* serving rwkv6-7b at its published widths and full depth (32 layers,
  d_model 4096, 7.53 B parameters; the same prompt, batch and tokens), with
  the WKV recurrence of every prefill in the CUDA kernel of
  ``csrc/rwkv6_scan.cu``;
* training through the wireless simulator (``sim.simulate_dpsgd_cnn``, the
  driver behind Fig. 3's accuracy against simulated time) at the paper's
  size, one epoch of 400 rounds on ``compressed_int8`` and on ``static``,
  with every int8 round's quantize and error-feedback dequantize in the
  CUDA kernels of ``csrc/quantize.cu`` and its receive in ``gossip_mix_q8``.

Phases, each of which ends the run with a nonzero exit if it fails:

1. device   — a CUDA card of compute capability >= (9, 0); TF32 off for
              matmuls and cuDNN convolutions, so fp32 means fp32;
2. build    — nvcc builds every kernel from the sources into ``build/``
              (one nvcc per source, started together); each flash entry's
              registers and spill bytes from the ptxas report, and the
              bf16 (wgmma) kernels must not spill;
3. kernels  — each kernel against its plain torch version at the main
              paths' shapes and at edge shapes, its ValueError contracts,
              and its time beside its bound, plain and library times; the
              four kernels of the D-PSGD step also inside a CUDA graph
              (``graph_ms``: 100 captured calls), beside the library call
              captured the same way, and the host time of each piece of an
              eager rows-mix call, the earlier launch path and this one
              (3: gossip mixes, 3b: flash and rglru, flash in bf16 also at
              the tensor-core kernel's tile edges, with its TFLOP/s over
              the band and share of the bound, 3c: rwkv6_scan, and
              its state handoff to the one-token decode step, 3d: the
              int8 quantize / dequantize, bit-equal, in the TPU kernels'
              256-lane format through ``ops`` and the 2048-lane wire
              format, timed at the path's message and at (64, 1 048 576));
4. slice    — the paper run, each λ target's 40 steps twice in turns:
              the eager body, then the entry point, whose step is a CUDA
              graph (steps/s of both); the gossip_mix launch counter must
              grow by one launch per graphed step; graphed against eager on
              the card in lockstep (losses 1e-4, parameters 1e-5); the
              first 5 steps rerun on the CPU (plain versions) from the
              card's state must agree on losses to 1e-4 and on the mixed
              parameters to 1e-5; the card's time per graphed step (CUDA
              events) and the profiler's busy time, each with its idle
              share;
5. compressed — 4 rounds of int8 error-feedback D-PSGD with one dead
              node; the gossip_mix_q8 counter must grow, and one more step
              must agree with the CPU (q bit-equal, parameters to 1e-5);
6. serving  — recurrentgemma-2b served at (4, 4096, 32) in bf16: tokens
              (4, 32), finite logits, exactly 8 flash and 576 rglru
              launches; prefill s, decode tok/s, peak memory, the decode
              idle share and the top device operations of a prefill;
7. served correctness — (a) fp32 teacher forcing at full width and depth
              (prefill and 3 decode steps against ``apply``, 2e-4);
              (b) card against CPU in lockstep at the smoke widths with
              window 32 (logits and caches, 1e-4);
8. serving rwkv6-7b — the same at (4, 4096, 32) in bf16: tokens (4, 32),
              finite logits, exactly 32 rwkv6_scan launches (one per
              layer in prefill, none in decode), and the same readings;
9. rwkv correctness — (a) as 7(a) for rwkv6-7b: the prefill against
              apply over the same prompt (same GEMM shapes) at 2e-4, the
              decode steps, which read the kernel's final state, at 2e-4
              plus 3x the floor that changing only the GEMMs' shapes
              moves apply's logits by (this model amplifies rounding; the
              state handoff itself is held in 3c); (b) card against CPU
              in lockstep at the smoke widths with 4 layers (5e-4, the
              rwkv6 kernel's bar);
10. simulated training — ``simulate_dpsgd_cnn`` over 60 000 / 10 000
              images with ``measure_compute=True`` (each round stamped with
              the card's own step time), each scenario twice in turns: with
              the step builders patched to their eager bodies (the "before"
              run, here only), then as the port runs it (CUDA graphs). In
              both runs: on ``compressed_int8`` the
              quantize, dequantize and gossip_mix_q8 counters each grow by
              exactly the round count, on ``static`` gossip_mix does and the
              codec does not; each trace's communication fields equal the
              CPU simulator's charged the same compute; the first 5
              compressed rounds rerun on the CPU in lockstep (q bit-equal,
              losses 1e-4, parameters and residuals 1e-5 on every node row
              whose max-pools and ReLUs card and CPU route alike); rounds,
              simulated seconds, accuracy and host ms per round split into
              simulator, step and the rest, for both runs (the lockstep
              rounds are the graphed run's).

Each phase prints its wall time. The last lines are the card's
``nvidia-smi`` name and power limit, one JSON line with every kernel's
numbers, and ``{"ok": true, "device": ...}``.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_NODES = 6
EPS = 5.0
N_TRAIN, N_TEST = 60_000, 10_000     # SyntheticFashion's paper defaults
STEPS = 40                           # D-PSGD steps per λ target
CPU_STEPS = 5                        # steps rerun on the CPU
PROFILE_STEPS = 10                   # steps under the profiler
STEADY_STEPS = 200                   # graphed steps past the first replays
TIMING_REPEATS = 3                   # eager / graphed pairs per λ target
COMPRESSED_ROUNDS = 4
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOPS = 67e12                   # H100 SXM, fp32 outside tensor cores
BF16_FLOPS = 989e12                  # H100 SXM, dense bf16 tensor cores
TOL_FP32, TOL_BF16 = 1e-5, 3e-2      # tests/test_kernels.py
TOL_FLASH_FP32, TOL_RGLRU = 2e-5, 1e-4   # tests/test_kernels.py
TOL_RWKV = 5e-4                          # tests/test_kernels.py
# bf16 flash, besides max|err| <= TOL_BF16: every output row (one query,
# one head: D values) within 2^-6 of its norm, ||got - want|| <=
# TOL_FLASH_ROW ||want||. Rows that attend to 2048 keys are ~0.036 in size,
# so the absolute bar alone would pass a kernel that loses a few keys of
# the window's edge; losing one key of 2048 moves a row by ~2048^-1/2 =
# 0.022 of its norm, while the kernel's own roundings (P and out to bf16)
# stay well below the bar (PERF.md, PR 15's row of the flash kernel).
TOL_FLASH_ROW = 2.0 ** -6

# the serving slice (phases 6-7): recurrentgemma-2b at its published widths
SERVE_ARCH = "recurrentgemma-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
WARM_PROMPT = 256                    # warm-up generate, same widths
DECODE_PROFILE_STEPS = 10
TF_PROMPT, TF_STEPS = 4096, 3        # 7(a): teacher forcing, batch 1, fp32
LOCK_BATCH, LOCK_PROMPT, LOCK_STEPS = 2, 80, 4   # 7(b): card vs CPU

# the rwkv slice (phases 8-9): rwkv6-7b at its published widths, the same
# prompt, batch and tokens; 9(b) at the smoke widths with 4 layers
RWKV_ARCH = "rwkv6-7b"
RWKV_CHUNK = 32                      # the model's chunk: the plain version's
LOCK_RWKV_LAYERS = 4

# training through the wireless simulator (phase 10): one epoch of the
# paper's setup (400 rounds of batch 25 on 6 nodes) per scenario
SIM_EPOCHS = 1
SIM_CPU_ROUNDS = 5                   # compressed rounds rerun on the CPU


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 100, rounds: int = 5,
            warmup: int = 10) -> float:
    """CUDA events around ``reps`` back-to-back calls, after ``warmup``
    calls; the median over ``rounds`` of the per-call mean."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def paired_ms(torch, fn, library, reps: int = 100,
              rounds: int = 9) -> tuple[float, float]:
    """``time_ms`` of a kernel's eager call and of its library call, taken
    in turns (kernel, library, library, kernel, ...) so that a stall of the
    shared host falls on both alike: the median per call of each."""
    for f in (fn, library):
        for _ in range(10):
            f()
    torch.cuda.synchronize()
    per_call = ([], [])
    for i in range(rounds):
        order = (0, 1) if i % 2 == 0 else (1, 0)
        for j in order:
            f = (fn, library)[j]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                f()
            end.record()
            end.synchronize()
            per_call[j].append(start.elapsed_time(end) / reps)
    return statistics.median(per_call[0]), statistics.median(per_call[1])


def graph_ms(torch, fn, reps: int = 100, rounds: int = 5) -> float:
    """``reps`` back-to-back calls of ``fn`` captured into one CUDA graph
    (after warm-up calls on the capture's side stream), the graph replayed
    ``rounds`` times between CUDA events: the median per call. What a call
    costs inside the D-PSGD step's graph, with no host dispatch. Captures
    on the port's one capture stream (a new stream per capture would leave
    a cuBLAS workspace behind for each)."""
    from repro_torch import graphs

    side = graphs._side_stream(torch.device("cuda", 0))
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
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def device_profile(torch, run, calls: int) -> list[tuple[str, float, int]]:
    """Kernels in a ``torch.profiler`` trace of ``run`` (which makes
    ``calls`` calls of the thing measured): (name, device ms per call,
    launches per call), longest first; empty if the trace shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((evt.key, us / 1e3 / calls, evt.count // calls))
    return sorted(rows, key=lambda r: -r[1])


def device_ms(torch, fn, kernel_name: str, calls: int = 50):
    """Device time per call of the kernels whose name contains
    ``kernel_name``; None if the trace shows none."""
    fn()

    def run():
        for _ in range(calls):
            fn()
    ms = sum(r[1] for r in device_profile(torch, run, calls)
             if kernel_name in r[0])
    return ms if ms > 0 else None


def bound(nbytes: float, flops: float,
          peak: float = FP32_FLOPS) -> tuple[float, str]:
    """Least time on an H100 SXM: bytes over HBM rate vs flops over the
    peak of their type (fp32 unless given), whichever is larger (ms, and
    which one binds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rows_cost(m: int, k: int, n: int, elt: int) -> tuple[float, float]:
    """gossip_mix_rows: read W and bufs once, write out once; 2MKN flops."""
    return 4 * m * k + elt * (k * n + m * n), 2.0 * m * k * n


def q8_cost(m: int, k: int, n: int) -> tuple[float, float]:
    """gossip_mix_q8_rows: weights, fp32 self, the int8 lanes < N (the
    kernel never reads the padding), one scale per 2048-lane block in, fp32
    out; K*N dequantize multiplies, M*N self products, 2MKN flops."""
    nbytes = 4 * m * (k + 1) + 4 * m * n + k * n + 4 * k * -(-n // 2048) \
        + 4 * m * n
    return nbytes, float(k * n + m * n + 2 * m * k * n)


def flash_cost(b: int, s: int, hq: int, hkv: int, d: int, window: int,
               elt: int) -> tuple[float, float]:
    """flash_attention, causal: q and out (B, S, Hq, D), k and v
    (B, S, Hkv, D) once each; 4 D flops per (query, key) pair of the band
    (2 for q.k, 2 for p.v), for every batch and q head."""
    pairs = sum(min(q + 1, window) if window else q + 1 for q in range(s))
    return elt * (2 * b * s * hq * d + 2 * b * s * hkv * d), \
        4.0 * d * pairs * b * hq


def rglru_cost(b: int, s: int, d: int) -> tuple[float, float]:
    """rglru_scan: fp32 a, b in and h out (B, S, D), h0 (B, D); one
    multiply-add (2 flops) per element."""
    return 4.0 * (3 * b * s * d + b * d), 2.0 * b * s * d


def rwkv_cost(b: int, s: int, h: int, d: int) -> tuple[float, float]:
    """rwkv6_scan: fp32 r, k, v, w in and y out (B, S, H, D), s0 in and the
    final state out (B, H, D, D); 4 D^2 flops per (b, h, t) for the exact
    recurrence (D^2 multiply-adds for y, D^2 for the state)."""
    return 4.0 * (5 * b * s * h * d + 2 * b * h * d * d), \
        4.0 * d * d * b * h * s


def quantize_cost(rows: int, length: int, block: int,
                  elt: int) -> tuple[float, float]:
    """quantize_int8: x (rows, length) read once, q (rows, Lp) int8 and one
    fp32 scale per block written once; ~6 operations per lane (|x|, max,
    divide, round, two clamps)."""
    nb = -(-length // block)
    return elt * rows * length + rows * nb * block + 4 * rows * nb, \
        6.0 * rows * nb * block


def dequantize_cost(rows: int, length: int, block: int,
                    elt: int) -> tuple[float, float]:
    """dequantize_int8: the int8 lanes below ``length`` and one scale per
    block read once, (rows, length) written once; one multiply per lane."""
    nb = -(-length // block)
    return rows * length + 4 * rows * nb + elt * rows * length, \
        float(rows * length)


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_err(a, b) -> float:
    """Largest relative error over the rows of the last axis:
    max ||a_r - b_r|| / ||b_r||."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30))
                 .max())


def flash_edge_tile_dropped(torch, q, k, v, window: int):
    """A planted wrong bf16 flash kernel, causal with a window: where the
    window clips a 128-row query tile's band, the band starts one 64-key
    tile late (the partial tile at the window's edge is lost). Otherwise
    the plain version's arithmetic; rows left with no key read 0."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, s, hkv, hq // hkv, d) * d**-0.5
    out = torch.zeros_like(q)
    for q0 in range(0, s, 128):
        q1 = min(q0 + 128, s)
        lo = max(0, q0 - window + 1) // 64 * 64 \
            + (64 if q0 - window + 1 > 0 else 0)
        if lo >= q1:
            continue
        scores = torch.einsum("bshgd,bthd->bshgt", qf[:, q0:q1],
                              k[:, lo:q1].float())
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(lo, q1, device=q.device)[None, :]
        live = ((kpos <= qpos) & (qpos - kpos < window))[None, :, None, None]
        p = torch.softmax(scores.masked_fill(~live, -1e30), dim=-1) \
            * live.any(-1, keepdim=True)
        o = torch.einsum("bshgt,bthd->bshgd", p, v[:, lo:q1].float())
        out[:, q0:q1] = o.reshape(b, q1 - q0, hq, d).to(q.dtype)
    return out


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(torch) -> None:
    phase("1. device")
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} | capability {cap} | "
          f"{torch.cuda.device_count()} device(s)")
    check(cap >= (9, 0), f"capability {cap} < (9, 0): the kernels are sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")


def ptxas_entries(log: str) -> list[tuple[str, int, int, int]]:
    """(entry function, registers, spill store bytes, spill load bytes) of
    each kernel in an ``nvcc -Xptxas -v`` report."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def phase_build() -> None:
    phase("2. build")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()          # one nvcc per missing source, together
    print(f"built {built or 'nothing (all up to date)'} in "
          f"{time.perf_counter() - t0:.2f}s")
    for name in _build.SOURCES:
        _, so = _build._target(name)
        _build.load(name)
        print(f"{name}: {so.relative_to(ROOT)}")
        log = so.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        if name != "flash_attention":
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    print(f"   {line.strip()}")
            continue
        # the flash entries by name: the bf16 (wgmma) kernels must not spill
        bf16 = []
        for entry, regs, st, ld in ptxas_entries(text):
            m = re.search(r"(flash_attention(?:_bf16)?_kernel)ILi(\d+)E",
                          entry)
            label = f"{m[1]}<{m[2]}>" if m else entry
            print(f"   {label}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")
            if "_bf16_" in label:
                bf16.append((label, st + ld))
        for line in text.splitlines():
            if "Performance Loss" in line:      # wgmma serialised by ptxas
                print(f"   {line.strip()}")
        check(len(bf16) == 3, f"ptxas log names {len(bf16)} bf16 flash "
              "kernels, expected 3 (DP 64, 128, 256)")
        check(all(n == 0 for _, n in bf16), f"bf16 flash kernels spill: {bf16}")


def phase_kernels(torch) -> dict:
    phase("3. kernels against their plain versions")
    from repro_torch.core.compression import quantize_int8_rows
    from repro_torch.kernels import gossip_mix as gm

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def softmax_rows(m, k):
        return torch.softmax(torch.randn((m, k), generator=gen), -1).to(dev)

    errs = {"gossip_mix": 0.0, "gossip_mix_q8": 0.0}

    def hold(name, got, want, tol, what):
        e = err(got, want)
        print(f"{name:14s} {what:44s} max|err| {e:.3e} (tol {tol:g})")
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {what}: {got.shape}/{got.dtype} vs "
              f"{want.shape}/{want.dtype}")
        check(e <= tol, f"{name} {what}: max|err| {e} > {tol}")
        errs[name] = max(errs[name], e)

    # gossip_mix: the TPU signature (M = 1) and the rows form
    for k, n in ((7, 21_840), (9, 3 * 8192 + 5)):
        for dtype, tol in ((torch.float32, TOL_FP32),
                           (torch.bfloat16, TOL_BF16)):
            bufs = randn(k, n).to(dtype)
            w = softmax_rows(1, k)[0]
            hold("gossip_mix", gm.gossip_mix(bufs, w),
                 gm.gossip_mix_rows_plain(w[None], bufs)[0], tol,
                 f"(K={k}, N={n}) {str(dtype)[6:]}")
    for m, k, n in ((N_NODES, N_NODES, 21_840), (N_NODES, 2 * N_NODES, 21_840),
                    (3, 5, 8195)):
        for dtype, tol in ((torch.float32, TOL_FP32),
                           (torch.bfloat16, TOL_BF16)):
            bufs, w = randn(k, n).to(dtype), softmax_rows(m, k)
            hold("gossip_mix", gm.gossip_mix_rows(w, bufs),
                 gm.gossip_mix_rows_plain(w, bufs), tol,
                 f"rows W ({m}x{k}) bufs ({k}x{n}) {str(dtype)[6:]}")
    # a contiguous view 4 bytes off 16-byte alignment: the scalar path
    k, n = 5, 4096
    store = randn(k * n + 1)
    bufs, w = store[1:].view(k, n), softmax_rows(2, k)
    hold("gossip_mix", gm.gossip_mix_rows(w, bufs),
         gm.gossip_mix_rows_plain(w, bufs), TOL_FP32,
         f"rows ({k}x{n}) misaligned view fp32")

    # gossip_mix_q8: the TPU signature and the D-PSGD rows form
    for k, n in ((5, 21_840), (3, 3 * 8192 + 5)):
        q, s = quantize_int8_rows(randn(k, n, scale=4.0))
        x, w = randn(n), softmax_rows(1, k + 1)[0]
        hold("gossip_mix_q8", gm.gossip_mix_q8(x, q, s, w),
             gm.gossip_mix_q8_rows_plain(w[:1], w[None, 1:], x[None], q, s)[0],
             TOL_FP32, f"(K={k}, N={n}, Np={q.shape[1]})")
    n = 21_840
    q, s = quantize_int8_rows(randn(N_NODES, n, scale=0.3))
    x, wfull = randn(N_NODES, n, scale=0.3), softmax_rows(N_NODES, N_NODES)
    w_self = torch.diagonal(wfull).contiguous()
    w_off = wfull - torch.diag(w_self)
    hold("gossip_mix_q8", gm.gossip_mix_q8_rows(w_self, w_off, x, q, s),
         gm.gossip_mix_q8_rows_plain(w_self, w_off, x, q, s), TOL_FP32,
         f"rows n={N_NODES} (N={n}, Np={q.shape[1]})")

    # the ValueError contracts of repro/kernels/gossip_mix.py:143-153
    qz = torch.zeros((2, 4096), dtype=torch.int8, device=dev)
    for what, args, match in (
            ("weights", (torch.zeros(100, device=dev), qz,
                         torch.ones((2, 2), device=dev),
                         torch.ones(4, device=dev) / 4), "weights"),
            ("ragged scales", (torch.zeros(100, device=dev), qz,
                               torch.ones((2, 3), device=dev),
                               torch.ones(3, device=dev) / 3), "scale"),
            ("short payload", (torch.zeros(9000, device=dev), qz,
                               torch.ones((2, 2), device=dev),
                               torch.ones(3, device=dev) / 3), "shorter")):
        before = gm.gossip_mix_q8_rows.launches
        try:
            gm.gossip_mix_q8(*args)
        except ValueError as e:
            check(match in str(e), f"q8 {what}: wrong message {e}")
            check(gm.gossip_mix_q8_rows.launches == before,
                  f"q8 {what}: launched before raising")
            print(f"gossip_mix_q8  ValueError on {what}: ok")
        else:
            fail(f"gossip_mix_q8 accepted a bad {what} on CUDA tensors")
    torch.cuda.synchronize()

    # times at the main path's shapes: "ms" the eager wrapper call, "graph_ms"
    # the call inside a CUDA graph (as the step replays it), each beside the
    # one-call library equivalent timed the same way
    m = k = N_NODES
    n = 21_840
    bufs, w = randn(k, n), softmax_rows(m, k)
    b_ms, b_by = bound(*rows_cost(m, k, n, 4))
    eager_ms, library_ms = paired_ms(
        torch, lambda: gm.gossip_mix_rows(w, bufs),
        lambda: torch.matmul(w, bufs))
    mix = {"ms": eager_ms,
           "plain_ms": time_ms(torch,
                               lambda: gm.gossip_mix_rows_plain(w, bufs)),
           "library_ms": library_ms,
           "graph_ms": graph_ms(torch, lambda: gm.gossip_mix_rows(w, bufs)),
           "library_graph_ms": graph_ms(torch, lambda: torch.matmul(w, bufs)),
           "device_ms": device_ms(torch, lambda: gm.gossip_mix_rows(w, bufs),
                                  "gossip_mix_rows"),
           "bound_ms": b_ms, "bound_by": b_by,
           "shape": f"W ({m}x{k}) fp32, bufs ({k}x{n}) fp32"}
    q, s = quantize_int8_rows(randn(k, n, scale=0.3))
    x = randn(m, n, scale=0.3)
    w_self = torch.diagonal(w).contiguous()
    w_off = w - torch.diag(w_self)
    b_ms, b_by = bound(*q8_cost(m, k, n))
    q8 = {"ms": time_ms(torch, lambda: gm.gossip_mix_q8_rows(
              w_self, w_off, x, q, s)),
          "plain_ms": time_ms(torch, lambda: gm.gossip_mix_q8_rows_plain(
              w_self, w_off, x, q, s)),
          "library_ms": None,
          "graph_ms": graph_ms(torch, lambda: gm.gossip_mix_q8_rows(
              w_self, w_off, x, q, s)),
          "library_graph_ms": None,
          "device_ms": device_ms(torch, lambda: gm.gossip_mix_q8_rows(
              w_self, w_off, x, q, s), "gossip_mix_q8_rows_kernel"),
          "bound_ms": b_ms, "bound_by": b_by,
          "shape": f"self ({m}x{n}) fp32, q ({k}x{q.shape[1]}) int8"}
    for name, t in (("gossip_mix", mix), ("gossip_mix_q8", q8)):
        print_times(name, t)
    against_library("gossip_mix", mix, "torch.matmul")
    launch_path(torch, w, bufs)
    mix["max_abs_err"], q8["max_abs_err"] = errs["gossip_mix"], \
        errs["gossip_mix_q8"]
    return {"gossip_mix": mix, "gossip_mix_q8": q8}


def print_times(name: str, t: dict) -> None:
    """One kernel's times at the path's shape, in microseconds."""
    def us(v):
        return "none" if v is None else f"{v * 1e3:.2f} us"
    dms = "not measured" if t["device_ms"] is None else us(t["device_ms"])
    print(f"{name:15s} {t['shape']}: {us(t['ms'])}/call (device {dms}; in "
          f"a graph {us(t['graph_ms'])}) | plain {us(t['plain_ms'])} | "
          f"library {us(t['library_ms'])} (in a graph "
          f"{us(t['library_graph_ms'])}) | bound {t['bound_ms'] * 1e3:.3f} "
          f"us ({t['bound_by']})")


def against_library(name: str, t: dict, library: str) -> None:
    """Print (host times vary between calls, so nothing fails on them)
    whether a kernel is at or under its one-call library equivalent in a
    graph, and at most 1.5x it as an eager call, both in this run."""
    in_graph = t["graph_ms"] / t["library_graph_ms"]
    eager = t["ms"] / t["library_ms"]
    print(f"{name:15s} against {library}: in a graph {in_graph:.3f}x "
          f"({'at or under' if in_graph <= 1 else 'ABOVE'}), eager "
          f"{eager:.3f}x ({'within' if eager <= 1.5 else 'OVER'} 1.5x)")


def launch_path(torch, w, bufs, calls: int = 10_000) -> None:
    """Where an eager call of the rows mix spends its host time: each piece
    of the call timed alone over ``calls`` calls (time.perf_counter_ns),
    as the wrapper and launch helper did it before the lean launch path
    ("before", rebuilt here for the comparison) and as they do it now
    ("after"). The
    ctypes call launches the kernel each time."""
    from repro_torch.kernels import _backend, _build
    from repro_torch.kernels import gossip_mix as gm

    dev = bufs.device
    m, n = w.shape[0], bufs.shape[1]
    out = torch.empty((m, n), device=dev)
    fn = _build._ENTRIES[("gossip_mix", "gossip_mix_rows_f32")]
    ptrs = (w.data_ptr(), bufs.data_ptr(), out.data_ptr(), m, w.shape[1], n)
    lock = _build._LOCK

    def old_probe():
        return tuple(torch.cuda.get_device_capability(torch.device(dev))) \
            >= (9, 0)

    def old_checks():
        w32 = w.to(torch.float32).contiguous()
        _backend.require_operands(dev, w=w32, bufs=bufs)

    def new_checks():
        _backend.refuse_grad("gossip_mix_rows", w=w, bufs=bufs)
        _backend.require_operands(dev, w=w, bufs=bufs)

    def old_lookup():
        with lock:
            lib = _build._LOADED["gossip_mix"]
        return getattr(lib, "gossip_mix_rows_f32")

    def old_device():
        with torch.cuda.device(dev):
            pass

    def old_call():
        if w.dim() != 2 or bufs.dim() != 2 or w.shape[1] != bufs.shape[0]:
            raise ValueError
        old_probe()
        old_checks()
        o = torch.empty((m, n), dtype=bufs.dtype, device=dev)
        f = old_lookup()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            f(*ptrs[:2], o.data_ptr(), *ptrs[3:], stream)
        return o

    index = dev.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    pieces = (
        ("probe", old_probe, lambda: _backend.use_kernel(dev)),
        ("checks", old_checks, new_checks),
        ("output allocation",
         lambda: torch.empty((m, n), dtype=bufs.dtype, device=dev),
         lambda: torch.empty_like(bufs)),
        ("library lookup (lock, getattr)", old_lookup,
         lambda: _build._ENTRIES.get(("gossip_mix", "gossip_mix_rows_f32"))),
        ("device context", old_device,
         lambda: torch._C._cuda_getDevice() == index),
        ("stream query", lambda: torch.cuda.current_stream(dev).cuda_stream,
         lambda: torch._C._cuda_getCurrentRawStream(index)),
        ("ctypes call (the launch)", lambda: fn(*ptrs, stream),
         lambda: fn(*ptrs, stream)),
        ("whole call", old_call, lambda: gm.gossip_mix_rows(w, bufs)))

    def per_call_us(f):
        for _ in range(100):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            f()
        t = (time.perf_counter_ns() - t0) / calls / 1e3
        torch.cuda.synchronize()
        return t
    print(f"launch path of one gossip_mix_rows call, host us per call over "
          f"{calls} calls (before: the earlier path; after: this one):")
    for label, before, after in pieces:
        b, a = per_call_us(before), per_call_us(after)
        print(f"   {label:32s} before {b:8.3f}  after {a:8.3f}")


def eager_train(torch, params, data, w, steps: int, eta: float = 0.05,
                seed: int = 0):
    """``wireless_dpsgd.train`` with the eager body: the same numpy batch
    draws, each step ``dpsgd.dpsgd_step`` called directly (no graph).
    Returns (params, losses (steps, n), seconds up to the last result)."""
    from repro_torch.core import dpsgd
    from repro_torch.examples import wireless_dpsgd as ex
    from repro_torch.models import cnn

    n = data.x.shape[0]
    w_t = torch.as_tensor(w, dtype=torch.float32, device=data.x.device)
    cfg = dpsgd.DPSGDConfig(eta=eta)
    rng = np.random.default_rng(seed)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        idx = rng.integers(0, data.per_node, size=(n, ex.BATCH))
        params, loss = dpsgd.dpsgd_step(cnn.cnn_loss, params,
                                        ex._batch(data, idx), w_t, cfg)
        losses.append(loss)
    out = torch.stack(losses)
    torch.cuda.synchronize()
    return params, out, time.perf_counter() - t0


def graphed_step_split(torch, step, params, data, w_t,
                       calls: int = 200) -> None:
    """Host time of each piece of a graphed D-PSGD step as train() runs
    it, each timed alone (the card idle before each call, so no piece
    waits on it) over ``calls`` calls: the batch draw and gather, the
    signature (flatten the arguments, key the captured graph), the copy-in
    to the static inputs, the replay, and the outputs' clone."""
    from repro_torch import graphs
    from repro_torch.examples import wireless_dpsgd as ex

    rng = np.random.default_rng(0)

    def draw():
        return ex._batch(data, rng.integers(0, data.per_node,
                                            size=(N_NODES, ex.BATCH)))
    batch = draw()
    leaves, structure = graphs._flatten_args((params, batch, w_t))
    entry = step._entry(w_t.device, leaves, structure)

    def signature():
        lv, st = graphs._flatten_args((params, batch, w_t))
        step._entry(w_t.device, lv, st)

    def host_us(fn):
        total = 0
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            fn()
            total += time.perf_counter_ns() - t0
        torch.cuda.synchronize()
        return total / calls / 1e3
    pieces = [("batch draw and gather", draw), ("signature", signature),
              ("copy-in", lambda: entry.load(leaves)),
              ("replay", entry.graph.replay), ("output clone", entry.fresh),
              ("whole step (the four above)",
               lambda: step(params, batch, w_t))]
    print(f"host us per graphed step, each piece alone over {calls} calls: "
          + ", ".join(f"{label} {host_us(fn):.2f}" for label, fn in pieces))


def phase_slice(torch) -> dict:
    phase("4. slice: the paper run on the card, eager and as a CUDA graph")
    from repro_torch.core import dpsgd, rate_opt
    from repro_torch.examples import wireless_dpsgd as ex
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.models import cnn

    cap = ex.place(N_NODES, EPS)
    t0 = time.perf_counter()
    data = ex.load_data(N_NODES, N_TRAIN, N_TEST, device="cuda")
    print(f"data: {N_TRAIN} train / {N_TEST} test images "
          f"({data.per_node} per node) in {time.perf_counter() - t0:.1f}s")
    # warm-up (cuDNN plans, vmap, a first capture) outside the counted runs
    w_warm = rate_opt.solve(cap, cnn.MODEL_BITS, 0.8).w
    ex.train(ex.init_params(N_NODES, device="cuda"), data, w_warm, 3)
    eager_train(torch, ex.init_params(N_NODES, device="cuda"), data, w_warm,
                3)

    # the same STEPS steps per λ target twice, in turns: the eager body,
    # then the entry point (run_target -> train), whose step is a graph;
    # the pair TIMING_REPEATS times (a shared host stalls a run now and
    # then), every run printed, the medians compared
    results, times, launches = [], [], {"gossip_mix": 0, "gossip_mix_q8": 0}
    for lam_t in ex.LAMBDA_TARGETS:
        w = rate_opt.solve(cap, cnn.MODEL_BITS, lam_t).w
        runs = []
        for rep in range(TIMING_REPEATS):
            e_run = eager_train(torch, ex.init_params(N_NODES, device="cuda"),
                                data, w, STEPS)
            gm.gossip_mix_rows.launches = gm.gossip_mix_q8_rows.launches = 0
            g_run = ex.run_target(cap, lam_t, data, STEPS, verbose=rep == 0)
            torch.cuda.synchronize()
            got = {"gossip_mix": gm.gossip_mix_rows.launches,
                   "gossip_mix_q8": gm.gossip_mix_q8_rows.launches}
            check(got["gossip_mix"] == STEPS, f"gossip_mix launched "
                  f"{got['gossip_mix']} times, want {STEPS}")
            if rep == 0:
                print(f"λ target {lam_t}: launches {got} (gossip_mix "
                      f"expected {STEPS}, one per step)")
                for k in launches:
                    launches[k] += got[k]
            runs.append((e_run, g_run))
        results.append(runs[0][1])
        times.append(([e[2] for e, _ in runs],
                      [g["t_compute_s"] for _, g in runs]))
        print(f"λ target {lam_t}: free-running max|loss diff| (not held): "
              f"graphed vs eager "
              f"{err(runs[0][1]['losses'], runs[0][0][1]):.3e}, two eager "
              f"runs {err(runs[1][0][1], runs[0][0][1]):.3e}, two graphed "
              f"runs {err(runs[1][1]['losses'], runs[0][1]['losses']):.3e}")

    for r, (e_s, g_s) in zip(results, times):
        losses = r["losses"]
        check(losses.shape == (STEPS, N_NODES), f"losses {losses.shape}")
        check(bool(torch.isfinite(losses).all()), "non-finite loss")
        check(0.0 <= r["accuracy"] <= 1.0, f"accuracy {r['accuracy']}")
        first, last = float(losses[:5].mean()), float(losses[-5:].mean())
        check(last < first, f"λ={r['lambda_target']}: loss did not fall "
              f"({first:.4f} -> {last:.4f})")
        g_rate = STEPS / statistics.median(g_s)
        e_rate = STEPS / statistics.median(e_s)
        print(f"λ target {r['lambda_target']}: λ={r['sol'].lam:.4f}, "
              f"t_com={r['t_com_s']:.3f}s for {STEPS} steps, "
              f"accuracy {r['accuracy']:.4f}, loss {first:.4f} -> "
              f"{last:.4f}; compute of {TIMING_REPEATS} runs in turns, "
              f"graphed {', '.join(f'{t:.4f}' for t in g_s)} s, eager "
              f"{', '.join(f'{t:.4f}' for t in e_s)} s; medians "
              f"{g_rate:.2f} vs {e_rate:.2f} steps/s: {g_rate / e_rate:.2f}x "
              f"({'at least' if g_rate >= 4 * e_rate else 'UNDER'} 4x)")

    # graphed against eager on the card, in lockstep: each step starts
    # both from the graphed run's state, on the same batch
    cfg = dpsgd.DPSGDConfig(eta=0.05)
    step = dpsgd.make_dpsgd_step(cnn.cnn_loss, cfg)
    g_loss = g_param = 0.0
    for r in results:
        w_t = torch.as_tensor(r["sol"].w, dtype=torch.float32, device="cuda")
        params = ex.init_params(N_NODES, device="cuda")
        rng = np.random.default_rng(0)
        for _ in range(STEPS):
            b = ex._batch(data, rng.integers(0, data.per_node,
                                             size=(N_NODES, ex.BATCH)))
            p_e, l_e = dpsgd.dpsgd_step(cnn.cnn_loss, params, b, w_t, cfg)
            params, l_g = step(params, b, w_t)
            g_loss = max(g_loss, err(l_g, l_e))
            g_param = max(g_param, max(err(a, c) for a, c in zip(
                dpsgd._leaves(params), dpsgd._leaves(p_e))))
    print(f"graphed vs eager on the card, {STEPS} steps per λ target in "
          f"lockstep: max|loss diff| {g_loss:.3e}, max|param diff| "
          f"{g_param:.3e}")
    check(g_loss <= 1e-4, f"graphed and eager losses differ by {g_loss}")
    check(g_param <= TOL_FP32,
          f"graphed and eager parameters differ by {g_param}")

    # The first steps again on the CPU (plain versions), in lockstep: each
    # step starts card and CPU from the card's state and batch. Run free,
    # the two drift apart at the first near-tie of a max-pool or ReLU whose
    # gradient flips sides (the loss is continuous, its gradient is not),
    # so the free-running gap is printed but not held.
    cpu = ex.NodeData(data.x.cpu(), data.y.cpu(), data.test_x[:1].cpu(),
                      data.test_y[:1].cpu())
    to_cpu = lambda t: dpsgd._tree_map(lambda x: x.cpu(), t)  # noqa: E731
    lock_loss = lock_param = free = 0.0
    for r in results:
        w = r["sol"].w
        params = ex.init_params(N_NODES, device="cuda")
        rng = np.random.default_rng(0)              # train()'s batch stream
        for _ in range(CPU_STEPS):
            idx = rng.integers(0, data.per_node, size=(N_NODES, ex.BATCH))
            p_c, l_c = step(to_cpu(params), ex._batch(cpu, idx), w)
            params, l_g = step(params, ex._batch(data, idx), w)
            lock_loss = max(lock_loss, err(l_g.cpu(), l_c))
            lock_param = max(lock_param, max(
                err(a.cpu(), b) for a, b in zip(dpsgd._leaves(params),
                                                dpsgd._leaves(p_c))))
        _, cpu_losses, _ = ex.train(ex.init_params(N_NODES, device="cpu"),
                                    cpu, w, CPU_STEPS)
        free = max(free, err(cpu_losses, r["losses"][:CPU_STEPS].cpu()))
    print(f"card vs CPU, first {CPU_STEPS} steps in lockstep: max|loss diff| "
          f"{lock_loss:.3e}, max|param diff| {lock_param:.3e}; free-running "
          f"max|loss diff| {free:.3e} (not held)")
    check(lock_loss <= 1e-4, f"card and CPU losses differ by {lock_loss}")
    check(lock_param <= TOL_FP32,
          f"card and CPU mixed parameters differ by {lock_param}")

    # where a graphed step's time goes: the profiler's device busy time
    # over PROFILE_STEPS steps as train() runs them (batch gather, copy-in,
    # replay, the outputs' clone), and the card's time per step from CUDA
    # events around PROFILE_STEPS steps on batches gathered first (the host
    # stays ahead of the card), each against the run's wall time per step
    wall = {"graphed": 1e3 * statistics.median(times[0][1]) / STEPS,
            "eager": 1e3 * statistics.median(times[0][0]) / STEPS}
    w_t = torch.as_tensor(results[0]["sol"].w, dtype=torch.float32,
                          device="cuda")
    params = ex.init_params(N_NODES, device="cuda")
    batches = [ex._batch(data, np.random.default_rng(i).integers(
        0, data.per_node, size=(N_NODES, ex.BATCH)))
        for i in range(PROFILE_STEPS)]
    step.prepare(params, batches[0], w_t)

    def graphed_steps():
        p, rng = params, np.random.default_rng(0)
        for _ in range(PROFILE_STEPS):
            p, _ = step(p, ex._batch(data, rng.integers(
                0, data.per_node, size=(N_NODES, ex.BATCH))), w_t)

    def graphed_on_batches():
        p = params
        for b in batches:
            p, _ = step(p, b, w_t)

    def eager_steps():
        p = params
        for b in batches:
            p, _ = dpsgd.dpsgd_step(cnn.cnn_loss, p, b, w_t, cfg)
    dev_ms = time_ms(torch, graphed_on_batches, reps=1, rounds=5,
                     warmup=2) / PROFILE_STEPS
    # the same step object past its first replays: STEADY_STEPS steps as
    # train() runs them (each run_target captures a fresh step, and its
    # 40 steps include the first replays of that capture)
    p, rng = params, np.random.default_rng(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEADY_STEPS):
        p, _ = step(p, ex._batch(data, rng.integers(
            0, data.per_node, size=(N_NODES, ex.BATCH))), w_t)
    torch.cuda.synchronize()
    steady = 1e3 * (time.perf_counter() - t0) / STEADY_STEPS
    print(f"graphed step: {dev_ms:.4f} ms of card time per step (CUDA "
          f"events over {PROFILE_STEPS} steps on batches gathered first) "
          f"vs {wall['graphed']:.4f} ms wall in the entry point's run (idle "
          f"share {1 - dev_ms / wall['graphed']:.3f}) and {steady:.4f} ms "
          f"wall over {STEADY_STEPS} steps of one prepared step, "
          f"{1e3 / steady:.2f} steps/s (idle share "
          f"{1 - dev_ms / steady:.3f})")
    graphed_step_split(torch, step, params, data, w_t)
    busy = {}
    for label, run in (("graphed", graphed_steps), ("eager", eager_steps)):
        rows = device_profile(torch, run, PROFILE_STEPS)
        if not rows:
            print(f"profile ({label}): no device time in the trace "
                  "(not measured)")
            continue
        busy[label] = sum(r[1] for r in rows)
        print(f"profile of {PROFILE_STEPS} {label} steps: device busy "
              f"{busy[label]:.4f} ms/step in {sum(r[2] for r in rows)} "
              f"launches vs {wall[label]:.4f} ms/step wall, idle share "
              f"{1 - busy[label] / wall[label]:.3f}; top kernels (ms/step):")
        for name, ms, calls in rows[:8]:
            print(f"   {ms:.4f} ms  {calls:3d}x  {name[:90]}")
    return {"cap": cap, "data": data, "results": results,
            "launches": launches}


def phase_compressed(torch, sl: dict) -> int:
    phase("5. compressed path: int8 error feedback, one dead node")
    from repro_torch.core import dpsgd, topology
    from repro_torch.core.compression import QuantConfig, quantize_int8_rows
    from repro_torch.examples import wireless_dpsgd as ex
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.models import cnn

    data, sol = sl["data"], sl["results"][0]["sol"]     # the λ = 0.1 run
    ids = list(range(N_NODES - 1))                      # the last node is dead
    adj = topology.adjacency_from_rates(sl["cap"], sol.rates_bps)
    w = dpsgd.embed_w(topology.paper_w(adj[np.ix_(ids, ids)]), ids, N_NODES)
    live = torch.tensor([i in ids for i in range(N_NODES)], device="cuda")
    step = dpsgd.make_dpsgd_compressed_step(
        cnn.cnn_loss, QuantConfig(mode="int8"), dpsgd.DPSGDConfig(eta=0.05))
    params = ex.init_params(N_NODES, device="cuda")
    res = dpsgd.zero_residuals(params)
    rng = np.random.default_rng(1)

    def batch():
        return ex._batch(data, rng.integers(0, data.per_node,
                                            size=(N_NODES, ex.BATCH)))

    gm.gossip_mix_rows.launches = gm.gossip_mix_q8_rows.launches = 0
    for r in range(COMPRESSED_ROUNDS):
        params, res, losses = step(params, batch(), w, live, res)
    torch.cuda.synchronize()
    launches = gm.gossip_mix_q8_rows.launches
    print(f"{COMPRESSED_ROUNDS} rounds: gossip_mix_q8 launches {launches}, "
          f"losses {[round(float(v), 4) for v in losses]}")
    check(launches == COMPRESSED_ROUNDS,
          f"gossip_mix_q8 launched {launches} times, want {COMPRESSED_ROUNDS}")
    leaves = dpsgd._leaves(params) + dpsgd._leaves(res) + [losses]
    check(all(bool(torch.isfinite(t).all()) for t in leaves),
          "non-finite parameters, residuals or losses")

    # one more step from this state, on the card and on the CPU
    b = batch()
    to_cpu = lambda t: dpsgd._tree_map(lambda x: x.cpu(), t)  # noqa: E731
    p_g, r_g, _ = step(params, b, w, live, res)
    p_c, r_c, _ = step(to_cpu(params), to_cpu(b), w, live.cpu(), to_cpu(res))

    def carried(p, e):
        return (torch.cat([x.reshape(N_NODES, -1) for x in dpsgd._leaves(p)], 1)
                + torch.cat([x.reshape(N_NODES, -1) for x in dpsgd._leaves(e)],
                            1))
    q_g, s_g = quantize_int8_rows(carried(params, res))
    q_c, s_c = quantize_int8_rows(carried(to_cpu(params), to_cpu(res)))
    check(torch.equal(q_g.cpu(), q_c), "int8 payload differs card vs CPU")
    check(torch.equal(s_g.cpu(), s_c), "int8 scales differ card vs CPU")
    e_p = max(err(a.cpu(), c) for a, c in zip(dpsgd._leaves(p_g),
                                              dpsgd._leaves(p_c)))
    e_r = max(err(a.cpu(), c) for a, c in zip(dpsgd._leaves(r_g),
                                              dpsgd._leaves(r_c)))
    dead = all(torch.equal(a[-1], b_[-1]) for a, b_ in
               zip(dpsgd._leaves(p_g), dpsgd._leaves(params)))
    print(f"card vs CPU, one step: q bit-equal, params max|diff| {e_p:.3e}, "
          f"residuals {e_r:.3e}, dead node carried verbatim: {dead}")
    check(e_p <= 1e-5 and e_r <= 1e-5, "compressed step differs card vs CPU")
    check(dead, "the dead node's parameters changed")
    return launches


def phase_attention_kernels(torch) -> dict:
    phase("3b. flash_attention and rglru_scan against their plain versions")
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_attention": 0.0, "rglru_scan": 0.0}
    tol = {torch.float32: TOL_FLASH_FP32, torch.bfloat16: TOL_BF16}

    def hold(name, got, want, tol, what):
        e = err(got, want)
        print(f"{name:15s} {what:58s} max|err| {e:.3e} (tol {tol:g})")
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {what}: {got.shape}/{got.dtype} vs "
              f"{want.shape}/{want.dtype}")
        check(e <= tol, f"{name} {what}: max|err| {e} > {tol}")
        errs[name] = max(errs[name], e)

    def qkv(b, s, hq, hkv, d, dtype):
        return tuple(torch.randn((b, s, h, d), generator=gen, device=dev
                                 ).to(dtype) for h in (hq, hkv, hkv))

    # the slice's prefill shape, then edge shapes: ragged S, D in
    # {16, 64, 80, 128}, window 0 causal and not, Hq == Hkv, bands that skip;
    # the bf16 (wgmma) kernel also at its tile edges (128 query rows, 64
    # keys a block): S = T of 1, 63, 129, 200 and 4097, windows 1, 33, 64,
    # 100 and 2048, D of 16 to 256, GQA groups 1, 2 and 10, causal off
    main = (SERVE_BATCH, SERVE_PROMPT, 10, 1, 256, True, 2048)
    bf16 = torch.bfloat16
    cases = [(*main, bf16), (*main, torch.float32),
             (2, 33, 4, 2, 64, True, 0, torch.float32),
             (2, 80, 4, 1, 16, True, 32, torch.float32),
             (2, 130, 8, 2, 64, True, 48, bf16),
             (1, 257, 4, 4, 128, True, 0, torch.float32),
             (1, 65, 4, 4, 80, True, 0, torch.float32),
             (2, 100, 4, 2, 64, False, 0, torch.float32),
             (2, 100, 4, 2, 16, False, 0, bf16),
             (2, 1, 4, 2, 64, True, 0, bf16),
             (2, 63, 4, 4, 80, True, 33, bf16),
             (1, 129, 10, 1, 128, True, 1, bf16),
             (2, 200, 4, 2, 16, True, 64, bf16),
             (1, 200, 10, 1, 256, False, 100, bf16),
             (2, 129, 4, 2, 64, False, 0, bf16),
             (1, 63, 2, 1, 256, True, 2048, bf16),
             (1, 4097, 10, 1, 256, True, 2048, bf16),
             (1, 4097, 2, 2, 128, True, 0, bf16)]
    for b, s, hq, hkv, d, causal, window, dtype in cases:
        q, k, v = qkv(b, s, hq, hkv, d, dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        what = (f"({b},{s},{hq}/{hkv},{d}) causal={causal} w={window} "
                f"{str(dtype)[6:]}")
        hold("flash_attention", got, want, tol[dtype], what)
        if dtype != bf16:
            continue
        e = row_err(got, want)
        print(f"{'':15s} {what:58s} row |err|/|want| {e:.3e} "
              f"(tol {TOL_FLASH_ROW:g})")
        check(e <= TOL_FLASH_ROW,
              f"flash_attention {what}: row error {e} > {TOL_FLASH_ROW}")
        if causal and 1 < window <= (s - 1) // 128 * 128:
            # the bar's power: planted wrong kernels that lose the window's
            # edge tile (a query tile past the first one has its band
            # clipped), or one key of each full window
            for wrong, bad in (
                    ("edge tile dropped",
                     flash_edge_tile_dropped(torch, q, k, v, window)),
                    ("window one key short", fa.flash_attention_plain(
                        q, k, v, causal=True, window=window - 1))):
                e_bad = row_err(bad, want)
                print(f"{'':15s} {'planted wrong kernel: ' + wrong:58s} "
                      f"row |err|/|want| {e_bad:.3e}, max|err| "
                      f"{err(bad, want):.3e}")
                check(e_bad > TOL_FLASH_ROW,
                      f"the row bar passes a wrong kernel ({wrong}) at "
                      f"{what}")
    for d, dtype in ((320, torch.float32), (20, bf16)):
        before = fa.flash_attention.launches
        try:
            fa.flash_attention(*qkv(1, 8, 2, 1, d, dtype))
        except ValueError as e:
            check("head_dim" in str(e), f"head_dim {d}: wrong message {e}")
            check(fa.flash_attention.launches == before,
                  "launched before raising")
            print(f"flash_attention ValueError on head_dim {d} "
                  f"{str(dtype)[6:]}: ok ({e})")
        else:
            fail(f"flash_attention accepted head_dim {d} in {dtype}")

    for b, s, d, with_h0 in ((SERVE_BATCH, SERVE_PROMPT, 2560, True),
                             (SERVE_BATCH, 1, 2560, True),
                             (3, 37, 100, False), (2, 70, 100, True)):
        a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=dev))
        x = torch.randn((b, s, d), generator=gen, device=dev)
        h0 = torch.randn((b, d), generator=gen, device=dev) if with_h0 \
            else None
        got = rg.rglru_scan(a, x, h0)
        torch.cuda.synchronize()
        hold("rglru_scan", got, rg.rglru_scan_plain(a, x, h0), TOL_RGLRU,
             f"({b},{s},{d}) h0={with_h0}")

    # times at the slice's shapes: flash in bf16 (the served dtype) and
    # fp32; rglru at the prefill (S = 4096) and decode (S = 1) shapes
    out = {}
    b, s, hq, hkv, d, causal, window = main
    qpos = torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(s, device=dev)[None, :]
    band = (kpos <= qpos) & (qpos - kpos < window)
    for dtype, elt, peak, kname in (
            (torch.bfloat16, 2, BF16_FLOPS, "flash_attention_bf16_kernel"),
            (torch.float32, 4, FP32_FLOPS, "flash_attention_kernel")):
        q, k, v = qkv(b, s, hq, hkv, d, dtype)

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=band, enable_gqa=True)
        lib_err = err(library().transpose(1, 2), kernel())
        nbytes, flops = flash_cost(b, s, hq, hkv, d, window, elt)
        b_ms, b_by = bound(nbytes, flops, peak)
        out[str(dtype)[6:]] = {
            "ms": time_ms(torch, kernel, reps=10, rounds=3, warmup=2),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, window=window), reps=2, rounds=3,
                warmup=1),
            "library_ms": time_ms(torch, library, reps=10, rounds=3,
                                  warmup=2),
            "device_ms": device_ms(torch, kernel, kname, calls=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"q ({b},{s},{hq},{d}) k/v ({b},{s},{hkv},{d}) "
                     f"{str(dtype)[6:]}, causal, window {window}"}
        t = out[str(dtype)[6:]]
        dev_t = t["device_ms"] if t["device_ms"] is not None else t["ms"]
        print(f"flash_attention {t['shape']}: library "
              f"(scaled_dot_product_attention, band mask) vs kernel "
              f"max|diff| {lib_err:.3e}; {flops:.4e} flops over the band: "
              f"{flops / dev_t / 1e9:.1f} TFLOP/s "
              f"({'device' if t['device_ms'] is not None else 'per call'}), "
              f"{b_ms / dev_t * 100:.1f} % of the bound; library "
              f"{t['library_ms']:.4f} ms in this run")
    flash = dict(out["bfloat16"], fp32=out["float32"])
    for b, s, d, reps in ((SERVE_BATCH, SERVE_PROMPT, 2560, 1),
                          (SERVE_BATCH, 1, 2560, 100)):
        a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=dev))
        x = torch.randn((b, s, d), generator=gen, device=dev)
        h0 = torch.randn((b, d), generator=gen, device=dev)
        b_ms, b_by = bound(*rglru_cost(b, s, d))
        out[s] = {
            "ms": time_ms(torch, lambda: rg.rglru_scan(a, x, h0), reps=20),
            # the plain version is a Python loop over time: at S = 4096,
            # 3 rounds of 1 call after 1 warm-up call
            "plain_ms": time_ms(torch, lambda: rg.rglru_scan_plain(a, x, h0),
                                reps=reps, rounds=3, warmup=1),
            "library_ms": None,
            "device_ms": device_ms(torch, lambda: rg.rglru_scan(a, x, h0),
                                   "rglru_scan_kernel", calls=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"a, b ({b},{s},{d}) fp32, h0 ({b},{d})"}
    rglru = dict(out[SERVE_PROMPT], decode=out[1])
    for name, t in (("flash_attention", flash),
                    ("flash_attention", flash["fp32"]),
                    ("rglru_scan", rglru), ("rglru_scan", rglru["decode"])):
        dms = "not measured" if t["device_ms"] is None \
            else f"{t['device_ms']:.4f} ms"
        lib = "none" if t["library_ms"] is None \
            else f"{t['library_ms']:.4f} ms"
        print(f"{name:15s} {t['shape']}: {t['ms']:.4f} ms/call "
              f"(device {dms}) | plain {t['plain_ms']:.4f} ms | library "
              f"{lib} | bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    flash["max_abs_err"] = errs["flash_attention"]
    rglru["max_abs_err"] = errs["rglru_scan"]
    return {"flash_attention": flash, "rglru_scan": rglru}


def phase_rwkv_kernel(torch) -> dict:
    phase("3c. rwkv6_scan against its plain version")
    from repro_torch.kernels import rwkv6_scan as rw

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0

    def inputs(b, s, h, d):
        """Drawn as tests/test_kernels.py:110-114 draws them, plus s0."""
        r, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn((b, s, h, d), generator=gen,
                                             device=dev) * 0.5))
        u = torch.randn((h, d), generator=gen, device=dev) * 0.1
        s0 = torch.randn((b, h, d, d), generator=gen, device=dev)
        return r, k, v, w, u, s0

    # the served shape (B = 4, S = 4096, H = 64, D = 64), then edge shapes:
    # S in {1, 33}, D in {8, 16, 32}, H = 1
    cfg = (SERVE_BATCH, SERVE_PROMPT, 64, 64)
    cases = [(*cfg, True), (*cfg, False)] + [
        (2, s, 1, d, d != 16) for s in (1, 33) for d in (8, 16, 32)]
    for b, s, h, d, with_s0 in cases:
        r, k, v, w, u, s0 = inputs(b, s, h, d)
        s0 = s0 if with_s0 else None
        y, st = rw.rwkv6_scan(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        want_y, want_s = rw.rwkv6_scan_plain(r, k, v, w, u, s0, RWKV_CHUNK)
        check(y.shape == want_y.shape and st.shape == want_s.shape
              and y.dtype == st.dtype == torch.float32,
              f"rwkv6_scan ({b},{s},{h},{d}): {y.shape}/{st.shape}")
        e = max(err(y, want_y), err(st, want_s))
        print(f"rwkv6_scan     ({b},{s},{h},{d}) s0={with_s0!s:5s} "
              f"max|err| y and state {e:.3e} (tol {TOL_RWKV:g})")
        check(e <= TOL_RWKV, f"rwkv6_scan ({b},{s},{h},{d}): max|err| {e}")
        worst = max(worst, e)
    # the handoff decode reads: the kernel's final state after S steps and
    # one plain step (models.rwkv6.wkv_step) against the kernel's own
    # output and state after S + 1 steps, at the served heads
    from repro_torch.models.rwkv6 import wkv_step

    r, k, v, w, u, _ = inputs(SERVE_BATCH, SERVE_PROMPT + 1, 64, 64)
    y_all, s_all = rw.rwkv6_scan(r, k, v, w, u)
    _, s_pre = rw.rwkv6_scan(*(x[:, :-1] for x in (r, k, v, w)), u)
    s_next, y_next = wkv_step(s_pre, r[:, -1], k[:, -1], v[:, -1], w[:, -1],
                              u)
    e = max(err(y_next, y_all[:, -1]), err(s_next, s_all))
    print(f"rwkv6_scan     handoff: state after {SERVE_PROMPT} steps + one "
          f"plain step vs the kernel over {SERVE_PROMPT + 1}: max|err| "
          f"{e:.3e} (tol {TOL_RWKV:g})")
    check(e <= TOL_RWKV, f"rwkv6_scan handoff: max|err| {e}")

    r, k, v, w, u, s0 = inputs(1, 4, 2, 16)
    wide = [torch.ones((1, 2, 1, 136), device=dev) for _ in range(4)]
    for what, args, match in (
            ("mismatched shapes", (r, k[:, :3], v, w, u), "one shape"),
            ("a bf16 state", (r, k, v, w, u, s0.to(torch.bfloat16)),
             "float32"),
            ("head size 136", (*wide, torch.ones((1, 136), device=dev)),
             "head size")):
        before = rw.rwkv6_scan.launches
        try:
            rw.rwkv6_scan(*args)
        except ValueError as e:
            check(match in str(e), f"rwkv6_scan {what}: wrong message {e}")
            check(rw.rwkv6_scan.launches == before,
                  f"rwkv6_scan {what}: launched before raising")
            print(f"rwkv6_scan     ValueError on {what}: ok")
        else:
            fail(f"rwkv6_scan accepted {what} on CUDA tensors")

    # time at the served shape, with s0 (prefill passes the cache's zeros)
    r, k, v, w, u, s0 = inputs(*cfg)
    b_ms, b_by = bound(*rwkv_cost(*cfg))
    out = {"ms": time_ms(torch, lambda: rw.rwkv6_scan(r, k, v, w, u, s0),
                         reps=20),
           "plain_ms": time_ms(torch, lambda: rw.rwkv6_scan_plain(
               r, k, v, w, u, s0, RWKV_CHUNK), reps=1, rounds=3, warmup=1),
           "library_ms": None,
           "device_ms": device_ms(torch, lambda: rw.rwkv6_scan(
               r, k, v, w, u, s0), "rwkv6_scan_kernel", calls=10),
           "bound_ms": b_ms, "bound_by": b_by,
           "shape": "r, k, v, w (%d,%d,%d,%d) fp32, s0 (%d,%d,%d,%d)"
                    % (*cfg, cfg[0], cfg[2], cfg[3], cfg[3]),
           "max_abs_err": worst}
    dms = "not measured" if out["device_ms"] is None \
        else f"{out['device_ms']:.4f} ms"
    print(f"rwkv6_scan     {out['shape']}: {out['ms']:.4f} ms/call (device "
          f"{dms}) | plain (chunk {RWKV_CHUNK}) {out['plain_ms']:.4f} ms | "
          f"library none | bound {b_ms:.4f} ms ({b_by})")
    return {"rwkv6_scan": out}


def phase_quantize_kernels(torch) -> dict:
    phase("3d. quantize_int8 and dequantize_int8 against their plain versions")
    from repro_torch.core import compression as comp
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def same(what, got, want):
        """Check ``got`` bit-equal to ``want``; max|err| of each pair."""
        ok = all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
                 for a, b in zip(got, want))
        print(f"quantize       {what:62s} bit-equal: {ok}")
        check(ok, f"int8 codec {what}: kernel and plain version differ")
        return [err(a, b) for a, b in zip(got, want)]

    def randn(rows, length, scale=3.0, dtype=torch.float32):
        return (torch.randn((rows, length), generator=gen, device=dev)
                * scale).to(dtype)

    # the TPU kernels' contract through ops (256-lane blocks, ragged C,
    # fp32 and bf16 inputs, fp32 and bf16 outputs)
    for rows, c in ((8, 512), (5, 700), (16, 256), (N_NODES, 21_840)):
        for dtype in (torch.float32, bf16):
            x = randn(rows, c, dtype=dtype)
            q, s = ops.quantize_int8(x)
            qp, sp = qz.quantize_int8_plain(x, 256)
            outs = [ops.dequantize_int8(q, s, dt) for dt in (torch.float32,
                                                            bf16)]
            want = [qz.dequantize_int8_plain(qp, sp, 256, c, dt)
                    for dt in (torch.float32, bf16)]
            torch.cuda.synchronize()
            same(f"ops ({rows}, {c}) {str(dtype)[6:]} in, fp32/bf16 out",
                 [q, s, *outs], [qp[:, :c], sp, *want])
    # the wire format (2048-lane blocks) through core.compression, at the
    # path's message and at ragged lengths
    for rows, length in ((N_NODES, 21_840), (N_NODES, 21_843), (3, 2049),
                         (1, 1)):
        x = randn(rows, length, scale=0.3)
        q, s = comp.quantize_int8_rows(x)
        d = comp.dequantize_int8_rows(q, s, length)
        qp, sp = qz.quantize_int8_plain(x, 2048)
        dp = qz.dequantize_int8_plain(qp, sp, 2048, length)
        torch.cuda.synchronize()
        e = same(f"wire format ({rows}, {length}) fp32", [q, s, d],
                 [qp, sp, dp])
        if (rows, length) == (N_NODES, 21_840):     # the path's message
            errs = {"quantize_int8": max(e[:2]), "dequantize_int8": e[2]}
    # the ValueError contracts, raised before any launch
    qz8 = torch.zeros((2, 512), dtype=torch.int8, device=dev)
    for what, call, match in (
            ("a 3-lane scale block", lambda: qz.quantize_int8(
                randn(2, 9), 3), "scale block"),
            ("a 1-D input", lambda: qz.quantize_int8(randn(1, 9)[0]), "2-D"),
            ("an fp16 input", lambda: qz.quantize_int8(
                randn(2, 9, dtype=torch.float16)), "float32 or bfloat16"),
            ("3 scales for 2 blocks", lambda: qz.dequantize_int8(
                qz8, torch.ones((2, 3), device=dev)), "one per block"),
            ("a length past the payload", lambda: qz.dequantize_int8(
                qz8, torch.ones((2, 2), device=dev), length=600), "fit")):
        before = (qz.quantize_int8.launches, qz.dequantize_int8.launches)
        try:
            call()
        except ValueError as e:
            check(match in str(e), f"int8 codec {what}: wrong message {e}")
            check((qz.quantize_int8.launches, qz.dequantize_int8.launches)
                  == before, f"int8 codec {what}: launched before raising")
            print(f"quantize       ValueError on {what}: ok")
        else:
            fail(f"int8 codec accepted {what} on CUDA tensors")

    # times: at the path's message, (6, 21 840) fp32 in 2048-lane blocks,
    # and at (64, 1 048 576) fp32, large enough to read the HBM rate (both
    # formats; printed only). Dequantize's library call is one broadcast
    # multiply of the int8 payload by its scales, trimmed by a view (timed
    # here only; quantize has no single-call equivalent)
    out = {}
    for rows, length, block, reps in ((N_NODES, 21_840, 2048, 100),
                                      (64, 1 << 20, 2048, 10),
                                      (64, 1 << 20, 256, 10)):
        x = randn(rows, length, scale=0.3)
        q, s = qz.quantize_int8(x, block)

        def library():
            return (q.view(rows, -1, block) * s[..., None]).view(
                rows, -1)[:, :length]
        lib_err = err(library(), qz.dequantize_int8(q, s, block, length))
        print(f"dequantize_int8 ({rows}, {length}), {block}-lane blocks: "
              f"library (int8 payload * scales) vs kernel max|diff| "
              f"{lib_err:.3e}")
        for name, kernel, plain, lib, cost, kname in (
                ("quantize_int8", lambda: qz.quantize_int8(x, block),
                 lambda: qz.quantize_int8_plain(x, block), None,
                 quantize_cost(rows, length, block, 4),
                 "quantize_int8_kernel"),
                ("dequantize_int8",
                 lambda: qz.dequantize_int8(q, s, block, length),
                 lambda: qz.dequantize_int8_plain(q, s, block, length),
                 library, dequantize_cost(rows, length, block, 4),
                 "dequantize_int8_kernel")):
            b_ms, b_by = bound(*cost)
            path = rows == N_NODES      # the path's shape: the JSON row
            eager_ms, lib_ms = (time_ms(torch, kernel, reps=reps), None) \
                if lib is None else paired_ms(torch, kernel, lib, reps=reps)
            t = {"ms": eager_ms,
                 "plain_ms": time_ms(torch, plain, reps=reps),
                 "library_ms": lib_ms,
                 "graph_ms": graph_ms(torch, kernel) if path else None,
                 "library_graph_ms": graph_ms(torch, lib)
                 if path and lib is not None else None,
                 "device_ms": device_ms(torch, kernel, kname, calls=reps),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "max_abs_err": errs[name],
                 "shape": f"({rows}, {length}) fp32, {block}-lane blocks"}
            print_times(name, t)
            if t["device_ms"] is not None:
                print(f"{'':15s} device rate "
                      f"{cost[0] / t['device_ms'] / 1e9:.1f} TB/s")
            if path:
                out[name] = t
    against_library("dequantize_int8", out["dequantize_int8"],
                    "int8 payload * scales")
    return out


def phase_serve(torch, title: str, arch: str, counters: dict, want: dict,
                why: str) -> dict:
    """Serve ``arch`` at its published widths at (SERVE_BATCH,
    SERVE_PROMPT, SERVE_GEN) in bf16 through ``launch.serve.generate``;
    ``counters`` are the kernel wrappers of its path, each of which must
    launch exactly ``want[name]`` times."""
    phase(title)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import build, transformer

    cfg = get_config(arch)
    kinds = transformer.layer_kinds(cfg)
    mix = ", ".join(f"{kinds.count(k)} {k}" for k in sorted(set(kinds)))
    print(f"{cfg.name}: {cfg.n_layers} layers ({mix}), d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, window {cfg.window}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype} compute, {cfg.param_dtype} "
          f"weights; batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
          f"{SERVE_GEN} tokens")
    # warm-up at the same widths (cuBLAS handles, the allocator's pools)
    serve.generate(cfg, batch=SERVE_BATCH, prompt_len=WARM_PROMPT, gen=2,
                   device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    for fn in counters.values():
        fn.launches = 0
    out = serve.generate(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                         gen=SERVE_GEN, device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"launches: {launches} (expected {want}: {why})")
    check(launches == want, f"launches {launches}, want {want}")
    tokens, logits = out["tokens"], out["logits"]
    check(tuple(tokens.shape) == (SERVE_BATCH, SERVE_GEN),
          f"tokens {tuple(tokens.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "non-finite logits")
    print(f"prefill {out['prefill_s']:.4f} s ({SERVE_BATCH} x {SERVE_PROMPT} "
          f"tokens), decode {out['decode_s']:.4f} s for {SERVE_GEN - 1} "
          f"steps = {out['tok_per_s']:.2f} tok/s, peak device memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes); sample "
          f"{tokens[0, :8].tolist()}")

    # where the time goes: one profiled prefill, then DECODE_PROFILE_STEPS
    # decode steps timed on the host clock and again under the profiler
    api = build(cfg, "cuda")
    rng = torch.Generator(device="cuda").manual_seed(1)
    params = serve.serving_params(cfg, api.init(rng))
    print(f"parameters: {sum(t.numel() for t in tree_leaves(params))}")
    inputs = api.make_inputs(ShapeConfig("serve", SERVE_PROMPT, SERVE_BATCH,
                                         "prefill"), rng,
                             batch_override=SERVE_BATCH)
    max_len = SERVE_PROMPT + 2 * DECODE_PROFILE_STEPS + 1
    state = {}

    def prefill():
        state["logits"], state["cache"] = api.prefill(params, inputs,
                                                      max_len=max_len)
    rows = device_profile(torch, prefill, 1)
    if not rows:
        print("prefill profile: no device time in the trace (not measured)")
    else:
        print(f"profile of one prefill: device busy "
              f"{sum(r[1] for r in rows):.4f} ms; top device operations "
              f"(ms, launches):")
        for name, ms, calls in rows[:10]:
            print(f"   {ms:9.4f} ms  {calls:4d}x  {name[:90]}")

    def decode(start):
        tok = torch.argmax(state["logits"], -1)
        for i in range(DECODE_PROFILE_STEPS):
            state["logits"], state["cache"] = api.decode_step(
                params, tok, state["cache"], start + i)
            tok = torch.argmax(state["logits"], -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode(SERVE_PROMPT)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / DECODE_PROFILE_STEPS
    drows = device_profile(torch, lambda: decode(
        SERVE_PROMPT + DECODE_PROFILE_STEPS), DECODE_PROFILE_STEPS)
    idle = None
    if not drows:
        print("decode profile: no device time in the trace (not measured)")
    else:
        dbusy = sum(r[1] for r in drows)
        idle = 1 - dbusy / wall_ms
        print(f"decode, {DECODE_PROFILE_STEPS} steps: device busy "
              f"{dbusy:.4f} ms/step in {sum(r[2] for r in drows)} launches "
              f"vs {wall_ms:.4f} ms/step wall, idle share {idle:.3f}; top "
              f"device operations (ms/step, launches/step):")
        for name, ms, calls in drows[:8]:
            print(f"   {ms:9.4f} ms  {calls:4d}x  {name[:90]}")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": out["prefill_s"],
            "tok_per_s": out["tok_per_s"], "peak_bytes": peak,
            "decode_idle_share": idle}


def phase_served_correctness(torch, title: str, arch: str, counters: dict,
                             lock_cfg, lock_tol: float,
                             shape_noise: bool = False) -> None:
    """(a) fp32 teacher forcing of ``arch`` at full width and depth; (b)
    card against CPU in lockstep at ``lock_cfg``, held at ``lock_tol``.
    Both must launch every kernel of ``counters``. With ``shape_noise``,
    (a) also measures what the GEMMs' shapes alone change (see there)."""
    phase(title)
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build, transformer

    def ran():
        return {name: fn.launches for name, fn in counters.items()}

    # (a) teacher forcing at full width and depth, in fp32 (same widths,
    # only the compute type differs): prefill (the kernels) and decode
    # (plain torch: the ring-buffer einsum, the one-token WKV step) against
    # apply's logits at the same positions. fp32 end to end (TF32 off):
    # held at tests/test_serve.py's 2e-4, room for summation order over the
    # layers (2.4e-5 measured on an H100 for recurrentgemma-2b), not for a
    # wrong band, ring or carried state.
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    api = build(cfg, "cuda")
    rng = torch.Generator(device="cuda").manual_seed(2)
    params = api.init(rng)
    tokens = torch.randint(0, cfg.vocab_size, (1, TF_PROMPT + TF_STEPS),
                           generator=rng, device="cuda")
    for fn in counters.values():
        fn.launches = 0
    logits, cache = api.prefill(params, {"tokens": tokens[:, :TF_PROMPT]},
                                max_len=TF_PROMPT + TF_STEPS)
    served = [logits]
    for i in range(TF_STEPS):
        logits, cache = api.decode_step(params, tokens[:, TF_PROMPT + i],
                                        cache, TF_PROMPT + i)
        served.append(logits)
    full = transformer.apply(cfg, params, tokens)
    errs = [err(got, full[:, TF_PROMPT - 1 + i])
            for i, got in enumerate(served)]
    scale = float(full[:, TF_PROMPT - 1:].abs().max())
    print(f"(a) {cfg.name} fp32, batch 1, prompt {TF_PROMPT}, {TF_STEPS} "
          f"decode steps: max|served - apply| per position "
          f"{[f'{e:.3e}' for e in errs]} (logits up to {scale:.3f}); "
          f"launches {ran()}")
    bar = 2e-4
    if shape_noise:
        # A model that amplifies rounding (rwkv6-7b's random weights at
        # full depth) moves its logits when only the GEMMs' row counts
        # change (cuBLAS picks another kernel and summation order). apply
        # over the prompt alone has the prefill's shapes: the prefill is
        # held to it at 2e-4. apply over the prompt against apply over the
        # whole sequence, at the prompt's last position, is the same
        # computation with other shapes: that floor bounds the decode
        # steps, whose one-row GEMMs no apply shares. The carried state
        # itself is held exactly in phase 3c (the handoff check).
        short = transformer.apply(cfg, params, tokens[:, :TF_PROMPT])[:, -1]
        same = err(served[0], short)
        floor = err(short, full[:, TF_PROMPT - 1])
        bar = 2e-4 + 3 * floor
        print(f"    prefill vs apply over the prompt alone (same shapes): "
              f"{same:.3e}; apply vs apply, shapes only (the floor): "
              f"{floor:.3e}; decode held at 2e-4 + 3 x floor = {bar:.3e}")
        check(same <= 2e-4, f"prefill differs from apply over the same "
              f"prompt by {same}")
        del short
    check(max(errs) <= bar, f"served logits differ from apply by {errs}")
    check(all(n > 0 for n in ran().values()),
          "teacher forcing did not run the kernels")
    del params, cache, full, served
    torch.cuda.empty_cache()

    # (b) card (kernels) against CPU (plain versions) in lockstep at the
    # smoke widths. Each decode step starts both from the card's cache.
    # fp32 on both sides, held at the bar of the path's loosest kernel.
    cfg = lock_cfg
    params_c = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                       "cpu")
    params_g = tree_to(params_c, "cuda")
    api_c, api_g = build(cfg, "cpu"), build(cfg, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (LOCK_BATCH, LOCK_PROMPT),
                           generator=torch.Generator().manual_seed(4))
    max_len = LOCK_PROMPT + LOCK_STEPS + 1
    for fn in counters.values():
        fn.launches = 0
    lg, cg = api_g.prefill(params_g, {"tokens": tokens.cuda()},
                           max_len=max_len)
    lc, cc = api_c.prefill(params_c, {"tokens": tokens}, max_len=max_len)
    worst = {"logits": err(lg.cpu(), lc),
             "cache": max(err(a.cpu(), b) for a, b in
                          zip(tree_leaves(cg), tree_leaves(cc)))}
    for i in range(LOCK_STEPS):
        tok = torch.argmax(lg, -1)
        lg, cg_next = api_g.decode_step(params_g, tok, cg, LOCK_PROMPT + i)
        lc, cc = api_c.decode_step(params_c, tok.cpu(), tree_to(cg, "cpu"),
                                   LOCK_PROMPT + i)
        cg = cg_next
        worst["logits"] = max(worst["logits"], err(lg.cpu(), lc))
        worst["cache"] = max(worst["cache"], max(
            err(a.cpu(), b) for a, b in zip(tree_leaves(cg),
                                            tree_leaves(cc))))
    print(f"(b) {cfg.name} ({cfg.n_layers} layers, window {cfg.window}), "
          f"batch {LOCK_BATCH}, prompt {LOCK_PROMPT}, {LOCK_STEPS} decode "
          f"steps, card vs CPU in lockstep: max|logits diff| "
          f"{worst['logits']:.3e}, max|cache diff| {worst['cache']:.3e} "
          f"(tol {lock_tol:g}); card launches {ran()}")
    check(worst["logits"] <= lock_tol and worst["cache"] <= lock_tol,
          f"card and CPU differ: {worst}")
    check(all(n > 0 for n in ran().values()),
          "the card side did not run the kernels")


def phase_simulated_training(torch) -> dict:
    phase("10. training through the wireless simulator on the card")
    from repro_torch.core import dpsgd
    from repro_torch.core.compression import quantize_int8_rows
    from repro_torch.data import SyntheticFashion
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.kernels import quantize as qz
    from repro_torch.models import cnn
    from repro_torch.sim import (WirelessSimulator, get_scenario,
                                 simulate_dpsgd_cnn)

    counters = {"quantize_int8": qz.quantize_int8,
                "dequantize_int8": qz.dequantize_int8,
                "gossip_mix_q8": gm.gossip_mix_q8_rows,
                "gossip_mix": gm.gossip_mix_rows}
    t0 = time.perf_counter()
    ds = SyntheticFashion(n_train=N_TRAIN, n_test=N_TEST, seed=0)
    print(f"data: {N_TRAIN} train / {N_TEST} test images in "
          f"{time.perf_counter() - t0:.1f}s")
    # warm-up (cuDNN plans, vmap) at the same widths, outside the counted runs
    simulate_dpsgd_cnn(get_scenario("compressed_int8"), epochs=1,
                       n_train=1200, n_test=300, device="cuda")
    torch.cuda.synchronize()

    # the first SIM_CPU_ROUNDS compressed steps of the graphed run are
    # captured (the card's inputs and outputs) for the lockstep rerun on
    # the CPU below
    captured = []
    builders = {name: getattr(dpsgd, name) for name in (
        "make_dpsgd_step", "make_dpsgd_masked_step",
        "make_dpsgd_compressed_step")}
    factory = builders["make_dpsgd_compressed_step"]

    def capturing(*args, **kw):
        step = factory(*args, **kw)

        def run(params, batch, w, live, res):
            out = step(params, batch, w, live, res)
            if len(captured) < SIM_CPU_ROUNDS:
                captured.append(((params, batch, w, live, res), out))
            return out
        run.prepare = step.prepare
        return run

    # the "before" run: each builder returns its eager body (a plain
    # function, which simulate_dpsgd_cnn calls without a capture), for the
    # comparison only
    eager = {
        "make_dpsgd_step": lambda loss_fn, config=dpsgd.DPSGDConfig(): (
            lambda p, b, w: dpsgd.dpsgd_step(loss_fn, p, b, w, config)),
        "make_dpsgd_masked_step":
            lambda loss_fn, config=dpsgd.DPSGDConfig(): (
                lambda p, b, w, live: dpsgd.dpsgd_masked_step(
                    loss_fn, p, b, w, live, config)),
        "make_dpsgd_compressed_step":
            lambda loss_fn, quant, config=dpsgd.DPSGDConfig(): (
                lambda p, b, w, live, res: dpsgd.dpsgd_masked_compressed_step(
                    loss_fn, p, b, w, live, res, quant, config))}

    out = {}
    for name, variant in (("compressed_int8", "eager"),
                          ("compressed_int8", "graphed"),
                          ("static", "eager"), ("static", "graphed")):
        label = f"{name} ({variant})"
        cfg = get_scenario(name)
        patch = dict(eager) if variant == "eager" else \
            {"make_dpsgd_compressed_step": capturing}
        for attr, fn in patch.items():
            setattr(dpsgd, attr, fn)
        try:
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            trace, params = simulate_dpsgd_cnn(
                cfg, epochs=SIM_EPOCHS, ds=ds, measure_compute=True,
                device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
        finally:
            for attr, fn in builders.items():
                setattr(dpsgd, attr, fn)
        s = trace.summary()
        rounds = s["rounds"]
        compressed = cfg.payload.mode == "int8"
        want = ({"quantize_int8": rounds, "dequantize_int8": rounds,
                 "gossip_mix_q8": rounds, "gossip_mix": 0} if compressed else
                {"quantize_int8": 0, "dequantize_int8": 0,
                 "gossip_mix_q8": 0, "gossip_mix": rounds})
        print(f"{label}: launches {launches} (expected {want})")
        check(launches == want, f"{label}: launches {launches}, want {want}")
        check(rounds == SIM_EPOCHS * N_TRAIN // N_NODES // 25,
              f"{label}: {rounds} rounds")
        check(all(np.isfinite(r.loss) for r in trace.records),
              f"{label}: non-finite loss")
        check(all(bool(torch.isfinite(x).all())
                  for x in dpsgd._leaves(params)),
              f"{label}: non-finite parameters")
        check(s["final_acc"] is not None and 0.0 <= s["final_acc"] <= 1.0,
              f"{label}: accuracy {s['final_acc']}")

        # the communication plane: the CPU simulator, charged the card's
        # measured compute per round (fading blocks follow the simulated
        # clock), must realize the very same rounds
        computes = [r.t_compute_s for r in trace.records]
        replay = WirelessSimulator(cfg).run(
            rounds, lambda ctx: {"compute_s": computes[ctx.round]})
        fields = ("round", "n_live", "t_start_s", "t_comm_s", "t_end_s",
                  "lam_planned", "lam_effective", "feasible",
                  "intended_links", "outage_links", "retx_packets",
                  "delivered_frac", "replanned", "mean_drift", "wire_bits",
                  "payload_mode")
        diff = [(a.round, f) for a, b in zip(trace.records, replay.records)
                for f in fields if getattr(a, f) != getattr(b, f)]
        print(f"{label}: communication fields of {rounds} rounds equal to the "
              f"CPU simulator's: {not diff}")
        check(not diff and len(replay.records) == rounds,
              f"{label}: the trace's communication differs from the CPU's at "
              f"{diff[:5]}")
        t_plan = time.perf_counter()
        sim = WirelessSimulator(cfg)           # the initial Algorithm 2 plan
        t_sim = time.perf_counter()
        sim.run(rounds)
        sim_ms = (time.perf_counter() - t_sim) * 1e3 / rounds
        plan_s = t_sim - t_plan
        step_ms = s["total_compute_s"] * 1e3 / rounds
        wall_ms = wall * 1e3 / rounds
        print(f"{label}: {rounds} rounds, simulated {s['t_end_s']:.4f} s "
              f"(communication {s['total_comm_s']:.4f} s + the card's "
              f"measured compute {s['total_compute_s']:.4f} s), outage "
              f"{s['outage_rate']:.4f}, final accuracy {s['final_acc']:.4f}, "
              f"loss {trace.records[0].loss:.4f} -> "
              f"{trace.records[-1].loss:.4f}")
        print(f"{label}: host {wall_ms:.4f} ms per round = simulator "
              f"{sim_ms:.4f} (driver-less run, after a {plan_s:.4f} s "
              f"initial plan) + step {step_ms:.4f} (synchronized) + the rest "
              f"{wall_ms - sim_ms - step_ms:.4f} (batch gather, evaluation "
              f"every {cfg.eval_every_rounds} rounds on {N_TEST} images)")
        split = {"host_ms": wall_ms, "step_ms": step_ms, "sim_ms": sim_ms}
        out.setdefault(name, {})[variant] = split
        if variant == "graphed":
            out[name]["launches"] = launches
    for name in ("compressed_int8", "static"):
        e, g = out[name]["eager"], out[name]["graphed"]
        print(f"{name}: host ms per round graphed {g['host_ms']:.4f} vs "
              f"eager {e['host_ms']:.4f} "
              f"({'below' if g['host_ms'] < e['host_ms'] else 'NOT below'});"
              f" step {g['step_ms']:.4f} vs {e['step_ms']:.4f} ms")

    # the first compressed rounds again on the CPU (plain versions), in
    # lockstep: each from the card's input state
    check(len(captured) == SIM_CPU_ROUNDS, f"captured {len(captured)} rounds")
    to_cpu = lambda t: dpsgd._tree_map(lambda x: x.cpu(), t)  # noqa: E731
    step = factory(cnn.cnn_loss, get_scenario("compressed_int8").payload,
                   dpsgd.DPSGDConfig(eta=0.05))    # simulate_dpsgd_cnn's eta
    worst = {"loss": 0.0, "params": 0.0, "residuals": 0.0}
    for (params, batch, w, live, res), (p_g, r_g, l_g) in captured:
        p_c, r_c, l_c = step(to_cpu(params), to_cpu(batch), w, live.cpu(),
                             to_cpu(res))
        worst["loss"] = max(worst["loss"], err(l_g.cpu(), l_c))
        worst["residuals"] = max(worst["residuals"], max(
            err(a.cpu(), b) for a, b in zip(dpsgd._leaves(r_g),
                                            dpsgd._leaves(r_c))))
        worst["params"] = max(worst["params"], max(
            err(a.cpu(), b) for a, b in zip(dpsgd._leaves(p_g),
                                            dpsgd._leaves(p_c))))

        def carried(p, e):
            return torch.cat([(a + b).reshape(len(l_c), -1) for a, b in
                              zip(dpsgd._leaves(p), dpsgd._leaves(e))], 1)
        q_g, s_g = quantize_int8_rows(carried(params, res))
        q_c, s_c = quantize_int8_rows(carried(to_cpu(params), to_cpu(res)))
        check(torch.equal(q_g.cpu(), q_c) and torch.equal(s_g.cpu(), s_c),
              "int8 payload or scales differ card vs CPU")
    print(f"compressed_int8, first {SIM_CPU_ROUNDS} rounds card vs CPU in "
          f"lockstep: q and scales bit-equal, max|loss diff| "
          f"{worst['loss']:.3e}, max|param diff| {worst['params']:.3e}, "
          f"max|residual diff| {worst['residuals']:.3e}")
    check(worst["loss"] <= 1e-4, f"card and CPU losses differ: {worst}")
    check(worst["params"] <= TOL_FP32 and worst["residuals"] <= TOL_FP32,
          f"card and CPU parameters or residuals differ: {worst}")
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    t_start = time.perf_counter()
    walls = []

    def run(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls.append((label, time.perf_counter() - t0))
        print(f"-- phase {label}: {walls[-1][1]:.2f} s wall", flush=True)
        return out

    run("1", phase_device, torch)
    run("2", phase_build)
    kernels = run("3", phase_kernels, torch)
    kernels.update(run("3b", phase_attention_kernels, torch))
    kernels.update(run("3c", phase_rwkv_kernel, torch))
    kernels.update(run("3d", phase_quantize_kernels, torch))
    sl = run("4", phase_slice, torch)
    q8_launches = run("5", phase_compressed, torch, sl)

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.models import transformer

    kinds = transformer.layer_kinds(get_config(SERVE_ARCH))
    n_attn = sum(k in ("global", "local") for k in kinds)
    n_rec = kinds.count("rglru")
    griffin = {"flash_attention": fa.flash_attention,
               "rglru_scan": rg.rglru_scan}
    served = run("6", phase_serve, torch,
                 "6. serving slice: recurrentgemma-2b at full width on the "
                 "card", SERVE_ARCH, griffin,
                 {"flash_attention": n_attn, "rglru_scan": n_rec * SERVE_GEN},
                 f"flash once per attention layer in prefill, rglru once "
                 f"per recurrent layer in prefill and in each of "
                 f"{SERVE_GEN - 1} decode steps")
    run("7", phase_served_correctness, torch,
        "7. correctness of the served path", SERVE_ARCH, griffin,
        reduce_for_smoke(get_config(SERVE_ARCH)), TOL_RGLRU)
    n_rwkv = get_config(RWKV_ARCH).n_layers
    served_rwkv = run("8", phase_serve, torch,
                      "8. serving rwkv6-7b at full width on the card",
                      RWKV_ARCH, {"rwkv6_scan": rw.rwkv6_scan},
                      {"rwkv6_scan": n_rwkv},
                      "rwkv6_scan once per layer in prefill, none in the "
                      f"{SERVE_GEN - 1} decode steps (the one-token step is "
                      "plain torch)")
    run("9", phase_served_correctness, torch,
        "9. correctness of the served rwkv path", RWKV_ARCH,
        {"rwkv6_scan": rw.rwkv6_scan},
        dataclasses.replace(reduce_for_smoke(get_config(RWKV_ARCH)),
                            n_layers=LOCK_RWKV_LAYERS), TOL_RWKV, True)
    simulated = run("10", phase_simulated_training, torch)
    int8_run = simulated["compressed_int8"]["launches"]

    rows = []
    for name, source, replaces, launches in (
            ("gossip_mix", "gossip_mix", "gossip_mix.py:62",
             sl["launches"]["gossip_mix"]),
            ("gossip_mix_q8", "gossip_mix", "gossip_mix.py:109",
             q8_launches),
            ("flash_attention", "flash_attention", "flash_attention.py:105",
             served["launches"]["flash_attention"]),
            ("rglru_scan", "rglru_scan", "rglru_scan.py:59",
             served["launches"]["rglru_scan"]),
            ("rwkv6_scan", "rwkv6_scan", "rwkv6_scan.py:87",
             served_rwkv["launches"]["rwkv6_scan"]),
            ("quantize_int8", "quantize", "quantize.py:53",
             int8_run["quantize_int8"]),
            ("dequantize_int8", "quantize", "quantize.py:85",
             int8_run["dequantize_int8"])):
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "graph_ms": k.get("graph_ms"),
            "library_graph_ms": k.get("library_graph_ms"),
            "device_ms": k["device_ms"], "shape": k["shape"]})
        if name == "flash_attention":    # the fp32 entry at the same shape
            rows[-1]["fp32"] = {f: k["fp32"][f] for f in (
                "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")}
    print("\nphase wall times: " + ", ".join(f"{label} {sec:.2f} s"
                                             for label, sec in walls))
    print(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(nvidia_smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
