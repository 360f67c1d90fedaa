#!/usr/bin/env python3
"""Chip smoke of the PyTorch / H100 port (``src/repro_torch``).

Drives the port's main path — the paper's wireless D-PSGD run: Eq. 2
capacities, Algorithm 2 rates at λ targets {0.1, 0.8}, then the full
21 840-parameter CNN trained with D-PSGD on 6 nodes at batch 25 over the
60 000-image synthetic set — on one NVIDIA Hopper card, through the
entry points a user calls, with every gossip mix in the hand-written CUDA
kernels of ``src/repro_torch/csrc/gossip_mix.cu``. Phases, each of which
ends the run with a nonzero exit if it fails:

1. device   — a CUDA card of compute capability >= (9, 0); TF32 off for
              matmuls and cuDNN convolutions, so fp32 means fp32;
2. build    — nvcc builds every kernel from the sources into ``build/``;
3. kernels  — each kernel against its plain torch version at the main
              path's shapes and at edge shapes, its ValueError contracts,
              and its time beside its bound, plain and library times;
4. slice    — the paper run; the gossip_mix launch counter must grow by
              one launch per step, and the first 5 steps rerun on the CPU
              (plain versions) from the card's state must agree on losses
              to 1e-4 and on the mixed parameters to 1e-5;
5. compressed — 4 rounds of int8 error-feedback D-PSGD with one dead
              node; the gossip_mix_q8 counter must grow, and one more step
              must agree with the CPU (q bit-equal, parameters to 1e-5).

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON line with every kernel's numbers, and ``{"ok": true, "device": ...}``.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
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
COMPRESSED_ROUNDS = 4
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOPS = 67e12                   # H100 SXM, fp32 outside tensor cores
TOL_FP32, TOL_BF16 = 1e-5, 3e-2      # tests/test_kernels.py


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

def time_ms(torch, fn, reps: int = 100, rounds: int = 5) -> float:
    """CUDA events around ``reps`` back-to-back calls, after warm-up; the
    median over ``rounds`` of the per-call mean (>= 500 calls in all)."""
    for _ in range(10):
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on an H100 SXM: bytes over HBM rate vs fp32 flops over
    the fp32 peak, whichever is larger (ms, and which one binds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
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


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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


def phase_build() -> None:
    phase("2. build")
    from repro_torch.kernels import _build

    _, so = _build._target("gossip_mix")
    built = not so.exists()
    t0 = time.perf_counter()
    _build.load("gossip_mix")
    print(f"gossip_mix: built={built} in {time.perf_counter() - t0:.2f}s -> "
          f"{so.relative_to(ROOT)}")
    log = so.with_suffix(".log")
    for line in (log.read_text() if log.exists() else "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"   {line.strip()}")


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

    # times at the main path's shapes
    m = k = N_NODES
    n = 21_840
    bufs, w = randn(k, n), softmax_rows(m, k)
    b_ms, b_by = bound(*rows_cost(m, k, n, 4))
    mix = {"ms": time_ms(torch, lambda: gm.gossip_mix_rows(w, bufs)),
           "plain_ms": time_ms(torch,
                               lambda: gm.gossip_mix_rows_plain(w, bufs)),
           "library_ms": time_ms(torch, lambda: torch.matmul(w, bufs)),
           "device_ms": device_ms(torch, lambda: gm.gossip_mix_rows(w, bufs),
                                  "gossip_mix_rows_kernel"),
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
          "device_ms": device_ms(torch, lambda: gm.gossip_mix_q8_rows(
              w_self, w_off, x, q, s), "gossip_mix_q8_rows_kernel"),
          "bound_ms": b_ms, "bound_by": b_by,
          "shape": f"self ({m}x{n}) fp32, q ({k}x{q.shape[1]}) int8"}
    for name, t in (("gossip_mix", mix), ("gossip_mix_q8", q8)):
        dms = "not measured" if t["device_ms"] is None \
            else f"{t['device_ms'] * 1e3:.2f} us"
        lib = "none" if t["library_ms"] is None \
            else f"{t['library_ms'] * 1e3:.2f} us"
        print(f"{name:14s} {t['shape']}: {t['ms'] * 1e3:.2f} us/call "
              f"(device {dms}) | plain {t['plain_ms'] * 1e3:.2f} us | "
              f"library {lib} | bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_by']})")
    mix["max_abs_err"], q8["max_abs_err"] = errs["gossip_mix"], \
        errs["gossip_mix_q8"]
    return {"gossip_mix": mix, "gossip_mix_q8": q8}


def phase_slice(torch) -> dict:
    phase("4. slice: the paper run on the card")
    from repro_torch.core import dpsgd, rate_opt
    from repro_torch.examples import wireless_dpsgd as ex
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.models import cnn

    cap = ex.place(N_NODES, EPS)
    t0 = time.perf_counter()
    data = ex.load_data(N_NODES, N_TRAIN, N_TEST, device="cuda")
    print(f"data: {N_TRAIN} train / {N_TEST} test images "
          f"({data.per_node} per node) in {time.perf_counter() - t0:.1f}s")
    # warm-up (cuDNN plans, vmap) outside the counted run
    ex.train(ex.init_params(N_NODES, device="cuda"), data,
             rate_opt.solve(cap, cnn.MODEL_BITS, 0.8).w, 3)

    gm.gossip_mix_rows.launches = gm.gossip_mix_q8_rows.launches = 0
    results = [ex.run_target(cap, lam_t, data, STEPS)
               for lam_t in ex.LAMBDA_TARGETS]
    torch.cuda.synchronize()
    launches = {"gossip_mix": gm.gossip_mix_rows.launches,
                "gossip_mix_q8": gm.gossip_mix_q8_rows.launches}
    want = STEPS * len(results)           # one mix launch per step
    print(f"launches: {launches} (gossip_mix expected {want})")
    check(launches["gossip_mix"] == want,
          f"gossip_mix launched {launches['gossip_mix']} times, want {want}")

    for r in results:
        losses = r["losses"]
        check(losses.shape == (STEPS, N_NODES), f"losses {losses.shape}")
        check(bool(torch.isfinite(losses).all()), "non-finite loss")
        check(0.0 <= r["accuracy"] <= 1.0, f"accuracy {r['accuracy']}")
        first, last = float(losses[:5].mean()), float(losses[-5:].mean())
        check(last < first, f"λ={r['lambda_target']}: loss did not fall "
              f"({first:.4f} -> {last:.4f})")
        print(f"λ target {r['lambda_target']}: λ={r['sol'].lam:.4f}, "
              f"t_com={r['t_com_s']:.3f}s for {STEPS} steps, "
              f"accuracy {r['accuracy']:.4f}, compute "
              f"{r['t_compute_s']:.4f}s, {STEPS / r['t_compute_s']:.2f} "
              f"steps/s, loss {first:.4f} -> {last:.4f}")

    # The first steps again on the CPU (plain versions), in lockstep: each
    # step starts card and CPU from the card's state and batch. Run free,
    # the two drift apart at the first near-tie of a max-pool or ReLU whose
    # gradient flips sides (the loss is continuous, its gradient is not),
    # so the free-running gap is printed but not held.
    cpu = ex.NodeData(data.x.cpu(), data.y.cpu(), data.test_x[:1].cpu(),
                      data.test_y[:1].cpu())
    step = dpsgd.make_dpsgd_step(cnn.cnn_loss, dpsgd.DPSGDConfig(eta=0.05))
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

    # where a step's time goes: device busy time from a profiler trace of
    # PROFILE_STEPS steps against the host-clock step time of the run
    wall_ms = 1e3 * min(r["t_compute_s"] / STEPS for r in results)
    rows = device_profile(torch, lambda: ex.train(
        ex.init_params(N_NODES, device="cuda"), data, results[0]["sol"].w,
        PROFILE_STEPS), PROFILE_STEPS)
    if not rows:
        print("profile: no device time in the trace (not measured)")
    else:
        busy_ms = sum(r[1] for r in rows)
        print(f"profile of {PROFILE_STEPS} steps: device busy {busy_ms:.4f} "
              f"ms/step vs {wall_ms:.4f} ms/step wall, idle share "
              f"{1 - busy_ms / wall_ms:.3f}; top kernels (ms/step):")
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


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    t0 = time.perf_counter()
    phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch)
    sl = phase_slice(torch)
    q8_launches = phase_compressed(torch, sl)

    rows = []
    for name, replaces, launches in (
            ("gossip_mix", "src/repro/kernels/gossip_mix.py:62",
             sl["launches"]["gossip_mix"]),
            ("gossip_mix_q8", "src/repro/kernels/gossip_mix.py:109",
             q8_launches)):
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/gossip_mix.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "device_ms": k["device_ms"], "shape": k["shape"]})
    print(f"\nall phases passed in {time.perf_counter() - t0:.1f}s")
    print(nvidia_smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
