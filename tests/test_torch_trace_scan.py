"""The scan trace engine (``repro_torch.sim.jit_trace`` over
``kernels.trace_scan``) against the JAX package's own scan engine on the
CPU.

The reference's ``precompute_trace_scan`` imports
``jax.experimental.enable_x64``, which this jax no longer has; the tests
put the context manager ``jax.enable_x64(True)`` there for their own run
(``monkeypatch``), so the reference's compiled round loop runs unchanged
and the port is held against it field for field, fading included:
``delivered``, ``retx`` and ``w_eff`` equal, times within 1e-12 relative
(the reference sums a transmitter's airtimes with ``d.sum()``, the port
takes the running sum's last element, which may associate differently in
the last bits). The splitmix64 hash is bit-equal, on inputs whose top
bit is set too (where an arithmetic shift would differ from a logical
one); the gains -log1p(-u) agree to the two libraries' log1p. A numpy
model of the CUDA kernel's algorithm (receiver lists and integer
thresholds, tiles of packets with the running sum carried across them,
the pass that sends nothing ending a transmitter, decodes filtered by the
thresholds with the exact formula inside the band) is held equal to the
plain version here, since the kernel itself only runs on the card
(``tests/test_torch_kernels_card.py``, ``chip_smoke.py`` phase 21); the
filter's decision is held against the exact formula at the thresholds,
at the flip point and at random draws.
"""
import dataclasses
import functools
import operator
import re

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from examples import sim_scenarios as r_example
from repro.core import dpsgd as r_dpsgd
from repro.sim import batch as r_batch
from repro.sim import jit_trace as r_jit
from repro.sim import scenario as r_scenario
from repro_torch.convert import params_to_numpy
from repro_torch.examples import sim_scenarios as t_example
from repro_torch.kernels import trace_scan as ts
from repro_torch.sim import batch as t_batch
from repro_torch.sim import jit_trace as t_jit
from repro_torch.sim import scenario as t_scenario
from repro_torch.sim import trace as t_trace
from test_torch_batch import (BATCH, ETA, N_NODES, ROUNDS, TOL, TRAIN_KW,
                              _jax_init, _np_tree, _patch_init, _reached,
                              _record_steps, _shards)
from test_torch_sim import _same
from test_torch_sim_train import _capture, _host

RTOL_T = 1e-12
FIELDS = ("w_eff", "live", "active", "t_start_s", "t_comm_s", "t_end_s",
          "wire_bits")
TIMES = ("t_start_s", "t_comm_s", "t_end_s")
NO_SHADOW = {"fading.shadowing_sigma_db": 0.0}


@pytest.fixture
def x64(monkeypatch):
    """The reference's scan engine, runnable under this jax."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _cfgs(name, **kw):
    if name != "static":
        kw = {**NO_SHADOW, **kw}
    return (r_scenario.get_scenario(name, **kw),
            t_scenario.get_scenario(name, **kw))


def _close(a, b, rtol=RTOL_T):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(
        np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1e-300)))


# ---------------------------------------------------------------------------
# splitmix64
# ---------------------------------------------------------------------------

def _u64_inputs(seed):
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 2**64, size=257, dtype=np.uint64)
    z[:6] = [0, 1, 2**63, 2**63 - 1, 2**64 - 1, 0x9E3779B97F4A7C15]
    return z


@pytest.mark.parametrize("dtype", ["uint64", "int64"])
def test_mix64_bit_equal_to_reference(dtype):
    z = _u64_inputs(1).view(dtype)
    with jax.enable_x64(True):
        want = np.asarray(r_jit._mix64(jnp.asarray(z.view(np.uint64))))
    got = ts._mix64(torch.from_numpy(z.view(np.int64).copy()))
    assert np.array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("seed", [0, 7, 2**63 + 5, 2**64 - 1])
def test_rayleigh_gains_match_reference(seed):
    """The uniforms bit-equal to the reference's hash; the gains
    -log1p(-u) within 1e-13 relative: XLA's log1p on the CPU is up to ~120
    ulps from torch's (measured over 600 000 draws), the one place the two
    packages' decodes may part, at a near-tie of capacity and rate."""
    blocks = _u64_inputs(2)[:40].view(np.int64)   # negative: top bit set
    blocks[6:12] = np.arange(6)
    for i, n in ((0, 5), (3, 9), (8, 9)):
        with jax.enable_x64(True):
            j = jnp.arange(n)
            pair = (jnp.minimum(i, j) * n
                    + jnp.maximum(i, j)).astype(jnp.uint64)
            b = r_jit._mix64(jnp.uint64(seed & (2**64 - 1)) ^ r_jit._mix64(
                jnp.asarray(blocks).astype(jnp.uint64)))
            h = r_jit._mix64(b[:, None] ^ pair[None, :])
            u_want = np.asarray((h >> jnp.uint64(11)) * (2.0 ** -53))
            g_want = np.asarray(r_jit._rayleigh_gains(
                seed, jnp.asarray(blocks), i, n))
        t_blocks = torch.from_numpy(blocks.copy())
        u = ts._uniforms(seed, t_blocks, i, n)
        assert u.dtype == torch.float64
        assert np.array_equal(u.numpy(), u_want), (i, n)
        g = ts._rayleigh_gains(seed, t_blocks, i, n)
        assert _close(g.numpy(), g_want, rtol=1e-13), (i, n)


# ---------------------------------------------------------------------------
# The round loop against the reference's compiled one
# ---------------------------------------------------------------------------

def _inputs(name, n, **kw):
    cfg = t_scenario.get_scenario(
        name, n_nodes=n, **({} if name == "static" else NO_SHADOW), **kw)
    return t_jit.scan_inputs(cfg, t_trace.WirelessSimulator(cfg))


LOOP_CASES = [("static", 6, "renorm", 3), ("static", 6, "naive", 0),
              ("fading", 6, "renorm", 3), ("fading", 6, "naive", 0),
              ("fading", 12, "renorm", 0), ("fading", 12, "naive", 3)]


@pytest.mark.parametrize("name,n,degrade,retx", LOOP_CASES)
def test_round_scan_plain_matches_reference_round_scan(name, n, degrade,
                                                       retx):
    arrays, kw = _inputs(name, n, degrade=degrade,
                         **{"mac.max_retx_rounds": retx})
    rounds = 3
    fn = r_jit._round_scan(n, kw["n_pkts"], kw["passes"], kw["fading_on"],
                           kw["coherence_s"], kw["bandwidth_hz"],
                           kw["overhead_s"], kw["compute_s"], degrade,
                           kw["seed"], rounds)
    with jax.enable_x64(True):
        want = [np.asarray(x) for x in fn(*arrays)]
    got = [x.numpy() for x in ts.round_scan_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        n_rounds=rounds, **kw)]
    w, t0, tc, dl, rx, te = got
    assert dl.dtype == bool and np.array_equal(dl, want[3])
    assert rx.dtype == np.int64 and np.array_equal(rx, want[4])
    assert w.dtype == np.float64 and np.array_equal(w, want[0])
    for a, b in ((t0, want[1]), (tc, want[2]), (te, want[5])):
        assert _close(a, b)
    if name == "fading" and retx:
        assert rx.sum() > 0                       # retransmissions in play
    assert ts.round_scan.launches == 0


@pytest.mark.parametrize("name", ["static", "fading", "compressed_int8"])
@pytest.mark.parametrize("n", [6, 128])
def test_precompute_trace_scan_matches_reference(x64, name, n):
    """Every ``TrainTrace`` field and every ``RoundRecord`` field; at n =
    128 the effective densities come from ``spectral_lambda_iter_batch``
    (above ``ITERATIVE_MIN_N`` = 96)."""
    cfg_r, cfg_t = _cfgs(name, n_nodes=n)
    want = r_jit.precompute_trace_scan(cfg_r, 3)
    got = t_jit.precompute_trace_scan(cfg_t, 3, device="cpu")
    assert (got.scenario, got.n_nodes) == (want.scenario, want.n_nodes)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f
        assert (_close(a, b) if f in TIMES else np.array_equal(a, b)), f
    assert _same(got.cfg, want.cfg)
    for ra, rb in zip(got.trace.records, want.trace.records, strict=True):
        for f in ("t_start_s", "t_comm_s"):
            assert _close(getattr(ra, f), getattr(rb, f)), f
        assert _same(dataclasses.replace(ra, t_start_s=rb.t_start_s,
                                         t_comm_s=rb.t_comm_s), rb)
    assert _close(got.trace.t_end_s, want.trace.t_end_s)
    assert (got.trace.replans, got.trace.failures,
            got.trace.events_processed) == (0, [], 3)
    if name != "static":
        assert sum(r.retx_packets for r in got.trace.records) > 0


def test_static_scan_matches_the_event_loop():
    """The twin of tests/test_scale.py's: Eq. 3 to association order."""
    ev = t_trace.precompute_trace("static", 6)
    sc = t_trace.precompute_trace("static", 6, engine="scan", device="cpu")
    assert np.array_equal(sc.w_eff, ev.w_eff)
    assert np.array_equal(sc.live, ev.live)
    assert (np.abs(sc.t_comm_s - ev.t_comm_s) / ev.t_comm_s).max() < 1e-9
    assert sc.trace.records[0].outage_links == 0


@pytest.mark.parametrize("name", r_scenario.list_scenarios())
def test_scan_eligibility_matches_reference(x64, name):
    """``scan_unsupported_reason`` string-equal to the reference's, and the
    same ``ValueError`` from both engines on an ineligible scenario."""
    cfg_r, cfg_t = (r_scenario.get_scenario(name),
                    t_scenario.get_scenario(name))
    reason = t_jit.scan_unsupported_reason(cfg_t)
    assert reason == r_jit.scan_unsupported_reason(cfg_r)
    if reason is None:
        return
    with pytest.raises(ValueError) as want:
        r_jit.precompute_trace_scan(cfg_r, 2)
    with pytest.raises(ValueError) as got:
        t_jit.precompute_trace_scan(cfg_t, 2, device="cpu")
    assert str(got.value) == str(want.value)


def test_auto_engine_falls_back_or_scans():
    """``engine="auto"``: the event loop on an ineligible scenario (it
    raised for every scenario before), the scan engine on an eligible one;
    any other engine is refused before any work."""
    tr = t_trace.precompute_trace("churn", 3, engine="auto", device="cpu")
    ev = t_trace.precompute_trace("churn", 3)
    for f in FIELDS:
        assert np.array_equal(getattr(tr, f), getattr(ev, f)), f
    assert tr.n_rounds == 3
    auto = t_trace.precompute_trace("fading", 3, engine="auto", device="cpu",
                                    **NO_SHADOW)
    scan = t_jit.precompute_trace_scan("fading", 3, device="cpu", **NO_SHADOW)
    for f in FIELDS:
        assert np.array_equal(getattr(auto, f), getattr(scan, f)), f
    with pytest.raises(ValueError, match="engine"):
        t_trace.precompute_trace("static", 2, engine="warp")
    batch = t_trace.precompute_traces(["static", "churn"], 2, engine="auto",
                                      device="cpu")
    assert batch.w_eff.shape == (2, 2, 6, 6)


def test_scan_engine_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: t_jit.precompute_trace_scan("static", 2),
                 lambda: t_trace.precompute_trace("static", 2, engine="scan"),
                 lambda: t_example.main(["--scale", "12", "--rounds", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_sim_handed_over_must_match_cfg():
    cfg = t_scenario.get_scenario("static")
    sim = t_trace.WirelessSimulator(cfg)
    tr = t_jit.precompute_trace_scan(cfg, 2, sim=sim, device="cpu")
    assert np.array_equal(
        tr.w_eff, t_jit.precompute_trace_scan(cfg, 2, device="cpu").w_eff)
    with pytest.raises(ValueError, match="sim="):
        t_jit.precompute_trace_scan(cfg.replace(seed=1), 2, sim=sim,
                                    device="cpu")
    zero = t_jit.precompute_trace_scan(cfg, 0, device="cpu")
    assert zero.w_eff.shape == (0, 6, 6) and zero.trace.t_end_s == 0.0


# ---------------------------------------------------------------------------
# The kernel's algorithm, modelled on the CPU
# ---------------------------------------------------------------------------

def _mix64_np(z):
    with np.errstate(over="ignore"):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _thresholds_np(snr, rate, bw):
    """csrc/trace_scan.cu's ``fade_threshold`` in numpy: (m_lo, m_hi) on
    the grid of m = h >> 11 around u* = -expm1(-g*), the whole range where
    the band is not sound or a value is not finite."""
    last = float(2**53 - 1)
    with np.errstate(all="ignore"):
        x = np.expm1(rate / bw * np.log(2.0))
        g = bw * x / snr
        u = -np.expm1(-g)
        lo = np.floor(u * (1.0 - ts.BAND) * 2.0**53)
        hi = np.ceil(u * (1.0 + ts.BAND) * 2.0**53)
    ok = ((snr > 0) & np.isfinite(snr) & (x >= ts.MIN_X) & np.isfinite(x)
          & np.isfinite(g) & np.isfinite(lo) & np.isfinite(hi))
    return (np.where(ok, np.maximum(lo, 0.0), 0.0).astype(np.int64),
            np.where(ok, np.minimum(hi, last), last).astype(np.int64))


def _kernel_model(rates, sizes, recv, chan, *, n_pkts, passes, fading_on,
                  coherence_s, bandwidth_hz, overhead_s, compute_s, seed,
                  n_rounds, tile_words=None):
    """csrc/trace_scan.cu's algorithm in numpy, step for step: each row's
    receiver list and (fading) its pairs' integer thresholds; per pass the
    send mask the OR of the receivers' need bits, the first pass with
    nothing to send ending the transmitter's passes; the packets tile by
    tile (``tile_words`` words of 64, the launch's layout by default), the
    running sum over a tile's sent packets carried from tile to tile in
    packet order, one block hash per sent packet, and a decode for each
    sent packet a receiver still needs: m = h >> 11 below m_lo fails,
    above m_hi decodes, in between the exact formula (counted). Vectorised
    within a tile. Every filtered decision is also held against the exact
    formula. Returns delivered, t_start, t_comm, retx, t_end, the counts
    (passes run, decodes decided) and the exact-path count."""
    n = len(rates)
    tile = 64 * (tile_words or ts._layout(n, n_pkts)[0])
    lists = [np.flatnonzero(recv[i]) for i in range(n)]
    thr = [_thresholds_np(chan[i, lst], rates[i], bandwidth_hz)
           if fading_on else None for i, lst in enumerate(lists)]
    delivered = np.zeros((n_rounds, n, n), bool)
    t_start, t_comm = np.zeros(n_rounds), np.zeros(n_rounds)
    retx = np.zeros(n_rounds, np.int64)
    clock, steps, pairs, banded = np.float64(0.0), 0, 0, 0
    for r in range(n_rounds):
        start = clock
        for i in range(n):
            rate = rates[i]
            if not (np.isfinite(rate) and rate > 0):
                continue
            lst = lists[i]
            need = np.ones((n_pkts, len(lst)), bool)
            durs = sizes / rate + overhead_s
            pair = (np.minimum(i, lst) * n + np.maximum(i, lst)).astype(
                np.uint64)
            for p in range(passes):
                send = np.ones(n_pkts, bool) if p == 0 else need.any(1)
                if not send.any():
                    break
                steps += 1
                if p > 0:
                    retx[r] += send.sum()
                cs = np.float64(0.0)
                for k0 in range(0, n_pkts, tile):
                    sent = k0 + np.flatnonzero(send[k0:k0 + tile])
                    if not sent.size:
                        continue
                    d = durs[sent]
                    run = np.cumsum(np.concatenate([[cs], d]))[1:]
                    ttx = clock + (run - d)
                    cs = run[-1]
                    nb = need[sent]
                    pairs += int(nb.sum())
                    if fading_on:
                        blk = np.floor(ttx / coherence_s).astype(np.int64)
                        bk = _mix64_np(np.uint64(seed)
                                       ^ _mix64_np(blk.view(np.uint64)))
                        m = (_mix64_np(bk[:, None] ^ pair[None, :])
                             >> np.uint64(11)).astype(np.int64)
                        lo, hi = thr[i]
                        band = nb & (m >= lo) & (m <= hi)
                        g = -np.log1p(-(m * 2.0 ** -53))
                        exact = bandwidth_hz * np.log2(
                            1.0 + chan[i, lst] * g / bandwidth_hz) >= rate
                        ok = np.where(band, exact, m > hi)
                        assert np.array_equal(ok[nb], exact[nb])
                        banded += int(band.sum())
                    else:
                        ok = np.broadcast_to(chan[i, lst], nb.shape)
                    need[sent] = nb & ~ok
                clock = clock + cs
            delivered[r, i, lst] = ~need.any(0)
        t_start[r], t_comm[r] = start, clock - start
        clock = clock + compute_s
    return delivered, t_start, t_comm, retx, clock, (steps, pairs), banded


MODEL_CASES = [("static", 6, {}), ("fading", 6, {}),
               ("fading", 9, {"mac.max_retx_rounds": 0}),
               # 70 packets: the second need word
               ("fading", 6, {"model_bits": 70 * 32768.0 - 100}),
               ("static", 9, {"model_bits": 130 * 32768.0}),
               # 8641 packets: past one tile (5 tiles of 2048)
               ("fading", 6, {"model_bits": 8641 * 32768.0 - 100})]


def _held_to_plain(name, n, kw, tile_words=None):
    arrays, args = _inputs(name, n, **kw)
    args.pop("degrade")
    rounds = 2
    counts = torch.zeros(2, dtype=torch.int64)
    _, t0, tc, dl, rx, te = ts.round_scan_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        n_rounds=rounds, degrade="renorm", counts=counts, **args)
    m_dl, m_t0, m_tc, m_rx, m_te, m_counts, _ = _kernel_model(
        *arrays[:4], n_rounds=rounds, tile_words=tile_words, **args)
    assert np.array_equal(dl.numpy(), m_dl)
    assert np.array_equal(rx.numpy(), m_rx)
    # the same association, sequential in packet order: bit-equal times
    assert np.array_equal(t0.numpy(), m_t0)
    assert np.array_equal(tc.numpy(), m_tc) and float(te) == m_te
    assert tuple(counts.tolist()) == m_counts
    assert m_counts[1] > 0 and (name == "static" or m_rx.sum() > 0
                                or args["passes"] == 1)
    return args


@pytest.mark.parametrize("name,n,kw", MODEL_CASES)
def test_kernel_algorithm_matches_plain(name, n, kw):
    _held_to_plain(name, n, kw)


@pytest.mark.parametrize("tile_words", [1, 2])
def test_kernel_algorithm_tiles_match_plain(tile_words):
    """The same with tiles forced narrow: 130 packets in 3 or 2 tiles,
    the running sum carried across them."""
    args = _held_to_plain("fading", 9, {"model_bits": 130 * 32768.0 - 100},
                          tile_words)
    assert args["n_pkts"] > 64 * tile_words


def _real_pairs(n):
    """(snr, rate) of every intended pair of ``fading`` at n nodes, and
    the bandwidth."""
    (rates, _, recv, chan, _), kw = _inputs("fading", n)
    i, j = np.nonzero(recv)
    return chan[i, j], rates[i], kw["bandwidth_hz"]


def _flip_points(snr, rate, bw):
    """The smallest m in [0, 2^53) the exact formula decodes at, by
    bisection (2^53 where none does)."""
    s, r = torch.from_numpy(snr), torch.from_numpy(rate)
    lo = np.full(len(snr), -1, np.int64)           # exact False (or -1)
    hi = np.full(len(snr), 2**53, np.int64)        # exact True (or 2^53)
    while np.any(hi - lo > 1):
        mid = (lo + hi) // 2
        ok = ts._exact_decode(torch.from_numpy(mid), s, r, bw).numpy()
        ok = ok & (mid < 2**53)
        lo, hi = np.where(ok, lo, mid), np.where(ok, mid, hi)
    return hi


@pytest.mark.parametrize("n", [6, 64])
def test_filter_decision_equals_the_exact_formula(n):
    """On every intended pair of ``fading`` at n nodes: m at m_lo - 1,
    m_lo, m_hi, m_hi + 1, at the exact formula's flip point (bisection)
    and its neighbours, and at random draws (a tenth within 5000 of the
    flip): the filtered decision equals the exact formula's. The plain
    thresholds agree with the numpy model to one grid step, and a uniform
    draw almost never lands in the band."""
    snr, rate, bw = _real_pairs(n)
    thr = ts.fade_thresholds_plain(torch.from_numpy(snr),
                                   torch.from_numpy(rate), bw).numpy()
    lo, hi = _thresholds_np(snr, rate, bw)
    assert np.abs(thr[:, 0] - lo).max() <= 1
    assert np.abs(thr[:, 1] - hi).max() <= 1
    assert np.all(thr[:, 1] - thr[:, 0] < 2**53 - 1)   # no pair all exact
    flip = _flip_points(snr, rate, bw)
    assert np.all((thr[:, 0] <= flip) & (flip <= thr[:, 1]))
    rng = np.random.default_rng(n)
    draws = rng.integers(0, 2**53, size=(200, len(snr)), dtype=np.int64)
    draws[:20] = flip + rng.integers(-5000, 5001, size=(20, len(snr)))
    cols = [thr[:, 0] - 1, thr[:, 0], thr[:, 1], thr[:, 1] + 1,
            flip - 1, flip, flip + 1, *draws]
    m = np.clip(np.stack(cols), 0, 2**53 - 1)
    k = m.shape[0]
    _, filtered, exact, banded = ts.trace_decide(
        torch.from_numpy(np.tile(snr, k)), torch.from_numpy(np.tile(rate, k)),
        torch.from_numpy(m.ravel()), bandwidth_hz=bw)
    assert torch.equal(filtered, exact)
    banded = banded.numpy().reshape(k, -1)
    assert not banded[[0, 3]].any() and banded[[1, 2, 5]].all()
    assert banded[27:].sum() <= 1              # uniform draws: ~2e-9 each
    assert ts.trace_decide.launches == 0


def test_round_scan_refuses_what_the_kernel_does_not_take():
    arrays, kw = _inputs("fading", 6)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    bad = [(0, t[0].float(), "rates"), (3, t[3] > 0, "chan"),
           (2, t[2][:, :5], "recv"), (4, t[4][None], "planned_w")]
    for pos, x, match in bad:
        args = list(t)
        args[pos] = x
        with pytest.raises(ValueError, match=match):
            ts.round_scan(*args, n_rounds=1, **kw)
    for key, val, match in (("degrade", "mean", "degrade"),
                            ("passes", 0, "passes"),
                            ("n_pkts", kw["n_pkts"] + 1, "sizes")):
        with pytest.raises(ValueError, match=match):
            ts.round_scan(*t, n_rounds=1, **{**kw, key: val})
    with pytest.raises(ValueError, match="counts"):
        ts.round_scan(*t, n_rounds=1, counts=torch.zeros(2), **kw)
    with pytest.raises(ValueError, match="exact"):
        ts.round_scan(*t, n_rounds=1, exact=torch.zeros(2, dtype=torch.int64),
                      **kw)
    exact = torch.zeros(1, dtype=torch.int64)   # the plain version: no filter
    ts.round_scan(*t, n_rounds=1, exact=exact, **kw)
    assert int(exact) == 0
    # bounded for every trace: tiles of packets past one tile's worth
    for n in (6, 256, 1024):
        for n_pkts in (22, 8641, 10_000, 329_000):
            assert ts.smem_bytes(n, n_pkts) <= ts._SMEM_LIMIT, (n, n_pkts)


# ---------------------------------------------------------------------------
# Entry points: train-on-trace and the --scale example
# ---------------------------------------------------------------------------

def _jax_steps_on(cfg, tr):
    """The JAX package's per-round steps on one trace, captured (as
    test_torch_batch.py's ``_jax_steps`` on the event engine's)."""
    imgs, labs = r_batch._driver_batches(cfg, tr, *_shards(), BATCH)
    p0 = jax.tree.map(jnp.asarray, _jax_init(cfg.seed))
    calls = []
    mp = pytest.MonkeyPatch()
    try:
        _capture(r_dpsgd, mp, calls)
        r_batch.train_on_trace_reference(
            r_batch._cnn_loss, r_dpsgd.replicate(p0, N_NODES), tr.w_eff,
            tr.live, {"images": imgs, "labels": labs},
            r_dpsgd.DPSGDConfig(eta=ETA), payload=cfg.payload,
            active_seq=tr.active)
    finally:
        mp.undo()
    return [(jax.tree.map(_host, inputs), _np_tree(out))
            for inputs, out in calls]


def test_train_cnn_on_traces_scan_engine_matches_reference(x64, monkeypatch):
    """Both packages' ``train_cnn_on_traces(engine="scan")`` on 2 seeds of
    ``fading`` (shadowing 0): the scan traces equal, the same eval rounds
    and time stamps, mean losses within 1e-5 on every round no max-pool /
    ReLU routing flip has reached, and the final parameters within 1e-5 on
    every node row none has reached (``_reached``, from both packages'
    steps)."""
    seeds = (0, 1)
    cfgs_r = [r_scenario.get_scenario("fading", seed=s, **NO_SHADOW)
              for s in seeds]
    cfgs_t = [t_scenario.get_scenario("fading", seed=s, **NO_SHADOW)
              for s in seeds]
    traces_r, want = r_batch.train_cnn_on_traces(cfgs_r, engine="scan",
                                                 **TRAIN_KW)
    _patch_init(monkeypatch)
    calls = _record_steps(monkeypatch)
    traces_t, got = t_batch.train_cnn_on_traces(
        cfgs_t, engine="scan", device="cpu", **TRAIN_KW)
    assert np.array_equal(traces_t.w_eff, traces_r.w_eff)
    assert _close(traces_t.t_end_s, traces_r.t_end_s)
    assert got["eval_rounds"] == want["eval_rounds"]
    assert _close(got["t_acc_s"], want["t_acc_s"])
    held = 0
    for s in seeds:
        reached = _reached(calls[s::len(seeds)],
                           _jax_steps_on(cfgs_r[s], traces_r.traces[s]),
                           traces_t.w_eff[s], False)
        clean = ~reached[:-1].any(1)
        assert float(np.max(np.abs(np.where(
            clean, got["losses"][s] - want["losses"][s], 0.0)))) <= TOL
        held += clean.sum()
        p_t = params_to_numpy(got["final_params"][s])
        p_r = _np_tree(want["final_params"][s])
        rows = ~reached[-1]
        for a in p_r:
            for b in p_r[a]:
                assert np.max(np.abs(p_t[a][b][rows] - p_r[a][b][rows]),
                              initial=0.0) <= TOL, (a, b)
    assert held >= len(seeds) * ROUNDS // 2, held


def _masked(text):
    return "\n".join(
        re.sub(r"\d+\.\d+s|\d+\.\d+ rounds/s", "#", line)
        for line in text.splitlines())


def test_scale_example_prints_the_reference_line(x64, capsys):
    """``--scale 128 --rounds 2 --device cpu``: the reference's line, its
    seconds masked."""
    r_example.main(["--scale", "128", "--rounds", "2"])
    want = capsys.readouterr().out
    t_example.main(["--scale", "128", "--rounds", "2", "--device", "cpu"])
    got = capsys.readouterr().out
    assert got.startswith("# n=128: plan ") and "certified=True" in got
    assert _masked(got) == _masked(want)
