"""Train-on-trace (``sim.batch``), the port against the JAX package on the
CPU, at small sizes: 300 training images over 6 nodes (2 rounds of batch
25 an epoch), 8 rounds, families of at most 3 traces.

The same numpy inputs (the JAX package's initial parameters carried across
with ``convert.params_from_numpy``, its ``_driver_batches``, the traces,
which the port's simulator realizes ``np.array_equal``) go through both
packages' ``train_on_trace`` on ``static``, ``churn``, ``compressed_int8``,
``fault_chaos`` (watchdog armed, crashes in ``active``) and ``mixed``
(nodes die within the 8 rounds; ``churn`` loses none that early). Losses
within 1e-5, the int8 payload bit-equal, and final parameters and node-0
snapshots within 1e-5 on every node row whose state no max-pool/ReLU
routing flip has reached (test_torch_sim_lockstep.py's check, on the
port's state each round, carried forward through the nonzero weights of
each round's W).

Also here: the family against separate runs and against the JAX family,
the loop against the port's per-round driver and the reference's
``train_cnn_on_traces``, the watchdog, the shared batches, the contract's
errors, chunked evaluation, and the graph path rehearsed with the fakes of
test_torch_graphs.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from repro.core import compression as r_comp
from repro.core import dpsgd as r_dpsgd
from repro.data import SyntheticFashion as RFashion
from repro.data import node_splits as r_splits
from repro.models import cnn as r_cnn
from repro.sim import batch as r_batch
from repro.sim import scenario as r_scenario
from repro.sim import trace as r_trace
from repro_torch import graphs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import compression as t_comp
from repro_torch.core import dpsgd as t_dpsgd
from repro_torch.examples import sim_scenarios as t_example
from repro_torch.kernels import counted_wrappers
from repro_torch.kernels import gossip_mix as t_gm
from repro_torch.kernels import quantize as t_qz
from repro_torch.models import cnn as t_cnn
from repro_torch.sim import batch as t_batch
from repro_torch.sim import scenario as t_scenario
from repro_torch.sim import trace as t_trace
from test_torch_graphs import fake_graphs  # noqa: F401  (a fixture)
from test_torch_sim_lockstep import _same_routing
from test_torch_sim_train import _capture, _host

N_NODES, N_TRAIN, N_TEST, BATCH, ROUNDS, EPOCHS = 6, 300, 30, 25, 8, 4
TOL, ETA = 1e-5, 0.05
SCENARIOS = ["static", "churn", "compressed_int8", "fault_chaos", "mixed"]


# ---------------------------------------------------------------------------
# Shared inputs
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_init(seed):
    return _np_tree(r_cnn.cnn_init(jax.random.key(seed)))


def _patch_init(monkeypatch):
    """The port's ``cnn_init`` hands out the JAX package's parameters for
    the generator's seed (``init_params(seed)`` seeds a fresh one)."""
    monkeypatch.setattr(
        t_cnn, "cnn_init", lambda gen, device="cuda": params_from_numpy(
            _jax_init(gen.initial_seed()), device))


@functools.lru_cache(maxsize=None)
def _shards():
    ds = RFashion(n_train=N_TRAIN, n_test=N_TEST, seed=0)
    shards = r_splits(ds.train_x, ds.train_y, N_NODES, seed=0)
    return (np.stack([x for x, _ in shards]),
            np.stack([y for _, y in shards]))


@functools.lru_cache(maxsize=None)
def _inputs(name, seed=None):
    """(JAX config, port trace, batches) for one scenario at ROUNDS."""
    kw = {} if seed is None else {"seed": seed}
    cfg = r_scenario.get_scenario(name, **kw)
    tr_r = r_trace.precompute_trace(cfg, ROUNDS)
    tr_t = t_trace.precompute_trace(t_scenario.get_scenario(name, **kw),
                                    ROUNDS)
    for f in ("w_eff", "live", "active", "t_end_s"):
        assert np.array_equal(getattr(tr_r, f), getattr(tr_t, f)), f
    imgs, labs = r_batch._driver_batches(cfg, tr_r, *_shards(), BATCH)
    return cfg, tr_t, {"images": imgs, "labels": labs}


def _t_payload(cfg):
    p = cfg.payload
    return t_comp.QuantConfig(mode=p.mode, error_feedback=p.error_feedback,
                              granularity=p.granularity)


def _max_err(a, b):
    return max(float(np.max(np.abs(a[k][j] - b[k][j]))) for k in b
               for j in b[k])


@functools.lru_cache(maxsize=None)
def _jax_train_on_trace(name):
    cfg, tr, b = _inputs(name)
    p0 = r_dpsgd.replicate(jax.tree.map(jnp.asarray, _jax_init(cfg.seed)),
                           N_NODES)
    out = r_batch.train_on_trace(
        r_batch._cnn_loss, p0, jnp.asarray(tr.w_eff), jnp.asarray(tr.live),
        jax.tree.map(jnp.asarray, b), r_dpsgd.DPSGDConfig(eta=ETA),
        collect_node0=True, payload=cfg.payload,
        active_seq=jnp.asarray(tr.active), watchdog=cfg.watchdog)
    return tuple(_np_tree(o) for o in out)


def _port_train_on_trace(name, **kw):
    cfg, tr, b = _inputs(name)
    p0 = t_dpsgd.replicate(params_from_numpy(_jax_init(cfg.seed), "cpu"),
                           N_NODES)
    return t_batch.train_on_trace(
        t_batch._cnn_loss, p0, tr.w_eff, tr.live, b,
        t_dpsgd.DPSGDConfig(eta=ETA), collect_node0=True,
        payload=_t_payload(cfg), active_seq=tr.active,
        watchdog=cfg.watchdog, **kw)


def _record_steps(monkeypatch):
    """Record the inputs and outputs of every masked step the round body
    runs (on the CPU the body runs eagerly, one step per trace per
    round)."""
    calls = []
    for fname in ("dpsgd_masked_step", "dpsgd_masked_compressed_step"):
        fn = getattr(t_dpsgd, fname)

        def run(loss_fn, params, batch, *rest, fn=fn):
            out = fn(loss_fn, params, batch, *rest)
            calls.append((params, batch, rest, out))
            return out
        monkeypatch.setattr(t_dpsgd, fname, run)
    return calls


# ---------------------------------------------------------------------------
# train_on_trace: the port against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_steps(name, seed=None):
    """The JAX package's per-round steps on one trace: its
    ``train_on_trace_reference`` (the jitted step the scan body runs) with
    every step's inputs and outputs captured as numpy."""
    cfg, tr, b = _inputs(name, seed)
    p0 = r_dpsgd.replicate(jax.tree.map(jnp.asarray, _jax_init(cfg.seed)),
                           N_NODES)
    calls = []
    mp = pytest.MonkeyPatch()
    try:
        _capture(r_dpsgd, mp, calls)
        r_batch.train_on_trace_reference(
            r_batch._cnn_loss, p0, tr.w_eff, tr.live, b,
            r_dpsgd.DPSGDConfig(eta=ETA), payload=cfg.payload,
            active_seq=tr.active)
    finally:
        mp.undo()
    return [(jax.tree.map(_host, inputs), _np_tree(out))
            for inputs, out in calls]


def _carried(state, res):
    return np.concatenate([(state[a][b] + res[a][b]).reshape(N_NODES, -1)
                           for a in sorted(state) for b in sorted(state[a])],
                          1)


def _flat(tree):
    return np.concatenate([tree[a][b].reshape(N_NODES, -1)
                           for a in sorted(tree) for b in sorted(tree[a])], 1)


def _reached(t_calls, j_steps, w_seq, compressed):
    """(rounds + 1, n) bool: the node rows a routing flip or a differing
    int8 payload has reached before each round (and after the last).

    Each round, each framework on its own input state: a node whose
    max-pools or ReLUs the two route differently (test_torch_sim_lockstep.
    py's check) takes a gradient that jumps by ~1e-4; on int8 rounds a
    sender whose payloads differ in a lane (a ~1e-7 difference across a
    rounding boundary; the JAX package's jitted step also rounds an
    occasional lane of the very state its eager codec rounds alike) feeds
    a jump of one scale, ~1e-3, to every receiver: its new residuals
    differ by that scale. Either reaches every row that mixes a reached row
    in, from that round on. The payload from one and the same state is
    bit-equal across the codecs."""
    reached = np.zeros(N_NODES, dtype=bool)
    before = []
    for r, ((params, batch, rest, out), (j_in, j_out)) in enumerate(
            zip(t_calls, j_steps)):
        before.append(reached.copy())
        flip = ~_same_routing(j_in, (params, batch))
        sent = np.zeros(N_NODES, dtype=bool)
        if compressed:
            state = params_to_numpy(params)
            carried = _carried(state, params_to_numpy(rest[2]))
            q_t, s_t = t_comp.quantize_int8_rows(torch.from_numpy(carried))
            q_j, s_j = r_comp.quantize_int8_rows(jnp.asarray(carried))
            assert np.array_equal(q_t.numpy(), np.asarray(q_j))
            np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                                       rtol=1e-6)
            sent = (np.abs(_flat(params_to_numpy(out[1])) - _flat(j_out[1]))
                    > TOL).any(1)
        spread = reached | sent
        reached = reached | flip | sent | \
            ((w_seq[r] != 0) & spread[None, :]).any(1)
    before.append(reached)
    return np.array(before)


def _hold(reached, live, t_out, j_out):
    """Hold losses, node-0 snapshots and final rows that no flip reached
    at 1e-5; returns the share of (round, node) losses held."""
    t_final, t_losses, t_snaps = (params_to_numpy(t_out[0]),
                                  t_out[1].numpy(), params_to_numpy(t_out[2]))
    j_final, j_losses, j_snaps = j_out[:3]
    held = live & ~reached[:-1]
    assert float(np.max(np.abs(np.where(held, t_losses - j_losses, 0.0)))) \
        <= TOL
    first = live.argmax(-1)
    for r in range(len(first)):
        if not reached[r + 1, first[r]]:
            err = max(float(np.max(np.abs(t_snaps[a][b][r]
                                          - j_snaps[a][b][r])))
                      for a in j_snaps for b in j_snaps[a])
            assert err <= TOL, (r, err)
    for k in np.flatnonzero(~reached[-1]):
        err = max(float(np.max(np.abs(t_final[a][b][k] - j_final[a][b][k])))
                  for a in j_final for b in j_final[a])
        assert err <= TOL, (k, err)
    return held.sum() / live.sum()


@pytest.mark.parametrize("name", SCENARIOS)
def test_train_on_trace_matches_jax(monkeypatch, name):
    cfg, tr, _ = _inputs(name)
    want = _jax_train_on_trace(name)
    calls = _record_steps(monkeypatch)
    got = _port_train_on_trace(name)
    assert len(got) == len(want) == (4 if cfg.watchdog else 3)
    assert len(calls) == ROUNDS
    assert got[1].shape == (ROUNDS, N_NODES)
    if cfg.watchdog:
        assert np.array_equal(got[3].numpy(), want[3])
    reached = _reached(calls, _jax_steps(name), tr.w_eff,
                       cfg.payload.mode == "int8")
    assert _hold(reached, tr.live, got, want) >= 0.5, reached


@pytest.mark.parametrize("name", ["static", "compressed_int8"])
def test_train_on_trace_equals_the_per_round_reference(name):
    """The loop against ``train_on_trace_reference`` (one built step per
    round, losses read back each round): the same update sequence."""
    cfg, tr, b = _inputs(name)
    p0 = t_dpsgd.replicate(params_from_numpy(_jax_init(cfg.seed), "cpu"),
                           N_NODES)
    final, losses = t_batch.train_on_trace(
        t_batch._cnn_loss, p0, tr.w_eff, tr.live, b,
        t_dpsgd.DPSGDConfig(eta=ETA), payload=_t_payload(cfg))
    ref_final, ref_losses = t_batch.train_on_trace_reference(
        t_batch._cnn_loss, p0, tr.w_eff, tr.live, b,
        t_dpsgd.DPSGDConfig(eta=ETA), payload=_t_payload(cfg))
    assert isinstance(ref_losses, np.ndarray)
    assert np.array_equal(losses.numpy(), ref_losses)
    assert all(torch.equal(x, y) for x, y in zip(t_dpsgd._leaves(final),
                                                 t_dpsgd._leaves(ref_final)))


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------

def _family(name, seeds=(0, 1, 2)):
    """(configs, stacked numpy inputs, per-seed initial node params)."""
    ins = [_inputs(name, seed=s) for s in seeds]
    cfgs = [i[0] for i in ins]
    w = np.stack([i[1].w_eff for i in ins])
    live = np.stack([i[1].live for i in ins])
    act = np.stack([i[1].active for i in ins])
    b = {k: np.stack([i[2][k] for i in ins]) for k in ("images", "labels")}
    p0 = [_jax_init(s) for s in seeds]
    return cfgs, w, live, act, b, p0


@pytest.mark.parametrize("name", ["static", "compressed_int8", "fault_chaos"])
def test_family_equals_separate_runs(name):
    """One family of 3 seeds against 3 separate ``train_on_trace`` calls:
    equal on the CPU (each trace is its own step in the round body)."""
    cfgs, w, live, act, b, p0 = _family(name)
    kw = dict(config=t_dpsgd.DPSGDConfig(eta=ETA), collect_node0=True,
              payload=_t_payload(cfgs[0]), watchdog=cfgs[0].watchdog)
    stacked = {k: {j: torch.stack([
        t_dpsgd.replicate(params_from_numpy(p, "cpu"), N_NODES)[k][j]
        for p in p0]) for j in p0[0][k]} for k in p0[0]}
    fam = t_batch.train_on_traces(t_batch._cnn_loss, stacked, w, live, b,
                                  params_batched=True, active_seq=act, **kw)
    for s in range(len(cfgs)):
        solo = t_batch.train_on_trace(
            t_batch._cnn_loss, t_dpsgd._tree_map(lambda x: x[s], stacked),
            w[s], live[s], {k: v[s] for k, v in b.items()},
            active_seq=act[s], **kw)
        for f, o in zip(fam, solo):
            for x, y in zip(t_dpsgd._leaves(f), t_dpsgd._leaves(o)):
                assert torch.equal(x[s], y)
    # different seeds genuinely differ (different inits, batches, traces)
    assert float((fam[1][0] - fam[1][1]).abs().max()) > 1e-3


def test_family_shares_one_init_unless_batched():
    cfgs, w, live, act, b, p0 = _family("static", seeds=(0, 1))
    one = t_dpsgd.replicate(params_from_numpy(p0[0], "cpu"), N_NODES)
    final, losses = t_batch.train_on_traces(
        t_batch._cnn_loss, one, w, live, b, t_dpsgd.DPSGDConfig(eta=ETA))
    solo = t_batch.train_on_trace(
        t_batch._cnn_loss, one, w[1], live[1], {k: v[1] for k, v in b.items()},
        t_dpsgd.DPSGDConfig(eta=ETA))
    assert torch.equal(losses[1], solo[1])
    assert final["fc2"]["w"].shape == (2, N_NODES, 50, 10)


@pytest.mark.parametrize("name", ["static", "compressed_int8"])
def test_family_matches_jax_params_batched(monkeypatch, name):
    """Both packages' families of 3 seeds, per-seed inits: each trace held
    as ``test_train_on_trace_matches_jax`` holds one."""
    seeds = (0, 1, 2)
    cfgs, w, live, act, b, p0 = _family(name, seeds)
    j_p0 = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        r_dpsgd.replicate(jax.tree.map(jnp.asarray, p), N_NODES)
        for p in p0])
    want = r_batch.train_on_traces(
        r_batch._cnn_loss, j_p0, jnp.asarray(w), jnp.asarray(live),
        jax.tree.map(jnp.asarray, b), r_dpsgd.DPSGDConfig(eta=ETA),
        collect_node0=True, params_batched=True, payload=cfgs[0].payload,
        active_seq=jnp.asarray(act))
    want = tuple(_np_tree(o) for o in want)
    calls = _record_steps(monkeypatch)
    got = t_batch.train_on_traces(
        t_batch._cnn_loss, params_from_numpy(_np_tree(j_p0), "cpu"), w,
        live, b, t_dpsgd.DPSGDConfig(eta=ETA), collect_node0=True,
        params_batched=True, payload=_t_payload(cfgs[0]), active_seq=act)
    assert len(calls) == ROUNDS * len(seeds)
    for s, seed in enumerate(seeds):
        reached = _reached(calls[s::len(seeds)], _jax_steps(name, seed),
                           w[s], cfgs[0].payload.mode == "int8")
        pick = lambda out: tuple(  # noqa: E731
            t_dpsgd._tree_map(lambda x: x[s], o) for o in out)
        assert _hold(reached, live[s], pick(got), pick(want)) >= 0.5, \
            (seed, reached)


# ---------------------------------------------------------------------------
# train_cnn_on_traces: against the port's driver and the reference's
# ---------------------------------------------------------------------------

TRAIN_KW = dict(epochs=EPOCHS, n_train=N_TRAIN, n_test=N_TEST)


@pytest.mark.parametrize("name", ["static", "churn", "mixed"])
def test_scan_matches_the_ports_driver(name):
    """The loop at S = 1 against ``simulate_dpsgd_cnn`` (compute charged
    at ``compute_s_per_round``, so both realize one trace): per-round mean
    losses within 1e-5, the accuracy points at the same simulated times,
    accuracies within one test image."""
    cfg = t_scenario.get_scenario(name)
    trace, _ = t_trace.simulate_dpsgd_cnn(cfg, device="cpu", **TRAIN_KW)
    traces, out = t_batch.train_cnn_on_traces([cfg], device="cpu",
                                              **TRAIN_KW)
    assert out["losses"].shape == (1, ROUNDS)
    driver = np.array([r.loss for r in trace.records])
    assert float(np.max(np.abs(out["losses"][0] - driver))) <= TOL
    assert [r.n_live for r in trace.records] == \
        traces.live[0].sum(-1).tolist()
    curve = trace.accuracy_curve()
    assert [t for t, _ in curve] == out["t_acc_s"][0].tolist()
    for (_, a), b in zip(curve, out["acc"][0]):
        assert abs(a - b) <= 1.0 / N_TEST + 1e-6


@pytest.mark.parametrize("name", ["static", "compressed_int8", "fault_chaos"])
def test_train_cnn_on_traces_matches_reference(monkeypatch, name):
    """Both packages' ``train_cnn_on_traces`` on a family of 2 seeds, the
    port from the JAX package's inits: the same eval rounds and time
    stamps; the mean loss of every round no flip has reached before it
    within 1e-5, and the accuracy of every snapshot no flip has reached
    within one test image (``_reached``, from both packages' steps)."""
    seeds = (0, 1)
    cfgs_r = [r_scenario.get_scenario(name, seed=s) for s in seeds]
    cfgs_t = [t_scenario.get_scenario(name, seed=s) for s in seeds]
    traces_r, want = r_batch.train_cnn_on_traces(cfgs_r, **TRAIN_KW)
    _patch_init(monkeypatch)
    calls = _record_steps(monkeypatch)
    traces_t, got = t_batch.train_cnn_on_traces(cfgs_t, device="cpu",
                                                **TRAIN_KW)
    assert got["eval_rounds"] == want["eval_rounds"]
    assert np.array_equal(got["t_acc_s"], want["t_acc_s"])
    assert np.array_equal(traces_t.w_eff, traces_r.w_eff)
    assert [[p for p, _ in c] for c in got["curves"]] == \
        [[p for p, _ in c] for c in want["curves"]]
    live = traces_t.live
    held = 0
    for s, seed in enumerate(seeds):
        reached = _reached(calls[s::len(seeds)], _jax_steps(name, seed),
                           traces_t.w_eff[s], cfgs_r[0].payload.mode == "int8")
        clean = ~(reached[:-1] & live[s]).any(1)
        assert float(np.max(np.abs(np.where(
            clean, got["losses"][s] - want["losses"][s], 0.0)))) <= TOL
        first = live[s].argmax(-1)
        for e, r in enumerate(got["eval_rounds"]):
            if not reached[r + 1, first[r]]:
                assert abs(got["acc"][s, e] - want["acc"][s, e]) \
                    <= 1.0 / N_TEST + 1e-6
        held += clean.sum()
    assert held >= live.shape[0] * ROUNDS // 2, held
    for f_t, f_r in zip(got["final_params"], want["final_params"]):
        assert t_dpsgd.node_axis_size(f_t) == r_dpsgd.node_axis_size(f_r)
    if cfgs_r[0].watchdog:
        assert np.array_equal(got["rollbacks"], np.asarray(want["rollbacks"]))
    else:
        assert got["rollbacks"] is None and want["rollbacks"] is None


def test_train_cnn_on_traces_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_batch.train_cnn_on_traces(["static"], **TRAIN_KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_example.main(["--train-sweep", "static", "--epochs", "1"])


# ---------------------------------------------------------------------------
# Watchdog (twins of tests/test_faults.py's)
# ---------------------------------------------------------------------------

def _quad_loss(p, b):
    return torch.mean((p["x"] - b["t"]) ** 2)


def _ring_w(n):
    w = np.zeros((n, n))
    for i in range(n):
        w[i, i] = w[i, (i + 1) % n] = w[i, (i - 1) % n] = 1 / 3
    return w


PAYLOADS = [t_comp.QuantConfig(mode="none"), t_comp.QuantConfig(mode="int8")]


@pytest.mark.parametrize("payload", PAYLOADS, ids=["none", "int8"])
def test_watchdog_rolls_back_poisoned_node(payload):
    n, d, rounds = 4, 3, 6
    rng = np.random.default_rng(0)
    params = {"x": torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))}
    w_seq = np.stack([_ring_w(n)] * rounds)
    live = np.ones((rounds, n), dtype=bool)
    targets = rng.normal(size=(rounds, n, d)).astype(np.float32)
    targets[2, 1] = np.nan            # poison node 1's round-2 batch
    batches = {"t": targets}

    final, losses, rb = t_batch.train_on_trace(
        _quad_loss, params, w_seq, live, batches, payload=payload,
        watchdog=True)
    rb = rb.numpy()
    assert rb[2, 1] and rb.sum() == 1
    assert torch.isfinite(final["x"]).all()
    # losses after the poisoned round stay finite: the rollback cleansed
    # the state before it could mix into the neighbours
    assert np.isfinite(losses.numpy()[3:]).all()

    final_off, _ = t_batch.train_on_trace(
        _quad_loss, params, w_seq, live, batches, payload=payload,
        watchdog=False)
    assert not torch.isfinite(final_off["x"]).all()


@pytest.mark.parametrize("payload", PAYLOADS, ids=["none", "int8"])
def test_watchdog_noop_on_healthy_run(payload):
    n, d, rounds = 4, 3, 5
    rng = np.random.default_rng(1)
    params = {"x": torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))}
    w_seq = np.stack([_ring_w(n)] * rounds)
    live = np.ones((rounds, n), dtype=bool)
    batches = {"t": rng.normal(size=(rounds, n, d)).astype(np.float32)}
    f_on, l_on, rb = t_batch.train_on_trace(
        _quad_loss, params, w_seq, live, batches, payload=payload,
        watchdog=True)
    f_off, l_off = t_batch.train_on_trace(
        _quad_loss, params, w_seq, live, batches, payload=payload,
        watchdog=False)
    assert int(rb.sum()) == 0
    assert float((f_on["x"] - f_off["x"]).abs().max()) <= 1e-12
    assert float((l_on - l_off).abs().max()) <= 1e-12


def test_watchdog_flags_every_nonfinite_row_and_checks_shapes():
    x = torch.zeros(4, 3)
    x[1, 2] = float("nan")
    y = torch.zeros(4, 2, 2)
    y[3, 0, 1] = float("inf")
    assert t_batch._nonfinite_rows({"a": x, "b": y}).tolist() == \
        [False, True, False, True]
    with pytest.raises(ValueError, match="leading node axis"):
        t_batch._nonfinite_rows({"a": x, "b": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="row mask"):
        t_batch._row_where(torch.zeros(3, dtype=torch.bool), {"a": x},
                           {"a": x})


# ---------------------------------------------------------------------------
# Batches, errors, evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["static", "mixed"])
def test_driver_batches_equal_reference(name):
    cfg, tr, want = _inputs(name)
    imgs, labs = t_batch._driver_batches(t_scenario.get_scenario(name), tr,
                                         *_shards(), BATCH)
    assert np.array_equal(imgs, want["images"])
    assert np.array_equal(labs, want["labels"])


def test_driver_batches_reject_foreign_shards():
    _, tr, _ = _inputs("static")
    x, y = _shards()
    with pytest.raises(ValueError, match="data shards cover 5 nodes"):
        t_batch._driver_batches(t_scenario.get_scenario("static"), tr,
                                x[:5], y[:5], BATCH)


def _auto(cfg):
    return cfg.replace(payload=t_comp.QuantConfig(mode="auto"))


@pytest.mark.parametrize("call,match", [
    (lambda p, tr, b: t_batch.train_on_trace(
        t_batch._cnn_loss, p, tr.w_eff, tr.live, b,
        payload=t_comp.QuantConfig(mode="auto")),
     "train_on_trace needs a concrete payload mode"),
    (lambda p, tr, b: t_batch.train_on_traces(
        t_batch._cnn_loss, p, tr.w_eff[None], tr.live[None],
        {k: v[None] for k, v in b.items()},
        payload=t_comp.QuantConfig(mode="auto")),
     "train_on_traces needs a concrete payload mode"),
    (lambda p, tr, b: t_batch.train_on_trace_reference(
        t_batch._cnn_loss, p, tr.w_eff, tr.live, b,
        payload=t_comp.QuantConfig(mode="auto")),
     "train_on_trace_reference needs a concrete payload mode")],
    ids=["trace", "traces", "reference"])
def test_auto_payload_is_refused(call, match):
    cfg, tr, b = _inputs("static")
    p0 = t_dpsgd.replicate(params_from_numpy(_jax_init(0), "cpu"), N_NODES)
    with pytest.raises(ValueError, match=match):
        call(p0, tr, b)


@pytest.mark.parametrize("configs,match", [
    (["static", t_scenario.get_scenario("static", n_nodes=5)],
     "share n_nodes"),
    (["static", t_scenario.get_scenario("static", eval_every_rounds=2)],
     "share n_nodes/eval_every_rounds"),
    (["static", "compressed_int8"], "share the payload"),
    (["static", t_scenario.get_scenario("static", watchdog=True)],
     "share the watchdog"),
    ([], "at least one config")],
    ids=["n_nodes", "eval_every", "payload", "watchdog", "empty"])
def test_mixed_families_are_refused(configs, match):
    adapter = t_batch.ModelAdapter("quad", lambda s: None, _quad_loss,
                                   lambda c, t: None)
    with pytest.raises(ValueError, match=match):
        t_batch.train_model_on_traces(adapter, configs, ROUNDS, device="cpu")


def test_foreign_trace_batch_is_refused():
    """Reusing a precomputed TraceBatch for configs it was not realized
    under is rejected (shape match alone is not enough)."""
    batch = t_trace.precompute_traces([t_scenario.get_scenario("static")],
                                      ROUNDS)
    with pytest.raises(ValueError, match="seed"):
        t_batch.train_cnn_on_traces(
            [t_scenario.get_scenario("static", seed=1)], trace_batch=batch,
            device="cpu", **TRAIN_KW)
    with pytest.raises(ValueError, match="does not match"):
        t_batch.train_cnn_on_traces(
            ["static"], trace_batch=batch, device="cpu", epochs=1,
            n_train=N_TRAIN, n_test=N_TEST)


class _TPMesh:
    """A (fleet 2, model 2) mesh's names and sizes, as a DeviceMesh gives
    them."""
    mesh_dim_names = ("fleet", "model")

    def size(self, dim: int) -> int:
        return 2


def test_mesh_names_its_roadmap_item():
    """A mesh runs the family over its fleet (``tests/test_torch_dist_
    train.py``) and, for the dense decoder families, each node over its
    'model' axis (``tests/test_torch_tp.py``); a model without tensor
    parallelism (this adapter's) under a 'model' axis > 1 raises before
    any work, saying it has no tensor-parallel layout."""
    adapter = t_batch.ModelAdapter("quad", lambda s: None, _quad_loss,
                                   lambda c, t: None)
    with pytest.raises(NotImplementedError,
                       match="no tensor-parallel layout"):
        t_batch.train_model_on_traces(adapter, ["static"], ROUNDS,
                                      mesh=_TPMesh(), device="cpu")


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_chunked_evaluation_equals_one_snapshot_at_a_time(chunk):
    """Seven distinct snapshots of the CNN on 30 test images, ``chunk``
    per vmapped call: exactly the accuracies of one call per snapshot."""
    ds = RFashion(n_train=60, n_test=N_TEST, seed=0)
    x, y = torch.from_numpy(ds.test_x), torch.from_numpy(ds.test_y)
    g = torch.Generator().manual_seed(3)
    snaps = [t_cnn.cnn_init(g, device="cpu") for _ in range(7)]

    def eval_fn(p):
        return t_cnn.cnn_accuracy(p, x, y)
    got = t_batch._evaluate(eval_fn, t_batch._stack(snaps), chunk)
    want = torch.stack([eval_fn(p) for p in snaps])
    assert torch.equal(got, want)
    assert len(set(want.tolist())) > 1


# ---------------------------------------------------------------------------
# The graph path, rehearsed on the CPU
# ---------------------------------------------------------------------------

def _count_plain(monkeypatch):
    """Count the plain versions' calls on the kernels' counters, as a
    launch on the card counts (``core.dpsgd`` imports both by name)."""
    rows, round_ = t_dpsgd.gossip_mix_rows, t_dpsgd.gossip_mix_int8_round

    def counted_rows(w, bufs):
        out = rows(w, bufs)
        t_gm.gossip_mix_rows.launches += 1
        return out

    def counted_round(*args):
        out = round_(*args)
        t_qz.quantize_int8_ef.launches += 1
        t_gm.gossip_mix_q8_rows.launches += 1
        return out
    monkeypatch.setattr(t_dpsgd, "gossip_mix_rows", counted_rows)
    monkeypatch.setattr(t_dpsgd, "gossip_mix_int8_round", counted_round)


@pytest.mark.parametrize("name", ["static", "compressed_int8"])
def test_graph_path_replays_one_capture_per_family_round(
        monkeypatch, fake_graphs, name):  # noqa: F811
    """A family of 3 seeds: one capture for the family's signature, one
    replay per round, the launch counters advanced by S per round, and the
    results those of the eager loop. A second call with the same
    signature captures nothing new."""
    monkeypatch.setattr(t_batch, "_STEPS", {})
    cfgs, w, live, act, b, p0 = _family(name)
    stacked = {k: {j: torch.stack([
        t_dpsgd.replicate(params_from_numpy(p, "cpu"), N_NODES)[k][j]
        for p in p0]) for j in p0[0][k]} for k in p0[0]}
    args = (t_batch._cnn_loss, stacked, w, live, b,
            t_dpsgd.DPSGDConfig(eta=ETA))
    kw = dict(collect_node0=True, params_batched=True,
              payload=_t_payload(cfgs[0]), active_seq=act)
    with monkeypatch.context() as m:
        m.setattr(graphs, "_graphable", lambda device: False)
        eager = t_batch.train_on_traces(*args, **kw)

    replays = []
    replay = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda self: (replays.append(1), replay(self)))
    _count_plain(monkeypatch)
    counters = {"rows": t_gm.gossip_mix_rows, "send": t_qz.quantize_int8_ef,
                "q8": t_gm.gossip_mix_q8_rows}
    for fn in counted_wrappers():
        monkeypatch.setattr(fn, "launches", 0)
    for call in range(2):
        graphed = t_batch.train_on_traces(*args, **kw)
        assert len(replays) == ROUNDS * (call + 1)
        (step,) = t_batch._STEPS.values()
        assert step.signatures == 1
        want = 3 * ROUNDS * (call + 1)
        launches = {k: fn.launches for k, fn in counters.items()}
        assert launches == ({"rows": want, "send": 0, "q8": 0}
                            if cfgs[0].payload.mode == "none" else
                            {"rows": 0, "send": want, "q8": want}), launches
        for f, e in zip(graphed, eager):
            for x, y in zip(t_dpsgd._leaves(f), t_dpsgd._leaves(e)):
                assert torch.equal(x, y)


def test_round_loop_reads_nothing_back(monkeypatch):
    """No host read inside the loop: ``.item()``, ``bool()``, ``float()``
    and ``.numpy()`` of any tensor raise while the family trains; the one
    read is after it (``train_model_on_traces``' numpy results)."""
    cfgs, w, live, act, b, p0 = _family("fault_chaos", seeds=(0, 1))
    stacked = {k: {j: torch.stack([
        t_dpsgd.replicate(params_from_numpy(p, "cpu"), N_NODES)[k][j]
        for p in p0]) for j in p0[0][k]} for k in p0[0]}
    w, live, act = (torch.from_numpy(a) for a in (w, live, act))
    b = {k: torch.from_numpy(v) for k, v in b.items()}

    def refuse(*a, **k):
        raise AssertionError("host read inside the round loop")
    for attr in ("item", "__bool__", "__float__", "__int__", "numpy",
                 "tolist"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    out = t_batch.train_on_traces(
        t_batch._cnn_loss, stacked, w, live, b, t_dpsgd.DPSGDConfig(eta=ETA),
        collect_node0=True, params_batched=True,
        payload=_t_payload(cfgs[0]), active_seq=act, watchdog=True)
    monkeypatch.undo()
    assert out[3].shape == (2, ROUNDS, N_NODES)
