"""Training through the wireless simulator, ``sim.trace.simulate_dpsgd_cnn``,
the port against the JAX package on the CPU, from the JAX package's initial
parameters (``convert.params_from_numpy``, patched in for ``cnn_init``), at
``epochs=1, n_train=1200, n_test=300`` (8 rounds of batch 25 on 6 nodes) on
``static``, ``churn``, ``compressed_int8``, ``compressed_ra`` and
``fault_chaos``. ``measure_compute`` stays off, so the simulated clock is
exact on both sides.

Run free: per-round losses within 1e-5, every round record's
communication fields and time stamps equal, accuracy points within 1/n_test
(one test image). Each round held on its own (lockstep) is in
test_torch_sim_lockstep.py.

Free-running final parameters are not comparable at 1e-5: one max-pool
near-tie (``static``, round 6) moves the conv rows by 1.0e-4 in one step
(the gradient itself jumps), and an int8 round turns a 1e-7 difference
into a flipped lane (a jump of one scale, ~1e-3).
"""
import functools

import jax
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch

from repro.core import dpsgd as r_dpsgd
from repro.models import cnn as r_cnn
from repro.sim import scenario as r_scenario
from repro.sim import trace as r_trace
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import compression as t_comp
from repro_torch.core import dpsgd as t_dpsgd
from repro_torch.examples import sim_scenarios as t_example
from repro_torch.models import cnn as t_cnn
from repro_torch.sim import scenario as t_scenario
from repro_torch.sim import trace as t_trace

SCENARIOS = ["static", "churn", "compressed_int8", "compressed_ra",
             "fault_chaos"]
N_TRAIN, N_TEST, TOL = 1200, 300, 1e-5
FACTORIES = ("make_dpsgd_step", "make_dpsgd_masked_step",
             "make_dpsgd_compressed_step")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _capture(module, monkeypatch, calls):
    """Wrap ``module``'s step factories so every step call records its
    inputs and outputs (as numpy) in ``calls``."""
    def wrap(factory):
        def make(*args, **kw):
            step = factory(*args, **kw)

            def run(*inputs):
                out = step(*inputs)
                calls.append((inputs, out))
                return out
            return run
        return make
    for name in FACTORIES:
        monkeypatch.setattr(module, name, wrap(getattr(module, name)))


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX package's driver on ``name``, every step captured."""
    calls = []
    mp = pytest.MonkeyPatch()
    try:
        _capture(r_dpsgd, mp, calls)
        trace, params = r_trace.simulate_dpsgd_cnn(
            r_scenario.get_scenario(name), epochs=1, n_train=N_TRAIN,
            n_test=N_TEST)
    finally:
        mp.undo()
    steps = [(jax.tree.map(_host, inputs), _np_tree(out))
             for inputs, out in calls]
    return trace, _np_tree(params), steps


def _host(x):
    return np.asarray(x) if isinstance(x, jax.Array) else x


def _jax_params0(name):
    seed = r_scenario.get_scenario(name).seed
    return _np_tree(r_cnn.cnn_init(jax.random.key(seed)))


def _patch_init(monkeypatch, name):
    p0 = _jax_params0(name)
    monkeypatch.setattr(t_cnn, "cnn_init",
                        lambda gen, device="cuda": params_from_numpy(p0, device))


def _max_err(t_tree, j_tree):
    t_np = params_to_numpy(t_tree)
    return max(float(np.max(np.abs(t_np[k][j] - j_tree[k][j])))
               for k in j_tree for j in j_tree[k])


@pytest.mark.parametrize("name", SCENARIOS)
def test_free_running_driver_matches_jax(monkeypatch, name):
    want, _, _ = _jax_run(name)
    _patch_init(monkeypatch, name)
    got, params = t_trace.simulate_dpsgd_cnn(
        t_scenario.get_scenario(name), epochs=1, n_train=N_TRAIN,
        n_test=N_TEST, device="cpu")
    assert len(got.records) == len(want.records) == 8
    for a, b in zip(got.records, want.records):
        assert abs(a.loss - b.loss) <= TOL, (a.round, a.loss, b.loss)
        assert (a.acc is None) == (b.acc is None)
        if a.acc is not None:
            assert abs(a.acc - b.acc) <= 1.0 / N_TEST + 1e-6
        for f in ("round", "n_live", "t_start_s", "t_comm_s", "t_compute_s",
                  "t_end_s", "lam_planned", "lam_effective", "feasible",
                  "intended_links", "outage_links", "retx_packets",
                  "replanned", "mean_drift", "wire_bits", "payload_mode",
                  "n_down", "blackout_links", "n_suspect"):
            assert getattr(a, f) == getattr(b, f), f
    assert got.summary().keys() == want.summary().keys()
    assert all(np.isfinite(x).all() for x in
               (v for d in params_to_numpy(params).values()
                for v in d.values()))


def test_churn_reshapes_the_driver_state(monkeypatch):
    """A churn event mid-run shrinks the node state and the shards the
    driver gathers from: the port's driver keeps the survivors' rows and
    the JAX driver's batches (``mixed`` loses 2 nodes in 30 rounds)."""
    cfg_r = r_scenario.get_scenario("mixed", eval_every_rounds=100)
    cfg_t = t_scenario.get_scenario("mixed", eval_every_rounds=100)
    want, _ = r_trace.simulate_dpsgd_cnn(cfg_r, epochs=4, n_train=900,
                                         n_test=30)
    _patch_init(monkeypatch, "mixed")
    got, params = t_trace.simulate_dpsgd_cnn(cfg_t, epochs=4, n_train=900,
                                             n_test=30, device="cpu")
    assert [r.n_live for r in got.records] == [r.n_live
                                               for r in want.records]
    assert got.records[-1].n_live < 6
    assert t_dpsgd.node_axis_size(params) == got.records[-1].n_live
    assert got.failures == want.failures
    for a, b in zip(got.records, want.records):
        assert abs(a.loss - b.loss) <= 1e-4, (a.round, a.loss, b.loss)


def test_driver_rejects_auto_payload_and_needs_a_card_by_default(monkeypatch):
    with pytest.raises(ValueError, match="concrete payload"):
        t_trace.simulate_dpsgd_cnn(
            t_scenario.get_scenario("compressed_int8",
                                    payload=t_comp.QuantConfig(mode="auto")),
            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_trace.simulate_dpsgd_cnn(t_scenario.get_scenario("static"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_example.main(["--train", "static", "--epochs", "1"])


def test_measured_compute_stamps_the_clock():
    clock = iter(np.arange(0.0, 100.0, 0.5))
    trace, _ = t_trace.simulate_dpsgd_cnn(
        t_scenario.get_scenario("static"), epochs=1, n_train=300, n_test=30,
        measure_compute=True, compute_clock=lambda: float(next(clock)),
        device="cpu")
    assert [r.t_compute_s for r in trace.records] == [0.5, 0.5]
    assert trace.total_compute_s == 1.0
