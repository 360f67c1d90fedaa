"""The port's simulator plane against the JAX package's: the numpy modules
copied into ``repro_torch`` (gossip plans, density controller, runtime
fault/straggler, access and schedule planners, the sim event engine) must
give exactly equal outputs, and the node-axis surgery of
``checkpoint.ckpt`` must equal the reference's on the same state.

Every registered scenario's ``precompute_trace(cfg, 6)`` is compared with
``np.array_equal`` (w_eff, live, active, time stamps, wire bits) and its
``SimTrace.summary()`` with ``==``; all run at their registered solver,
which is fast enough at 6 rounds. The example's comm-only tables print the
same text as the JAX package's example.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch

from examples import sim_scenarios as r_example
from repro.checkpoint import ckpt as r_ckpt
from repro.core import access_opt as r_access
from repro.core import density_controller as r_dc
from repro.core import gossip as r_gossip
from repro.core import sched_opt as r_sched
from repro.core.comm_model import LinkModel as RLinkModel
from repro.runtime import fault as r_fault
from repro.runtime import straggler as r_straggler
from repro.sim import scenario as r_scenario
from repro.sim import trace as r_trace
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import access_opt as t_access
from repro_torch.core import channel as t_channel
from repro_torch.core.comm_model import LinkModel as TLinkModel
from repro_torch.core import density_controller as t_dc
from repro_torch.core import gossip as t_gossip
from repro_torch.core import sched_opt as t_sched
from repro_torch.examples import sim_scenarios as t_example
from repro_torch.runtime import fault as t_fault
from repro_torch.runtime import straggler as t_straggler
from repro_torch.sim import scenario as t_scenario
from repro_torch.sim import trace as t_trace

TRACE_FIELDS = ("w_eff", "live", "active", "t_start_s", "t_comm_s",
                "t_end_s", "wire_bits")


def _same(a, b) -> bool:
    """Exact equality through dataclasses, containers and arrays (NaN ==
    NaN); classes are compared by name, since each package has its own."""
    if dataclasses.is_dataclass(a):
        return (type(a).__name__ == type(b).__name__ and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic, float)):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and bool(np.array_equal(
            a, b, equal_nan=a.dtype.kind in "fc"))
    return a == b


def test_scenario_registries_equal():
    assert t_scenario.list_scenarios() == r_scenario.list_scenarios()
    for name in r_scenario.list_scenarios():
        assert _same(t_scenario.get_scenario(name),
                     r_scenario.get_scenario(name)), name


@pytest.mark.parametrize("name", r_scenario.list_scenarios())
def test_precompute_trace_equals_reference(name):
    want = r_trace.precompute_trace(r_scenario.get_scenario(name), 6)
    got = t_trace.precompute_trace(t_scenario.get_scenario(name), 6)
    for f in TRACE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.trace.summary() == want.trace.summary()
    assert _same(got.trace.records, want.trace.records)


@pytest.mark.parametrize("name", ["mixed", "fault_chaos", "compressed_ra",
                                  "bass_energy"])
def test_long_runs_and_sweep_equal_reference(name):
    """30 rounds of the stateful worlds (churn, replans, faults, duty
    cycles): every round record equal, and ``sweep`` equal to ``run``."""
    want = r_trace.WirelessSimulator(r_scenario.get_scenario(name)).run(30)
    got = t_trace.WirelessSimulator(t_scenario.get_scenario(name)).run(30)
    assert _same(got.records, want.records)
    assert (got.replans, got.failures, got.t_end_s, got.events_processed) \
        == (want.replans, want.failures, want.t_end_s, want.events_processed)
    swept = t_trace.sweep([name], 30)[0]
    assert _same(swept.records, got.records)


def test_stack_traces_and_scan_engine():
    traces = [t_trace.precompute_trace("static", 4, seed=s) for s in (0, 1)]
    batch = t_trace.stack_traces(traces)
    want = r_trace.stack_traces(
        [r_trace.precompute_trace("static", 4, seed=s) for s in (0, 1)])
    for f in TRACE_FIELDS:
        assert np.array_equal(getattr(batch, f), getattr(want, f)), f
    assert (batch.n_traces, batch.n_rounds) == (2, 4)
    with pytest.raises(ValueError, match="homogeneous"):
        t_trace.stack_traces([traces[0], t_trace.precompute_trace("static", 3)])
    for engine in ("scan", "auto"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            t_trace.precompute_trace("static", 2, engine=engine)


@pytest.mark.parametrize("seed,round_,n_live", [(0, 0, 6), (3, 17, 4)])
def test_sampling_contracts_equal(seed, round_, n_live):
    assert np.array_equal(
        t_trace.driver_batch_indices(seed, round_, n_live, 200, 25),
        r_trace.driver_batch_indices(seed, round_, n_live, 200, 25))
    got = t_trace.model_batch_tokens(seed, round_, n_live, 2, 13, 97)
    assert np.array_equal(got, r_trace.model_batch_tokens(
        seed, round_, n_live, 2, 13, 97))
    assert np.array_equal(got, t_trace.model_batch_tokens_reference(
        seed, round_, n_live, 2, 13, 97))


@pytest.mark.parametrize("shape", [(8,), (2, 4), (16,), (4, 4)])
def test_gossip_plans_equal(shape):
    axes = ("pod", "data")[-len(shape):]
    plans = [(t_gossip.ring_plan(axes, shape, k=2),
              r_gossip.ring_plan(axes, shape, k=2)),
             (t_gossip.torus_plan(axes, shape),
              r_gossip.torus_plan(axes, shape)),
             (t_gossip.hypercube_plan(axes, shape),
              r_gossip.hypercube_plan(axes, shape)),
             (t_gossip.allreduce_plan(axes, shape),
              r_gossip.allreduce_plan(axes, shape)),
             (t_gossip.onepeer_plan(axes, shape, phase=1),
              r_gossip.onepeer_plan(axes, shape, phase=1))]
    for got, want in plans:
        assert _same(got, want)
        assert np.array_equal(t_gossip.plan_w(got), r_gossip.plan_w(want))
        for rnd_t, rnd_r in zip(got.rounds, want.rounds):
            assert t_gossip.round_crosses_pod(rnd_t, shape) \
                == r_gossip.round_crosses_pod(rnd_r, shape)
    assert t_gossip.onepeer_lambda_eff(shape) \
        == r_gossip.onepeer_lambda_eff(shape)


@pytest.mark.parametrize("axes,shape,lam,eta", [
    (("pod", "data"), (2, 16), 0.97, None), (("data",), (16,), 0.5, 0.01),
    (("data",), (16,), -1.0, None), (("pod", "data"), (2, 4), 0.95, None)])
def test_choose_plan_equal(axes, shape, lam, eta):
    got = t_dc.choose_plan(axes, shape, lam, 1e9, TLinkModel(), eta=eta)
    want = r_dc.choose_plan(axes, shape, lam, 1e9, RLinkModel(), eta=eta)
    assert _same(got, want)


def _capacity(seed, n=6, eps=5.0):
    pos = t_channel.random_placement(n, 200.0, seed=seed)
    return t_channel.capacity_matrix(
        pos, t_channel.ChannelParams(path_loss_exp=eps))


@pytest.mark.parametrize("seed", [0, 3])
def test_access_and_schedule_solutions_equal(seed):
    cap = _capacity(seed)
    assert _same(t_access.solve_access(cap, 698_880.0, 0.5),
                 r_access.solve_access(cap, 698_880.0, 0.5))
    assert _same(t_access.solve_access_joint(cap, 698_880.0, 0.5),
                 r_access.solve_access_joint(cap, 698_880.0, 0.5))
    assert _same(t_sched.solve_schedule(cap, 698_880.0),
                 r_sched.solve_schedule(cap, 698_880.0))
    assert _same(t_sched.solve_schedule(cap, 698_880.0, duty_cycle=0.5),
                 r_sched.solve_schedule(cap, 698_880.0, duty_cycle=0.5))


def test_runtime_controllers_equal():
    cap = _capacity(1)
    kw = dict(n_nodes=6, lambda_target=0.5, mode="wireless", capacity=cap,
              model_bits=698_880.0)
    got, want = t_fault.ElasticController(**kw), r_fault.ElasticController(**kw)
    assert _same(got.replan(), want.replan())
    assert _same(got.fail(3, (2,)), want.fail(3, (2,)))
    assert _same(t_fault.fallback_plan(cap, 698_880.0),
                 r_fault.fallback_plan(cap, 698_880.0))
    assert _same(t_straggler.ring_neighbors(8, 2),
                 r_straggler.ring_neighbors(8, 2))
    assert t_straggler.straggler_penalty(2, 8, 0.1, 4.0) \
        == r_straggler.straggler_penalty(2, 8, 0.1, 4.0)


def _state(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(n, 3, 4)).astype(np.float32),
                  "b": rng.normal(size=(n,)).astype(np.float32)},
            "step": np.asarray(7, dtype=np.int32)}


@pytest.mark.parametrize("survivors,n_new", [([0, 2, 4], 3), ([1, 3], 5),
                                             ([4, 0, 1], 2)])
def test_reshape_nodes_equals_reference(survivors, n_new):
    state = _state()
    got = t_ckpt.reshape_nodes(params_from_numpy(state, "cpu"), survivors,
                               n_new)
    want = r_ckpt.reshape_nodes(jax.tree.map(jnp.asarray, state), survivors,
                                n_new)
    assert _same(params_to_numpy(got), jax.tree.map(np.asarray, want))


def test_compact_and_expand_nodes_equal_reference():
    state = _state()
    live = np.array([True, False, True, True, False])
    got = t_ckpt.compact_nodes(params_from_numpy(state, "cpu"), live)
    want = r_ckpt.compact_nodes(jax.tree.map(jnp.asarray, state), live)
    assert _same(params_to_numpy(got), jax.tree.map(np.asarray, want))
    got = t_ckpt.expand_nodes(got, [0, 2, 3], 5)
    want = r_ckpt.expand_nodes(want, [0, 2, 3], 5)
    assert _same(params_to_numpy(got), jax.tree.map(np.asarray, want))
    with pytest.raises(ValueError, match="live mask"):
        t_ckpt.compact_nodes(params_from_numpy(state, "cpu"), live[:4])
    with pytest.raises(ValueError, match="out of range"):
        t_ckpt.reshape_nodes(params_from_numpy(state, "cpu"), [0, 5], 2)
    with pytest.raises(ValueError, match="survivor slots"):
        t_ckpt.expand_nodes(params_from_numpy(state, "cpu"), [0, 1], 5)


@pytest.mark.parametrize("argv", [
    ["--rounds", "3", "--scenario", "fault_*"],
    ["--rounds", "3", "--scenario", "compressed_*", "--payload", "auto"],
    ["--margin-sweep", "--rounds", "3"]])
def test_example_tables_print_the_reference_text(capsys, argv):
    r_example.main(argv)
    want = capsys.readouterr().out
    t_example.main(argv)
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("argv,match", [
    (["--train-sweep", "static"], "Queue 1 item 2"),
    (["--scale", "64"], "Queue 1 item 4"),
    (["--train", "static", "--payload", "auto"], "comm-only")])
def test_example_refuses_unported_modes(capsys, argv, match):
    with pytest.raises(SystemExit):
        t_example.main(argv)
    assert match in capsys.readouterr().err


def test_example_trains_on_the_cpu(capsys):
    t_example.main(["--train", "compressed_int8", "--device", "cpu",
                    "--epochs", "1"])
    out = capsys.readouterr().out
    # 1200 images over 6 nodes at batch 25: 8 rounds, evaluated every 2
    assert out.startswith("# compressed_int8 on cpu: 8 rounds")
    assert len(out.strip().splitlines()) == 2 + 4


@pytest.mark.parametrize("flag,names", [
    ("--mac-compare", ("static", "ra_static", "ra_capture")),
    ("--policy-compare", ("fading", "ra_fading", "bass_fading"))])
def test_example_compare_demos_on_the_cpu(capsys, flag, names):
    """Each scenario through the per-round driver: 600 images over 6 nodes
    at batch 25 is 4 rounds, evaluated every 2, then one summary line."""
    t_example.main([flag, "--device", "cpu", "--epochs", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("scenario,")
    assert [ln.split(",")[0] for ln in lines[1:7]] == [
        n for n in names for _ in range(2)]
    assert len(lines) == 10
    assert all(ln.startswith(f"# {n}") for ln, n in zip(lines[7:], names))
