"""The port's pod-mode step builders against the JAX package, on the CPU.

``repro_torch.train.step``: ``roll_from_neighbor`` bit-equal to the
reference's rolls on (4,), (8,) and (2, 2) node grids for every round kind;
``mix_params`` against the reference's roll mix (none, allreduce, bf16,
int8: q bit-equal, scales 1e-6 relative, mixed parameters and residuals
1e-6); ``make_train_step`` Mode A and Mode B in lockstep with the
reference's jitted step for 3 steps (each port step starts from the
reference's state; losses and every state leaf 1e-5) on the smoke configs
of stablelm-3b, qwen2-vl-2b (the test's patch embeddings fed to both; also
at remat "full" on both sides) and rwkv6-7b with int8 gossip; the default
``RunConfig`` (remat "full") stepping bit-equal to remat "none" in Mode A
and Mode B; ``chip_smoke.py``'s AdamW hold (``hold_step``) passing remat
"full" against "none" and failing where one checkpointed unit's gradient
is 1 % off; the Mode B step against ``core.dpsgd.dpsgd_step``
with the plan's W (the twin of ``tests/test_system.py``'s
``test_dpsgd_equals_reference_implementation``); ``init_train_state``'s
leaves against the reference's. Weights cross through numpy
(``convert.params_from_numpy``); inputs are drawn with numpy from seeds.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from repro.configs import RunConfig as RRunConfig
from repro.configs import get_config as r_get_config
from repro.configs import reduce_for_smoke as r_reduce
from repro.core import gossip as r_gossip
from repro.models import build as r_build
from repro.optim.schedule import constant_lr as r_constant_lr
from repro.train import step as r_step
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import dpsgd as t_dpsgd
from repro_torch.core import gossip as t_gossip
from repro_torch.kernels import gossip_mix as gm
from repro_torch.models import build, remat
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import step as t_step

LOCK = 1e-5          # the D-PSGD parity bar (ROADMAP: losses, parameters)
MIX = 1e-6           # the mix alone: one fp32 sum in another order


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(tree):
    return params_from_numpy(_np_tree(tree), "cpu")


def _max_diff(port_tree, jax_tree) -> float:
    got, want = t_dpsgd._leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    worst = 0.0
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(
            b.dtype), (a.shape, a.dtype, b.shape, b.dtype)
        if b.size:
            worst = max(worst, float(np.abs(
                a.detach().double().numpy() - b.astype(np.float64)).max()))
    return worst


# ---------------------------------------------------------------------------
# Rolls and mixes
# ---------------------------------------------------------------------------

def _plans():
    out = []
    for shape in ((4,), (8,)):
        names = ("data",)
        out += [r_gossip.ring_plan(names, shape, 1),
                r_gossip.ring_plan(names, shape, 2),
                r_gossip.hypercube_plan(names, shape),
                r_gossip.onepeer_plan(names, shape, phase=1)]
    out += [r_gossip.torus_plan(("pod", "data"), (2, 2)),
            r_gossip.ring_plan(("pod", "data"), (2, 2), 1),
            r_gossip.hypercube_plan(("pod", "data"), (2, 2))]
    return out


PLANS = _plans()


@pytest.mark.parametrize("plan", PLANS,
                         ids=[f"{p.name}{p.node_shape}" for p in PLANS])
def test_roll_from_neighbor_bit_equal(plan):
    """Every round of every plan: the rolled tensor equals the reference's
    bit for bit, on fp32, int8 and a 1-d per-node leaf."""
    kinds = {r.kind for r in plan.rounds}
    assert kinds, plan
    rng = np.random.default_rng(0)
    n = plan.n_nodes
    for x in (rng.normal(size=(n, 3, 5)).astype(np.float32),
              rng.integers(-127, 128, size=(n, 7)).astype(np.int8),
              rng.normal(size=(n,)).astype(np.float32)):
        for r in plan.rounds:
            want = np.asarray(r_step.roll_from_neighbor(jnp.asarray(x), plan,
                                                        r))
            got = t_step.roll_from_neighbor(torch.from_numpy(x), plan, r)
            np.testing.assert_array_equal(got.numpy(), want)


def _node_tree(seed, n):
    rng = np.random.default_rng(seed)
    return {"embed": {"embedding": rng.normal(size=(n, 24, 8))
                      .astype(np.float32)},
            "unit": [{"w": rng.normal(size=(n, 2, 8, 6)).astype(np.float32),
                      "scale": rng.normal(size=(n, 8)).astype(np.float32)}],
            "zero_rows": np.zeros((n, 3, 4), np.float32)}


MIX_CASES = [("none", "ring-1"), ("none", "hypercube"), ("none", "torus"),
             ("none", "allreduce"), ("bf16", "ring-1"), ("bf16", "torus"),
             ("int8", "ring-1"), ("int8", "hypercube"), ("int8", "allreduce")]


def _plan_named(name):
    if name == "torus":
        return r_gossip.torus_plan(("pod", "data"), (2, 2))
    if name == "allreduce":
        return r_gossip.allreduce_plan(("data",), (4,))
    if name == "hypercube":
        return r_gossip.hypercube_plan(("data",), (4,))
    return r_gossip.ring_plan(("data",), (4,), 1)


@pytest.mark.parametrize("compression,plan_name", MIX_CASES)
def test_mix_params_matches_reference(compression, plan_name):
    """Mixed parameters and new residuals within 1e-6 of the reference's
    roll mix; an uncompressed mix or an allreduce plan passes the
    residuals through untouched. The uncompressed and compressed receives
    go through the rows mix: one call per buffer group."""
    plan = _plan_named(plan_name)
    params = _node_tree(1, 4)
    res = jax.tree.map(lambda x: 0.01 * x, _node_tree(2, 4))
    rrun = RRunConfig(compression=compression, remat="none")
    trun = RunConfig(compression=compression, remat="none")
    want_p, want_r = r_step.mix_params(jax.tree.map(jnp.asarray, params),
                                       jax.tree.map(jnp.asarray, res), plan,
                                       rrun)
    calls = []
    rows = gm.gossip_mix_rows_plain

    def counted(w, bufs):
        calls.append(tuple(w.shape))
        return rows(w, bufs)

    gm.gossip_mix_rows_plain, saved = counted, gm.gossip_mix_rows_plain
    try:
        got_p, got_r = t_step.mix_params(_to_port(params), _to_port(res),
                                         plan, trun)
    finally:
        gm.gossip_mix_rows_plain = saved
    assert _max_diff(got_p, want_p) <= MIX
    assert _max_diff(got_r, want_r) <= MIX
    if compression == "none" or plan.kind == "allreduce":
        for a, b in zip(t_dpsgd._leaves(got_r), jax.tree.leaves(res)):
            np.testing.assert_array_equal(a.numpy(), b)
    groups = len(t_dpsgd.mix_groups([24 * 8, 2 * 8 * 6, 8, 12]))
    if plan.kind == "allreduce":
        assert calls == []
    elif compression == "none":
        assert calls == [(4, 4)] * groups
    else:
        assert calls == [(4, 8)] * groups


def test_int8_rowwise_codec_bit_equal():
    """One scale per last-dim row (a zero row's scale is 1): q bit-equal,
    scales within 1e-6 relative, on carried-like values."""
    rng = np.random.default_rng(3)
    for shape in ((4, 5, 33), (4, 64), (4, 2, 3, 7)):
        x = (rng.normal(size=shape) * rng.uniform(1e-3, 10, size=shape[:-1]
                                                  + (1,))).astype(np.float32)
        x[0, ...] = 0.0
        q_want, s_want = r_step._quantize_rowwise_int8(jnp.asarray(x))
        q_got, s_got = t_step._quantize_rowwise_int8(torch.from_numpy(x))
        assert q_got.dtype == torch.int8
        np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
        np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# Train steps in lockstep with the reference
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    mode: str
    compression: str = "none"
    optimizer: str = "sgd"
    plan: str = "ring-1"
    microbatch: int = 0
    weight_decay: float = 0.0
    eta: float = 0.05
    remat: str = "none"


CASES = [
    Case("stablelm-3b", "allreduce", optimizer="adamw", eta=1e-3),
    Case("stablelm-3b", "dpsgd", optimizer="adamw", eta=1e-3,
         weight_decay=0.1),
    Case("stablelm-3b", "dpsgd", plan="allreduce", optimizer="momentum"),
    Case("stablelm-3b", "dpsgd", compression="bf16"),
    Case("qwen2-vl-2b", "allreduce", microbatch=2),
    Case("qwen2-vl-2b", "dpsgd", microbatch=2),
    Case("rwkv6-7b", "dpsgd", compression="int8"),
    Case("qwen2-vl-2b", "allreduce", optimizer="adamw", eta=1e-3,
         remat="full"),
    Case("qwen2-vl-2b", "dpsgd", remat="full"),
]
N_NODES = 4
SEQ = 32


def _runs(case):
    kw = dict(mode=case.mode, compression=case.compression,
              optimizer=case.optimizer, momentum=0.9 if case.optimizer ==
              "momentum" else 0.0, weight_decay=case.weight_decay,
              microbatch=case.microbatch, eta=case.eta, remat=case.remat)
    return RRunConfig(**kw), RunConfig(**kw)


def _batches(cfg, case, steps):
    """Numpy batches, (B, S) for Mode A and (n, B/n, S) for Mode B, with
    the vision stub's patch embeddings where the config has one."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        b = {"tokens": rng.integers(0, cfg.vocab_size, size=(8, SEQ))
             .astype(np.int32)}
        if cfg.frontend == "vision":
            b["patch_embeds"] = rng.normal(
                size=(8, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if case.mode == "dpsgd":
            b = {k: v.reshape(N_NODES, 2, *v.shape[1:]) for k, v in b.items()}
        out.append(b)
    return out


ADAM_BETA1, ADAM_BETA2, ADAM_EPS = 0.9, 0.95, 1e-8   # make_optimizer's


def _adam_steps(m_leaves, v_leaves, t, lr):
    """lr m^ / (sqrt(v^) + eps) of every parameter, in float64 from one
    state's new moments (numpy arrays)."""
    return [lr * (m / (1 - ADAM_BETA1 ** t))
            / (np.sqrt(v / (1 - ADAM_BETA2 ** t)) + ADAM_EPS)
            for m, v in zip(m_leaves, v_leaves)]


def _assert_state_close(port, ref, lr):
    """The port's new state against the reference's. Parameters and
    residuals within LOCK; the optimizer's leaves within LOCK of their
    leaf's largest entry (AdamW's v holds squared gradients, ~1e-7 here,
    where an absolute 1e-5 would hold nothing); ``step`` and ``t`` equal.

    AdamW's step lr m^ / (sqrt(v^) + eps) is steep in g where sqrt(v^) is
    near the rounding noise of the gradient's sums: at lr 1e-3 the
    stablelm-3b smoke config's first Mode A step has a w_gate entry whose
    gradient is -1.691e-08 in the port and -1.770e-08 in the reference
    (the leaf's median |g| is 1.77e-03), so g / (|g| + eps) is -0.6284
    against -0.6389 and the entry differs by 1.049e-05. Where the two
    states' own moments give steps more than LOCK / 2 apart, the
    parameters are held within LOCK of that difference (each side's
    update from its own moments, the moments held as above); every other
    parameter within LOCK."""
    steps = None
    if "t" in ref.get("opt", {}):            # AdamW
        t = float(np.asarray(ref["opt"]["t"]))
        mine = _adam_steps(*([x.double().numpy() for x in t_dpsgd._leaves(
            port["opt"][k])] for k in ("m", "v")), t, lr)
        theirs = _adam_steps(*([np.asarray(x, np.float64) for x in
                                jax.tree.leaves(ref["opt"][k])]
                               for k in ("m", "v")), t, lr)
        steps = [a - b for a, b in zip(mine, theirs)]
    for key in ref:
        got, want = t_dpsgd._leaves(port[key]), jax.tree.leaves(ref[key])
        assert len(got) == len(want), key
        for i, (a, b) in enumerate(zip(got, want)):
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(
                b.dtype), (key, a.shape, a.dtype, b.shape, b.dtype)
            d = a.detach().double().numpy() - b.astype(np.float64)
            if not b.size:
                continue
            if key == "opt":
                scale = float(np.abs(b.astype(np.float64)).max())
                assert np.abs(d).max() <= LOCK * scale, (key, i, scale)
            elif key == "params" and steps is not None:
                amp = np.abs(steps[i]) > LOCK / 2
                assert np.abs(d[~amp]).max(initial=0.0) <= LOCK, (key, i)
                # p' = p - lr r: the two parameters differ by -(lr dr)
                assert np.abs(d + steps[i])[amp].max(initial=0.0) <= LOCK, (
                    key, i)
            else:
                assert np.abs(d).max() <= LOCK, (key, i)


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c.arch}-{c.mode}-{c.compression}-{c.optimizer}-{c.plan}"
    f"{'-mb2' if c.microbatch else ''}"
    f"{'-remat-' + c.remat if c.remat != 'none' else ''}" for c in CASES])
def test_train_step_lockstep_with_reference(case):
    """3 steps: each port step from the reference's state and batch; the
    loss within 1e-5 of the reference's jitted step and every leaf of the
    new state (parameters, optimizer state, residual, step) as
    ``_assert_state_close`` holds it."""
    jcfg = r_reduce(r_get_config(case.arch))
    tcfg = reduce_for_smoke(get_config(case.arch))
    rrun, trun = _runs(case)
    plan = _plan_named(case.plan) if case.mode == "dpsgd" else None
    r_fn = jax.jit(r_step.make_train_step(r_build(jcfg), rrun, plan,
                                          r_constant_lr(case.eta)))
    t_fn = t_step.make_train_step(build(tcfg, "cpu"), trun, plan,
                                  constant_lr(case.eta))
    state = r_step.init_train_state(r_build(jcfg), rrun, jax.random.key(0),
                                    n_nodes=N_NODES)
    if case.mode == "dpsgd":   # de-sync the nodes so mixing matters
        state["params"] = jax.tree.map(
            lambda p: p * (1 + 0.01 * jnp.arange(N_NODES).reshape(
                -1, *[1] * (p.ndim - 1))), state["params"])
    for batch in _batches(tcfg, case, 3):
        t_new, t_metrics = t_fn(_to_port(state), params_from_numpy(batch,
                                                                   "cpu"))
        state, r_metrics = r_fn(state, jax.tree.map(jnp.asarray, batch))
        d_loss = abs(float(t_metrics["loss"]) - float(r_metrics["loss"]))
        assert d_loss <= LOCK, d_loss
        assert set(t_new) == set(state)
        _assert_state_close(t_new, state, case.eta)
    assert int(t_new["step"]) == 3 and t_new["step"].dtype == torch.int32


@pytest.mark.parametrize("mode,compression,plan_name", [
    ("allreduce", "none", None), ("dpsgd", "int8", "ring"),
    ("dpsgd", "none", "allreduce")])
def test_donating_step_is_bit_equal(mode, compression, plan_name):
    """``make_train_step(donate=True)`` consumes its state and gives the
    state and loss of the step that does not, bit for bit, over 2 steps
    (AdamW); Mode B under the node mean too, whose mixed leaves are
    expanded views."""
    cfg = reduce_for_smoke(get_config("qwen2-vl-2b"))
    run = RunConfig(mode=mode, compression=compression, optimizer="adamw",
                    eta=1e-3, remat="none")
    plan = _plan_named(plan_name) if plan_name else None
    api = build(cfg, "cpu")
    steps = {d: t_step.make_train_step(api, run, plan, constant_lr(1e-3),
                                       donate=d) for d in (False, True)}
    state = t_step.init_train_state(api, run,
                                    torch.Generator().manual_seed(0),
                                    n_nodes=N_NODES)
    rng = np.random.default_rng(0)
    for _ in range(2):
        lead = (N_NODES, 2) if mode == "dpsgd" else (4,)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(*lead, 16)).astype(np.int32))}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = torch.from_numpy(rng.normal(
                size=(*lead[:-1], lead[-1], cfg.n_patches, cfg.d_model))
                .astype(np.float32))
        want, m_want = steps[False](state, batch)
        got, m_got = steps[True](
            t_dpsgd._tree_map(torch.clone, state), batch)
        assert torch.equal(m_got["loss"], m_want["loss"])
        for a, b in zip(t_dpsgd._leaves(got), t_dpsgd._leaves(want)):
            assert torch.equal(a, b)
        state = want


def test_dpsgd_step_equals_core_dpsgd():
    """Mode B trainer step == ``core.dpsgd.dpsgd_step`` with the plan's W
    (Eq. 5) for SGD on de-synced nodes, at the reference test's bars
    (rtol 2e-4, atol 2e-5); both mix in the rows mix."""
    cfg = reduce_for_smoke(get_config("stablelm-3b"))
    api = build(cfg, "cpu")
    n = 4
    plan = t_gossip.ring_plan(("data",), (n,), 1)
    run = RunConfig(mode="dpsgd", optimizer="sgd", eta=0.05, remat="none")
    step = t_step.make_train_step(api, run, plan, constant_lr(0.05))
    state = t_step.init_train_state(
        api, run, torch.Generator().manual_seed(1), n_nodes=n)
    state["params"] = t_dpsgd._tree_map(
        lambda p: p * (1 + 0.01 * torch.arange(n, dtype=p.dtype).reshape(
            -1, *[1] * (p.dim() - 1))), state["params"])
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(n, 2, 32)).astype(np.int32))
    new_state, _ = step(state, {"tokens": tokens})
    ref_params, _ = t_dpsgd.dpsgd_step(
        api.loss, state["params"], {"tokens": tokens},
        t_gossip.plan_w(plan), t_dpsgd.DPSGDConfig(eta=0.05))
    for a, b in zip(t_dpsgd._leaves(new_state["params"]),
                    t_dpsgd._leaves(ref_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


INIT_CASES = [("dpsgd", "int8", "adamw"), ("dpsgd", "none", "sgd"),
              ("dpsgd", "bf16", "momentum"), ("allreduce", "none", "adamw")]


@pytest.mark.parametrize("mode,compression,optimizer", INIT_CASES)
def test_init_train_state_leaves_match_reference(mode, compression,
                                                 optimizer):
    """The state's leaves in the reference's order, shapes and dtypes; the
    node rows replicas of one draw, the residual (iff compressed) and the
    optimizer's moments zeros, ``step`` a 0-d int32 zero."""
    kw = dict(mode=mode, compression=compression, optimizer=optimizer,
              remat="none")
    jcfg = r_reduce(r_get_config("qwen2-vl-2b"))
    tcfg = reduce_for_smoke(get_config("qwen2-vl-2b"))
    want = jax.eval_shape(lambda k: r_step.init_train_state(
        r_build(jcfg), RRunConfig(**kw), k, n_nodes=N_NODES),
        jax.random.key(0))
    got = t_step.init_train_state(build(tcfg, "cpu"), RunConfig(**kw),
                                  torch.Generator().manual_seed(0),
                                  n_nodes=N_NODES)
    assert set(got) == set(want)
    assert ("residual" in got) == (compression != "none"
                                   and mode == "dpsgd")
    w_leaves = jax.tree.leaves(want)
    g_leaves = t_dpsgd._leaves(got)
    assert [tuple(x.shape) for x in g_leaves] == [x.shape for x in w_leaves]
    assert [str(x.dtype)[6:] for x in g_leaves] == [str(x.dtype)
                                                     for x in w_leaves]
    assert got["step"].dim() == 0 and int(got["step"]) == 0
    if mode == "dpsgd":
        for p in t_dpsgd._leaves(got["params"]):
            assert torch.equal(p, p[:1].expand(p.shape))
    zeros = [got["opt"].get(k) for k in ("m", "v")] + [got.get("residual")]
    for tree in zeros:
        if tree is not None:
            assert all(not x.any() for x in t_dpsgd._leaves(tree))


@pytest.mark.parametrize("mode", ["allreduce", "dpsgd"])
def test_default_run_config_steps_with_remat_full(mode):
    """``make_train_step(api, RunConfig(mode=...))`` (remat "full", the
    default) builds and takes a step, Mode A and Mode B: its new state
    bit-equal to the same step at remat "none"."""
    cfg = reduce_for_smoke(get_config("stablelm-3b"))
    api = build(cfg, "cpu")
    run = RunConfig(mode=mode)
    assert run.remat == "full"
    plan = t_gossip.ring_plan(("data",), (N_NODES,), 1) \
        if mode == "dpsgd" else None
    state = t_step.init_train_state(api, run, torch.Generator().manual_seed(
        3), n_nodes=N_NODES)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(8, SEQ)).astype(np.int32))
    batch = {"tokens": tokens if mode == "allreduce"
             else tokens.reshape(N_NODES, 2, SEQ)}
    out = {}
    for remat in ("full", "none"):
        step = t_step.make_train_step(
            api, dataclasses.replace(run, remat=remat), plan,
            constant_lr(run.eta))
        out[remat] = step(state, batch)
    (new, metrics), (want, want_m) = out["full"], out["none"]
    assert int(new["step"]) == 1
    assert torch.equal(metrics["loss"], want_m["loss"])
    for a, b in zip(t_dpsgd._leaves(new), t_dpsgd._leaves(want)):
        assert torch.equal(a, b)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [None, 1.01], ids=["clean", "planted"])
def test_chip_smoke_adamw_hold_catches_a_wrong_recompute_gradient(
        fault, monkeypatch):
    """``chip_smoke.py``'s hold of two AdamW steps (``hold_step``, phases
    22 (c) and 23 (b)): remat "full" against "none", 2 microbatches, one
    step from one state, passes with nothing apart (the two are
    bit-equal); with one checkpointed unit's gradient scaled by ``fault``
    it fails, through AdamW's m (1 - b1) g. The parameters alone cannot
    show it: they are held to each side's own step."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-vl-2b")),
                              n_layers=2)
    api = build(cfg, "cpu")
    run = cs._pod_run("allreduce", microbatch=2)
    state = t_step.init_train_state(api, run, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(4, SEQ)).astype(np.int32)),
        "patch_embeds": torch.from_numpy(rng.normal(size=(
            4, cfg.n_patches, cfg.d_model)).astype(np.float32))}
    new = {}
    for policy in ("none", "full"):
        if policy == "full" and fault is not None:
            plain, calls = remat._Recompute.forward, []

            def once_off(*args):
                grads = plain(*args)
                calls.append(1)
                return tuple(g * fault for g in grads) if len(calls) == 1 \
                    else grads
            monkeypatch.setattr(remat._Recompute, "forward",
                                staticmethod(once_off))
        step = t_step.make_train_step(api, dataclasses.replace(
            run, remat=policy), None, constant_lr(run.eta))
        new[policy], _ = step(state, batch)
    held = cs.hold_step(torch, "full against none", new["full"],
                        new["none"], state, run.eta, True)
    if fault is None:
        assert held["opt"] == held["params"] == 0.0
        cs.report_held("full against none", held, True)
        return
    assert max(held["params"], held["params_amplified"]) <= cs.TOL_FP32
    assert held["opt"] > 100 * cs.TOL_FP32
    with pytest.raises(SystemExit):
        cs.report_held("full against none", held, True)


def test_reshape_batch_for_nodes():
    b = {"tokens": torch.arange(24).reshape(8, 3),
         "patch_embeds": torch.zeros(8, 2, 5)}
    out = t_step.reshape_batch_for_nodes(b, 4)
    assert out["tokens"].shape == (4, 2, 3)
    assert out["patch_embeds"].shape == (4, 2, 2, 5)
    assert torch.equal(out["tokens"][1, 0], b["tokens"][2])
