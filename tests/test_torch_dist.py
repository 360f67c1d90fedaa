"""The node axis over a gloo world of four ranks, against the JAX package.

One world for the module: four processes (``tests/torch_dist_cases.py``,
a ``FileStore`` in a temporary directory) run every case and hand back
their gathered results; the JAX package's side runs in one subprocess on
8 host devices, as ``tests/test_dist.py`` runs it. On the same numpy
inputs:

* ``core.gossip.gossip_mix_array`` and ``gossip_mix_tree`` (fused and per
  leaf) for every plan kind — ring k 1 and 2, torus, hypercube, one-peer,
  allreduce — with 2 nodes a rank (8 nodes) and 1 (4 nodes): against
  ``plan_w @ X`` and the JAX ``shard_map`` run of ``gossip_mix_array``
  (fp32 1e-6 relative);
* ``compressed_gossip_mix_array`` / ``_buffers`` for none, bf16 and int8,
  with and without error feedback, against the JAX ``shard_map`` run
  (outputs and residuals 1e-6); the send's q bit-equal to the JAX
  quantizer's and its scales at rtol 1e-6;
* ``train.shardings``' specs equal to the JAX specs for every arch's smoke
  parameters (the JAX side on a duck mesh: jax 0.9.0's ``AbstractMesh``
  pair form raises, ROADMAP Queue 3), and its shard / gather round trip;
* Mode B (``train.step.make_train_step(group=...)``) on 4 ranks x 1 node
  and 2 ranks x 2 nodes, two steps from the JAX jitted step's states:
  bit-equal to the one-process port step (the node mean 1e-6) and within
  the lockstep bar of the JAX step, for none, bf16, int8 and allreduce.
"""
import os
import pickle
import subprocess
import sys
import textwrap
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
from repro.train import shardings as r_shr
from repro.train import step as r_step
from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.core import gossip as t_gossip
from repro_torch.kernels import quantize as t_qz
from repro_torch.models import build
from repro_torch.train import shardings as t_shr

ROOT = Path(__file__).resolve().parents[1]
MIX = 1e-6           # the mix alone: one fp32 sum in another order
LOCK = 1e-5          # the D-PSGD parity bar (ROADMAP: losses, parameters)
WORLD = 4

# (kind, axis names, node shape, arg): the plans the fleet runs
PLANS = {
    "ring1-8": ("ring", ("data",), (8,), 1),
    "ring2-8": ("ring", ("data",), (8,), 2),
    "torus-2x4": ("torus", ("pod", "data"), (2, 4), None),
    "hypercube-8": ("hypercube", ("data",), (8,), None),
    "onepeer-8": ("onepeer", ("data",), (8,), 1),
    "allreduce-8": ("allreduce", ("data",), (8,), None),
    "ring1-4": ("ring", ("data",), (4,), 1),
    "hypercube-4": ("hypercube", ("data",), (4,), None),
}
BF16_PLANS = ("ring1-8", "torus-2x4", "allreduce-8")
BF16 = 3e-2          # the gossip kernel's bf16 bar (tests/test_kernels.py)
COMPRESSED = {
    "none": (PLANS["ring1-8"], "none", True),
    "bf16": (PLANS["ring1-8"], "bf16", True),
    "bf16-noef": (PLANS["torus-2x4"], "bf16", False),
    "int8": (PLANS["ring1-8"], "int8", True),
    "int8-noef": (PLANS["hypercube-8"], "int8", False),
    "int8-4": (PLANS["ring1-4"], "int8", True),
    "int8-allreduce": (PLANS["allreduce-8"], "int8", True),
}
MODE_B = {
    "none": dict(compression="none", plan=PLANS["ring1-4"]),
    "bf16": dict(compression="bf16", plan=PLANS["ring1-4"]),
    "int8": dict(compression="int8", plan=PLANS["ring1-4"]),
    "allreduce": dict(compression="none",
                      plan=("allreduce", ("data",), (4,), None)),
}
MODE_B_ARCH = "stablelm-3b"
MODE_B_STEPS = 2
ETA = 0.05


def _r_plan(spec):
    kind, names, shape, arg = spec
    if kind == "ring":
        return r_gossip.ring_plan(names, shape, arg)
    if kind == "torus":
        return r_gossip.torus_plan(names, shape)
    if kind == "hypercube":
        return r_gossip.hypercube_plan(names, shape)
    if kind == "onepeer":
        return r_gossip.onepeer_plan(names, shape, phase=arg)
    return r_gossip.allreduce_plan(names, shape)


# The JAX package's side: gossip_mix_array and compressed_gossip_mix_array
# under shard_map, one node a host device; results as an npz.
JAX_SIDE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.core import gossip as g
from repro.core.compression import QuantConfig, compressed_gossip_mix_array

inp = pickle.load(open(sys.argv[1], "rb"))

def plan_of(spec):
    kind, names, shape, arg = spec
    if kind == "ring":
        return g.ring_plan(names, shape, arg)
    if kind == "torus":
        return g.torus_plan(names, shape)
    if kind == "hypercube":
        return g.hypercube_plan(names, shape)
    if kind == "onepeer":
        return g.onepeer_plan(names, shape, phase=arg)
    return g.allreduce_plan(names, shape)

def mesh_of(plan):
    axt = getattr(jax.sharding, "AxisType", None)
    kw = dict(axis_types=(axt.Auto,) * len(plan.axis_names)) if axt else {}
    devs = np.asarray(jax.devices()[:plan.n_nodes]).reshape(plan.node_shape)
    return jax.sharding.Mesh(devs, plan.axis_names, **kw)

out = {}
for key, spec in inp["plans"].items():
    plan = plan_of(spec)
    spec_p = P(plan.axis_names)
    fn = shard_map(lambda v: g.gossip_mix_array(v[0], plan)[None],
                   mesh=mesh_of(plan), in_specs=spec_p, out_specs=spec_p)
    out["array/" + key] = np.asarray(jax.jit(fn)(jnp.asarray(
        inp["x"][plan.n_nodes])))
    if key in inp["bf16_plans"]:
        out["bf16/" + key] = np.asarray(jax.jit(fn)(jnp.asarray(
            inp["x"][plan.n_nodes]).astype(jnp.bfloat16)).astype(
                jnp.float32))
for key, (spec, mode, ef) in inp["compressed"].items():
    plan = plan_of(spec)
    cfg = QuantConfig(mode=mode, error_feedback=ef)
    spec_p = P(plan.axis_names)
    def body(v, r):
        m, e = compressed_gossip_mix_array(v[0], r[0], plan, cfg)
        return m[None], e[None]
    fn = shard_map(body, mesh=mesh_of(plan), in_specs=(spec_p, spec_p),
                   out_specs=(spec_p, spec_p))
    m, e = jax.jit(fn)(jnp.asarray(inp["cx"][plan.n_nodes]),
                       jnp.asarray(inp["cres"][plan.n_nodes]))
    out["mixed/" + key] = np.asarray(m)
    out["res/" + key] = np.asarray(e)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _mode_b_reference():
    """Per Mode B case: the JAX jitted step's states, each step from the
    last (numpy), its losses, and the inputs each port step starts from."""
    jcfg = r_reduce(r_get_config(MODE_B_ARCH))
    rng = np.random.default_rng(11)
    out = {}
    for key, case in MODE_B.items():
        run_kw = dict(mode="dpsgd", compression=case["compression"],
                      optimizer="sgd", eta=ETA, remat="none")
        plan = _r_plan(case["plan"])
        fn = jax.jit(r_step.make_train_step(
            r_build(jcfg), RRunConfig(**run_kw), plan, r_constant_lr(ETA)))
        state = r_step.init_train_state(r_build(jcfg), RRunConfig(**run_kw),
                                        jax.random.key(0), n_nodes=4)
        # de-sync the nodes so mixing matters
        state["params"] = jax.tree.map(
            lambda p: p * (1 + 0.01 * jnp.arange(4).reshape(
                -1, *[1] * (p.ndim - 1))), state["params"])
        steps, want = [], []
        for _ in range(MODE_B_STEPS):
            batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(
                4, 2, 16)).astype(np.int32)}
            steps.append((jax.tree.map(np.asarray, state), batch))
            state, metrics = fn(state, jax.tree.map(jnp.asarray, batch))
            want.append((jax.tree.map(np.asarray, state),
                         float(metrics["loss"])))
        out[key] = {"arch": MODE_B_ARCH, "run": run_kw, "plan": case["plan"],
                    "steps": steps, "want": want}
    return out


def _inputs():
    rng = np.random.default_rng(0)
    x = {n: rng.normal(size=(n, 16)).astype(np.float32) for n in (4, 8)}
    tree = {n: {"a": rng.normal(size=(n, 3, 5)).astype(np.float32),
                "b": rng.normal(size=(n, 7)).astype(np.float32),
                "h": rng.normal(size=(n, 6)).astype(np.float32)
                .astype(jnp.bfloat16).astype(np.float32)}
            for n in (4, 8)}
    cx = {n: rng.normal(size=(n, 3000)).astype(np.float32) for n in (4, 8)}
    cres = {n: (0.01 * rng.normal(size=(n, 3000))).astype(np.float32)
            for n in (4, 8)}
    return {"plans": PLANS, "x": x, "tree": tree, "cx": cx, "cres": cres,
            "compressed": COMPRESSED, "bf16_plans": BF16_PLANS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist4")
    inp = _inputs()
    with open(root / "jax_inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    jax_side = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE),
         str(root / "jax_inputs.pkl"), str(root / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    mode_b = _mode_b_reference()
    inp["mode_b"] = {k: {kk: vv for kk, vv in v.items() if kk != "want"}
                     for k, v in mode_b.items()}
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_cases.py"),
         "four", str(r), str(WORLD), str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    for p in ranks + [jax_side]:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    results = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return {"inputs": inp, "ranks": results, "mode_b": mode_b,
            "jax": dict(np.load(root / "jax.npz"))}


def test_fleet_places_every_rank(world):
    got = [r["fleet"] for r in world["ranks"]]
    assert got == [(WORLD, r, (0, 1, 2, 3)) for r in range(WORLD)]


def test_mesh_builders_name_their_axes_and_refuse_a_larger_mesh(world):
    """``launch.mesh``: a (2, 2) host mesh over the world of four has the
    reference's axis names, replica axes and TP size; a fleet mesh of 3 x
    2 and the production meshes (256 and 512 ranks) raise ``ValueError``
    naming the ranks they need and the world's 4, never a reshaped mesh."""
    for rank in world["ranks"]:
        got = rank["mesh"]
        assert got["host"] == (("data", "model"), ("data",), 2, (2, 2))
        for name, need in (("fleet 3x2", "3x2=6"),
                           ("production", "16x16=256"),
                           ("multi-pod", "2x16x16=512")):
            assert got[name] is not None, name
            assert need in got[name] and "only 4" in got[name], got[name]


@pytest.mark.parametrize("key", list(PLANS))
def test_gossip_mix_array_matches_dense_w_and_shard_map(world, key):
    plan = _r_plan(PLANS[key])
    x = world["inputs"]["x"][plan.n_nodes]
    want = (r_gossip.plan_w(plan) @ x.astype(np.float64)).astype(np.float32)
    for rank in world["ranks"]:           # every rank gathered the same
        got = rank["gossip"][("array", key)]
        np.testing.assert_allclose(got, want, rtol=MIX, atol=MIX)
        np.testing.assert_allclose(got, world["jax"]["array/" + key],
                                   rtol=MIX, atol=MIX)


@pytest.mark.parametrize("key", BF16_PLANS)
def test_gossip_mix_array_bf16_rounds_once(world, key):
    """bf16 leaves: the fleet's mix sums in fp32 and rounds once, so it is
    held exactly against the plain rows mix over the rank's [x; recv_1 ..
    recv_d] (the node mean: bf16 of the fp32 mean), and within the bf16
    bar of the reference, which rounds after every term."""
    from repro_torch.kernels.gossip_mix import gossip_mix_rows_plain

    plan = _r_plan(PLANS[key])
    x = torch.from_numpy(world["inputs"]["x"][plan.n_nodes]).to(
        torch.bfloat16)
    if plan.kind == "allreduce":
        want = x.float().sum(0, keepdim=True) / torch.full((), plan.n_nodes)
        want = want.to(torch.bfloat16).expand(x.shape)
    else:
        w = t_gossip._round_weights(plan, 1, x.device)
        src = [{d: s for s, d in r.perm(plan.node_shape)}
               for r in plan.rounds]
        want = torch.cat([gossip_mix_rows_plain(
            w, torch.stack([x[i]] + [x[m[i]] for m in src]))
            for i in range(plan.n_nodes)])
    got = world["ranks"][0]["gossip"][("array_bf16", key)]
    np.testing.assert_array_equal(got, want.float().numpy())
    np.testing.assert_allclose(got, world["jax"]["bf16/" + key], rtol=BF16,
                               atol=BF16)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-leaf"])
@pytest.mark.parametrize("key", list(PLANS))
def test_gossip_mix_tree_matches_dense_w(world, key, fused):
    plan = _r_plan(PLANS[key])
    w = r_gossip.plan_w(plan)
    tree = world["inputs"]["tree"][plan.n_nodes]
    got = world["ranks"][0]["gossip"][("tree", key, fused)]
    assert sorted(got) == sorted(tree)
    for name, x in tree.items():
        want = (w @ x.reshape(len(x), -1).astype(np.float64)).reshape(
            x.shape)
        np.testing.assert_allclose(got[name], want, rtol=MIX, atol=MIX)


@pytest.mark.parametrize("key", list(COMPRESSED))
def test_compressed_gossip_matches_shard_map(world, key):
    spec, mode, ef = COMPRESSED[key]
    n = _r_plan(spec).n_nodes
    mixed, res = world["ranks"][0]["compressed"][key]
    np.testing.assert_allclose(mixed, world["jax"]["mixed/" + key],
                               rtol=MIX, atol=MIX)
    np.testing.assert_allclose(res, world["jax"]["res/" + key],
                               rtol=MIX, atol=MIX)
    if not ef or mode == "none":      # the residual passes through untouched
        np.testing.assert_array_equal(res, world["inputs"]["cres"][n])


def test_int8_send_matches_the_jax_quantizer(world):
    """The send the int8 exchange moves: q bit-equal to the reference's
    ``quantize_int8`` of x + e, scales at rtol 1e-6."""
    from repro.core.compression import quantize_int8

    x, res = world["inputs"]["cx"][8], world["inputs"]["cres"][8]
    q, scales, _ = t_qz.quantize_int8_ef(
        torch.from_numpy(x), torch.from_numpy(res),
        torch.ones(8, dtype=torch.bool))
    for i in range(8):
        rq, rs, _ = quantize_int8(jnp.asarray(x[i] + res[i]))
        np.testing.assert_array_equal(q[i].numpy(), np.asarray(rq))
        np.testing.assert_allclose(scales[i].numpy(), np.asarray(rs),
                                   rtol=1e-6)


def _spec_leaves(specs) -> list:
    """The port's ``P`` leaves of a spec tree in ``jax.tree``'s order (a
    ``P`` is a tuple, which the tree helpers would walk into)."""
    if isinstance(specs, t_shr.P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [s for item in specs for s in _spec_leaves(item)]


class _DuckMesh:
    """What ``node_param_specs`` reads of a mesh: axis names and sizes."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_specs_equal_the_jax_specs(arch):
    from repro.models import build as rb

    jcfg = r_reduce(r_get_config(arch))
    shapes = jax.eval_shape(rb(jcfg).init, jax.random.key(0))
    tparams = build(reduce_for_smoke(get_config(arch)), "cpu").init(
        torch.Generator().manual_seed(0))
    stacked = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        (4, *s.shape), s.dtype), shapes)
    t_stacked = t_shr._map_with_path(
        lambda _, x: x.new_empty((4, *x.shape)), tparams)

    for tp in (1, 2, 4):
        want = jax.tree.leaves(r_shr.param_specs(shapes, tp, jcfg.kv_dim),
                               is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec))
        got = _spec_leaves(t_shr.param_specs(tparams, tp,
                                                       jcfg.kv_dim))
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
    for fleet, model in ((2, 2), (4, 1), (3, 2)):
        mesh = _DuckMesh({"fleet": fleet, "model": model})
        want = jax.tree.leaves(
            r_shr.node_param_specs(stacked, mesh, jcfg.kv_dim),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = _spec_leaves(
            t_shr.node_param_specs(t_stacked, mesh, jcfg.kv_dim))
        assert [tuple(s) for s in got] == [tuple(s) for s in want]


def test_shardings_cache_batch_and_prepend_specs_equal_the_jax_specs():
    rng = np.random.default_rng(3)
    caches = {"layers": [{"k": rng.normal(size=(2, 4, 6, 8)).astype(
        np.float32), "pos": np.zeros(6, np.int32)}],
        "state": rng.normal(size=(4, 3)).astype(np.float32),
        "step": np.zeros((), np.int32)}
    t_caches = t_shr._map_with_path(lambda _, x: torch.from_numpy(x),
                                    caches)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for tp, shards in ((2, 2), (4, 1), (3, 4)):
        want = jax.tree.leaves(r_shr.cache_specs(
            caches, tp, ("data",), 4, shards), is_leaf=is_p)
        got = _spec_leaves(t_shr.cache_specs(
            t_caches, tp, ("data",), 4, shards))
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
        want = jax.tree.leaves(r_shr.batch_specs(
            caches, ("pod", "data"), 4, shards), is_leaf=is_p)
        got = _spec_leaves(t_shr.batch_specs(
            t_caches, ("pod", "data"), 4, shards))
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
    specs = r_shr.param_specs(jax.tree.map(jnp.asarray, {"wq": np.zeros(
        (8, 4), np.float32)}), 2)
    want = jax.tree.leaves(r_shr.prepend_axes(specs, "fleet"), is_leaf=is_p)
    got = _spec_leaves(t_shr.prepend_axes(t_shr.param_specs(
        {"wq": torch.zeros(8, 4)}, 2), "fleet"))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]


def test_shard_gather_scatter_on_a_fleet_of_one():
    """A fleet of one keeps every leaf whole; a replicated node axis (6 over
    4) is kept whole on each rank."""
    state = {"p": torch.arange(12.0).reshape(4, 3), "step": torch.tensor(2)}
    one = t_shr.fleet_of(None)
    assert t_shr.shard_nodes(state, one, 4) is state
    assert t_shr.gather_nodes(state, one, 4) is state
    back = t_shr.scatter_nodes(state, state, one, 4)
    assert torch.equal(back["p"], state["p"])
    four = t_shr.Fleet(None, 4, 1, (0, 1, 2, 3))
    assert four.sharded(8) and four.block(8) == (2, 4)
    assert not four.sharded(6) and four.block(6) == (0, 6)
    assert t_shr.shard_nodes({"p": torch.zeros(6, 2)}, four, 6)["p"].shape \
        == (6, 2)


def test_gather_to_rank_zero_lands_on_its_host_and_scatters_back(world):
    """``gather_nodes`` to fleet index 0 hands rank 0 the whole node axis in
    host memory (None elsewhere), equal to the all-gather every rank gets;
    ``scatter_nodes`` gives each rank its block back, the 0-d leaf
    broadcast."""
    tree = world["inputs"]["tree"][8]
    to_zero, devices = world["ranks"][0]["gather"]["to_zero"]
    assert devices == ["cpu"]
    assert int(to_zero["step"]) == 3
    for r, res in enumerate(world["ranks"]):
        assert (res["gather"]["to_zero"] is None) == (r != 0)
        assert res["gather"]["back"]
        for k, v in tree.items():
            np.testing.assert_array_equal(res["gather"]["every"][k], v)
            np.testing.assert_array_equal(to_zero[k], v)


def test_receive_halves_per_emulated_rank_equal_the_one_process_mix():
    """Each rank's receive half, fed the rows its exchange would hand it
    (a four-rank ring, one node a rank, emulated in one process), is
    bit-equal to that rank's row of the one-process mix: ``mix_received``
    (gossip_mix_array), ``compression.receive_q8`` (its int8 receive), and
    the family's ``dpsgd.receive_q8_block`` / ``receive_bf16_block`` over
    every node's payload."""
    from repro_torch.core import compression as t_comp
    from repro_torch.core import dpsgd as t_dpsgd

    rng = np.random.default_rng(30)
    plan = t_gossip.ring_plan(("data",), (4,), 1)
    n, lanes = plan.n_nodes, 5000
    x = torch.from_numpy(rng.standard_normal((n, lanes), dtype=np.float32))
    res = torch.from_numpy(
        0.01 * rng.standard_normal((n, lanes), dtype=np.float32))
    w = torch.as_tensor(t_gossip.plan_w(plan), dtype=torch.float32)
    live = torch.ones(n, dtype=torch.bool)
    int8 = t_comp.QuantConfig(mode="int8")
    whole = t_gossip.gossip_mix_array(x, plan)
    whole8, _ = t_comp.compressed_gossip_mix_array(x, res, plan, int8)
    fam8, _ = t_dpsgd._compress_and_mix(x, res, w, live, int8)
    fam16, _ = t_dpsgd._compress_and_mix(
        x, res, w, live, t_comp.QuantConfig(mode="bf16"))
    q, scales, _ = t_qz.quantize_int8_ef(x, res, live, True)
    msg = (x + res).to(torch.bfloat16)
    for r in range(n):
        src = [next(s for s, d in rnd.perm(plan.node_shape) if d == r)
               for rnd in plan.rounds]
        mine = x[r:r + 1]
        got = t_gossip.mix_received(mine, [x[j:j + 1] for j in src], plan)
        assert torch.equal(got[0], whole[r])
        got = t_comp.receive_q8(mine, [q[j:j + 1] for j in src],
                                [scales[j:j + 1] for j in src], plan)
        assert torch.equal(got[0], whole8[r])
        assert torch.equal(
            t_dpsgd.receive_q8_block(w, r, mine, q, scales)[0], fam8[r])
        assert torch.equal(
            t_dpsgd.receive_bf16_block(w, r, mine, msg)[0], fam16[r])


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
@pytest.mark.parametrize("key", list(MODE_B))
def test_mode_b_over_ranks_in_lockstep(world, key, layout):
    """Each fleet step from the JAX step's state: bit-equal to the
    one-process port step (the node mean within 1e-6: its fp32 sum runs
    over the ranks), within 1e-5 of the JAX jitted step."""
    got = world["ranks"][0]["mode_b"][(key, layout)]
    one = world["ranks"][0]["mode_b"][(key, "4x1")]
    for i, (item, ref) in enumerate(zip(got, one)):
        want_state, want_loss = world["mode_b"][key]["want"][i]
        assert abs(item["loss"] - want_loss) <= LOCK
        assert item["loss"] == ref["one"]["loss"]
        for k in want_state:
            a = jax.tree.leaves(item["state"][k])
            b = jax.tree.leaves(ref["one"]["state"][k])
            c = jax.tree.leaves(want_state[k])
            assert len(a) == len(b) == len(c), k
            for x, y, z in zip(a, b, c):
                x, y, z = np.asarray(x), np.asarray(y), np.asarray(z)
                assert x.shape == z.shape and x.dtype == z.dtype, k
                if key == "allreduce":
                    np.testing.assert_allclose(x, y, rtol=MIX, atol=MIX)
                else:
                    np.testing.assert_array_equal(x, y)
                np.testing.assert_allclose(
                    x.astype(np.float64), z.astype(np.float64), rtol=0,
                    atol=LOCK)
    # every rank of the layout holds the same gathered state
    members = range(WORLD) if layout == "4x1" else range(2)
    for r in members:
        other = world["ranks"][r]["mode_b"][(key, layout)]
        for a, b in zip(other, got):
            for x, y in zip(jax.tree.leaves(a["state"]),
                            jax.tree.leaves(b["state"])):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
