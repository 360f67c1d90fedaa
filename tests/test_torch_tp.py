"""Tensor parallelism over a gloo world of four ranks, against the JAX package.

One world for the module (``tests/torch_dist_cases.py tp``, a
``FileStore`` in a temporary directory), laid out as a (fleet 2, model 2)
mesh and as a (1, 4) mesh: a model axis of 2 and of 4. The JAX side runs
on one device in this process, on the same numpy inputs. Held:

* shard and gather: every leaf's shard has the shape the JAX
  ``param_specs`` give it (qwen2-vl's head split at ``tp`` 4, and a narrow
  config whose ``kv_dim`` does not divide: replicated kv under sharded q);
  the round trip is bit-equal;
* the loss, the gathered logits and the gathered gradients of the five
  dense archs' smoke configs and the narrow one, at ``tp`` 2 and 4, within
  1e-5 of ``repro.models`` ``lm_loss``, ``apply`` and ``jax.grad``;
* remat "full" and "dots" under tensor parallelism bit-equal to "none";
* Mode A (AdamW with a gradient clip, the batch split over the fleet) and
  Mode B (ring-1, none and int8) in lockstep with the JAX steps; the int8
  scales on the shards bit-equal to a one-process quantization;
* the replicated leaves bit-equal across the model ranks after the steps;
* ``real_model_smoke.run(fleet=2, model=2)`` reports ``ok``, on fading
  and on compressed_int8 (the int8 family within 1e-5 of one device);
* ``train_loop --nodes 1 --tp 2 --mode allreduce`` (two replicas): its
  checkpoint the one process's, gathered from one replica's model axis;
* ``train_loop --nodes 2 --tp 2`` (fault drill, checkpoints, resume):
  losses within 1e-4 of the port's one-process run, the checkpoints the
  JAX package's global arrays, the resume bit-equal;
* the ``pod_gossip_train`` twin at 2 x 2 for 3 steps within 1e-4 of the
  JAX step from the same initial parameters, plan and batches;
* import hygiene: neither ``jax`` nor ``repro`` in any rank's modules.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
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
from repro.models import transformer as r_transformer
from repro.optim import optimizers as r_optim
from repro.optim.schedule import constant_lr as r_constant_lr
from repro.train import shardings as r_shr
from repro.train import step as r_step
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.launch import train as t_train
from repro_torch.models import build, tp

from test_torch_train_step import _assert_state_close

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
PARITY = 1e-5        # losses, logits, gradients, lockstep parameters
LOSS_TOL = 1e-4      # free-running losses (train_loop, the twin)
DENSE = ["stablelm-3b", "gemma3-12b", "qwen2-vl-2b", "qwen2.5-14b",
         "nemotron-4-15b"]
# kv_dim 6 does not divide over 4 (wk / wv replicated), q_dim 24 does
NARROW = ("qwen2.5-14b", {"n_heads": 4, "n_kv_heads": 1, "head_dim": 6,
                          "name": "narrow-kv"})
MODEL_CASES = {a: (a, {}) for a in DENSE} | {"narrow": NARROW}
MODE_A = {"arch": "gemma3-12b", "clip": 0.05, "eta": 1e-3}
MODE_B_ARCH, MODE_B_ETA = "qwen2-vl-2b", 1e-3
STEPS = 2
TRAIN = {"arch": "qwen2-vl-2b", "steps": 6, "ckpt_every": 2, "fail_at": 3,
         "run": {"mode": "dpsgd", "compression": "int8",
                 "optimizer": "adamw", "eta": 0.01, "remat": "none",
                 "lambda_target": 0.8}}
# momentum SGD: linear in the gradient, so the checkpoint is held within
# 1e-5 (AdamW's sign-like first steps move a near-zero gradient's element
# by up to eta between two summation orders)
TRAIN_A = {"arch": "qwen2-vl-2b", "steps": 2, "batch": 4,
           "run": {"mode": "allreduce", "optimizer": "momentum",
                   "momentum": 0.9, "eta": 0.01, "remat": "none"}}
TWIN_STEPS = 3
CKPT_STEP = 4        # a checkpoint both trainer runs keep


def _jcfg(arch, repl):
    return dataclasses.replace(r_reduce(r_get_config(arch)), **repl)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, rng, b, lead=()):
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(*lead, b, 16)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.normal(size=(*lead, b, cfg.n_patches,
                                               cfg.d_model)).astype(
            np.float32)
    return out


def _model_inputs():
    """Per config: numpy parameters and batch."""
    rng = np.random.default_rng(3)
    inp = {}
    for i, (key, (arch, repl)) in enumerate(MODEL_CASES.items()):
        cfg = _jcfg(arch, repl)
        inp[key] = {"arch": arch, "replace": repl,
                    "params": _np(r_build(cfg).init(jax.random.key(i))),
                    "batch": _batch(cfg, rng, 2)}
    return inp


def _model_refs(inp):
    """Per config: the JAX side's loss, logits and gradients, and the
    specs at tp 2 and 4."""
    want = {}
    for key, case in inp.items():
        cfg = _jcfg(case["arch"], case["replace"])
        params, jb = case["params"], jax.tree.map(jnp.asarray, case["batch"])
        loss, grads = jax.jit(jax.value_and_grad(r_build(cfg).loss))(
            params, jb)
        logits = r_transformer.apply(cfg, params, jb["tokens"],
                                     patch_embeds=jb.get("patch_embeds"))
        want[key] = {"loss": float(loss), "logits": np.asarray(logits),
                     "grads": _np(grads),
                     "specs": {t: r_shr.param_specs(params, t, cfg.kv_dim)
                               for t in (2, 4)}}
    return want


def _mode_a():
    """Mode A from the JAX side: value_and_grad over the whole batch, then
    AdamW with the clip, each step from the last."""
    cfg = r_reduce(r_get_config(MODE_A["arch"]))
    api = r_build(cfg)
    run = RRunConfig(mode="allreduce", optimizer="adamw", eta=MODE_A["eta"],
                     remat="none")
    opt = r_optim.make_optimizer("adamw", grad_clip=MODE_A["clip"])
    state = r_step.init_train_state(api, run, jax.random.key(7))
    lr = r_constant_lr(MODE_A["eta"])

    @jax.jit
    def step(state, batch):
        loss, grads = jax.value_and_grad(api.loss)(state["params"], batch)
        params, new_opt = opt.update(grads, state["opt"], state["params"],
                                     lr(state["step"]))
        return {**state, "params": params, "opt": new_opt,
                "step": state["step"] + 1}, loss

    rng = np.random.default_rng(5)
    steps, want = [], []
    for _ in range(STEPS):
        batch = _batch(cfg, rng, 4)
        steps.append((_np(state), batch))
        state, loss = step(state, jax.tree.map(jnp.asarray, batch))
        want.append((_np(state), float(loss)))
    return ({"arch": MODE_A["arch"], "clip": MODE_A["clip"],
             "run": {"mode": "allreduce", "optimizer": "adamw",
                     "eta": MODE_A["eta"], "remat": "none"},
             "steps": steps}, want)


def _mode_b():
    """Mode B's JAX jitted steps (4 nodes, ring-1), none and int8."""
    cfg = r_reduce(r_get_config(MODE_B_ARCH))
    plan = r_gossip.ring_plan(("data",), (4,), 1)
    rng = np.random.default_rng(11)
    inp, want = {}, {}
    for comp in ("none", "int8"):
        kw = {"mode": "dpsgd", "compression": comp, "optimizer": "adamw",
              "eta": MODE_B_ETA, "remat": "none"}
        fn = jax.jit(r_step.make_train_step(r_build(cfg), RRunConfig(**kw),
                                            plan, r_constant_lr(MODE_B_ETA)))
        state = r_step.init_train_state(r_build(cfg), RRunConfig(**kw),
                                        jax.random.key(0), n_nodes=4)
        state["params"] = jax.tree.map(
            lambda p: p * (1 + 0.01 * jnp.arange(4).reshape(
                -1, *[1] * (p.ndim - 1))), state["params"])
        steps, got = [], []
        for _ in range(STEPS):
            batch = _batch(cfg, rng, 2, lead=(4,))
            steps.append((_np(state), batch))
            state, metrics = fn(state, jax.tree.map(jnp.asarray, batch))
            got.append((_np(state), float(metrics["loss"])))
        inp[comp] = {"arch": MODE_B_ARCH, "run": kw,
                     "plan": ("ring", ("data",), (4,), 1), "steps": steps}
        want[comp] = got
    return inp, want


def _twin_inputs():
    """The twin's initial parameters (one replica) and batches, numpy."""
    cfg = r_reduce(r_get_config("gemma3-12b"))
    rng = np.random.default_rng(13)
    return {"init": _np(r_build(cfg).init(jax.random.key(0))),
            "batches": [rng.integers(0, cfg.vocab_size, size=(2, 4, 64))
                        .astype(np.int32) for _ in range(TWIN_STEPS)]}


def _twin(inp):
    """The pod_gossip_train twin's JAX side at 2 nodes: its plan and
    RunConfig, one device, from the numpy parameters and batches."""
    from dataclasses import replace

    from repro.core.comm_model import LinkModel
    from repro.core.density_controller import choose_plan

    nodes = 2
    cfg = r_reduce(r_get_config("gemma3-12b"))
    api = r_build(cfg)
    run = RRunConfig(mode="dpsgd", optimizer="adamw", eta=1e-3,
                     lambda_target=0.9, compression="int8", remat="none")
    choice = choose_plan(("pod", "data"), (2, nodes // 2), run.lambda_target,
                         bytes_per_rank=1e6, link=LinkModel(dci_penalty=16.0))
    plan = (replace(choice.plan, axis_names=("data",), node_shape=(nodes,))
            if choice.plan.kind == "gossip"
            else r_gossip.ring_plan(("data",), (nodes,), 1))
    init = inp["init"]
    state = r_step.init_train_state(api, run, jax.random.key(0),
                                    n_nodes=nodes)
    state["params"] = jax.tree.map(
        lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (nodes, *p.shape)),
        init)
    opt = r_optim.make_optimizer("adamw")
    state["opt"] = opt.init(state["params"])
    state["residual"] = jax.tree.map(jnp.zeros_like, state["params"])
    fn = jax.jit(r_step.make_train_step(api, run, plan, r_constant_lr(1e-3),
                                        node_axes=("data",)))
    losses = []
    for b in inp["batches"]:
        state, m = fn(state, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
    return {"losses": losses, "plan": plan.name}


def _checkpoint(step_dir):
    """A checkpoint's manifest and its leaves (numpy, in leaf order)."""
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(step_dir, "host0.npz")) as data:
        leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    return manifest, leaves


def _one_process_train():
    """The port's train_loop in this process (no world) on the trainer
    case: the losses the four ranks are held against, and its first
    checkpoint's manifest; and the same for the Mode A trainer case with
    its checkpoint's leaves."""
    import tempfile

    cfg = reduce_for_smoke(get_config(TRAIN["arch"]))
    ticks = iter(range(1000))
    with tempfile.TemporaryDirectory() as ckpt:
        out = t_train.train_loop(
            cfg, RunConfig(**TRAIN["run"]), nodes=2, tp=1,
            steps=TRAIN["steps"], batch_per_node=2, seq_len=16,
            ckpt_dir=ckpt, ckpt_every=TRAIN["ckpt_every"],
            fail_at=TRAIN["fail_at"], fail_node=1, log_every=1,
            clock=lambda: float(next(ticks)), device="cpu", graphed=False)
        manifest, _ = _checkpoint(os.path.join(ckpt,
                                               f"step_{CKPT_STEP:08d}"))
    cfg = reduce_for_smoke(get_config(TRAIN_A["arch"]))
    ticks = iter(range(1000))
    with tempfile.TemporaryDirectory() as ckpt:
        out_a = t_train.train_loop(
            cfg, RunConfig(**TRAIN_A["run"]), nodes=1, tp=1,
            steps=TRAIN_A["steps"], batch_per_node=TRAIN_A["batch"],
            seq_len=16, ckpt_dir=ckpt, ckpt_every=TRAIN_A["steps"],
            log_every=1, clock=lambda: float(next(ticks)), device="cpu",
            graphed=False)
        mode_a = (out_a["log"], *_checkpoint(os.path.join(
            ckpt, f"step_{TRAIN_A['steps']:08d}")))
    return out["log"], manifest, mode_a


def _dump(obj, path):
    """Pickle ``obj`` to ``path`` whole (a rename: a rank polling for it
    never reads half a file)."""
    with open(str(path) + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(str(path) + ".tmp", path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks start on the numpy inputs; the JAX references run here
    meanwhile, and the JAX steps' states follow in ``steps.pkl``, which
    the ranks wait for before their Mode A / B cases."""
    root = tmp_path_factory.mktemp("tp4")
    models, twin = _model_inputs(), _twin_inputs()
    inp = {"tp": {"models": models, "train": TRAIN, "trainer_a": TRAIN_A,
                  "twin": twin}}
    _dump(inp, root / "inputs.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_cases.py"),
         "tp", str(r), str(WORLD), str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    mode_a, mode_a_want = _mode_a()
    mode_b, mode_b_want = _mode_b()
    _dump({"mode_a": mode_a, "mode_b": mode_b}, root / "steps.pkl")
    inp["tp"].update(mode_a=mode_a, mode_b=mode_b)
    want = _model_refs(models)
    twin_want = _twin(twin)
    one_log, one_manifest, one_mode_a = _one_process_train()
    for p in ranks:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    results = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return {"inputs": inp, "ranks": results, "want": want, "root": root,
            "mode_a": mode_a_want, "mode_b": mode_b_want, "twin": twin_want,
            "one_log": one_log, "one_manifest": one_manifest,
            "one_mode_a": one_mode_a}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _shard_shape(shape, spec, tp_size):
    return tuple(d // tp_size if e == "model" else d
                 for d, e in zip(shape, tuple(spec)))


CASES = [(k, t) for k in MODEL_CASES for t in (2, 4)]


@pytest.mark.parametrize("key,size", CASES)
def test_shards_follow_the_jax_specs_and_round_trip(world, key, size):
    """Each rank's shard of every leaf has the shape the JAX spec gives
    it: qwen2-vl's kv lanes split mid-head at tp 4, the narrow config's
    wk / wv replicated under its sharded wq; the gather is bit-equal."""
    params = world["inputs"]["tp"]["models"][key]["params"]
    specs = world["want"][key]["specs"][size]
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = [_shard_shape(np.shape(x), s, size)
            for x, s in zip(_leaves(params), spec_leaves)]
    for rank in world["ranks"]:
        got = rank["models"][(key, size)]
        assert got["shapes"] == want
        assert got["round_trip"]
    if key == "narrow" and size == 4:
        kv = [s for p, s in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))
            if "wk" in jax.tree_util.keystr(p)]
        assert kv and all("model" not in tuple(s) for s in kv)


@pytest.mark.parametrize("key,size", CASES)
def test_loss_logits_and_gradients_match_jax(world, key, size):
    want = world["want"][key]
    for rank in world["ranks"]:
        got = rank["models"][(key, size)]
        assert abs(got["loss"] - want["loss"]) <= PARITY
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=0, atol=PARITY)
        for a, b in zip(_leaves(got["grads"]), _leaves(want["grads"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARITY)


@pytest.mark.parametrize("key,size", CASES)
def test_remat_under_tensor_parallelism_is_bit_equal_to_none(world, key,
                                                             size):
    for rank in world["ranks"]:
        assert rank["models"][(key, size)]["remat_equal"] == {
            "full": True, "dots": True}


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_mode_a_adamw_with_clip_in_lockstep(world):
    """Each step from the JAX state: the gathered new state (AdamW's
    moments, the clipped update) as ``test_torch_train_step`` holds it."""
    for rank in world["ranks"]:
        for got, (want, loss) in zip(rank["mode_a"], world["mode_a"]):
            assert abs(got["loss"] - loss) <= PARITY
            _assert_state_close(_to_torch(got["state"]), want,
                                MODE_A["eta"])


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_mode_b_in_lockstep_with_jax(world, comp):
    for rank in world["ranks"]:
        for got, (want, loss) in zip(rank["mode_b"][comp],
                                     world["mode_b"][comp]):
            assert abs(got["loss"] - loss) <= PARITY
            _assert_state_close(_to_torch(got["state"]), want, MODE_B_ETA)
            if comp == "int8":
                assert got["scales_equal"]


@pytest.mark.parametrize("case", ["mode_a", "none", "int8"])
def test_replicated_leaves_bit_equal_across_model_ranks(world, case):
    """Ranks 2f and 2f + 1 make up fleet coordinate f's model axis: every
    leaf the specs leave whole is bit-equal between them."""
    places = [r["place"] for r in world["ranks"]]
    assert places == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for f in (0, 1):
        a, b = world["ranks"][2 * f], world["ranks"][2 * f + 1]
        runs = ((a["mode_a"], b["mode_a"]) if case == "mode_a"
                else (a["mode_b"][case], b["mode_b"][case]))
        for x, y in zip(*runs):
            assert x["replicated"]
            for u, v in zip(x["replicated"], y["replicated"]):
                assert np.array_equal(u, v)


def test_real_model_smoke_at_the_jax_defaults(world):
    for rank in world["ranks"]:
        report = rank["smoke"]
        assert report["ok"], report
        assert report["mesh"] == {"fleet": 2, "model": 2}
        assert report["devices_spanned"] == 4


def test_compressed_int8_family_over_fleet_and_model_matches_one_device(
        world):
    """``real_model_smoke`` on compressed_int8 over (fleet 2, model 2):
    the round loop and train_model_on_traces within 1e-5 of the one-device
    loop, so the int8 scale blocks are the whole leaves', not a
    shard's."""
    for rank in world["ranks"]:
        report = rank["smoke_int8"]
        assert report["ok"], report
        assert report["devices_spanned"] == 4
        assert max(v for k, v in report["parity"].items()
                   if k != "tol") <= PARITY


def test_mode_a_trainer_over_two_replicas_by_tp_2_saves_from_one_axis(
        world):
    """``train_loop --nodes 1 --tp 2 --mode allreduce`` on four ranks:
    losses within 1e-4 of one process; its checkpoint the one process's
    global arrays within 1e-5; only fleet index 0's model axis gathers
    the replicated state (the other replica gathers no leaf)."""
    one_log, one_manifest, one_leaves = world["one_mode_a"]
    for rank in world["ranks"]:
        got = rank["trainer_a"]
        assert [e["step"] for e in got["log"]] == [e["step"]
                                                   for e in one_log]
        assert max(abs(a["loss"] - b["loss"])
                   for a, b in zip(got["log"], one_log)) <= LOSS_TOL
        if rank["place"][0] == 0:
            assert got["model_gathers"] == one_manifest["n_leaves"]
        else:
            assert got["model_gathers"] == 0
    manifest, leaves = _checkpoint(
        world["root"] / "ckpt_tp_a" / f"step_{TRAIN_A['steps']:08d}")
    for k in ("n_leaves", "shapes", "dtypes"):
        assert manifest[k] == one_manifest[k], k
    for a, b in zip(leaves, one_leaves):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=PARITY)
        else:
            assert np.array_equal(a, b)


def test_train_loop_over_two_nodes_by_tp_2(world):
    """Losses within 1e-4 of one process (fault drill at step 3
    included); the checkpoint's manifest is the one process's (global
    shapes, dtypes); resumed from step 4's checkpoint, steps 5 and 6
    repeat the first run's losses bit for bit."""
    one = world["one_log"]
    for rank in world["ranks"]:
        first, again = rank["train"]
        assert [e["step"] for e in first] == [e["step"] for e in one]
        assert max(abs(a["loss"] - b["loss"])
                   for a, b in zip(first, one)) <= LOSS_TOL
        assert [(e["step"], e["loss"]) for e in again] == [
            (e["step"], e["loss"]) for e in first[-2:]]
    with open(world["root"] / "ckpt_tp" / f"step_{CKPT_STEP:08d}"
              / "MANIFEST.json") as f:
        manifest = json.load(f)
    for k in ("n_leaves", "shapes", "dtypes"):
        assert manifest[k] == world["one_manifest"][k], k


def test_pod_gossip_train_twin_matches_jax(world):
    """The twin over (2, 2), and on each rank alone (``alone=True``, the
    run chip_smoke.py holds the four cards' twin against), within 1e-4
    of the JAX step."""
    want = world["twin"]
    for rank in world["ranks"]:
        for got in (rank["twin"], rank["twin_alone"]):
            assert got["plan"] == want["plan"]
            assert max(abs(a - b) for a, b in zip(
                got["losses"], want["losses"])) <= LOSS_TOL
        assert rank["twin"]["p2p_bytes"] > 0
        assert rank["twin_alone"]["p2p_bytes"] == 0


def test_import_hygiene_on_every_rank(world):
    for rank in world["ranks"]:
        assert rank["modules"] == []


def test_non_dense_families_refuse_a_model_axis():
    """Every family builds under an active model axis and trains on it
    (``tests/test_torch_tp_families.py``); what still waits raises naming
    ROADMAP Queue 1 item 9: a serve cache under an active axis (prefill
    and decode, built with the axis or run under ``tp.use``), before any
    collective."""
    from repro_torch.models import build

    for arch in ("deepseek-v2-lite-16b", "recurrentgemma-2b", "rwkv6-7b",
                 "seamless-m4t-large-v2", "phi3.5-moe-42b-a6.6b"):
        cfg = reduce_for_smoke(get_config(arch))
        api = build(cfg, "cpu", model=tp.Model(size=2))
        one = build(cfg, "cpu")
        params = one.init(torch.Generator().manual_seed(0))
        batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64)}
        if cfg.is_encdec:
            batch["src_embeds"] = torch.zeros((1, 8, cfg.d_model))
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            api.prefill(params, batch)
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            api.decode_step(params, torch.zeros((1,), dtype=torch.int64),
                            None, 8)
        with tp.use(tp.Model(size=2)), \
                pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            one.prefill(params, batch)
        # an axis of one serves
        logits, _ = build(cfg, "cpu", model=tp.ONE).prefill(params, batch)
        assert logits.shape == (1, cfg.vocab_size)
