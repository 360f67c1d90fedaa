"""The trainer and train-on-trace over a gloo world of two ranks.

One world for the module (``tests/torch_dist_cases.py``, a ``FileStore``
in a temporary directory): each rank runs every case and hands back its
results; the one-process runs they are held against run here.

* ``launch.train.train_loop`` on 2 ranks (the qwen2-vl-2b smoke config,
  4 nodes, the controller's ring-1, int8 gossip, AdamW, a
  fault drill at step 3, checkpoints every 2 steps, then a resume to step
  6): the same losses and wall column as one process, and every
  checkpoint file byte-equal to the one process's;
* Mode A on the 2 ranks (half the global batch each, the gradients
  all-reduced): the one process's losses within 1e-5;
* ``sim.batch.train_model_on_traces(mesh=fleet 2)`` on the stablelm-3b
  smoke config over ``static`` and ``compressed_int8``: losses,
  accuracies and final parameters within 1e-5 of the unsharded run;
* ``sim.real_model_smoke.run(fleet=2)`` reports ``ok`` (its nodes on 2
  ranks, parity <= 1e-5 against the per-round reference);
* import hygiene: a two-rank ``gossip_mix_tree`` against ``plan_w @ X``,
  and neither ``jax`` nor ``repro`` in the ranks' ``sys.modules``.

What a q head split over the ranks of a 'model' axis needs outside a
world (the ranks, named before any work) is held here too.
"""
import filecmp
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference's CI installs no torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.core.gossip import plan_w, ring_plan
from repro_torch.launch import train as t_train
from repro_torch.sim import batch as t_batch
from repro_torch.sim import real_model_smoke

ROOT = Path(__file__).resolve().parents[1]
PARITY = 1e-5
WORLD = 2
TRAIN = {"arch": "qwen2-vl-2b", "nodes": 4, "steps": 4, "ckpt_every": 2,
         "fail_at": 3,
         "run": dict(mode="dpsgd", optimizer="adamw", eta=1e-3,
                     compression="int8", remat="none")}
FAMILIES = ["static", "compressed_int8"]
# Mode A over the two ranks: each takes half the global batch, the
# gradients all-reduced to their mean
MODE_A = dict(mode="allreduce", optimizer="adamw", eta=1e-3, remat="none")


def _one_process(ckpt: str, steps: int, resume: bool,
                 run: dict = TRAIN["run"]) -> dict:
    cfg = reduce_for_smoke(get_config(TRAIN["arch"]))
    ticks = iter(range(1000))
    return t_train.train_loop(
        cfg, RunConfig(**run), nodes=TRAIN["nodes"], tp=1,
        steps=steps, batch_per_node=2, seq_len=16, ckpt_dir=ckpt,
        ckpt_every=TRAIN["ckpt_every"], fail_at=TRAIN["fail_at"],
        fail_node=1, log_every=1, resume=resume,
        clock=lambda: float(next(ticks)), device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist2")
    rng = np.random.default_rng(5)
    inp = {"train": TRAIN, "families": FAMILIES, "mode_a": MODE_A,
           "tree": {"a": rng.normal(size=(4, 3, 5)).astype(np.float32),
                    "b": rng.normal(size=(4, 7)).astype(np.float32)}}
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_cases.py"),
         "two", str(r), str(WORLD), str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    # the one-process runs, meanwhile
    one_ckpt = str(root / "ckpt_one")
    one = (_one_process(one_ckpt, TRAIN["steps"], False),
           _one_process(one_ckpt, TRAIN["steps"] + 2, True))
    one_a = _one_process(None, 3, False, MODE_A)
    outs = [p.communicate(timeout=600) for p in ranks]
    for p, (out, err) in zip(ranks, outs):
        assert p.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    results = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return {"root": root, "inputs": inp, "ranks": results, "one": one,
            "one_a": one_a, "stdout": [o for o, _ in outs]}


def test_train_loop_over_two_ranks_logs_the_one_process_losses(world):
    for rank in world["ranks"]:
        for got, want in zip(rank["train"], world["one"]):
            assert got == want["log"]
    first, again = world["ranks"][0]["train"]
    assert [r["step"] for r in first] == list(range(1, TRAIN["steps"] + 1))
    assert [r["step"] for r in again] == [TRAIN["steps"] + 1,
                                          TRAIN["steps"] + 2]


def test_mode_a_over_two_ranks_matches_one_process(world):
    """Mode A: each rank's half of the global batch, the gradients
    all-reduced to their mean: the one process's losses within 1e-5."""
    want = world["one_a"]["log"]
    for rank in world["ranks"]:
        got = rank["mode_a"]
        assert [r["step"] for r in got] == [r["step"] for r in want] \
            == [1, 2, 3]
        assert max(abs(a["loss"] - b["loss"]) for a, b in zip(got, want)) \
            <= PARITY


def test_train_loop_checkpoints_are_byte_equal_to_one_process(world):
    fleet_dir = world["root"] / "ckpt_fleet"
    one_dir = world["root"] / "ckpt_one"
    steps = sorted(os.listdir(one_dir))
    assert steps == ["step_00000002", "step_00000004", "step_00000006"]
    assert sorted(os.listdir(fleet_dir)) == steps
    for step in steps:
        names = sorted(os.listdir(one_dir / step))
        assert names == sorted(os.listdir(fleet_dir / step)) == [
            "MANIFEST.json", "host0.npz"]
        for name in names:
            assert filecmp.cmp(one_dir / step / name, fleet_dir / step / name,
                               shallow=False), (step, name)


def test_train_loop_logs_on_rank_zero_only(world):
    rank0, rank1 = world["stdout"]
    assert "[plan] PlanChoice(ring-1" in rank0 \
        and "[fault] replanned" in rank0 \
        and "[resume] step 4" in rank0
    assert "step" not in rank1 and "[plan]" not in rank1


@pytest.mark.parametrize("name", FAMILIES)
def test_train_model_on_traces_over_a_fleet_matches_one_process(world, name):
    for rank in world["ranks"]:
        got = rank[("family", name)]
        fleet, one = got["fleet"], got["one"]
        np.testing.assert_allclose(fleet["losses"], one["losses"], rtol=0,
                                   atol=PARITY)
        np.testing.assert_allclose(fleet["acc"], one["acc"], rtol=0,
                                   atol=PARITY)
        a, b = fleet["final"], one["final"]
        flat_a = [a] if isinstance(a, np.ndarray) else _leaves(a)
        flat_b = [b] if isinstance(b, np.ndarray) else _leaves(b)
        assert len(flat_a) == len(flat_b) > 0
        for x, y in zip(flat_a, flat_b):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=0, atol=PARITY)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def test_real_model_smoke_runs_on_two_ranks(world):
    for rank in world["ranks"]:
        report = rank["smoke"]
        assert report["ok"], report
        assert report["devices_spanned"] == 2
        assert report["mesh"] == {"fleet": 2, "model": 1}
        assert max(v for k, v in report["parity"].items() if k != "tol") \
            <= PARITY


def test_two_rank_gossip_tree_and_import_hygiene(world):
    w = plan_w(ring_plan(("data",), (4,), 1))
    for rank in world["ranks"]:
        for k, x in world["inputs"]["tree"].items():
            want = (w @ x.reshape(4, -1).astype(np.float64)).reshape(x.shape)
            np.testing.assert_allclose(rank["hygiene_tree"][k], want,
                                       rtol=1e-6, atol=1e-6)
        assert rank["modules"] == []


def test_tensor_parallelism_raises_naming_queue_1_item_9():
    """A q head split over the ranks of a 'model' axis now builds and runs
    (``tests/test_torch_tp_serve.py`` holds it on a gloo world): the
    trainer on recurrentgemma-2b (10 q heads) at tp 4 outside a world
    names the ranks it needs, before any work; its train-on-trace
    adapter's loss (10 heads at the smoke widths) under a 'model' axis of
    4 runs (a group faked to move nothing) through the split layout; the
    model builds at tp 4 and 2."""
    import dataclasses

    from repro_torch.models import attention, build, tp

    rec = get_config("recurrentgemma-2b")
    with pytest.raises(ValueError, match="1 x 4 = 4 ranks"):
        t_train.train_loop(rec, RunConfig(remat="none"), nodes=1, tp=4,
                           steps=1, batch_per_node=2, seq_len=16,
                           ckpt_dir=None, device="cpu")
    ten = dataclasses.replace(reduce_for_smoke(rec), n_heads=10)
    assert attention.head_layout(ten, tp.Model(size=4)).split
    adapter = t_batch.transformer_adapter(ten, batch=2, seq_len=16,
                                          device="cpu")
    tokens = {"tokens": torch.zeros((2, 16), dtype=torch.int32)}
    fakes = {"_gathered": lambda x, m: torch.cat([x] * m.size, dim=-1),
             "_reduced": lambda x, m, op: x.clone()}
    real = {k: getattr(tp, k) for k in fakes}
    for k, f in fakes.items():
        setattr(tp, k, f)
    try:
        from repro_torch.launch.train import model_specs
        from repro_torch.train import shardings as shr

        model = tp.Model(size=4)
        local = shr.shard_model(adapter.init_params(0),
                                model_specs(ten, 4), model)
        with tp.use(model):
            loss = adapter.loss_fn(local, tokens)
        assert bool(torch.isfinite(loss))
    finally:
        for k, f in real.items():
            setattr(tp, k, f)
    build(rec, "cpu", model=tp.Model(size=4))
    build(rec, "cpu", model=tp.Model(size=2))
    build(reduce_for_smoke(rec), "cpu", model=tp.Model(size=4))
    # the smoke at its defaults (fleet 2 x model 2) outside a world names
    # the ranks it needs
    with pytest.raises(SystemExit, match="4 ranks"):
        real_model_smoke.main([])
