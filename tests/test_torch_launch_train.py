"""The port's pod-mode trainer and quickstart against the JAX package's.

``repro_torch.launch.train.train_loop`` on the stablelm-3b smoke config (4
nodes, Mode B, the controller's plan, a fault drill at step 3) against the
JAX package's ``train_loop`` run in a subprocess on 4 host devices: the port
starts from the JAX package's initial state through a step-0 checkpoint the
JAX package wrote (``resume=True``), and the logged losses match at 1e-4,
the wall column (an injected clock) exactly, the plan and fault lines as
text. Also: its refusals (``tp`` > 1, a sequence no longer than the vision
stub), the CLI on the CPU, the default device, and
``repro_torch.examples.quickstart`` printing the JAX example's lines from
the JAX example's initial states.
"""
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from repro.configs import RunConfig as RRunConfig
from repro.configs import get_config as r_get_config
from repro.configs import reduce_for_smoke as r_reduce
from repro.models import build as r_build
from repro.train import step as r_step
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.examples import quickstart as t_quickstart
from repro_torch.launch import train as t_train

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4
STEPS, FAIL_AT = 6, 3

# The JAX package's side, on 4 host devices: its initial state saved as a
# step-0 checkpoint, then its train_loop with a counting clock; the log as
# the last line.
JAX_RUN = """
import json, sys
import jax
from repro.checkpoint import save
from repro.configs import RunConfig, get_config, reduce_for_smoke
from repro.launch.train import train_loop
from repro.models import build
from repro.train.step import init_train_state

ckpt, steps, fail_at = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = reduce_for_smoke(get_config("stablelm-3b"))
run = RunConfig(mode="dpsgd", optimizer="adamw", eta=1e-3, remat="none",
                lambda_target=0.8)
state = jax.jit(lambda k: init_train_state(build(cfg), run, k, n_nodes=4))(
    jax.random.key(run.seed))
save(ckpt, 0, state)
ticks = iter(range(1000))
out = train_loop(cfg, run, nodes=4, tp=1, steps=steps, batch_per_node=2,
                 seq_len=32, ckpt_dir=None, fail_at=fail_at, fail_node=2,
                 log_every=1, clock=lambda: float(next(ticks)))
print(json.dumps(out["log"]))
"""


def test_train_loop_matches_jax_train_loop(tmp_path, capsys):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run(
        [sys.executable, "-c", JAX_RUN, str(tmp_path), str(STEPS),
         str(FAIL_AT)], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want_lines = proc.stdout.strip().splitlines()
    want_log = json.loads(want_lines[-1])

    cfg = reduce_for_smoke(get_config("stablelm-3b"))
    run = RunConfig(mode="dpsgd", optimizer="adamw", eta=1e-3, remat="none",
                    lambda_target=0.8)
    ticks = iter(range(1000))
    out = t_train.train_loop(
        cfg, run, nodes=4, tp=1, steps=STEPS, batch_per_node=2, seq_len=32,
        ckpt_dir=str(tmp_path), ckpt_every=100, fail_at=FAIL_AT,
        fail_node=2, log_every=1, resume=True,
        clock=lambda: float(next(ticks)), device="cpu")
    got_lines = capsys.readouterr().out.strip().splitlines()
    assert got_lines[1] == "[resume] step 0"
    # the plan, the fault and the replanned plan print the same text
    tagged = lambda lines: [x for x in lines  # noqa: E731
                            if x.startswith(("[plan]", "[fault]"))]
    assert tagged(got_lines) == tagged(want_lines)
    assert len(tagged(got_lines)) == 3
    assert [r["step"] for r in out["log"]] == [r["step"] for r in want_log] \
        == list(range(1, STEPS + 1))
    assert [r["wall_s"] for r in out["log"]] == [r["wall_s"]
                                                 for r in want_log]
    diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(out["log"],
                                                       want_log)]
    assert max(diffs) <= LOSS_TOL, diffs
    assert out["final_loss"] == out["log"][-1]["loss"]


def test_train_loop_refusals():
    cfg = reduce_for_smoke(get_config("stablelm-3b"))
    run = RunConfig(remat="none")
    kw = dict(steps=1, batch_per_node=2, seq_len=16, ckpt_dir=None,
              device="cpu")
    # a q head split over ranks (10 heads over 4) and the dry run's pod
    # meshes wait for Queue 1 item 9, before any work
    rec = get_config("recurrentgemma-2b")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        t_train.train_loop(rec, run, nodes=4, tp=4, **kw)
    from repro_torch.launch import dryrun

    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        dryrun.check_mesh("single")
    vlm = get_config("qwen2-vl-2b")
    with pytest.raises(ValueError, match="patch positions"):
        t_train.train_loop(vlm, run, nodes=4, tp=1,
                           **{**kw, "seq_len": vlm.n_patches})


@pytest.mark.parametrize("nodes,tp,need", [(4, 2, "4 x 2 = 8 ranks"),
                                           (1, 4, "1 x 4 = 4 ranks")])
def test_tensor_parallelism_without_a_world_names_the_ranks_it_needs(
        nodes, tp, need):
    """A dense arch under ``tp`` > 1 in one process raises ``ValueError``
    naming the ranks its (nodes, tp) mesh needs and the launcher line."""
    cfg = reduce_for_smoke(get_config("stablelm-3b"))
    with pytest.raises(ValueError, match=need) as info:
        t_train.train_loop(cfg, RunConfig(remat="none"), nodes=nodes,
                           tp=tp, steps=1, batch_per_node=2, seq_len=16,
                           ckpt_dir=None, device="cpu")
    assert f"--nproc_per_node {nodes * tp}" in str(info.value)


def test_train_loop_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.train_loop(reduce_for_smoke(get_config("stablelm-3b")),
                           RunConfig(remat="none"), nodes=2, tp=1, steps=1,
                           batch_per_node=1, seq_len=8, ckpt_dir=None)


def test_cli_runs_modes_on_the_cpu(tmp_path, capsys):
    """The CLI's default arch (qwen2-vl-2b, vision stub) in both modes, with
    int8 gossip, a checkpoint every step and a resume from step 2."""
    args = ["--device", "cpu", "--smoke", "--nodes", "2", "--steps", "2",
            "--batch-per-node", "1", "--seq-len", "16"]
    assert t_train.main(args + ["--mode", "allreduce"]) == 0
    ck = str(tmp_path / "ck")
    int8 = ["--compression", "int8", "--ckpt-dir", ck, "--ckpt-every", "1"]
    assert t_train.main(args + int8) == 0
    first = capsys.readouterr().out
    assert t_train.main(args + int8 + ["--steps", "3", "--resume"]) == 0
    resumed = capsys.readouterr().out
    assert "[resume] step 2" in resumed and "final loss: " in first
    assert "step     3 loss" in resumed and "step     2 loss" not in resumed
    assert sorted(os.listdir(ck)) == ["step_00000001", "step_00000002",
                                      "step_00000003"]


def test_cli_eager_flag_skips_the_graph(monkeypatch, capsys):
    """``--eager`` runs the step without a ``GraphedStep``; without it the
    loop makes one. On the CPU both run the same body: equal losses."""
    made = []
    real = t_train.GraphedStep

    def counted(fn):
        made.append(fn)
        return real(fn)

    monkeypatch.setattr(t_train, "GraphedStep", counted)
    args = ["--device", "cpu", "--smoke", "--arch", "stablelm-3b", "--nodes",
            "2", "--steps", "2", "--batch-per-node", "1", "--seq-len", "16"]
    assert t_train.main(args) == 0
    graphed = capsys.readouterr().out
    assert len(made) == 1
    assert t_train.main(args + ["--eager"]) == 0
    eager = capsys.readouterr().out
    assert len(made) == 1
    pick = [line.split("wall")[0] for line in graphed.splitlines()
            if line.startswith("step ")]
    assert pick and pick == [line.split("wall")[0]
                             for line in eager.splitlines()
                             if line.startswith("step ")]


def test_resume_repeats_the_uninterrupted_losses(tmp_path):
    """Mode B with int8 gossip and adamw, 4 steps straight against 2 steps,
    a checkpoint, and a restart with ``resume=True``: steps 3 and 4 log the
    same losses bit for bit (deterministic batches, the whole state
    restored)."""
    cfg = reduce_for_smoke(get_config("qwen2-vl-2b"))
    run = RunConfig(mode="dpsgd", optimizer="adamw", eta=1e-3,
                    compression="int8", remat="none")
    kw = dict(nodes=4, tp=1, batch_per_node=1, seq_len=16, log_every=1,
              device="cpu")
    straight = t_train.train_loop(cfg, run, steps=4, ckpt_dir=None, **kw)
    ck = str(tmp_path)
    t_train.train_loop(cfg, run, steps=2, ckpt_dir=ck, ckpt_every=2, **kw)
    resumed = t_train.train_loop(cfg, run, steps=4, ckpt_dir=ck,
                                 resume=True, **kw)
    assert [r["step"] for r in resumed["log"]] == [3, 4]
    assert [r["loss"] for r in resumed["log"]] == [
        r["loss"] for r in straight["log"][2:]]


def _load_jax_quickstart():
    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", ROOT / "examples" / "quickstart.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_prints_the_jax_example_lines(monkeypatch):
    """Both examples at 11 steps a mode (two loss lines each), the port's
    from the JAX example's initial states: the same lines, every number
    within 2e-4 (the losses are printed to 4 decimals)."""
    jq = _load_jax_quickstart()
    monkeypatch.setattr(jq, "STEPS", 11)
    monkeypatch.setattr(t_quickstart, "STEPS", 11)
    jcfg = r_reduce(r_get_config("stablelm-3b"))

    def jax_init(api, run, gen, n_nodes):
        rrun = RRunConfig(mode=run.mode, optimizer=run.optimizer,
                          eta=run.eta, remat="none")
        state = r_step.init_train_state(r_build(jcfg), rrun,
                                        jax.random.key(0), n_nodes=n_nodes)
        return params_from_numpy(jax.tree.map(np.asarray, state), "cpu")

    monkeypatch.setattr(t_quickstart, "init_train_state", jax_init)

    def lines(train):
        buf = io.StringIO()
        with redirect_stdout(buf):
            a = train("dpsgd")
            b = train("allreduce")
        return buf.getvalue().splitlines(), (a, b)

    want, want_final = lines(jq.train)
    got, got_final = lines(lambda mode: t_quickstart.train(mode,
                                                           device="cpu"))
    number = re.compile(r"-?\d+\.\d+")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert number.sub("#", g) == number.sub("#", w)
        for a, b in zip(number.findall(g), number.findall(w)):
            assert abs(float(a) - float(b)) <= 2e-4, (g, w)
    np.testing.assert_allclose(got_final, want_final, atol=LOSS_TOL)
