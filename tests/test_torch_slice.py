"""The port's first slice end to end on the CPU, against the JAX package,
and the port's import hygiene.

The slice is the paper's run (``examples/wireless_dpsgd.py``): placement,
Eq. 2 capacities, Algorithm 2 rates, then D-PSGD on the CNN. At the
example's size (n = 6, 1200 training images, one epoch = 8 steps of batch
25) the port must see the same placement, rate solution and batch indices,
and, from the JAX package's initial parameters, give per-step losses and
final parameters within 1e-5 of the JAX loop built from
``repro.core.dpsgd.make_dpsgd_step``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch

from repro.core import channel as r_channel
from repro.core import dpsgd as r_dpsgd
from repro.core import rate_opt as r_rate
from repro.data import SyntheticFashion, node_splits
from repro.models import cnn as r_cnn
from repro_torch import device as t_device
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import rate_opt as t_rate
from repro_torch.examples import wireless_dpsgd as ex
from repro_torch.models import cnn as t_cnn

ROOT = Path(__file__).resolve().parents[1]
N_NODES, N_TRAIN, N_TEST, STEPS = 6, 1200, 300, 8


def _jax_slice(lam_t):
    """The JAX example's steps 1-4, returning what the port must match."""
    pos = r_channel.random_placement(N_NODES, 200.0, seed=0)
    cap = r_channel.capacity_matrix(
        pos, r_channel.ChannelParams(path_loss_exp=5.0))
    ds = SyntheticFashion(n_train=N_TRAIN, n_test=N_TEST, seed=0)
    splits = node_splits(ds.train_x, ds.train_y, N_NODES, seed=0)
    sol = r_rate.solve(cap, r_cnn.MODEL_BITS, lam_t)
    params0 = r_dpsgd.replicate(r_cnn.cnn_init(jax.random.key(0)), N_NODES)
    step = r_dpsgd.make_dpsgd_step(lambda p, b: r_cnn.cnn_loss(p, b),
                                   r_dpsgd.DPSGDConfig(eta=0.05))
    w = jnp.asarray(sol.w)
    rng = np.random.default_rng(0)
    params, losses = params0, []
    for _ in range(STEPS):
        idx = rng.integers(0, len(splits[0][0]), size=(N_NODES, 25))
        batch = {
            "images": jnp.asarray(np.stack(
                [splits[i][0][idx[i]] for i in range(N_NODES)])),
            "labels": jnp.asarray(np.stack(
                [splits[i][1][idx[i]] for i in range(N_NODES)])),
        }
        params, loss = step(params, batch, w)
        losses.append(np.asarray(loss))
    return {"cap": cap, "splits": splits, "sol": sol,
            "params0": jax.tree.map(np.asarray, params0),
            "params": jax.tree.map(np.asarray, params),
            "losses": np.stack(losses), "test": (ds.test_x, ds.test_y)}


@pytest.mark.parametrize("lam_t", ex.LAMBDA_TARGETS)
def test_slice_matches_jax_loop(lam_t):
    ref = _jax_slice(lam_t)
    cap = ex.place(N_NODES, 5.0)
    assert np.array_equal(cap, ref["cap"])
    sol = t_rate.solve(cap, t_cnn.MODEL_BITS, lam_t)
    assert np.array_equal(sol.rates_bps, ref["sol"].rates_bps)
    assert np.array_equal(sol.w, ref["sol"].w) and sol.lam == ref["sol"].lam
    assert abs(sol.t_com_s * STEPS - ref["sol"].t_com_s * STEPS) <= 1e-9

    data = ex.load_data(N_NODES, N_TRAIN, N_TEST, device="cpu")
    assert np.array_equal(data.x.numpy(), np.stack([s[0] for s in ref["splits"]]))
    assert np.array_equal(data.y.numpy(), np.stack([s[1] for s in ref["splits"]]))
    assert np.array_equal(data.test_x.numpy(), ref["test"][0])

    params0 = params_from_numpy(ref["params0"], "cpu")
    params, losses, t_compute = ex.train(params0, data, sol.w, STEPS, eta=0.05)
    assert losses.shape == (STEPS, N_NODES) and t_compute > 0
    np.testing.assert_allclose(losses.numpy(), ref["losses"], rtol=0, atol=1e-5)
    got = params_to_numpy(params)
    for k, leaves in ref["params"].items():
        for kk, want in leaves.items():
            np.testing.assert_allclose(got[k][kk], want, rtol=0, atol=1e-5,
                                       err_msg=f"{k}.{kk}")
    node1 = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params.items()}
    acc = float(t_cnn.cnn_accuracy(node1, data.test_x, data.test_y))
    want_acc = float(r_cnn.cnn_accuracy(
        jax.tree.map(lambda p: jnp.asarray(p[0]), ref["params"]),
        jnp.asarray(ref["test"][0]), jnp.asarray(ref["test"][1])))
    assert abs(acc - want_acc) <= 1.0 / N_TEST      # at most one flip


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"forbidden imports: {bad}"


def test_slice_runs_without_jax_or_repro_loaded():
    code = (
        "import sys\n"
        "from repro_torch.examples import wireless_dpsgd as ex\n"
        "cap = ex.place(6, 5.0)\n"
        "data = ex.load_data(6, 240, 60, device='cpu')\n"
        "out = [ex.run_target(cap, lam, data, 2) for lam in ex.LAMBDA_TARGETS]\n"
        "assert [r['steps'] for r in out] == [2, 2], out\n"
        "import repro_torch.sim as sim\n"
        "trace, _ = sim.simulate_dpsgd_cnn(sim.get_scenario('compressed_int8'),"
        " epochs=1, n_train=300, n_test=30, device='cpu')\n"
        "assert len(trace.records) == 2, trace.records\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: t_device.resolve_device(),
                 lambda: t_cnn.cnn_init(gen),
                 lambda: params_from_numpy({"w": np.zeros(3)}),
                 lambda: ex.init_params(N_NODES),
                 lambda: ex.load_data(N_NODES, 60, 12),
                 lambda: ex.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert t_device.resolve_device("cpu") == torch.device("cpu")
