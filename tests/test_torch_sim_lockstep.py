"""Training through the wireless simulator in lockstep, the port against
the JAX package on the CPU (see test_torch_sim_train.py for the setup):
both drivers' steps are captured and each port step is fed the JAX step's
input state, so each of the 8 rounds on ``static``, ``churn``,
``compressed_int8``, ``compressed_ra`` and ``fault_chaos`` is held on its
own. The port's driver must hand its step the JAX driver's batch, W and
masks exactly; losses and parameters within 1e-5, residuals within 1e-5
and the int8 payload bit-equal (scales rtol 1e-6). A parameter row is held
at 1e-5 only where the two frameworks' forward passes route that node's
max-pools and ReLUs the same way: at a near-tie (two entries of a 2x2
window, or a ReLU input, within the ~1e-7 the two frameworks' conv sums
differ by) the gradient itself jumps, so a flipped node's conv and fc1 rows
differ by ~1e-4 in one step. Such a node keeps its fc2 row held; at least
90 % of the (round, node) pairs must be held in full.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores
import torch.nn.functional as F

from repro.core import compression as r_comp
from repro.models import cnn as r_cnn
from repro.sim import scenario as r_scenario
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import compression as t_comp
from repro_torch.core import dpsgd as t_dpsgd
from repro_torch.sim import scenario as t_scenario
from repro_torch.sim import trace as t_trace
from test_torch_sim_train import (FACTORIES, N_TEST, N_TRAIN, SCENARIOS, TOL,
                                  _jax_run, _max_err, _patch_init)


def _forward_routes_jax(params, images):
    def fwd(p, x):
        c1 = r_cnn._conv(p["conv1"], x)
        c2 = r_cnn._conv(p["conv2"], jax.nn.relu(r_cnn._maxpool2(c1)))
        h = jax.nn.relu(r_cnn._maxpool2(c2)).reshape(x.shape[0], -1)
        return c1, c2, h @ p["fc1"]["w"] + p["fc1"]["b"]
    return [np.asarray(a) for a in jax.jit(jax.vmap(fwd))(params, images)]


def _forward_routes_torch(params, images):
    def fwd(p, x):
        c1 = F.conv2d(x, p["conv1"]["w"], p["conv1"]["b"])
        c2 = F.conv2d(F.relu(F.max_pool2d(c1, 2)), p["conv2"]["w"],
                      p["conv2"]["b"])
        h = F.relu(F.max_pool2d(c2, 2)).reshape(x.shape[0], -1)
        return c1, c2, h @ p["fc1"]["w"] + p["fc1"]["b"]
    return [a.numpy() for a in torch.func.vmap(fwd)(params, images)]


def _routing(c1, c2, z1):
    """Per node: which entry each 2x2 max-pool window routes its gradient
    to (-1 where the ReLU after it blocks the gradient), and fc1's ReLU
    mask — what the gradient depends on discontinuously."""
    def pool(a):
        n, b, c, h, w = a.shape
        win = a.reshape(n, b, c, h // 2, 2, w // 2, 2).transpose(
            0, 1, 2, 3, 5, 4, 6).reshape(n, b, c, h // 2, w // 2, 4)
        return np.where(win.max(-1) > 0, win.argmax(-1), -1)
    return pool(c1), pool(c2), z1 > 0


def _same_routing(j_in, t_in):
    """(n,) bool: node k's forward passes route identically in both
    frameworks, on the step's input parameters and batch."""
    rj = _routing(*_forward_routes_jax(j_in[0], j_in[1]["images"]))
    rt = _routing(*_forward_routes_torch(t_in[0], t_in[1]["images"]))
    n = rj[0].shape[0]
    return np.array([all(np.array_equal(a[k], b[k]) for a, b in zip(rj, rt))
                     for k in range(n)])


@pytest.mark.parametrize("name", SCENARIOS)
def test_lockstep_driver_matches_jax(monkeypatch, name):
    _, _, jax_steps = _jax_run(name)
    compressed = r_scenario.get_scenario(name).payload.mode != "none"
    port_calls = []
    _patch_init(monkeypatch, name)

    def wrap(factory):
        def make(*args, **kw):
            step = factory(*args, **kw)

            def run(*inputs):
                j_in, _ = jax_steps[len(port_calls)]
                inputs = list(inputs)
                # the driver's data path: batch, W and masks exactly
                for key in ("images", "labels"):
                    assert np.array_equal(inputs[1][key].numpy(),
                                          j_in[1][key]), key
                assert np.array_equal(np.asarray(inputs[2], np.float32),
                                      j_in[2])
                if len(inputs) >= 4:
                    assert np.array_equal(np.asarray(inputs[3]), j_in[3])
                # lockstep: the JAX step's input state
                inputs[0] = params_from_numpy(j_in[0], "cpu")
                if compressed:
                    inputs[4] = params_from_numpy(j_in[4], "cpu")
                out = step(*inputs)
                port_calls.append((inputs, out))
                return out
            return run
        return make
    for fname in FACTORIES:
        monkeypatch.setattr(t_dpsgd, fname, wrap(getattr(t_dpsgd, fname)))
    t_trace.simulate_dpsgd_cnn(t_scenario.get_scenario(name), epochs=1,
                               n_train=N_TRAIN, n_test=N_TEST, device="cpu")
    assert len(port_calls) == len(jax_steps) == 8

    held = total = 0
    for (t_in, t_out), (j_in, j_out) in zip(port_calls, jax_steps):
        assert float(np.max(np.abs(t_out[-1].numpy() - j_out[-1]))) <= TOL
        same = _same_routing(j_in, t_in)
        t_new = params_to_numpy(t_out[0])
        for k in range(len(same)):
            leaves = [("fc2", "w"), ("fc2", "b")] if not same[k] else [
                (a, b) for a in j_out[0] for b in j_out[0][a]]
            for a, b in leaves:
                err = float(np.max(np.abs(t_new[a][b][k] - j_out[0][a][b][k])))
                assert err <= TOL, (k, a, b, err)
        held += int(same.sum())
        total += len(same)
        if compressed:
            assert _max_err(t_out[1], j_out[1]) <= TOL
            carried = np.concatenate(
                [(j_in[0][a][b] + j_in[4][a][b]).reshape(len(same), -1)
                 for a in sorted(j_in[0]) for b in sorted(j_in[0][a])], 1)
            q_t, s_t = t_comp.quantize_int8_rows(torch.from_numpy(carried))
            q_j, s_j = r_comp.quantize_int8_rows(jnp.asarray(carried))
            assert np.array_equal(q_t.numpy(), np.asarray(q_j))
            np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                                       rtol=1e-6)
    assert held >= 0.9 * total, (held, total)
