"""The port's CNN and D-PSGD steps against the JAX package, one step at a
time from the same state.

Parameters start as the JAX package's (``cnn_init`` under ``jax.random``)
and cross into torch through ``convert.params_from_numpy``; batches, W and
masks are numpy. Tolerances: losses, gradients, parameters and residuals
1e-5; int8 payloads bit-equal and scales rtol 1e-6 on the same input.
Multi-round int8 is held step by step (both fed the JAX state each round):
a 1e-7 gradient difference can flip one lane's rounding, which moves a
parameter by ~scale * W_ij, so free-running int8 trajectories are not
comparable at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch

from repro.core import compression as jcomp
from repro.core import dpsgd as jd
from repro.core import topology as jtopo
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import compression as tcomp
from repro_torch.core import dpsgd as td
from repro_torch.models import cnn as tcnn

N, B = 6, 8
TOL = 1e-5
_init_nodes = jax.jit(jax.vmap(jcnn.cnn_init))


def _node_params(seed=0, n=N):
    """Distinct per-node parameters (so the mix does real work) as numpy."""
    keys = jax.random.split(jax.random.key(seed), n)
    return jax.tree.map(np.asarray, _init_nodes(keys))


def _batch(seed=0, n=N, b=B, h=None):
    rng = np.random.default_rng(seed)
    lead = (n, b) if h is None else (n, h, b)
    return {"images": rng.normal(size=(*lead, 1, 28, 28)).astype(np.float32),
            "labels": rng.integers(0, 10, size=lead).astype(np.int32)}


def _w(seed=0, n=N):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.6).astype(np.float64)
    np.fill_diagonal(a, 1.0)
    return jtopo.paper_w(a)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict) and "images" in tree:
        return {k: torch.from_numpy(v) for k, v in tree.items()}
    return params_from_numpy(tree, "cpu")


def _assert_close(t_tree, j_tree, tol=TOL):
    t_np = params_to_numpy(td._tree_map(lambda x: x.float(), t_tree)) \
        if isinstance(t_tree, dict) else t_tree.detach().float().numpy()
    j_np = jax.tree.map(np.asarray, j_tree)
    if isinstance(j_np, dict):
        assert sorted(t_np) == sorted(j_np)
        for k in j_np:
            _assert_close_np(t_np[k], j_np[k], tol, k)
    else:
        _assert_close_np(t_np, j_np, tol, "")


def _assert_close_np(a, b, tol, path):
    if isinstance(b, dict):
        for k in b:
            _assert_close_np(a[k], b[k], tol, f"{path}.{k}")
        return
    assert a.shape == b.shape, path
    err = float(np.max(np.abs(a.astype(np.float32) - b.astype(np.float32))))
    assert err <= tol, f"{path}: max|err| {err} > {tol}"


def test_cnn_loss_grads_logits_accuracy_match_jax():
    params = jax.tree.map(lambda x: x[0], _node_params(3, n=1))
    batch = _batch(1, n=1, b=32)
    batch = {k: v[0] for k, v in batch.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(jcnn.cnn_loss))(
        _jax(params), _jax(batch))
    t_params = _torch(params)
    t_batch = _torch(batch)
    t_grads, t_loss = torch.func.grad_and_value(tcnn.cnn_loss)(t_params,
                                                              t_batch)
    assert abs(float(t_loss) - float(j_loss)) <= TOL
    _assert_close(t_grads, j_grads)
    _assert_close(tcnn.cnn_apply(t_params, t_batch["images"]),
                  jcnn.cnn_apply(_jax(params), jnp.asarray(batch["images"])))
    assert float(tcnn.cnn_accuracy(t_params, t_batch["images"],
                                   t_batch["labels"])) == \
        float(jcnn.cnn_accuracy(_jax(params), jnp.asarray(batch["images"]),
                                jnp.asarray(batch["labels"])))


def test_cnn_init_layout_and_generator():
    j_shapes = jax.tree.map(lambda x: x.shape[1:], _node_params(0, n=1))
    p = tcnn.cnn_init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda x: tuple(x.shape), p) == j_shapes
    assert sum(x.numel() for x in td._leaves(p)) == tcnn.PARAM_COUNT == 21_840
    assert tcnn.MODEL_BITS == jcnn.MODEL_BITS
    assert [path for path, _ in td._paths(p)] == [
        "['conv1']['b']", "['conv1']['w']", "['conv2']['b']", "['conv2']['w']",
        "['fc1']['b']", "['fc1']['w']", "['fc2']['b']", "['fc2']['w']"]
    again = tcnn.cnn_init(torch.Generator().manual_seed(0), device="cpu")
    other = tcnn.cnn_init(torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(p["fc1"]["w"], again["fc1"]["w"])
    assert not torch.equal(p["fc1"]["w"], other["fc1"]["w"])
    std = float(p["fc1"]["w"].std())
    assert abs(std - 320 ** -0.5) < 0.1 * 320 ** -0.5   # N(0, 1/din)


def test_cnn_dropout_draws_from_generator():
    p = tcnn.cnn_init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(_batch(0, n=1, b=4)["images"][0])
    a = tcnn.cnn_apply(p, x, torch.Generator().manual_seed(5))
    b = tcnn.cnn_apply(p, x, torch.Generator().manual_seed(5))
    c = tcnn.cnn_apply(p, x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, tcnn.cnn_apply(p, x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mix_matches_jax(dtype):
    params = _node_params(1)
    w = _w(1)
    if dtype == "bfloat16":
        j_params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
        t_params = td._tree_map(lambda x: x.to(torch.bfloat16), _torch(params))
        tol = 3e-2
    else:
        j_params, t_params, tol = _jax(params), _torch(params), TOL
    got = td.mix(t_params, w)
    assert all(x.dtype == getattr(torch, dtype) for x in td._leaves(got))
    _assert_close(got, jd.mix(j_params, jnp.asarray(w)), tol)


@pytest.mark.parametrize("mix_first", [True, False])
@pytest.mark.parametrize("local_steps", [1, 2])
def test_dpsgd_step_matches_jax(mix_first, local_steps):
    params, w = _node_params(2), _w(2)
    batch = _batch(2, h=None if local_steps == 1 else local_steps)
    cfg_j = jd.DPSGDConfig(eta=0.05, local_steps=local_steps,
                           mix_first=mix_first)
    cfg_t = td.DPSGDConfig(eta=0.05, local_steps=local_steps,
                           mix_first=mix_first)
    j_params, j_losses = jd.dpsgd_step(jcnn.cnn_loss, _jax(params),
                                       _jax(batch), jnp.asarray(w), cfg_j)
    step = td.make_dpsgd_step(tcnn.cnn_loss, cfg_t)
    t_params, t_losses = step(_torch(params), _torch(batch), w)
    _assert_close(t_losses, j_losses)
    _assert_close(t_params, j_params)


@pytest.mark.parametrize("mix_first", [True, False])
def test_masked_step_with_churned_w_matches_jax(mix_first):
    params = _node_params(3)
    ids = [0, 2, 3, 5]
    w = td.embed_w(_w(3, n=len(ids)), ids, N)
    assert np.array_equal(w, jd.embed_w(_w(3, n=len(ids)), ids, N))
    live = np.isin(np.arange(N), ids)
    batch = _batch(3)
    batch["images"][~live] = np.nan          # junk rows must not leak
    cfg = dict(eta=0.05, mix_first=mix_first)
    j_params, j_losses = jd.make_dpsgd_masked_step(
        jcnn.cnn_loss, jd.DPSGDConfig(**cfg))(_jax(params), _jax(batch),
                                              jnp.asarray(w), jnp.asarray(live))
    t_params, t_losses = td.make_dpsgd_masked_step(
        tcnn.cnn_loss, td.DPSGDConfig(**cfg))(_torch(params), _torch(batch), w,
                                              live)
    _assert_close(t_losses[live], np.asarray(j_losses)[live])
    _assert_close(t_params, j_params)
    for path, leaf in td._paths(t_params):                  # dead rows verbatim
        assert torch.isfinite(leaf).all(), path
    for dead in np.flatnonzero(~live):
        assert torch.equal(t_params["fc1"]["w"][dead],
                           torch.tensor(params["fc1"]["w"][dead]))


def _carried(params, res):
    """Message-granularity carried buffer (flat + residual), sorted-key
    leaf order, as numpy."""
    flat = np.concatenate([x.reshape(N, -1) for x in jax.tree.leaves(params)], 1)
    r = np.concatenate([x.reshape(N, -1) for x in jax.tree.leaves(res)], 1)
    return (flat.astype(np.float32) + r).astype(np.float32)


def _compressed_round(params, res, batch, w, live, mode, granularity,
                      mix_first=True):
    cfg = dict(eta=0.05, mix_first=mix_first)
    j_out = jd.make_dpsgd_compressed_step(
        jcnn.cnn_loss, jcomp.QuantConfig(mode=mode, granularity=granularity),
        jd.DPSGDConfig(**cfg))(_jax(params), _jax(batch), jnp.asarray(w),
                               jnp.asarray(live), _jax(res))
    step = td.make_dpsgd_compressed_step(
        tcnn.cnn_loss, tcomp.QuantConfig(mode=mode, granularity=granularity),
        td.DPSGDConfig(**cfg))
    t_out = step(_torch(params), _torch(batch), w, live, _torch(res))
    return j_out, t_out


@pytest.mark.parametrize("mode,granularity,mix_first", [
    (mode, granularity, True) for mode in ("none", "bf16", "int8")
    for granularity in ("message", "leaf")] + [
    ("int8", "message", False), ("bf16", "leaf", False)])
def test_masked_compressed_step_matches_jax(mode, granularity, mix_first):
    params = _node_params(4)
    rng = np.random.default_rng(4)
    res = jax.tree.map(
        lambda x: (rng.normal(size=x.shape) * 1e-3).astype(np.float32), params)
    ids = [0, 1, 2, 4, 5]
    w = td.embed_w(_w(4, n=len(ids)), ids, N)
    live = np.isin(np.arange(N), ids)
    (jp, jr, jl), (tp, tr, tl) = _compressed_round(
        params, res, _batch(4), w, live, mode, granularity, mix_first)
    _assert_close(tl, jl)
    _assert_close(tp, jp)
    _assert_close(tr, jr)
    if mode == "int8" and granularity == "message":
        carried = _carried(params, res)
        q_j, s_j = jcomp.quantize_int8_rows(jnp.asarray(carried))
        q_t, s_t = tcomp.quantize_int8_rows(torch.from_numpy(carried))
        assert np.array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)


def test_int8_rounds_held_step_by_step():
    """Three int8 EF rounds, both frameworks fed the JAX state each round."""
    params = _node_params(5)
    res = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), params)
    w, live = _w(5), np.ones(N, bool)
    for r in range(3):
        (jp, jr, jl), (tp, tr, tl) = _compressed_round(
            params, res, _batch(10 + r), w, live, "int8", "message")
        _assert_close(tl, jl)
        _assert_close(tp, jp)
        _assert_close(tr, jr)
        params = jax.tree.map(np.asarray, jp)
        res = jax.tree.map(np.asarray, jr)


def test_tree_helpers_and_contracts():
    params = _torch(_node_params(6))
    assert td.node_axis_size(params) == N
    res = td.zero_residuals(params)
    assert all(torch.count_nonzero(x) == 0 and x.dtype == torch.float32
               for x in td._leaves(res))
    with pytest.raises(ValueError, match="scalar"):
        td.node_axis_size({"a": torch.zeros(()), "b": torch.zeros(3)})
    assert td.node_axis_size({"a": torch.zeros(()), "b": torch.zeros(3)},
                             allow_scalar=True) == 3
    with pytest.raises(ValueError, match="disagree"):
        td.node_axis_size({"a": torch.zeros(2, 1), "b": torch.zeros(3)})
    one = tcnn.cnn_init(torch.Generator().manual_seed(0), device="cpu")
    rep = td.replicate(one, 4)
    assert rep["conv1"]["w"].shape == (4, 10, 1, 5, 5)
    rep["conv1"]["w"][0].zero_()                      # nodes own their copy
    assert torch.count_nonzero(rep["conv1"]["w"][1]) > 0
    batch = _torch(_batch(6))
    live = np.ones(N, bool)
    with pytest.raises(NotImplementedError):
        td.dpsgd_masked_step(tcnn.cnn_loss, params, batch, _w(6), live,
                             td.DPSGDConfig(local_steps=2))
    with pytest.raises(ValueError, match="unknown compression mode"):
        td.dpsgd_masked_compressed_step(
            tcnn.cnn_loss, params, batch, _w(6), live, res,
            tcomp.QuantConfig(mode="fp4"))
    with pytest.raises(ValueError, match="disagree"):
        td.dpsgd_masked_compressed_step(
            tcnn.cnn_loss, params, batch, _w(6, n=5), live, res,
            tcomp.QuantConfig(mode="int8"))


def test_params_cross_frameworks_through_numpy():
    j = jax.tree.map(np.array, _node_params(7))
    t = params_from_numpy(j, "cpu")
    assert t["conv2"]["w"].shape == (N, 20, 10, 5, 5)
    assert t["fc1"]["w"].shape == (N, 320, 50)               # (din, dout)
    back = params_to_numpy(t)
    for k in j:
        for kk in j[k]:
            assert np.array_equal(back[k][kk], j[k][kk])
    j["fc1"]["w"][0, 0, 0] = 123.0                  # a copy, not a view
    assert float(t["fc1"]["w"][0, 0, 0]) != 123.0
