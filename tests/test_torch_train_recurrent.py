"""Training the recurrent archs with the port, on the CPU, against the JAX
package.

The slice that trains recurrentgemma-2b and rwkv6-7b over wireless traces:
the RG-LRU and RWKV-6 scans' backward (each plain backward against
autograd through its plain forward; the autograd Functions against
``jax.grad`` of the JAX package's ``linear_recurrence`` and
``wkv_chunked``; ``vmap`` over nodes of ``grad_and_value`` as one call of
each Function for all nodes, rwkv6's u a node's own), ``api.loss`` and its
gradient against ``jax.grad`` on both smoke configs (weights carried
across by ``convert.params_from_numpy``), and
``sim.batch.transformer_adapter`` on both archs trained by
``train_model_on_traces`` against the per-round reference and against the
JAX package over the same traces. Inputs are drawn with numpy from fixed
seeds. Bars: rglru 1e-4, rwkv6 5e-4 of max(1, max |reference|) (the
kernels' bars, tests/test_kernels.py); the D-PSGD parity bar 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from repro.configs import get_config as r_get_config
from repro.configs import reduce_for_smoke as r_reduce
from repro.models import build as r_build
from repro.models import rglru as r_rglru
from repro.models import rwkv6 as r_rwkv6
from repro.sim import batch as r_batch
from repro.sim import scenario as r_scenario
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import dpsgd as t_dpsgd
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.models import build
from repro_torch.sim import batch as t_batch
from repro_torch.sim import scenario as t_scenario
from repro_torch.sim import trace as t_trace

ARCHS = ("recurrentgemma-2b", "rwkv6-7b")
RGLRU_TOL, RWKV_TOL = 1e-4, 5e-4
LOCK = 1e-5


def _leaves(tree):
    return t_dpsgd._leaves(tree)


def _held(got, want, bar):
    """max |got - want| <= bar x max(1, max |want|), per gradient."""
    for g, w_ in zip(got, want):
        g = np.asarray(g.detach() if isinstance(g, torch.Tensor) else g,
                       np.float64)
        w_ = np.asarray(w_, np.float64)
        assert g.shape == w_.shape
        assert np.abs(g - w_).max() <= bar * max(1.0, np.abs(w_).max())


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _ab(b, s, d, seed):
    rng = np.random.default_rng(seed)
    return (1.0 / (1.0 + np.exp(-rng.normal(size=(b, s, d)))),
            rng.normal(size=(b, s, d)), rng.normal(size=(b, d)),
            rng.normal(size=(b, s, d)))


def _rkvw(b, s, h, d, seed):
    """r, k, v, w, u, s0, dy, ds_final as tests/test_kernels.py draws the
    scan's inputs (w = exp(-exp(N(0, 0.5^2))))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, s, h, d)) * 0.5))
    return (r, k, v, w, rng.normal(size=(h, d)) * 0.1,
            rng.normal(size=(b, h, d, d)), rng.normal(size=(b, s, h, d)),
            rng.normal(size=(b, h, d, d)))


# ---------------------------------------------------------------------------
# The plain backward versions against autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,with_h0", [(1, True), (33, False), (70, True)])
def test_rglru_bwd_plain_matches_autograd(s, with_h0):
    """rglru_scan_bwd_plain against autograd through rglru_scan_plain,
    fp32, 1e-5 (the same loop run backwards)."""
    a, x, h0, dh = (_t(z) for z in _ab(2, s, 24, seed=s))
    h0 = h0 if with_h0 else None
    leaves = [z.clone().requires_grad_() for z in (a, x, h0)
              if z is not None]
    out = rg.rglru_scan_plain(*leaves, *([None] if h0 is None else []))
    want = torch.autograd.grad(out, leaves, dh)
    got = rg.rglru_scan_bwd_plain(a, out.detach(), dh, h0)
    assert (got[2] is None) == (h0 is None)
    _held([g for g in got if g is not None], want, 1e-5)


def _wkv_exact(r, k, v, w, u, s0):
    """The exact recurrence, one step at a time (``wkv_step``'s update, w
    floored at 1e-12 as the scans floor it), in the inputs' dtype."""
    b, s, h, d = r.shape
    st = torch.zeros((b, h, d, d), dtype=r.dtype) if s0 is None else s0
    ys = []
    for t in range(s):
        kv = k[:, t, ..., None] * v[:, t, :, None]
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, t],
                               st + u[None, ..., None] * kv))
        st = torch.clamp(w[:, t], min=1e-12)[..., None] * st + kv
    return torch.stack(ys, 1), st


@pytest.mark.parametrize("s,states,chunk", [(1, True, 8), (37, False, 16),
                                            (70, True, 32)])
def test_rwkv6_bwd_plain_matches_autograd(s, states, chunk):
    """rwkv6_scan_bwd_plain (fp32) against autograd through the exact
    recurrence in float64, 1e-5 of max(1, max |reference|), with s0 and
    ds_final or neither; du per batch row sums to the shared u's
    gradient. (Autograd through the chunked plain forward in fp32 is no
    reference for dw: its d log w / w loses eps / w, 1.2e-2 here.)"""
    r, k, v, w, u, s0, dy, dsf = (_t(z) for z in _rkvw(2, s, 2, 16, s))
    s0, dsf = (s0, dsf) if states else (None, None)
    leaves = [z.double().requires_grad_() for z in (r, k, v, w, u, s0)
              if z is not None]
    y, s_fin = _wkv_exact(*leaves, *([None] if s0 is None else []))
    loss = (y * dy.double()).sum() + (
        (s_fin * dsf.double()).sum() if states else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, s0, dsf, chunk)
    assert got[4].shape == (2, 2, 16) and (got[5] is None) == (s0 is None)
    _held([*got[:4], got[4].sum(0), *got[5:6]][:len(want)], want, 1e-5)


# ---------------------------------------------------------------------------
# The autograd Functions against jax.grad of the JAX package's scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,with_h0", [(33, True), (70, False)])
def test_rglru_function_matches_jax_grad_of_linear_recurrence(s, with_h0):
    """rglru_scan through _RGLRU / _RGLRUBackward against jax.grad of the
    JAX model's associative scan, through a loss sum(h * dh), 1e-4."""
    a, x, h0, dh = _ab(2, s, 24, seed=s + 1)
    h0 = h0 if with_h0 else None

    def jloss(*args):
        return jnp.sum(r_rglru.linear_recurrence(*args) * jnp.asarray(
            dh, jnp.float32))
    jargs = [jnp.asarray(z, jnp.float32) for z in (a, x, h0)
             if z is not None]
    jgrads = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)
    leaves = [_t(z).requires_grad_() for z in (a, x, h0) if z is not None]
    out = rg.rglru_scan(*leaves, *([None] if h0 is None else []))
    assert out.grad_fn is not None
    (out * _t(dh)).sum().backward()
    _held([z.grad for z in leaves], jgrads, RGLRU_TOL)


@pytest.mark.parametrize("s,states", [(37, False), (70, True)])
def test_rwkv6_function_matches_jax_grad_of_wkv_chunked(s, states):
    """rwkv6_scan through _RWKV6 / _RWKV6Backward against jax.grad of the
    JAX model's wkv_chunked (chunk 32, the model's), through a loss
    sum(y * dy) (+ sum(s_final * ds_final) with s0), 5e-4."""
    r, k, v, w, u, s0, dy, dsf = _rkvw(2, s, 2, 16, seed=s + 2)
    s0 = s0 if states else None
    names = ["r", "k", "v", "w", "u"] + (["s0"] if states else [])

    def jloss(*args):
        y, s_fin = r_rwkv6.wkv_chunked(*args[:5], args[5] if states else
                                       None, chunk=32)
        out = jnp.sum(y * jnp.asarray(dy, jnp.float32))
        return out + (jnp.sum(s_fin * jnp.asarray(dsf, jnp.float32))
                      if states else 0.0)
    jargs = [jnp.asarray(z, jnp.float32) for z in (r, k, v, w, u, s0)
             if z is not None]
    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(*jargs)
    leaves = [_t(z).requires_grad_() for z in (r, k, v, w, u, s0)
              if z is not None]
    y, s_fin = rw.rwkv6_scan(*leaves[:5], leaves[5] if states else None,
                             chunk=32)
    assert y.grad_fn is not None
    loss = (y * _t(dy)).sum() + ((s_fin * _t(dsf)).sum() if states else 0)
    loss.backward()
    _held([z.grad for z in leaves], jgrads, RWKV_TOL)


def test_dw_near_the_floor_holds_where_the_reference_fp32_gradient_fails():
    """At the served decays (log w = -exp(U(0.5, 2) + N(0, 1)), w down to
    the 1e-12 floor) jax.grad of wkv_chunked in fp32 forms d log w as a
    sum of terms the size of G S and divides it by w: its dw is off from
    the float64 product by more than 1e3 times the largest |dw|. The
    port's fp32 plain backward, which forms dw as the product of G and
    S_{t-1}, holds 5e-4 of it."""
    rng = np.random.default_rng(0)
    r, k, v, dy = (rng.normal(size=(1, 64, 2, 16)) for _ in range(4))
    w = np.exp(-np.exp(rng.uniform(0.5, 2.0, size=r.shape)
                       + rng.normal(size=r.shape)))
    u = rng.normal(size=(2, 16)) * 0.1
    assert (w < 1e-9).any()
    want = rw.rwkv6_scan_bwd_plain(*(torch.from_numpy(x) for x in (
        r, k, v, w, u, dy)), chunk=32, acc_dtype=torch.float64)[3].numpy()
    jdw = jax.grad(lambda *a: jnp.sum(r_rwkv6.wkv_chunked(
        *a, chunk=32)[0] * jnp.asarray(dy, jnp.float32)), argnums=3)(
        *(jnp.asarray(x, jnp.float32) for x in (r, k, v, w, u)))
    scale = np.abs(want).max()
    assert np.abs(np.asarray(jdw, np.float64) - want).max() > 1e3 * scale
    got = rw.rwkv6_scan_bwd_plain(*(_t(x) for x in (r, k, v, w, u, dy)),
                                  chunk=32)[3]
    _held([got], [want], RWKV_TOL)


def test_vmap_grad_over_nodes_is_one_call_of_each_and_equals_a_loop(
        monkeypatch):
    """vmap(grad_and_value) over 3 nodes, as D-PSGD takes its gradients,
    through both scans with u a node's own parameter: the Functions' vmap
    rules fold the node axis into B (u then one per batch row), so each
    plain forward and backward runs once for all nodes, on plain tensors,
    and every node's loss and gradients equal a per-node loop's."""
    rng = np.random.default_rng(4)
    a = _t(1.0 / (1.0 + np.exp(-rng.normal(size=(3, 2, 20, 8)))))
    x = _t(rng.normal(size=(3, 2, 20, 8)))
    r, k, v = (_t(rng.normal(size=(3, 2, 20, 2, 8))) for _ in range(3))
    w = _t(np.exp(-np.exp(rng.normal(size=(3, 2, 20, 2, 8)) * 0.5)))
    u = _t(rng.normal(size=(3, 2, 8)) * 0.1)
    calls = []
    for mod, name in ((rg, "rglru_scan_plain"), (rg, "rglru_scan_bwd_plain"),
                      (rw, "rwkv6_scan_plain"), (rw, "rwkv6_scan_bwd_plain")):
        orig = getattr(mod, name)

        def spy(first, *args, _orig=orig, _name=name, **kw):
            calls.append((_name, tuple(first.shape),
                          torch._C._functorch.is_functorch_wrapped_tensor(
                              first)))
            return _orig(first, *args, **kw)
        monkeypatch.setattr(mod, name, spy)

    def loss(a_, x_, r_, k_, v_, w_, u_):
        y, _ = rw.rwkv6_scan(r_, k_, v_, w_, u_, chunk=8)
        return (rg.rglru_scan(a_, x_) ** 2).sum() + (y ** 2).sum()
    argnums = tuple(range(7))
    grads, losses = torch.func.vmap(torch.func.grad_and_value(
        loss, argnums=argnums))(a, x, r, k, v, w, u)
    assert sorted(calls) == sorted([
        ("rglru_scan_plain", (6, 20, 8), False),
        ("rglru_scan_bwd_plain", (6, 20, 8), False),
        ("rwkv6_scan_plain", (6, 20, 2, 8), False),
        ("rwkv6_scan_bwd_plain", (6, 20, 2, 8), False)])
    assert grads[6].shape == u.shape
    for i in range(3):
        g, l_ = torch.func.grad_and_value(loss, argnums=argnums)(
            a[i], x[i], r[i], k[i], v[i], w[i], u[i])
        assert abs(float(l_ - losses[i])) <= 1e-6 * float(abs(l_))
        _held([gv[i] for gv in grads], [z.numpy() for z in g], 1e-6)


# ---------------------------------------------------------------------------
# The model's loss and its gradient
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """An arch's smoke config in both packages and the JAX package's
    weights (seed 0), as numpy and as the port's tree."""
    jcfg = r_reduce(r_get_config(request.param))
    tcfg = reduce_for_smoke(get_config(request.param))
    jparams = jax.tree.map(np.asarray,
                           r_build(jcfg).init(jax.random.key(0)))
    return jcfg, tcfg, jparams, params_from_numpy(jparams, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_api_loss_and_gradient_match_jax(smoke, dtype):
    """api.loss and its gradient (torch.func.grad, through the scans'
    Functions) against jax.grad of the JAX package's api.loss on the
    recurrentgemma-2b and rwkv6-7b smoke configs, the same weights: fp32
    compute 1e-5 on the loss and on every gradient leaf (measured: at most
    1.8e-7 for recurrentgemma, 2.2e-6 for rwkv6); the config's bf16
    compute 1e-2 on the loss and, per leaf, 3e-2 of its largest |gradient|
    or 1e-3 of the whole gradient's, whichever is larger (the two
    frameworks round bf16 at other places: recurrentgemma's three lam
    leaves, whose gradients are 1e-3 to 1e-4 of the whole's 0.17, differ
    by 7.0e-6, 8.2e-6 and 6.8e-5, 5.2e-2, 3.6e-2 and 3.5e-2 of their own
    and at most 4e-4 of the whole; every other leaf of both archs within
    2.5e-2 of its own)."""
    jcfg, tcfg, jparams, tparams = smoke
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    tokens = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    jval, jgrad = jax.jit(jax.value_and_grad(r_build(jcfg).loss))(
        jax.tree.map(jnp.asarray, jparams), {"tokens": jnp.asarray(tokens)})
    tgrad, tval = torch.func.grad_and_value(build(tcfg, "cpu").loss)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    loss_tol, rel = (1e-5, None) if dtype == "float32" else (1e-2, 3e-2)
    assert abs(float(tval) - float(jval)) < loss_tol
    assert abs(float(jval) - np.log(tcfg.vocab_size)) < 1.0
    jleaves = [np.asarray(a, np.float32) for a in jax.tree.leaves(jgrad)]
    whole = max(float(np.abs(a).max()) for a in jleaves)
    for a, b in zip(jleaves, _leaves(tgrad)):
        b = b.detach().float().numpy()
        bar = 1e-5 if rel is None else max(rel * float(np.abs(a).max()),
                                           1e-3 * whole)
        assert float(np.abs(a - b).max()) <= bar


# ---------------------------------------------------------------------------
# transformer_adapter and train-on-trace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def adapters(request):
    kw = dict(batch=2, seq_len=8)
    return (r_batch.transformer_adapter(request.param, **kw),
            t_batch.transformer_adapter(request.param, device="cpu", **kw))


def _static(adapter, module, rounds):
    return module.get_scenario("static", model_bits=adapter.model_bits,
                               model_shapes=adapter.param_shapes,
                               eval_every_rounds=rounds)


def test_adapter_shapes_and_bits_match_reference(adapters):
    """param_shapes and model_bits exactly the JAX package's."""
    jad, tad = adapters
    assert tad.name == jad.name
    assert tad.param_shapes == jad.param_shapes
    assert tad.model_bits == jad.model_bits
    assert tad.param_shapes == tuple(tuple(x.shape) for x in _leaves(
        tad.init_params(0)))


def test_transformer_loop_matches_reference(adapters):
    """The family loop over a static trace against the per-round
    reference: losses and final parameters within 1e-5."""
    _, tad = adapters
    rounds = 2
    cfg = _static(tad, t_scenario, rounds)
    tb = t_trace.precompute_traces([cfg], rounds)
    tr = tb.traces[0]
    params0 = t_dpsgd.replicate(tad.init_params(cfg.seed), cfg.n_nodes)
    ref_final, ref_losses = t_batch.train_on_trace_reference(
        tad.loss_fn, params0, tr.w_eff, tr.live, tad.batch_fn(cfg, tr),
        t_dpsgd.DPSGDConfig(eta=0.05), payload=cfg.payload,
        active_seq=tr.active)
    _, out = t_batch.train_model_on_traces(tad, [cfg], rounds, eta=0.05,
                                           trace_batch=tb, device="cpu")
    ref_mean = np.where(tr.live, ref_losses, 0.0).sum(-1) / tr.live.sum(-1)
    np.testing.assert_allclose(out["losses"][0], ref_mean, atol=LOCK)
    want = t_ckpt.compact_nodes(ref_final, tr.live[-1])
    for a, b in zip(_leaves(out["final_params"][0]), _leaves(want)):
        assert float((a - b).abs().max()) <= LOCK
    assert np.isfinite(out["losses"]).all()


def test_port_trains_like_jax_over_the_same_traces(adapters):
    """train_model_on_traces in both packages over the static trace, the
    JAX package's initial weights carried across: masked mean losses and
    final parameters within 1e-5 (fp32), accuracies equal."""
    jad, tad = adapters
    rounds = 2
    jcfg = _static(jad, r_scenario, rounds)
    tcfg = _static(tad, t_scenario, rounds)
    carried = dataclasses.replace(tad, init_params=lambda seed: (
        params_from_numpy(jax.tree.map(np.asarray, jad.init_params(seed)),
                          "cpu")))
    _, jout = r_batch.train_model_on_traces(jad, [jcfg], rounds, eta=0.05)
    _, tout = t_batch.train_model_on_traces(carried, [tcfg], rounds,
                                            eta=0.05, device="cpu")
    np.testing.assert_allclose(tout["losses"], np.asarray(jout["losses"]),
                               atol=LOCK)
    np.testing.assert_array_equal(tout["acc"], np.asarray(jout["acc"]))
    for a, b in zip(jax.tree.leaves(jout["final_params"][0]),
                    _leaves(tout["final_params"][0])):
        assert float(np.abs(np.asarray(a) - b.numpy()).max()) <= LOCK
