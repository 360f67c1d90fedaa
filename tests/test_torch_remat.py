"""Activation checkpointing (``repro_torch.models.remat``) on the CPU.

``remat.checkpoint`` against the plain function (fp64, exact, under
``torch.func.grad`` and ``vmap(grad_and_value)``; the unit runs twice
under a checkpoint, once without); ``api.loss(remat="full" | "dots")``
against ``remat="none"`` for every family of ``chip_smoke.py`` phase 23
(a) at the smoke widths (qwen2-vl-2b, rwkv6-7b and deepseek-v2-lite-16b
deepened to 3 layers so that several units are checkpointed): losses and
gradients within 1e-6, and bit-equal for every family but
seamless-m4t-large-v2, whose encoder output collects one gradient from
each checkpointed decoder layer and sums them in another order (1.1e-8),
under ``grad`` and under ``vmap`` over 2 nodes; "full" runs each kernel's
forward and each weight product twice in a checkpointed unit, "dots"
once; the MoE recompute routes as the forward did, dropped pairs
included; the encoder-decoder's training path slices no layer out of its
stack; and ``jax.grad`` of the JAX package's ``api.loss`` at remat
"full" (qwen2-vl-2b, rwkv6-7b, seamless-m4t-large-v2) and "dots"
(deepseek-v2-lite-16b) within 1e-5, the weights carried across with
``convert.params_from_numpy`` (rwkv6-7b at its smoke depth of 1 layer: at
3 its scan's gradient is 1.27e-4 off the reference's on the embedding,
whose entries reach 1.65, with remat "none" on both sides as well, inside
the scans' 5e-4 of max(1, max |reference|)).
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
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import dpsgd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.models import build, encdec, moe, remat, transformer

ARCHS = ["qwen2-vl-2b", "gemma3-12b", "recurrentgemma-2b", "rwkv6-7b",
         "deepseek-v2-lite-16b", "seamless-m4t-large-v2"]
DEEPER = {"qwen2-vl-2b": 3, "rwkv6-7b": 3, "deepseek-v2-lite-16b": 3}
NOT_BIT_EQUAL = {"seamless-m4t-large-v2"}
SELF = 1e-6          # remat against none, in the port
REF = 1e-5           # the port against the JAX package (fp32 smoke)
NODES = 2
SEQ = 32


def _cfgs(arch, deeper=True):
    jcfg, tcfg = r_reduce(r_get_config(arch)), reduce_for_smoke(
        get_config(arch))
    if deeper and arch in DEEPER:
        jcfg = dataclasses.replace(jcfg, n_layers=DEEPER[arch])
        tcfg = dataclasses.replace(tcfg, n_layers=DEEPER[arch])
    return jcfg, tcfg


def _batch(cfg, seed=3, rows=2, seq=SEQ):
    """A numpy batch: (rows, seq) tokens, the vision stub's patch
    embeddings, or the encoder-decoder's seq / 2 frames and tokens."""
    rng = np.random.default_rng(seed)
    s = seq // 2 if cfg.is_encdec else seq
    b = {"tokens": rng.integers(0, cfg.vocab_size, (rows, s)).astype(
        np.int32)}
    if cfg.is_encdec:
        b["src_embeds"] = rng.normal(size=(rows, s, cfg.d_model)).astype(
            np.float32)
    elif cfg.frontend == "vision":
        b["patch_embeds"] = rng.normal(
            size=(rows, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _max_diff(a_tree, b_tree) -> float:
    a, b = dpsgd._leaves(a_tree), dpsgd._leaves(b_tree)
    assert len(a) == len(b)
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _bit_equal(a_tree, b_tree) -> bool:
    return all(torch.equal(x, y) for x, y in zip(dpsgd._leaves(a_tree),
                                                 dpsgd._leaves(b_tree)))


# ---------------------------------------------------------------------------
# The checkpoint itself
# ---------------------------------------------------------------------------

def _toy(runs):
    def unit(p, x):
        runs.append(1)
        h = torch.tanh(remat.product(x, p["w"][0]) + p["b"])
        return x + remat.product(h, p["w"][1])

    def loss(params, x, policy):
        for p in params:
            x = remat.checkpoint(unit, p, x, policy=policy)
        return (x ** 2).sum()
    return loss


def _toy_params(gen, n=None):
    lead = () if n is None else (n,)
    return [{"w": [torch.randn(*lead, 6, 6, generator=gen,
                               dtype=torch.float64) for _ in range(2)],
             "b": torch.randn(*lead, 6, generator=gen, dtype=torch.float64)}
            for _ in range(3)]


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_checkpoint_equals_the_plain_function(policy):
    """fp64: the value and every gradient bit-equal to the plain function
    under grad and under vmap(grad_and_value) over 2 nodes; the unit runs
    twice a checkpoint (forward, recompute), once without one."""
    gen = torch.Generator().manual_seed(0)
    params = _toy_params(gen)
    x = torch.randn(2, 5, 6, generator=gen, dtype=torch.float64)
    runs: list = []
    loss = _toy(runs)
    want_g, want_l = torch.func.grad_and_value(loss)(params, x, "none")
    assert len(runs) == 3
    runs.clear()
    got_g, got_l = torch.func.grad_and_value(loss)(params, x, policy)
    assert len(runs) == 6
    assert torch.equal(got_l, want_l) and _bit_equal(got_g, want_g)

    node_params = _toy_params(gen, NODES)
    xs = torch.randn(NODES, 2, 5, 6, generator=gen, dtype=torch.float64)
    mapped = torch.func.vmap(torch.func.grad_and_value(loss),
                             in_dims=(0, 0, None))
    want_g, want_l = mapped(node_params, xs, "none")
    got_g, got_l = mapped(node_params, xs, policy)
    assert torch.equal(got_l, want_l) and _bit_equal(got_g, want_g)


def test_dots_keeps_the_products_and_full_recomputes_them(monkeypatch):
    """Products run: 6 without a checkpoint, 12 under "full" (each again
    in its recompute), 6 under "dots" (the recompute takes them from the
    forward); all three give one gradient."""
    calls = []
    plain = remat._matmul
    monkeypatch.setattr(remat, "_matmul",
                        lambda x, w: calls.append(1) or plain(x, w))
    gen = torch.Generator().manual_seed(1)
    params = _toy_params(gen)
    x = torch.randn(2, 5, 6, generator=gen, dtype=torch.float64)
    loss = _toy([])
    grads = {}
    for policy, want in (("none", 6), ("full", 12), ("dots", 6)):
        calls.clear()
        grads[policy] = torch.func.grad(loss)(params, x, policy)
        assert len(calls) == want, policy
    assert _bit_equal(grads["full"], grads["none"])
    assert _bit_equal(grads["dots"], grads["none"])


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_checkpoint_refuses_a_second_derivative(policy):
    """A second derivative through a checkpointed unit raises, under
    torch.func and under autograd's create_graph, where the plain
    function (the toy runs no kernel) has one."""
    gen = torch.Generator().manual_seed(2)
    params = _toy_params(gen)
    x = torch.randn(2, 5, 6, generator=gen, dtype=torch.float64)
    loss = _toy([])

    def dx_norm(x, policy):
        return (torch.func.grad(loss, argnums=1)(params, x, policy)
                ** 2).sum()
    assert torch.isfinite(torch.func.grad(dx_norm)(x, "none")).all()
    with pytest.raises(RuntimeError, match="no double backward"):
        torch.func.grad(dx_norm)(x, policy)
    xr = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(params, xr, policy), xr,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="no double backward"):
        torch.autograd.grad(g.sum(), xr)


def test_checkpoint_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="remat must be one of"):
        remat.checkpoint(lambda x: x, torch.ones(2), policy="offload")


# ---------------------------------------------------------------------------
# Every family: remat against none in the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    _, cfg = _cfgs(arch)
    api = build(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = params_from_numpy(_batch(cfg), "cpu")
    return arch, api, params, batch


def _counted(monkeypatch):
    """Counters of the weight products and of each kernel's forward."""
    counts = {"products": 0, "flash": 0, "rglru": 0, "rwkv6": 0}
    for mod, name, key in ((remat, "_matmul", "products"),
                           (fa, "_forward", "flash"),
                           (rg, "_forward", "rglru"),
                           (rw, "_forward", "rwkv6")):
        def wrap(*a, _f=getattr(mod, name), _k=key, **kw):
            counts[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)
    return counts


def test_remat_equals_none_under_grad(family, monkeypatch):
    """Mode A's form: losses and gradients of "full" and "dots" within
    1e-6 of "none" (bit-equal but for seamless); "full" runs every kernel
    forward and product of a checkpointed unit twice, "dots" as often as
    "none"."""
    arch, api, params, batch = family
    counts = _counted(monkeypatch)
    out, seen = {}, {}
    for policy in remat.POLICIES:
        for k in counts:
            counts[k] = 0
        out[policy] = torch.func.grad_and_value(
            lambda p, b: api.loss(p, b, remat=policy))(params, batch)
        seen[policy] = dict(counts)
    (g0, l0) = out["none"]
    assert abs(float(l0) - np.log(api.cfg.vocab_size)) < 1.0
    for policy in ("full", "dots"):
        g, loss = out[policy]
        assert abs(float(loss - l0)) <= SELF
        assert _max_diff(g, g0) <= SELF, (arch, policy)
        if arch not in NOT_BIT_EQUAL:
            assert torch.equal(loss, l0) and _bit_equal(g, g0), (arch,
                                                                 policy)
    assert seen["dots"] == seen["none"], seen
    for k, n in seen["none"].items():
        assert seen["full"][k] > n if n else seen["full"][k] == 0, seen
    if arch == "qwen2-vl-2b":    # every layer in a unit: all run twice
        assert seen["full"] == {k: 2 * n for k, n in seen["none"].items()}


def test_remat_equals_none_under_vmap_over_nodes(family):
    """Mode B's form, vmap(grad_and_value) over 2 de-synced nodes: the
    same bars as under grad."""
    arch, api, params, batch = family
    nodes = dpsgd._tree_map(
        lambda p: p * (1 + 0.01 * torch.arange(NODES, dtype=p.dtype).reshape(
            -1, *[1] * (p.dim() - 1))), dpsgd.replicate(params, NODES))
    batches = dpsgd._tree_map(lambda x: torch.stack([x, x.flip(0)]), batch)
    out = {policy: torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: api.loss(p, b, remat=policy)))(nodes, batches)
        for policy in remat.POLICIES}
    g0, l0 = out["none"]
    for policy in ("full", "dots"):
        g, losses = out[policy]
        assert float((losses - l0).abs().max()) <= SELF
        assert _max_diff(g, g0) <= SELF, (arch, policy)
        if arch not in NOT_BIT_EQUAL:
            assert torch.equal(losses, l0) and _bit_equal(g, g0)


def test_moe_recompute_routes_as_the_forward(monkeypatch):
    """deepseek-v2-lite-16b at capacity factor 0.5 over 256 tokens (an
    expert takes 64 of its ~128 pairs; the capacity's floor, min(S, 64),
    drops nothing at S <= 64): under "full" each checkpointed MoE layer's
    recompute routes every (token, expert) pair as its forward did, the
    dropped ones included."""
    _, cfg = _cfgs("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    api = build(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = params_from_numpy(_batch(cfg, rows=1, seq=256), "cpu")
    routes = []
    route = moe.moe_route

    def recorded(*a, **kw):
        r = route(*a, **kw)
        routes.append({k: r[k].tolist() for k in ("expert", "gate", "keep",
                                                   "slot")})
        return r
    monkeypatch.setattr(moe, "moe_route", recorded)
    torch.func.grad(lambda p, b: api.loss(p, b, remat="full"))(params, batch)
    pro, repeats, _ = transformer.layer_groups(cfg)
    moe_units = repeats          # the prologue's dense layer has no MoE
    assert len(routes) == 2 * moe_units
    # forward order: units 1..R; recompute order: unit R first (backward)
    forward, recompute = routes[:moe_units], routes[moe_units:][::-1]
    assert forward == recompute
    assert any(not k for r in forward for row in r["keep"] for t in row
               for k in t), "no pair was dropped"


def test_encdec_training_path_slices_no_layer(monkeypatch):
    """The encoder-decoder's training path unbinds each stack once: with
    per-layer indexing made to raise, its loss and gradient still run
    (none and full) and agree."""
    _, cfg = _cfgs("seamless-m4t-large-v2")
    api = build(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = params_from_numpy(_batch(cfg), "cpu")

    def refuse(*_):
        raise AssertionError("a layer was sliced out of its stack")
    monkeypatch.setattr(encdec, "_tree_index", refuse)
    grads = [torch.func.grad(lambda p, b: api.loss(p, b, remat=policy))(
        params, batch) for policy in ("none", "full")]
    assert _max_diff(*grads) <= SELF


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

JAX_CASES = [("qwen2-vl-2b", "full", True), ("rwkv6-7b", "full", False),
             ("seamless-m4t-large-v2", "full", True),
             ("deepseek-v2-lite-16b", "dots", True)]


@pytest.mark.parametrize("arch,policy,deeper", JAX_CASES,
                         ids=[f"{a}-{p}" for a, p, _ in JAX_CASES])
def test_remat_gradient_matches_jax(arch, policy, deeper):
    """jax.grad of the JAX package's api.loss(remat=policy) against the
    port's torch.func.grad of api.loss(remat=policy), the same weights
    and batch: the loss and every gradient leaf within 1e-5."""
    jcfg, tcfg = _cfgs(arch, deeper)
    japi = r_build(jcfg)
    jparams = jax.tree.map(np.asarray, japi.init(jax.random.key(0)))
    batch = _batch(tcfg)
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss(p, b, remat=policy)))(
        jax.tree.map(jnp.asarray, jparams),
        jax.tree.map(jnp.asarray, batch))
    tgrad, tval = torch.func.grad_and_value(
        lambda p, b: build(tcfg, "cpu").loss(p, b, remat=policy))(
        params_from_numpy(jparams, "cpu"), params_from_numpy(batch, "cpu"))
    assert abs(float(tval) - float(jval)) <= REF
    got, want = dpsgd._leaves(tgrad), jax.tree.leaves(jgrad)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert float(np.abs(a.numpy() - b).max(initial=0.0)) <= REF
