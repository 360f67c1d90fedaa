"""Training a transformer with the port, on the CPU, against the JAX package.

The slice that trains stablelm-3b over wireless traces: the tree helpers
of ``core.dpsgd`` on the model's tree of dicts and lists (leaf order and
shapes, ``replicate``, ``mix``, ``compact_nodes``), flash attention's
backward (its plain version against autograd through the plain forward;
the autograd Functions against ``jax.grad`` of the JAX package's
``chunked_attention`` and ``local_block_attention``; ``vmap`` over nodes
of ``grad_and_value`` as one call for all nodes), ``api.loss`` and its
gradient against ``jax.grad`` on the stablelm-3b smoke config (weights
carried across by ``convert.params_from_numpy``), and
``sim.batch.transformer_adapter`` trained by ``train_model_on_traces``
against the per-round reference and against the JAX package over the
same traces. Inputs are drawn with numpy from fixed seeds.
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

from repro.checkpoint import ckpt as r_ckpt
from repro.configs import get_config as r_get_config
from repro.configs import reduce_for_smoke as r_reduce
from repro.core import dpsgd as r_dpsgd
from repro.models import attention as r_attn
from repro.models import build as r_build
from repro.sim import batch as r_batch
from repro.sim import scenario as r_scenario
from repro.sim import trace as r_trace
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import dpsgd as t_dpsgd
from repro_torch.core.compression import QuantConfig, payload_bits_tree
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build
from repro_torch.sim import batch as t_batch
from repro_torch.sim import scenario as t_scenario
from repro_torch.sim import trace as t_trace

ARCH = "stablelm-3b"
TOL = 2e-5          # flash's fp32 bar (tests/test_kernels.py)
LOCK = 1e-5         # the D-PSGD parity bar (tests/test_pytree_train.py)


def _leaves(tree):
    return t_dpsgd._leaves(tree)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def smoke():
    """The stablelm-3b smoke config in both packages and the JAX package's
    weights (seed 0), as numpy and as the port's tree."""
    jcfg = r_reduce(r_get_config(ARCH))
    tcfg = reduce_for_smoke(get_config(ARCH))
    jparams = jax.tree.map(np.asarray,
                           r_build(jcfg).init(jax.random.key(0)))
    return jcfg, tcfg, jparams, params_from_numpy(jparams, "cpu")


# ---------------------------------------------------------------------------
# Trees of dicts and lists
# ---------------------------------------------------------------------------

def test_tree_leaves_follow_jax_order(smoke):
    """The port's leaf order on the transformer's tree (lists of layer
    groups inside dicts) is jax.tree.leaves's: every leaf equal in turn."""
    _, tcfg, jparams, tparams = smoke
    jl, tl = jax.tree.leaves(jparams), _leaves(tparams)
    assert isinstance(tparams["unit"], list) and len(jl) == len(tl) > 10
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())
    # a tree drawn by the port has the same leaf shapes in the same order
    own = build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in _leaves(own)] == [a.shape for a in jl]
    assert t_dpsgd._unflatten(tparams, tl)["unit"][0]["attn"]["wq"]["w"] \
        is tparams["unit"][0]["attn"]["wq"]["w"]


def test_replicate_mix_and_compact_match_jax(smoke):
    """replicate, mix (one rows-mix launch over the concatenated leaves)
    and compact_nodes on the transformer's tree, against the JAX
    package's: leaf for leaf, in order."""
    _, _, jparams, tparams = smoke
    n = 4
    w = np.random.default_rng(0).dirichlet(np.ones(n), size=n)
    jrep = r_dpsgd.replicate(jax.tree.map(jnp.asarray, jparams), n)
    trep = t_dpsgd.replicate(tparams, n)
    assert t_dpsgd.node_axis_size(trep) == n
    for a, b in zip(jax.tree.leaves(jrep), _leaves(trep)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # distinct rows, so that the mix and the compaction move something
    jnode = jax.tree.map(lambda x: x * (1.0 + 0.1 * jnp.arange(n).reshape(
        (n,) + (1,) * (x.ndim - 1))), jrep)
    tnode = params_from_numpy(jax.tree.map(np.asarray, jnode), "cpu")
    jmix = r_dpsgd.mix(jnode, jnp.asarray(w, jnp.float32))
    tmix = t_dpsgd.mix(tnode, w)
    assert isinstance(tmix["unit"], list)
    for a, b in zip(jax.tree.leaves(jmix), _leaves(tmix)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)
    live = np.array([True, False, True, True])
    jc = r_ckpt.compact_nodes(jnode, live)
    tc = t_ckpt.compact_nodes(tnode, live)
    assert t_ckpt._node_width(tc, "compacted") == 3
    for a, b in zip(jax.tree.leaves(jc), _leaves(tc)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# Flash attention's backward
# ---------------------------------------------------------------------------

BWD_CASES = {   # (B, S, T, Hq, Hkv, D, causal, window)
    "causal": (2, 40, 40, 4, 4, 16, True, 0),
    "gqa": (2, 37, 37, 8, 2, 16, True, 0),
    "windowed": (1, 300, 300, 4, 1, 80, True, 64),
    "cross": (2, 21, 45, 4, 2, 16, False, 0),
    "d80": (1, 70, 70, 2, 2, 80, True, 0),
}


def _qkvd(b, s, t, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d),
                               (b, s, hq, d)))


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_plain_matches_autograd_through_the_plain_forward(case):
    """flash_attention_bwd_plain (the backward kernel's formulas) against
    torch.autograd through flash_attention_plain, fp32, 2e-5; the forward's
    lse against torch.logsumexp of the masked scaled scores."""
    b, s, t, hq, hkv, d, causal, window = BWD_CASES[case]
    q, k, v, do = _qkvd(b, s, t, hq, hkv, d)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    assert torch.equal(o, out.detach()) and lse.shape == (b, hq, s)
    got = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and g.dtype == w_.dtype
        assert float((g - w_).abs().max()) < TOL
    # summed in float64 (the card's oracle): the same formulas, fp32 out
    oracle = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                          window=window,
                                          acc_dtype=torch.float64)
    for g, w_ in zip(oracle, want):
        assert g.dtype == torch.float32
        assert float((g - w_).abs().max()) < TOL
    # lse from the scores themselves
    qpos, kpos = np.arange(s)[:, None], np.arange(t)[None, :]
    live = np.ones((s, t), bool)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= qpos - kpos < window
    scores = torch.einsum("bshd,bthd->bhst", q,
                          k.repeat_interleave(hq // hkv, 2)) * d**-0.5
    scores = scores.masked_fill(~torch.from_numpy(live), float("-inf"))
    assert float((torch.logsumexp(scores, -1) - lse).abs().max()) < TOL


JAX_CASES = {   # (B, S, T, Hq, Hkv, D, causal, window)
    "chunked_causal_gqa": (2, 37, 37, 4, 2, 16, True, 0),
    "chunked_cross": (2, 21, 45, 4, 4, 16, False, 0),
    "chunked_d80": (1, 70, 70, 2, 2, 80, True, 0),
    "local_window": (2, 50, 50, 4, 2, 16, True, 16),
    "local_d80": (1, 64, 64, 2, 1, 80, True, 24),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_function_gradients_match_jax_grad_of_the_reference(case):
    """flash_attention (through its autograd Functions) and its gradients
    against jax.grad of the JAX package's chunked_attention (global,
    causal or not, T != S) or local_block_attention (windowed), fp32,
    2e-5, through a loss sum(out * do)."""
    b, s, t, hq, hkv, d, causal, window = JAX_CASES[case]
    q, k, v, do = _qkvd(b, s, t, hq, hkv, d, seed=len(case))

    def jloss(q_, k_, v_):
        if window:
            out = r_attn.local_block_attention(q_, k_, v_, window=window)
        else:
            out = r_attn.chunked_attention(q_, k_, v_, causal=causal)
        return jnp.sum(out * jnp.asarray(do.numpy()))
    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None
    val = (out * do).sum()
    val.backward()
    assert abs(float(val.detach()) - float(jval)) < TOL * max(
        1.0, abs(float(jval)))
    for x, jg in zip(leaves, jgrads):
        assert float(np.abs(x.grad.numpy() - np.asarray(jg)).max()) < TOL


def test_vmap_grad_over_nodes_is_one_call_and_equals_a_node_loop(
        monkeypatch):
    """vmap(grad_and_value) over 3 nodes, as D-PSGD takes its gradients:
    the Functions' vmap rules fold the node axis into B, so the plain
    forward and the plain backward each run once for all nodes, on plain
    tensors, and every node's loss and gradients equal a per-node loop's."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(3, 16, 48)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 2, 20, 16)).astype(np.float32))
    calls = []
    for name in ("flash_attention_plain", "flash_attention_bwd_plain"):
        orig = getattr(fa, name)

        def spy(q, *a, _orig=orig, _name=name, **kw):
            calls.append((_name, tuple(q.shape),
                          torch._C._functorch.is_functorch_wrapped_tensor(q)))
            return _orig(q, *a, **kw)
        monkeypatch.setattr(fa, name, spy)

    def loss(w_, x_):
        q, k, v = (x_ @ w_).reshape(2, 20, 3, 4, 4).unbind(2)
        out = fa.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
        return (out * out).sum()
    grads, losses = torch.func.vmap(torch.func.grad_and_value(loss))(w, x)
    assert calls == [("flash_attention_plain", (6, 20, 4, 4), False),
                     ("flash_attention_bwd_plain", (6, 20, 4, 4), False)]
    for i in range(3):
        g, l_ = torch.func.grad_and_value(loss)(w[i], x[i])
        assert torch.equal(l_, losses[i]) and torch.equal(g, grads[i])


# ---------------------------------------------------------------------------
# The model's loss and its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_api_loss_and_gradient_match_jax(smoke, dtype):
    """api.loss and its gradient (torch.func.grad) against jax.grad of the
    JAX package's api.loss on the stablelm-3b smoke config, the same
    weights: fp32 compute 1e-5 on the loss and every gradient leaf; the
    config's bf16 compute 1e-2 on the loss and 3e-2 of each leaf's
    largest |gradient| (the two frameworks round bf16 at other places)."""
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
    for a, b in zip(jax.tree.leaves(jgrad), _leaves(tgrad)):
        a = np.asarray(a, np.float32)
        bar = 1e-5 if rel is None else rel * float(np.abs(a).max())
        assert float(np.abs(a - _np(b)).max()) <= bar


# ---------------------------------------------------------------------------
# transformer_adapter and train-on-trace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adapters():
    kw = dict(batch=2, seq_len=8)
    return (r_batch.transformer_adapter(ARCH, **kw),
            t_batch.transformer_adapter(ARCH, device="cpu", **kw))


def test_adapter_shapes_bits_and_errors_match_reference(adapters):
    """param_shapes and model_bits exactly the JAX package's; the
    encoder-decoder refused as there."""
    jad, tad = adapters
    assert tad.name == jad.name
    assert tad.param_shapes == jad.param_shapes
    assert tad.model_bits == jad.model_bits
    assert tad.param_shapes == tuple(tuple(x.shape) for x in _leaves(
        tad.init_params(0)))
    with pytest.raises(ValueError, match="encoder-decoder"):
        t_batch.transformer_adapter("seamless-m4t-large-v2", device="cpu")


def test_host_token_batches_equal_the_reference():
    """_host_token_batches on a churn trace (dead rows zero-filled), exactly
    the JAX package's."""
    jcfg = r_scenario.get_scenario("churn", seed=3)
    tcfg = t_scenario.get_scenario("churn", seed=3)
    jtr = r_trace.precompute_traces([jcfg], 12).traces[0]
    ttr = t_trace.precompute_traces([tcfg], 12).traces[0]
    assert np.array_equal(jtr.live, ttr.live) and not ttr.live.all()
    want = r_batch._host_token_batches(jcfg, jtr, 3, 16, 512)
    got = t_batch._host_token_batches(tcfg, ttr, 3, 16, 512)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _static(adapter, module, rounds):
    return module.get_scenario("static", model_bits=adapter.model_bits,
                               model_shapes=adapter.param_shapes,
                               eval_every_rounds=rounds)


def test_transformer_loop_matches_reference(adapters):
    """The twin of tests/test_pytree_train.py's
    test_transformer_scan_matches_reference: the family loop over a static
    trace against the per-round reference, losses and final parameters
    within 1e-5."""
    _, tad = adapters
    rounds = 3
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
    assert out["acc"].shape == (1, 1) and 0.0 <= out["acc"][0, 0] <= 1.0


def test_port_trains_like_jax_over_the_same_traces(adapters):
    """train_model_on_traces in both packages over the static trace, the
    JAX package's initial weights carried across: masked mean losses and
    final parameters within 1e-5 (fp32), accuracies equal."""
    jad, tad = adapters
    rounds = 3
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


def test_leaf_compressed_family_trains_finite(adapters):
    """Per-leaf int8 (each leaf its own block grid and residual: the send
    and q8 kernels' plain versions) over a fading family of two seeds:
    finite losses and the wire bits of the per-leaf framing, as the JAX
    package's test_transformer_leaf_compressed_trains_finite."""
    _, tad = adapters
    payload = QuantConfig(mode="int8", granularity="leaf")
    cfgs = [t_scenario.get_scenario(
        "fading", seed=s, model_bits=tad.model_bits,
        model_shapes=tad.param_shapes, payload=payload, eval_every_rounds=3)
        for s in range(2)]
    assert cfgs[0].wire_bits() == payload_bits_tree(tad.param_shapes,
                                                    payload)
    _, out = t_batch.train_model_on_traces(tad, cfgs, 3, eta=0.05,
                                           device="cpu")
    assert out["losses"].shape == (2, 3) and np.isfinite(out["losses"]).all()
    assert all(t_dpsgd.node_axis_size(p) > 0 for p in out["final_params"])


def test_mix_of_a_large_tree_in_bounded_buffers_equals_one_buffer(
        monkeypatch, smoke):
    """mix groups the leaves into rows-mix buffers of at most
    MIX_CONCAT_LANES lanes a node (a larger leaf alone, as its own view):
    bit-equal to the one-buffer mix, one launch per group, and the CNN's
    21 840 lanes stay one launch."""
    _, _, _, tparams = smoke
    node = t_dpsgd._tree_map(lambda p: p[None] * torch.tensor(
        [1.0, 0.5, -0.25])[(...,) + (None,) * p.dim()], tparams)
    w = np.random.default_rng(1).dirichlet(np.ones(3), size=3)
    want = t_dpsgd.mix(node, w)
    calls = []
    rows = t_dpsgd.gossip_mix_rows

    def counted(w_, flat):
        calls.append(tuple(flat.shape))
        return rows(w_, flat)
    monkeypatch.setattr(t_dpsgd, "gossip_mix_rows", counted)
    monkeypatch.setattr(t_dpsgd, "MIX_CONCAT_LANES", 4096)
    sizes = [x[0].numel() for x in _leaves(node)]
    groups = t_dpsgd.mix_groups(sizes)
    assert len(groups) > 3 and sorted(sum(groups, [])) == list(range(
        len(sizes)))
    assert all(len(g) == 1 or sum(sizes[i] for i in g) <= 4096
               for g in groups)
    got = t_dpsgd.mix(node, w)
    assert len(calls) == len(groups)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)
    monkeypatch.undo()
    assert t_dpsgd.mix_groups([21_840]) == [[0]]


@pytest.mark.parametrize("kind", ["global", "mla"])
def test_layer_checks_positions_unless_its_caller_built_them(kind):
    """A layer's flash path checks that positions are arange(S), with or
    without a cache; ``positions_are_arange`` (passed by
    ``transformer.apply``, which builds them so) skips the check, and the
    teacher-forced loss goes through."""
    from repro_torch.models import attention as t_attn
    from repro_torch.models import mla as t_mla

    arch = ARCH if kind == "global" else "deepseek-v2-lite-16b"
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="float32")
    gen = torch.Generator().manual_seed(5)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    if kind == "global":
        p = t_attn.attn_init(gen, cfg, torch.device("cpu"))

        def run(pos, **kw):
            return t_attn.attn_apply(p, x, cfg, kind="global", positions=pos,
                                     **kw)[0]
    else:
        p = t_mla.mla_init(gen, cfg, cfg.mla, torch.device("cpu"))

        def run(pos, **kw):
            return t_mla.mla_apply(p, x, cfg, m=cfg.mla, positions=pos,
                                   **kw)[0]
    pos = torch.arange(8)
    assert torch.equal(run(pos), run(pos, positions_are_arange=True))
    with pytest.raises(ValueError, match="arange"):
        run(pos + 3)
    api = build(cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(2, 8)).astype(np.int64))
    assert torch.isfinite(api.loss(api.init(gen), {"tokens": tokens}))
