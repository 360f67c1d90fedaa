"""The port's MoE MLP (``models.moe``) against the JAX package's, on the
CPU in fp32.

Parameters are drawn by the JAX package and carried across with
``convert.params_from_numpy``; inputs are numpy from a seed. Outputs
within 2e-5 (the model layers' bar in tests/test_torch_models.py); the
routing exactly: the same top-k experts, and the same (token, expert)
pairs dropped past capacity, taken from the JAX package's own
``_dispatch_row``.

The combine's order: the port sums each token's k gated expert outputs
from zero in ascending expert order. The JAX package's ``.at[token].add``
meets a token's updates in its stable sort's order, which is ascending
expert order too, so the two orders do not differ. Two tests show it in
bf16, where the order of additions shows: the port's combine bit-equal to
a sequential scatter-add in that order, and the port's ``moe_apply``
bit-equal to the JAX package's own, on inputs whose expert products are
exact (so that only the combine rounds). A serve repeats itself (no
atomics).
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

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import moe as j_moe
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as t_moe

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=128, dtype="float32", param_dtype="float32")


def _cfgs(**moe):
    moe = {**dict(n_experts=4, top_k=2, d_ff_expert=32, n_shared=0), **moe}
    jc = JaxModelConfig(name="t", family="moe", **BASE,
                        moe=JaxMoEConfig(**moe))
    tc = ModelConfig(name="t", family="moe", **BASE, moe=MoEConfig(**moe))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _params(jc, seed):
    return jax.tree.map(np.array, j_moe.moe_init(jax.random.key(seed), jc,
                                                 jc.moe))


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().float().numpy())))


def _jax_routing(p, x, jc):
    """The JAX package's routing of x: top-k experts (b, s, k) and the
    set of (row, token, expert) pairs its dispatch drops."""
    mc = jc.moe
    b, s, _ = x.shape
    cap = max(int(s * mc.top_k * mc.capacity_factor / mc.n_experts),
              min(s, 64), mc.top_k)
    logits = jnp.einsum("bsd,de->bse", x, p["router"]["w"])
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    gate, expert = jax.lax.top_k(probs, mc.top_k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    _, _, token, _, keep = jax.vmap(lambda xr, er, gr: j_moe._dispatch_row(
        xr, er, gr, p, jc, mc, cap))(x, expert, gate)
    expert_sorted = jnp.sort(expert.reshape(b, -1), axis=-1, stable=True)
    dropped = {(r, int(t), int(e)) for r in range(b)
               for t, e, kp in zip(np.asarray(token[r]),
                                   np.asarray(expert_sorted[r]),
                                   np.asarray(keep[r])) if not kp}
    return np.asarray(expert), dropped, cap


def _port_dropped(r):
    b, s, k = r["keep"].shape
    keep, expert = r["keep"].numpy(), r["expert"].numpy()
    return {(i, t, int(expert[i, t, j])) for i in range(b) for t in range(s)
            for j in range(k) if not keep[i, t, j]}


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("s", [1, 16, 33])
def test_moe_apply_matches_jax(n_shared, s):
    jc, tc = _cfgs(n_shared=n_shared)
    p = _params(jc, 1)
    x = _x(2, s, 64, seed=2)
    want = j_moe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc,
                           jc.moe)
    got = t_moe.moe_apply(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                          tc, tc.moe)
    assert got.shape == (2, s, 64) and _err(want, got) <= 2e-5
    assert ("shared" in p) == bool(n_shared)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_drops_the_same_pairs_as_jax(n_shared):
    """200 tokens a row over 4 experts, top-2, at capacity factor 0.5:
    cap = max(50, 64, 2) = 64 slots an expert against ~100 pairs, so each
    row drops pairs; the same ones as the reference (the later positions
    of each expert's group, by the stable sort), and the outputs agree."""
    jc, tc = _cfgs(n_shared=n_shared, capacity_factor=0.5)
    p = _params(jc, 3)
    x = _x(2, 200, 64, seed=4)
    j_expert, j_dropped, cap = _jax_routing(jax.tree.map(jnp.asarray, p),
                                            jnp.asarray(x), jc)
    tp = params_from_numpy(p, "cpu")
    r = t_moe.moe_route(tp, torch.from_numpy(x), tc, tc.moe)
    assert r["cap"] == cap == 64
    assert np.array_equal(r["expert"].numpy(), j_expert)
    assert len(j_dropped) > 50 and _port_dropped(r) == j_dropped
    want = j_moe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc,
                           jc.moe)
    got = t_moe.moe_apply(tp, torch.from_numpy(x), tc, tc.moe)
    assert _err(want, got) <= 2e-5


@pytest.mark.parametrize("tie", ["all", "pair"])
def test_moe_ties_go_to_the_lower_expert(tie):
    """Rows with tied routing probabilities: a zero router (every expert
    tied: the top 2 are experts 0 and 1 for every token, and 100 tokens
    overflow their 64 slots) and a router whose columns 1 and 3 are equal
    (those two always tie). ``lax.top_k`` takes the lower index first;
    the port's stable sort does the same, so the experts, the dropped
    pairs and the outputs agree."""
    jc, tc = _cfgs(n_experts=4, top_k=2)
    p = _params(jc, 5)
    w = p["router"]["w"]
    if tie == "all":
        w[:] = 0.0
    else:
        w[:, 3] = w[:, 1]
    x = _x(2, 100, 64, seed=6)
    j_expert, j_dropped, _ = _jax_routing(jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(x), jc)
    tp = params_from_numpy(p, "cpu")
    r = t_moe.moe_route(tp, torch.from_numpy(x), tc, tc.moe)
    expert = r["expert"].numpy()
    assert np.array_equal(expert, j_expert)
    if tie == "all":
        assert (expert == [0, 1]).all() and len(j_dropped) == 2 * 2 * 36
    else:
        # 3 comes only behind its twin 1 (both on top); where the twins
        # tie for second place, 1 takes it and 3 is left out
        has3 = (expert == 3).any(-1)
        assert has3.any() and (expert[has3] == [1, 3]).all()
        assert ((expert[..., 1] == 1) & ~has3).any()
    assert _port_dropped(r) == j_dropped
    want = j_moe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc,
                           jc.moe)
    assert _err(want, t_moe.moe_apply(tp, torch.from_numpy(x), tc,
                                      tc.moe)) <= 2e-5


def test_combine_is_the_references_scatter_order_bit_for_bit():
    """In bf16, where the order of additions shows: the port's combine
    equals a sequential scatter-add of the gated outputs in the JAX
    package's order (per row, the pairs sorted stably by expert, each
    added into its token's row from zero), bit for bit, with drops."""
    _, tc = _cfgs(n_experts=4, top_k=2, capacity_factor=0.5)
    tc = dataclasses.replace(tc, dtype="bfloat16")
    gen = torch.Generator().manual_seed(7)
    p = t_moe.moe_init(gen, tc, tc.moe, torch.device("cpu"))
    x = torch.randn((2, 150, 64), generator=gen).to(torch.bfloat16)
    r = t_moe.moe_route(p, x, tc, tc.moe)
    assert not r["keep"].all()
    rows = r["slot"].max().item() + 1
    ye = torch.randn((rows - 1, 64), generator=gen).to(torch.bfloat16)
    got = t_moe.combine(ye, r)

    ye_sink = torch.cat([ye, torch.zeros((1, 64), dtype=torch.bfloat16)])
    want = torch.zeros_like(got)
    b, s, k = r["slot"].shape
    for i in range(b):
        flat_e = r["expert"][i].reshape(-1)
        order = torch.sort(flat_e, stable=True).indices
        for f in order.tolist():
            t, j = divmod(f, k)
            wgt = (r["gate"][i, t, j] * r["keep"][i, t, j]).to(torch.bfloat16)
            want[i, t] = want[i, t] + ye_sink[r["slot"][i, t, j]] * wgt
    assert torch.equal(got, want)


def _exact_experts(n_experts, s, seed, d=64, f=32):
    """Parameters and an input (numpy) whose routing and expert products
    are exact in bf16, so that both packages' experts give the same bits
    and only the combine rounds: integer tokens with a constant feature
    32 (column 0), which alone feeds the gate projection (silu(32) is 32
    in fp32: sigmoid(32) rounds to 1); a router of quarters that ignores
    it; up projections of -1, 0, 1; each down projection a partial
    permutation scaled by 1/8."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, size=(2, s, d)).astype(np.float32)
    x[..., 0] = 32.0
    router = (rng.integers(-2, 3, size=(d, n_experts)) / 4).astype(np.float32)
    router[0] = 0.0
    gate = np.zeros((n_experts, d, f), np.float32)
    gate[:, 0, :] = 1.0
    up = rng.integers(-1, 2, size=(n_experts, d, f)).astype(np.float32)
    up[:, 0, :] = 0.0
    down = np.zeros((n_experts, f, d), np.float32)
    for e in range(n_experts):
        down[e, np.arange(f), rng.permutation(d)[:f]] = 0.125
    return {"router": {"w": router}, "ew_gate": gate, "ew_up": up,
            "ew_down": down}, x


@pytest.mark.parametrize("n_experts,top_k,cf,s,seed", [
    (8, 4, 1.25, 70, 1), (16, 6, 1.25, 200, 2), (8, 4, 0.5, 150, 5)])
def test_moe_apply_bit_equal_to_jax_in_bf16(n_experts, top_k, cf, s, seed):
    """The JAX package's own bf16 ``moe_apply`` against the port's, bit
    for bit, on inputs where everything before the combine is exact
    (``_exact_experts``): the gated outputs ``ye * gate`` round the same
    in both, and the k of a token are then added from zero in bf16, one
    rounding per addition. Summing them in top-k order, or in fp32 with
    one rounding at the end, differs from the reference on a few per cent
    of these outputs (top_k 4 and 6: with 2 the order cannot show), so
    the reference's scatter on the host adds in ascending expert order,
    rounding each time, as the port does. The last case drops pairs."""
    jc, tc = _cfgs(n_experts=n_experts, top_k=top_k, capacity_factor=cf)
    jc = dataclasses.replace(jc, dtype="bfloat16")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    p, x = _exact_experts(n_experts, s, seed)
    want = jax.jit(lambda p, x: j_moe.moe_apply(p, x, jc, jc.moe))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x).astype(jnp.bfloat16))
    tp, xt = params_from_numpy(p, "cpu"), torch.from_numpy(x).bfloat16()
    got = t_moe.moe_apply(tp, xt, tc, tc.moe)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                          got.float().numpy())
    dropped = int((~t_moe.moe_route(tp, xt, tc, tc.moe)["keep"]).sum())
    assert (dropped > 100) == (cf < 1)


def test_moe_apply_repeats_itself_in_bf16():
    _, tc = _cfgs(n_shared=1)
    tc = dataclasses.replace(tc, dtype="bfloat16")
    gen = torch.Generator().manual_seed(8)
    p = t_moe.moe_init(gen, tc, tc.moe, torch.device("cpu"))
    x = torch.randn((2, 70, 64), generator=gen).to(torch.bfloat16)
    a = t_moe.moe_apply(p, x, tc, tc.moe)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, t_moe.moe_apply(p, x, tc, tc.moe))


@pytest.mark.parametrize("s,cf,want", [(1, 1.25, 2), (16, 1.25, 16),
                                       (200, 1.25, 125), (200, 0.5, 64),
                                       (4096, 1.25, 480)])
def test_capacity_matches_the_reference_formula(s, cf, want):
    """``moe.py:93``: max(int(s k cf / e), min(s, 64), k); deepseek's
    served prefill (s 4096, 64 experts, top-6, cf 1.25) gets 480 slots."""
    e, k = (64, 6) if s == 4096 else (4, 2)
    assert t_moe.capacity(s, MoEConfig(n_experts=e, top_k=k, d_ff_expert=8,
                                       capacity_factor=cf)) == want


def test_moe_init_layout_and_active_params_match_jax():
    jc, tc = _cfgs(n_shared=1)
    jp = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                      j_moe.moe_init(jax.random.key(0), jc, jc.moe))
    tp = t_moe.moe_init(torch.Generator().manual_seed(0), tc, tc.moe,
                        torch.device("cpu"))

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in t.items()}
    assert shapes(tp) == jp
    assert t_moe.moe_active_params(tc, tc.moe) == \
        j_moe.moe_active_params(jc, jc.moe)
