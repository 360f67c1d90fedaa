"""The port's model layers against the JAX package's, on the CPU in fp32.

Inputs are numpy from a seed; parameters are drawn by the JAX package and
carried across with ``convert.params_from_numpy`` (the two frameworks draw
different numbers from the same seed). Tolerances:

* layers (norm, mlp, rope, dense, cross_entropy): max |diff| <= 1e-6 of
  the reference's largest magnitude;
* attention layers (prefill and decode, output and cache; self, cross
  and MLA): 2e-5, the flash tolerance of tests/test_kernels.py; MLA's
  compressed cache (c_kv, k_rope: two projections, no attention) 1e-5;
* the RG-LRU layer (output and state): 1e-4, the rglru tolerance there;
* the RWKV-6 recurrence and time-mix (output and state): 1e-4, the
  recurrent layer's bar; channel-mix 1e-6 relative, an elementwise layer.
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

from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RGLRUConfig as JaxRGLRUConfig
from repro.configs.base import RWKVConfig as JaxRWKVConfig
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import mla as j_mla
from repro.models import rglru as j_rglru
from repro.models import rwkv6 as j_rwkv
from repro_torch.configs.base import (MLAConfig, ModelConfig, RGLRUConfig,
                                      RWKVConfig)
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import mla as t_mla
from repro_torch.models import rglru as t_rglru
from repro_torch.models import rwkv6 as t_rwkv

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=128, dtype="float32", param_dtype="float32")


def _cfgs(**kw):
    """The same configuration in both packages' dataclasses."""
    rg = kw.pop("rglru", None)
    rw = kw.pop("rwkv", None)
    ml = kw.pop("mla", None)
    jc = JaxModelConfig(name="t", family="dense", **{**BASE, **kw},
                        rglru=JaxRGLRUConfig(**rg) if rg else None,
                        rwkv=JaxRWKVConfig(**rw) if rw else None,
                        mla=JaxMLAConfig(**ml) if ml else None)
    tc = ModelConfig(name="t", family="dense", **{**BASE, **kw},
                     rglru=RGLRUConfig(**rg) if rg else None,
                     rwkv=RWKVConfig(**rw) if rw else None,
                     mla=MLAConfig(**ml) if ml else None)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _rel(a, b):
    return _err(a, b) / max(float(np.max(np.abs(_np(b)))), 1e-30)


def _tree_err(a, b):
    la = jax.tree.leaves(jax.tree.map(np.asarray, a))
    lb = jax.tree.leaves(params_to_numpy(b))
    assert len(la) == len(lb)
    return max(_err(x, y) for x, y in zip(la, lb))


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    rng = np.random.default_rng(1)
    p = {"scale": rng.normal(size=64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=64).astype(np.float32)
    jx, tx = _both(_x(2, 5, 64) * 3 + 1)
    got = t_layers.norm(params_from_numpy(p, "cpu"), tx, kind)
    want = j_layers.norm(jax.tree.map(jnp.asarray, p), jx, kind)
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-6


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp(kind):
    p = jax.tree.map(np.asarray, j_layers.mlp_init(jax.random.key(2), 64, 96,
                                                   kind))
    jx, tx = _both(_x(2, 7, 64, seed=3))
    got = t_layers.mlp(params_from_numpy(p, "cpu"), tx, kind, "float32")
    want = j_layers.mlp(jax.tree.map(jnp.asarray, p), jx, kind, jnp.float32)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope(fraction):
    jx, tx = _both(_x(2, 33, 4, 16, seed=4))
    pos = np.arange(33)
    got = t_layers.rope(tx, torch.from_numpy(pos), 1e4, fraction)
    want = j_layers.rope(jx, jnp.asarray(pos), 1e4, fraction)
    assert _rel(got, want) <= 1e-6


def test_dense_with_bias_and_init_layout():
    p = jax.tree.map(np.asarray, j_layers.dense_init(jax.random.key(5), 64,
                                                     48, bias=True))
    p["b"] = _x(48, seed=6)
    jx, tx = _both(_x(3, 64, seed=7))
    got = t_layers.dense(params_from_numpy(p, "cpu"), tx, "float32")
    want = j_layers.dense(jax.tree.map(jnp.asarray, p), jx, jnp.float32)
    assert _rel(got, want) <= 1e-6
    mine = t_layers.dense_init(torch.Generator().manual_seed(0), 64, 48,
                               torch.device("cpu"), bias=True)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: torch.Size(v.shape) for k, v in p.items()}


def test_cross_entropy():
    rng = np.random.default_rng(8)
    logits = _x(2, 9, 50, seed=8) * 4
    labels = rng.integers(0, 50, size=(2, 9))
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = t_layers.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        want = j_layers.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      None if m is None else jnp.asarray(m))
        assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,window", [(16, 16), (33, 16), (40, 0)])
def test_prefill_lowerings_match_jax(s, window):
    """The JAX package's two prefill lowerings, kept in plain torch, and
    the flash kernel's plain version against them."""
    q, k, v = _x(2, s, 4, 16, seed=9), _x(2, s, 2, 16, seed=10), \
        _x(2, s, 2, 16, seed=11)
    jq, tq = _both(q)
    jk, tk = _both(k)
    jv, tv = _both(v)
    from repro_torch.kernels import ops
    if window:
        want = j_attn.local_block_attention(jq, jk, jv, window=window)
        got = t_attn.local_block_attention(tq, tk, tv, window=window)
    else:
        want = j_attn.chunked_attention(jq, jk, jv, k_chunk=16)
        got = t_attn.chunked_attention(tq, tk, tv, k_chunk=16)
    assert _err(got, want) <= 2e-5
    flash = ops.flash_attention_gqa(tq, tk, tv, causal=True, window=window)
    assert _err(flash, want) <= 2e-5


@pytest.mark.parametrize("kind", ["local", "global"])
@pytest.mark.parametrize("s", [16, 33])
def test_attn_apply_prefill_then_decode(kind, s):
    jc, tc = _cfgs(window=16, qkv_bias=True)
    p = jax.tree.map(np.asarray, j_attn.attn_init(jax.random.key(12), jc))
    tp = params_from_numpy(p, "cpu")
    jp = jax.tree.map(jnp.asarray, p)
    jx, tx = _both(_x(2, s + 3, 64, seed=13))
    pos = np.arange(s)
    jcache = j_attn.init_attn_cache(jc, kind, 2, s + 8, jnp.float32)
    tcache = t_attn.init_attn_cache(tc, kind, 2, s + 8, torch.float32,
                                    torch.device("cpu"))
    assert _tree_err(jcache, tcache) == 0.0
    jy, jcache = j_attn.attn_apply(jp, jx[:, :s], jc, kind=kind,
                                   positions=jnp.asarray(pos), cache=jcache)
    ty, tcache = t_attn.attn_apply(tp, tx[:, :s], tc, kind=kind,
                                   positions=torch.from_numpy(pos),
                                   cache=tcache)
    assert _err(ty, jy) <= 2e-5 and _tree_err(jcache, tcache) <= 2e-5
    if kind == "local":
        assert np.array_equal(np.asarray(jcache["pos"]),
                              tcache["pos"].numpy())
    for i in range(3):
        idx = s + i
        jy, jcache = j_attn.attn_apply(
            jp, jx[:, idx:idx + 1], jc, kind=kind,
            positions=jnp.asarray([idx]), cache=jcache,
            cache_index=jnp.asarray(idx))
        ty, tcache = t_attn.attn_apply(
            tp, tx[:, idx:idx + 1], tc, kind=kind,
            positions=torch.tensor([idx]), cache=tcache, cache_index=idx)
        assert _err(ty, jy) <= 2e-5 and _tree_err(jcache, tcache) <= 2e-5


@pytest.mark.parametrize("s,t", [(16, 40), (33, 7), (5, 5)])
def test_attn_apply_cross_prefill_then_decode(s, t):
    """Cross attention: the prefill (flash, non-causal, T source frames
    against S target positions, no rotary) caches the encoder's K/V; each
    decode step reads them (plain torch)."""
    jc, tc = _cfgs(qkv_bias=True)
    p = jax.tree.map(np.asarray, j_attn.attn_init(jax.random.key(30), jc,
                                                  cross=True))
    tp = params_from_numpy(p, "cpu")
    jp = jax.tree.map(jnp.asarray, p)
    jx, tx = _both(_x(2, s + 3, 64, seed=31))
    jsrc, tsrc = _both(_x(2, t, 64, seed=32))
    shape = (2, t, jc.n_kv_heads, jc.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    pos = np.arange(s)
    jy, jcache = j_attn.attn_apply(jp, jx[:, :s], jc, kind="cross",
                                   positions=jnp.asarray(pos), cache=jcache,
                                   kv_src=jsrc)
    ty, tcache = t_attn.attn_apply(tp, tx[:, :s], tc, kind="cross",
                                   positions=torch.from_numpy(pos),
                                   cache=tcache, kv_src=tsrc)
    assert _err(ty, jy) <= 2e-5 and _tree_err(jcache, tcache) <= 2e-5
    # without a cache (apply): the same output, no cache back
    ty2, none = t_attn.attn_apply(tp, tx[:, :s], tc, kind="cross",
                                  positions=torch.from_numpy(pos),
                                  kv_src=tsrc)
    assert none is None and torch.equal(ty2, ty)
    for i in range(3):
        idx = s + i
        jy, jcache = j_attn.attn_apply(
            jp, jx[:, idx:idx + 1], jc, kind="cross",
            positions=jnp.asarray([idx]), cache=jcache,
            cache_index=jnp.asarray(idx))
        ty, tcache = t_attn.attn_apply(
            tp, tx[:, idx:idx + 1], tc, kind="cross",
            positions=torch.tensor([idx]), cache=tcache, cache_index=idx)
        assert _err(ty, jy) <= 2e-5 and _tree_err(jcache, tcache) <= 2e-5


@pytest.mark.parametrize("s", [16, 33])
def test_attn_apply_encoder_mode_is_bidirectional(s):
    """``causal_override=False`` (the encoder): every position sees every
    other, as the JAX package's encoder layers do."""
    jc, tc = _cfgs()
    p = jax.tree.map(np.asarray, j_attn.attn_init(jax.random.key(33), jc))
    jx, tx = _both(_x(2, s, 64, seed=34))
    pos = np.arange(s)
    jy, _ = j_attn.attn_apply(jax.tree.map(jnp.asarray, p), jx, jc,
                              kind="global", positions=jnp.asarray(pos),
                              causal_override=False)
    ty, _ = t_attn.attn_apply(params_from_numpy(p, "cpu"), tx, tc,
                              kind="global", positions=torch.from_numpy(pos),
                              causal_override=False)
    causal, _ = t_attn.attn_apply(params_from_numpy(p, "cpu"), tx, tc,
                                  kind="global",
                                  positions=torch.from_numpy(pos))
    assert _err(ty, jy) <= 2e-5 and _err(causal, jy) > 1e-2


@pytest.mark.parametrize("s,t,dv,causal", [(40, 40, 16, True),
                                           (33, 33, 8, True),
                                           (16, 40, 24, False),
                                           (40, 7, 16, False)])
def test_flash_with_narrower_v_matches_chunked_attention(s, t, dv, causal):
    """``ops.flash_attention_gqa`` with v narrower than q and k (MLA's
    layout; v zero-padded to q's width inside ``ops``) and with T != S
    (cross attention) against the JAX package's ``chunked_attention``,
    which takes Dv != Dqk natively. The scale stays q's D ** -0.5."""
    from repro_torch.kernels import ops
    q, k, v = _x(2, s, 4, 24, seed=35), _x(2, t, 4, 24, seed=36), \
        _x(2, t, 4, dv, seed=37)
    jq, tq = _both(q)
    jk, tk = _both(k)
    jv, tv = _both(v)
    want = j_attn.chunked_attention(jq, jk, jv, causal=causal, k_chunk=16)
    pos = torch.arange(s) if causal else None
    got = ops.flash_attention_gqa(tq, tk, tv, causal=causal, positions=pos)
    assert got.shape == (2, s, 4, dv) and _err(got, want) <= 2e-5
    with pytest.raises(ValueError, match="exceeds"):
        ops.flash_attention_gqa(tq[..., :8], tk[..., :8], tk)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA = dict(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


@pytest.mark.parametrize("s", [16, 33])
def test_mla_apply_prefill_then_decode(s):
    """Prefill (full heads through the flash kernel, v narrower than q and
    k) and three decode steps (the absorbed low-rank form against the
    compressed cache) against the JAX package."""
    jc, tc = _cfgs(mla=MLA)
    p = jax.tree.map(np.asarray, j_mla.mla_init(jax.random.key(40), jc,
                                                jc.mla))
    tp = params_from_numpy(p, "cpu")
    jp = jax.tree.map(jnp.asarray, p)
    jx, tx = _both(_x(2, s + 3, 64, seed=41))
    jcache = j_mla.init_mla_cache(jc, jc.mla, 2, s + 8, jnp.float32)
    tcache = t_mla.init_mla_cache(tc, tc.mla, 2, s + 8, torch.float32,
                                  torch.device("cpu"))
    assert _tree_err(jcache, tcache) == 0.0
    pos = np.arange(s)
    jy, jcache = j_mla.mla_apply(jp, jx[:, :s], jc, m=jc.mla,
                                 positions=jnp.asarray(pos), cache=jcache)
    ty, tcache = t_mla.mla_apply(tp, tx[:, :s], tc, m=tc.mla,
                                 positions=torch.from_numpy(pos),
                                 cache=tcache)
    assert _err(ty, jy) <= 2e-5 and _tree_err(jcache, tcache) <= 1e-5
    for i in range(3):
        idx = s + i
        jy, jcache = j_mla.mla_apply(
            jp, jx[:, idx:idx + 1], jc, m=jc.mla,
            positions=jnp.asarray([idx]), cache=jcache,
            cache_index=jnp.asarray(idx))
        ty, tcache = t_mla.mla_apply(
            tp, tx[:, idx:idx + 1], tc, m=tc.mla,
            positions=torch.tensor([idx]), cache=tcache, cache_index=idx)
        assert _err(ty, jy) <= 2e-5 and _tree_err(jcache, tcache) <= 1e-5
    # without a cache: the same prefill output, no cache back
    ty2, none = t_mla.mla_apply(tp, tx[:, :s], tc, m=tc.mla,
                                positions=torch.from_numpy(pos))
    assert none is None and _err(ty2, j_mla.mla_apply(
        jp, jx[:, :s], jc, m=jc.mla, positions=jnp.asarray(pos))[0]) <= 2e-5


def test_mla_init_layout_matches_jax():
    jc, tc = _cfgs(mla=MLA)
    jp = j_mla.mla_init(jax.random.key(0), jc, jc.mla)
    tp = t_mla.mla_init(torch.Generator().manual_seed(0), tc, tc.mla,
                        torch.device("cpu"))
    assert {k: tuple(v["w"].shape) for k, v in tp.items()} == \
        {k: tuple(v["w"].shape) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# RG-LRU layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 16, 33])
def test_rglru_apply_with_and_without_state(s):
    jc, tc = _cfgs(rglru=dict(d_rnn=48, conv_width=4))
    p = jax.tree.map(np.asarray, j_rglru.rglru_init(jax.random.key(14), jc,
                                                    jc.rglru))
    tp = params_from_numpy(p, "cpu")
    jp = jax.tree.map(jnp.asarray, p)
    jx, tx = _both(_x(2, s, 64, seed=15))
    jy, jst = j_rglru.rglru_apply(jp, jx, jc, r=jc.rglru, return_state=True)
    ty, tst = t_rglru.rglru_apply(tp, tx, tc, r=tc.rglru, return_state=True)
    assert _err(ty, jy) <= 1e-4 and _tree_err(jst, tst) <= 1e-4
    jx2, tx2 = _both(_x(2, 3, 64, seed=16))
    jy, jst = j_rglru.rglru_apply(jp, jx2, jc, r=jc.rglru, state=jst,
                                  return_state=True)
    ty, tst = t_rglru.rglru_apply(tp, tx2, tc, r=tc.rglru, state=tst,
                                  return_state=True)
    assert _err(ty, jy) <= 1e-4 and _tree_err(jst, tst) <= 1e-4
    assert tst["h"].dtype == torch.float32


def test_rglru_init_layout_matches_jax():
    jc, tc = _cfgs(rglru=dict(d_rnn=48))
    jp = j_rglru.rglru_init(jax.random.key(0), jc, jc.rglru)
    tp = t_rglru.rglru_init(torch.Generator().manual_seed(0), tc, tc.rglru,
                            torch.device("cpu"))
    shapes = lambda t: {k: (tuple(v.shape) if not isinstance(v, dict) else  # noqa: E731
                            shapes(v)) for k, v in t.items()}
    assert shapes(tp) == shapes(jp)
    lam = tp["lam"].numpy()
    assert lam.min() >= 1.0 and lam.max() <= 5.0


# ---------------------------------------------------------------------------
# RWKV-6 layer
# ---------------------------------------------------------------------------

RWKV = dict(head_size=16, decay_lora=8, d_ff=96)


def _rwkv_params(seed):
    jc, tc = _cfgs(rwkv=RWKV)
    p = jax.tree.map(np.asarray, j_rwkv.rwkv_init(jax.random.key(seed), jc,
                                                  jc.rwkv))
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")


@pytest.mark.parametrize("s", [1, 16, 33])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_chunked_and_step_match_jax(s, with_state):
    """The port's wkv_chunked (the kernel's plain version on the CPU) and
    the exact one-token step against the JAX model's."""
    rng = np.random.default_rng(s)
    r, k, v = (rng.normal(size=(2, s, 4, 16)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(2, s, 4, 16)) + 0.5)).astype(
        np.float32)
    u = (rng.normal(size=(4, 16)) * 0.1).astype(np.float32)
    s0 = rng.normal(size=(2, 4, 16, 16)).astype(np.float32) \
        if with_state else None
    j = [jnp.asarray(x) for x in (r, k, v, w, u)]
    t = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    jy, jst = j_rwkv.wkv_chunked(*j, js0)
    ty, tst = t_rwkv.wkv_chunked(*t, ts0)
    assert _err(ty, jy) <= 1e-4 and _err(tst, jst) <= 1e-4
    assert tst.dtype == torch.float32
    st0 = np.zeros((2, 4, 16, 16), np.float32) if s0 is None else s0
    jst, jy = j_rwkv.wkv_step(jnp.asarray(st0), *(x[:, 0] for x in j[:4]),
                              j[4])
    tst, ty = t_rwkv.wkv_step(torch.from_numpy(st0),
                              *(x[:, 0] for x in t[:4]), t[4])
    assert _err(ty, jy) <= 1e-4 and _err(tst, jst) <= 1e-4


@pytest.mark.parametrize("s", [1, 16, 33])
def test_rwkv_time_mix_with_and_without_state(s):
    """Without state (teacher forcing), from the zero state with the new
    state returned (prefill; S = 1 takes the one-token step), then three
    tokens on from it."""
    jc, tc, jp, tp = _rwkv_params(17)
    jx, tx = _both(_x(2, s, 64, seed=18))
    jy, _ = j_rwkv.rwkv_time_mix(jp, jx, jc, jc.rwkv)
    ty, tst = t_rwkv.rwkv_time_mix(tp, tx, tc, tc.rwkv)
    assert _err(ty, jy) <= 1e-4 and tst is None
    jst = j_rwkv.init_rwkv_state(jc, jc.rwkv, 2, jnp.float32)
    tst = t_rwkv.init_rwkv_state(tc, tc.rwkv, 2, torch.float32,
                                 torch.device("cpu"))
    assert _tree_err(jst, tst) == 0.0
    jy, jst = j_rwkv.rwkv_time_mix(jp, jx, jc, jc.rwkv, state=jst,
                                   return_state=True)
    ty, tst = t_rwkv.rwkv_time_mix(tp, tx, tc, tc.rwkv, state=tst,
                                   return_state=True)
    assert _err(ty, jy) <= 1e-4 and _tree_err(jst, tst) <= 1e-4
    for i in range(3):
        jx1, tx1 = _both(_x(2, 1, 64, seed=19 + i))
        jy, jst = j_rwkv.rwkv_time_mix(jp, jx1, jc, jc.rwkv, state=jst,
                                       return_state=True)
        ty, tst = t_rwkv.rwkv_time_mix(tp, tx1, tc, tc.rwkv, state=tst,
                                       return_state=True)
        assert _err(ty, jy) <= 1e-4 and _tree_err(jst, tst) <= 1e-4
    assert tst["wkv"].dtype == torch.float32


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_channel_mix(with_state):
    jc, tc, jp, tp = _rwkv_params(22)
    jx, tx = _both(_x(2, 9, 64, seed=23))
    prev = _x(2, 64, seed=24)
    jst = {"shift_cm": jnp.asarray(prev)} if with_state else None
    tst = {"shift_cm": torch.from_numpy(prev)} if with_state else None
    jy, jnew = j_rwkv.rwkv_channel_mix(jp, jx, jc, jc.rwkv, state=jst,
                                       return_state=True)
    ty, tnew = t_rwkv.rwkv_channel_mix(tp, tx, tc, tc.rwkv, state=tst,
                                       return_state=True)
    assert _rel(ty, jy) <= 1e-6
    assert _err(tnew["shift_cm"], jnew["shift_cm"]) == 0.0


def test_rwkv_init_layout_matches_jax():
    jc, tc = _cfgs(rwkv=RWKV)
    jp = j_rwkv.rwkv_init(jax.random.key(0), jc, jc.rwkv)
    tp = t_rwkv.rwkv_init(torch.Generator().manual_seed(0), tc, tc.rwkv,
                          torch.device("cpu"))
    shapes = lambda t: {k: (tuple(v.shape) if not isinstance(v, dict) else  # noqa: E731
                            shapes(v)) for k, v in t.items()}
    assert shapes(tp) == shapes(jp)
    w0 = tp["w0"].numpy()
    assert w0.min() >= 0.5 and w0.max() <= 2.0
