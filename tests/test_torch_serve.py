"""The port's serving slice against the JAX package, on the CPU in fp32.

For each configuration, the same converted parameters and numpy inputs
go through both packages' ``apply``, ``prefill`` and three
``decode_step``s: logits within 2e-4 (tests/test_serve.py's bar), caches
within 1e-4, position tags exact. The configurations are
tests/test_serve.py's ``hybrid``, ``local``, ``dense`` and ``rwkv``, and
small ``mla``, ``moe`` (a dense first layer, then MoE layers with a shared
expert) and ``encdec`` (2 encoder and 2 decoder layers; seq source frames
and seq target tokens) configs, at seq 16 and 33 (the local window is 16,
so 33 rolls the ring buffer; 33 is a ragged multiple of rwkv's chunk),
and ``reduce_for_smoke`` of every arch at seq 40 (past the smoke window
of 32). Then the serving entry point (``launch.serve.generate``), its
greedy tokens against a loop over the JAX package's api, its cast-as-drawn
initialisation against casting the whole tree, and the port's import
hygiene and default device on this path.
"""
import dataclasses
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
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.configs import base as j_base
from repro.models import build as j_build
from repro.models import encdec as j_encdec
from repro.models import transformer as j_tf
from repro_torch.configs import ARCHS, base, get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import build, encdec, transformer

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=128, dtype="float32", param_dtype="float32")


_SUB = {"rglru": "RGLRUConfig", "rwkv": "RWKVConfig", "mla": "MLAConfig",
        "moe": "MoEConfig"}


def _pair(name, family, **kw):
    """The same configuration in both packages' dataclasses."""
    def make(mod):
        sub = {k: getattr(mod, cls)(**kw[k]) if k in kw else None
               for k, cls in _SUB.items()}
        rest = {k: v for k, v in kw.items() if k not in _SUB}
        return mod.ModelConfig(name=name, family=family,
                               **{**BASE, **rest}, **sub)
    return make(j_base), make(base)


SERVE_CFGS = {   # tests/test_serve.py:13-33
    "dense": _pair("d", "dense"),
    "local": _pair("l", "dense", pattern=("local", "global"), window=16),
    "hybrid": _pair("h", "hybrid", pattern=("rglru", "local"), window=16,
                    rglru=dict(d_rnn=64)),
    "rwkv": _pair("r", "ssm", pattern=("rwkv",),
                  rwkv=dict(head_size=16, decay_lora=8, d_ff=128)),
    "mla": _pair("m", "dense", n_kv_heads=4,
                 mla=dict(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                          v_head_dim=16)),
    "moe": _pair("e", "moe", first_k_dense=1, dense_d_ff=96,
                 moe=dict(n_experts=4, top_k=2, d_ff_expert=32, n_shared=1)),
    "encdec": _pair("s", "encdec", encoder_layers=2, n_kv_heads=4,
                    mlp_kind="gelu", norm="layernorm", frontend="audio"),
}
ARCH_CASES = sorted(ARCHS)
CASES = [(n, s) for n in sorted(SERVE_CFGS) for s in (16, 33)] + \
    [(a, 40) for a in ARCH_CASES]


def _cfgs(name):
    if name in SERVE_CFGS:
        return SERVE_CFGS[name]
    jc, tc = j_reduce(j_get_config(name)), reduce_for_smoke(get_config(name))
    return jc, tc


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _cache_errs(jcache, tcache):
    """(max |diff| over float leaves, position tags equal)."""
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jcache))[0]
    flat_t = jax.tree_util.tree_flatten_with_path(params_to_numpy(tcache))[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    err, tags = 0.0, True
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert a.shape == b.shape, path
        if "pos" in jax.tree_util.keystr(path):
            tags &= bool(np.array_equal(a, b))
        else:
            err = max(err, float(np.max(np.abs(a - b), initial=0.0)))
    return err, tags


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's run of each case (jit-compiled once per case),
    shared by the tests below."""
    out = {}

    def run(name, seq):
        key = (name, seq)
        if key not in out:
            jc, _ = _cfgs(name)
            api = j_build(jc)
            params = api.init(jax.random.key(1))
            tokens = jax.random.randint(jax.random.key(7), (2, seq + 3), 0,
                                        jc.vocab_size, jnp.int32)
            batch = {"tokens": tokens[:, :seq]}
            patches = src = None
            if jc.frontend == "vision":
                patches = jax.random.normal(jax.random.key(9),
                                            (2, jc.n_patches, jc.d_model))
                batch["patch_embeds"] = patches
            if jc.is_encdec:    # seq source frames, seq target tokens
                src = jax.random.normal(jax.random.key(9),
                                        (2, seq, jc.d_model))
                batch["src_embeds"] = src
                full = jax.jit(lambda p, s_, t: j_encdec.apply(
                    jc, p, s_, t))(params, src, tokens)
            else:
                full = jax.jit(lambda p, t, pe: j_tf.apply(
                    jc, p, t, patch_embeds=pe))(params, tokens, patches)
            logits, cache = jax.jit(lambda p, b: api.prefill(
                p, b, max_len=seq + 8))(params, batch)
            steps = [(logits, cache)]
            decode = jax.jit(api.decode_step)
            for i in range(3):
                logits, cache = decode(params, tokens[:, seq + i], cache,
                                       jnp.asarray(seq + i))
                steps.append((logits, cache))
            out[key] = {"params": jax.tree.map(np.asarray, params),
                        "tokens": np.asarray(tokens),
                        "patches": None if patches is None
                        else np.asarray(patches),
                        "src": None if src is None else np.asarray(src),
                        "full": np.asarray(full), "steps": steps}
        return out[key]
    return run


@pytest.mark.parametrize("name,seq", CASES)
def test_prefill_decode_and_apply_match_jax(jax_runs, name, seq):
    jc, tc = _cfgs(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    ref = jax_runs(name, seq)
    api = build(tc, "cpu")
    params = params_from_numpy(ref["params"], "cpu")
    tokens = torch.tensor(ref["tokens"], dtype=torch.long)
    patches = None if ref["patches"] is None \
        else torch.tensor(ref["patches"])
    batch = {"tokens": tokens[:, :seq]}
    if patches is not None:
        batch["patch_embeds"] = patches
    if tc.is_encdec:
        batch["src_embeds"] = torch.tensor(ref["src"])
        full = encdec.apply(tc, params, batch["src_embeds"], tokens)
    else:
        full = transformer.apply(tc, params, tokens, patch_embeds=patches)
    assert _err(full, ref["full"]) <= 2e-4
    logits, cache = api.prefill(params, batch, max_len=seq + 8)
    for i, (jlogits, jcache) in enumerate(ref["steps"]):
        if i:
            logits, cache = api.decode_step(params, tokens[:, seq + i - 1],
                                            cache, seq + i - 1)
        assert _err(logits, jlogits) <= 2e-4, f"step {i}"
        cerr, tags = _cache_errs(jcache, cache)
        assert cerr <= 1e-4 and tags, f"step {i}: cache {cerr}, tags {tags}"
    # the teacher-forcing property of tests/test_serve.py, port side
    assert _err(logits, full[:, seq + 2]) <= 2e-4


def test_lm_loss_matches_jax(jax_runs):
    ref = jax_runs("hybrid", 33)
    jc, tc = _cfgs("hybrid")
    tokens = ref["tokens"]
    want = j_tf.lm_loss(jc, jax.tree.map(jnp.asarray, ref["params"]),
                        {"tokens": jnp.asarray(tokens)})
    got = transformer.lm_loss(tc, params_from_numpy(ref["params"], "cpu"),
                              {"tokens": torch.tensor(tokens, dtype=torch.long)})
    assert abs(float(got) - float(want)) <= 1e-5


def test_encdec_loss_and_encode_match_jax(jax_runs):
    ref = jax_runs("encdec", 33)
    jc, tc = _cfgs("encdec")
    jp = jax.tree.map(jnp.asarray, ref["params"])
    tp = params_from_numpy(ref["params"], "cpu")
    src, tokens = ref["src"], ref["tokens"]
    want = j_encdec.encdec_loss(jc, jp, {"src_embeds": jnp.asarray(src),
                                         "tokens": jnp.asarray(tokens)})
    got = build(tc, "cpu").loss(tp, {
        "src_embeds": torch.tensor(src),
        "tokens": torch.tensor(tokens, dtype=torch.long)})
    assert abs(float(got) - float(want)) <= 1e-5
    enc_j = j_encdec.encode(jc, jp, jnp.asarray(src))
    enc_t = encdec.encode(tc, tp, torch.tensor(src))
    assert _err(enc_t, enc_j) <= 2e-4


def test_encdec_decode_passes_cross_kv_through_and_keeps_its_input(
        jax_runs):
    """A decode step hands the cross K/V on as the same tensors (the
    encoder's K/V never change after prefill: no copy a step), writes its
    token into a new copy of the self-attention caches, and leaves the
    caches it was given as they were; the step's logits and caches match
    the JAX package's (test_prefill_decode_and_apply_match_jax's bars)."""
    ref = jax_runs("encdec", 16)
    _, tc = _cfgs("encdec")
    tp = params_from_numpy(ref["params"], "cpu")
    tokens = torch.tensor(ref["tokens"], dtype=torch.long)
    _, caches = encdec.prefill(tc, tp, torch.tensor(ref["src"]),
                               tokens[:, :16], max_len=24)
    before = [t.clone() for _, t in _paths(caches)]
    logits, new = encdec.decode_step(tc, tp, tokens[:, 16], caches, 16)
    assert new["cross"]["k"] is caches["cross"]["k"]
    assert new["cross"]["v"] is caches["cross"]["v"]
    assert new["attn"]["k"].data_ptr() != caches["attn"]["k"].data_ptr()
    assert all(torch.equal(a, t) for a, (_, t) in zip(before,
                                                      _paths(caches)))
    assert not torch.equal(new["attn"]["k"][:, :, 16],
                           caches["attn"]["k"][:, :, 16])
    want_logits, want_cache = ref["steps"][1]
    assert _err(logits, want_logits) <= 2e-4
    cerr, tags = _cache_errs(want_cache, new)
    assert cerr <= 1e-4 and tags


def test_encdec_make_inputs_halves_the_shape():
    """A serving shape of S positions: S / 2 source frames of d_model in
    the compute dtype and S / 2 target tokens (the JAX package's map)."""
    _, tc = _cfgs("seamless-m4t-large-v2")
    shape = base.ShapeConfig("serve", 40, 3, "prefill")
    got = build(tc, "cpu").make_inputs(shape, torch.Generator().manual_seed(0))
    want = j_build(_cfgs("seamless-m4t-large-v2")[0]).make_inputs(
        shape, jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()} == \
        {"src_embeds": (3, 20, tc.d_model), "tokens": (3, 20)}
    assert got["src_embeds"].dtype == torch.float32
    assert int(got["tokens"].max()) < tc.vocab_size


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b",
                                  "deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "seamless-m4t-large-v2"])
def test_init_layout_matches_jax(arch):
    """The port's own init draws the JAX package's tree: same paths,
    shapes and dtypes, unit params stacked over repeats (an rwkv layer has
    no ``mlp``; a MoE layer a ``moe`` in its place, past deepseek's dense
    first layer; MLA's projections; the encoder-decoder's stacked encoder
    and decoder, the decoder's cross attention), and the cache of each
    layer kind (rwkv's shift and wkv state, not an RG-LRU state; MLA's
    compressed c_kv and k_rope; the decoder's self and cross K/V)."""
    jc, tc = _cfgs(arch)
    if jc.is_encdec:
        jparams = jax.eval_shape(lambda: j_encdec.init_params(
            jc, jax.random.key(0)))
        tparams = encdec.init_params(
            tc, torch.Generator().manual_seed(0), "cpu")
        jcache = jax.eval_shape(lambda: j_encdec.init_dec_cache(
            jc, 2, 40, 20))
        tcache = encdec.init_dec_cache(tc, 2, 40, 20, device="cpu")
    else:
        jparams = jax.eval_shape(lambda: j_tf.init_params(
            jc, jax.random.key(0)))
        tparams = transformer.init_params(
            tc, torch.Generator().manual_seed(0), "cpu")
        jcache = jax.eval_shape(lambda: j_tf.init_cache(jc, 2, 40))
        tcache = transformer.init_cache(tc, 2, 40, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        params_to_numpy(tparams))[0]
    assert [(p, tuple(a.shape), str(a.dtype)) for p, a in flat_j] == \
        [(p, a.shape, str(a.dtype)) for p, a in flat_t], arch
    assert [(p, tuple(a.shape), str(a.dtype)) for p, a in
            jax.tree_util.tree_flatten_with_path(jcache)[0]] == \
        [(p, a.shape, str(a.dtype)) for p, a in
         jax.tree_util.tree_flatten_with_path(
             params_to_numpy(tcache))[0]], arch


SERVED = ["recurrentgemma-2b", "rwkv6-7b", "deepseek-v2-lite-16b",
          "phi3.5-moe-42b-a6.6b", "seamless-m4t-large-v2"]


def _paths(tree, path=()):
    """(path, tensor) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v, path + (i,))]
    return [(path, tree)]


def _apply(cfg, params, seq=40):
    """Teacher-forced logits of a fixed batch (source frames and target
    tokens for the encoder-decoder)."""
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen)
    if cfg.is_encdec:
        src = torch.randn((2, seq, cfg.d_model), generator=gen)
        return encdec.apply(cfg, params, src, tokens)
    return transformer.apply(cfg, params, tokens)


@pytest.mark.parametrize("arch", SERVED)
def test_serving_params_cast_once_and_keep_fp32_leaves(arch):
    """Casting once is bit-identical to casting at each use; the leaves
    each use reads in fp32 (norms, rglru's lam, rwkv's decay LoRA, w0, u
    and group-norm scale) stay fp32. Every leaf is cast or kept: the cast
    tree has as many leaves as the JAX package's tree of the same config,
    more than 20 (phi3.5-moe's smoke tree, one MoE layer without shared
    experts, has 16)."""
    keep = {"scale", "bias", "lam", "w0", "w_lora_a", "w_lora_b", "u",
            "ln_scale"}
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="bfloat16")
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    cast = serve.serving_params(cfg, params)
    got = _paths(cast)
    n_jax = len(jax.tree.leaves(
        j_build(j_reduce(j_get_config(arch))).init(jax.random.key(0))))
    assert len(got) == len(_paths(params)) == n_jax
    assert n_jax > (15 if arch == "phi3.5-moe-42b-a6.6b" else 20)
    for path, leaf in got:     # a leaf's dict key is its path's last
        assert leaf.dtype == (torch.float32 if path[-1] in keep
                              else torch.bfloat16), (arch, path)
    a = _apply(cfg, params)
    assert torch.equal(a, _apply(cfg, cast)), arch   # bit-identical


@pytest.mark.parametrize("arch", SERVED)
def test_cast_as_drawn_init_is_bit_identical(arch):
    """``init_serving_params`` (each piece cast as it is drawn, stacked
    layers written into their stack one by one) gives
    ``serving_params(cfg, api.init(gen))`` bit for bit: the same paths,
    dtypes and values, and it leaves the generator where the whole-tree
    draw leaves it (the same draws in the same order). The paper-size
    param_dtype of phi3.5-moe (bf16 weights) is kept here."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="bfloat16",
                              param_dtype=get_config(arch).param_dtype)
    api = build(cfg, "cpu")
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want = _paths(serve.serving_params(cfg, api.init(g1)))
    got = _paths(serve.init_serving_params(api, g2))
    assert [p for p, _ in want] == [p for p, _ in got]
    assert any(t.dtype == torch.bfloat16 for _, t in got)
    for (path, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert torch.equal(torch.randn(4, generator=g1),
                       torch.randn(4, generator=g2))


def test_generate_on_cpu():
    cfg = reduce_for_smoke(get_config("recurrentgemma-2b"))
    out = serve.generate(cfg, batch=2, prompt_len=16, gen=4, device="cpu")
    assert out["tokens"].shape == (2, 4) and out["tok_per_s"] > 0
    assert out["logits"].shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(out["logits"]).all())
    again = serve.generate(cfg, batch=2, prompt_len=16, gen=4, device="cpu")
    assert torch.equal(out["tokens"], again["tokens"])
    sampled = serve.generate(cfg, batch=2, prompt_len=16, gen=4,
                             greedy=False, device="cpu")
    assert sampled["tokens"].shape == (2, 4)
    ticks = iter(range(100))
    timed = serve.generate(cfg, batch=2, prompt_len=16, gen=4, device="cpu",
                           clock=lambda: float(next(ticks)))
    assert timed["prefill_s"] == 1.0 and timed["decode_s"] == 1.0


def test_greedy_tokens_match_a_jax_decode_loop():
    """A greedy decode loop over the port's api gives the JAX api's tokens,
    from the same converted parameters and prompt."""
    jc, tc = _cfgs("recurrentgemma-2b")
    japi, tapi = j_build(jc), build(tc, "cpu")
    jparams = japi.init(jax.random.key(3))
    prompt = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 40))
    jlog, jcache = jax.jit(lambda p, b: japi.prefill(p, b, max_len=48))(
        jparams, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tlog, tcache = tapi.prefill(tparams,
                                {"tokens": torch.from_numpy(prompt)},
                                max_len=48)
    decode = jax.jit(japi.decode_step)
    jtok = [np.asarray(jnp.argmax(jlog, -1))]
    ttok = [torch.argmax(tlog, -1)]
    for i in range(6):
        jlog, jcache = decode(jparams, jnp.asarray(jtok[-1]), jcache,
                              jnp.asarray(40 + i))
        tlog, tcache = tapi.decode_step(tparams, ttok[-1], tcache, 40 + i)
        jtok.append(np.asarray(jnp.argmax(jlog, -1)))
        ttok.append(torch.argmax(tlog, -1))
    assert np.array_equal(np.stack(jtok, 1), torch.stack(ttok, 1).numpy())


def test_serve_main_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--smoke", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"]) == 0
    assert "tok/s" in capsys.readouterr().out


def test_serving_path_runs_without_jax_or_repro_loaded():
    code = (
        "import sys\n"
        "from repro_torch.configs import get_config, reduce_for_smoke\n"
        "from repro_torch.launch import serve\n"
        "for arch in ('recurrentgemma-2b', 'rwkv6-7b', "
        "'deepseek-v2-lite-16b', 'phi3.5-moe-42b-a6.6b', "
        "'seamless-m4t-large-v2'):\n"
        "    cfg = reduce_for_smoke(get_config(arch))\n"
        "    out = serve.generate(cfg, batch=2, prompt_len=40, gen=3, "
        "device='cpu')\n"
        "    assert tuple(out['tokens'].shape) == (2, 3), arch\n"
        "import numpy as np\n"
        "from repro_torch.sim import batch\n"
        "from repro_torch.models import cnn\n"
        "from repro_torch.core import dpsgd\n"
        "import torch\n"
        "p0 = dpsgd.replicate(cnn.cnn_init(torch.Generator().manual_seed(0),"
        " 'cpu'), 3)\n"
        "rng = np.random.default_rng(0)\n"
        "b = {'images': rng.normal(size=(2, 3, 4, 1, 28, 28))"
        ".astype(np.float32), 'labels': rng.integers(0, 10, (2, 3, 4))}\n"
        "final, losses = batch.train_on_trace(batch._cnn_loss, p0, "
        "np.stack([np.full((3, 3), 1 / 3)] * 2), np.ones((2, 3), bool), b)\n"
        "assert tuple(losses.shape) == (2, 3), losses.shape\n"
        "lm = batch.transformer_adapter('stablelm-3b', batch=2, seq_len=8, "
        "device='cpu')\n"
        "_, out = batch.train_model_on_traces(lm, ['static'], 1, "
        "device='cpu')\n"
        "assert np.isfinite(out['losses']).all(), out['losses']\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")


def test_serving_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("recurrentgemma-2b", "rwkv6-7b", "deepseek-v2-lite-16b",
                 "seamless-m4t-large-v2"):
        cfg = reduce_for_smoke(get_config(arch))
        for call in (lambda: serve.generate(cfg, batch=1, prompt_len=4,
                                            gen=2),
                     lambda: serve.main(["--arch", arch]),
                     lambda: transformer.init_params(cfg, torch.Generator()),
                     lambda: transformer.init_cache(cfg, 1, 8),
                     lambda: build(cfg).init(torch.Generator())):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])               # the default arch, rwkv6-7b


def test_serve_demo_twin_prints_the_jax_scripts_tokens(monkeypatch, capsys):
    """``repro_torch.examples.serve_demo`` on the JAX script's weights and
    prompts (its draws patched to them, converted) prints the JAX
    ``examples/serve_demo.py``'s greedy sample tokens, arch for arch."""
    import re
    import runpy

    from repro_torch.examples import serve_demo

    runpy.run_path(str(ROOT / "examples" / "serve_demo.py"))
    want = capsys.readouterr().out
    drawn = {}
    for arch in serve_demo.ARCHS:
        jc = j_reduce(j_get_config(arch))
        api, key = j_build(jc), jax.random.key(0)
        params = jax.jit(api.init)(key)
        inputs = api.make_inputs(j_base.ShapeConfig("serve", 32, 4,
                                                    "prefill"),
                                 key, batch_override=4)
        drawn[jc.name] = (jax.tree.map(np.asarray, params),
                          {k: torch.from_numpy(np.array(v))
                           for k, v in inputs.items()})
    real_build = serve.build

    def built(cfg, dev, model=None):
        api = real_build(cfg, dev, model=model)
        return dataclasses.replace(
            api, make_inputs=lambda *a, **kw: drawn[cfg.name][1])
    monkeypatch.setattr(serve, "build", built)
    monkeypatch.setattr(serve, "init_serving_params",
                        lambda api, gen, model: serve.serving_params(
                            api.cfg, params_from_numpy(
                                drawn[api.cfg.name][0], "cpu")))
    assert serve_demo.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def samples(text):
        return re.findall(r"^(\S+)\s.*sample tokens: (\[.*\])$", text,
                          flags=re.M)
    assert [a for a, _ in samples(got)] == list(serve_demo.ARCHS)
    assert samples(got) == samples(want)
