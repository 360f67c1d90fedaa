"""The port's serving slice against the JAX package, on the CPU in fp32.

For each decoder-only configuration whose layer kinds the port has, the
same converted parameters and numpy tokens go through both packages'
``apply``, ``prefill`` and three ``decode_step``s: logits within 2e-4
(tests/test_serve.py's bar), caches within 1e-4, position tags exact. The
configurations are tests/test_serve.py's ``hybrid``, ``local``,
``dense`` and ``rwkv`` at seq 16 and 33 (the local window is 16, so 33
rolls the ring buffer; 33 is a ragged multiple of rwkv's chunk), and
``reduce_for_smoke`` of every arch of the port's kinds at seq 40 (past the
smoke window of 32). The other archs must refuse to
build. Then the serving entry point (``launch.serve.generate``), its
greedy tokens against a loop over the JAX package's api, and the port's
import hygiene and default device on this path.
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

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import RGLRUConfig as JaxRGLRUConfig
from repro.configs.base import RWKVConfig as JaxRWKVConfig
from repro.models import build as j_build
from repro.models import transformer as j_tf
from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.configs.base import ModelConfig, RGLRUConfig, RWKVConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import build, transformer

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=128, dtype="float32", param_dtype="float32")


def _pair(name, family, **kw):
    rg = kw.pop("rglru", None)
    rw = kw.pop("rwkv", None)
    return (JaxModelConfig(name=name, family=family, **BASE, **kw,
                           rglru=JaxRGLRUConfig(**rg) if rg else None,
                           rwkv=JaxRWKVConfig(**rw) if rw else None),
            ModelConfig(name=name, family=family, **BASE, **kw,
                        rglru=RGLRUConfig(**rg) if rg else None,
                        rwkv=RWKVConfig(**rw) if rw else None))


SERVE_CFGS = {   # tests/test_serve.py:13-33
    "dense": _pair("d", "dense"),
    "local": _pair("l", "dense", pattern=("local", "global"), window=16),
    "hybrid": _pair("h", "hybrid", pattern=("rglru", "local"), window=16,
                    rglru=dict(d_rnn=64)),
    "rwkv": _pair("r", "ssm", pattern=("rwkv",),
                  rwkv=dict(head_size=16, decay_lora=8, d_ff=128)),
}
PORTED_ARCHS = ["recurrentgemma-2b", "gemma3-12b", "nemotron-4-15b",
                "qwen2.5-14b", "qwen2-vl-2b", "rwkv6-7b", "stablelm-3b"]
REFUSED_ARCHS = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b",
                 "seamless-m4t-large-v2"]
CASES = [(n, s) for n in sorted(SERVE_CFGS) for s in (16, 33)] + \
    [(a, 40) for a in PORTED_ARCHS]


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
            patches = None
            if jc.frontend == "vision":
                patches = jax.random.normal(jax.random.key(9),
                                            (2, jc.n_patches, jc.d_model))
                batch["patch_embeds"] = patches
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
    full = transformer.apply(tc, params, tokens, patch_embeds=patches)
    assert _err(full, ref["full"]) <= 2e-4
    batch = {"tokens": tokens[:, :seq]}
    if patches is not None:
        batch["patch_embeds"] = patches
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


def test_init_layout_matches_jax():
    """The port's own init draws the JAX package's tree: same paths,
    shapes and dtypes, unit params stacked over repeats (an rwkv layer has
    no ``mlp``), and the cache of each layer kind (rwkv's shift and wkv
    state, not an RG-LRU state)."""
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        jc, tc = _cfgs(arch)
        jparams = jax.eval_shape(lambda: j_tf.init_params(
            jc, jax.random.key(0)))
        tparams = transformer.init_params(
            tc, torch.Generator().manual_seed(0), "cpu")
        flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(
            params_to_numpy(tparams))[0]
        assert [(p, tuple(a.shape), str(a.dtype)) for p, a in flat_j] == \
            [(p, a.shape, str(a.dtype)) for p, a in flat_t], arch
        jcache = jax.eval_shape(lambda: j_tf.init_cache(jc, 2, 40))
        tcache = transformer.init_cache(tc, 2, 40, device="cpu")
        assert [(p, tuple(a.shape), str(a.dtype)) for p, a in
                jax.tree_util.tree_flatten_with_path(jcache)[0]] == \
            [(p, a.shape, str(a.dtype)) for p, a in
             jax.tree_util.tree_flatten_with_path(
                 params_to_numpy(tcache))[0]], arch


@pytest.mark.parametrize("arch", REFUSED_ARCHS)
def test_unported_archs_refuse_to_build(arch):
    assert arch in ARCHS
    cfg = reduce_for_smoke(get_config(arch))
    with pytest.raises(NotImplementedError, match="not ported"):
        build(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_params(cfg, torch.Generator(), "cpu")


def test_serving_params_cast_once_and_keep_fp32_leaves():
    """Casting once is bit-identical to casting at each use; the leaves
    each use reads in fp32 (norms, rglru's lam, rwkv's decay LoRA, w0, u
    and group-norm scale) stay fp32."""
    keep = {"scale", "bias", "lam", "w0", "w_lora_a", "w_lora_b", "u",
            "ln_scale"}
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                  dtype="bfloat16")
        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu")
        cast = serve.serving_params(cfg, params)

        def leaves(tree, key=None):
            if isinstance(tree, dict):
                return [x for k, v in tree.items() for x in leaves(v, k)]
            if isinstance(tree, list):
                return [x for v in tree for x in leaves(v, key)]
            return [(key, tree)]
        got = leaves(cast)
        assert len(got) == len(leaves(params)) > 20
        for key, leaf in got:
            assert leaf.dtype == (torch.float32 if key in keep
                                  else torch.bfloat16), (arch, key)
        tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                               generator=torch.Generator().manual_seed(1))
        a = transformer.apply(cfg, params, tokens)
        b = transformer.apply(cfg, cast, tokens)
        assert torch.equal(a, b), arch   # casting once is bit-identical


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
        "for arch in ('recurrentgemma-2b', 'rwkv6-7b'):\n"
        "    cfg = reduce_for_smoke(get_config(arch))\n"
        "    out = serve.generate(cfg, batch=2, prompt_len=40, gen=3, "
        "device='cpu')\n"
        "    assert tuple(out['tokens'].shape) == (2, 3), arch\n"
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
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
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
