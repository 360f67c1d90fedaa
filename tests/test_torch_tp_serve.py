"""Serving under tensor parallelism over a gloo world of four ranks,
against the JAX package.

One world for the module (``tests/torch_dist_cases.py tps``, a
``FileStore`` in a temporary directory), laid out as a (fleet 2, model 2)
mesh, a (1, 4) mesh and a (4, 1) mesh: a model axis of 2, of 4 and of
one. The JAX side runs on one device in this process, on the same numpy
inputs. For the smoke configs of every served family (dense GQA:
qwen2.5-14b; local attention + RG-LRU: recurrentgemma-2b; RWKV-6:
rwkv6-7b; MLA + MoE: deepseek-v2-lite-16b; MoE + GQA:
phi3.5-moe-42b-a6.6b; the encoder-decoder: seamless-m4t-large-v2) and a
q head split (recurrentgemma-2b's smoke at 10 heads: two and a half heads
a rank at tp 4), at ``tp`` 2 and 4, held:

* the prefill's logits and three teacher-forced decode steps' logits,
  gathered whole, against the JAX package's one-device ``prefill`` /
  ``decode_step`` on the same converted parameters within 2e-4
  (``tests/test_torch_serve.py``'s bar), and within 1e-5 of the port's
  one device;
* the caches after the prefill and after the last step, gathered
  (``train.shardings.gather_caches``), within 1e-4 of the JAX package's,
  position tags exact;
* every rank's cache shard has the shape ``cache_layout`` gives
  (``shard_caches`` of the whole cache);
* greedy tokens of ``launch.serve.generate(tp=)`` equal to the JAX api
  loop's;
* a model axis of one (a group of one rank) bit-equal to one device,
  with the same kernel calls;
* the q head split's training loss and gathered gradients against
  ``jax.grad`` within 1e-5;
* import hygiene: neither ``jax`` nor ``repro`` in any rank's modules.
"""
import dataclasses
import os
import pickle
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

from repro.configs import get_config as r_get_config
from repro.configs import reduce_for_smoke as r_reduce
from repro.models import build as r_build

from test_torch_tp import _dump, _leaves, _np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
LOGITS_TOL = 2e-4        # tests/test_torch_serve.py's bar against JAX
ONE_TOL = 1e-5           # against the port's one device
CACHE_TOL = 1e-4
PROMPT, STEPS, GEN, BATCH = 40, 3, 4, 2
SPLIT = "recurrentgemma-10-heads"
CASES_OF = {arch: (arch, {}) for arch in (
    "qwen2.5-14b", "recurrentgemma-2b", "rwkv6-7b", "deepseek-v2-lite-16b",
    "phi3.5-moe-42b-a6.6b", "seamless-m4t-large-v2")} | {
    SPLIT: ("recurrentgemma-2b", {"n_heads": 10, "name": SPLIT})}


def _jcfg(arch, repl=None):
    return dataclasses.replace(r_reduce(r_get_config(arch)), **(repl or {}))


def _prompt(cfg, rng):
    """The prompt: 40 tokens (past the smoke window of 32: the ring buffer
    rolls), or for the encoder-decoder 20 source frames and 20 target
    tokens."""
    s = PROMPT // 2 if cfg.is_encdec else PROMPT
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, s))
           .astype(np.int64)}
    if cfg.is_encdec:
        out["src_embeds"] = rng.normal(size=(BATCH, s, cfg.d_model)) \
            .astype(np.float32)
    return out


def _inputs():
    rng = np.random.default_rng(33)
    models = {}
    for i, (key, (arch, repl)) in enumerate(CASES_OF.items()):
        cfg = _jcfg(arch, repl)
        prompt = _prompt(cfg, rng)
        models[key] = {
            "arch": arch, "replace": repl,
            "params": _np(r_build(cfg).init(jax.random.key(i))),
            "prompt": prompt,
            "steps": [rng.integers(0, cfg.vocab_size, (BATCH,))
                      .astype(np.int64) for _ in range(STEPS)],
            "max_len": prompt["tokens"].shape[1] + STEPS + GEN,
            "gen": GEN}
    split_batch = rng.integers(0, 512, (BATCH, 16)).astype(np.int32)
    return {"models": models, "split_key": SPLIT,
            "split_batch": split_batch}


def _jax_refs(inp):
    """Per config: the JAX side's teacher-forced logits and caches, its
    greedy tokens (the api loop), and the q head split's loss and
    gradients."""
    want = {}
    for key, case in inp["models"].items():
        cfg = _jcfg(case["arch"], case["replace"])
        api = r_build(cfg)
        params = case["params"]
        batch = {k: jnp.asarray(v, jnp.float32 if k == "src_embeds"
                                else jnp.int32)
                 for k, v in case["prompt"].items()}
        s = batch["tokens"].shape[1]
        prefill = jax.jit(lambda p, b: api.prefill(
            p, b, max_len=case["max_len"]))
        decode = jax.jit(api.decode_step)
        logits, cache = prefill(params, batch)
        got = {"logits": [np.asarray(logits)],
               "cache_prefill": _np(cache)}
        for i, tok in enumerate(case["steps"]):
            logits, cache = decode(params, jnp.asarray(tok, jnp.int32),
                                   cache, jnp.asarray(s + i))
            got["logits"].append(np.asarray(logits))
        got["cache_last"] = _np(cache)
        logits, cache = prefill(params, batch)
        tokens = [jnp.argmax(logits, -1).astype(jnp.int32)]
        for i in range(case["gen"] - 1):
            logits, cache = decode(params, tokens[-1], cache,
                                   jnp.asarray(s + i))
            tokens.append(jnp.argmax(logits, -1).astype(jnp.int32))
        got["greedy"] = np.asarray(jnp.stack(tokens, 1))
        want[key] = got
    case = inp["models"][SPLIT]
    cfg = _jcfg(case["arch"], case["replace"])
    loss, grads = jax.jit(jax.value_and_grad(r_build(cfg).loss))(
        case["params"], {"tokens": jnp.asarray(inp["split_batch"])})
    want["split_train"] = {"loss": float(loss), "grads": _np(grads)}
    return want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks start on the numpy inputs; the JAX references run here
    meanwhile."""
    root = tmp_path_factory.mktemp("tps4")
    inp = {"tps": _inputs()}
    _dump(inp, root / "inputs.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_cases.py"),
         "tps", str(r), str(WORLD), str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    want = _jax_refs(inp["tps"])
    for p in ranks:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    results = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return {"inputs": inp["tps"], "ranks": results, "want": want}


CASES = [(k, t) for k in CASES_OF for t in (2, 4)]


def _close(got, want, tol):
    for a, b in zip(_leaves(got), _leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.kind in "iu":
            assert np.array_equal(a, b)       # position tags
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("key,size", CASES)
def test_prefill_and_decode_logits_match_jax(world, key, size):
    want = world["want"][key]["logits"]
    for rank in world["ranks"]:
        got = rank["serve"][(key, size)]["logits"]
        assert len(got) == len(want) == 1 + STEPS
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=LOGITS_TOL)


@pytest.mark.parametrize("key,size", CASES)
def test_serving_matches_the_one_device_port(world, key, size):
    """The logits within 1e-5 of the port's own one-device serve, the
    gathered caches too (the summation orders differ over the ranks)."""
    for rank in world["ranks"]:
        got = rank["serve"][(key, size)]
        for a, b in zip(got["logits"], got["one"]["logits"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=ONE_TOL)
        for which in ("cache_prefill", "cache_last"):
            _close(got[which], got["one"][which], ONE_TOL)


@pytest.mark.parametrize("key,size", CASES)
def test_gathered_caches_match_jax(world, key, size):
    want = world["want"][key]
    for rank in world["ranks"]:
        got = rank["serve"][(key, size)]
        for which in ("cache_prefill", "cache_last"):
            assert len(_leaves(got[which])) == len(_leaves(want[which]))
            _close(got[which], want[which], CACHE_TOL)


@pytest.mark.parametrize("key,size", CASES)
def test_cache_shards_have_the_layout_shapes(world, key, size):
    """Every rank's cache shard has the shape ``cache_layout`` gives; the
    rank holds less than the whole where the layout splits a leaf."""
    for rank in world["ranks"]:
        got, want = rank["serve"][(key, size)]["shapes"]
        assert got == want
    one = [np.shape(x) for x in _leaves(
        world["ranks"][0]["serve"][(key, size)]["one"]["cache_prefill"])]
    split = [g != w for g, w in zip(
        world["ranks"][0]["serve"][(key, size)]["shapes"][0], one)]
    # MLA's latent cache stays whole; every other family splits a leaf
    assert any(split) == (key != "deepseek-v2-lite-16b")


@pytest.mark.parametrize("key,size", CASES)
def test_generate_greedy_tokens_match_the_jax_api_loop(world, key, size):
    want = world["want"][key]["greedy"]
    for rank in world["ranks"]:
        got = rank["generate"][(key, size)]
        assert got.shape == (BATCH, GEN)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("key", CASES_OF)
def test_axis_of_one_is_the_one_device_code(world, key):
    """A model axis of one (a real group of one rank): prefill and decode
    bit-equal to the one-device code's, the kernels' calls the same."""
    for rank in world["ranks"]:
        got = rank["axis_one"][key]
        assert got["group_size"] == 1
        assert got["bit_equal"]
        one, axis = got["calls"]
        assert one == axis
        assert any(one.values())


@pytest.mark.parametrize("size", [2, 4])
def test_q_head_split_trains_like_jax_grad(world, size):
    """recurrentgemma-2b's smoke at 10 heads: 5 whole heads a rank at tp
    2, the q head split at tp 4 (40 of 160 columns a rank): the loss and
    the gathered gradients within 1e-5 of ``jax.grad``."""
    want = world["want"]["split_train"]
    for rank in world["ranks"]:
        got = rank["split_train"][size]
        assert abs(got["loss"] - want["loss"]) <= ONE_TOL
        for a, b in zip(_leaves(got["grads"]), _leaves(want["grads"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=ONE_TOL)


def test_q_head_split_layout():
    """The rank's heads: whole heads where they divide, the q head split
    (every head on every rank, the output's columns the rank's block)
    where they do not, and the replicated layer where q_dim does not
    divide."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, tp

    rec = get_config("recurrentgemma-2b")
    lay = attention.head_layout(rec, tp.Model(None, 4, 1))
    assert lay == attention.Heads(0, 10, 0, 1, split=True)
    assert attention.head_layout(rec, tp.Model(None, 2, 1)) == \
        attention.Heads(5, 5, 0, 1)
    qwen = get_config("qwen2-vl-2b")            # 12 heads, 2 kv
    assert attention.head_layout(qwen, tp.Model(None, 4, 2)) == \
        attention.Heads(6, 3, 1, 1)
    assert attention.head_layout(qwen, tp.Model(None, 16, 3)).split
    odd = dataclasses.replace(rec, n_heads=3, head_dim=5)   # q_dim 15
    assert attention.attn_axis(odd, tp.Model(None, 4, 1)) is tp.ONE


def test_import_hygiene_on_every_rank(world):
    for rank in world["ranks"]:
        assert rank["modules"] == []
