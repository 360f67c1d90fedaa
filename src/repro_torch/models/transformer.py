"""Decoder-only LM assembly over heterogeneous layers.

The torch counterpart of ``repro.models.transformer`` for layer kinds
``global``, ``local``, ``rglru`` and ``rwkv``. Layers are grouped as
``prologue + repeats x pattern-unit + tail`` with the JAX layout:

* prologue = ``first_k_dense`` unrolled layers,
* the pattern unit's params carry a leading ``repeats`` axis (stacked),
* tail = remainder layers (recurrentgemma's 26 = 8x(R,R,A) + R,R).

The JAX package's ``lax.scan`` over the unit becomes a Python loop over
``repeats`` that indexes the stacked params and caches and restacks the
new caches in the same layout. Every layer is pre-norm residual:
x += mixer(norm1(x)); x += mlp(norm2(x)). RWKV layers use (time-mix,
channel-mix) as (mixer, mlp) and have no ``mlp`` of their own. Kinds
``mla`` and ``moe`` and cross-attention raise ``NotImplementedError``
naming the slice that ports them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention, rglru, rwkv6
from .layers import (cross_entropy, embed_init, mlp, mlp_init, norm,
                     norm_init, normal, torch_dtype)

PyTree = Any

__all__ = ["layer_kinds", "layer_groups", "check_supported", "init_params",
           "apply", "lm_loss", "init_cache", "prefill", "decode_step"]

_LATER = {
    "mla": "the mla/moe/encdec slice (ROADMAP Queue 1 item 3)",
    "moe": "the mla/moe/encdec slice (ROADMAP Queue 1 item 3)",
    "cross": "the mla/moe/encdec slice (ROADMAP Queue 1 item 3)",
}


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def layer_kinds(cfg: ModelConfig) -> list[str]:
    u = len(cfg.pattern)
    return [cfg.pattern[i % u] for i in range(cfg.n_layers)]


def layer_groups(cfg: ModelConfig) -> tuple[int, int, int]:
    """(prologue, repeats, tail) layer counts; prologue/tail are unrolled."""
    pro = cfg.first_k_dense
    u = len(cfg.pattern)
    rest = cfg.n_layers - pro
    return pro, rest // u, rest % u


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    missing = set()
    if cfg.is_encdec:
        missing.add("cross")
    if cfg.moe is not None:
        missing.add("moe")
    for kind in set(cfg.pattern):
        if kind == "global" and cfg.mla is not None:
            missing.add("mla")
        elif kind not in ("global", "local", "rglru", "rwkv"):
            missing.add(kind)
    if missing:
        kind = sorted(missing)[0]
        raise NotImplementedError(
            f"{cfg.name}: layer kind {kind!r} is not ported yet; it comes "
            f"with {_LATER.get(kind, 'a later slice')}")


def _tree_map(fn, tree):
    """``fn`` on every tensor of one layer's dict of params or caches."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_index(tree, i: int):
    return _tree_map(lambda t: t[i], tree)


def _tree_stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                device: torch.device) -> dict:
    p: dict = {"norm1": norm_init(cfg.d_model, cfg.norm, device,
                                  cfg.param_dtype),
               "norm2": norm_init(cfg.d_model, cfg.norm, device,
                                  cfg.param_dtype)}
    if kind in ("global", "local"):
        p["attn"] = attention.attn_init(gen, cfg, device)
    elif kind == "rglru":
        p["rec"] = rglru.rglru_init(gen, cfg, cfg.rglru, device)
    elif kind == "rwkv":
        p["rwkv"] = rwkv6.rwkv_init(gen, cfg, cfg.rwkv, device)
        return p  # rwkv owns both halves (time-mix + channel-mix)
    else:
        raise ValueError(kind)
    p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, device,
                        cfg.param_dtype)
    return p


def _apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                 positions: torch.Tensor, cache: Optional[dict] = None,
                 cache_index: Optional[int] = None, want_cache: bool = False
                 ) -> tuple[torch.Tensor, Optional[dict]]:
    dt = torch_dtype(cfg.dtype)
    new_cache: dict = {}
    if kind == "rwkv":
        st = cache.get("rwkv") if cache else None
        y, st_tm = rwkv6.rwkv_time_mix(
            p["rwkv"], norm(p["norm1"], x, cfg.norm), cfg, cfg.rwkv,
            state=st, return_state=want_cache)
        x = x + y
        y2, st_cm = rwkv6.rwkv_channel_mix(
            p["rwkv"], norm(p["norm2"], x, cfg.norm), cfg, cfg.rwkv,
            state=st, return_state=want_cache)
        x = x + y2
        if want_cache:
            new_cache["rwkv"] = {**st_tm, **st_cm}
        return x, (new_cache if want_cache else None)

    h = norm(p["norm1"], x, cfg.norm)
    if kind in ("global", "local"):
        y, attn_cache = attention.attn_apply(
            p["attn"], h, cfg, kind=kind, positions=positions,
            cache=cache.get("attn") if cache else None,
            cache_index=cache_index)
        if want_cache:
            new_cache["attn"] = attn_cache
    elif kind == "rglru":
        st = cache.get("rec") if cache else None
        y, st_new = rglru.rglru_apply(p["rec"], h, cfg, r=cfg.rglru, state=st,
                                      return_state=want_cache)
        if want_cache:
            new_cache["rec"] = st_new
    else:
        raise ValueError(kind)
    x = x + y
    h2 = norm(p["norm2"], x, cfg.norm)
    x = x + mlp(p["mlp"], h2, cfg.mlp_kind, dt)
    return x, (new_cache if want_cache else None)


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      dtype, device: torch.device) -> dict:
    if kind in ("global", "local"):
        return {"attn": attention.init_attn_cache(cfg, kind, batch, max_len,
                                                  dtype, device)}
    if kind == "rglru":
        return {"rec": rglru.init_rglru_state(cfg, cfg.rglru, batch, dtype,
                                              device)}
    if kind == "rwkv":
        return {"rwkv": rwkv6.init_rwkv_state(cfg, cfg.rwkv, batch, dtype,
                                              device)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Stack init / apply
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: str | torch.device = "cuda") -> PyTree:
    """Full parameter tree, drawn from ``gen`` on its device and placed on
    ``device``. The pattern unit's params carry a leading repeats axis."""
    dev = resolve_device(device)
    check_supported(cfg)
    pro, repeats, tail = layer_groups(cfg)
    kinds = layer_kinds(cfg)
    u = len(cfg.pattern)
    params: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dev,
                                        cfg.param_dtype)}
    params["prologue"] = [_init_layer(gen, cfg, kinds[i], dev)
                          for i in range(pro)]
    params["unit"] = [
        _tree_stack([_init_layer(gen, cfg, kinds[pro + j], dev)
                     for _ in range(repeats)])
        for j in range(u)] if repeats > 0 else []
    params["tail"] = [_init_layer(gen, cfg, kinds[pro + repeats * u + i], dev)
                      for i in range(tail)]
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, dev,
                                     cfg.param_dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal(gen, (cfg.d_model, cfg.vocab_size),
                                         dev, cfg.d_model**-0.5,
                                         cfg.param_dtype)}
    return params


def _embed(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
           patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    # the rows are gathered before the cast (bit-identical to the JAX
    # package's cast-then-gather, without casting the whole table)
    e = params["embed"]["embedding"][tokens].to(dt)
    # gemma-style scaling; the scale is rounded to the compute dtype first
    # (on the host: a product of two bf16 values is exact in the fp32 the
    # multiply computes in, so this equals the JAX package's bf16 * bf16)
    e = e * torch.tensor(cfg.d_model**0.5, dtype=dt).item()
    if patch_embeds is not None and cfg.frontend == "vision":
        npatch = patch_embeds.shape[1]
        e = torch.cat([patch_embeds.to(dt), e[:, npatch:]], dim=1)
    return e


def _logits(cfg: ModelConfig, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    x = norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].to(dt).T
    else:
        logits = x @ params["lm_head"]["w"].to(dt)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _run_stack(cfg: ModelConfig, params: PyTree, x: torch.Tensor, *,
               positions: torch.Tensor, caches: Optional[dict] = None,
               cache_index: Optional[int] = None, want_cache: bool = False
               ) -> tuple[torch.Tensor, Optional[dict]]:
    pro, repeats, tail = layer_groups(cfg)
    kinds = layer_kinds(cfg)
    u = len(cfg.pattern)
    new_caches: dict = {"prologue": [], "unit": None, "tail": []}

    def run_layer(p, x, kind, cache):
        return _apply_layer(p, x, cfg, kind, positions=positions, cache=cache,
                            cache_index=cache_index, want_cache=want_cache)

    for i, p in enumerate(params["prologue"]):
        cache = caches["prologue"][i] if caches else None
        x, nc = run_layer(p, x, kinds[i], cache)
        new_caches["prologue"].append(nc)

    if repeats > 0:
        unit_kinds = [kinds[pro + j] for j in range(u)]
        outs: list[list] = [[] for _ in range(u)]
        for rep in range(repeats):
            for j in range(u):
                cache_j = (_tree_index(caches["unit"][j], rep) if caches
                           else None)
                x, nc = run_layer(_tree_index(params["unit"][j], rep), x,
                                  unit_kinds[j], cache_j)
                outs[j].append(nc)
        if want_cache:
            new_caches["unit"] = [_tree_stack(o) for o in outs]

    for i, p in enumerate(params["tail"]):
        li = pro + repeats * u + i
        cache = caches["tail"][i] if caches else None
        x, nc = run_layer(p, x, kinds[li], cache)
        new_caches["tail"].append(nc)

    return x, (new_caches if want_cache else None)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def apply(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor, *,
          patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced forward: (B, S) tokens -> (B, S, V) logits."""
    x = _embed(cfg, params, tokens, patch_embeds)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _ = _run_stack(cfg, params, x, positions=positions)
    return _logits(cfg, params, x)


def lm_loss(cfg: ModelConfig, params: PyTree, batch: dict) -> torch.Tensor:
    """Next-token cross entropy on batch["tokens"] (B, S); forward only."""
    tokens = batch["tokens"]
    logits = apply(cfg, params, tokens, patch_embeds=batch.get("patch_embeds"))
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: str | torch.device = "cuda") -> dict:
    """Serving cache tree matching the stack layout."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
    pro, repeats, tail = layer_groups(cfg)
    kinds = layer_kinds(cfg)
    u = len(cfg.pattern)

    def one(kind):
        return _init_layer_cache(cfg, kind, batch, max_len, dtype, dev)

    return {
        "prologue": [one(kinds[i]) for i in range(pro)],
        "unit": [_tree_map(lambda l: l[None].expand(repeats, *l.shape).clone(),
                           one(kinds[pro + j])) for j in range(u)]
        if repeats else [],
        "tail": [one(kinds[pro + repeats * u + i]) for i in range(tail)],
    }


def prefill(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor, *,
            max_len: Optional[int] = None,
            patch_embeds: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt, returning (last-position logits (B, V), filled cache)."""
    b, s = tokens.shape
    max_len = max_len or s
    caches = init_cache(cfg, b, max_len, device=tokens.device)
    x = _embed(cfg, params, tokens, patch_embeds)
    positions = torch.arange(s, device=tokens.device)
    x, new_caches = _run_stack(cfg, params, x, positions=positions,
                               caches=caches, want_cache=True)
    logits = _logits(cfg, params, x[:, -1:])
    return logits[:, 0], new_caches


def decode_step(cfg: ModelConfig, params: PyTree, token: torch.Tensor,
                caches: dict, index: int) -> tuple[torch.Tensor, dict]:
    """One decode step: token (B,), index (int) -> (logits (B, V), caches)."""
    index = int(index)
    x = _embed(cfg, params, token[:, None])
    positions = torch.arange(index, index + 1, device=token.device)
    x, new_caches = _run_stack(cfg, params, x, positions=positions,
                               caches=caches, cache_index=index,
                               want_cache=True)
    logits = _logits(cfg, params, x)
    return logits[:, 0], new_caches
