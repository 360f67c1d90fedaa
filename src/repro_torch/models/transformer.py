"""Decoder-only LM assembly over heterogeneous layers.

The torch counterpart of ``repro.models.transformer``: layer kinds
``global`` (``mla`` where the config has MLA), ``local``, ``rglru`` and
``rwkv``, a MoE MLP at and past ``first_k_dense`` where the config has
MoE, and cross attention in the encoder-decoder's decoder layers
(``models.encdec``). Layers are grouped as
``prologue + repeats x pattern-unit + tail`` with the JAX layout:

* prologue = ``first_k_dense`` unrolled layers,
* the pattern unit's params carry a leading ``repeats`` axis (stacked),
* tail = remainder layers (recurrentgemma's 26 = 8x(R,R,A) + R,R).

The JAX package's ``lax.scan`` over the unit becomes a Python loop over
``repeats`` over the stacked params unbound once (their gradient is one
stack; a slice taken a layer would cost a stack-sized gradient a layer)
and the caches indexed, restacking the new caches in the same layout. Every layer is pre-norm residual:
x += mixer(norm1(x)); [x += cross(norm_cross(x))]; x += mlp(norm2(x)).
RWKV layers use (time-mix, channel-mix) as (mixer, mlp) and have no
``mlp`` of their own.

``init_params`` takes an optional ``cast``, applied to each piece of the
tree (the embedding, each layer, the final norm, the head) as soon as it
is drawn, and stacked layers are written into their stack one by one: a
served model never holds its fp32 tree beside the cast one
(``launch.serve.init_serving_params``).

Tensor parallelism (``model``, a ``models.tp.Model``; ``tp.current()``
when none is given) runs every family's teacher-forced forward on the
rank's shards of the ``train.shardings.param_specs`` layout: attention
and MLA on the rank's heads, the MLPs column / row parallel, the MoE
experts over the ranks, the RG-LRU on the rank's channels, RWKV-6 on its
heads and channels, the embedding and the head vocab-parallel
(``lm_loss``'s cross entropy over the vocab's blocks, ``apply`` returning
the rank's block of the logits). What still waits raises naming ROADMAP
Queue 1 item 9 (``check_tp``: a q head split over ranks; the caches of
prefill and decode); an axis of one runs the one-device code.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention, mla, moe, remat, rglru, rwkv6, tp
from .layers import (cross_entropy, embed_init, embed_rows, mlp, mlp_init,
                     norm, norm_init, normal, rounded_to, torch_dtype,
                     vocab_cross_entropy)

PyTree = Any

__all__ = ["layer_kinds", "layer_groups", "init_params", "apply",
           "lm_loss", "init_cache", "prefill", "decode_step", "check_tp",
           "tp_runs_eager"]


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


def _mixer_kind(cfg: ModelConfig, kind: str) -> str:
    """Archs with MLA swap 'global' attention for MLA."""
    if kind == "global" and cfg.mla is not None:
        return "mla"
    return kind


def _moe_flag(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.moe is not None and layer_idx >= cfg.first_k_dense


def _tree_map(fn, tree):
    """``fn`` on every tensor of one layer's dict of params or caches."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_index(tree, i: int):
    return _tree_map(lambda t: t[i], tree)


def _tree_unbind(tree, n: int) -> list:
    """The ``n`` trees along the leading axis of every leaf, by one
    ``unbind`` a leaf: its gradient is one stack of the slices' gradients,
    where indexing each slice would add a stack-sized tensor a slice
    (quadratic in the depth)."""
    if isinstance(tree, dict):
        parts = {k: _tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_tree_unbind(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    return list(torch.unbind(tree, 0))


def _tree_stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def stack_drawn(n: int, draw: Callable[[], dict]) -> dict:
    """``_tree_stack([draw() for _ in range(n)])``, with each draw written
    into its slot of the stack as it comes: the peak is the stack and one
    layer, not the stack and every layer."""
    first = draw()
    out = _tree_map(lambda t: t.new_empty((n, *t.shape)), first)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, draw(), i)
    return out


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                is_moe: bool, device: torch.device,
                cross: bool = False) -> dict:
    kind = _mixer_kind(cfg, kind)
    p: dict = {"norm1": norm_init(cfg.d_model, cfg.norm, device,
                                  cfg.param_dtype),
               "norm2": norm_init(cfg.d_model, cfg.norm, device,
                                  cfg.param_dtype)}
    if kind in ("global", "local"):
        p["attn"] = attention.attn_init(gen, cfg, device)
    elif kind == "mla":
        p["attn"] = mla.mla_init(gen, cfg, cfg.mla, device)
    elif kind == "rglru":
        p["rec"] = rglru.rglru_init(gen, cfg, cfg.rglru, device)
    elif kind == "rwkv":
        p["rwkv"] = rwkv6.rwkv_init(gen, cfg, cfg.rwkv, device)
        return p  # rwkv owns both halves (time-mix + channel-mix)
    else:
        raise ValueError(kind)
    if cross:
        p["norm_cross"] = norm_init(cfg.d_model, cfg.norm, device,
                                    cfg.param_dtype)
        p["cross"] = attention.attn_init(gen, cfg, device)
    if is_moe:
        p["moe"] = moe.moe_init(gen, cfg, cfg.moe, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, _dense_d_ff(cfg), cfg.mlp_kind,
                            device, cfg.param_dtype)
    return p


def _dense_d_ff(cfg: ModelConfig) -> int:
    """The width of a layer's dense MLP (a MoE config's dense layers have
    their own)."""
    return cfg.dense_d_ff if (cfg.moe is not None and cfg.dense_d_ff) \
        else cfg.d_ff


def _apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                 positions: torch.Tensor, cache: Optional[dict] = None,
                 cache_index: Optional[int] = None,
                 cross_src: Optional[torch.Tensor] = None,
                 want_cache: bool = False, encoder_mode: bool = False,
                 cache_in_place: bool = False,
                 positions_are_arange: bool = False,
                 model: tp.Model = tp.ONE
                 ) -> tuple[torch.Tensor, Optional[dict]]:
    """One layer. ``cache_in_place``: decode writes the self-attention
    cache's new token into the given tensors; ``positions_are_arange``:
    the caller built ``positions`` as ``arange(S)``, unchecked
    (``attn_apply``)."""
    kind = _mixer_kind(cfg, kind)
    dt = torch_dtype(cfg.dtype)
    new_cache: dict = {}
    if kind == "rwkv":
        st = cache.get("rwkv") if cache else None
        y, st_tm = rwkv6.rwkv_time_mix(
            p["rwkv"], norm(p["norm1"], x, cfg.norm), cfg, cfg.rwkv,
            state=st, return_state=want_cache, model=model)
        x = x + y
        y2, st_cm = rwkv6.rwkv_channel_mix(
            p["rwkv"], norm(p["norm2"], x, cfg.norm), cfg, cfg.rwkv,
            state=st, return_state=want_cache, model=model)
        x = x + y2
        if want_cache:
            new_cache["rwkv"] = {**st_tm, **st_cm}
        return x, (new_cache if want_cache else None)

    h = norm(p["norm1"], x, cfg.norm)
    if kind in ("global", "local"):
        y, attn_cache = attention.attn_apply(
            p["attn"], h, cfg, kind=kind, positions=positions,
            cache=cache.get("attn") if cache else None,
            cache_index=cache_index,
            causal_override=False if encoder_mode else None,
            cache_in_place=cache_in_place,
            positions_are_arange=positions_are_arange, model=model)
        if want_cache:
            new_cache["attn"] = attn_cache
    elif kind == "mla":
        y, attn_cache = mla.mla_apply(
            p["attn"], h, cfg, m=cfg.mla, positions=positions,
            cache=cache.get("attn") if cache else None,
            cache_index=cache_index,
            positions_are_arange=positions_are_arange, model=model)
        if want_cache:
            new_cache["attn"] = attn_cache
    elif kind == "rglru":
        st = cache.get("rec") if cache else None
        y, st_new = rglru.rglru_apply(p["rec"], h, cfg, r=cfg.rglru, state=st,
                                      return_state=want_cache, model=model)
        if want_cache:
            new_cache["rec"] = st_new
    else:
        raise ValueError(kind)
    x = x + y

    if "cross" in p:
        hc = norm(p["norm_cross"], x, cfg.norm)
        yc, cross_cache = attention.attn_apply(
            p["cross"], hc, cfg, kind="cross", positions=positions,
            cache=cache.get("cross") if cache else None,
            cache_index=cache_index, kv_src=cross_src, model=model)
        x = x + yc
        if want_cache:
            new_cache["cross"] = cross_cache

    h2 = norm(p["norm2"], x, cfg.norm)
    if "moe" in p:
        x = x + moe.moe_apply(p["moe"], h2, cfg, cfg.moe, model)
    else:
        x = x + mlp(p["mlp"], h2, cfg.mlp_kind, dt, model, _dense_d_ff(cfg))
    return x, (new_cache if want_cache else None)


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      dtype, device: torch.device, cross: bool = False,
                      cross_len: int = 0) -> dict:
    kind = _mixer_kind(cfg, kind)
    c: dict = {}
    if kind in ("global", "local"):
        c["attn"] = attention.init_attn_cache(cfg, kind, batch, max_len,
                                              dtype, device)
    elif kind == "mla":
        c["attn"] = mla.init_mla_cache(cfg, cfg.mla, batch, max_len, dtype,
                                       device)
    elif kind == "rglru":
        c["rec"] = rglru.init_rglru_state(cfg, cfg.rglru, batch, dtype,
                                          device)
    elif kind == "rwkv":
        c["rwkv"] = rwkv6.init_rwkv_state(cfg, cfg.rwkv, batch, dtype,
                                          device)
    else:
        raise ValueError(kind)
    if cross:
        shape = (batch, cross_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
    return c


# ---------------------------------------------------------------------------
# Stack init / apply
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: str | torch.device = "cuda",
                cast: Optional[Callable[[dict], dict]] = None) -> PyTree:
    """Full parameter tree, drawn from ``gen`` on its device and placed on
    ``device``. The pattern unit's params carry a leading repeats axis.
    ``cast`` (a dict of tensors -> the same dict) is applied to each piece
    as it is drawn; the pieces are drawn in the same order either way."""
    dev = resolve_device(device)
    cast = cast or (lambda tree: tree)
    pro, repeats, tail = layer_groups(cfg)
    kinds = layer_kinds(cfg)
    u = len(cfg.pattern)

    def layer(i):
        return cast(_init_layer(gen, cfg, kinds[i], _moe_flag(cfg, i), dev))
    params: dict = {"embed": cast(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                             dev, cfg.param_dtype))}
    params["prologue"] = [layer(i) for i in range(pro)]
    params["unit"] = [stack_drawn(repeats, lambda j=j: layer(pro + j))
                      for j in range(u)] if repeats > 0 else []
    params["tail"] = [layer(pro + repeats * u + i) for i in range(tail)]
    params["final_norm"] = cast(norm_init(cfg.d_model, cfg.norm, dev,
                                          cfg.param_dtype))
    if not cfg.tie_embeddings:
        # cast under its name: a cast that lays leaves out by their names
        # (``train.shardings.param_specs``) sees the head as the head
        params["lm_head"] = cast({"lm_head": {"w": normal(
            gen, (cfg.d_model, cfg.vocab_size), dev, cfg.d_model**-0.5,
            cfg.param_dtype)}})["lm_head"]
    return params


def _embed(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
           patch_embeds: Optional[torch.Tensor] = None,
           model: tp.Model = tp.ONE) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    # the rows are gathered before the cast (bit-identical to the JAX
    # package's cast-then-gather, without casting the whole table)
    e = embed_rows(params["embed"]["embedding"], tokens, model,
                   cfg.vocab_size).to(dt)
    # gemma-style scaling; the scale is rounded to the compute dtype first
    # (on the host, without a tensor: a product of two bf16 values is exact
    # in the fp32 the multiply computes in, so this equals the JAX
    # package's bf16 * bf16)
    e = e * rounded_to(cfg.d_model**0.5, dt)
    if patch_embeds is not None and cfg.frontend == "vision":
        npatch = patch_embeds.shape[1]
        e = torch.cat([patch_embeds.to(dt), e[:, npatch:]], dim=1)
    return e


def _logits(cfg: ModelConfig, params: PyTree, x: torch.Tensor,
            model: tp.Model = tp.ONE) -> torch.Tensor:
    """The logits; with the vocab split over ``model``, the rank's block
    of them (the head's columns, or the tied table's rows)."""
    dt = torch_dtype(cfg.dtype)
    x = norm(params["final_norm"], x, cfg.norm)
    if model.splits(cfg.vocab_size):
        x = tp.copy_in(x, model)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].to(dt).T
    else:
        logits = x @ params["lm_head"]["w"].to(dt)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _run_stack(cfg: ModelConfig, params: PyTree, x: torch.Tensor, *,
               positions: torch.Tensor, caches: Optional[dict] = None,
               cache_index: Optional[int] = None, want_cache: bool = False,
               positions_are_arange: bool = False, remat_policy: str = "none",
               model: tp.Model = tp.ONE
               ) -> tuple[torch.Tensor, Optional[dict]]:
    """The decoder-only stack (prologue, unit, tail). The encoder-decoder
    stacks are ``models.encdec._run_stacked``. ``remat_policy`` != "none"
    (the teacher-forced forward: no caches) runs each repeat of the
    pattern unit under ``remat.checkpoint`` (the reference's
    ``jax.checkpoint`` of ``unit_body``); prologue and tail layers are not
    checkpointed, as there."""
    pro, repeats, tail = layer_groups(cfg)
    kinds = layer_kinds(cfg)
    u = len(cfg.pattern)
    new_caches: dict = {"prologue": [], "unit": None, "tail": []}

    def run_layer(p, x, kind, cache):
        return _apply_layer(p, x, cfg, kind, positions=positions, cache=cache,
                            cache_index=cache_index, want_cache=want_cache,
                            positions_are_arange=positions_are_arange,
                            model=model)

    for i, p in enumerate(params["prologue"]):
        cache = caches["prologue"][i] if caches else None
        x, nc = run_layer(p, x, kinds[i], cache)
        new_caches["prologue"].append(nc)

    if repeats > 0:
        unit_kinds = [kinds[pro + j] for j in range(u)]
        unit = [_tree_unbind(params["unit"][j], repeats) for j in range(u)]
        outs: list[list] = [[] for _ in range(u)]

        def unit_body(unit_params, x, positions):
            for j in range(u):
                x, _ = _apply_layer(
                    unit_params[j], x, cfg, unit_kinds[j],
                    positions=positions,
                    positions_are_arange=positions_are_arange, model=model)
            return x
        for rep in range(repeats):
            if remat_policy != "none":
                x = remat.checkpoint(
                    unit_body, [unit[j][rep] for j in range(u)], x,
                    positions, policy=remat_policy)
                continue
            for j in range(u):
                cache_j = (_tree_index(caches["unit"][j], rep) if caches
                           else None)
                x, nc = run_layer(unit[j][rep], x, unit_kinds[j], cache_j)
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

def check_tp(cfg: ModelConfig, model: tp.Model) -> None:
    """What tensor parallelism still refuses in training, checked from
    the config before any work: heads that do not divide over the axis
    (a q head split over ranks), for attention, MLA and RWKV-6 alike,
    raise naming ROADMAP Queue 1 item 9. An axis of one passes."""
    if not model.active:
        return
    kinds = {_mixer_kind(cfg, k) for k in cfg.pattern}
    if cfg.is_encdec or kinds & {"global", "local"}:
        attention.head_split(cfg, model)
    if "mla" in kinds:
        mla.heads_of(cfg, model)
    if "rwkv" in kinds:
        rwkv6.axis_of(cfg, cfg.rwkv, model)


def tp_runs_eager(cfg: ModelConfig, model: tp.Model) -> bool:
    """Whether ``launch.train`` runs a tensor-parallel step eager: a step
    through RG-LRU layers whose channels split over ``model``.
    recurrentgemma-2b's Mode B step at its published widths (512 steps:
    the chained scans) never ended its CUDA graph capture on four H100s,
    with the all-gather of ``tp.gather`` issued either as a list of
    shards or into one buffer; at the smoke widths (32 steps) the same
    step, and RWKV-6's with its all-gather, captured and replayed
    bit-equal. Which collective or kernel holds the full-width capture
    is not known."""
    if not model.active:
        return False
    kinds = {_mixer_kind(cfg, k) for k in cfg.pattern}
    return "rglru" in kinds and model.splits(cfg.rglru.d_rnn)


def apply(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor, *,
          patch_embeds: Optional[torch.Tensor] = None,
          remat: str = "none", model: Optional[tp.Model] = None
          ) -> torch.Tensor:
    """Teacher-forced forward: (B, S) tokens -> (B, S, V) logits (under
    tensor parallelism with the vocab split, the rank's (B, S, V / size)
    block). ``remat``: "none" | "full" | "dots" (``models.remat``)."""
    model = tp.resolve(model)
    check_tp(cfg, model)
    x = _embed(cfg, params, tokens, patch_embeds, model)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _ = _run_stack(cfg, params, x, positions=positions,
                      positions_are_arange=True, remat_policy=remat,
                      model=model)
    return _logits(cfg, params, x, model)


def lm_loss(cfg: ModelConfig, params: PyTree, batch: dict, *,
            remat: str = "none", model: Optional[tp.Model] = None
            ) -> torch.Tensor:
    """Next-token cross entropy on batch["tokens"] (B, S); differentiable
    (``torch.func.grad``, autograd), under ``torch.func.vmap`` too."""
    model = tp.resolve(model)
    tokens = batch["tokens"]
    logits = apply(cfg, params, tokens, patch_embeds=batch.get("patch_embeds"),
                   remat=remat, model=model)
    if model.splits(cfg.vocab_size):
        return vocab_cross_entropy(logits[:, :-1], tokens[:, 1:], model)
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
