"""Encoder-decoder backbone (seamless-m4t-large-v2's transformer core).

The torch counterpart of ``repro.models.encdec``. The audio frontend is a
stub: ``src_embeds`` are precomputed frame embeddings (B, S_src, d_model)
fed straight to the encoder (bidirectional attention). The decoder is a
causal stack whose every layer carries cross attention over the encoder
output. Every attention of a prefill runs the flash kernel: the encoder's
non-causal, the decoder's causal, the cross attention non-causal over
S_src keys; decode launches none.

The layer params keep the JAX layout, stacked with a leading ``n_enc`` /
``n_dec`` axis (``convert.params_from_numpy`` carries the JAX tree over
unchanged); the JAX package's ``lax.scan`` over a stack becomes a loop
over its leading axis. A serving shape of S positions maps to S_src =
S_tgt = S / 2 (``api._encdec_make_inputs``).

Tensor parallelism (``model``; ``tp.current()`` when none is given) runs
the teacher-forced forward on the rank's shards, through both stacks and
remat's checkpoint: self and cross attention on the rank's heads, the
MLPs column / row parallel, the tied embedding and its head
vocab-parallel where the vocab divides over the axis (else replicated,
``encdec_loss`` then the plain cross entropy).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import remat, tp
from .layers import (cross_entropy, embed_init, norm, norm_init, torch_dtype,
                     vocab_cross_entropy)
from .transformer import (_apply_layer, _embed, _init_layer,
                          _init_layer_cache, _logits, _tree_index,
                          _tree_map, _tree_stack, _tree_unbind, check_tp,
                          stack_drawn)

PyTree = Any

__all__ = ["init_params", "apply", "encdec_loss", "encode", "init_dec_cache",
           "prefill", "decode_step"]


def _half_layers(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.encoder_layers, cfg.n_layers - cfg.encoder_layers


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: str | torch.device = "cuda",
                cast: Optional[Callable[[dict], dict]] = None) -> PyTree:
    """The JAX package's tree: embedding, the stacked encoder and decoder
    layers (decoder layers with cross attention), two final norms.
    ``cast`` as in ``transformer.init_params``."""
    dev = resolve_device(device)
    cast = cast or (lambda tree: tree)
    n_enc, n_dec = _half_layers(cfg)

    def stack(n, cross):
        return stack_drawn(n, lambda: cast(_init_layer(
            gen, cfg, "global", False, dev, cross=cross)))
    return {
        "embed": cast(embed_init(gen, cfg.vocab_size, cfg.d_model, dev,
                                 cfg.param_dtype)),
        "encoder": stack(n_enc, cross=False),
        "decoder": stack(n_dec, cross=True),
        "enc_norm": cast(norm_init(cfg.d_model, cfg.norm, dev,
                                   cfg.param_dtype)),
        "final_norm": cast(norm_init(cfg.d_model, cfg.norm, dev,
                                     cfg.param_dtype)),
    }


def _run_stacked(cfg: ModelConfig, stacked: dict, x: torch.Tensor, *,
                 positions: torch.Tensor,
                 cross_src: Optional[torch.Tensor] = None,
                 caches: Optional[dict] = None,
                 cache_index: Optional[int] = None, want_cache: bool = False,
                 encoder_mode: bool = False,
                 positions_are_arange: bool = False,
                 remat_policy: str = "none", model: tp.Model = tp.ONE
                 ) -> tuple[torch.Tensor, Optional[dict]]:
    """The layers of a stack in turn. In decode (``cache_index`` given)
    the cross K/V, which never change after prefill, pass through as the
    same tensors, and the self-attention caches are copied once, as a
    stack, each layer writing its token into its slot of the copy.
    Otherwise the stack is unbound once (a slice taken a layer would cost
    a stack-sized gradient a layer), and ``remat_policy`` != "none" (the
    teacher-forced forward: no caches) runs each layer under
    ``remat.checkpoint`` (the reference's ``jax.checkpoint`` of
    ``_scan_stack``'s body)."""
    n = stacked["norm1"]["scale"].shape[0]
    if cache_index is not None:
        self_kv = _tree_map(torch.clone, caches["attn"])
        for i in range(n):
            x, _ = _apply_layer(
                _tree_index(stacked, i), x, cfg, "global",
                positions=positions, cache_index=cache_index,
                cache={"attn": _tree_index(self_kv, i),
                       "cross": _tree_index(caches["cross"], i)},
                cache_in_place=True)
        return x, {"attn": self_kv, "cross": caches["cross"]}

    def layer(p, x, cross_src, positions, cache=None):
        return _apply_layer(
            p, x, cfg, "global", positions=positions, cache=cache,
            cross_src=cross_src, want_cache=want_cache,
            encoder_mode=encoder_mode,
            positions_are_arange=positions_are_arange, model=model)
    new = []
    for i, p in enumerate(_tree_unbind(stacked, n)):
        if remat_policy != "none":
            x = remat.checkpoint(lambda *a: layer(*a)[0], p, x, cross_src,
                                 positions, policy=remat_policy)
            continue
        x, nc = layer(p, x, cross_src, positions,
                      _tree_index(caches, i) if caches is not None else None)
        new.append(nc)
    return x, (_tree_stack(new) if want_cache else None)


def encode(cfg: ModelConfig, params: PyTree, src_embeds: torch.Tensor, *,
           remat: str = "none", model: tp.Model = tp.ONE) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings."""
    s = src_embeds.shape[1]
    x, _ = _run_stacked(cfg, params["encoder"],
                        src_embeds.to(torch_dtype(cfg.dtype)),
                        positions=torch.arange(s, device=src_embeds.device),
                        encoder_mode=True, remat_policy=remat, model=model)
    return norm(params["enc_norm"], x, cfg.norm)


def apply(cfg: ModelConfig, params: PyTree, src_embeds: torch.Tensor,
          tgt_tokens: torch.Tensor, *, remat: str = "none",
          model: Optional[tp.Model] = None) -> torch.Tensor:
    """Teacher-forced: (B,S_src,d) x (B,S_tgt) -> (B,S_tgt,V) logits
    (under tensor parallelism with the vocab split, the rank's (B, S_tgt,
    V / size) block). ``remat``: "none" | "full" | "dots"
    (``models.remat``)."""
    model = tp.resolve(model)
    check_tp(cfg, model)
    enc = encode(cfg, params, src_embeds, remat=remat, model=model)
    x = _embed(cfg, params, tgt_tokens, model=model)
    x, _ = _run_stacked(
        cfg, params["decoder"], x,
        positions=torch.arange(tgt_tokens.shape[1], device=x.device),
        cross_src=enc, positions_are_arange=True, remat_policy=remat,
        model=model)
    return _logits(cfg, params, x, model)


def encdec_loss(cfg: ModelConfig, params: PyTree, batch: dict, *,
                remat: str = "none",
                model: Optional[tp.Model] = None) -> torch.Tensor:
    """Next-token cross entropy of the target; differentiable
    (``torch.func.grad``, autograd), under ``torch.func.vmap`` too."""
    model = tp.resolve(model)
    tokens = batch["tokens"]
    logits = apply(cfg, params, batch["src_embeds"], tokens, remat=remat,
                   model=model)
    if model.splits(cfg.vocab_size):
        return vocab_cross_entropy(logits[:, :-1], tokens[:, 1:], model)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


def init_dec_cache(cfg: ModelConfig, batch: int, max_len: int, cross_len: int,
                   dtype=None, device: str | torch.device = "cuda") -> PyTree:
    """The decoder's caches, stacked over its layers: self attention
    (B, max_len, ...) and cross attention (B, cross_len, ...)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype if dtype is None else dtype)
    _, n_dec = _half_layers(cfg)
    one = _init_layer_cache(cfg, "global", batch, max_len, dtype, dev,
                            cross=True, cross_len=cross_len)
    return _tree_map(lambda l: l[None].expand(n_dec, *l.shape).clone(), one)


def prefill(cfg: ModelConfig, params: PyTree, src_embeds: torch.Tensor,
            tgt_tokens: torch.Tensor, *, max_len: Optional[int] = None
            ) -> tuple[torch.Tensor, PyTree]:
    """Encode, then run the target prompt; returns (last logits (B, V),
    the decoder's caches, the encoder's K/V among them)."""
    b, s_tgt = tgt_tokens.shape
    max_len = max_len or s_tgt
    enc = encode(cfg, params, src_embeds)
    caches = init_dec_cache(cfg, b, max_len, src_embeds.shape[1],
                            device=tgt_tokens.device)
    x = _embed(cfg, params, tgt_tokens)
    x, new_caches = _run_stacked(
        cfg, params["decoder"], x,
        positions=torch.arange(s_tgt, device=x.device), cross_src=enc,
        caches=caches, want_cache=True)
    return _logits(cfg, params, x[:, -1:])[:, 0], new_caches


def decode_step(cfg: ModelConfig, params: PyTree, token: torch.Tensor,
                caches: PyTree, index: int) -> tuple[torch.Tensor, PyTree]:
    """One target-token decode against the cached encoder K/V. The
    returned caches hold ``caches``' cross K/V tensors themselves and a
    new copy of the self-attention caches; ``caches`` is left as it was."""
    index = int(index)
    x = _embed(cfg, params, token[:, None])
    x, new_caches = _run_stacked(
        cfg, params["decoder"], x,
        positions=torch.arange(index, index + 1, device=token.device),
        caches=caches, cache_index=index)
    return _logits(cfg, params, x)[:, 0], new_caches
