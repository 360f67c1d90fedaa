"""Uniform model facade: every architecture exposes the same five functions.

The torch counterpart of ``repro.models.api``:

* ``init(gen, cast=None) -> params``     (drawn from a ``torch.Generator``;
                                          ``cast`` applied as drawn)
* ``loss(params, batch, remat="none") -> scalar``
                                         (teacher-forced; differentiable
                                          on the card and on the CPU:
                                          attention's gradient is the
                                          flash backward kernel or its
                                          plain version; ``remat`` "full"
                                          / "dots" checkpoints each unit,
                                          ``models.remat``)
* ``prefill(params, batch) -> (logits, cache)``
* ``decode_step(params, token, cache, index) -> (logits, cache)``
* ``make_inputs(shape, gen) -> batch``   (synthetic, for smoke runs)

``batch`` layouts per family:
  lm / moe / ssm / hybrid: {"tokens": (B, S)}
  vlm:                     {"tokens": (B, S), "patch_embeds": (B, P, d)}
  encdec:                  {"src_embeds": (B, S/2, d), "tokens": (B, S/2)}
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import encdec, tp, transformer
from .layers import torch_dtype

PyTree = Any

__all__ = ["ModelAPI", "build"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[[torch.Generator], PyTree]
    loss: Callable[..., torch.Tensor]
    prefill: Callable[..., tuple[torch.Tensor, PyTree]]
    decode_step: Callable[..., tuple[torch.Tensor, PyTree]]
    make_inputs: Callable[..., dict]


def _lm_make_inputs(cfg: ModelConfig, shape: ShapeConfig,
                    gen: torch.Generator, device: str | torch.device,
                    batch_override: Optional[int] = None) -> dict:
    device = resolve_device(device)
    b = batch_override or shape.global_batch
    s = shape.seq_len
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=gen.device).to(device)
    out = {"tokens": tokens}
    if cfg.frontend == "vision":
        out["patch_embeds"] = torch.randn(
            (b, cfg.n_patches, cfg.d_model), generator=gen,
            device=gen.device).to(device=device, dtype=torch_dtype(cfg.dtype))
    return out


def _encdec_make_inputs(cfg: ModelConfig, shape: ShapeConfig,
                        gen: torch.Generator, device: str | torch.device,
                        batch_override: Optional[int] = None) -> dict:
    """A shape of S positions as S / 2 source frames and S / 2 target
    tokens (at least 8 each), as the JAX package maps it."""
    device = resolve_device(device)
    b = batch_override or shape.global_batch
    half = max(shape.seq_len // 2, 8)
    src = torch.randn((b, half, cfg.d_model), generator=gen,
                      device=gen.device)
    tokens = torch.randint(0, cfg.vocab_size, (b, half), generator=gen,
                           device=gen.device)
    return {"src_embeds": src.to(device=device,
                                 dtype=torch_dtype(cfg.dtype)),
            "tokens": tokens.to(device)}


def _serve_alone(model: Optional[tp.Model]) -> None:
    """Serving runs on one device: its caches over a 'model' axis wait for
    ROADMAP Queue 1 item 9."""
    if tp.resolve(model).active:
        raise NotImplementedError(
            "tensor parallelism runs the teacher-forced loss; prefill and "
            f"decode caches over a 'model' axis wait for {tp.SERVE_ITEM}")


def build(cfg: ModelConfig, device: str | torch.device = "cuda",
          model: Optional[tp.Model] = None) -> ModelAPI:
    """The facade of ``cfg`` with ``init`` and ``make_inputs`` placing
    tensors on ``device`` (checked when they are called). ``model`` (a
    ``models.tp.Model``) runs ``loss`` tensor parallel on the rank's
    shards (``train.shardings.shard_model``; None: ``tp.current()`` at
    the call), every family; what still waits raises naming ROADMAP
    Queue 1 item 9: here a q head split over the ranks
    (``transformer.check_tp``), at the call ``prefill`` and
    ``decode_step`` under an active axis."""
    if model is not None:
        transformer.check_tp(cfg, model)
    if cfg.is_encdec:
        def loss(params, batch, remat="none"):
            return encdec.encdec_loss(cfg, params, batch, remat=remat,
                                      model=model)

        def prefill(params, batch, max_len=None):
            _serve_alone(model)
            return encdec.prefill(cfg, params, batch["src_embeds"],
                                  batch["tokens"], max_len=max_len)

        def decode(params, token, cache, index):
            _serve_alone(model)
            return encdec.decode_step(cfg, params, token, cache, index)

        return ModelAPI(
            cfg, lambda gen, cast=None: encdec.init_params(cfg, gen, device,
                                                           cast),
            loss, prefill, decode,
            lambda shape, gen, batch_override=None: _encdec_make_inputs(
                cfg, shape, gen, device, batch_override))

    def loss(params, batch, remat="none"):
        return transformer.lm_loss(cfg, params, batch, remat=remat,
                                   model=model)

    def prefill(params, batch, max_len=None):
        _serve_alone(model)
        return transformer.prefill(cfg, params, batch["tokens"],
                                   max_len=max_len,
                                   patch_embeds=batch.get("patch_embeds"))

    def decode(params, token, cache, index):
        _serve_alone(model)
        return transformer.decode_step(cfg, params, token, cache, index)

    return ModelAPI(
        cfg, lambda gen, cast=None: transformer.init_params(cfg, gen, device,
                                                            cast), loss,
        prefill, decode,
        lambda shape, gen, batch_override=None: _lm_make_inputs(
            cfg, shape, gen, device, batch_override))
