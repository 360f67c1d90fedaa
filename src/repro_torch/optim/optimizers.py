"""Minimal optimizers in plain torch: SGD / momentum / AdamW.

The torch counterpart of ``repro.optim.optimizers``, formula for formula
(PyTorch's own AdamW class decays ``p`` before its step and so computes
something else). API: ``opt.init(params) -> state``; ``opt.update(grads,
state, params, lr, donate=False) -> (new_params, new_state)``, with ``lr``
a 0-d fp32 tensor. ``donate`` (the JAX trainer's ``donate_argnums``)
writes the new parameters and moments into ``params`` and ``state``'s
tensors, leaf by leaf, bit-equal to the new trees: a step then holds one
copy of them beside the gradient, not two (a parameter whose elements
share memory, as the node mean's expanded view, gets a new tensor). All updates are elementwise, so
they apply to the D-PSGD node axis unchanged (each node owns its optimizer
state). Two quirks of the reference are kept: weight decay applies where
``p.ndim >= 2``, which on node-stacked leaves includes the per-node
vectors, and the gradient clip takes one norm over the whole tree (over
all nodes together in Mode B).
Under tensor parallelism (``model``, a ``models.tp.Model``, with
``sharded`` one flag a leaf) the clip's sum of squares adds the sharded
leaves' sums over the model group and counts each replicated leaf once,
so the norm is the whole tree's, as the JAX package's global arrays give
it.

Every division by a Python number goes through a tensor on the operands'
device: CUDA's ``tensor / python_scalar`` multiplies by the reciprocal,
one bit off IEEE division.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..core.dpsgd import _leaves, _tree_map
from ..models import tp

PyTree = Any

__all__ = ["Optimizer", "make_optimizer"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d fp32 tensor on ``like``'s device (made by a fill
    kernel, so a CUDA graph can capture it)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _minus(p: torch.Tensor, d: torch.Tensor, donate: bool) -> torch.Tensor:
    """``p - d``, written into ``p`` when ``donate`` and no two of its
    elements share memory (an expanded view's do)."""
    if donate and all(st or n == 1 for st, n in zip(p.stride(), p.shape)):
        return p.sub_(d)
    return p - d


def _tree_zeros_like(params: PyTree) -> PyTree:
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)


def _clip_by_global_norm(grads: PyTree, max_norm: float,
                         model: tp.Model = tp.ONE,
                         sharded: Optional[list] = None) -> PyTree:
    leaves = _leaves(grads)
    squares = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
    if model.active:
        split = [q for q, s in zip(squares, sharded) if s]
        whole = [q for q, s in zip(squares, sharded) if not s]
        total = tp.reduce_out(torch.stack(split).sum(), model) if split \
            else 0
        gn = torch.sqrt(total + sum(whole))
    else:
        gn = torch.sqrt(sum(squares))
    scale = torch.minimum(
        _full(1.0, gn),
        _full(max_norm, gn) / torch.maximum(gn, _full(1e-9, gn)))
    return _tree_map(lambda g: g * scale.to(g.dtype), grads)


def make_optimizer(name: str, *, momentum: float = 0.0,
                   weight_decay: float = 0.0,
                   beta1: float = 0.9, beta2: float = 0.95,
                   eps: float = 1e-8,
                   grad_clip: Optional[float] = None,
                   model: tp.Model = tp.ONE,
                   sharded: Optional[list] = None) -> Optimizer:
    """``model`` / ``sharded`` (one flag a leaf of the gradient tree: split
    over the model axis): the clip's norm over the whole tree under
    tensor parallelism."""
    if model.active and grad_clip and sharded is None:
        raise ValueError("a gradient clip under tensor parallelism needs "
                         "the leaves' sharded flags")

    def maybe_clip(grads):
        return _clip_by_global_norm(grads, grad_clip, model, sharded) \
            if grad_clip else grads

    if name == "sgd":
        def init(params):
            return {}

        def update(grads, state, params, lr, donate=False):
            grads = maybe_clip(grads)
            new = _tree_map(
                lambda p, g: _minus(p, (lr * g.to(torch.float32)).to(p.dtype),
                                    donate), params, grads)
            return new, state
        return Optimizer("sgd", init, update)

    if name == "momentum":
        def init(params):
            return {"v": _tree_zeros_like(params)}

        def update(grads, state, params, lr, donate=False):
            grads = maybe_clip(grads)
            if donate:
                def one(p, v, g):
                    v.mul_(momentum).add_(g.to(torch.float32))
                    return _minus(p, (lr * v).to(p.dtype), True)
                return _tree_map(one, params, state["v"], grads), state
            v = _tree_map(lambda v, g: momentum * v + g.to(torch.float32),
                          state["v"], grads)
            new = _tree_map(lambda p, v: p - (lr * v).to(p.dtype), params, v)
            return new, {"v": v}
        return Optimizer("momentum", init, update)

    if name == "adamw":
        def init(params):
            device = _leaves(params)[0].device
            return {"m": _tree_zeros_like(params),
                    "v": _tree_zeros_like(params),
                    "t": torch.zeros((), dtype=torch.int32, device=device)}

        def update(grads, state, params, lr, donate=False):
            grads = maybe_clip(grads)
            t = state["t"] + 1
            tf = t.to(torch.float32)
            # beta ** t in fp32, as the reference's weak-typed power
            bc1 = 1 - torch.pow(_full(beta1, tf), tf)
            bc2 = 1 - torch.pow(_full(beta2, tf), tf)

            def step_of(p, m, v):
                step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if weight_decay and p.dim() >= 2:  # decay matrices only
                    step = step + lr * weight_decay * p.to(torch.float32)
                return step.to(p.dtype)

            if donate:
                def one(p, m, v, g):
                    g = g.to(torch.float32)
                    m.mul_(beta1).add_((1 - beta1) * g)
                    v.mul_(beta2).add_((1 - beta2) * torch.square(g))
                    return _minus(p, step_of(p, m, v), True)
                return (_tree_map(one, params, state["m"], state["v"],
                                  grads),
                        {"m": state["m"], "v": state["v"], "t": t})
            m = _tree_map(lambda m, g: beta1 * m + (1 - beta1)
                          * g.to(torch.float32), state["m"], grads)
            v = _tree_map(lambda v, g: beta2 * v + (1 - beta2)
                          * torch.square(g.to(torch.float32)),
                          state["v"], grads)
            return (_tree_map(lambda p, m, v: p - step_of(p, m, v),
                              params, m, v),
                    {"m": m, "v": v, "t": t})
        return Optimizer("adamw", init, update)

    raise ValueError(f"unknown optimizer {name!r}")
