"""D-PSGD optimizer (paper Algorithm 1 / Eq. 5) — wireless-faithful simulation.

State layout: every parameter leaf carries a leading **node axis** of size n
(``X = (x_1 .. x_n)`` stacked), mirroring Eq. 5:

    X_{k+1} <- W @ X_k  -  eta * stack_i( grad F_i(x_{k,i}; xi_{k,i}) )

One step = (a) per-node minibatch gradients via ``torch.func.vmap`` over the
node axis, (b) mixing with the averaging matrix W, (c) SGD update. The
wall-clock communication cost is modeled separately by
``comm_model.tdm_time_s`` (measured compute + Eq. 3, as the paper does).

The torch counterpart of ``repro.core.dpsgd``. Parameters are nested dicts
of tensors; leaves are visited in sorted-key order, as ``jax.tree`` visits
dict keys, so the concatenated message buffer has the same layout (and the
int8 block grid the same blocks) as the JAX package's.

The mix is lowered onto the hand-written kernels of ``kernels.gossip_mix``
(CUDA on an sm_90 card, their plain torch versions on the CPU):

* ``mix`` — one ``gossip_mix_rows`` launch per step over the leaves
  concatenated into one (n, total) buffer per dtype (the CNN: one launch
  over (6, 21 840)); element for element the same arithmetic as mixing
  each leaf on its own.
* the int8 round of ``_mix_compressed_*`` — three launches: the
  quantize and the error-feedback dequantize of ``kernels.quantize`` (at
  the wire format's 2048-lane blocks, through
  ``compression.quantize_int8_rows`` / ``dequantize_int8_rows``), then
  ``gossip_mix_q8_rows`` (exact fp32 self term, int8 neighbor payloads
  dequantized in the kernel).
* the bf16 receive — one ``gossip_mix_rows`` launch with
  ``W_cat = [diag(diag(W)) | W_off]`` (n, 2n) over the stacked fp32
  buffers ``[flat; deq]`` (2n, N): the self term exact, the neighbor terms
  the bf16-rounded payloads.

Also supports ``local_steps`` H >= 1 (Cooperative-SGD generalization; H=1 ==
paper) and arbitrary W (row-stochastic, Metropolis, fully-connected).

The ``make_*`` builders are the counterpart of the JAX package's jitted
steps: each returns a ``graphs.GraphedStep``, which on CUDA inputs captures
its eager body (``dpsgd_step``, ``dpsgd_masked_step``,
``dpsgd_masked_compressed_step``) into one CUDA graph per input signature
and replays it, and on CPU inputs runs the body as it is. A churn that
changes n is a new signature and a new capture; ``step.prepare(*args)``
captures ahead of a measured call. The gathered batch is copied into the
graph's static buffers (the step does not see the data set), as are W and
``live``, which may arrive as numpy per round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..graphs import GraphedStep
from ..kernels.gossip_mix import gossip_mix_q8_rows, gossip_mix_rows
from .compression import dequantize_int8_rows, quantize_int8_rows

__all__ = ["DPSGDConfig", "replicate", "mix", "dpsgd_step", "make_dpsgd_step",
           "dpsgd_masked_step", "make_dpsgd_masked_step",
           "dpsgd_masked_compressed_step",
           "make_dpsgd_compressed_step", "embed_w", "zero_residuals",
           "node_axis_size"]

PyTree = Any


# ---------------------------------------------------------------------------
# Nested-dict trees, leaves in sorted-key order (jax.tree's dict order)
# ---------------------------------------------------------------------------

def _paths(tree: PyTree, path: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in _paths(tree)]


def _unflatten(like: PyTree, leaves: list) -> PyTree:
    """Rebuild ``like``'s structure from leaves in sorted-key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def node_axis_size(tree: PyTree, what: str = "node state",
                   allow_scalar: bool = False) -> int:
    """The shared leading node-axis length of every leaf — the shape
    contract of the masked-state layout (every parameter/residual/batch
    leaf is ``(n_nodes, ...)``). Raises with the offending leaf path on
    scalar leaves or disagreeing leading dims.

    ``allow_scalar=True`` skips 0-d leaves; returns 0 if every leaf was
    scalar."""
    sizes: dict[str, int] = {}
    for path, leaf in _paths(tree):
        if getattr(leaf, "ndim", 0) == 0:
            if allow_scalar:
                continue
            raise ValueError(
                f"{what} leaf {path} is a scalar; "
                "every leaf must carry the leading (n_nodes, ...) node axis")
        sizes[path] = int(leaf.shape[0])
    uniq = set(sizes.values())
    if len(uniq) > 1:
        raise ValueError(
            f"{what} leaves disagree on the leading node axis: {sizes}")
    return uniq.pop() if uniq else 0


@dataclasses.dataclass(frozen=True)
class DPSGDConfig:
    eta: float = 0.01        # learning rate (paper Fig. 3: 0.01)
    local_steps: int = 1     # H; H=1 is the paper's Algorithm 1
    # Eq. 5 order. True:  X <- W X - eta G(X)   (gradient at pre-mix params,
    # so computation and communication overlap — Lian et al.'s Algorithm 1).
    # False: X <- W (X - eta G(X))  (gradient-first: local update, then mix).
    mix_first: bool = True


def _device_of(tree: PyTree) -> torch.device:
    return _leaves(tree)[0].device


def _as_w(w, device: torch.device) -> torch.Tensor:
    """W as an fp32 tensor on ``device`` (a float64 numpy W rounds to fp32,
    as ``jnp.asarray`` does without x64)."""
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def _as_live(live, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(live, dtype=torch.bool, device=device)


def replicate(params: PyTree, n: int) -> PyTree:
    """All nodes start from the same x_0 (paper assumption for Eq. 7); each
    node gets its own copy."""
    return _tree_map(lambda p: p[None].repeat(n, *([1] * p.dim())), params)


def mix(node_params: PyTree, w) -> PyTree:
    """X <- W @ X on the leading node axis of every leaf.

    Leaves of one dtype are concatenated into one (n, total) buffer and
    mixed by one ``gossip_mix_rows`` launch; W is cast to that dtype first,
    as the reference's ``w.astype(flat.dtype)`` does. The mixed leaves are
    views into the output buffer."""
    leaves = _leaves(node_params)
    n = leaves[0].shape[0]
    w = _as_w(w, leaves[0].device)
    out: list = [None] * len(leaves)
    for dtype in dict.fromkeys(p.dtype for p in leaves):
        idx = [i for i, p in enumerate(leaves) if p.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(n, -1) for i in idx], dim=1)
        mixed = gossip_mix_rows(w.to(dtype), flat)
        offset = 0
        for i in idx:
            size = leaves[i][0].numel()
            out[i] = mixed[:, offset:offset + size].reshape(leaves[i].shape)
            offset += size
    return _unflatten(node_params, out)


def _node_grads(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    node_params: PyTree,
    node_batches: PyTree,
) -> tuple[torch.Tensor, PyTree]:
    """Per-node loss/grads: vmap over the leading node axis of params+batch."""
    grads, losses = torch.func.vmap(torch.func.grad_and_value(loss_fn))(
        node_params, node_batches)
    return losses, grads


def _sgd(params: PyTree, grads: PyTree, eta: float) -> PyTree:
    return _tree_map(lambda x, g: x - eta * g.to(x.dtype), params, grads)


def dpsgd_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    node_params: PyTree,
    node_batches: PyTree,
    w,
    config: DPSGDConfig = DPSGDConfig(),
) -> tuple[PyTree, torch.Tensor]:
    """One D-PSGD iteration (Algorithm 1 steps 2-5) for all n nodes.

    Eq. 5:  X_{k+1} = W X_k - eta * G(X_k)   — the gradient is taken at
    X_k (the *pre-mix* parameters), exactly as in Lian et al./the paper.

    ``node_batches`` leaves have shape (n, local_batch, ...). With
    local_steps > 1 the batch leaves carry (n, H, local_batch, ...) and W is
    applied once per H local SGD steps (Cooperative SGD).
    """
    h = config.local_steps
    if h == 1:
        losses, grads = _node_grads(loss_fn, node_params, node_batches)
        if config.mix_first:
            new_params = _sgd(mix(node_params, w), grads, config.eta)
        else:
            # gradient-first order: X <- W (X - eta G)
            new_params = mix(_sgd(node_params, grads, config.eta), w)
        return new_params, losses

    losses = None
    for i in range(h):
        batch = _tree_map(lambda b: b[:, i], node_batches)
        losses, grads = _node_grads(loss_fn, node_params, batch)
        node_params = _sgd(node_params, grads, config.eta)
    return mix(node_params, w), losses


def embed_w(w_live, ids, n_total: int):
    """Embed a compacted (n_live, n_live) mixing matrix into a fixed (n, n)
    one for the masked-state layout: live rows/columns are scattered to their
    original node indices ``ids``; dead rows get an identity row (their stale
    parameters are carried unchanged) and dead columns weight 0 (they feed
    nothing into live rows). This is the W contract ``dpsgd_masked_step``
    assumes: the state keeps its full (n, ...) shape forever, no reshapes.
    """
    ids = np.asarray(ids, dtype=np.int64)
    w_full = np.eye(n_total, dtype=np.float64)
    w_full[np.ix_(ids, ids)] = np.asarray(w_live, dtype=np.float64)
    return w_full


def _mask_grads(grads: PyTree, live: torch.Tensor) -> PyTree:
    """Zero dead nodes' gradients (``where``, so NaNs from junk batch rows
    cannot leak)."""
    def _mask(g: torch.Tensor) -> torch.Tensor:
        m = live.reshape(live.shape[0], *([1] * (g.dim() - 1)))
        return torch.where(m, g, torch.zeros((), dtype=g.dtype,
                                             device=g.device))
    return _tree_map(_mask, grads)


def dpsgd_masked_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    node_params: PyTree,
    node_batches: PyTree,
    w,
    live,
    config: DPSGDConfig = DPSGDConfig(),
) -> tuple[PyTree, torch.Tensor]:
    """One D-PSGD iteration on a fixed-width node state under churn.

    ``live`` is a (n,) bool mask; ``w`` must follow the ``embed_w`` contract
    (identity rows / zero columns for dead nodes). Dead rows carry their
    parameters unchanged and never contribute to live rows. Returned
    per-node losses are raw; mask with ``live`` before aggregating.

    Only ``local_steps == 1`` is supported.
    """
    if config.local_steps != 1:
        raise NotImplementedError(
            "dpsgd_masked_step supports local_steps == 1 only")
    live = _as_live(live, _device_of(node_params))
    losses, grads = _node_grads(loss_fn, node_params, node_batches)
    grads = _mask_grads(grads, live)
    if config.mix_first:
        new_params = _sgd(mix(node_params, w), grads, config.eta)
    else:
        new_params = mix(_sgd(node_params, grads, config.eta), w)
    return new_params, losses


def zero_residuals(node_params: PyTree) -> PyTree:
    """Fresh error-feedback state: one fp32 zero per parameter (the residual
    lives in fp32 no matter the parameter dtype)."""
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), node_params)


def _mix_compressed(
    node_params: PyTree,
    residuals: PyTree,
    w,
    live,
    quant,
) -> tuple[PyTree, PyTree]:
    """Quantized error-feedback mixing on the masked layout.

    Per node:  m_i = Q(x_i + e_i),  e_i' = (x_i + e_i) - m_i;  receivers mix
    the **exact** own value with dequantized neighbor messages,
    x_j' = W_jj x_j + sum_{i!=j} W_ji m_i (CHOCO-SGD-flavored). Under the
    ``embed_w`` contract dead rows come back verbatim and dead residuals are
    zeroed. ``mode="none"`` degenerates to the exact ``mix`` with the
    residuals passed through untouched.

    ``quant.granularity`` picks the wire format: ``"message"`` quantizes
    the concatenated leaves as one (n, total) buffer, ``"leaf"`` each
    tensor on its own block grid with its own residual.
    """
    if quant.mode == "none":
        return mix(node_params, w), residuals
    n = node_axis_size(node_params, "node_params")
    device = _device_of(node_params)
    w = _as_w(w, device)
    live = _as_live(live, device)
    if live.shape[0] != n or w.shape[-1] != n:
        raise ValueError(
            f"live {tuple(live.shape)} / w {tuple(w.shape)} disagree with "
            f"the node axis n={n} of node_params")
    if getattr(quant, "granularity", "message") == "leaf":
        return _mix_compressed_leaf(node_params, residuals, w, live, quant)
    return _mix_compressed_message(node_params, residuals, w, live, quant)


def _compress_and_mix(flat: torch.Tensor, res: torch.Tensor,
                      w: torch.Tensor, live: torch.Tensor,
                      quant) -> tuple[torch.Tensor, torch.Tensor]:
    """One (n, L) fp32 buffer through the wire: returns the mixed buffer
    ``diag(W) * flat + W_off @ deq(Q(flat + res))`` and the new residual."""
    carried = flat + res if quant.error_feedback else flat
    diag = torch.diagonal(w)
    off = w - torch.diag(diag)
    if quant.mode == "bf16":
        deq = carried.to(torch.bfloat16).to(torch.float32)
        mixed = gossip_mix_rows(torch.cat([torch.diag(diag), off], dim=1),
                                torch.cat([flat, deq], dim=0))
    elif quant.mode == "int8":
        q, scale = quantize_int8_rows(carried)
        deq = dequantize_int8_rows(q, scale, carried.shape[1])
        mixed = gossip_mix_q8_rows(diag, off, flat, q, scale)
    else:
        raise ValueError(f"unknown compression mode {quant.mode!r}")
    new_res = carried - deq if quant.error_feedback else res
    new_res = torch.where(live[:, None], new_res,
                          torch.zeros((), dtype=new_res.dtype,
                                      device=new_res.device))
    return mixed, new_res


def _mix_compressed_message(
    node_params: PyTree,
    residuals: PyTree,
    w: torch.Tensor,
    live: torch.Tensor,
    quant,
) -> tuple[PyTree, PyTree]:
    """Concat-flat wire format: one quantized buffer per node per round."""
    leaves = _leaves(node_params)
    res_leaves = _leaves(residuals)
    n = leaves[0].shape[0]
    flat = torch.cat([p.reshape(n, -1).to(torch.float32) for p in leaves],
                     dim=1)
    res = torch.cat([r.reshape(n, -1) for r in res_leaves], dim=1)
    mixed, new_res = _compress_and_mix(flat, res, w, live, quant)

    out, res_out, offset = [], [], 0
    for p in leaves:
        size = p[0].numel()
        out.append(mixed[:, offset:offset + size]
                   .reshape(p.shape).to(p.dtype))
        res_out.append(new_res[:, offset:offset + size].reshape(p.shape))
        offset += size
    return _unflatten(node_params, out), _unflatten(node_params, res_out)


def _mix_compressed_leaf(
    node_params: PyTree,
    residuals: PyTree,
    w: torch.Tensor,
    live: torch.Tensor,
    quant,
) -> tuple[PyTree, PyTree]:
    """Per-tensor wire format: each leaf quantizes with its own block grid
    and carries its own error-feedback residual (one kernel launch per
    leaf)."""
    def _one(p: torch.Tensor, r: torch.Tensor):
        n = p.shape[0]
        mixed, new_res = _compress_and_mix(
            p.reshape(n, -1).to(torch.float32), r.reshape(n, -1), w, live,
            quant)
        return mixed.reshape(p.shape).to(p.dtype), new_res.reshape(p.shape)

    pairs = [_one(p, r) for p, r in zip(_leaves(node_params),
                                        _leaves(residuals))]
    return (_unflatten(node_params, [m for m, _ in pairs]),
            _unflatten(node_params, [e for _, e in pairs]))


def dpsgd_masked_compressed_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    node_params: PyTree,
    node_batches: PyTree,
    w,
    live,
    residuals: PyTree,
    quant,
    config: DPSGDConfig = DPSGDConfig(),
) -> tuple[PyTree, PyTree, torch.Tensor]:
    """``dpsgd_masked_step`` with quantized error-feedback mixing.

    ``quant`` is a ``compression.QuantConfig``; every sender quantizes once
    per round, the self term stays exact, and per-node residuals ride along
    as explicit state — pass ``zero_residuals(node_params)`` at round 0 and
    thread the returned residuals through. Dead nodes keep their parameters
    verbatim and their residuals zeroed. With ``quant.mode == "none"`` this
    is exactly ``dpsgd_masked_step`` plus an untouched residual
    pass-through.

    Returns ``(new_params, new_residuals, losses)``. ``quant`` has no
    default on purpose: ``QuantConfig()``'s own default mode is the lossy
    ``"int8"``.
    """
    if config.local_steps != 1:
        raise NotImplementedError(
            "dpsgd_masked_compressed_step supports local_steps == 1 only")
    live = _as_live(live, _device_of(node_params))
    losses, grads = _node_grads(loss_fn, node_params, node_batches)
    grads = _mask_grads(grads, live)
    if config.mix_first:
        mixed, new_res = _mix_compressed(node_params, residuals, w, live,
                                         quant)
        new_params = _sgd(mixed, grads, config.eta)
    else:
        new_params, new_res = _mix_compressed(
            _sgd(node_params, grads, config.eta), residuals, w, live, quant)
    return new_params, new_res, losses


def make_dpsgd_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    config: DPSGDConfig = DPSGDConfig(),
) -> GraphedStep:
    """Bind loss_fn/config once; returns (params, batches, W) -> step, a
    CUDA graph per input signature on the card (``GraphedStep``)."""
    def step(node_params, node_batches, w):
        return dpsgd_step(loss_fn, node_params, node_batches, w, config)
    return GraphedStep(step)


def make_dpsgd_masked_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    config: DPSGDConfig = DPSGDConfig(),
) -> GraphedStep:
    """Bind loss_fn/config once; returns
    ``(params, batches, w, live) -> (params, losses)``, graphed on the
    card."""
    def step(node_params, node_batches, w, live):
        return dpsgd_masked_step(loss_fn, node_params, node_batches, w, live,
                                 config)
    return GraphedStep(step)


def make_dpsgd_compressed_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    quant,
    config: DPSGDConfig = DPSGDConfig(),
) -> GraphedStep:
    """Bind (loss_fn, quant, config) once; returns
    ``(params, batches, w, live, residuals) -> (params, residuals, losses)``,
    graphed on the card."""
    def step(node_params, node_batches, w, live, residuals):
        return dpsgd_masked_compressed_step(
            loss_fn, node_params, node_batches, w, live, residuals, quant,
            config)
    return GraphedStep(step)
