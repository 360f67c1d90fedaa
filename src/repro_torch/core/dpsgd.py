"""D-PSGD optimizer (paper Algorithm 1 / Eq. 5) — wireless-faithful simulation.

State layout: every parameter leaf carries a leading **node axis** of size n
(``X = (x_1 .. x_n)`` stacked), mirroring Eq. 5:

    X_{k+1} <- W @ X_k  -  eta * stack_i( grad F_i(x_{k,i}; xi_{k,i}) )

One step = (a) per-node minibatch gradients via ``torch.func.vmap`` over the
node axis, (b) mixing with the averaging matrix W, (c) SGD update. The
wall-clock communication cost is modeled separately by
``comm_model.tdm_time_s`` (measured compute + Eq. 3, as the paper does).

The torch counterpart of ``repro.core.dpsgd``. Parameters are trees of
dicts, lists and tuples of tensors (the transformer's layer groups are
lists); leaves are visited in ``jax.tree``'s order, dict keys sorted and
list items in order, so the concatenated message buffer has the same
layout (and the int8 block grid the same blocks) as the JAX package's.

The mix is lowered onto the hand-written kernels of ``kernels.gossip_mix``
(CUDA on an sm_90 card, their plain torch versions on the CPU):

* ``mix`` — one ``gossip_mix_rows`` launch per step over the leaves
  concatenated into one (n, total) buffer per dtype (the CNN: one launch
  over (6, 21 840)); element for element the same arithmetic as mixing
  each leaf on its own. A large model's leaves go in buffers of at most
  ``MIX_CONCAT_LANES`` lanes (stablelm-3b at 1 layer: 9 launches, its
  large weights mixed where they lie).
* the int8 round of ``_mix_compressed_*`` — ``gossip_mix_int8_round``,
  two launches back to back: the send, ``kernels.quantize.
  quantize_int8_ef`` (the quantize of ``flat + res`` in the wire format's
  2048-lane blocks and the new error-feedback residual, dead rows zeroed,
  in one kernel), then the receive, ``gossip_mix_q8_w`` (W taken whole:
  exact fp32 self term on its diagonal, int8 neighbor payloads
  dequantized in the kernel), launched as a programmatic dependent of
  the send.
* the bf16 receive — one ``gossip_mix_rows`` launch with
  ``W_cat = [diag(diag(W)) | W_off]`` (n, 2n) over the stacked fp32
  buffers ``[flat; deq]`` (2n, N): the self term exact, the neighbor terms
  the bf16-rounded payloads.

Also supports ``local_steps`` H >= 1 (Cooperative-SGD generalization; H=1 ==
paper) and arbitrary W (row-stochastic, Metropolis, fully-connected).

With ``group`` (a fleet's process group) the node axis of the state is
this rank's block (``core.gossip.node_block``) and W stays whole (n, n):
the mix ``all_gather``s each buffer's rows over the fleet (for int8, the
send's payloads and scales; for bf16, the messages) and runs the rank's
rows of W through the same rows-mix or q8 launch. Each output row is the
kernel's in-order sum over the same columns, so a rank's rows are
bit-equal to the one-device mix's (train-on-trace's sharded family,
``sim.batch``).

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
from ..kernels import quantize as _qz
from ..kernels.gossip_mix import (gossip_mix_int8_round, gossip_mix_q8_rows,
                                  gossip_mix_rows)
from .gossip import all_gather_nodes, node_block

__all__ = ["DPSGDConfig", "replicate", "mix", "dpsgd_step", "make_dpsgd_step",
           "dpsgd_masked_step", "make_dpsgd_masked_step",
           "dpsgd_masked_compressed_step",
           "make_dpsgd_compressed_step", "embed_w", "zero_residuals",
           "node_axis_size", "receive_exact_self", "receive_q8_block",
           "receive_bf16_block"]

PyTree = Any


# ---------------------------------------------------------------------------
# Trees of dicts, lists and tuples, leaves in jax.tree's order: dict keys
# sorted, list and tuple items in order
# ---------------------------------------------------------------------------

def _paths(tree: PyTree, path: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _paths(item, f"{path}[{i}]")
    else:
        yield path, tree


def _leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in _paths(tree)]


def _build(t: PyTree, it: Iterator) -> PyTree:
    # module level: a nested function calling itself would be a reference
    # cycle holding the leaves until the next garbage collection
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(item, it) for item in t)
    return next(it)


def _unflatten(like: PyTree, leaves: list) -> PyTree:
    """Rebuild ``like``'s structure from leaves in ``_paths`` order."""
    return _build(like, iter(leaves))


def _tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, item, *(r[i] for r in rest))
                          for i, item in enumerate(tree))
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


MIX_CONCAT_LANES = 1 << 24   # lanes a node's row of one rows-mix buffer holds


def mix_groups(sizes: list) -> list:
    """Leaves (by per-node size, in order) grouped for one rows-mix launch
    each: consecutive leaves while the group holds at most
    ``MIX_CONCAT_LANES`` lanes a node; a leaf of that size or more alone.
    The CNN's 21 840 lanes are one group."""
    groups: list = []
    lanes = 0
    for i, size in enumerate(sizes):
        if groups and lanes + size <= MIX_CONCAT_LANES:
            groups[-1].append(i)
            lanes += size
        else:
            groups.append([i])
            lanes = size
    return groups


def mix(node_params: PyTree, w, group=None) -> PyTree:
    """X <- W @ X on the leading node axis of every leaf.

    Leaves of one dtype are concatenated into (n, total) buffers of at most
    ``MIX_CONCAT_LANES`` lanes a node (``mix_groups``; a larger leaf is its
    own buffer, a view with no copy), each mixed by one
    ``gossip_mix_rows`` launch: element for element the arithmetic of
    mixing each leaf on its own, without a concatenated copy of a large
    model (8 GB at six replicas of 0.34 B parameters). W is cast to the
    leaves' dtype first, as the reference's ``w.astype(flat.dtype)`` does.
    The mixed leaves are views into the output buffers. With ``group``
    and a node-blocked tree, each buffer's rows are gathered over the
    fleet and the rank's rows of W run over them."""
    leaves = _leaves(node_params)
    n = leaves[0].shape[0]
    w = _as_w(w, leaves[0].device)
    lo, sharded = 0, False
    if group is not None:
        lo, _, sharded = node_block(leaves[0], w.shape[-1], group)
    w_rows = w[lo:lo + n] if sharded else w
    out: list = [None] * len(leaves)
    for dtype in dict.fromkeys(p.dtype for p in leaves):
        idx = [i for i, p in enumerate(leaves) if p.dtype == dtype]
        for grp in mix_groups([leaves[i][0].numel() for i in idx]):
            members = [idx[j] for j in grp]
            rows = [leaves[i].reshape(n, -1) for i in members]
            flat = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
            if sharded:
                flat = all_gather_nodes(flat, w.shape[-1], group)
            mixed = gossip_mix_rows(w_rows.to(dtype), flat)
            offset = 0
            for i in members:
                size = leaves[i][0].numel()
                out[i] = mixed[:, offset:offset + size].reshape(
                    leaves[i].shape)
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


def _sgd_mixed(mixed: PyTree, grads: PyTree, eta: float) -> PyTree:
    """``_sgd`` in place on the mix's output, which this step made: the
    same arithmetic (x - eta g), bit for bit, without a further
    node-stacked copy of the parameters (8 GB at six replicas of a
    0.34 B-parameter model)."""
    for x, g in zip(_leaves(mixed), _leaves(grads)):
        x.sub_(eta * g.to(x.dtype))
    return mixed


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
            new_params = _sgd_mixed(mix(node_params, w), grads, config.eta)
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
    group=None,
) -> tuple[PyTree, torch.Tensor]:
    """One D-PSGD iteration on a fixed-width node state under churn.

    ``live`` is a (n,) bool mask; ``w`` must follow the ``embed_w`` contract
    (identity rows / zero columns for dead nodes). Dead rows carry their
    parameters unchanged and never contribute to live rows. Returned
    per-node losses are raw; mask with ``live`` before aggregating.

    Only ``local_steps == 1`` is supported. With ``group`` the state,
    batch and ``live`` are this rank's block of nodes, W whole.
    """
    if config.local_steps != 1:
        raise NotImplementedError(
            "dpsgd_masked_step supports local_steps == 1 only")
    live = _as_live(live, _device_of(node_params))
    losses, grads = _node_grads(loss_fn, node_params, node_batches)
    grads = _mask_grads(grads, live)
    if config.mix_first:
        new_params = _sgd_mixed(mix(node_params, w, group), grads,
                                config.eta)
    else:
        new_params = mix(_sgd(node_params, grads, config.eta), w, group)
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
    group=None,
    whole=None,
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

    ``whole`` (``(gather, shard)``, for leaves that are a rank's shards
    over a model axis): the message is quantized on the whole leaves, as
    one device quantizes it, and ``shard`` takes the rank's part of the
    mixed values and residuals back.
    """
    if quant.mode == "none":
        return mix(node_params, w, group), residuals
    if whole is not None:
        gather, shard = whole
        mixed, res = _mix_compressed(gather(node_params), gather(residuals),
                                     w, live, quant, group)
        return shard(mixed), shard(res)
    n = node_axis_size(node_params, "node_params")
    device = _device_of(node_params)
    w = _as_w(w, device)
    live = _as_live(live, device)
    lo, sharded = 0, False
    if group is not None and w.shape[-1] != n:
        lo, _, sharded = node_block(_leaves(node_params)[0], w.shape[-1],
                                    group)
    if live.shape[0] != n or w.shape[0] != w.shape[-1] or \
            (w.shape[-1] != n and not sharded):
        raise ValueError(
            f"live {tuple(live.shape)} / w {tuple(w.shape)} disagree with "
            f"the node axis n={n} of node_params")
    fleet = (group, lo) if sharded else None
    if getattr(quant, "granularity", "message") == "leaf":
        return _mix_compressed_leaf(node_params, residuals, w, live, quant,
                                    fleet)
    return _mix_compressed_message(node_params, residuals, w, live, quant,
                                   fleet)


def receive_exact_self(w: torch.Tensor, flat: torch.Tensor,
                       deq: torch.Tensor) -> torch.Tensor:
    """``diag(W) * flat + W_off @ deq`` for (n, L) fp32 buffers: one
    ``gossip_mix_rows`` launch with ``W_cat = [diag(diag(W)) | W_off]``
    (n, 2n) over the stacked ``[flat; deq]`` (2n, L), the self term exact,
    the neighbor terms the received payloads."""
    diag = torch.diag(torch.diagonal(w))
    return gossip_mix_rows(torch.cat([diag, w - diag], dim=1),
                           torch.cat([flat, deq], dim=0))


def _self_and_off(w: torch.Tensor, lo: int, b: int):
    """(W's diagonal (b,), the rank's rows of W_off (b, n)) for the rank's
    block of ``b`` rows at row ``lo``."""
    rows = w[lo:lo + b]
    w_self = torch.diagonal(w)[lo:lo + b]
    diag = torch.zeros_like(rows)
    diag[:, lo:lo + b] = torch.diag(w_self)
    return w_self, rows - diag


def receive_q8_block(w: torch.Tensor, lo: int, flat: torch.Tensor,
                     q_all: torch.Tensor,
                     scales_all: torch.Tensor) -> torch.Tensor:
    """The int8 receive half for the rank's (b, L) fp32 block at row ``lo``
    of W (n, n): W's diagonal times ``flat`` exact, the rank's rows of
    W_off over every node's payload ``q_all`` (n, Lp) and ``scales_all``
    (the fleet's gathered sends), one ``gossip_mix_q8_rows`` launch (as
    ``gossip_mix_q8_w`` reads W, 0 at the rank's own payloads)."""
    w_self, off = _self_and_off(w, lo, flat.shape[0])
    return gossip_mix_q8_rows(w_self, off, flat, q_all, scales_all)


def receive_bf16_block(w: torch.Tensor, lo: int, flat: torch.Tensor,
                       msg_all: torch.Tensor) -> torch.Tensor:
    """The bf16 receive half for the rank's block: the rank's rows of
    ``W_cat = [diag(diag W) | W_off]`` over ``[flat; msg_all]`` (every
    node's gathered bf16 message, in fp32), one ``gossip_mix_rows``
    launch."""
    w_self, off = _self_and_off(w, lo, flat.shape[0])
    return gossip_mix_rows(torch.cat([torch.diag(w_self), off], dim=1),
                           torch.cat([flat, msg_all.to(torch.float32)],
                                     dim=0))


def _compress_and_mix_fleet(flat: torch.Tensor, res: torch.Tensor,
                            w: torch.Tensor, live: torch.Tensor, quant,
                            fleet: tuple) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``_compress_and_mix`` for the rank's (b, L) block at row ``lo`` of
    the fleet (``fleet`` = (group, lo)), W whole (n, n): the send on the
    block, the payloads gathered, the receive half
    (``receive_q8_block`` / ``receive_bf16_block``)."""
    group, lo = fleet
    n = w.shape[-1]
    if quant.mode == "int8":
        q, scales, new_res = _qz.quantize_int8_ef(flat, res, live,
                                                  quant.error_feedback)
        return receive_q8_block(w, lo, flat, all_gather_nodes(q, n, group),
                                all_gather_nodes(scales, n, group)), new_res
    if quant.mode != "bf16":
        raise ValueError(f"unknown compression mode {quant.mode!r}")
    carried = flat + res if quant.error_feedback else flat
    mixed = receive_bf16_block(w, lo, flat, all_gather_nodes(
        carried.to(torch.bfloat16), n, group))
    deq = carried.to(torch.bfloat16).to(torch.float32)
    new_res = carried - deq if quant.error_feedback else res
    new_res = torch.where(live[:, None], new_res,
                          torch.zeros((), dtype=new_res.dtype,
                                      device=new_res.device))
    return mixed, new_res


def _compress_and_mix(flat: torch.Tensor, res: torch.Tensor,
                      w: torch.Tensor, live: torch.Tensor,
                      quant) -> tuple[torch.Tensor, torch.Tensor]:
    """One (n, L) fp32 buffer through the wire: returns the mixed buffer
    ``diag(W) * flat + W_off @ deq(Q(flat + res))`` and the new residual."""
    if quant.mode == "int8":
        return gossip_mix_int8_round(flat, res, w, live, quant.error_feedback)
    if quant.mode != "bf16":
        raise ValueError(f"unknown compression mode {quant.mode!r}")
    carried = flat + res if quant.error_feedback else flat
    deq = carried.to(torch.bfloat16).to(torch.float32)
    mixed = receive_exact_self(w, flat, deq)
    new_res = carried - deq if quant.error_feedback else res
    new_res = torch.where(live[:, None], new_res,
                          torch.zeros((), dtype=new_res.dtype,
                                      device=new_res.device))
    return mixed, new_res


def _wire(flat, res, w, live, quant, fleet):
    """``_compress_and_mix``, or its fleet form for a rank's block."""
    if fleet is None:
        return _compress_and_mix(flat, res, w, live, quant)
    return _compress_and_mix_fleet(flat, res, w, live, quant, fleet)


def _mix_compressed_message(
    node_params: PyTree,
    residuals: PyTree,
    w: torch.Tensor,
    live: torch.Tensor,
    quant,
    fleet: tuple | None = None,
) -> tuple[PyTree, PyTree]:
    """Concat-flat wire format: one quantized buffer per node per round."""
    leaves = _leaves(node_params)
    res_leaves = _leaves(residuals)
    n = leaves[0].shape[0]
    flat = torch.cat([p.reshape(n, -1).to(torch.float32) for p in leaves],
                     dim=1)
    res = torch.cat([r.reshape(n, -1) for r in res_leaves], dim=1)
    mixed, new_res = _wire(flat, res, w, live, quant, fleet)

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
    fleet: tuple | None = None,
) -> tuple[PyTree, PyTree]:
    """Per-tensor wire format: each leaf quantizes with its own block grid
    and carries its own error-feedback residual (one kernel launch per
    leaf)."""
    def _one(p: torch.Tensor, r: torch.Tensor):
        n = p.shape[0]
        mixed, new_res = _wire(
            p.reshape(n, -1).to(torch.float32), r.reshape(n, -1), w, live,
            quant, fleet)
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
    group=None,
    whole=None,
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
    ``"int8"``. ``whole``: see ``_mix_compressed``.
    """
    if config.local_steps != 1:
        raise NotImplementedError(
            "dpsgd_masked_compressed_step supports local_steps == 1 only")
    live = _as_live(live, _device_of(node_params))
    losses, grads = _node_grads(loss_fn, node_params, node_batches)
    grads = _mask_grads(grads, live)
    if config.mix_first:
        mixed, new_res = _mix_compressed(node_params, residuals, w, live,
                                         quant, group, whole)
        new_params = _sgd_mixed(mixed, grads, config.eta)
    else:
        new_params, new_res = _mix_compressed(
            _sgd(node_params, grads, config.eta), residuals, w, live, quant,
            group, whole)
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
