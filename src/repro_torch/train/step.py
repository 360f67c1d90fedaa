"""Train-step builders — the paper's technique at pod scale.

The torch counterpart of ``repro.train.step``.

Mode A ``allreduce``: fully-synchronized data parallelism (the paper's
baseline, W = 11^T/n): one replica, ``grad_and_value`` of the model's loss
over the global batch.

Mode B ``dpsgd``: every node owns its own parameters — all state trees carry
a leading **node axis** — and one step is Eq. 5:

    X_{k+1} = W X_k - eta * stack_i(grad F_i(x_{k,i}; xi_i))

with the gradients of all nodes in one ``torch.func.vmap`` over the node
axis. The reference realises ``W X`` by rolls over the node-sharded axis
(``roll_from_neighbor``, kept here and tested bit-equal); with the node axis
whole on one device the mix is the rows-mix kernel over the plan's W
(``core.dpsgd.mix(params, plan_w(plan))``, one launch per buffer group),
the same sum the rolls make. The ``allreduce`` plan is the node mean,
broadcast. Compressed gossip (bf16 / int8 messages with error feedback)
quantizes each leaf as the reference does (int8: one scale per last-dim
row) and receives each buffer group in one rows-mix launch over
``[x; deq]`` with ``W_cat = [diag(diag W) | W_off]``: the self term exact,
the neighbours the rounded payloads.

Over a ``torch.distributed`` fleet (``group``, the fleet axis's process
group) each rank holds a block of ``n / fleet`` nodes on the node axis of
every state tree and its nodes' batch rows (``train.shardings``). The
rank takes its gradients with the same ``vmap``; the rolls become P2P of
the rows that cross ranks, realised as ``core.gossip.fetch_rows``: the
rank fetches the rows its lines of ``plan_w`` reach (its own copied) —
fp32 / bf16 rows, or the int8 payloads (int8 plus the fp32 row scales)
and bf16 messages, dequantized on arrival as the sender dequantizes its
own — and its rows of W (of ``W_cat`` when compressed) run over them in
the same rows-mix launches. Dropping the columns W leaves at 0 removes
only exact zero terms of the kernel's in-order fp32 sum, so every rank's
rows are bit-equal to the one-device mix's. The node mean and the loss's
mean are ``all_reduce`` / ``all_gather``; Mode A all-reduces the
gradients of each rank's share of the batch. A fleet of one, or a node
axis that does not divide over the fleet, runs the one-device path.

Under tensor parallelism (``model``, a ``models.tp.Model`` of the rank's
``model`` axis, with ``specs`` the parameters' spec tree) every state
leaf is the rank's shard (``train.shardings.shard_model``); the loss runs
on the shards (``models.tp``), the mixes and the node mean run over the
fleet group on the shards as they are (each is elementwise over a
leaf's lanes), the int8 message's row max is taken over the model group
where a leaf's last dim is split (its scale is the whole row's, as on
the JAX package's global array), and a gradient clip's norm sums the
split leaves over the model group.

The returned step is a plain function, as the reference's; the caller
makes it a ``graphs.GraphedStep`` (the counterpart of ``jax.jit``) where it
fits, as ``launch.train`` does.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import RunConfig
from ..core import dpsgd
from ..core.gossip import (GossipPlan, GossipRound, _fleet, fetch_rows,
                           node_block, node_mean, plan_w)
from ..kernels.gossip_mix import gossip_mix_rows
from ..models import tp
from ..models.api import ModelAPI
from ..optim import make_optimizer

PyTree = Any

__all__ = ["roll_from_neighbor", "mix_params", "make_train_step",
           "init_train_state", "reshape_batch_for_nodes"]


# ---------------------------------------------------------------------------
# Gossip over the leading node axis
# ---------------------------------------------------------------------------

def roll_from_neighbor(x: torch.Tensor, plan: GossipPlan,
                       r: GossipRound) -> torch.Tensor:
    """Value each node receives in round ``r``: out[i] = x[src_r(i)]."""
    n = plan.n_nodes
    if r.kind == "shift":
        return torch.roll(x, r.arg[0], dims=0)
    if r.kind == "axshift":
        axis, s = r.arg
        xr = x.reshape(*plan.node_shape, *x.shape[1:])
        return torch.roll(xr, s, dims=axis).reshape(x.shape)
    if r.kind == "xor":
        lo = 1 << r.arg[0]
        xr = x.reshape(n // (2 * lo), 2, lo, *x.shape[1:])
        return torch.flip(xr, dims=(1,)).reshape(x.shape)
    raise ValueError(r.kind)


def _node_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=0, keepdim=True).expand(x.shape)


def _quantize_rowwise_int8(x: torch.Tensor, model: tp.Model = tp.ONE
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fp32 scale per last-dim row: scale = max|x| / 127 (0 -> 1),
    q = clip(round(x / scale), ±127). Divided by tensors (bit-equal to
    IEEE division on the card too). ``model`` (active): the last dim is
    the rank's shard of the row, whose max is taken over the ranks."""
    amax = tp.all_max(torch.amax(torch.abs(x), dim=-1, keepdim=True), model)
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _message(carried: torch.Tensor, mode: str,
             model: tp.Model = tp.ONE) -> torch.Tensor:
    """The payload a node sends, dequantized to fp32."""
    if mode == "bf16":
        return carried.to(torch.bfloat16).to(torch.float32)
    if mode == "int8":
        q, scale = _quantize_rowwise_int8(carried, model)
        return q.to(torch.float32) * scale
    raise ValueError(mode)


def _plan_w(plan: GossipPlan, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(plan_w(plan), dtype=torch.float32, device=device)


def _mix_compressed(params: PyTree, residuals: PyTree, w: torch.Tensor,
                    mode: str, rows_split: Optional[list] = None
                    ) -> tuple[PyTree, PyTree]:
    """Error-feedback compressed gossip over every leaf.

    message m_i = Q(x_i + e_i);  e_i' = (x_i + e_i) - m_i
    x_i' = W_ii x_i + sum_j W_ij m_j   (self exact, neighbours compressed).

    Leaves of a dtype go in the buffer groups of ``dpsgd.mix``; each group
    is received by one rows-mix launch (``dpsgd.receive_exact_self``).
    ``rows_split``: per leaf, the ``models.tp.Model`` its last dim is
    split over (its int8 rows' max taken over it)."""
    leaves = dpsgd._leaves(params)
    res_leaves = dpsgd._leaves(residuals)
    rows_split = rows_split or [tp.ONE] * len(leaves)
    n = leaves[0].shape[0]
    out: list = [None] * len(leaves)
    res_out: list = [None] * len(leaves)
    for dtype in dict.fromkeys(p.dtype for p in leaves):
        idx = [i for i, p in enumerate(leaves) if p.dtype == dtype]
        for group in dpsgd.mix_groups([leaves[i][0].numel() for i in idx]):
            members = [idx[j] for j in group]
            x32, deq = [], []
            for i in members:
                x = leaves[i].reshape(n, -1).to(torch.float32)
                carried = x + res_leaves[i].reshape(n, -1).to(torch.float32)
                d = _message(carried.reshape(leaves[i].shape), mode,
                             rows_split[i])
                d = d.reshape(n, -1)
                res_out[i] = (carried - d).reshape(leaves[i].shape).to(
                    res_leaves[i].dtype)
                x32.append(x)
                deq.append(d)
            mixed = dpsgd.receive_exact_self(w, _cat_lanes(x32),
                                             _cat_lanes(deq))
            offset = 0
            for i in members:
                size = leaves[i][0].numel()
                out[i] = mixed[:, offset:offset + size].reshape(
                    leaves[i].shape).to(leaves[i].dtype)
                offset += size
    return dpsgd._unflatten(params, out), dpsgd._unflatten(params, res_out)


def _cat_lanes(rows: list) -> torch.Tensor:
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


def _cols_of(w: np.ndarray, n: int, size: int) -> list:
    """Per fleet index, the sorted node ids its rows of ``w`` reach."""
    b = n // size
    return [np.flatnonzero(np.any(w[p * b:(p + 1) * b] != 0, axis=0))
            for p in range(size)]


# (plan, fleet size, index, device, which) -> the rank's rows of W over
# the columns it fetches, made on a step's first (eager) run: a
# host-to-device copy cannot be captured into a CUDA graph
_FLEET_ROWS: dict = {}


def _rows_of(key: tuple, w: torch.Tensor, lo: int, b: int,
             cols) -> torch.Tensor:
    rows = _FLEET_ROWS.get(key)
    if rows is None:
        idx = torch.as_tensor(np.asarray(cols, dtype=np.int64),
                              device=w.device)
        rows = _FLEET_ROWS[key] = w[lo:lo + b].index_select(1, idx)
    return rows


def _mix_fleet(params: PyTree, w: torch.Tensor, plan: GossipPlan,
               group) -> PyTree:
    """``dpsgd.mix`` for the rank's block: each buffer group's rows the
    rank's lines of W reach fetched from the fleet, the rank's rows of W
    (cast to the leaves' dtype, as ``dpsgd.mix`` casts it) over them."""
    leaves = dpsgd._leaves(params)
    n = plan.n_nodes
    size, index = _fleet(group)
    b = n // size
    lo = index * b
    cols_of = _cols_of(plan_w(plan), n, size)
    w_rows = _rows_of((plan, size, index, str(w.device), "w"), w, lo, b,
                      cols_of[index])
    out: list = [None] * len(leaves)
    for dtype in dict.fromkeys(p.dtype for p in leaves):
        idx = [i for i, p in enumerate(leaves) if p.dtype == dtype]
        for grp in dpsgd.mix_groups([leaves[i][0].numel() for i in idx]):
            members = [idx[j] for j in grp]
            flat = _cat_lanes([leaves[i].reshape(b, -1) for i in members])
            bufs = fetch_rows([flat], cols_of, n, group)[0]
            mixed = gossip_mix_rows(w_rows.to(dtype), bufs)
            del bufs
            offset = 0
            for i in members:
                size_i = leaves[i][0].numel()
                out[i] = mixed[:, offset:offset + size_i].reshape(
                    leaves[i].shape)
                offset += size_i
    return dpsgd._unflatten(params, out)


def _mix_compressed_fleet(params: PyTree, residuals: PyTree,
                          w: torch.Tensor, plan: GossipPlan, group,
                          mode: str, rows_split: Optional[list] = None
                          ) -> tuple[PyTree, PyTree]:
    """``_mix_compressed`` for the rank's block: each node's message made
    where the node lives, the messages its rows of W_off reach fetched as
    they travel (bf16; int8 plus the fp32 row scales) and dequantized
    here, then the rank's rows of ``W_cat`` over ``[x; deq]``."""
    leaves = dpsgd._leaves(params)
    res_leaves = dpsgd._leaves(residuals)
    rows_split = rows_split or [tp.ONE] * len(leaves)
    n = plan.n_nodes
    size, index = _fleet(group)
    b = n // size
    lo = index * b
    w_np = plan_w(plan)
    w_off = w_np - np.diag(np.diag(w_np))
    cols_of = _cols_of(w_off, n, size)
    key = (plan, size, index, str(w.device), "w_cat")
    w_rows = _FLEET_ROWS.get(key)
    if w_rows is None:
        diag = torch.diag(torch.diagonal(w))
        keep = list(range(lo, lo + b)) + [n + int(j) for j in cols_of[index]]
        w_rows = _rows_of(key, torch.cat([diag, w - diag], dim=1), lo, b,
                          keep)
    out: list = [None] * len(leaves)
    res_out: list = [None] * len(leaves)
    for dtype in dict.fromkeys(p.dtype for p in leaves):
        idx = [i for i, p in enumerate(leaves) if p.dtype == dtype]
        for grp in dpsgd.mix_groups([leaves[i][0].numel() for i in idx]):
            members = [idx[j] for j in grp]
            x32, wire, scales = [], [], []
            for i in members:
                if leaves[i].dim() < 2:
                    raise ValueError(
                        "a node-stacked leaf needs a per-node dim for its "
                        f"message's row scales, got {tuple(leaves[i].shape)}")
                x = leaves[i].reshape(b, -1).to(torch.float32)
                carried = x + res_leaves[i].reshape(b, -1).to(torch.float32)
                if mode == "bf16":
                    msg = carried.to(torch.bfloat16)
                    d = msg.to(torch.float32)
                elif mode == "int8":
                    q, scale = _quantize_rowwise_int8(
                        carried.reshape(leaves[i].shape), rows_split[i])
                    d = (q.to(torch.float32) * scale).reshape(b, -1)
                    msg = q.reshape(b, -1)
                    scales.append(scale.reshape(b, -1))
                else:
                    raise ValueError(mode)
                res_out[i] = (carried - d).reshape(leaves[i].shape).to(
                    res_leaves[i].dtype)
                x32.append(x)
                wire.append(msg)
            wire_t = [_cat_lanes(wire)] + ([_cat_lanes(scales)]
                                           if scales else [])
            got = fetch_rows(wire_t, cols_of, n, group)
            m = got[0].shape[0]
            if mode == "bf16":
                deq = got[0].to(torch.float32)
            else:
                parts, offset, s_off = [], 0, 0
                for i in members:
                    shape = leaves[i].shape[1:]
                    size_i = leaves[i][0].numel()
                    rows = size_i // shape[-1]
                    q = got[0][:, offset:offset + size_i].reshape(m, *shape)
                    s = got[1][:, s_off:s_off + rows].reshape(
                        m, *shape[:-1], 1)
                    parts.append((q.to(torch.float32) * s).reshape(m, -1))
                    offset += size_i
                    s_off += rows
                deq = _cat_lanes(parts)
            del got
            mixed = gossip_mix_rows(
                w_rows, torch.cat([_cat_lanes(x32), deq], dim=0))
            offset = 0
            for i in members:
                size_i = leaves[i][0].numel()
                out[i] = mixed[:, offset:offset + size_i].reshape(
                    leaves[i].shape).to(leaves[i].dtype)
                offset += size_i
    return dpsgd._unflatten(params, out), dpsgd._unflatten(params, res_out)


def mix_params(params: PyTree, residuals: Optional[PyTree],
               plan: GossipPlan, run: RunConfig,
               w: Optional[torch.Tensor] = None, group=None,
               rows_split: Optional[list] = None
               ) -> tuple[PyTree, Optional[PyTree]]:
    """Mix every node-stacked leaf by the plan: the node mean for an
    ``allreduce`` plan, else the rows-mix kernel over ``plan_w(plan)``
    (uncompressed) or the error-feedback compressed receive; residuals
    pass through untouched when nothing is compressed. ``w`` is the plan's
    W as an fp32 tensor on the parameters' device; a step of
    ``make_train_step`` passes one made before any CUDA graph capture (a
    host-to-device copy cannot be captured), None makes it here.
    ``rows_split``: per leaf, the model axis its last dim is split over
    (tensor parallelism: the int8 rows' max over it)."""
    first = dpsgd._leaves(params)[0]
    _, _, sharded = node_block(first, plan.n_nodes, group)
    if plan.kind == "allreduce":
        if sharded:
            return dpsgd._tree_map(
                lambda x: node_mean(x, plan.n_nodes, group), params), \
                residuals
        return dpsgd._tree_map(_node_mean, params), residuals
    if w is None:
        w = _plan_w(plan, first.device)
    if sharded:
        if run.compression == "none":
            return _mix_fleet(params, w, plan, group), residuals
        return _mix_compressed_fleet(params, residuals, w, plan, group,
                                     run.compression, rows_split)
    if run.compression == "none":
        return dpsgd.mix(params, w), residuals
    return _mix_compressed(params, residuals, w, run.compression,
                           rows_split)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def reshape_batch_for_nodes(batch: PyTree, n_nodes: int) -> PyTree:
    """(B, ...) -> (n_nodes, B/n_nodes, ...) on every batch leaf."""
    return dpsgd._tree_map(
        lambda x: x.reshape(n_nodes, x.shape[0] // n_nodes, *x.shape[1:]),
        batch)


def _grads_fn(api: ModelAPI, run: RunConfig) -> Callable:
    """(params, batch) -> (grads, loss) of the loss under ``run.remat``
    (``models.remat``), with optional microbatch gradient accumulation in
    the reference's order (fp32 zeros, ``acc + l``, ``acc_g + g`` chunk by
    chunk, then ``/ mb``)."""
    value_and_grad = torch.func.grad_and_value(
        lambda params, batch: api.loss(params, batch, remat=run.remat))
    if not (run.microbatch and run.microbatch > 1):
        return value_and_grad
    mb = run.microbatch

    def gfn(params, batch):
        split = dpsgd._tree_map(
            lambda x: x.reshape(mb, x.shape[0] // mb, *x.shape[1:]), batch)
        device = dpsgd._leaves(params)[0].device
        acc_l = torch.zeros((), dtype=torch.float32, device=device)
        acc_g = dpsgd._tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=device), params)
        for i in range(mb):
            g, l = value_and_grad(params,
                                  dpsgd._tree_map(lambda x: x[i], split))
            acc_l = acc_l + l
            acc_g = dpsgd._tree_map(torch.add, acc_g, g)
        div = torch.full((), mb, dtype=torch.float32, device=device)
        return dpsgd._tree_map(lambda x: x / div, acc_g), acc_l / div
    return gfn


def _fleet_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the fleet's ranks: ``all_reduce(SUM)``
    divided by a tensor."""
    size, _ = _fleet(group)
    if size == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x / torch.full((), size, dtype=x.dtype, device=x.device)


def _model_flags(specs, model: tp.Model) -> tuple[list, list]:
    """Per leaf of the spec tree: split over the model axis at all, and
    the model axis its last dim is split over (``tp.ONE`` where not)."""
    from .shardings import spec_leaves

    leaves = spec_leaves(specs)
    return (["model" in sp for sp in leaves],
            [model if sp and sp[-1] == "model" else tp.ONE for sp in leaves])


def make_train_step(api: ModelAPI, run: RunConfig,
                    plan: Optional[GossipPlan], lr_fn: Callable,
                    node_axes: Optional[tuple] = None,
                    group=None, model: Optional[tp.Model] = None,
                    specs=None, donate: bool = False) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.

    Mode A: state["params"] is a plain tree; batch (B, ...), with
    ``group`` this rank's share of the global batch (the gradients and
    the loss all-reduced to their mean over the fleet).
    Mode B: state trees carry the leading node axis; batch (n, B/n, ...),
    with ``group`` this rank's block of nodes on both.
    ``node_axes`` names the mesh axes of the node dim in the reference (its
    vmap's ``spmd_axis_name``); it changes nothing here.
    ``model`` (a ``models.tp.Model``) with ``specs`` (``train.shardings.
    param_specs`` of the parameters, a spec a leaf aligned to its
    trailing dims): tensor parallelism, every state leaf the rank's
    shard, ``api`` built over the same ``model``. ``donate`` (the JAX
    trainer's ``donate_argnums=(0,)``): the step consumes its state, the
    optimizer writing into its tensors (``optim``'s ``donate``), so an
    eager step holds one copy of the parameters and moments.
    """
    del node_axes
    model = model or tp.ONE
    split = rows_split = None
    if model.active:
        if specs is None:
            raise ValueError("a tensor-parallel step needs the parameters' "
                             "specs (train.shardings.param_specs)")
        split, rows_split = _model_flags(specs, model)
    opt = make_optimizer(run.optimizer, momentum=run.momentum,
                         weight_decay=run.weight_decay, model=model,
                         sharded=split)
    gfn = _grads_fn(api, run)

    if run.mode == "allreduce":
        def step(state, batch):
            lr = lr_fn(state["step"])
            grads, loss = gfn(state["params"], batch)
            grads = dpsgd._tree_map(lambda g: _fleet_mean(g, group), grads)
            loss = _fleet_mean(loss, group)
            new_params, new_opt = opt.update(grads, state["opt"],
                                             state["params"], lr, donate)
            return {**state, "params": new_params, "opt": new_opt,
                    "step": state["step"] + 1}, {"loss": loss}
        return step

    if run.mode == "dpsgd":
        if plan is None:
            raise ValueError("Mode B (dpsgd) needs a gossip plan")
        vgfn = torch.func.vmap(gfn)
        # the plan's W on each device, made on the step's first (eager)
        # run: a CUDA graph's capture follows its warm-up runs
        w_on: dict = {}

        def step(state, batch):
            lr = lr_fn(state["step"])
            grads, losses = vgfn(state["params"], batch)
            device = state["step"].device
            if device not in w_on:
                w_on[device] = _plan_w(plan, device)
            # Eq. 5: gradients at X_k, mixing of X_k, then the local update
            mixed, new_res = mix_params(state["params"],
                                        state.get("residual"), plan, run,
                                        w_on[device], group, rows_split)
            new_params, new_opt = opt.update(grads, state["opt"], mixed, lr,
                                             donate)
            out = {**state, "params": new_params, "opt": new_opt,
                   "step": state["step"] + 1}
            if new_res is not None:
                out["residual"] = new_res
            _, _, sharded = node_block(losses, plan.n_nodes, group)
            if sharded:
                every = losses.new_empty(plan.n_nodes)
                dist.all_gather_into_tensor(every, losses.contiguous(),
                                            group=group)
                losses = every
            return out, {"loss": losses.mean()}
        return step

    raise ValueError(run.mode)


def init_train_state(api: ModelAPI, run: RunConfig, gen: torch.Generator,
                     n_nodes: int = 1, cast=None) -> PyTree:
    """The initial state: parameters drawn from ``gen`` (on the API's
    device), the optimizer's state, ``step`` a 0-d int32 tensor, and in
    Mode B every leaf replicated over ``n_nodes`` with the error-feedback
    residual (zeros of the parameters' dtype) iff compression is on.
    ``cast`` is applied to each piece of the tree as it is drawn
    (``api.init``'s; ``launch.train.shard_cast`` keeps a rank's shards)."""
    opt = make_optimizer(run.optimizer, momentum=run.momentum,
                         weight_decay=run.weight_decay)
    params = api.init(gen, cast=cast)
    device = dpsgd._leaves(params)[0].device
    state: dict = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    if run.mode == "dpsgd":
        params = dpsgd.replicate(params, n_nodes)
        state["params"] = params
        state["opt"] = opt.init(params)
        if run.compression != "none":
            # error-feedback residual, one per node per leaf (paper ref [6])
            state["residual"] = dpsgd._tree_map(torch.zeros_like, params)
    else:
        state["params"] = params
        state["opt"] = opt.init(params)
    return state
