"""Elastic node-axis surgery on D-PSGD state (the torch counterpart of the
node-axis half of ``repro.checkpoint.ckpt``).

A D-PSGD state is a tree of tensors whose leaves lead with the node axis.
``reshape_nodes`` keeps surviving node rows and fills new rows with the
survivor mean — the natural D-PSGD warm start after failure/scale events
(``runtime.fault`` re-solves W); ``compact_nodes`` / ``expand_nodes`` move
between the masked fixed-width layout and the compacted one. The atomic
npz checkpoint files (``save``, ``restore``, ``CheckpointManager``) come
with the train-on-trace slice.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.dpsgd import _tree_map, node_axis_size

PyTree = Any

__all__ = ["reshape_nodes", "compact_nodes", "expand_nodes"]


def _node_width(state: PyTree, what: str) -> int:
    """Shared leading node-axis width of the non-scalar leaves (scalar
    leaves — step counters and the like — carry no node axis and pass
    through every elastic transform untouched). Raises on disagreeing
    leading dims; returns 0 when every leaf is scalar."""
    return node_axis_size(state, what, allow_scalar=True)


def _host_mean(rows: torch.Tensor) -> np.ndarray:
    """The node-axis mean on the host, in the leaf's dtype: the device's
    reduction can drift ~20 float32 ulps from numpy's pairwise sum on
    near-cancelling rows, which breaks bit-for-bit agreement across hosts
    replaying the same elastic event."""
    host = rows.detach().cpu().numpy()
    return host.mean(axis=0, keepdims=True).astype(host.dtype)


def reshape_nodes(state: PyTree, survivors: list[int], n_new: int) -> PyTree:
    """Elastic restore: keep surviving node rows, fill the rest with the
    survivor mean (leading axis = node axis on every leaf of params/opt)."""
    width = _node_width(state, "reshape_nodes state")
    surv = np.asarray(survivors, dtype=np.int64)
    if width and surv.size and int(surv.max()) >= width:
        raise ValueError(
            f"survivor index {int(surv.max())} out of range for the state's "
            f"node axis of {width}")

    def fix(leaf):
        if leaf.dim() == 0:
            return leaf
        kept = leaf[torch.from_numpy(surv).to(leaf.device)]
        if n_new <= kept.shape[0]:
            return kept[:n_new]
        fill = torch.from_numpy(_host_mean(kept)).to(leaf.device, leaf.dtype)
        extra = fill.expand(n_new - kept.shape[0], *kept.shape[1:])
        return torch.cat([kept, extra], dim=0)
    return _tree_map(fix, state)


def compact_nodes(state: PyTree, live: np.ndarray) -> PyTree:
    """Masked fixed-width state -> compacted state: keep live node rows, in
    original-id order. The inverse (for live rows) of ``expand_nodes``.
    The node axis is validated against ``live``'s width so a ragged or
    transposed state fails loudly instead of gathering the wrong axis."""
    live = np.asarray(live, dtype=bool)
    width = _node_width(state, "compact_nodes state")
    if width and width != live.size:
        raise ValueError(
            f"state node axis is {width} but live mask has {live.size} "
            "entries")
    idx = torch.from_numpy(np.flatnonzero(live))
    return _tree_map(
        lambda leaf: leaf if leaf.dim() == 0 else leaf[idx.to(leaf.device)],
        state)


def expand_nodes(state: PyTree, survivors: list[int], n_total: int) -> PyTree:
    """Compacted state -> masked fixed-width state: scatter node row ``k`` to
    row ``survivors[k]`` of an ``n_total``-wide state; the remaining (dead)
    rows are filled with the survivor mean, matching the ``reshape_nodes``
    warm start (host-side mean for bit-identical replay across hosts). Dead
    rows are inert under ``dpsgd_masked_step`` — the fill only matters if a
    node is later revived."""
    survivors = np.asarray(survivors, dtype=np.int64)
    width = _node_width(state, "expand_nodes state")
    if width and width != survivors.size:
        raise ValueError(
            f"compacted state node axis is {width} but {survivors.size} "
            "survivor slots were given")
    if survivors.size and int(survivors.max()) >= n_total:
        raise ValueError(
            f"survivor index {int(survivors.max())} out of range for "
            f"n_total={n_total}")

    def fix(leaf):
        if leaf.dim() == 0:
            return leaf
        out = torch.from_numpy(_host_mean(leaf)).to(leaf.device, leaf.dtype)
        out = out.repeat(n_total, *([1] * (leaf.dim() - 1)))
        out[torch.from_numpy(survivors).to(leaf.device)] = leaf
        return out

    return _tree_map(fix, state)
