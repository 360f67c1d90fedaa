"""Tree <-> flat-buffer utilities for fused gossip collectives.

The torch counterpart of ``repro.utils.tree``. ``tree_to_buffers`` groups
leaves by dtype and concatenates each group into a single 1-D buffer, so one
gossip round issues one collective per dtype group instead of one per
tensor; ``buffers_to_tree`` inverts exactly. Leaves are visited in
``jax.tree``'s order (``core.dpsgd._leaves``) and the groups are keyed by the
JAX package's dtype names (``"float32"``, ``"bfloat16"``, ``"int32"``), so
both packages' buffers and specs line up key for key.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.dpsgd import _leaves, _tree_map, _unflatten

PyTree = Any

__all__ = ["tree_to_buffers", "buffers_to_tree", "tree_to_node_buffers",
           "node_buffers_to_tree", "tree_bytes", "tree_param_count"]


def _group_key(dtype: torch.dtype) -> str:
    """A torch dtype by its numpy / JAX name (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def _skeleton(tree: PyTree) -> PyTree:
    """The tree's structure with every leaf replaced by None: the treedef
    of the spec."""
    return _tree_map(lambda _: None, tree)


def _spec(tree: PyTree, leaves: list) -> tuple[tuple, dict]:
    groups: dict[str, list[int]] = {}
    for idx, leaf in enumerate(leaves):
        groups.setdefault(_group_key(leaf.dtype), []).append(idx)
    spec = (_skeleton(tree),
            [(tuple(leaf.shape), _group_key(leaf.dtype)) for leaf in leaves],
            groups)
    return spec, groups


def tree_to_buffers(tree: PyTree) -> tuple[dict[str, torch.Tensor], Any]:
    """Returns ({dtype_name: 1-D buffer}, spec) with deterministic leaf
    order."""
    leaves = _leaves(tree)
    spec, groups = _spec(tree, leaves)
    buffers = {key: torch.cat([leaves[i].reshape(-1) for i in idxs])
               for key, idxs in groups.items()}
    return buffers, spec


def _size(shape: tuple) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def buffers_to_tree(buffers: dict[str, torch.Tensor], spec: Any) -> PyTree:
    skeleton, shapes_dtypes, groups = spec
    leaves: list[Any] = [None] * len(shapes_dtypes)
    for key, idxs in groups.items():
        buf = buffers[key]
        off = 0
        for i in idxs:
            shape, _ = shapes_dtypes[i]
            size = _size(shape)
            leaves[i] = buf.narrow(0, off, size).reshape(shape)
            off += size
    return _unflatten(skeleton, leaves)


def tree_to_node_buffers(tree: PyTree) -> tuple[dict[str, torch.Tensor], Any]:
    """Like ``tree_to_buffers`` but leaves carry a leading node axis that is
    preserved: each group becomes one (n_nodes, total) buffer."""
    leaves = _leaves(tree)
    n = leaves[0].shape[0]
    spec, groups = _spec(tree, leaves)
    buffers = {key: torch.cat([leaves[i].reshape(n, -1) for i in idxs],
                              dim=1)
               for key, idxs in groups.items()}
    return buffers, spec


def node_buffers_to_tree(buffers: dict[str, torch.Tensor],
                         spec: Any) -> PyTree:
    skeleton, shapes_dtypes, groups = spec
    leaves: list[Any] = [None] * len(shapes_dtypes)
    for key, idxs in groups.items():
        buf = buffers[key]
        off = 0
        for i in idxs:
            shape, _ = shapes_dtypes[i]
            size = _size(shape[1:]) if len(shape) > 1 else 1
            leaves[i] = buf.narrow(1, off, size).reshape(shape)
            off += size
    return _unflatten(skeleton, leaves)


def tree_bytes(tree: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def tree_param_count(tree: PyTree) -> int:
    return sum(x.numel() for x in _leaves(tree))
