"""Parameters and caches across frameworks.

The JAX package's trees travel as nested dicts and lists of numpy arrays
(``jax.tree.map(np.asarray, tree)``); :func:`params_from_numpy` turns them
into the port's trees of tensors, layout unchanged (OIHW conv weights,
(din, dout) dense weights, a leading node or repeats axis kept where
present, the model zoo's ``prologue`` / ``unit`` / ``tail`` lists kept as
lists), and :func:`params_to_numpy` turns them back. Under tensor
parallelism :func:`shards_from_numpy` takes a rank's shards of such a
tree (``train.shardings.shard_model`` by its specs), so both sides of a
test start from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy", "shards_from_numpy"]


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """Nested dicts / lists of numpy arrays -> the same tree of tensors on
    ``device`` (a copy, dtypes kept)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def params_to_numpy(tree):
    """The inverse: a tree of tensors -> the same tree of numpy arrays on
    the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def shards_from_numpy(tree, specs, model,
                      device: str | torch.device = "cuda"):
    """A rank's shards of a numpy tree: each leaf sliced on the host by
    its spec (``train.shardings.param_specs`` entries aligned to the
    leaf's trailing dims) over ``model`` (a ``models.tp.Model``), then
    moved to ``device``."""
    from .train.shardings import shard_model

    return params_from_numpy(
        shard_model(params_from_numpy(tree, "cpu"), specs, model), device)
