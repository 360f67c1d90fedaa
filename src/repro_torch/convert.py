"""Parameters and caches across frameworks.

The JAX package's trees travel as nested dicts and lists of numpy arrays
(``jax.tree.map(np.asarray, tree)``); :func:`params_from_numpy` turns them
into the port's trees of tensors, layout unchanged (OIHW conv weights,
(din, dout) dense weights, a leading node or repeats axis kept where
present, the model zoo's ``prologue`` / ``unit`` / ``tail`` lists kept as
lists), and :func:`params_to_numpy` turns them back.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


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
