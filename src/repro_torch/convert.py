"""Parameters across frameworks.

The JAX package's parameters travel as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``); :func:`params_from_numpy` turns
them into the port's nested dict of tensors, layout unchanged (OIHW conv
weights, (din, dout) fc weights, a leading node axis kept where present).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (a copy, dtypes kept)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def params_to_numpy(tree):
    """The inverse: nested dict of tensors -> nested dict of numpy arrays
    on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
