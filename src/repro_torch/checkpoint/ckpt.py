"""Checkpointing: atomic, digest-verified, async-capable npz shards, and
elastic node-axis surgery on D-PSGD state.

The torch counterpart of ``repro.checkpoint.ckpt``, with its on-disk format
byte for byte, so a checkpoint written by one package restores in the
other:

    <dir>/step_<N>/host<h>.npz  (leaf_<i> in jax.tree order)
    <dir>/step_<N>/MANIFEST.json  (step, n_leaves, digest, shapes, dtypes)

The digest is the sha256 of each leaf's first 4096 bytes. numpy has no
bfloat16: the JAX package's bfloat16 leaves (ml_dtypes arrays) are npz
members with the header descr ``'<V2'``, which ``np.load`` returns as
2-byte void items. A bfloat16 tensor is held on the host as such items,
written with that header and named ``"bfloat16"`` in the manifest, and
its bits are viewed back on restore. Writes go to
``.tmp-`` paths first and are renamed only after fsync — a killed writer
never corrupts the latest checkpoint (restart reads the newest *complete*
manifest). ``CheckpointManager`` keeps the last ``keep`` steps and can
overlap saves with training via a writer thread (``async_save=True``).

A D-PSGD state is a tree of tensors whose leaves lead with the node axis.
``reshape_nodes`` keeps surviving node rows and fills new rows with the
survivor mean — the natural D-PSGD warm start after failure/scale events
(``runtime.fault`` re-solves W); ``compact_nodes`` / ``expand_nodes`` move
between the masked fixed-width layout and the compacted one.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from ..core.dpsgd import _leaves, _tree_map, _unflatten, node_axis_size

PyTree = Any

__all__ = ["save", "latest_step", "restore", "CheckpointManager",
           "reshape_nodes", "compact_nodes", "expand_nodes"]


# a bfloat16 leaf on the host: its bits as 2-byte void items
_BF16 = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy: the snapshot must not
    change with the tensor it came from); bfloat16 as ``_BF16`` items."""
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16).copy()
        return x.numpy().copy()
    return np.array(leaf, copy=True)


def _tensor(x: np.ndarray) -> torch.Tensor:
    if x.dtype == _BF16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _dtype_name(x: np.ndarray) -> str:
    return "bfloat16" if x.dtype == _BF16 else str(x.dtype)


def _digest(leaves: list) -> str:
    digest = hashlib.sha256()
    for leaf in leaves:
        digest.update(np.ascontiguousarray(leaf).tobytes()[:4096])
    return digest.hexdigest()


def _savez(f, leaves: list) -> None:
    """``np.savez(f, leaf_0=..., ...)``'s archive, each bfloat16 member
    with the header ``np.save`` writes for an ml_dtypes bfloat16 array."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for i, x in enumerate(leaves):
            with z.open(f"leaf_{i}.npy", "w", force_zip64=True) as fid:
                if x.dtype != _BF16:
                    np.lib.format.write_array(fid, x)
                    continue
                header = np.lib.format.header_data_from_array_1_0(x)
                header["descr"] = "<V2"
                np.lib.format.write_array_header_1_0(fid, header)
                fid.write(np.ascontiguousarray(x).reshape(-1).view(np.uint8))


def _write_synced(path: str, write) -> None:
    """``write(f)`` into ``.tmp-<name>`` beside ``path``, fsync, rename."""
    head, name = os.path.split(path)
    tmp = os.path.join(head, f".tmp-{name}")
    with open(tmp, "w" if name.endswith(".json") else "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(directory: str, step: int, state: PyTree, host: int = 0) -> str:
    """Atomic save; returns the checkpoint path."""
    leaves = [_host(x) for x in _leaves(state)]
    step_dir = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    _write_synced(os.path.join(step_dir, f"host{host}.npz"),
                  lambda f: _savez(f, leaves))
    manifest = {"step": step, "n_leaves": len(leaves),
                "digest": _digest(leaves),
                "shapes": [list(x.shape) for x in leaves],
                "dtypes": [_dtype_name(x) for x in leaves]}
    _write_synced(os.path.join(step_dir, "MANIFEST.json"),
                  lambda f: json.dump(manifest, f))
    return step_dir


def _complete_steps(directory: str) -> list[int]:
    return sorted(
        int(name.split("_")[1]) for name in os.listdir(directory)
        if name.startswith("step_") and os.path.exists(
            os.path.join(directory, name, "MANIFEST.json")))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, like: PyTree, step: Optional[int] = None,
            host: int = 0) -> tuple[PyTree, int]:
    """Restore into the structure of ``like``, each leaf on the device of
    ``like``'s leaf (dtypes as stored); returns (state, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    step_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves_like = _leaves(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves_like)}")
    with np.load(os.path.join(step_dir, f"host{host}.npz")) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(leaves_like))]
    if _digest(leaves) != manifest["digest"]:
        raise ValueError(f"checkpoint digest mismatch at step {step}")
    return _unflatten(like, [_tensor(x).to(ref.device) for x, ref
                             in zip(leaves, leaves_like)]), step


def _node_width(state: PyTree, what: str) -> int:
    """Shared leading node-axis width of the non-scalar leaves (scalar
    leaves — step counters and the like — carry no node axis and pass
    through every elastic transform untouched). Raises on disagreeing
    leading dims; returns 0 when every leaf is scalar."""
    return node_axis_size(state, what, allow_scalar=True)


def _host_mean(rows: torch.Tensor) -> torch.Tensor:
    """The node-axis mean on the host, in the leaf's dtype: the device's
    reduction can drift ~20 float32 ulps from numpy's pairwise sum on
    near-cancelling rows, which breaks bit-for-bit agreement across hosts
    replaying the same elastic event. bfloat16 rows (numpy has none) as
    numpy's mean of an ml_dtypes array computes them: each row added in
    float32 and rounded to bfloat16, the sum divided in float32."""
    host = rows.detach().cpu()
    if host.dtype == torch.bfloat16:
        acc = host[:1]
        for i in range(1, host.shape[0]):
            acc = (acc.float() + host[i:i + 1].float()).to(torch.bfloat16)
        return (acc.float() / host.shape[0]).to(torch.bfloat16)
    x = host.numpy()
    return torch.from_numpy(x.mean(axis=0, keepdims=True).astype(x.dtype))


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
        fill = _host_mean(kept).to(leaf.device)
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
        out = _host_mean(leaf).to(leaf.device)
        out = out.repeat(n_total, *([1] * (leaf.dim() - 1)))
        out[torch.from_numpy(survivors).to(leaf.device)] = leaf
        return out

    return _tree_map(fix, state)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: PyTree, host: int = 0):
        state = _tree_map(_host, state)  # snapshot off-device
        if self._thread is not None:
            self._thread.join()

        def _do():
            save(self.directory, step, state, host)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: PyTree, host: int = 0):
        return restore(self.directory, like, host=host)

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = _complete_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
