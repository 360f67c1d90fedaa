"""CUDA graphs of the port's steps: the counterpart of ``jax.jit``.

The JAX package's step builders return jitted steps, one compiled executable
per input signature. :class:`GraphedStep` is the port's counterpart. On
CUDA inputs it captures its body into a ``torch.cuda.CUDAGraph`` on the
first call with a given signature (device, tree structure, shapes and
dtypes) and replays the graph on later calls, so the body's few hundred
launches cost their device time and not their dispatch. On CPU inputs it
runs the body eagerly: the CPU has no graph, as it has no kernel.

* **Inputs** go through static device buffers, one per leaf, that the
  graph reads. Before each replay, outside the graph, the caller's tensors
  are copied in (one ``_foreach_copy_`` per dtype) and numpy arrays,
  lists and tuples host-to-device without waiting for the card (a copy
  from pageable memory cannot be captured). The body sees tensors where
  the caller passed arrays; the port's bodies convert either alike. Dicts
  are the only containers walked inside an argument; any other leaf (a
  number, ``None``, a config) is a constant of the signature.
* **Outputs** are fresh tensors: the graph packs the body's outputs into
  one flat buffer per dtype, and each call clones that buffer once and
  hands out views of the clone. Nothing a step returned is overwritten by
  a later replay.
* **Warm-up and capture.** Before a capture the body runs ``WARMUP`` times
  on a side stream (cuDNN plans, cuBLAS workspaces, the kernels' ``nvcc``
  build and ``.so`` load); then it is captured on that stream. A capture
  that fails raises: no path falls back to eager execution on a CUDA input.
  :meth:`GraphedStep.prepare` captures without replaying, so a caller can
  keep the capture out of a measured step.
* **Launch counters.** Each kernel wrapper counts its launches in
  ``<wrapper>.launches``. The capture records how much each count grew
  while the body was captured; each replay adds that delta. The warm-up
  runs and the capture itself are set-up and are taken back out of the
  counts, so a count reads the launches of the steps the caller ran.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .kernels import counted_wrappers

__all__ = ["GraphedStep", "WARMUP"]

WARMUP = 2          # eager runs on the side stream before a capture

_ARRAYS = (np.ndarray, list, tuple)
# one capture stream per device, shared by every capture: cuBLAS keeps a
# workspace per stream for the life of the process, so a new stream per
# capture would leave one workspace behind for each
_SIDE: dict = {}


def _side_stream(device: torch.device):
    side = _SIDE.get(device)
    if side is None:
        side = _SIDE[device] = torch.cuda.Stream(device)
    return side


def _flatten_args(args: tuple) -> tuple[list, tuple]:
    """Leaves of the step's arguments (dicts walked in sorted-key order) and
    the hashable structure that rebuilds them."""
    leaves: list = []

    def walk(x):
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return ("dict", keys, tuple(walk(x[k]) for k in keys))
        leaves.append(x)
        return None
    return leaves, tuple(walk(a) for a in args)


def _unflatten_args(structure: tuple, leaves: list) -> tuple:
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        _, keys, children = s
        return {k: build(c) for k, c in zip(keys, children)}
    return tuple(build(s) for s in structure)


def _flatten_out(out) -> tuple[list, Any]:
    """Tensor leaves of the body's output (dicts, tuples and lists walked)
    and the structure that rebuilds it."""
    leaves: list = []

    def walk(x):
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return ("dict", keys, tuple(walk(x[k]) for k in keys))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, None, tuple(walk(v) for v in x))
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"a graphed step returns tensors, got {type(x)}")
        leaves.append(x)
        return None
    return leaves, walk(out)


def _unflatten_out(structure, leaves: list):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, children = s
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        items = [build(c) for c in children]
        return tuple(items) if kind == "tuple" else items
    return build(structure)


def _graphable(device: torch.device) -> bool:
    """Inputs on this device run as a graph (CUDA); any other runs eager."""
    return device.type == "cuda"


def _record(graph: torch.cuda.CUDAGraph, stream, fn: Callable):
    """Capture the launches of ``fn()`` on ``stream`` into ``graph``; returns
    what ``fn`` returned (its tensors live in the graph's memory pool and
    are rewritten by each replay)."""
    with torch.cuda.graph(graph, stream=stream):
        return fn()


def _leaf_key(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return ("tensor", x.device, x.dtype, tuple(x.shape))
    if isinstance(x, _ARRAYS):
        a = np.asarray(x)
        return ("array", a.dtype.str, a.shape)
    return ("const", x)


def _static(x, device: torch.device):
    """The static device buffer of one input leaf, holding its value; None
    for a constant."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, _ARRAYS):
        return torch.tensor(np.asarray(x), device=device)
    return None


@dataclasses.dataclass
class _Entry:
    """One captured signature: the graph, its static inputs (None where the
    leaf is a constant), its flat outputs, and the counters' delta."""

    graph: torch.cuda.CUDAGraph
    statics: list
    flats: list                 # one flat output buffer per dtype
    packed: list                # per flat: the output leaves it packs
    order: list                 # output leaf i -> (flat index, piece index)
    structure: Any
    delta: list

    def load(self, leaves: list) -> None:
        groups: dict = {}       # one _foreach_copy_ per dtype: its fast path
        for static, leaf in zip(self.statics, leaves):
            if static is None:
                continue
            if isinstance(leaf, torch.Tensor) and leaf.device == static.device:
                dst, src = groups.setdefault(leaf.dtype, ([], []))
                dst.append(static)
                src.append(leaf)
            else:
                # host to device without waiting for the card: CUDA stages
                # a pageable source before the call returns
                host = leaf if isinstance(leaf, torch.Tensor) \
                    else torch.tensor(np.asarray(leaf))
                static.copy_(host, non_blocking=True)
        for dst, src in groups.values():
            torch._foreach_copy_(dst, src)

    def fresh(self):
        pieces = [_unflatten_dense_tensors(flat.clone(), leaves)
                  for flat, leaves in zip(self.flats, self.packed)]
        return _unflatten_out(self.structure,
                              [pieces[f][i] for f, i in self.order])


class GraphedStep:
    """``body`` as a CUDA graph per input signature on CUDA inputs, eager on
    CPU inputs. The device is that of the first tensor among the leaves."""

    def __init__(self, body: Callable):
        self._body = body
        self._entries: dict = {}

    @staticmethod
    def _device(leaves: list):
        for x in leaves:
            if isinstance(x, torch.Tensor):
                return x.device
        return None

    def __call__(self, *args):
        leaves, structure = _flatten_args(args)
        device = self._device(leaves)
        if device is None or not _graphable(device):
            return self._body(*args)
        entry = self._entry(device, leaves, structure)
        entry.load(leaves)
        entry.graph.replay()
        for fn, d in zip(counted_wrappers(), entry.delta):
            fn.launches += d
        return entry.fresh()

    def prepare(self, *args) -> None:
        """Capture the graph for these arguments' signature if it is new;
        nothing runs on the CPU. The arguments are used as warm-up data and
        left as they are."""
        leaves, structure = _flatten_args(args)
        device = self._device(leaves)
        if device is not None and _graphable(device):
            self._entry(device, leaves, structure)

    @property
    def signatures(self) -> int:
        """How many graphs this step holds."""
        return len(self._entries)

    def _entry(self, device, leaves, structure) -> _Entry:
        key = (device, structure, tuple(_leaf_key(x) for x in leaves))
        entry = self._entries.get(key)
        if entry is None:
            with torch.cuda.device(device):
                entry = self._capture(device, leaves, structure)
            self._entries[key] = entry
        return entry

    def _capture(self, device, leaves, structure) -> _Entry:
        statics = [_static(x, device) for x in leaves]
        args = _unflatten_args(structure, [
            x if s is None else s for s, x in zip(statics, leaves)])

        counted = counted_wrappers()
        before = [fn.launches for fn in counted]
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self._body(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        warm = [fn.launches for fn in counted]

        def packed():
            out_leaves, structure = _flatten_out(self._body(*args))
            dtypes = list(dict.fromkeys(t.dtype for t in out_leaves))
            order, groups = [], [[] for _ in dtypes]
            for t in out_leaves:
                f = dtypes.index(t.dtype)
                order.append((f, len(groups[f])))
                groups[f].append(t)
            flats = [_flatten_dense_tensors(g) for g in groups]
            return flats, groups, order, structure

        graph = torch.cuda.CUDAGraph()
        flats, packs, order, out_structure = _record(graph, side, packed)
        captured = [fn.launches for fn in counted]
        for fn, n in zip(counted, before):
            fn.launches = n
        return _Entry(graph, statics, flats, packs, order, out_structure,
                      [c - w for c, w in zip(captured, warm)])
