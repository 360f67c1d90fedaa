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
  the caller passed arrays; the port's bodies convert either alike. Dicts,
  and lists and tuples that hold tensors or dicts (the transformer's layer
  groups), are walked inside an argument; any other leaf (a number,
  ``None``, a config) is a constant of the signature.
* **Outputs** are fresh tensors: each replay rewrites the body's output
  tensors in the graph's memory, and each call copies them out into new
  tensors, one allocation per leaf and one multi-tensor copy per dtype
  (``_foreach_copy_``). Nothing a step returned is overwritten by a later
  replay, and keeping one output (a round's losses) keeps nothing else of
  its step alive. (Packing the outputs into one buffer inside the graph
  would hold one more copy of them in the graph's pool, 8.8 GiB at six
  replicas of a 0.34 B-parameter model, and copy them once more a replay.)
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
import gc
from typing import Any, Callable

import numpy as np
import torch

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


def _is_tree(x) -> bool:
    """A container of the parameter tree: a dict, or a list or tuple that
    is empty or holds a tensor or another container (a list of numbers is
    array data, as W may arrive)."""
    if isinstance(x, dict):
        return True
    return isinstance(x, (list, tuple)) and (not x or any(
        isinstance(v, torch.Tensor) or _is_tree(v) for v in x))


# The walkers are module-level functions: a nested function that calls
# itself is a reference cycle with its closure, and the leaves list in that
# closure (a round's input parameters) would live until the next garbage
# collection instead of until the call returns.

def _walk_args(x, leaves: list):
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_walk_args(x[k], leaves) for k in keys))
    if _is_tree(x):
        return (type(x).__name__, None,
                tuple(_walk_args(v, leaves) for v in x))
    leaves.append(x)
    return None


def _flatten_args(args: tuple) -> tuple[list, tuple]:
    """Leaves of the step's arguments (dicts walked in sorted-key order,
    lists and tuples of the tree in order) and the hashable structure that
    rebuilds them."""
    leaves: list = []
    return leaves, tuple(_walk_args(a, leaves) for a in args)


def _build(s, it):
    """The tree of structure ``s`` with its leaves drawn from ``it``."""
    if s is None:
        return next(it)
    kind, keys, children = s
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, children)}
    items = [_build(c, it) for c in children]
    return tuple(items) if kind == "tuple" else items


def _unflatten_args(structure: tuple, leaves: list) -> tuple:
    it = iter(leaves)
    return tuple(_build(s, it) for s in structure)


def _walk_out(x, leaves: list):
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_walk_out(x[k], leaves) for k in keys))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, None,
                tuple(_walk_out(v, leaves) for v in x))
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"a graphed step returns tensors, got {type(x)}")
    leaves.append(x)
    return None


def _flatten_out(out) -> tuple[list, Any]:
    """Tensor leaves of the body's output (dicts, tuples and lists walked)
    and the structure that rebuilds it."""
    leaves: list = []
    return leaves, _walk_out(out, leaves)


def _unflatten_out(structure, leaves: list):
    return _build(structure, iter(leaves))


def _graphable(device: torch.device) -> bool:
    """Inputs on this device run as a graph (CUDA); any other runs eager."""
    return device.type == "cuda"


def _record(graph: torch.cuda.CUDAGraph, stream, fn: Callable):
    """Capture the launches of ``fn()`` on ``stream`` into ``graph``; returns
    what ``fn`` returned (its tensors live in the graph's memory pool and
    are rewritten by each replay). The cyclic garbage collector is off
    while it captures: collected mid-capture, a dead reference cycle that
    holds another step's graph resets that graph, which CUDA forbids while
    a stream captures, and the capture is lost (``torch.cuda.graph`` no
    longer collects before it begins)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream):
            return fn()
    finally:
        if enabled:
            gc.enable()


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
    leaf is a constant), the output leaves it rewrites on each replay, and
    the counters' delta."""

    graph: torch.cuda.CUDAGraph
    statics: list
    outs: list                  # the body's output leaves, in the graph
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
        """Copies of the outputs, each leaf its own tensor, filled by one
        multi-tensor copy (``_foreach_copy_``) per dtype."""
        copies = [torch.empty_like(t) for t in self.outs]
        groups: dict = {}
        for dst, src in zip(copies, self.outs):
            d, s = groups.setdefault(src.dtype, ([], []))
            d.append(dst)
            s.append(src)
        for d, s in groups.values():
            torch._foreach_copy_(d, s)
        return _unflatten_out(self.structure, copies)


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
        return self.stage(*args)()

    def stage(self, *args) -> Callable:
        """Load ``args`` into the graph's static inputs (capturing first if
        their signature is new) and return a function of no arguments that
        replays the graph and returns fresh outputs: the caller may drop
        its own references to ``args`` before calling it, since the static
        inputs hold their values (a round loop then keeps no second copy
        of its parameters while the next ones are made). On CPU inputs the
        function runs the eager body on ``args``."""
        leaves, structure = _flatten_args(args)
        device = self._device(leaves)
        if device is None or not _graphable(device):
            return lambda: self._body(*args)
        entry = self._entry(device, leaves, structure)
        entry.load(leaves)

        def run():
            entry.graph.replay()
            for fn, d in zip(counted_wrappers(), entry.delta):
                fn.launches += d
            return entry.fresh()
        return run

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

        graph = torch.cuda.CUDAGraph()
        outs, out_structure = _record(
            graph, side, lambda: _flatten_out(self._body(*args)))
        captured = [fn.launches for fn in counted]
        for fn, n in zip(counted, before):
            fn.launches = n
        return _Entry(graph, statics, outs, out_structure,
                      [c - w for c, w in zip(captured, warm)])
