"""The profiler summary: device time, idle share, largest operations, gaps
and the hand-written kernels' launches of a traced window.

``torch.profiler`` (CUPTI) traces the card's operations while a function
runs. :func:`device_profile` groups them by name per call (what
``chip_smoke.py`` prints as a path's largest operations), :func:`device_ms`
sums the device time of the operations a wrapper's call makes, and
:func:`trace` summarises one window: its busy device ms (the union of the
operations' intervals), its idle share (1 - busy / wall, the wall read on
the host around the window, the device synchronised at both ends), the
largest operations, the longest gaps between operations, and each
hand-written kernel's launches, counted from the trace by the names of its
CUDA kernels (:data:`KERNELS`, each wrapper's ``.kernels``), not from the
wrappers' counters.

:func:`summarize` is the arithmetic on (name, start µs, end µs) triples,
which the CPU tests drive without a card.
"""
from __future__ import annotations

import re
import time
from typing import Callable, Iterable, Optional

from ..kernels import counted_wrappers

__all__ = ["KERNELS", "device_profile", "device_ms", "trace", "summarize",
           "kernel_launches"]

# Each counted wrapper's counter name and the CUDA kernels one call of it
# launches exactly one of (``kernels._backend.counted``)
KERNELS = {w.__name__: w.kernels for w in counted_wrappers()}


def _named(kernel: str) -> re.Pattern:
    """``kernel`` as a whole identifier in a profiler's name (so that
    ``quantize_int8_kernel`` does not match ``dequantize_int8_kernel``)."""
    return re.compile(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}"
                      r"(?![A-Za-z0-9_])")


_PATTERNS = {k: [_named(n) for n in names] for k, names in KERNELS.items()}


def kernel_launches(names: Iterable[str]) -> dict[str, int]:
    """Launches of each wrapper of :data:`KERNELS` among the device
    operations ``names`` (one entry an operation)."""
    out = dict.fromkeys(KERNELS, 0)
    for name in names:
        for wrapper, pats in _PATTERNS.items():
            if any(p.search(name) for p in pats):
                out[wrapper] += 1
    return out


def device_profile(run: Callable[[], object],
                   calls: int) -> list[tuple[str, float, int]]:
    """Kernels in a ``torch.profiler`` trace of ``run`` (which makes
    ``calls`` calls of the thing measured): (name, device ms per call,
    launches per call), longest first; empty if the trace shows no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((evt.key, us / 1e3 / calls, evt.count // calls))
    return sorted(rows, key=lambda r: -r[1])


def device_ms(fn: Callable[[], object], kernel_name, calls: int = 50):
    """Device time per call of every device operation a call makes whose
    name contains ``kernel_name`` (a string, or a tuple of name fragments:
    a wrapper's kernels, memsets and second passes all count); None if the
    trace shows none."""
    fn()
    names = (kernel_name,) if isinstance(kernel_name, str) else kernel_name

    def run():
        for _ in range(calls):
            fn()
    ms = sum(r[1] for r in device_profile(run, calls)
             if any(n in r[0] for n in names))
    return ms if ms > 0 else None


def summarize(events: list[tuple[str, float, float]],
              wall_ms: Optional[float] = None, top: int = 10,
              gaps: int = 5) -> dict:
    """The summary of a window's device operations, each (name, start µs,
    end µs): ``busy_ms`` the union of their intervals, ``idle`` 1 - busy /
    ``wall_ms`` (None without a wall), ``top`` the ``top`` names of the
    most device time (name, ms, count), ``gaps`` the ``gaps`` longest
    stretches with no operation running between the first start and the
    last end (ms, the operation before, the one after), ``launches`` each
    wrapper's kernels counted (:func:`kernel_launches`), ``operations``
    the number of operations."""
    spans = sorted(events, key=lambda e: (e[1], e[2]))
    busy_us, reach, holes = 0.0, None, []
    prev = None
    for name, start, end in spans:
        if reach is None or start >= reach:
            if reach is not None and start > reach:
                holes.append(((start - reach) / 1e3, prev, name))
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
        if reach == end:
            prev = name
    by_name: dict[str, list] = {}
    for name, start, end in spans:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (end - start) / 1e3
        acc[1] += 1
    busy = busy_us / 1e3
    return {
        "busy_ms": busy, "wall_ms": wall_ms,
        "idle": 1.0 - busy / wall_ms if wall_ms else None,
        "top": sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                      key=lambda r: -r[1])[:top],
        "gaps": sorted(holes, key=lambda g: -g[0])[:gaps],
        "launches": kernel_launches(n for n, _, _ in spans),
        "operations": len(spans)}


def _device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start µs, end µs) of each device operation of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and
            e.time_range.end > e.time_range.start]


def trace(run: Callable[[], object], top: int = 10, gaps: int = 5,
          clock: Optional[Callable[[], float]] = None) -> dict:
    """Trace ``run`` on the card and :func:`summarize` it, the wall read on
    ``clock`` (``time.perf_counter`` unless given) between two
    synchronisations of the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    clock = clock or time.perf_counter
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        run()
        torch.cuda.synchronize()
        wall_ms = (clock() - t0) * 1e3
    return summarize(_device_events(prof), wall_ms, top, gaps)
