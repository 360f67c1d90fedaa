"""Sharded host-side data loader with background prefetch.

Production posture: each host draws only its shard of the global batch
(deterministic per (seed, step, host)), a daemon thread keeps ``prefetch``
batches ready, and step indexing is explicit so checkpoint-restart resumes
the stream exactly (data determinism is part of fault tolerance)."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["ShardedLoader"]


class ShardedLoader:
    """Wraps a ``make_batch(step) -> pytree`` function with prefetching."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 prefetch: int = 2):
        self._make = make_batch
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def deterministic_lm_batch(step: int, batch: int, seq_len: int, vocab: int,
                           seed: int = 0,
                           extra: Optional[dict] = None) -> dict:
    """Stateless batch as a function of step (restart-exact)."""
    rng = np.random.default_rng((seed, step))
    out = {"tokens": rng.integers(0, vocab, size=(batch, seq_len)).astype(np.int32)}
    if extra:
        out.update(extra)
    return out
