"""Deterministic discrete-event backbone: clock + priority event queue.

Round starts and churn arrivals flow through one ``EventQueue`` so a run is
a single totally-ordered event sequence; the MAC can additionally log
per-packet (re)transmission events into a queue for inspection
(``mac.tdm_round(queue=...)``). Determinism is load-bearing — the
paper's Algorithm 2 relies on every node computing identical plans from
identical inputs, and our regression anchor (static scenario == Eq. 3)
relies on replaying the exact same event order every run. Ties in event
time are broken by insertion sequence number, never by dict/heap iteration
order.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Any, Iterator, Optional

__all__ = ["EventKind", "Event", "EventQueue", "SimClock"]


class EventKind(enum.Enum):
    ROUND_START = "round_start"
    PACKET_TX = "packet_tx"
    PACKET_RETX = "packet_retx"
    CHURN_FAIL = "churn_fail"


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    """One simulator event; ordering key is (time, seq)."""

    time_s: float
    seq: int
    kind: EventKind = dataclasses.field(compare=False)
    payload: dict = dataclasses.field(compare=False, default_factory=dict)


class SimClock:
    """Monotone simulated wall-clock (seconds)."""

    def __init__(self, t0: float = 0.0):
        self._now = float(t0)

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        if t < self._now - 1e-12:
            raise ValueError(f"clock cannot run backwards ({t} < {self._now})")
        self._now = max(self._now, t)
        return self._now


class EventQueue:
    """Min-heap of events, FIFO-stable within equal timestamps."""

    def __init__(self):
        self._heap: list[Event] = []
        self._seq = 0
        self.processed: int = 0

    def push(self, time_s: float, kind: EventKind, **payload: Any) -> Event:
        ev = Event(float(time_s), self._seq, kind, payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        self.processed += 1
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def drain(self) -> Iterator[Event]:
        """Pop every queued event in order (used to read back event logs)."""
        while self._heap:
            yield self.pop()
