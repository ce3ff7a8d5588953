"""Discrete-event simulation engine (gem5-style tick loop).

The engine is deliberately tiny: a monotonic tick counter (1 tick == 1 ps,
matching gem5's default resolution) and a priority queue of events.  Devices
schedule completion callbacks; the engine drains them in (tick, seq) order so
simultaneous events retain FIFO semantics.

The engine is the *slow path* of the simulator — it sequences device-level
latencies (SSD channel occupancy, MSHR wakeups, CXL round trips).  The *hot
path* — per-access cache-state updates over long address traces — is
vectorized separately in :mod:`repro_torch.core.cache.trace_sim` and in the CUDA
kernel of :mod:`repro_torch.kernels.cache_sim`.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

# 1 tick = 1 picosecond, like gem5.
TICKS_PER_NS = 1_000
TICKS_PER_US = 1_000_000
TICKS_PER_MS = 1_000_000_000
TICKS_PER_S = 1_000_000_000_000


def ns(x: float) -> int:
    """Convert nanoseconds to ticks."""
    return int(round(x * TICKS_PER_NS))


def us(x: float) -> int:
    """Convert microseconds to ticks."""
    return int(round(x * TICKS_PER_US))


def to_ns(ticks: int) -> float:
    return ticks / TICKS_PER_NS


def to_us(ticks: int) -> float:
    return ticks / TICKS_PER_US


def to_s(ticks: int) -> float:
    return ticks / TICKS_PER_S


@dataclass(order=True)
class _Event:
    tick: int
    seq: int
    callback: Callable[[], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


class EventEngine:
    """A minimal deterministic discrete-event engine."""

    def __init__(self) -> None:
        self._queue: list[_Event] = []
        self._seq = itertools.count()
        self.now: int = 0
        self.events_executed: int = 0

    # ------------------------------------------------------------------ API
    def schedule(self, delay_ticks: int, callback: Callable[[], None]) -> _Event:
        """Schedule ``callback`` to run ``delay_ticks`` from now."""
        if delay_ticks < 0:
            raise ValueError(f"negative delay: {delay_ticks}")
        ev = _Event(self.now + int(delay_ticks), next(self._seq), callback)
        heapq.heappush(self._queue, ev)
        return ev

    def schedule_at(self, tick: int, callback: Callable[[], None]) -> _Event:
        if tick < self.now:
            raise ValueError(f"cannot schedule in the past: {tick} < {self.now}")
        ev = _Event(int(tick), next(self._seq), callback)
        heapq.heappush(self._queue, ev)
        return ev

    @staticmethod
    def cancel(ev: _Event) -> None:
        ev.cancelled = True

    def run(self, until: Optional[int] = None, max_events: Optional[int] = None) -> int:
        """Drain the queue; returns the final tick."""
        n = 0
        while self._queue:
            if until is not None and self._queue[0].tick > until:
                self.now = until
                break
            if max_events is not None and n >= max_events:
                break
            ev = heapq.heappop(self._queue)
            if ev.cancelled:
                continue
            assert ev.tick >= self.now, "event queue went backwards"
            self.now = ev.tick
            ev.callback()
            self.events_executed += 1
            n += 1
        return self.now

    def pending(self) -> int:
        return sum(1 for e in self._queue if not e.cancelled)

    def reset(self) -> None:
        self._queue.clear()
        self.now = 0
        self.events_executed = 0
