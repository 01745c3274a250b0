"""Injectable scheduling seam — all runtime timing is testable virtual time.

Port of airwave_tpu/runtime/scheduler.py, the same host code: the port keeps
its own copy and imports no module of the JAX package.

The reference routes every delayed action through an `AudioRuntimeScheduling`
protocol (Airwave/AudioRuntimeController.swift:27-52) so its
state-machine tests run on captured, manually-fired actions. Same pattern:
`ThreadScheduler` for production, `ManualScheduler` for tests.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, Dict, List, Optional, Protocol, Tuple


class Scheduler(Protocol):
    def schedule(self, delay_seconds: float, action: Callable[[], None]) -> int:
        """Run `action` after `delay_seconds`; returns a cancellation token."""
        ...

    def cancel(self, token: int) -> None:
        ...


class ThreadScheduler:
    """threading.Timer-backed production scheduler."""

    def __init__(self) -> None:
        self._timers: Dict[int, threading.Timer] = {}
        self._next = itertools.count(1)
        self._lock = threading.Lock()

    def schedule(self, delay_seconds: float, action: Callable[[], None]) -> int:
        token = next(self._next)

        def fire() -> None:
            with self._lock:
                self._timers.pop(token, None)
            action()

        timer = threading.Timer(delay_seconds, fire)
        timer.daemon = True
        with self._lock:
            self._timers[token] = timer
        timer.start()
        return token

    def cancel(self, token: int) -> None:
        with self._lock:
            timer = self._timers.pop(token, None)
        if timer is not None:
            timer.cancel()

    def cancel_all(self) -> None:
        with self._lock:
            timers = list(self._timers.values())
            self._timers.clear()
        for timer in timers:
            timer.cancel()


class ManualScheduler:
    """Virtual-time scheduler for tests (ref SchedulerFake pattern)."""

    def __init__(self) -> None:
        self.now = 0.0
        self._queue: List[Tuple[float, int, Callable[[], None]]] = []
        self._cancelled: set = set()
        self._live: set = set()
        self._next = itertools.count(1)

    def schedule(self, delay_seconds: float, action: Callable[[], None]) -> int:
        token = next(self._next)
        heapq.heappush(self._queue, (self.now + delay_seconds, token, action))
        self._live.add(token)
        return token

    def cancel(self, token: int) -> None:
        # Cancelling an already-fired token is a no-op (callers routinely
        # cancel without knowing whether the timer ran); only live tokens
        # enter the cancelled set, so it cannot grow without bound across
        # long virtual-time soaks.
        if token in self._live:
            self._cancelled.add(token)

    @property
    def pending(self) -> List[Tuple[float, int]]:
        return sorted(
            (t, tok) for (t, tok, _) in self._queue if tok not in self._cancelled
        )

    def advance(self, seconds: float) -> None:
        """Advance virtual time, firing due actions in order."""
        deadline = self.now + seconds
        while self._queue and self._queue[0][0] <= deadline:
            fire_at, token, action = heapq.heappop(self._queue)
            self.now = max(self.now, fire_at)
            self._live.discard(token)
            if token in self._cancelled:
                self._cancelled.discard(token)
                continue
            action()
        self.now = deadline

    def fire_next(self) -> bool:
        while self._queue:
            fire_at, token, action = heapq.heappop(self._queue)
            self._live.discard(token)
            if token in self._cancelled:
                self._cancelled.discard(token)
                continue
            self.now = max(self.now, fire_at)
            action()
            return True
        return False
