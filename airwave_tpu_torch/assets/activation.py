"""Latest-wins activation coordination.

Port of airwave_tpu/assets/activation.py, the same host code: the port keeps
its own copy and imports no module of the JAX package.

Re-implements Airwave/PresetActivationCoordinator.swift:4-138:
generic dedup/cancel wrapper for asynchronous activation work — a generation
counter drops stale completions, an in-flight key dedups identical requests,
and newer requests cancel older ones (newest wins).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional


@dataclasses.dataclass
class CancellationToken:
    cancelled: bool = False

    def cancel(self) -> None:
        self.cancelled = True


class PresetActivationCoordinator:
    """work(key, token, done) runs (possibly async); `done(result)` resolves.

    Completions are delivered only for the newest request; duplicates of the
    in-flight key are coalesced (their completions all fire on resolution).
    """

    def __init__(self, run_async: Optional[Callable[[Callable], None]] = None):
        # run_async seam: production uses a worker thread; tests run inline.
        self._run_async = run_async or (lambda fn: fn())
        self._lock = threading.Lock()
        self._generation = 0
        self._inflight_key: Optional[Any] = None
        self._inflight_token: Optional[CancellationToken] = None
        self._completions: list = []

    def request(self, key: Any, work: Callable, completion: Callable) -> None:
        with self._lock:
            if self._inflight_key == key and self._inflight_token is not None \
                    and not self._inflight_token.cancelled:
                self._completions.append(completion)
                return  # coalesce duplicate
            # Newest wins: cancel the in-flight request.
            if self._inflight_token is not None:
                self._inflight_token.cancel()
            self._generation += 1
            generation = self._generation
            token = CancellationToken()
            self._inflight_key = key
            self._inflight_token = token
            self._completions = [completion]

        def done(result: Any) -> None:
            with self._lock:
                if generation != self._generation:
                    return  # stale (newer request superseded us)
                completions = list(self._completions)
                self._completions = []
                self._inflight_key = None
                self._inflight_token = None
            for resolve in completions:
                resolve(result)

        def run() -> None:
            try:
                work(key, token, done)
            except BaseException:
                # work escaped without resolving: clear the in-flight entry
                # (generation-guarded — a newer request may own it by now)
                # so later same-key requests dispatch fresh work instead of
                # coalescing forever behind a completion that cannot fire.
                with self._lock:
                    if generation == self._generation:
                        self._completions = []
                        self._inflight_key = None
                        self._inflight_token = None
                raise

        self._run_async(run)
