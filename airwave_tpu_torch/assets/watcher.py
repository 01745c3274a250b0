"""Debounced directory watcher (FSEvents analog, scheduler-driven polling).

The reference watches its preset directories with FSEvents and a 0.2 s
debounce (Airwave/HRIRManager.swift:580-627,
EqualizerManager.swift:181-230). Portable equivalent: poll the directory
fingerprint on the injectable scheduler; changes schedule a debounced reload.

Port of airwave_tpu/assets/watcher.py, the same host code: the port keeps
its own copy and imports no module of the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from airwave_tpu_torch.config import DEFAULT_CONFIG
from airwave_tpu_torch.runtime.scheduler import Scheduler


def directory_fingerprint(directory: str) -> tuple:
    try:
        entries = []
        with os.scandir(directory) as it:
            for entry in it:
                try:
                    stat = entry.stat()
                    entries.append((entry.name, stat.st_mtime_ns, stat.st_size))
                except OSError:
                    continue
        return tuple(sorted(entries))
    except OSError:
        return ()


class DirectoryWatcher:
    def __init__(
        self,
        directory: str,
        on_change: Callable[[], None],
        scheduler: Scheduler,
        poll_interval: float = 0.5,
        debounce: float = DEFAULT_CONFIG.preset_watch_debounce_seconds,
    ) -> None:
        self.directory = directory
        self.on_change = on_change
        self.scheduler = scheduler
        self.poll_interval = poll_interval
        self.debounce = debounce
        self._fingerprint = directory_fingerprint(directory)
        self._debounce_token: Optional[int] = None
        self._poll_token: Optional[int] = None
        self._stopped = False

    def start(self) -> None:
        self._schedule_poll()

    def stop(self) -> None:
        self._stopped = True
        for token in (self._poll_token, self._debounce_token):
            if token is not None:
                self.scheduler.cancel(token)

    def _schedule_poll(self) -> None:
        if self._stopped:
            return
        self._poll_token = self.scheduler.schedule(self.poll_interval, self._poll)

    def _poll(self) -> None:
        if self._stopped:
            return
        current = directory_fingerprint(self.directory)
        if current != self._fingerprint:
            self._fingerprint = current
            # Debounce: restart the window on every change burst.
            if self._debounce_token is not None:
                self.scheduler.cancel(self._debounce_token)

            def fire() -> None:
                self._debounce_token = None
                if not self._stopped:
                    self.on_change()

            self._debounce_token = self.scheduler.schedule(self.debounce, fire)
        self._schedule_poll()
