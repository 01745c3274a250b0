"""Schema-versioned JSON key-value persistence (UserDefaults analog).

Port of airwave_tpu/assets/store.py, the same host code: the port keeps its
own copy and imports no module of the JAX package.

The reference persists device profiles in UserDefaults under a
schema-versioned envelope (Airwave/DeviceProfileManager.swift:45,
102-116, 317-320). Here: an atomic-write JSON file store with the same
envelope discipline.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional


class JSONStore:
    def __init__(self, path: str) -> None:
        self.path = path

    def load(self) -> Optional[dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return None
        return data if isinstance(data, dict) else None

    def save(self, payload: dict) -> None:
        directory = os.path.dirname(self.path) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def load_versioned(store: JSONStore, expected_version: int) -> Optional[Any]:
    """Read an envelope {schemaVersion, payload}; reject other versions."""
    data = store.load()
    if data is None:
        return None
    if data.get("schemaVersion") != expected_version:
        return None
    return data.get("payload")


def save_versioned(store: JSONStore, version: int, payload: Any) -> None:
    store.save({"schemaVersion": version, "payload": payload})
