"""Resource accounting: capacity minus live reservations (a copy of
``hypha_tpu/worker/resources_mgr.py``).

Reference: crates/worker/src/resources.rs:18-92 — a ``ResourceManager``
trait and ``StaticResourceManager`` holding configured capacity, with
reserve/release double-checked under a write lock.
"""

from __future__ import annotations

import threading

from ..resources import InsufficientResources, Resources

__all__ = ["ResourceManager", "StaticResourceManager"]


class ResourceManager:
    def capacity(self) -> Resources:
        raise NotImplementedError

    def available(self) -> Resources:
        raise NotImplementedError

    def reserve(self, request: Resources, reservation_id: str) -> None:
        """Atomically reserve; raises InsufficientResources if it doesn't fit."""
        raise NotImplementedError

    def release(self, reservation_id: str) -> None:
        raise NotImplementedError


class StaticResourceManager(ResourceManager):
    """Fixed configured capacity (a host's accelerators/cores/memory)."""

    def __init__(self, capacity: Resources) -> None:
        self._capacity = capacity
        self._lock = threading.Lock()
        self._reservations: dict[str, Resources] = {}

    def capacity(self) -> Resources:
        return self._capacity

    def available(self) -> Resources:
        with self._lock:
            return self._available_locked()

    def _available_locked(self) -> Resources:
        out = self._capacity
        for r in self._reservations.values():
            got = out.checked_sub(r)
            if got is None:  # defensive: reservations can never exceed capacity
                return Resources()
            out = got
        return out

    def reserve(self, request: Resources, reservation_id: str) -> None:
        with self._lock:
            if reservation_id in self._reservations:
                raise ValueError(f"duplicate reservation {reservation_id}")
            if self._available_locked().checked_sub(request) is None:
                raise InsufficientResources(f"cannot reserve {request}")
            self._reservations[reservation_id] = request

    def release(self, reservation_id: str) -> None:
        with self._lock:
            self._reservations.pop(reservation_id, None)
