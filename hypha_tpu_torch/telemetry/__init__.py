"""Instruments of the port (counterpart of ``hypha_tpu/telemetry``): only
the monotonic :class:`Counter` that ``ft_metrics.DataMetrics`` counts with.
The exporters, traces and the metrics plane are not ported (ROADMAP.md,
Queue 1: telemetry)."""

from __future__ import annotations

import threading

__all__ = ["Counter"]


class Counter:
    """Monotonic sum instrument."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def add(self, amount: float) -> None:
        if amount < 0:
            raise ValueError("counter increments must be non-negative")
        with self._lock:
            # float() here: a numpy or torch scalar increment would keep a
            # non-JSON scalar in every snapshot.
            self._value += float(amount)

    def value(self) -> float:
        with self._lock:
            return self._value
