"""Per-worker runtime statistics (a copy of
``hypha_tpu/scheduler/statistics.py``).

Reference: crates/scheduler/src/statistics.rs:1-44 — a ``RuntimeStatistic``
trait plus ``RunningMean``, the incremental mean of per-batch milliseconds
that feeds the synchronization simulation. The reference module's
``EwmaMean`` serves no path of the port (nothing constructs it).
"""

from __future__ import annotations

__all__ = ["RuntimeStatistic", "RunningMean"]


class RuntimeStatistic:
    """Accumulates per-batch wall-clock samples; yields an expected value."""

    def record(self, value_ms: float) -> None:
        raise NotImplementedError

    def mean(self) -> float | None:
        """Expected per-batch ms, or None before any sample."""
        raise NotImplementedError


class RunningMean(RuntimeStatistic):
    """Incremental arithmetic mean (crates/scheduler/src/statistics.rs)."""

    def __init__(self) -> None:
        self._count = 0
        self._mean = 0.0

    def record(self, value_ms: float) -> None:
        self._count += 1
        self._mean += (value_ms - self._mean) / self._count

    def mean(self) -> float | None:
        return self._mean if self._count else None

    @property
    def count(self) -> int:
        return self._count
