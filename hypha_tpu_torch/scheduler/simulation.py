"""Synchronization-point simulation: discrete-event fast-forward (a copy of
``hypha_tpu/scheduler/simulation.py``).

Reference: crates/scheduler/src/simulation.rs:3-68 (``BasicSimulation``),
algorithm from rfc/2025-10-16_performance_aware_scheduling.md:88-101.

Given each worker's batch size, expected per-batch time and the time already
elapsed since its last completed batch, repeatedly advance the worker with the
earliest next completion and decrement the remaining sample budget, until the
round target is met or a cap fires. The result tells the batch scheduler how
many more batches each worker should run before the DiLoCo update — the
mechanism that lets heterogeneous workers finish a round simultaneously.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

__all__ = ["WorkerSim", "Projection", "project"]


@dataclass(frozen=True, slots=True)
class WorkerSim:
    """Inputs for one worker.

    ``mean_batch_ms`` None means no statistics yet — the worker is simulated
    only if every worker has statistics (the reference projects after each
    worker reported at least one Status)."""

    batch_size: int
    mean_batch_ms: float | None
    elapsed_ms: float = 0.0  # time since this worker's last completed batch


@dataclass(frozen=True, slots=True)
class Projection:
    time_ms: float  # simulated wall-clock until the round target is met
    left: int  # samples still unassigned when simulation stopped
    updates: tuple  # per-worker batch counts to run before the sync point
    capped: bool  # True when time_cap/updates_cap stopped the simulation
    # True when the cap is "a worker has no statistics yet" — its capacity
    # is unknown, not zero, so callers must not memoize the shortfall
    # (the batch scheduler's O(1) capped-sim fast path keys on this).
    no_stats: bool = False


def project(
    remaining: int,
    workers: list[WorkerSim],
    time_cap_ms: float = 10_000.0,
    updates_cap: int = 3,
) -> Projection:
    """Fast-forward the round.

    Caps (reference hardcodes time_cap=10_000 ms, update_cap=3 —
    crates/scheduler/src/scheduling/batch_scheduler.rs:87-89): a projection
    that would make any single worker run more than ``updates_cap`` extra
    batches *beyond the point where the target was reachable*, or run past
    ``time_cap_ms``, is marked capped so the scheduler keeps the workers
    training instead of scheduling a far-future sync point.
    """
    n = len(workers)
    updates = [0] * n
    if remaining <= 0:
        return Projection(0.0, max(remaining, 0), tuple(updates), False)
    if n == 0 or any(w.mean_batch_ms is None for w in workers):
        return Projection(0.0, remaining, tuple(updates), True, no_stats=True)

    # Priority queue of (next_completion_time_ms, index).
    heap: list[tuple[float, int]] = []
    for i, w in enumerate(workers):
        first = max(w.mean_batch_ms - w.elapsed_ms, 0.0)
        heapq.heappush(heap, (first, i))

    time_ms = 0.0
    while remaining > 0:
        t, i = heapq.heappop(heap)
        if t > time_cap_ms:
            return Projection(time_ms, remaining, tuple(updates), True)
        if updates[i] + 1 > updates_cap:
            return Projection(time_ms, remaining, tuple(updates), True)
        time_ms = t
        updates[i] += 1
        remaining -= workers[i].batch_size
        heapq.heappush(heap, (t + workers[i].mean_batch_ms, i))

    return Projection(time_ms, 0, tuple(updates), False)
