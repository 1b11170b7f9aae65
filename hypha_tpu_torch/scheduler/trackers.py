"""Progress, worker and slice trackers (a copy of
``hypha_tpu/scheduler/trackers.py``).

Reference: crates/scheduler/src/tracker/{progress.rs,worker.rs,slice.rs}
(SURVEY.md §2.4). Pure logic with an injectable clock for deterministic tests.
"""

from __future__ import annotations

import enum
import time
from typing import Callable

from .simulation import WorkerSim
from .statistics import RunningMean, RuntimeStatistic

__all__ = ["WorkerState", "ProgressTracker", "SliceTracker"]


class WorkerState(enum.Enum):
    """Per-worker DiLoCo round state
    (crates/scheduler/src/tracker/worker.rs:7-114; mermaid in
    scheduling/batch_scheduler.rs:45-52)."""

    TRAINING = "training"
    UPDATE_SCHEDULED = "update-scheduled"
    UPDATING = "updating"
    UPDATE_RECEIVED = "update-received"
    DONE = "done"


class ProgressTracker:
    """Round bookkeeping: a global sample counter plus per-worker timing stats.

    Reference: crates/scheduler/src/tracker/progress.rs:9-67 and
    tracker/worker.rs — per-worker parallel arrays of peer id, batch size,
    time of last status, runtime statistic and state. ``update()`` decrements
    the global counter by the reported batch and feeds the elapsed
    milliseconds into that worker's statistic.
    """

    def __init__(
        self,
        parameter_server: "str | list[str]",
        update_target: int,
        update_epochs: int,
        stat_factory: Callable[[], RuntimeStatistic] = RunningMean,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        # Sharded parameter service: a list names every shard peer (any of
        # them may report UPDATED); a plain string is the single-PS form.
        # ``parameter_server`` stays the first peer for existing callers.
        servers = (
            [parameter_server]
            if isinstance(parameter_server, str)
            else list(parameter_server)
        )
        self.parameter_servers: list[str] = servers
        self.parameter_server = servers[0] if servers else ""
        self.update_target = update_target  # avg_samples_between_updates
        self.update_epochs = update_epochs  # number of outer rounds
        self.counter = update_target  # samples left in the current round
        self.round = 0
        self._clock = clock
        self._stat_factory = stat_factory
        self.round_start = clock()
        # parallel arrays
        self.peers: list[str] = []
        self.batch_sizes: list[int] = []
        self.last_update: list[float] = []  # clock() of last completed batch
        self.stats: list[RuntimeStatistic] = []
        self.states: list[WorkerState] = []
        # O(1) lookups at fleet scale: peer → array index, a
        # per-state census, and the Σ batch_size over workers still
        # producing this round (TRAINING / UPDATE_SCHEDULED — the batch
        # scheduler's reachability lower bound). All maintained
        # incrementally: every mutation funnels through add/remove/
        # set_state, so per-Status work stays independent of N.
        self._index: dict[str, int] = {}
        self._state_counts: dict[WorkerState, int] = {s: 0 for s in WorkerState}
        self.sim_batch_total = 0
        # Invalidation feeds for the batch scheduler's cached round plan
        # and capped-capacity memo. A mid-round depart must re-spread the
        # dead worker's planned share, and a materially faster fleet must
        # re-measure its assignable capacity — both caches key on these
        # versions so staleness is bounded to one Status.
        self.membership_version = 0
        # Bumped when any worker's mean drifts >10% (either direction)
        # from the value at its last bump: a projection's time-capped
        # capacity is only as fresh as the speeds it simulated. The 10%
        # hysteresis keeps converged EWMAs from bumping every Status.
        self.stats_version = 0
        self._stat_base: list[float | None] = []

    _SIM_STATES = (WorkerState.TRAINING, WorkerState.UPDATE_SCHEDULED)

    # -- membership ---------------------------------------------------------
    def add_worker(self, peer: str, batch_size: int) -> None:
        if peer in self._index:
            raise ValueError(f"worker {peer!r} already tracked")
        self._index[peer] = len(self.peers)
        self.peers.append(peer)
        self.batch_sizes.append(batch_size)
        self.last_update.append(self._clock())
        self.stats.append(self._stat_factory())
        self.states.append(WorkerState.TRAINING)
        self._state_counts[WorkerState.TRAINING] += 1
        self.sim_batch_total += batch_size
        self._stat_base.append(None)
        self.membership_version += 1

    def index_of(self, peer: str) -> int:
        try:
            return self._index[peer]
        except KeyError:
            raise ValueError(f"{peer!r} is not tracked") from None

    def tracked(self, peer: str) -> bool:
        """O(1) membership — ``peer in tracker.peers`` scans the list."""
        return peer in self._index

    def remove_worker(self, peer: str) -> None:
        i = self._index.pop(peer)
        self._state_counts[self.states[i]] -= 1
        if self.states[i] in self._SIM_STATES:
            self.sim_batch_total -= self.batch_sizes[i]
        for arr in (self.peers, self.batch_sizes, self.last_update, self.stats, self.states, self._stat_base):
            del arr[i]
        # Membership changes are rare (join/depart); re-basing the index
        # once per change keeps every hot-path lookup O(1).
        for j in range(i, len(self.peers)):
            self._index[self.peers[j]] = j
        self.membership_version += 1

    # -- round progress -----------------------------------------------------
    def update(self, peer: str, batch_size: int) -> None:
        """A worker completed one batch of ``batch_size`` samples."""
        i = self.index_of(peer)
        now = self._clock()
        elapsed_ms = (now - self.last_update[i]) * 1000.0
        self.stats[i].record(elapsed_ms)
        self.last_update[i] = now
        self.counter -= batch_size
        mean = self.stats[i].mean()
        if mean is not None:
            base = self._stat_base[i]
            if base is None or not (0.9 * base <= mean <= base / 0.9):
                self.stats_version += 1
                self._stat_base[i] = mean

    def elapsed_ms(self, peer: str) -> float:
        i = self.index_of(peer)
        return (self._clock() - self.last_update[i]) * 1000.0

    def set_state(self, peer: str, state: WorkerState) -> None:
        i = self.index_of(peer)
        old = self.states[i]
        if old is state:
            return
        self._state_counts[old] -= 1
        self._state_counts[state] += 1
        if (old in self._SIM_STATES) != (state in self._SIM_STATES):
            delta = self.batch_sizes[i]
            self.sim_batch_total += (
                delta if state in self._SIM_STATES else -delta
            )
        self.states[i] = state

    def state(self, peer: str) -> WorkerState:
        return self.states[self.index_of(peer)]

    def all_in(self, *states: WorkerState) -> bool:
        # O(states), not O(N): the census is maintained by set_state.
        return bool(self.states) and sum(
            self._state_counts[s] for s in set(states)
        ) == len(self.states)

    def advance_round(self) -> None:
        """Parameter server reported Updated: reset the sample counter."""
        self.round += 1
        self.counter = self.update_target
        self.round_start = self._clock()

    def sims(self, peers: list[str] | None = None, fresh: bool = False) -> list[WorkerSim]:
        """Simulation inputs for ``peers`` (default: all tracked workers).

        ``fresh=True`` zeroes the elapsed time — projecting a whole round
        from its start (the orchestrator's per-round deadline) instead of
        the in-flight remainder (the batch scheduler's sync point)."""
        if peers is None:
            peers = list(self.peers)
        return [
            WorkerSim(
                batch_size=self.batch_sizes[self.index_of(p)],
                mean_batch_ms=self.stats[self.index_of(p)].mean(),
                elapsed_ms=0.0 if fresh else self.elapsed_ms(p),
            )
            for p in peers
        ]

    def has_full_stats(self) -> bool:
        """Every tracked worker has reported at least one timed batch."""
        return bool(self.stats) and all(s.mean() is not None for s in self.stats)

    @property
    def rounds_left(self) -> int:
        return max(0, self.update_epochs - self.round)

    def is_last_round(self) -> bool:
        # During round k (0-based), k+1 rounds will have completed after the
        # pending update; the job is done when that reaches update_epochs.
        return self.round + 1 >= self.update_epochs


class SliceTracker:
    """Dataset slice assignment with peer affinity, work stealing and epochs.

    Reference: crates/scheduler/src/tracker/slice.rs:35-114 — ``next(peer)``
    prefers unprocessed slices previously assigned to the same peer (cache
    reuse), then steals from the peer with the fewest remaining slices (the
    slowest worker is the one still holding work late in the round), then
    starts a new epoch resetting every slice to available.
    """

    def __init__(self, num_slices: int) -> None:
        if num_slices <= 0:
            raise ValueError("num_slices must be positive")
        self.num_slices = num_slices
        self._assigned: dict[int, str] = {}  # slice -> peer currently assigned
        self._processed: set[int] = set()
        self.epoch = 0

    # -- queries ------------------------------------------------------------
    def available(self) -> list[int]:
        return [
            i
            for i in range(self.num_slices)
            if i not in self._processed and i not in self._assigned
        ]

    def remaining_of(self, peer: str) -> list[int]:
        return [i for i, p in self._assigned.items() if p == peer]

    # -- assignment ---------------------------------------------------------
    def next(self, peer: str, exclude: "frozenset[int] | set[int]" = frozenset()) -> int:
        """Pick the next slice for ``peer`` (slice.rs:65-100).

        ``exclude`` names slices the peer ALREADY HOLDS (prefetch-window
        assignment, scheduler.data_scheduler): the affinity shortcut must
        not hand one of them straight back."""
        # 1. peer-affine: a slice this peer was already assigned (cache reuse)
        mine = [i for i in self.remaining_of(peer) if i not in exclude]
        if mine:
            return mine[0]
        # 2. fresh available slice
        avail = self.available()
        if avail:
            idx = avail[0]
            self._assigned[idx] = peer
            return idx
        # 3. steal from the slowest peer = fewest remaining slices (slice.rs:65-90)
        by_peer: dict[str, list[int]] = {}
        for i, p in self._assigned.items():
            by_peer.setdefault(p, []).append(i)
        victims = [(len(v), p) for p, v in by_peer.items() if p != peer]
        if victims:
            _, victim = min(victims)
            idx = min(by_peer[victim])
            self._assigned[idx] = peer
            return idx
        # 4. everything processed: new epoch, reset all (slice.rs:91-100)
        self.new_epoch()
        idx = 0
        self._assigned[idx] = peer
        return idx

    def mark_processed(self, index: int) -> None:
        self._assigned.pop(index, None)
        self._processed.add(index)

    def new_epoch(self) -> None:
        self.epoch += 1
        self._assigned.clear()
        self._processed.clear()

    def remove_worker(self, peer: str) -> None:
        """Reclaim a dead worker's slices (slice.rs:105-114)."""
        for i in [i for i, p in self._assigned.items() if p == peer]:
            del self._assigned[i]
