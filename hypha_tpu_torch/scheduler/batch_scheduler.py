"""The DiLoCo control-plane state machine (a copy of
``hypha_tpu/scheduler/batch_scheduler.py``; a worker departing or joining
mid-round is the tracker's ``remove_worker`` / ``add_worker``, as in the
reference).

Reference: crates/scheduler/src/scheduling/batch_scheduler.rs:42-163.
Per-worker lifecycle (mermaid at :45-52):

    TRAINING --(projection says round reachable)--> UPDATE_SCHEDULED
    UPDATE_SCHEDULED --(worker sent delta: Update)--> UPDATING
    UPDATING --(worker merged broadcast: UpdateReceived)--> TRAINING | DONE

The parameter server's ``Updated`` advances the round; with a sharded
service (``shards_due``: round -> the shards that close it,
``stream.sync.shards_due_at``) the round advances once every due shard
reported, and a shard's ``Updated`` is answered ``Done`` after its last
owned round. On every worker
``Status`` the scheduler records timing, decrements the round's sample
counter, and runs the synchronization simulation with hard caps
time_cap=10_000 ms / updates_cap=3 (:87-89); when the projection reaches the
target uncapped it replies ``ScheduleUpdate{counter}`` telling that worker how
many more batches to run before shipping its pseudo-gradient. The job is
complete when every worker is DONE.

With ``adaptive`` (an ``ft.adaptive.StragglerController``) each worker's
sync point is the controller's assignment instead of the projection: every
Status feeds its batch cadence, the server's ``arrival_s`` in an
``Updated`` feeds its per-step cost, each advance freezes the next round's
assignments, and a worker's first Status of a round is answered
``ScheduleUpdate{counter_for(peer)}`` at once.

A restarted scheduler (``generation`` >= 2, ``ft.durable.DurableScheduler``)
stamps its generation and the round into every response, refuses traffic
stamped with a newer generation than its own (it is then the zombie), and
fast-forwards to the fleet's round with ``adopt_round``. A never-restarted
scheduler (``generation`` None) answers with the reference's frozen
singletons, byte for byte, and refuses any stamped traffic: senders stamp
only after adopting generation 2. Refusals are counted in
``stale_generation_dropped`` and in ``FT_METRICS``. A
shard reports a committed round as closed in its AdoptAck
(``worker/ps_executor.py``), so ``adopt_round`` can credit a shard's last
owned round while its UPDATED for it is still parked: the job then
completes only once that notify is answered, or the shard would be left
retrying against a scheduler that is gone. Every message's handling
time goes into the control-loop timing reservoir
(``SCALE_METRICS.note_sched_progress``).

This module is pure logic: the network layer feeds it decoded Progress
messages and returns its ProgressResponse to the peer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from ..messages import (
    Progress,
    ProgressKind,
    ProgressResponse,
    ProgressResponseKind,
)
from ..telemetry import trace
from ..telemetry.ft_metrics import FT_METRICS, SCALE_METRICS
from .simulation import project
from .trackers import ProgressTracker, WorkerState

__all__ = ["BatchScheduler", "TIME_CAP_MS", "UPDATES_CAP"]

# Hard simulation caps (batch_scheduler.rs:87-89).
TIME_CAP_MS = 10_000.0
UPDATES_CAP = 3

_CONTINUE = ProgressResponse(kind=ProgressResponseKind.CONTINUE)
_OK = ProgressResponse(kind=ProgressResponseKind.OK)
_DONE = ProgressResponse(kind=ProgressResponseKind.DONE)

class BatchScheduler:
    def __init__(
        self,
        tracker: ProgressTracker,
        on_metrics: Callable[[str, int, dict], None] | None = None,
        on_complete: Callable[[], None] | None = None,
        time_cap_ms: float = TIME_CAP_MS,
        updates_cap: int = UPDATES_CAP,
        shards_due: "Callable[[int], tuple[int, ...]] | None" = None,
        adaptive=None,
        generation: int | None = None,
    ) -> None:
        self.tracker = tracker
        self._on_metrics = on_metrics
        self._on_complete = on_complete
        self.time_cap_ms = time_cap_ms
        self.updates_cap = updates_cap
        self.completed = False
        # Which shards must report UPDATED before round r advances; None
        # is one unsharded server (shard 0, every round). While a shard
        # restarts, a round waits only on its due shards: the others'
        # UPDATED are kept and the frontier catches up once it reports.
        self.shards_due = shards_due
        # round -> shards that have reported UPDATED for it.
        self._updated: dict[int, set[int]] = {}
        # shard -> the last round it owns (memo for _shard_done).
        self._last_owned: dict[int, int] = {}
        # Round schedule plan: the first successful projection of a round
        # fixes the sync point for EVERY worker it simulated —
        # (round, membership_version, peer -> planned batch count). Later
        # TRAINING Statuses claim their assignment with one dict lookup
        # instead of re-running the O(N log N) event simulation per worker.
        # Invalidated by the round advancing and by any membership change.
        self._round_plan: "tuple[int, int, dict[str, int]] | None" = None
        # Capped-projection memo: a projection that capped `left` samples
        # short measured the fleet's assignable capacity = counter - left.
        # No projection can succeed until the counter falls below it, so
        # early-round Statuses skip the simulation with one compare. Keyed
        # on (round, sim_batch_total, membership_version, stats_version) so
        # a round advance, membership change, or a worker speeding up/down
        # >10% re-measures; the no-stats cap is never memoized (capacity is
        # unknown there, not zero).
        self._sim_skip: "tuple[int, int, int, int, int] | None" = None
        # Straggler-adaptive inner steps: the controller's assignments
        # replace the projection; None keeps the projection path.
        self.adaptive = adaptive
        # A restarted scheduler's generation (>= 2), stamped with the round
        # into every response; None keeps the frozen singletons.
        self.generation = generation
        self.stale_generation_dropped = 0
        # Shards whose last owned round adopt_round credited from their
        # AdoptAck: their UPDATED for it is still parked, so the job
        # completes only once it is answered (DONE ends their loop).
        self._owed: set = set()
        # Round tracing (telemetry.trace): the scheduler owns each round's
        # root span, opened when the round starts and closed when it
        # advances; its context rides SCHEDULE_UPDATE to the workers and
        # the UPDATED answer to the server. Off, every response keeps its
        # traceparent at None: the untraced wire.
        self._round_span: "trace.TraceSpan | None" = None
        self._round_span_num = -1
        if trace.active() is not None:
            # Round 0 opens eagerly: construction precedes dispatch, so the
            # root's start bounds every peer's round-0 spans from below,
            # the anchor the timeline aligns clocks on.
            self._round_tp()

    # ------------------------------------------------------------------
    def on_progress(self, peer: str, progress: Progress) -> ProgressResponse:
        # Control-loop timing reservoir: one perf_counter pair a message.
        t0 = time.perf_counter()
        try:
            return self._on_progress_gated(peer, progress)
        finally:
            SCALE_METRICS.note_sched_progress((time.perf_counter() - t0) * 1000.0)

    def _on_progress_gated(self, peer: str, progress: Progress) -> ProgressResponse:
        sender_gen = progress.scheduler_generation
        if sender_gen is not None and (self.generation is None or sender_gen > self.generation):
            # Split-brain guard: this message was addressed to a newer
            # scheduler generation, so this one is the zombie predecessor
            # and must not act on it (an unstamped scheduler is generation
            # 1, and senders stamp only from generation 2).
            self.stale_generation_dropped += 1
            FT_METRICS.stale_generation_dropped.add(1)
            return ProgressResponse(
                kind=ProgressResponseKind.ERROR,
                message=(f"stale scheduler generation {self.generation or 1} "
                         f"(sender adopted {sender_gen})"),
            )
        return self._stamp(self._on_progress(peer, progress))

    def _stamp(self, resp: ProgressResponse) -> ProgressResponse:
        """Stamp the generation and round (a no-op before any restart)."""
        if self.generation is None:
            return resp
        return dataclasses.replace(resp, generation=self.generation, round=self.tracker.round)

    def _round_tp(self) -> str | None:
        """The current round's root-span context (opens it on first use)."""
        tracing = trace.active()
        if tracing is None:
            return None
        r = self.tracker.round
        if self._round_span is None or self._round_span_num != r:
            if self._round_span is not None:
                tracing.finish(self._round_span)
                self._round_span = None
            if r < self.tracker.update_epochs:
                self._round_span = tracing.begin("round", attrs={"round": r}, node="scheduler")
            self._round_span_num = r
        return self._round_span.traceparent if self._round_span is not None else None

    def _close_round_span(self) -> None:
        tracing = trace.active()
        if tracing is not None and self._round_span is not None:
            tracing.finish(self._round_span)
        self._round_span = None

    def adopt_round(self, base_round: int, shard_rounds: "dict | None" = None,
                    ctrl: "dict | None" = None) -> int:
        """Fast-forward to the fleet's round after a scheduler restart.

        ``base_round`` is the journal's last frontier; ``shard_rounds`` maps
        each adopted shard to the next round it will close (its AdoptAck):
        every owned round below it is an UPDATED the predecessor processed
        or that died with it, so it is credited and the frontier re-advances
        as the live notifies would have moved it. Never rewinds. ``ctrl``
        is the journaled straggler-controller snapshot: the rebuilt
        controller resumes its history in warmup. Returns the round."""
        epochs = self.tracker.update_epochs
        while self.tracker.round < min(base_round, epochs):
            self.tracker.advance_round()
        horizon = max([self.tracker.round] + [int(r) for r in (shard_rounds or {}).values()])
        for shard, reported in (shard_rounds or {}).items():
            for rnd in range(self.tracker.round, min(int(reported), epochs)):
                if shard in self._due(rnd):
                    self._updated.setdefault(rnd, set()).add(shard)
            if 0 < int(reported) and self._shard_done(int(shard), int(reported) - 1):
                self._owed.add(int(shard))
        while (self.tracker.round < min(horizon, epochs)
               and self._updated.get(self.tracker.round, set()) >= self._due(self.tracker.round)):
            self._updated.pop(self.tracker.round, None)
            self.tracker.advance_round()
        if self.adaptive is not None:
            self.adaptive.resume_warmup(self.tracker.round, ctrl)
        self._round_tp()  # rotate the root span onto the adopted round
        return self.tracker.round

    def _on_progress(self, peer: str, progress: Progress) -> ProgressResponse:
        kind = progress.kind
        if kind == ProgressKind.STATUS:
            return self._on_status(peer, progress)
        if kind == ProgressKind.METRICS:
            if self._on_metrics is not None:
                self._on_metrics(peer, progress.round, dict(progress.metrics))
            return _OK
        if kind == ProgressKind.UPDATE:
            # Worker finished its countdown and shipped its pseudo-gradient.
            if self.tracker.tracked(peer):
                self.tracker.set_state(peer, WorkerState.UPDATING)
            return _OK
        if kind == ProgressKind.UPDATED:
            # Parameter server applied the outer step and broadcast weights.
            # Only the designated PS peer may advance the round.
            if peer not in self.tracker.parameter_servers:
                return ProgressResponse(
                    kind=ProgressResponseKind.ERROR, message="not the parameter server"
                )
            return self._on_updated(progress)
        if kind == ProgressKind.UPDATE_RECEIVED:
            return self._on_update_received(peer)
        return ProgressResponse(
            kind=ProgressResponseKind.ERROR, message=f"unknown progress kind {kind}"
        )

    # ------------------------------------------------------------------
    def _due(self, round_num: int) -> set:
        if self.shards_due is None:
            return {0}
        return set(self.shards_due(round_num))

    def _shard_done(self, shard: int, after_round: int) -> bool:
        """No owned round left for ``shard`` after ``after_round``: its
        aggregation loop should terminate. A stream shard's last owned
        round can come before the job's last round, and the scheduler
        owns ``update_epochs``, so it decides. The shard's last owned
        round is computed once."""
        last = self._last_owned.get(shard)
        if last is None:
            last = -1
            for r in range(self.tracker.update_epochs):
                if shard in self._due(r):
                    last = r
            self._last_owned[shard] = last
        return after_round >= last

    def _on_updated(self, progress: Progress) -> ProgressResponse:
        shard = int(progress.shard or 0)
        rnd = progress.round
        if shard in self._owed:
            self._owed.discard(shard)
            self._maybe_complete()
        if rnd < self.tracker.round:
            # Idempotent by (shard, round): a re-sent notify must not
            # advance again and eat a round.
            return _DONE if self._shard_done(shard, rnd) else _OK
        if self.adaptive is not None:
            # The server's per-peer arrival lags (collect start to the
            # delta's acceptance). A notify without them (a recovered
            # server re-announcing a round) is no evidence of a drop.
            arrival_s = dict(progress.metrics).get("arrival_s")
            if arrival_s is not None:
                self.adaptive.note_round_closed(rnd, arrival_s)
        self._updated.setdefault(rnd, set()).add(shard)
        # Advance while the frontier round has every due shard reported.
        advanced = False
        while (
            self.tracker.round < self.tracker.update_epochs
            and self._updated.get(self.tracker.round, set()) >= self._due(self.tracker.round)
        ):
            self._updated.pop(self.tracker.round, None)
            self.tracker.advance_round()
            advanced = True
        if advanced and self.adaptive is not None:
            # Freeze the next round's assignments before any worker's
            # first Status of it asks for its counter.
            self.adaptive.start_round(self.tracker.round, list(self.tracker.peers))
        # Rotate the root span at the boundary and hand the new round's
        # context to the server, whose next collect opens before any
        # worker reports.
        tp = self._round_tp()
        # DONE terminates this shard's aggregation loop; the workers' own
        # DONE comes with their UpdateReceived once the global round
        # reaches update_epochs.
        done = self._shard_done(shard, rnd)
        if tp is None:
            return _DONE if done else _OK
        return ProgressResponse(
            kind=ProgressResponseKind.DONE if done else ProgressResponseKind.OK, traceparent=tp)

    # ------------------------------------------------------------------
    def _on_status(self, peer: str, progress: Progress) -> ProgressResponse:
        if not self.tracker.tracked(peer):
            return ProgressResponse(
                kind=ProgressResponseKind.ERROR, message="unknown worker"
            )
        state = self.tracker.state(peer)
        if state == WorkerState.DONE:
            return _DONE
        self.tracker.update(peer, progress.batch_size)
        if self.adaptive is not None:
            self.adaptive.note_batch(peer)
        if state != WorkerState.TRAINING:
            # Already counting down / mid-update: keep going.
            return _CONTINUE
        if self.adaptive is not None:
            # The worker's sync point is its frozen assignment; the
            # sample-weighted fold keeps the mean unbiased.
            counter = self.adaptive.counter_for(peer)
            self.tracker.set_state(peer, WorkerState.UPDATE_SCHEDULED)
            return ProgressResponse(kind=ProgressResponseKind.SCHEDULE_UPDATE, counter=counter,
                                    traceparent=self._round_tp())
        # O(1) reachability lower bound: the projection can assign at most
        # ``updates_cap`` batches per producing worker before a cap fires,
        # so while the round's remaining counter exceeds
        # Σ batch_size × updates_cap the full simulation is GUARANTEED
        # capped and its verdict is CONTINUE.
        if self.tracker.counter > self.tracker.sim_batch_total * self.updates_cap:
            return _CONTINUE

        # Claim this round's cached plan if one exists. The claimant's
        # very Status completed one of its planned batches (a TRAINING
        # worker claims on its FIRST Status after the plan lands), so the
        # handed-out counter is the planned share minus one.
        plan = self._round_plan
        if (
            plan is not None
            and plan[0] == self.tracker.round
            and plan[1] == self.tracker.membership_version
            # A worker already in the next round (its UPDATE_RECEIVED beat
            # the PS's UPDATED) must not claim the old round's share.
            and progress.round in (None, plan[0])
        ):
            planned = plan[2].get(peer)
            if planned is not None:
                self.tracker.set_state(peer, WorkerState.UPDATE_SCHEDULED)
                return ProgressResponse(
                    kind=ProgressResponseKind.SCHEDULE_UPDATE,
                    counter=max(planned - 1, 0),
                    traceparent=self._round_tp(),
                )
            # Joined after the plan was fixed: fall through to a fresh sim.

        # Capped-memo fast negative: until the counter drops below the
        # last measured capacity the simulation caps again with the same
        # CONTINUE verdict.
        skip = self._sim_skip
        if (
            skip is not None
            and skip[0] == self.tracker.round
            and skip[1] == self.tracker.sim_batch_total
            and skip[2] == self.tracker.membership_version
            and skip[3] == self.tracker.stats_version
            and self.tracker.counter > skip[4]
        ):
            return _CONTINUE

        # Simulate all workers still producing batches this round.
        sim_peers = [
            p
            for p, s in zip(self.tracker.peers, self.tracker.states)
            if s in (WorkerState.TRAINING, WorkerState.UPDATE_SCHEDULED)
        ]
        workers = self.tracker.sims(sim_peers)
        projection = project(
            self.tracker.counter, workers, self.time_cap_ms, self.updates_cap
        )
        if projection.capped or projection.left > 0:
            if projection.left > 0 and not projection.no_stats:
                self._sim_skip = (
                    self.tracker.round,
                    self.tracker.sim_batch_total,
                    self.tracker.membership_version,
                    self.tracker.stats_version,
                    self.tracker.counter - projection.left,
                )
            return _CONTINUE
        # Round target reachable: schedule this worker's sync point and
        # fix the round's plan for everyone else it simulated.
        counter = projection.updates[sim_peers.index(peer)]
        self._round_plan = (
            self.tracker.round,
            self.tracker.membership_version,
            dict(zip(sim_peers, projection.updates)),
        )
        self.tracker.set_state(peer, WorkerState.UPDATE_SCHEDULED)
        return ProgressResponse(
            kind=ProgressResponseKind.SCHEDULE_UPDATE, counter=counter,
            traceparent=self._round_tp(),
        )

    def _maybe_complete(self) -> None:
        if self.tracker.all_in(WorkerState.DONE) and not self.completed and not self._owed:
            self.completed = True
            self._close_round_span()
            if self._on_complete is not None:
                self._on_complete()

    # ------------------------------------------------------------------
    def _on_update_received(self, peer: str) -> ProgressResponse:
        if not self.tracker.tracked(peer):
            return ProgressResponse(
                kind=ProgressResponseKind.ERROR, message="unknown worker"
            )
        if self.tracker.round >= self.tracker.update_epochs:
            self.tracker.set_state(peer, WorkerState.DONE)
            self._maybe_complete()
            return _DONE
        # Next round: back to training with a fresh timing baseline.
        self.tracker.set_state(peer, WorkerState.TRAINING)
        i = self.tracker.index_of(peer)
        self.tracker.last_update[i] = self.tracker._clock()
        tp = self._round_tp()
        if tp is None:
            return _CONTINUE
        # Traced jobs hand the worker the new round's context with the
        # Continue that starts it, so its inner_steps span parents right.
        return ProgressResponse(kind=ProgressResponseKind.CONTINUE, traceparent=tp)
