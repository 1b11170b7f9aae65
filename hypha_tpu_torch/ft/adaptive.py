"""WAN-adaptive outer rounds (counterpart of ``hypha_tpu/ft/adaptive.py``).

A volunteer pool has 10-100x bandwidth spread and persistent stragglers;
without adaptation a slow peer is either quorum-dropped (its round of
compute is wasted) or holds the round until the deadline (everyone's time
is wasted). Two controllers make per-worker work and per-link bytes follow
measured conditions:

  * :class:`StragglerController` (scheduler side) keeps an EWMA of each
    worker's per-step round-trip cost (from the arrival lags the parameter
    server reports with every ``Updated``, and from the Status cadence) and
    assigns each worker a power-of-two fraction of the base inner steps.
    Assignments ride the round membership (``RoundMembership.inner_steps``)
    and the ``ScheduleUpdate{counter}`` channel; the sample-weighted fold
    keeps the mean unbiased.
  * :class:`LinkTable` (parameter-server side) keeps an EWMA of each peer's
    measured upload bandwidth and maps it onto a wire codec per link
    (:func:`hypha_tpu_torch.compress.codec_for_bandwidth`); the serving
    plane's fleet pulls read the same table for their link estimate.

Both are pure logic with injectable clocks. The reference's ``HET_METRICS``
(telemetry) is not ported: each of its ``note_*`` calls is a log line here
(``assigned steps``, ``link estimate``, ``link codec``), which the smoke
reads.
"""

from __future__ import annotations

import logging
import math
import statistics
import time
from typing import Callable

from ..compress import codec_for_bandwidth

__all__ = ["Ewma", "StragglerController", "LinkTable"]

log = logging.getLogger("hypha.torch.ft.adaptive")


class Ewma:
    """Exponentially weighted moving average; None until the first sample."""

    __slots__ = ("alpha", "_value")

    def __init__(self, alpha: float = 0.4) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError("ewma alpha must be in (0, 1]")
        self.alpha = alpha
        self._value: "float | None" = None

    def update(self, sample: float) -> float:
        if self._value is None:
            self._value = float(sample)
        else:
            self._value = self.alpha * float(sample) + (1.0 - self.alpha) * self._value
        return self._value

    def scale(self, factor: float) -> None:
        """Multiplicative penalty: a quorum-dropped peer yields no arrival
        sample, but its estimate must still move toward slower."""
        if self._value is not None:
            self._value *= float(factor)

    @property
    def value(self) -> "float | None":
        return self._value


class StragglerController:
    """Per-worker inner-step assignment from measured round-trip history.

    * The per-step cost is the larger of two EWMAs: the server's arrival lag
      over the steps run (compute plus upload) and the scheduler's batch
      cadence. A worker that starts during the previous broadcast can land
      with a tiny lag however slow it is, while a bandwidth-starved one
      batches at full speed; each EWMA sees what the other misses. Rounds
      below ``warmup_rounds`` feed no lag (one-time compile dominates them).
    * The assignment keeps the base count while ``t_peer / t_median`` lies
      inside ``deadband``; beyond it the count snaps to the nearest
      power-of-two divisor of the base, clamped to ``[min_steps,
      base * max_boost]``.
    * A peer that no close report credited (quorum-dropped) has its
      estimate scaled by ``drop_penalty`` at the next :meth:`start_round`.
    """

    def __init__(
        self,
        base_steps: int,
        min_steps: int = 1,
        max_boost: float = 1.0,
        alpha: float = 0.4,
        drop_penalty: float = 1.5,
        warmup_rounds: int = 1,
        deadband: float = 1.5,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if base_steps < 1:
            raise ValueError("base_steps must be >= 1")
        if min_steps < 1:
            raise ValueError("min_steps must be >= 1")
        if max_boost < 1.0:
            raise ValueError("max_boost must be >= 1.0 (1.0 = never over-assign)")
        if deadband < math.sqrt(2.0):
            # Below sqrt(2) the band and the power-of-two snapping disagree
            # at the boundary.
            raise ValueError("deadband must be >= sqrt(2)")
        self.base_steps = int(base_steps)
        self.min_steps = int(min_steps)
        self.max_boost = float(max_boost)
        self.drop_penalty = float(drop_penalty)
        self.warmup_rounds = max(int(warmup_rounds), 0)
        self.deadband = float(deadband)
        self._alpha = alpha
        self._clock = clock
        self.round = 0
        # peer -> EWMA of per-step seconds from arrival lags / batch cadence.
        self._per_step: dict = {}
        self._batch: dict = {}
        self._batch_ts: dict = {}
        # This round: batches run, frozen assignments, and per round the
        # peers any close report credited (a sharded service reports once
        # per shard, and a stream shard may report a later round first).
        self._run: dict = {}
        self._assigned: dict = {}
        self._arrived: dict = {}
        # Rounds <= this span a scheduler restart and count as warmup
        # (resume_warmup); -1 = never resumed.
        self._resumed_at = -1

    # -------------------------------------------------------------- feeding
    def note_batch(self, peer: str) -> None:
        """One Status heartbeat from ``peer`` (a completed batch)."""
        now = self._clock()
        prev = self._batch_ts.get(peer)
        self._batch_ts[peer] = now
        if prev is not None and now > prev:
            self._batch.setdefault(peer, Ewma(self._alpha)).update(now - prev)
        self._run[peer] = self._run.get(peer, 0) + 1

    def note_round_closed(self, round_num: int, arrivals: dict) -> None:
        """One close report for ``round_num``: ``arrivals`` maps a peer to
        the seconds from collect start to its delta's acceptance. Reports
        for one round accumulate; the drop penalty waits for
        :meth:`start_round`."""
        if round_num < self.round:
            return  # a recovered server's stale re-notify
        self._arrived.setdefault(round_num, set()).update(str(p) for p in arrivals)
        if round_num <= self._resumed_at or round_num < self.warmup_rounds:
            return  # arrival credit counts, the lags do not
        for peer, lag in arrivals.items():
            try:
                lag_s = float(lag)
            except (TypeError, ValueError):
                continue
            if lag_s <= 0:
                continue
            steps = self._assigned.get(peer) or self._run.get(peer) or self.base_steps
            self._per_step.setdefault(peer, Ewma(self._alpha)).update(lag_s / max(steps, 1))

    def start_round(self, round_num: int, peers: "list | None" = None) -> None:
        """Freeze the next round's assignments; assigned peers that no close
        report credited since the last freeze were quorum-dropped and have
        their estimate scaled by ``drop_penalty``."""
        if self.round >= self.warmup_rounds and self.round > self._resumed_at:
            credited: set = set()
            for rnd, peers_seen in self._arrived.items():
                if rnd >= self.round:
                    credited |= peers_seen
            for peer in set(self._assigned) - credited:
                est = self._per_step.get(peer)
                if est is None:
                    # Never measured at the server: seed from the cadence.
                    est = self._per_step.setdefault(peer, Ewma(self._alpha))
                    fallback = self._batch.get(peer)
                    if fallback is not None and fallback.value is not None:
                        est.update(fallback.value)
                est.scale(self.drop_penalty)
        self.round = round_num
        self._run.clear()
        self._assigned.clear()
        self._arrived = {rnd: seen for rnd, seen in self._arrived.items() if rnd >= round_num}
        # The gap from one round's last batch to the next's first spans the
        # broadcast wait, which is sync latency, not compute.
        self._batch_ts.clear()
        for peer in peers or ():
            self.steps_for(peer)

    # ------------------------------------------------------------- querying
    def _estimate(self, peer: str) -> "float | None":
        values = [e.value for e in (self._per_step.get(peer), self._batch.get(peer))
                  if e is not None and e.value is not None]
        return max(values) if values else None

    def steps_for(self, peer: str) -> int:
        """This round's assignment for ``peer``, frozen at its first query."""
        if self.round <= self._resumed_at:
            return self.base_steps  # published as no assignment
        cached = self._assigned.get(peer)
        if cached is not None:
            return cached
        t_peer = self._estimate(peer)
        known = [v for v in (self._estimate(p) for p in set(self._per_step) | set(self._batch))
                 if v is not None]
        if t_peer is None or not known:
            steps = self.base_steps
        else:
            t_ref = statistics.median(known)
            ratio = max(t_peer, 1e-9) / max(t_ref, 1e-9)  # > 1 = slower
            if 1.0 / self.deadband <= ratio <= self.deadband:
                steps = self.base_steps
            else:
                level = round(math.log2(ratio))
                steps = round(self.base_steps / (2.0 ** level))
            steps = max(self.min_steps, min(steps, max(round(self.base_steps * self.max_boost), 1)))
        self._assigned[peer] = steps
        log.info("assigned steps: round %d peer %s steps %d", self.round, peer, steps)
        return steps

    def counter_for(self, peer: str) -> int:
        """Batches still to run before ``peer``'s sync point (the
        ``ScheduleUpdate{counter}`` payload)."""
        return max(self.steps_for(peer) - self._run.get(peer, 0), 0)

    def assignments(self) -> dict:
        """This round's frozen assignments (``RoundMembership.inner_steps``)."""
        return dict(self._assigned)

    # --------------------------------------------------------- crash recovery
    def snapshot(self) -> dict:
        """The per-peer estimates and the round they speak for (the
        scheduler journal's payload)."""
        return {
            "round": self.round,
            "base_steps": self.base_steps,
            "per_step": {p: e.value for p, e in self._per_step.items() if e.value is not None},
        }

    def resume_warmup(self, round_num: int, snapshot: "dict | None" = None) -> None:
        """Adopt a journaled snapshot after a scheduler restart, in warmup:
        until round ``round_num`` has been measured every peer gets the base
        count, nothing is published and no drop penalty applies; the
        journaled EWMAs seed the estimates."""
        self.round = max(int(round_num), 0)
        self._resumed_at = self.round
        self._run.clear()
        self._assigned.clear()
        self._arrived.clear()
        self._batch_ts.clear()
        self._batch.clear()
        for peer, value in ((snapshot or {}).get("per_step") or {}).items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            if v > 0:
                self._per_step.setdefault(str(peer), Ewma(self._alpha)).update(v)


class LinkTable:
    """Per-peer EWMA of measured bandwidth (bits/s) and the wire codec it
    maps to. ``measured`` gates the first-round deadline grace: an elastic
    round must not drop a peer the table has never seen upload."""

    def __init__(
        self,
        base_codec: str = "none",
        hi_mbps: float = 100.0,
        lo_mbps: float = 10.0,
        alpha: float = 0.4,
        first_round_grace: float = 6.0,
    ) -> None:
        if lo_mbps > hi_mbps:
            raise ValueError("codec bandwidth thresholds need lo <= hi")
        self.base_codec = base_codec
        self.hi_bps = float(hi_mbps) * 1e6
        self.lo_bps = float(lo_mbps) * 1e6
        self.first_round_grace = max(float(first_round_grace), 1.0)
        self._alpha = alpha
        self._bw: dict = {}

    def observe(self, peer: str, nbytes: int, seconds: float) -> float:
        """Record one measured transfer; returns the updated bits/s EWMA."""
        bps = (max(int(nbytes), 1) * 8.0) / max(float(seconds), 1e-6)
        value = self._bw.setdefault(peer, Ewma(self._alpha)).update(bps)
        log.info("link estimate: peer %s %d bytes in %.6f s, estimate %.1f bit/s",
                 peer, int(nbytes), float(seconds), value)
        return value

    def measured(self, peer: str) -> bool:
        est = self._bw.get(peer)
        return est is not None and est.value is not None

    def bandwidth_bps(self, peer: str) -> "float | None":
        """The peer's estimate; None until its first transfer."""
        est = self._bw.get(peer)
        return est.value if est is not None else None

    def codec_for(self, peer: str) -> str:
        bw = self.bandwidth_bps(peer)
        if bw is None:
            return self.base_codec
        codec = codec_for_bandwidth(bw, self.base_codec, self.hi_bps, self.lo_bps)
        log.info("link codec: peer %s %s at %.1f bit/s", peer, codec, bw)
        return codec

    # --------------------------------------------------------- crash recovery
    def snapshot(self) -> dict:
        """Peer -> bits/s, the shape :meth:`restore` seeds from (no journal
        holds it yet: ``adaptive_codec`` refuses ``checkpoint_dir``)."""
        return {peer: est.value for peer, est in self._bw.items() if est.value is not None}

    def restore(self, snapshot: dict) -> None:
        """Seed the table from a snapshot; restored estimates count as
        measured."""
        for peer, value in (snapshot or {}).items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            if v > 0:
                self._bw.setdefault(str(peer), Ewma(self._alpha)).update(v)
