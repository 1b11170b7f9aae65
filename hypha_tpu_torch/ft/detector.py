"""Phi-accrual failure detection over heartbeat arrivals (a copy of
``hypha_tpu/ft/detector.py``, which imports no JAX; the port may not
import the JAX package, so it keeps its own).

Hayashibara et al., "The φ Accrual Failure Detector" (2004): instead of a
boolean alive/dead verdict, expose a continuous suspicion level

    φ(t) = -log10( P_later(t - t_last) )

where ``P_later`` is the probability that a heartbeat arrives later than the
current silence, under a normal distribution fitted to the observed
inter-arrival history. φ grows without bound while a peer is silent and
drops back to ~0 the moment a heartbeat lands (re-heal), so a threshold
crossing is a *tunable* trade between detection latency and false positives
— exactly what an unreliable permissioned swarm needs on top of the hard
lease-renewal signal (worker/lease_manager.py): renewals are seconds apart,
per-batch ``Status`` progress events are tens of milliseconds apart, and the
detector consumes both streams without caring which is which.

Pure logic with an injectable clock for deterministic tests.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable

__all__ = ["PhiAccrualDetector", "PHI_THRESHOLD_DEFAULT"]

# Cassandra's production default is 8 (~a 1-in-10^8 chance the peer is
# actually alive); we keep the same order of magnitude.
PHI_THRESHOLD_DEFAULT = 8.0

# Floor on the fitted standard deviation: a perfectly regular heartbeat
# (simulated clocks, in-process tests) would otherwise make φ a step
# function that fires on the first microsecond of jitter.
_MIN_STD_S = 0.05

# NOTE: a peer that dies with fewer than ``min_samples`` recorded intervals
# is never suspected by φ (phi() returns 0.0 below the warm-up gate, by
# design — see PhiAccrualDetector.min_samples).  Early death is caught by
# the lease-renewal failure path instead, which needs no distribution.


def _phi_of_z(z: float) -> float:
    """φ as a function of the standardized silence z (the exact formula
    :meth:`PhiAccrualDetector.phi` evaluates, including its underflow
    fallback) — strictly monotone increasing."""
    p_later = 0.5 * math.erfc(z)
    if p_later <= 0.0:
        return z * z / math.log(10.0)
    return -math.log10(p_later)


def _solve_z(threshold: float) -> float:
    """The z where φ crosses ``threshold``, by bisection (φ is monotone;
    one solve per detector, reused for every peer's suspect_at)."""
    lo, hi = -10.0, 10.0
    while _phi_of_z(hi) < threshold:
        hi *= 2.0
        if hi > 1e6:  # pathological threshold; fall back to "always check"
            return float("-inf")
    for _ in range(200):
        mid = (lo + hi) / 2.0
        if _phi_of_z(mid) < threshold:
            lo = mid
        else:
            hi = mid
    return hi


class _PeerHistory:
    __slots__ = ("intervals", "last", "_sum", "_sum_sq", "suspect_at")

    def __init__(self, now: float, window: int) -> None:
        self.intervals: deque[float] = deque(maxlen=window)
        self.last = now
        self._sum = 0.0
        self._sum_sq = 0.0
        # Earliest clock() at which φ can reach the detector's threshold
        # (solved in closed form from the fitted distribution at each
        # heartbeat). Until then suspicion checks are ONE float compare —
        # the poll loop's per-tick cost stops scaling with erfc calls at
        # fleet size.
        self.suspect_at = float("inf")

    def record(self, now: float) -> None:
        interval = max(now - self.last, 0.0)
        self.last = now
        if len(self.intervals) == self.intervals.maxlen:
            old = self.intervals[0]
            self._sum -= old
            self._sum_sq -= old * old
        self.intervals.append(interval)
        self._sum += interval
        self._sum_sq += interval * interval

    def mean_std(self) -> tuple[float, float]:
        # Only reached past the min_samples warm-up gate, so n >= 1 always.
        n = len(self.intervals)
        mean = self._sum / n
        var = max(self._sum_sq / n - mean * mean, 0.0)
        return mean, max(math.sqrt(var), _MIN_STD_S)


class PhiAccrualDetector:
    """Per-peer suspicion levels from heartbeat inter-arrival statistics."""

    def __init__(
        self,
        threshold: float = PHI_THRESHOLD_DEFAULT,
        window: int = 128,
        min_samples: int = 3,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if threshold <= 0:
            raise ValueError("phi threshold must be positive")
        self.threshold = threshold
        self.window = window
        # Warm-up gate: with fewer than this many observed intervals there
        # is no distribution worth trusting — a worker's first batches can
        # be separated by a multi-second jit compile, and suspecting the
        # whole fleet at startup helps nobody.
        self.min_samples = min_samples
        self._clock = clock
        self._peers: dict[str, _PeerHistory] = {}
        # z* with φ(z*) == threshold (φ is strictly monotone in z): the
        # crossing elapsed is mean + z*·√2·std, giving every peer a
        # closed-form suspect_at timestamp per heartbeat.
        self._z_threshold = _solve_z(threshold)

    # -- feeding -------------------------------------------------------------
    def heartbeat(self, peer: str) -> None:
        """Any liveness signal: Status progress, lease renewal, metrics."""
        now = self._clock()
        hist = self._peers.get(peer)
        if hist is None:
            self._peers[peer] = _PeerHistory(now, self.window)
        else:
            hist.record(now)
            if len(hist.intervals) >= self.min_samples:
                mean, std = hist.mean_std()
                hist.suspect_at = (
                    now + mean + self._z_threshold * std * math.sqrt(2.0)
                )

    def remove(self, peer: str) -> None:
        self._peers.pop(peer, None)

    def peers(self) -> list[str]:
        return list(self._peers)

    # -- querying ------------------------------------------------------------
    def phi(self, peer: str) -> float:
        """Current suspicion level; 0.0 for unknown peers (benefit of the
        doubt until they have spoken at least once)."""
        hist = self._peers.get(peer)
        if hist is None or len(hist.intervals) < self.min_samples:
            return 0.0
        elapsed = self._clock() - hist.last
        if elapsed <= 0:
            return 0.0
        mean, std = hist.mean_std()
        # P(heartbeat later than `elapsed`) under N(mean, std).
        z = (elapsed - mean) / (std * math.sqrt(2.0))
        p_later = 0.5 * math.erfc(z)
        if p_later <= 0.0:
            # erfc underflowed: far past any plausible arrival. Use the
            # asymptotic tail so φ keeps growing monotonically instead of
            # saturating at an arbitrary cap.
            return z * z / math.log(10.0)
        return -math.log10(p_later)

    def suspected(self, peer: str) -> bool:
        # Fast negative (the overwhelming case): before suspect_at the
        # fitted φ cannot have crossed the threshold — one float compare
        # instead of an erfc per peer per poll tick. The exact φ check
        # stays the verdict past the horizon (and for short histories,
        # whose suspect_at is still +inf).
        hist = self._peers.get(peer)
        if hist is None or self._clock() < hist.suspect_at:
            return False
        return self.phi(peer) >= self.threshold

    def suspicion_levels(self) -> dict[str, float]:
        """Snapshot of φ for every known peer (telemetry / orchestrator)."""
        return {peer: self.phi(peer) for peer in self._peers}
