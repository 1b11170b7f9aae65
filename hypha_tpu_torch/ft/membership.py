"""Epoch-numbered round membership: who is in the DiLoCo round (a copy of
``hypha_tpu/ft/membership.py``, which imports no JAX; the port may not
import the JAX package, so it keeps its own).

  * :class:`RoundMembership` — the wire snapshot ``(epoch, active,
    suspected, departed)``; the parameter server stamps its epoch into every
    outer-update broadcast header so all parties can agree on who was in the
    round that produced it;
  * :class:`MembershipView` — the orchestrator's mutable copy; every
    mutation (suspect / reinstate / depart / join) bumps the epoch;
  * :class:`MembershipUpdate` — the orchestrator → parameter-server RPC
    carrying a new snapshot (``/hypha-ft/0.0.1``);
  * :class:`FTConfig` — the job-level fault-tolerance knobs
    (``quorum_fraction``, ``round_deadline_s``, ``phi_threshold``).

The three dataclasses are registered with the port's codec under the
reference's names, fields, order and defaults, so ``messages.encode`` gives
the reference's bytes (``tests/test_torch_ft.py``).

Quorum is a *fraction of the active set*, recomputed as membership changes:
with 4 active and ``quorum_fraction=0.75`` the PS aggregates at 3 deltas
once the round deadline passes; after one worker departs (active=3) the
quorum is again all 3 — degraded but never below ``ceil(f·n)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..messages import _register

__all__ = [
    "PROTOCOL_FT",
    "FTConfig",
    "RoundMembership",
    "MembershipUpdate",
    "MembershipView",
    "quorum_size",
]

PROTOCOL_FT = "/hypha-ft/0.0.1"


def quorum_size(fraction: float, n_active: int) -> int:
    """Minimum deltas per round: ``ceil(fraction * n_active)``, at least 1."""
    if n_active <= 0:
        return 1
    return max(1, math.ceil(fraction * n_active - 1e-9))


@_register
@dataclass(slots=True)
class FTConfig:
    """Job-level fault-tolerance knobs (the reference documents each).

    ``quorum_fraction > 0`` is the subsystem's master switch: 0 keeps the
    seed's exact semantics (wait for every worker forever, any failure
    aborts the attempt). With ``DiLoCoJob.scheduler_recovery`` the
    scheduler reads ``scheduler_adopt_grace_s`` (None: 120 s, how long the
    executions outlive a dead scheduler) and ``scheduler_adopt_deadline_s``
    (None: 20 s, how long a restarted one waits for an ``AdoptAck``); both
    stay None on the wire unless set."""

    quorum_fraction: float = 0.75
    round_deadline_s: float = 30.0
    phi_threshold: float = 8.0
    rejoin_attempts: int = 3
    rejoin_backoff_s: float = 2.0
    ps_restart_attempts: int = 2
    ps_restart_backoff_s: float = 1.0
    scheduler_adopt_grace_s: float | None = None
    scheduler_adopt_deadline_s: float | None = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.quorum_fraction <= 1.0:
            raise ValueError("quorum_fraction must be in [0, 1]")
        if self.round_deadline_s < 0:
            raise ValueError("round_deadline_s must be >= 0")
        if self.phi_threshold <= 0:
            raise ValueError("phi_threshold must be positive")

    @property
    def enabled(self) -> bool:
        return self.quorum_fraction > 0.0


@_register
@dataclass(slots=True)
class RoundMembership:
    """One agreed view of the round's participants. ``inner_steps`` is the
    straggler controller's per-worker assignment (``adaptive_steps``); None
    on every other job, and then omitted from the wire."""

    epoch: int = 0
    active: list = field(default_factory=list)  # list[str] peer ids
    suspected: list = field(default_factory=list)
    departed: list = field(default_factory=list)
    inner_steps: dict | None = None  # peer id -> assigned inner steps

    def expected(self) -> set:
        """Peers whose delta the round should wait for (past quorum)."""
        return set(self.active) - set(self.suspected)

    def quorum(self, fraction: float) -> int:
        return quorum_size(fraction, len(self.active))


@_register
@dataclass(slots=True)
class MembershipUpdate:
    """Orchestrator → parameter server: adopt this membership snapshot.

    ``joined`` names peers newly added to ``active`` that need a catch-up
    push (current global weights + round counter) before they can train.
    """

    job_id: str
    membership: RoundMembership = field(default_factory=RoundMembership)
    joined: list = field(default_factory=list)


class MembershipView:
    """The orchestrator's mutable membership; every change bumps the epoch."""

    def __init__(self, active: list) -> None:
        self.epoch = 0
        self.active: set = set(active)
        self.suspected: set = set()
        self.departed: set = set()

    # -- mutations (each returns True when the view actually changed) -------
    def suspect(self, peer: str) -> bool:
        if peer not in self.active or peer in self.suspected:
            return False
        self.suspected.add(peer)
        self.epoch += 1
        return True

    def reinstate(self, peer: str) -> bool:
        """A suspected peer heartbeated again (re-heal)."""
        if peer not in self.suspected:
            return False
        self.suspected.discard(peer)
        self.epoch += 1
        return True

    def depart(self, peer: str) -> bool:
        if peer not in self.active:
            return False
        self.active.discard(peer)
        self.suspected.discard(peer)
        self.departed.add(peer)
        self.epoch += 1
        return True

    def join(self, peer: str) -> bool:
        if peer in self.active:
            return False
        self.active.add(peer)
        self.departed.discard(peer)
        self.suspected.discard(peer)
        self.epoch += 1
        return True

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> RoundMembership:
        return RoundMembership(
            epoch=self.epoch,
            active=sorted(self.active),
            suspected=sorted(self.suspected),
            departed=sorted(self.departed),
        )
