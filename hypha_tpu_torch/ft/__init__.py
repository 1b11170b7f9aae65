"""Fault tolerance (counterpart of ``hypha_tpu/ft/``).

  detector.py   — φ-accrual failure detector (the orchestrator's suspicion
                  and the request router's ejector read it)
  membership.py — epoch-numbered RoundMembership + the FT wire vocabulary
  rejoin.py     — catch-up protocol (θ_r = θ₀ + Σ updates) for replacements
  durable.py    — the parameter server's round journal + outer-state
                  checkpoint: a restarted server resumes the interrupted
                  round (generation ids + worker re-sends, deduplicated)
  adaptive.py   — the measured-link table the serving plane reads
  chaos.py      — deterministic kills of a worker or the parameter server

Every sync mode and placement runs all of it: each shard of a sharded
job has its own journal and generation. The straggler controller,
per-link codecs, the scheduler's own journal and the chaos kinds beyond
the two kills are not ported (ROADMAP.md, Queue 1: adaptive rounds and
chaos kinds; scheduler recovery)."""

from .adaptive import Ewma, LinkTable
from .chaos import ChaosAction, ChaosController, parse_chaos_spec, parse_chaos_specs
from .detector import PHI_THRESHOLD_DEFAULT, PhiAccrualDetector
from .durable import GENERATION_KEY, RESYNC_KEY, DurablePS, FoldRecord, RoundJournal, restart_signal
from .membership import (
    PROTOCOL_FT,
    FTConfig,
    MembershipUpdate,
    MembershipView,
    RoundMembership,
    quorum_size,
)
from .rejoin import CATCHUP_KEY, CatchupBuffer, await_catchup

__all__ = [
    "Ewma", "LinkTable", "PhiAccrualDetector", "PHI_THRESHOLD_DEFAULT",
    "PROTOCOL_FT", "FTConfig", "MembershipUpdate", "MembershipView", "RoundMembership",
    "quorum_size", "CATCHUP_KEY", "CatchupBuffer", "await_catchup",
    "GENERATION_KEY", "RESYNC_KEY", "DurablePS", "FoldRecord", "RoundJournal", "restart_signal",
    "ChaosAction", "ChaosController", "parse_chaos_spec", "parse_chaos_specs",
]
