"""Fault tolerance (counterpart of ``hypha_tpu/ft/``).

  detector.py   — φ-accrual failure detector (the orchestrator's suspicion
                  and the request router's ejector read it)
  membership.py — epoch-numbered RoundMembership + the FT wire vocabulary
  rejoin.py     — catch-up protocol (θ_r = θ₀ + Σ updates) for replacements
  durable.py    — the parameter server's round journal + outer-state
                  checkpoint: a restarted server resumes the interrupted
                  round (generation ids + worker re-sends, deduplicated)
  adaptive.py   — WAN-adaptive rounds: the straggler controller (per-worker
                  inner steps) and the measured-link table (per-link codecs;
                  the serving plane's link estimate)
  chaos.py      — deterministic faults: kills of a worker or the parameter
                  server, delays, partitions and the degrade kinds (slow
                  worker, bandwidth cap, jitter)

Every sync mode and placement runs all of it: each shard of a sharded
job has its own journal and generation. The scheduler's own journal and
the two chaos kinds aimed at the scheduler are not ported (ROADMAP.md,
Queue 1: scheduler recovery)."""

from ..lazy import exports

# Each name's submodule, imported on first use (``lazy.exports``): the
# node CLI and a training job's scheduler hold no tensor, and ``rejoin`` and
# ``durable`` import torch.
_SUBMODULE = {
    **dict.fromkeys(("Ewma", "LinkTable", "StragglerController"), "adaptive"),
    **dict.fromkeys(("ChaosAction", "ChaosController", "parse_chaos_spec", "parse_chaos_specs"),
                    "chaos"),
    **dict.fromkeys(("PHI_THRESHOLD_DEFAULT", "PhiAccrualDetector"), "detector"),
    **dict.fromkeys(("GENERATION_KEY", "RESYNC_KEY", "DurablePS", "FoldRecord", "RoundJournal",
                     "restart_signal"), "durable"),
    **dict.fromkeys(("PROTOCOL_FT", "FTConfig", "MembershipUpdate", "MembershipView",
                     "RoundMembership", "quorum_size"), "membership"),
    **dict.fromkeys(("CATCHUP_KEY", "CatchupBuffer", "await_catchup"), "rejoin"),
}

__getattr__ = exports(__name__, _SUBMODULE)
__all__ = list(_SUBMODULE)
