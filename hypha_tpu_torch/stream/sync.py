"""The fragment schedule and the delayed-update correction (counterpart of
``hypha_tpu/stream/sync.py``).

Blocking DiLoCo merges the broadcast update ``u`` while compute is paused
(θ ← θ_s + u, anchor ← θ). Overlapped sync keeps stepping while ``u`` is
in flight, so at merge time the live params are θ_l = θ_s + d. The
correction re-anchors at the send-time snapshot:

    θ      ← θ_l + u          (the drift stays in the live params)
    anchor ← θ_s + u          (and out of the anchor)

so the next Δθ = θ − anchor starts at exactly ``d``. With zero flight time
both equal blocking's merge, bit for bit. The sharded service's round
ownership (``shard_owns_round``, ``shards_due_at``, ``next_owned_round``)
is not ported (ROADMAP.md, Queue 1: sharded PS/FT/rejoin).
"""

from __future__ import annotations

from typing import Mapping

from ..executor.diloco import merge_update

__all__ = ["SYNC_MODES", "DEFAULT_FRAGMENTS", "fragment_due", "effective_fragments",
           "placement_parts", "merge_corrected"]

# blocking: ship Δθ, wait, merge; overlap: the whole tree synced in the
# background while inner steps go on; stream: F staggered fragments, one
# due a round, overlapped.
SYNC_MODES = ("blocking", "overlap", "stream")

# Streaming DiLoCo's headline fragment count, used when a job picks none.
DEFAULT_FRAGMENTS = 4


def fragment_due(round_num: int, fragments: int) -> int:
    """The staggered schedule: fragment ``r mod F`` syncs at round ``r``."""
    if fragments < 1:
        raise ValueError(f"fragments must be >= 1, got {fragments}")
    return round_num % fragments


def effective_fragments(sync_mode: str, fragments: int = 0) -> int:
    """The fragment count of a sync mode: 1 for blocking and overlap, the
    job's ``fragments`` (0 = :data:`DEFAULT_FRAGMENTS`) for stream."""
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"sync_mode must be {'|'.join(SYNC_MODES)}, got {sync_mode!r}")
    if sync_mode != "stream":
        return 1
    if fragments < 0:
        raise ValueError(f"fragments must be >= 0, got {fragments}")
    return int(fragments) or DEFAULT_FRAGMENTS


def placement_parts(sync_mode: str, fragments: int = 0, num_shards: int = 1) -> int:
    """How many parts the tree splits into on a single parameter server:
    the sync mode's fragments. Malformed arguments raise the reference's
    ``ValueError`` first; more shards then raise (not ported)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards == 1 or sync_mode == "stream":
        parts = effective_fragments(sync_mode, fragments)
    elif sync_mode not in SYNC_MODES:
        raise ValueError(f"sync_mode must be {'|'.join(SYNC_MODES)}, got {sync_mode!r}")
    if num_shards != 1:
        raise NotImplementedError(
            f"num_shards={num_shards}: the sharded parameter service is not ported to "
            "PyTorch yet (ROADMAP.md, Queue 1: sharded PS/FT/rejoin)"
        )
    return parts


def merge_corrected(live: Mapping, snapshot: Mapping, update: Mapping) -> tuple:
    """One fragment's update with the delayed-update correction:
    ``(θ_l + u, θ_s + u)`` as new dicts, each sum ``merge_update``'s (the
    update cast to the leaf's dtype, then added). The keys must match
    exactly: a mismatch means the two ends disagree on the partition."""
    if set(live) != set(update) or set(snapshot) != set(update):
        raise ValueError(
            "fragment key mismatch: "
            f"live={sorted(live)} snapshot={sorted(snapshot)} update={sorted(update)}"
        )
    live_d = {k: live[k] for k in update}
    snap_d = {k: snapshot[k] for k in update}
    return merge_update(live_d, update), merge_update(snap_d, update)
