"""The fragment schedule and the delayed-update correction (counterpart of
``hypha_tpu/stream/sync.py``).

Blocking DiLoCo merges the broadcast update ``u`` while compute is paused
(θ ← θ_s + u, anchor ← θ). Overlapped sync keeps stepping while ``u`` is
in flight, so at merge time the live params are θ_l = θ_s + d. The
correction re-anchors at the send-time snapshot:

    θ      ← θ_l + u          (the drift stays in the live params)
    anchor ← θ_s + u          (and out of the anchor)

so the next Δθ = θ − anchor starts at exactly ``d``. With zero flight time
both equal blocking's merge, bit for bit. With N parameter-server shards a
stream round is closed by the due fragment's owner alone, and a blocking
round by every shard, each with its own part (``shards_due_at``).
"""

from __future__ import annotations

from typing import Mapping

from .partition import shard_of

__all__ = ["SYNC_MODES", "DEFAULT_FRAGMENTS", "fragment_due", "effective_fragments",
           "placement_parts", "shard_owns_round", "shards_due_at", "next_owned_round",
           "merge_corrected"]

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
    """How many placement parts the tree splits into: stream mode's F
    fragments (fragment ``f`` owned by shard ``f mod N``); in blocking and
    overlap one part per shard, all due every round (the whole tree on one
    server)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards == 1 or sync_mode == "stream":
        return effective_fragments(sync_mode, fragments)
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"sync_mode must be {'|'.join(SYNC_MODES)}, got {sync_mode!r}")
    return num_shards


def shard_owns_round(sync_mode: str, round_num: int, fragments: int, num_shards: int,
                     shard_id: int) -> bool:
    """Does shard ``shard_id`` aggregate anything at round ``round_num``?
    Every shard owns a part of every blocking or overlap round; in stream
    mode only the due fragment's owner does."""
    if num_shards <= 1 or sync_mode != "stream":
        return True
    return shard_of(fragment_due(round_num, fragments), num_shards) == shard_id


def shards_due_at(sync_mode: str, round_num: int, fragments: int,
                  num_shards: int) -> tuple:
    """The shards that close round ``round_num``: the scheduler advances
    the round on ``UPDATED`` from every one of them."""
    if num_shards <= 1:
        return (0,)
    if sync_mode == "stream":
        return (shard_of(fragment_due(round_num, fragments), num_shards),)
    return tuple(range(num_shards))


def next_owned_round(sync_mode: str, from_round: int, fragments: int, num_shards: int,
                     shard_id: int) -> int:
    """The first round >= ``from_round`` that ``shard_id`` aggregates
    (the stream schedule cycles every ``fragments`` rounds)."""
    for r in range(from_round, from_round + max(fragments, 1)):
        if shard_owns_round(sync_mode, r, fragments, num_shards, shard_id):
            return r
    raise ValueError(
        f"shard {shard_id} owns no round in a cycle of {fragments} fragments "
        f"over {num_shards} shards"
    )


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
    from ..executor.diloco import merge_update  # torch: job options import this module

    return merge_update(live_d, update), merge_update(snap_d, update)
