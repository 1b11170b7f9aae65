"""Deterministic, size-balanced partition of a parameter tree (counterpart
of ``hypha_tpu/stream/partition.py:26-66``).

The parameter server and every worker agree on which tensors form fragment
``k`` without exchanging a manifest: the partition is a pure function of
the flat tensor names and element counts (the wire's names, the same in
both packages). Greedy longest-processing-time packing: tensors sorted by
(size descending, name ascending) go one by one to the lightest fragment
(ties to the lower index). The sharded service places fragment ``f`` on
shard ``f mod N`` (``shard_of``, reference ``:68-102``).
"""

from __future__ import annotations

from typing import Mapping

__all__ = ["partition_names", "fragment_of", "shard_of", "shard_names"]


def partition_names(sizes: Mapping[str, int], fragments: int) -> list:
    """Split tensor names into ``fragments`` size-balanced groups: a list
    of name tuples, each sorted by name; every name in exactly one."""
    if fragments < 1:
        raise ValueError(f"fragments must be >= 1, got {fragments}")
    if fragments > 1 and len(sizes) < fragments:
        # An empty fragment would ship empty deltas and fail the server's
        # outer step; refuse it where the message can name the fix.
        raise ValueError(
            f"cannot split {len(sizes)} tensors into {fragments} fragments; "
            f"lower the job's num_fragments to at most {max(len(sizes), 1)}"
        )
    bins: list = [[] for _ in range(fragments)]
    loads = [0] * fragments
    for name in sorted(sizes, key=lambda n: (-int(sizes[n]), n)):
        i = min(range(fragments), key=lambda k: (loads[k], k))
        bins[i].append(name)
        loads[i] += int(sizes[name])
    return [tuple(sorted(b)) for b in bins]


def fragment_of(sizes: Mapping[str, int], fragments: int) -> dict:
    """Inverse view: flat tensor name -> fragment index."""
    return {name: idx for idx, names in enumerate(partition_names(sizes, fragments))
            for name in names}


def shard_of(fragment_id: int, num_shards: int) -> int:
    """Owning parameter-server shard of a fragment: fragments round-robin
    over shards, so consecutive stream rounds leave different shards."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if fragment_id < 0:
        raise ValueError(f"fragment_id must be >= 0, got {fragment_id}")
    return fragment_id % num_shards


def shard_names(sizes: Mapping[str, int], fragments: int, num_shards: int,
                shard_id: int) -> tuple:
    """All tensor names shard ``shard_id`` owns (its fragments' union), sorted."""
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} out of range for {num_shards} shards")
    parts = partition_names(sizes, fragments)
    return tuple(sorted(name for f, names in enumerate(parts)
                        if shard_of(f, num_shards) == shard_id for name in names))
