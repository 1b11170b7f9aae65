"""The streaming outer sync (counterpart of ``hypha_tpu/stream``).

  * :mod:`partition` -- the deterministic, size-balanced split of the
    parameter tree into F fragments (a pure function of ``{name: size}``)
    and their placement on parameter-server shards (``shard_of``);
  * :mod:`sync`      -- the staggered schedule (fragment ``r mod F`` due at
    round ``r``), the shards that close each round, and the delayed-update
    correction ``merge_corrected``;
  * :mod:`accum`     -- the streaming sample-weighted fold, ``RoundAccum``,
    shared by the parameter server and the group reducer;
  * :mod:`tree`      -- the tree-reduce plan (sorted peer ids in groups of
    G, ``depth`` levels deep);
  * :mod:`reduce`    -- the group reducer that pre-folds its members'
    deltas before the shards, and the broadcast relay that carries the
    update wires back down the same tree.

Selection is per job through ``sync_mode: blocking | overlap | stream``,
``num_ps_shards``, ``reduce_group_size`` and ``broadcast_tree``.
"""

from .accum import RoundAccum
from .partition import fragment_of, partition_names, shard_names, shard_of
from .sync import (
    DEFAULT_FRAGMENTS,
    SYNC_MODES,
    effective_fragments,
    fragment_due,
    merge_corrected,
    next_owned_round,
    placement_parts,
    shard_owns_round,
    shards_due_at,
)
from .reduce import (
    BroadcastRelay,
    GroupReducer,
    TreeRuntime,
    maybe_start_reducer,
    maybe_start_relay,
    relay_tag,
    tree_broadcast,
)
from .tree import (
    ancestors_of,
    build_reduce_groups,
    children_of,
    parent_of,
    subtree_of,
    top_targets,
    tree_levels,
    with_serve_leaves,
)

__all__ = ["RoundAccum", "partition_names", "fragment_of", "shard_of", "shard_names",
           "SYNC_MODES", "DEFAULT_FRAGMENTS", "fragment_due", "effective_fragments",
           "placement_parts", "shard_owns_round", "shards_due_at", "next_owned_round",
           "merge_corrected", "build_reduce_groups", "children_of", "parent_of",
           "ancestors_of", "subtree_of", "top_targets", "tree_levels", "with_serve_leaves",
           "GroupReducer", "BroadcastRelay", "TreeRuntime", "maybe_start_reducer",
           "maybe_start_relay", "relay_tag", "tree_broadcast"]
