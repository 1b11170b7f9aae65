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

from ..lazy import exports

# Each name's submodule, imported on first use (``lazy.exports``):
# ``accum``, ``sync``'s merge and ``reduce`` import torch, and a job's
# options (``SYNC_MODES``, ``effective_fragments``) are read by processes
# that hold no tensor (the node CLI, a training job's scheduler).
_SUBMODULE = {
    "RoundAccum": "accum",
    **dict.fromkeys(("fragment_of", "partition_names", "shard_names", "shard_of"), "partition"),
    **dict.fromkeys(("DEFAULT_FRAGMENTS", "SYNC_MODES", "effective_fragments", "fragment_due",
                     "merge_corrected", "next_owned_round", "placement_parts", "shard_owns_round",
                     "shards_due_at"), "sync"),
    **dict.fromkeys(("BroadcastRelay", "GroupReducer", "TreeRuntime", "maybe_start_reducer",
                     "maybe_start_relay", "relay_tag", "tree_broadcast"), "reduce"),
    **dict.fromkeys(("ancestors_of", "build_reduce_groups", "children_of", "parent_of",
                     "subtree_of", "top_targets", "tree_levels", "with_serve_leaves"), "tree"),
}

__getattr__ = exports(__name__, _SUBMODULE)
__all__ = list(_SUBMODULE)
