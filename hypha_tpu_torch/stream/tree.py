"""Multi-level reduce/broadcast tree placement — pure plan derivation (a copy
of ``hypha_tpu/stream/tree.py``, which imports no JAX).

A single-level ``GroupReducer`` cuts one shard's ingress from W
pushes to ~W/G partials — but the reducers themselves still push straight
to the shard, so ingress (and the PS's broadcast egress) stays linear in
the pool size past a constant factor. This module generalizes the plan to
a configurable depth ``d``: workers are chunked into deterministic
sorted-peer-id groups of ``G``, the group heads are chunked again, and so
on — a groups-of-groups tree whose top level is what actually talks to
the parameter-service shards. Shard ingress becomes ~W/G^d partials and
PS broadcast egress ~G top-level pushes (plus ungrouped leftovers).

Everything here is a pure function of ``(sorted worker peer ids,
group_size, depth)`` — the same contract as :mod:`partition`: every peer
(and a recovered scheduler re-deriving its plan from the journal) computes
the identical tree with no manifest exchange beyond the ``ShardMap``
announcement that already rides dispatched specs.

Representation: the **collapsed per-reducer group list** — for each node
with children, one group ``[reducer, *children]`` where the children may
come from different levels (a level-2 head folds its level-1 group AND the
other level-1 heads in its chunk). At ``depth=1`` this is byte-identical
to the single-level plan shipped in ``ShardMap.groups``, which is
exactly why the wire needs no new placement field for the default.

The mechanics that consume the plan:

  * a LEAF routes its delta ``[parent, shard]`` with ANY failover
    (unchanged from single-level);
  * a MID-TREE reducer folds its children's pushes — raw deltas from leaf
    children, ``prefold``-tagged partials from reducer children — and
    forwards ONE cumulative partial to ITS parent with the same ANY
    failover, covers extending transitively;
  * broadcast mirrors the tree downward: the PS pushes each wire to the
    top-level reducers (and ungrouped workers) only; each relay re-pushes
    to its direct children, expanding a dead child relay to that child's
    children so a mid-tree death degrades fan-out instead of severing the
    subtree.
"""

from __future__ import annotations

__all__ = [
    "build_reduce_groups",
    "children_of",
    "parent_of",
    "ancestors_of",
    "subtree_of",
    "top_targets",
    "tree_levels",
    "with_serve_leaves",
]


def build_reduce_groups(
    peers, group_size: int, depth: int = 1
) -> list[list[str]]:
    """The deterministic tree plan as collapsed per-reducer groups.

    Chunk the sorted peer ids into groups of ``group_size``; each chunk's
    first member is its head. Repeat ``depth`` times over the heads —
    every level's non-head members attach to their chunk's head as
    children. Returns ``[head, *children]`` for every head that has
    children, in sorted-head order. ``depth=1`` reproduces the
    single-level plan exactly (singleton chunks contribute nothing).
    """
    group_size = int(group_size or 0)
    depth = int(depth or 1)
    if group_size < 2 or depth < 1:
        return []
    ordered = sorted(set(str(p) for p in peers))
    children: dict[str, list[str]] = {p: [] for p in ordered}
    current = ordered
    for _ in range(depth):
        if len(current) < 2:
            break
        chunks = [
            current[i : i + group_size]
            for i in range(0, len(current), group_size)
        ]
        nxt: list[str] = []
        for chunk in chunks:
            head = chunk[0]
            children[head].extend(chunk[1:])
            nxt.append(head)
        current = nxt
        if len(chunks) <= 1:
            break
    return [[p, *children[p]] for p in ordered if children[p]]


def children_of(groups) -> dict[str, list[str]]:
    """reducer peer -> its direct children (reduce members)."""
    return {str(g[0]): [str(c) for c in g[1:]] for g in (groups or []) if len(g) >= 2}


def parent_of(groups) -> dict[str, str]:
    """child peer -> its reducer (the ANY-failover first hop)."""
    out: dict[str, str] = {}
    for g in groups or []:
        for child in g[1:]:
            out[str(child)] = str(g[0])
    return out


def ancestors_of(groups, peer: str) -> list[str]:
    """``peer``'s reducer chain, nearest first (empty for a top-level
    reducer or an ungrouped worker). Broadcast wires can arrive from any
    of these — the worker's results allowlist must admit them all."""
    parents = parent_of(groups)
    chain: list[str] = []
    cur = str(peer)
    while cur in parents and parents[cur] not in chain:
        cur = parents[cur]
        chain.append(cur)
    return chain


def subtree_of(groups, peer: str) -> list[str]:
    """Every transitive child under ``peer`` (excluding ``peer``), in
    deterministic DFS order — the worker set a reducer's cumulative
    partial can cover, and the flatten target when a broadcast hop must
    route AROUND a dead relay."""
    kids = children_of(groups)
    out: list[str] = []
    stack = list(kids.get(str(peer), ()))
    seen: set[str] = set()
    while stack:
        cur = stack.pop(0)
        if cur in seen:
            continue
        seen.add(cur)
        out.append(cur)
        stack = list(kids.get(cur, ())) + stack
    return out


def top_targets(groups, peers) -> list[str]:
    """The parameter service's broadcast targets under a tree: every
    top-level reducer plus every ungrouped worker, restricted to
    ``peers`` (the live broadcast set) and keeping its order. A peer in
    ``peers`` whose every ancestor is absent from ``peers`` is also a
    target — a dead relay chain must not sever its subtree."""
    parents = parent_of(groups)
    live = [str(p) for p in peers]
    live_set = set(live)
    out: list[str] = []
    for p in live:
        anc = ancestors_of(groups, p)
        if p not in parents or not any(a in live_set for a in anc):
            out.append(p)
    return out


def with_serve_leaves(groups, serve_leaves) -> list[list[str]]:
    """The BROADCAST-ONLY plan: ``groups`` with serving subscribers
    attached as relay children (live weight streaming).

    Serve peers consume update wires but never push deltas, so they must
    stay out of the REDUCE plan (a reducer folding a group that contains
    one would wait forever); this derives the downward fan-out plan the
    parameter service and the relays share instead. Each serve leaf is
    assigned round-robin to a relay head in sorted-head order — a pure
    function of ``(groups, sorted serve peer ids)``, so the PS's
    ``top_targets``/``tree_broadcast`` walk and every relay's
    ``children_of`` slice agree on the assignment with no extra wire.
    Leaves already present anywhere in ``groups`` are skipped (a peer
    that trains AND serves already receives every wire); with no relay
    heads the plan is returned unchanged — callers fall back to direct
    pushes, exactly the no-tree topology.
    """
    base = [list(g) for g in (groups or [])]
    heads = sorted({str(g[0]) for g in base if len(g) >= 2})
    members = {str(p) for g in base for p in g}
    leaves = [
        p
        for p in sorted({str(s) for s in (serve_leaves or [])})
        if p not in members
    ]
    if not heads or not leaves:
        return base
    by_head = {str(g[0]): g for g in base if len(g) >= 2}
    for i, leaf in enumerate(leaves):
        by_head[heads[i % len(heads)]].append(leaf)
    return base


def tree_levels(groups) -> dict[str, int]:
    """reducer peer -> its level (1 = folds only raw worker deltas;
    ``1 + max(child reducer levels)`` otherwise). Telemetry labels the
    per-level fold/forward counters with this."""
    kids = children_of(groups)

    def level(p: str, _seen=()) -> int:
        if p in _seen:  # defensive: a malformed plan must not recurse
            return 1
        subs = [
            level(c, (*_seen, p)) for c in kids.get(p, ()) if c in kids
        ]
        return 1 + max(subs, default=0)

    return {p: level(p) for p in kids}
