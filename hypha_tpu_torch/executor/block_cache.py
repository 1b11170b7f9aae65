"""Host-side physical-block allocator with automatic prefix caching (a copy
of ``hypha_tpu/executor/block_cache.py`` without its metrics calls).

The paged pool (executor.pool) maps each decode lane's logical KV window
onto physical blocks through a per-lane table (ops.kvcache paged layout).
This module owns the HOST bookkeeping for those blocks: who references
them, which ones hold content worth keeping, and which one to hand out
next. Device memory never moves here — the pool does the (rare) copies.

Design (vLLM's automatic prefix caching, adapted to this allocator):

* **Content addressing.** A full block of ``block_size`` token positions
  is uniquely identified by the *chain hash* of every token id up to and
  including the block (causal attention: a block's K/V depends on its
  whole prefix, not just its own tokens). :func:`chain_hashes` computes
  the per-block chain; the pool registers a block under its hash once
  its K/V are fully written.
* **Refcounts.** ``ref[b]`` counts lane-table references. A cache hit
  maps the same physical block into several tables (ref > 1) — those
  lanes share the prefix K/V without recomputing it.
* **LRU of ref-0 cached blocks.** When the last reference drops, a
  REGISTERED block is parked in an LRU instead of the free list: its
  content stays addressable (a later request with the same prefix
  re-maps it) until allocation pressure evicts it. Unregistered blocks
  (partial tails, never-hashed content) free immediately.
* **Allocation order.** ``alloc`` draws from the free list first, then
  evicts the LRU's oldest block (dropping its hash entry). Only when
  both are empty does the pool fall back to preemption.
* **Weight generations (live weight streaming).** Chain hashes
  address token CONTENT, but the cached K/V were computed under specific
  weights — after a hot swap the same prompt bytes hash identically
  while the blocks hold stale activations. Every registration is
  stamped with the allocator's current ``generation``;
  ``bump_generation`` (called by the pool at the swap boundary)
  invalidates LAZILY: live lanes keep their mapped blocks until release
  (refcounts never move at a swap), but a stale-generation block is a
  cache MISS — ``peek``/``lookup`` drop its registration on contact,
  ``release`` sends a stale ref-0 block to the free list instead of the
  LRU, and ``register`` evicts a stale holder so the new-generation
  content can claim the hash.

Every block is therefore in exactly one of three places — the free
list, at least one live lane table (ref > 0), or the ref-0 LRU — and
``check_conservation`` asserts that partition (the block-conservation
property test drives random op sequences against it, swap bumps
included).
"""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["PrefixBlockCache", "chain_hashes"]


def chain_hashes(tokens, block_size: int) -> list:
    """Per-block chain hashes of ``tokens``: entry ``j`` identifies the
    K/V content of full block ``j`` (tokens ``[0, (j+1)*block_size)`` —
    the whole prefix, because causal attention bakes it into the block).
    Only FULL blocks hash; a partial tail has no entry. Deterministic
    within a process (CPython int/tuple hashing is unseeded)."""
    out: list = []
    h = 0
    for j in range(len(tokens) // block_size):
        h = hash((h, tuple(tokens[j * block_size : (j + 1) * block_size])))
        out.append(h)
    return out


class PrefixBlockCache:
    """Physical-block allocator + content-addressed prefix cache.

    Pure host state (no device arrays): the serve thread is the only
    caller, so there is no locking. ``caching=False`` degrades to a plain
    free-list allocator — ``lookup`` never hits, ``register`` is a no-op,
    and released blocks always return to the free list (bit-identical to
    the pre-cache pool)."""

    def __init__(
        self, num_blocks: int, block_size: int, *, caching: bool = False
    ) -> None:
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.caching = bool(caching)
        self._free = list(range(self.num_blocks))
        self._ref = [0] * self.num_blocks
        self._hash_of: dict[int, int] = {}  # block -> content hash
        self._by_hash: dict[int, int] = {}  # content hash -> block
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # ref-0 cached
        self.evictions = 0  # cached blocks recycled under pressure
        # Weight generation the allocator currently admits against; every
        # registered block remembers the generation its K/V were written
        # under, and a mismatch makes it a miss (lazily dropped).
        self.generation = 0
        self._gen_of: dict[int, int] = {}  # block -> generation registered
        self.stale_drops = 0  # stale-generation registrations dropped
        # Fleet cache: per-hash hit tally feeding the bounded ServeLoad
        # digest — registered-but-never-hit chains count 0 so a fresh
        # worker still advertises what it holds (the fleet can't bootstrap
        # off hits that haven't happened yet).
        self._hits: dict[int, int] = {}  # content hash -> lookup hits

    # ----------------------------------------------------------- querying

    def free_count(self) -> int:
        """Allocatable blocks: truly free + evictable (ref-0 cached)."""
        return len(self._free) + len(self._lru)

    def cached_count(self) -> int:
        """Blocks currently registered under a content hash."""
        return len(self._hash_of)

    def shared_count(self) -> int:
        """Blocks mapped into more than one lane table right now."""
        return sum(1 for r in self._ref if r > 1)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def is_shared(self, block: int) -> bool:
        return self._ref[block] > 1

    def is_registered(self, block: int) -> bool:
        return block in self._hash_of

    def _stale(self, block: int) -> bool:
        """Registered under an older weight generation than current."""
        return (
            block in self._hash_of
            and self._gen_of.get(block, self.generation) != self.generation
        )

    def _drop_stale(self, block: int) -> None:
        """Lazy invalidation on contact: drop a stale block's
        registration; if it was parked ref-0 in the LRU it becomes plain
        free space (nothing can ever hit it again). Live references are
        untouched — the owning lanes finish on the blocks they mapped."""
        self.forget(block)
        self.stale_drops += 1
        if block in self._lru:
            del self._lru[block]
            self._free.append(block)

    def peek(self, hashes: list) -> tuple:
        """Longest cached prefix of ``hashes`` WITHOUT taking references:
        ``(hit_blocks, hits_in_lru)``. ``hits_in_lru`` counts hits that
        currently sit in the LRU — mapping them consumes allocatable
        headroom, so admission must budget for them like fresh blocks.
        Stale-generation entries are misses (and are dropped on
        contact, so peek/lookup agree on the same admission)."""
        hits = in_lru = 0
        if not self.caching:
            return 0, 0
        for h in hashes:
            b = self._by_hash.get(h)
            if b is None:
                break
            if self._stale(b):
                self._drop_stale(b)
                break
            hits += 1
            if b in self._lru:
                in_lru += 1
        return hits, in_lru

    # ---------------------------------------------------------- mutation

    def bump_generation(self) -> None:
        """A weight swap happened: everything registered so far holds K/V
        from the OLD weights. No refcount or table moves here — the
        stale entries fall out lazily as peek/lookup/release touch them,
        so live lanes are never disturbed mid-decode."""
        self.generation += 1

    def lookup(self, hashes: list) -> list:
        """Map the longest cached prefix of ``hashes``: bumps each hit
        block's refcount (un-parking it from the LRU) and returns the
        physical ids in prefix order. The caller writes them into its
        lane table. Stale-generation entries never map — a post-swap
        admission must recompute the prefix under the new weights."""
        out: list = []
        if not self.caching:
            return out
        for h in hashes:
            b = self._by_hash.get(h)
            if b is None:
                break
            if self._stale(b):
                self._drop_stale(b)
                break
            if self._ref[b] == 0:
                del self._lru[b]
            self._ref[b] += 1
            self._hits[h] = self._hits.get(h, 0) + 1
            out.append(b)
        return out

    # -------------------------------------------------------- fleet cache

    def block_for(self, h: int) -> int | None:
        """Physical block registered under ``h`` at the CURRENT weight
        generation, else None (stale holders are dropped on contact, the
        same lazy invalidation peek/lookup apply)."""
        b = self._by_hash.get(h)
        if b is None:
            return None
        if self._stale(b):
            self._drop_stale(b)
            return None
        return b

    def resolve_chain(self, hashes: list) -> list:
        """Physical ids of the longest cached prefix of ``hashes``
        WITHOUT taking references — the BlockPull serving path. The
        serve thread extracts the rows in the same loop iteration, so
        the blocks cannot move under the read."""
        out: list = []
        for h in hashes:
            b = self.block_for(h)
            if b is None:
                break
            out.append(b)
        return out

    def hot_chains(self, k: int) -> list:
        """Bounded digest for ServeLoad piggybacking: the top-``k``
        currently-registered chain hashes by hit count, as
        ``[hash, hits]`` pairs (hottest first). Hashes whose block was
        evicted are pruned from the tally here, so the digest only ever
        advertises chains a puller can actually fetch."""
        if not self.caching or k <= 0:
            return []
        live = {h: self._hits.get(h, 0) for h in self._by_hash}
        self._hits = dict(live)  # prune tallies for evicted content
        top = sorted(live.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        return [[h, c] for h, c in top]

    def alloc(self) -> int | None:
        """One fresh block with ref=1: free list first, then evict the
        LRU's oldest cached block (its hash entry drops — the content is
        about to be overwritten). None = pool truly exhausted (every
        block is live in some table); the pool preempts then."""
        if self._free:
            b = self._free.pop()
        elif self._lru:
            b, _ = self._lru.popitem(last=False)
            del self._by_hash[self._hash_of.pop(b)]
            self._gen_of.pop(b, None)
            self.evictions += 1
        else:
            return None
        self._ref[b] = 1
        return b

    def register(self, block: int, h: int) -> None:
        """Attach content hash ``h`` to ``block`` (its K/V are fully
        written and final) under the CURRENT weight generation.
        Duplicate content — another block already registered under ``h``
        — keeps the original; this block stays unregistered and will
        free normally. Exception: a stale-generation holder is evicted
        first, so post-swap recomputation can re-claim the hash."""
        if not self.caching or block in self._hash_of:
            return
        holder = self._by_hash.get(h)
        if holder is not None:
            if not self._stale(holder):
                return
            self._drop_stale(holder)
        self._hash_of[block] = h
        self._by_hash[h] = block
        self._gen_of[block] = self.generation

    def forget(self, block: int) -> None:
        """Drop ``block``'s registration (an in-place overwrite is about
        to invalidate its cached content; ref==1, so no one else reads
        it). No-op for unregistered blocks."""
        h = self._hash_of.pop(block, None)
        if h is not None:
            del self._by_hash[h]
            self._gen_of.pop(block, None)

    def release(self, block: int) -> None:
        """Drop one table reference. At ref 0, registered blocks park in
        the LRU (their content stays addressable for future hits);
        unregistered blocks go straight back to the free list — as do
        stale-generation registrations, whose content can never be hit
        again (the lane that held them across a swap just finished)."""
        self._ref[block] -= 1
        if self._ref[block] < 0:
            raise AssertionError(f"block {block} released below ref 0")
        if self._ref[block] == 0:
            if self._stale(block):
                # Not yet parked anywhere: forget and fall through to the
                # free list (the LRU would just defer the same drop).
                self.forget(block)
                self.stale_drops += 1
            if block in self._hash_of:
                self._lru[block] = None
            else:
                self._free.append(block)

    # --------------------------------------------------------- invariant

    def check_conservation(self, tables: list) -> None:
        """Assert the block partition against the caller's live lane
        ``tables`` (a list of block-id lists, one per live lane, possibly
        sharing blocks): every physical block is in exactly one of
        {free list, live tables (ref>0), ref-0 LRU}, and every block's
        refcount equals its total table references. Raises
        AssertionError naming the first violation."""
        refs = [0] * self.num_blocks
        for table in tables:
            for b in table:
                refs[b] += 1
        free = set(self._free)
        lru = set(self._lru)
        if len(free) != len(self._free):
            raise AssertionError("duplicate block on the free list")
        if free & lru:
            raise AssertionError(f"blocks in free AND lru: {free & lru}")
        for b in range(self.num_blocks):
            in_table = refs[b] > 0
            places = (b in free) + (b in lru) + in_table
            if places != 1:
                raise AssertionError(
                    f"block {b} in {places} places (free={b in free}, "
                    f"lru={b in lru}, table_refs={refs[b]})"
                )
            if self._ref[b] != refs[b]:
                raise AssertionError(
                    f"block {b} refcount {self._ref[b]} != "
                    f"{refs[b]} table references"
                )
        for h, b in self._by_hash.items():
            if self._hash_of.get(b) != h:
                raise AssertionError(f"hash index desync on block {b}")
        if len(self._by_hash) != len(self._hash_of):
            raise AssertionError("hash maps disagree on cached count")
        if set(self._gen_of) != set(self._hash_of):
            raise AssertionError(
                "generation stamps desync from registrations: "
                f"{sorted(set(self._gen_of) ^ set(self._hash_of))}"
            )
