"""Continuous batching over a paged KV pool (counterpart of the paged mode
of ``hypha_tpu/executor/pool.py``).

One pool owns the device from a dedicated serve thread. K/V live in
``num_blocks`` physical blocks of ``block_size`` positions shared by every
decode lane, mapped through per-lane block tables (``ops/kvcache.py``
paged layout). Each serve-loop iteration:

* admits waiting groups FIFO when their prompt blocks fit above the
  watermark ``reserve_blocks`` (an empty pool admits anything that fits);
* runs one chunked-prefill forward of shape ``[slots, prefill_chunk]`` for
  the lanes still prefilling (per-column argmax gives each lane's first
  token from the column of its last prompt token);
* runs one decode chunk of ``steps_per_call`` forwards for the decoding
  lanes, argmax on the device, with ONE host sync per chunk;
* releases lanes at EOS or budget. When a lane cannot grow, the youngest
  other group is preempted to the head of the queue and later resumes by
  recompute, with its emitted tokens folded into its prompt, so its greedy
  stream equals an uncontended run.

**Automatic prefix caching** (``prefix_cache=True``): lanes are laid out
from position 0, so a full block's K/V is a pure function of the token
prefix. Admission chain-hashes the (resume) prompt's full blocks
(``block_cache.chain_hashes``), maps the longest cached prefix into the
lane's table with a reference each, and starts prefill past the hit,
capped one token short of the prompt's end: the last prompt token always
recomputes, since its logits give the first generated token. A write into
a block that another lane shares first copies it into a fresh block
(``ops.kvcache.copy_blocks``) and rewrites the table. Lanes register
their full blocks when a chunk fills them and when they are preempted;
blocks with no reference park in an LRU that allocation evicts from, so a
preempted group resumes as a cache hit. Off, admission and every dispatch
are the uncached pool's.

The host owns the row variables (``idx``, ``start``, ``table``) and writes
them into the cache tensors in place before every dispatch; idle lanes
park at ``idx = max_len``, so their writes land in the garbage block.

**Fleet prefix cache and KV migration** (``fleet_cache`` / ``kv_migration``, both
on top of the prefix cache): the serve loop refreshes ``fleet_digest``, the
top-``digest_k`` cached chains by hits, which the worker sends the router
on its heartbeats. ``serve_chain`` extracts a cached chain's blocks for a
puller and ``inject_chain`` lands shipped blocks as cached, unreferenced
entries, so the next admission of that prefix is an ordinary hit; both run
as ops on the serve thread at the next iteration (``run_op``), which owns
the allocator and the cache. With migration on, a preempted single-prompt
group whose transfer the worker's policy prefers to recompute leaves the
pool as a ticket (its full blocks, prompt, emitted tokens and remaining
budget); the worker's sender resolves it from the target's continuation
(``complete_migrated``) or hands it back for recompute-resume
(``requeue_migrated``).

**Live weight swap** (``request_swap``, reference ``:676-880``): a
follower (``serving/weight_stream.py``) stages each whole round's update,
keyed by the wire's flat names (``models/convert.py`` maps them onto the
module's parameters); a round staged before the last one applied folds
into it in f32. The serve thread applies the staged sum at the top of its
next iteration, between dispatched forwards: each named leaf becomes
``(leaf.float() + u.float()).to(leaf.dtype)``, a new tensor, so no forward
ever reads mixed rounds. ``keep_previous`` keeps the replaced leaves;
``pin_round`` holds serving at a round (later rounds stage, fold and count
as deferred) and, pinned at the previous round, restores the snapshot and
folds the undone update back into the pending sum, so lifting the pin
rolls forward through the rolled-back round. Each flip bumps the block
allocator's generation: no admission after it maps a chain written before
it. ``weight_state`` is the serving ``(round, generation)``, ``(None,
None)`` before the first swap. Each flip is logged (``weight swap:``) with
the staged-to-flip and flip milliseconds, the counts applied, deferred and
rolled back, the allocator's generation and a digest of the served leaves
(``swap_log`` keeps them).

Greedy only: sampled requests take ``PoolServer``'s one-shot fallback.
The pool records into ``SERVE_METRICS`` where the reference's does
(admissions, preemptions, rejections, prefix hits and misses, copy-on-write
copies, swaps, each request's submit-to-answer milliseconds, and after each
step its free blocks, queue depth, cached blocks and the last decode's
attended blocks), and keeps plain counters beside them: ``hit_blocks``,
``miss_blocks``, ``cow_copies``, ``migrated_out``, ``requeued``, and in
``stats`` the fleet counts under the reference's names
(``remote_prefix_hits``, ``remote_prefix_misses``, ``blocks_shipped``,
``block_bytes_shipped``, ``migrations``, ``transfer_chosen``,
``recompute_chosen``; ``count`` adds to them, and to ``SERVE_METRICS``,
from any thread).
Options of the JAX pool that this port does not have yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..ops.kvcache import KVCache, copy_blocks, extract_blocks, insert_blocks, pool_leaves
from ..telemetry import trace
from ..telemetry.flight import FLIGHT
from ..telemetry.ft_metrics import SERVE_METRICS
from .block_cache import PrefixBlockCache, chain_hashes

__all__ = ["DecodePool", "PoolBusy", "StaleBlockGeneration"]

log = logging.getLogger("hypha.torch.executor.pool")

# Pool options of the JAX package that wait for a later slice of the port.
_NOT_PORTED = {
    "spec_ngram": "speculative decoding",
    "spec_draft": "speculative decoding",
    "spec_layers": "speculative decoding",
    "draft_model": "speculative decoding",
    "draft_params": "speculative decoding",
}
# The fleet counts the JAX pool's worker keeps in its serving metrics.
FLEET_STATS = ("remote_prefix_hits", "remote_prefix_misses", "blocks_shipped",
               "block_bytes_shipped", "migrations", "transfer_chosen", "recompute_chosen")
# Serve-loop wake sentinel: unblocks an idle queue.get so a queued op runs.
_WAKE: Any = object()


class StaleBlockGeneration(RuntimeError):
    """Shipped blocks were computed under other weights than this pool
    serves: admission refuses the stamp rather than serve old-weight KV."""


class PoolBusy(RuntimeError):
    """Backpressure: the waiting line is full; retry after ``retry_after_s``."""

    def __init__(self, retry_after_s: float) -> None:
        super().__init__(f"pool queue is full; retry after {retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


@dataclass
class _Group:
    prompts: list
    n_new: int
    fut: Future
    rows: dict = field(default_factory=dict)  # lane -> _PRow
    order: int = -1  # admission sequence; preemption picks the youngest
    # Serve-path tracing: the request's ``decode`` span, opened at its first
    # admission and finished when it resolves (it spans preempt and
    # re-admit cycles: the decode latency the caller saw), and the
    # submitting request's context. Both None while tracing is off.
    trace_span: Any = None
    traceparent: "str | None" = None
    t_submit: float = 0.0  # the request's latency starts here


@dataclass
class _PRow:
    """One prompt's state. ``prompt`` and ``emitted`` survive preemption;
    the lane, window and blocks are rebuilt at re-admission."""

    group: _Group
    lane: int
    prompt: list
    budget: int
    emitted: list = field(default_factory=list)
    done: bool = False
    slot: int = -1
    window: int = 0  # prefill target: len(prompt + emitted) at admission
    pos: int = 0  # logical write index: prefill progress, then decode
    blocks: list = field(default_factory=list)
    win_tokens: Any = None  # np[window + prefill_chunk] resume prompt
    # Prefix cache: how many leading blocks are registered, and the chain
    # hash after them (block_cache.chain_hashes' recurrence).
    hashed: int = 0
    chain_h: int = 0


class DecodePool:
    """Paged continuous-batching pool over a ``models.llama.Llama``.

    ``submit`` is thread-safe and returns a Future resolving to one token
    list per prompt. ``close()`` fails queued and in-flight requests."""

    def __init__(
        self,
        model,
        *,
        slots: int = 8,
        max_len: int = 512,
        steps_per_call: int = 8,
        eos_token_id: "int | None" = None,
        block_size: int = 0,
        num_blocks: int = 0,
        prefill_chunk: int = 0,
        reserve_blocks: int = -1,
        max_queue: int = 0,
        prefix_cache: bool = False,
        ragged: bool = False,
        kv_quant: str = "",
        fleet_cache: bool = False,
        kv_migration: bool = False,
        digest_k: int = 32,
        **not_ported: Any,
    ) -> None:
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected pool option {name!r}")
            if (value is not None) if name.startswith("draft_") else value:
                raise NotImplementedError(
                    f"{name} is not ported yet: ROADMAP.md, Queue 1, "
                    f"'{_NOT_PORTED[name]}'"
                )
        if block_size <= 0:
            raise NotImplementedError(
                "fixed-slot mode (block_size=0) is not ported yet: "
                "ROADMAP.md, Queue 1, 'fixed-slot pool mode'"
            )
        if not hasattr(model, "config") or not hasattr(model.config, "num_kv_heads"):
            raise ValueError(f"{type(model).__name__} has no per-row decode path")
        if kv_quant not in ("", "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        if (fleet_cache or kv_migration) and not prefix_cache:
            # Both trade in content-addressed blocks: without the chain-hash
            # registry there is nothing to ship or land on.
            raise ValueError("fleet_cache / kv_migration require paged mode with prefix_cache=True")
        if max_len % block_size != 0:
            raise ValueError(f"max_len {max_len} must be a multiple of block_size {block_size}")
        if prefill_chunk <= 0:
            prefill_chunk = min(max_len, 4 * block_size)
        if max_len % prefill_chunk != 0:
            raise ValueError(
                f"max_len {max_len} must be a multiple of prefill_chunk {prefill_chunk}"
            )
        if prefill_chunk % block_size != 0:
            # A non-multiple would map the prompt tail to the garbage block.
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be a multiple of block_size {block_size}"
            )
        if num_blocks <= 0:
            num_blocks = slots * max_len // block_size
        self._model = model
        self._device = model.device
        self.slots, self.max_len = slots, max_len
        self.steps_per_call = steps_per_call
        self.eos_token_id = eos_token_id
        self.block_size, self.num_blocks = block_size, num_blocks
        self.prefill_chunk = prefill_chunk
        self.ragged, self.kv_quant = bool(ragged), kv_quant
        self.prefix_cache = bool(prefix_cache)
        self.reserve_blocks = slots if reserve_blocks < 0 else reserve_blocks
        self.max_queue = max(int(max_queue), 0)
        with torch.inference_mode():
            self._cache = KVCache.for_model(
                model, slots, max_len, per_row=True, blocks=num_blocks,
                block_size=block_size, kv_quant=kv_quant, ragged=self.ragged,
            )
        self._alloc = PrefixBlockCache(num_blocks, block_size, caching=self.prefix_cache)
        self._lane_rows: dict = {}
        self._free_lanes = list(range(slots))
        self._h_idx = np.full((slots,), max_len, np.int32)
        self._h_start = np.zeros((slots,), np.int32)
        self._h_table = np.full((slots, max_len // block_size), num_blocks, np.int32)
        # The digest is rebuilt by the serve thread each iteration and read
        # whole by the heartbeat; serve_chain / inject_chain run as ops on
        # the serve thread, which alone touches the allocator and cache.
        self.fleet_cache, self.kv_migration = bool(fleet_cache), bool(kv_migration)
        self.digest_k = max(int(digest_k), 1)
        self.fleet_digest: list = []
        self._ops: list = []  # (fn, Future) to run on the serve thread
        self._ops_lock = threading.Lock()
        self._migrate_policy = None  # (est_bytes, tokens) -> target | None
        self._migrate_send = None  # (ticket) -> None, hands off to the sender
        self._prefill_rate = 0.0  # tokens/s EWMA of the prefill chunks
        self._block_bytes = 0  # bytes one shipped block carries (lazy)
        self.migrated_out = 0
        self.requeued = 0  # migrations handed back for recompute-resume
        self._queue: "queue.Queue[_Group | None]" = queue.Queue()
        self._waiting: list = []
        # Guards submit's closed-check + enqueue against _fail_all's drain.
        self._submit_lock = threading.Lock()
        self._closed = False
        self._backlog = 0
        self._admit_seq = 0
        self.chunks = 0  # decode chunks dispatched
        self.prefill_chunks = 0
        self.preemptions = 0
        self.requests = 0
        # Prefix cache: blocks mapped from the cache at admission, hashed
        # blocks that missed, and copy-on-write block copies.
        self.hit_blocks = 0
        self.miss_blocks = 0
        self.cow_copies = 0
        # Host-clock totals of the dispatches, each ending in a host sync.
        self.stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                      "decode_s": 0.0, "decode_tokens": 0, **dict.fromkeys(FLEET_STATS, 0)}
        self._stats_lock = threading.Lock()
        # Live weight swap: staged by request_swap from any thread, applied
        # by the serve thread at the top of an iteration.
        self._swap_lock = threading.Lock()
        self._pending_swap: "dict | None" = None
        self._pending_rollback: "int | None" = None
        self._prev_leaves: "tuple | None" = None  # (round, {flat name: old leaf})
        self._param_index: "dict | None" = None  # flat name -> (param name, transposed)
        self.weight_round: "int | None" = None
        self.weight_generation: "int | None" = None
        self.pinned_round: "int | None" = None
        self.swaps_applied = 0
        self.swaps_deferred = 0
        self.swaps_rolled_back = 0
        self.swap_log: list = []
        self._thread = threading.Thread(target=self._serve_loop, name="decode-pool", daemon=True)
        self._thread.start()

    # ---------------------------------------------------------- load stats

    def free_blocks(self) -> int:
        return self._alloc.free_count()

    def queue_depth(self) -> int:
        with self._submit_lock:
            return self._backlog

    def live_rows(self) -> int:
        return len(self._lane_rows)

    def cached_count(self) -> int:
        """Blocks registered in the prefix cache."""
        return self._alloc.cached_count()

    def shared_count(self) -> int:
        """Blocks mapped by more than one lane."""
        return self._alloc.shared_count()

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to ``stats[name]`` (thread-safe), and to its
        ``SERVE_METRICS`` counter for a fleet count."""
        with self._stats_lock:
            self.stats[name] += n
        if name in FLEET_STATS:
            getattr(SERVE_METRICS, name).add(n)

    # ------------------------------------- fleet cache / migration plumbing

    def run_op(self, fn) -> Future:
        """Run ``fn()`` on the serve thread before its next step
        (thread-safe): every touch of the allocator or the cache from
        another thread goes through here."""
        fut: Future = Future()
        with self._ops_lock:
            if self._closed:
                fut.set_exception(RuntimeError("pool is closed"))
                return fut
            self._ops.append((fn, fut))
        self._queue.put(_WAKE)
        return fut

    def _drain_ops(self) -> None:
        while True:
            with self._ops_lock:
                if not self._ops:
                    return
                fn, fut = self._ops.pop(0)
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except Exception as exc:  # noqa: BLE001 — delivered to the caller
                fut.set_exception(exc)

    def serve_chain(self, hashes: list) -> Future:
        """Resolve the longest cached prefix of ``hashes`` and extract its
        blocks (every leaf, int8 scales included). Resolves to
        ``{"hashes", "leaves"}``, or None when nothing is cached."""
        return self.run_op(lambda: self._op_serve_chain(list(hashes)))

    def inject_chain(self, hashes: list, leaves: dict, weight_round, weight_generation) -> Future:
        """Land shipped blocks (one run of ``block_size`` rows per hash) as
        registered, unreferenced cache entries. Resolves to the number of
        blocks landed; raises :class:`StaleBlockGeneration` when the stamp
        is not this pool's."""
        return self.run_op(lambda: self._op_inject_chain(
            list(hashes), leaves, weight_round, weight_generation))

    def set_migrate_hooks(self, policy, send) -> None:
        """The worker's preemption hooks: ``policy(est_bytes, resume_tokens)
        -> target | None`` picks transfer or recompute, ``send(ticket)``
        hands the ticket to the sender. Both run on the serve thread and
        must not block."""
        self._migrate_policy = policy
        self._migrate_send = send

    def _block_nbytes(self) -> int:
        """Bytes one shipped block carries, over every pool leaf."""
        if not self._block_bytes:
            self._block_bytes = sum(
                self.block_size * leaf[0].numel() * leaf.element_size()
                for leaf in pool_leaves(self._cache).values())
        return self._block_bytes

    def prefill_cost_s(self, tokens: int) -> "float | None":
        """Seconds to prefill ``tokens`` here at the measured prefill rate;
        None before the first prefill chunk was timed."""
        rate = self._prefill_rate
        return tokens / rate if rate > 0 else None

    def _op_serve_chain(self, hashes: list) -> "dict | None":
        if not self.prefix_cache:
            raise RuntimeError("chain serving requires the prefix cache")
        ids = self._alloc.resolve_chain(hashes)
        if not ids:
            return None
        return {"hashes": list(hashes[: len(ids)]),
                "leaves": extract_blocks(self._cache, ids, self.block_size)}

    def _op_inject_chain(self, hashes: list, leaves: dict, wr, wg) -> int:
        if not self.prefix_cache:
            raise RuntimeError("chain injection requires the prefix cache")
        if (wr, wg) != self.weight_state():
            raise StaleBlockGeneration(
                f"shipped blocks stamped {(wr, wg)}, pool serves {self.weight_state()}")
        bs, n = self.block_size, len(hashes)
        taken: list = []  # (block, hash)
        rows: list = []  # which of the shipped row runs
        for i, h in enumerate(hashes):
            if self._alloc.block_for(h) is not None:
                continue  # already cached
            if self._lane_rows and self._alloc.free_count() <= max(self.reserve_blocks, 0):
                break  # warming the cache must not starve live lanes
            b = self._alloc.alloc()
            if b is None:
                break
            taken.append((b, h))
            rows.append(i)
        if not taken:
            return 0
        sub = {key: a.reshape(n, bs, *a.shape[1:])[rows].reshape(len(rows) * bs, *a.shape[1:])
               for key, a in leaves.items()}
        insert_blocks(self._cache, [b for b, _ in taken], sub, bs)
        for b, h in taken:
            self._alloc.register(b, h)
            self._alloc.release(b)  # unreferenced and registered: parks in the LRU
        return len(taken)

    # ----------------------------------------------------- weight swapping

    def weight_state(self) -> tuple:
        """The serving (round, generation); ``(None, None)`` until the first
        swap (requests decode on the dispatched weights)."""
        with self._swap_lock:
            return self.weight_round, self.weight_generation

    def _params(self) -> dict:
        if self._param_index is None:
            from ..models.convert import flat_names

            self._param_index = flat_names(self._model)
        return self._param_index

    def _norm_swap_key(self, name: str) -> str:
        """A wire name in the pool's spelling (the flat name without the
        ``params/`` head), normalized once at staging so fold, undo and
        apply share one key; an unknown name passes through and fails at
        apply."""
        names = self._params()
        if name in names:
            return name
        if name.startswith("params/") and name[7:] in names:
            return name[7:]
        return name

    def _as_f32(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(device=self._device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(v, np.float32), device=self._device)

    def request_swap(self, updates: dict, *, round_num: int, generation: int = 0,
                     keep_previous: bool = False) -> None:
        """Stage round ``round_num``'s update (flat name -> delta, in the
        wire's layout) for a flip at the next serve iteration. Thread-safe;
        rounds come contiguously (the stager sees to it). A round staged
        before the previous one applied folds into it (f32 adds): updates
        are deltas, so replacing would skip a round. While ``pin_round``
        holds serving back, later rounds fold and count as deferred."""
        if self._closed:
            return
        staged = {self._norm_swap_key(k): self._as_f32(v) for k, v in updates.items()}
        with self._swap_lock:
            pend = self._pending_swap
            if pend is None:
                self._pending_swap = {"updates": staged, "round": int(round_num),
                                      "generation": int(generation),
                                      "keep_previous": bool(keep_previous),
                                      "staged_at": time.perf_counter()}
            else:
                acc = pend["updates"]
                for k, v in staged.items():
                    acc[k] = acc[k] + v if k in acc else v
                pend.update(round=int(round_num), generation=int(generation),
                            keep_previous=bool(keep_previous))
            if self.pinned_round is not None and int(round_num) > self.pinned_round:
                self.swaps_deferred += 1
                SERVE_METRICS.swap_deferred.add(1)
        self._queue.put(_WAKE)  # an idle loop flips without waiting for traffic

    def pin_round(self, round_num: "int | None") -> None:
        """Hold serving at ``round_num`` (None lifts the pin): later staged
        rounds defer and keep folding. Pinning the previous applied round
        restores it from the ``keep_previous`` snapshot at the next
        iteration."""
        with self._swap_lock:
            self.pinned_round = int(round_num) if round_num is not None else None
            if (round_num is not None and self._prev_leaves is not None
                    and self._prev_leaves[0] == int(round_num)
                    and self.weight_round is not None and self.weight_round > int(round_num)):
                self._pending_rollback = int(round_num)
        self._queue.put(_WAKE)

    def _leaf(self, name: str) -> tuple:
        """(module, attribute, transposed?) of a flat name; KeyError on a
        name the model does not have (a wire/model mismatch fails loud)."""
        pname, transposed = self._params()[name]
        mod_name, _, attr = pname.rpartition(".")
        return self._model.get_submodule(mod_name) if mod_name else self._model, attr, transposed

    def served_digest(self) -> str:
        """A digest of the served leaves' exact bits (``theta_checksum``
        over the flat names), as the swap log records it."""
        from .training import theta_checksum

        return theta_checksum({name: getattr(*self._leaf(name)[:2]) for name in self._params()})

    def _apply_swap(self) -> None:
        """Serve thread only: flip to the staged round, or roll back to the
        pinned snapshot, between two iterations' forwards. Only the named
        leaves change; each becomes a new tensor."""
        with self._swap_lock:
            pend = self._pending_swap
            rollback, self._pending_rollback = self._pending_rollback, None
            pinned = self.pinned_round
            if pend is not None and pinned is not None and pend["round"] > pinned:
                pend = None  # stays staged; folds until unpinned
            elif pend is not None:
                self._pending_swap = None
        if rollback is not None and self._prev_leaves is not None:
            prev_round, leaves = self._prev_leaves
            if prev_round == rollback:
                # Fold the undone update (current - snapshot) back into the
                # pending sum before restoring, so the flip after the pin
                # rolls forward through the rolled-back round.
                rolled_from = self.weight_round
                undo = {}
                for name, old in leaves.items():
                    mod, attr, transposed = self._leaf(name)
                    d = getattr(mod, attr).float() - old.float()
                    undo[name] = d.T if transposed else d
                with self._swap_lock:
                    pend2 = self._pending_swap
                    if pend2 is None:
                        self._pending_swap = {"updates": undo, "round": rolled_from,
                                              "generation": self.weight_generation or 0,
                                              "keep_previous": False,
                                              "staged_at": time.perf_counter()}
                    else:
                        acc = pend2["updates"]
                        for k, v in undo.items():
                            acc[k] = acc[k] + v if k in acc else v
                for name, old in leaves.items():
                    mod, attr, _ = self._leaf(name)
                    getattr(mod, attr).data = old
                self._prev_leaves = None
                with self._swap_lock:
                    self.weight_round = prev_round
                    self.swaps_rolled_back += 1
                self._alloc.bump_generation()
                SERVE_METRICS.swap_rolled_back.add(1)
                SERVE_METRICS.weight_state(prev_round, self.weight_generation or 0)
                self._log_swap("rolled back to", prev_round, self.weight_generation or 0, None,
                               0.0)
        if pend is None:
            return
        t0 = time.perf_counter()
        prev = {} if pend["keep_previous"] else None
        for name, u in pend["updates"].items():
            mod, attr, transposed = self._leaf(name)
            leaf = getattr(mod, attr)
            if prev is not None:
                prev[name] = leaf.data
            u = u.T if transposed else u
            leaf.data = (leaf.float() + u.float()).to(leaf.dtype).contiguous()
        if prev is not None:
            self._prev_leaves = (self.weight_round, prev)
        with self._swap_lock:
            self.weight_round = pend["round"]
            self.weight_generation = pend["generation"]
            self.swaps_applied += 1
        # Cached prefix blocks hold K/V of the old weights: no admission
        # from now on maps them (live lanes keep theirs until release).
        self._alloc.bump_generation()
        SERVE_METRICS.swap_applied.add(1)
        SERVE_METRICS.swap_finished((time.perf_counter() - pend["staged_at"]) * 1000.0)
        SERVE_METRICS.weight_state(pend["round"], pend["generation"])
        FLIGHT.record("serve.weight_swap", round=pend["round"], generation=pend["generation"],
                      live_rows=len(self._lane_rows))
        self._log_swap("applied", pend["round"], pend["generation"], pend["staged_at"], t0)

    def _log_swap(self, what: str, round_num: int, generation: int, staged_at, t0: float) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        now = time.perf_counter()
        rec = {"what": what, "round": round_num, "generation": generation,
               "staged_to_flip_ms": None if staged_at is None else (now - staged_at) * 1e3,
               "flip_ms": (now - t0) * 1e3 if t0 else 0.0, "applied": self.swaps_applied,
               "deferred": self.swaps_deferred, "rolled_back": self.swaps_rolled_back,
               "alloc_generation": self._alloc.generation, "digest": self.served_digest(),
               "live_rows": len(self._lane_rows), "t": now}
        self.swap_log.append(rec)
        log.info("weight swap: %s", json.dumps(rec))

    # ------------------------------------------------------------ public

    def _pwin(self, n: int) -> int:
        """The smallest multiple of ``prefill_chunk`` holding ``n`` tokens."""
        P = self.prefill_chunk
        return max(-(-max(n, 1) // P) * P, P)

    def _paged_reject(self, prompts: list, n_new: int) -> "str | None":
        """Why the pool can never serve this request (None = fits). The
        window bound keeps ``prefill_chunk`` of slack for a resume prompt."""
        P = self.prefill_chunk
        longest = max(len(p) for p in prompts)
        limit = self._pwin(longest) + n_new + P
        if limit > self.max_len:
            return (
                f"paged window {self._pwin(longest)} + {n_new} new tokens "
                f"+ {P} resume slack exceed the pool window {self.max_len}"
            )
        need = len(prompts) * (-(-limit // self.block_size))
        if need > self.num_blocks:
            return f"request needs up to {need} KV blocks but the pool has {self.num_blocks}"
        return None

    def fits(self, prompts: list, n_new: int) -> bool:
        if not prompts or any(not p for p in prompts) or len(prompts) > self.slots:
            return False
        return self._paged_reject(prompts, n_new) is None

    def submit(self, prompts: list, n_new: int, traceparent: "str | None" = None) -> Future:
        """Queue ``prompts`` for greedy continuation, ``n_new`` tokens each.
        ``traceparent`` parents the group's prefill and decode spans under
        the submitting request's trace."""
        fut: Future = Future()
        if not prompts or any(not p for p in prompts):
            fut.set_exception(ValueError("prompts must be non-empty"))
            return fut
        if len(prompts) > self.slots:
            fut.set_exception(ValueError(f"{len(prompts)} prompts exceed {self.slots} slots"))
            return fut
        reason = self._paged_reject(prompts, n_new)
        if reason is not None:
            fut.set_exception(ValueError(reason))
            return fut
        with self._submit_lock:
            if self._closed:
                fut.set_exception(RuntimeError("pool is closed"))
                return fut
            if self.max_queue and self._backlog >= self.max_queue:
                # Reject with a retry-after hint instead of queueing without
                # bound.
                SERVE_METRICS.rejections.add(1)
                fut.set_exception(PoolBusy(0.05 * (self._backlog - self.max_queue + 1)))
                return fut
            self.requests += 1
            self._backlog += 1
            self._queue.put(_Group([list(p) for p in prompts], int(n_new), fut,
                                   traceparent=traceparent, t_submit=time.monotonic()))
        return fut

    def close(self, wait: bool = True) -> None:
        """Stop serving; the serve thread fails every queued and in-flight
        request as it exits."""
        self._closed = True
        self._queue.put(None)
        if wait:
            self._thread.join(timeout=30)

    def _fail_all(self, exc: Exception) -> None:
        with self._submit_lock:
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None and item is not _WAKE:
                    self._waiting.append(item)
            self._backlog = 0
        with self._ops_lock:
            ops, self._ops = self._ops, []
        for _fn, fut in ops:
            if not fut.done():
                fut.set_exception(exc)
        for g in self._waiting:
            if not g.fut.done():
                g.fut.set_exception(exc)
        self._waiting.clear()
        for r in self._lane_rows.values():
            if not r.group.fut.done():
                r.group.fut.set_exception(exc)
        self._lane_rows.clear()

    # --------------------------------------------------------- serve loop

    def _serve_loop(self) -> None:
        try:
            # Inference mode and the current CUDA device are thread-local:
            # set them here, in the thread that runs the forwards.
            with torch.inference_mode():
                if self._device.type == "cuda":
                    torch.cuda.set_device(self._device)
                while self._serve_once():
                    pass
        except Exception:
            log.exception("decode pool crashed")
            self._closed = True
            self._fail_all(RuntimeError("decode pool crashed"))

    def _serve_once(self) -> bool:
        """One serve-loop iteration; False once the pool stops. Waiting
        groups count as live work, so a preempted group is re-admitted
        without waiting for the next submit."""
        live = bool(self._lane_rows) or bool(self._waiting)
        stop = False
        try:
            item = self._queue.get(block=not live)
            while True:
                if item is None:
                    stop = True
                    break
                if item is not _WAKE:
                    self._waiting.append(item)
                item = self._queue.get_nowait()
        except queue.Empty:
            pass
        if stop:
            self._fail_all(RuntimeError("pool is closed"))
            return False
        # Between dispatched forwards: a staged swap flips here, before the
        # ops, so a stamp check inside one sees the weights the next
        # forward uses.
        self._apply_swap()
        self._drain_ops()
        self._step_paged()
        return True

    def _step_paged(self) -> None:
        """Admit what fits, advance chunked prefills, then one decode chunk
        for the decoding lanes: prefill and decode interleave."""
        self._admit_paged()
        pre = [r for r in self._lane_rows.values() if r.pos < r.window]
        if pre:
            self._run_prefill_chunk(pre)
            self._finish_paged()
        dec = [r for r in self._lane_rows.values() if r.pos >= r.window and not r.done]
        if dec:
            self._run_decode_chunk(dec)
            self._finish_paged()
        SERVE_METRICS.pool_state(self.free_blocks(), self.queue_depth())
        if self.prefix_cache:
            SERVE_METRICS.cache_state(self._alloc.cached_count(), self._alloc.shared_count())
        if self.fleet_cache:
            self.fleet_digest = self._alloc.hot_chains(self.digest_k)

    def _admit_paged(self) -> None:
        """FIFO block-granular admission above the watermark reserve. With
        the prefix cache on, each lane maps the longest cached prefix of
        its (resume) prompt and prefill starts at the first uncached
        position, capped one token short of the end."""
        bs = self.block_size
        while self._waiting:
            group = self._waiting[0]
            if not group.rows:
                for lane, p in enumerate(group.prompts):
                    group.rows[lane] = _PRow(group, lane, list(p), group.n_new)
            live = [r for r in group.rows.values() if not r.done]
            if len(live) > len(self._free_lanes):
                break
            # Fresh blocks per lane net of cached hits; hits parked in the
            # LRU leave the allocatable pool when mapped, so they count.
            need = 0
            plans = []
            for r in live:
                full = r.prompt + r.emitted  # recompute-resume prompt
                hashes = chain_hashes(full, bs) if self.prefix_cache else []
                hits, in_lru = self._alloc.peek(hashes)
                lane_blocks = -(-len(full) // bs)
                need += lane_blocks - hits + in_lru
                plans.append((r, full, hashes, lane_blocks))
            free = self._alloc.free_count()
            if free < need:
                break
            if self._lane_rows and free - need < self.reserve_blocks:
                break
            self._waiting.pop(0)
            with self._submit_lock:
                self._backlog -= 1
            self._admit_seq += 1
            group.order = self._admit_seq
            if group.trace_span is None:
                group.trace_span = trace.begin("decode", parent=group.traceparent,
                                               attrs={"rows": len(live)})
            for r, full, hashes, lane_blocks in plans:
                r.slot = self._free_lanes.pop()
                hit = self._alloc.lookup(hashes)
                fresh = [self._alloc.alloc() for _ in range(lane_blocks - len(hit))]
                if any(b is None for b in fresh):
                    raise RuntimeError("paged admission accounting broke")
                r.blocks = hit + fresh
                r.window = len(full)
                r.pos = min(len(hit) * bs, len(full) - 1)
                r.hashed = len(hit)
                r.chain_h = hashes[len(hit) - 1] if hit else 0
                self.hit_blocks += len(hit)
                self.miss_blocks += len(hashes) - len(hit)
                if self.prefix_cache:
                    SERVE_METRICS.prefix_hit_blocks.add(len(hit))
                    SERVE_METRICS.prefix_miss_blocks.add(len(hashes) - len(hit))
                r.win_tokens = np.zeros((len(full) + self.prefill_chunk,), np.int32)
                r.win_tokens[: len(full)] = full
                self._lane_rows[r.slot] = r
                self._h_start[r.slot] = 0
                self._h_table[r.slot, :] = self.num_blocks
                self._h_table[r.slot, : len(r.blocks)] = r.blocks
            SERVE_METRICS.admissions.add(1)

    def _push_rowvars(self) -> None:
        """Write the host row variables into the cache tensors in place."""
        c = self._cache
        c.idx.copy_(torch.from_numpy(self._h_idx))
        c.start.copy_(torch.from_numpy(self._h_start))
        c.table.copy_(torch.from_numpy(self._h_table))

    def _run_prefill_chunk(self, pre: list) -> None:
        """One [slots, prefill_chunk] forward over every prefilling lane."""
        P = self.prefill_chunk
        # Copy-on-write first: a copy target can preempt a group in ``pre``.
        for r in list(pre):
            if r.slot < 0 or r.done:
                continue
            if not self._cow_for_write(r, r.pos, P):
                self._fail_group(r.group, RuntimeError("paged pool exhausted"))
        pre = [r for r in pre if r.slot >= 0 and not r.done]
        if not pre:
            return
        toks = np.zeros((self.slots, P), np.int64)
        self._h_idx[:] = self.max_len  # park every lane in the garbage block
        for r in pre:
            toks[r.slot] = r.win_tokens[r.pos : r.pos + P]
            self._h_idx[r.slot] = r.pos
        # One ``prefill`` span per group the chunk serves, each in its
        # request's trace (the reference files one per chunk, under its
        # oldest group, so a request that shares a chunk has none).
        spans = []
        if trace.active() is not None:
            by_group: dict = {}
            for r in pre:
                by_group.setdefault(id(r.group), [r.group, 0])[1] += 1
            spans = [trace.begin("prefill", parent=g.traceparent,
                                 attrs={"rows": n, "chunk": P, "chunk_rows": len(pre)})
                     for g, n in by_group.values()]
        t0 = time.perf_counter()
        self._push_rowvars()
        logits = self._model(torch.from_numpy(toks).to(self._device), self._cache)
        nxt_host = logits.argmax(dim=-1).cpu().numpy()  # [slots, P] per-column greedy
        dt = time.perf_counter() - t0  # ends in the host sync: device time included
        for span in spans:
            trace.finish(span)
        self.stats["prefill_s"] += dt
        if dt > 0:
            # The recompute side of the transfer-vs-recompute policy.
            rate = P * len(pre) / dt
            self._prefill_rate = rate if self._prefill_rate == 0 else (
                0.7 * self._prefill_rate + 0.3 * rate)
        self.prefill_chunks += 1
        for r in pre:
            base = r.pos
            r.pos = min(r.pos + P, r.window)
            self.stats["prefill_tokens"] += r.pos - base
            if r.pos >= r.window:
                # The column of the last prompt token holds the first
                # generated token, exactly the monolithic prefill's.
                r.emitted.append(int(nxt_host[r.slot, r.window - 1 - base]))
            self._register_lane(r)

    def _grow(self, r: _PRow) -> bool:
        """Allocate the blocks the next decode chunk writes for ``r``,
        preempting the youngest other group when the pool is dry."""
        remaining = max(r.budget - len(r.emitted), 0)
        need = -(-(r.pos + min(self.steps_per_call, remaining)) // self.block_size)
        while len(r.blocks) < need:
            b = self._alloc.alloc()
            if b is None:
                victim = self._pick_victim(exclude=r.group)
                if victim is None:
                    return False
                self._preempt(victim)
                continue
            self._h_table[r.slot, len(r.blocks)] = b
            r.blocks.append(b)
        return True

    def _pick_victim(self, exclude: _Group) -> "_Group | None":
        """The most recently admitted live group other than ``exclude``."""
        victims = {id(r.group): r.group for r in self._lane_rows.values() if r.group is not exclude}
        if not victims:
            return None
        return max(victims.values(), key=lambda g: g.order)

    def _register_lane(self, r: _PRow) -> None:
        """Register ``r``'s newly full blocks in the prefix cache. A block
        is final once every position holds a token the request carries
        (``r.pos`` is the written extent; positions past ``prompt +
        emitted`` hold tokens past the budget, which nothing hashes)."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        full_len = len(r.prompt) + len(r.emitted)
        nfull = min(min(r.pos, full_len) // bs, len(r.blocks))
        if nfull <= r.hashed:
            return
        full = r.prompt + r.emitted
        h = r.chain_h
        for j in range(r.hashed, nfull):
            h = hash((h, tuple(full[j * bs : (j + 1) * bs])))
            self._alloc.register(r.blocks[j], h)
        r.chain_h = h
        r.hashed = nfull

    def _cow_for_write(self, r: _PRow, pos: int, span: int) -> bool:
        """Make the blocks that a write of ``[pos, pos + span)`` touches
        private: copy any block another lane shares into a fresh one, and
        un-register a cached block this lane alone holds before it is
        overwritten. False when no copy target can be had."""
        if not self.prefix_cache:
            return True
        bs = self.block_size
        hi = min(pos + span, len(r.blocks) * bs)
        for bi in range(pos // bs, -(-hi // bs)):
            b = r.blocks[bi]
            if self._alloc.is_shared(b):
                nb = self._alloc.alloc()
                while nb is None:
                    victim = self._pick_victim(exclude=r.group)
                    if victim is None:
                        return False
                    self._preempt(victim)
                    nb = self._alloc.alloc()
                copy_blocks(self._cache, [b], [nb], bs)
                self._alloc.release(b)
                r.blocks[bi] = nb
                self._h_table[r.slot, bi] = nb
                self.cow_copies += 1
                SERVE_METRICS.cow_copies.add(1)
            elif self._alloc.is_registered(b):
                # The lane's own cached block. Recomputing the final prompt
                # token of a capped hit rewrites the same K/V (the chain
                # hash covers that token), so the block stays registered;
                # any other overwrite would diverge from its hash.
                full_len = len(r.prompt) + len(r.emitted)
                identical = pos == full_len - 1 and bi == pos // bs and bi < r.hashed
                if not identical:
                    self._alloc.forget(b)
        return True

    def _release_lane(self, r: _PRow, *, register: bool) -> None:
        """Return the lane and its blocks; ``register`` (preemption) hashes
        its full blocks first, so the resume finds them cached. Blocks go
        back tail first: the LRU evicts oldest first, and a chain is
        useless without its head."""
        if register:
            self._register_lane(r)
        for b in reversed(r.blocks):
            self._alloc.release(b)
        self._h_table[r.slot, :] = self.num_blocks
        self._h_idx[r.slot] = self.max_len
        self._lane_rows.pop(r.slot, None)
        self._free_lanes.append(r.slot)
        r.slot, r.blocks, r.pos, r.window, r.win_tokens = -1, [], 0, 0, None
        r.hashed = r.chain_h = 0

    def _preempt(self, group: _Group) -> None:
        """Free the group's lanes and blocks and park it at the head of the
        queue; it resumes by recompute with its emitted tokens (from the
        cached prefix, with the prefix cache on). With KV migration on, a
        single-prompt group the policy ships leaves the pool instead."""
        if self._try_migrate(group):
            return
        for r in list(group.rows.values()):
            if r.slot >= 0 and not r.done:
                self._release_lane(r, register=True)
        self._waiting.insert(0, group)
        with self._submit_lock:
            self._backlog += 1
        self.preemptions += 1
        SERVE_METRICS.preemptions.add(1)
        FLIGHT.record("serve.preempt", rows=len(group.rows), order=group.order,
                      emitted=sum(len(r.emitted) for r in group.rows.values()))

    def _try_migrate(self, group: _Group) -> bool:
        """Ship a preemption victim instead of requeueing it. Single-prompt
        groups with at least one full block only. True: the group left
        this pool's books and the sender owns its future."""
        if not (self.kv_migration and self._migrate_policy is not None
                and self._migrate_send is not None and len(group.prompts) == 1):
            return False
        r = group.rows.get(0)
        if r is None or r.slot < 0 or r.done:
            return False
        bs = self.block_size
        full = r.prompt + r.emitted
        nfull = min(min(r.pos, len(full)) // bs, len(r.blocks))
        if nfull <= 0:
            return False  # nothing computed worth shipping
        try:
            target = self._migrate_policy(nfull * self._block_nbytes(), len(full))
        except Exception:  # noqa: BLE001 — the policy is the worker's hook
            log.exception("migrate policy failed; recompute-resume")
            return False
        if target is None:
            return False  # recompute wins, or no target named yet
        wr, wg = self.weight_state()
        ticket = {
            "group": group, "prompt": list(r.prompt), "emitted": list(r.emitted),
            "budget": max(r.budget - len(r.emitted), 0),
            "hashes": chain_hashes(full, bs)[:nfull], "block_size": bs,
            "leaves": extract_blocks(self._cache, r.blocks[:nfull], bs),
            "weight_round": wr, "weight_generation": wg, "target": target,
        }
        self._release_lane(r, register=True)
        self.preemptions += 1
        self.migrated_out += 1
        SERVE_METRICS.preemptions.add(1)
        FLIGHT.record("serve.migrate_out", order=group.order, blocks=nfull,
                      emitted=len(ticket["emitted"]))
        try:
            self._migrate_send(ticket)
        except Exception:  # noqa: BLE001 — the sender is the worker's hook
            log.exception("migrate send failed; recompute-resume")
            self.requeue_migrated(group)
        return True

    def requeue_migrated(self, group: _Group) -> None:
        """Any thread: a migration failed (refused, busy, link down); the
        group goes back to the serve loop for recompute-resume."""
        with self._submit_lock:
            if self._closed:
                if not group.fut.done():
                    group.fut.set_exception(RuntimeError("pool is closed"))
                return
            self._backlog += 1
            self.requeued += 1
            self._queue.put(group)

    def complete_migrated(self, group: _Group, tokens: list) -> None:
        """Any thread: the target decoded the rest of the budget; the
        group's answer is the tokens emitted here and the continuation."""
        r = group.rows[0]
        r.emitted = list(r.emitted) + [int(t) for t in tokens]
        r.done = True
        trace.finish(group.trace_span)
        group.trace_span = None
        if not group.fut.done():
            if group.t_submit:
                SERVE_METRICS.request_finished((time.monotonic() - group.t_submit) * 1e3)
            group.fut.set_result([r.emitted])

    def _run_decode_chunk(self, dec: list) -> None:
        K = self.steps_per_call
        for r in list(dec):
            if r.slot < 0 or r.done:  # preempted by an earlier _grow
                continue
            if not self._grow(r):
                # fits() bounds every group's need, so a sole live group
                # always grows; fail loudly rather than wedge the loop.
                self._fail_group(r.group, RuntimeError("paged pool exhausted"))
        live = [r for r in dec if r.slot >= 0 and not r.done]
        for r in list(live):
            # Decode writes land past the hit by construction, but a shared
            # block in the write range must never be written.
            if not self._cow_for_write(r, r.pos, K):
                self._fail_group(r.group, RuntimeError("paged pool exhausted"))
        live = [r for r in live if r.slot >= 0 and not r.done]
        if not live:
            return
        tok = np.zeros((self.slots,), np.int64)
        self._h_idx[:] = self.max_len
        for r in live:
            tok[r.slot] = r.emitted[-1]
            self._h_idx[r.slot] = r.pos
        t0 = time.perf_counter()
        self._push_rowvars()
        cur = torch.from_numpy(tok).to(self._device)
        steps = []
        for _ in range(K):
            cur = self._model(cur[:, None], self._cache)[:, -1].argmax(dim=-1)
            steps.append(cur)
        toks_host = torch.stack(steps).cpu().numpy()  # [K, slots]: the one sync
        self.stats["decode_s"] += time.perf_counter() - t0
        self.chunks += 1
        # The decode's occupancy: the ragged kernel visits exactly the
        # allocated blocks; a dense gather would pay every lane's window.
        allocated = sum(len(r.blocks) for r in live)
        capacity = len(live) * (self.max_len // self.block_size)
        SERVE_METRICS.attention_state(allocated if self.ragged else capacity, allocated,
                                      capacity)
        for r in live:
            for t in toks_host[:, r.slot]:
                if len(r.emitted) >= r.budget:
                    break
                r.emitted.append(int(t))
                self.stats["decode_tokens"] += 1
            r.pos += K
            self._register_lane(r)

    def _fail_group(self, group: _Group, exc: Exception) -> None:
        for r in list(group.rows.values()):
            if r.slot >= 0:
                self._release_lane(r, register=False)
        if not group.fut.done():
            group.fut.set_exception(exc)

    def _row_finished(self, row: _PRow) -> bool:
        """Budget/EOS check; pads an EOS row to its budget (as generate)."""
        full = len(row.emitted) >= row.budget
        eos = self.eos_token_id
        saw_eos = eos is not None and eos in row.emitted
        if not (full or saw_eos):
            return False
        if saw_eos:
            cut = row.emitted.index(eos) + 1
            row.emitted = row.emitted[:cut] + [eos] * (row.budget - cut)
        row.done = True
        return True

    def _finish_paged(self) -> None:
        for r in list(self._lane_rows.values()):
            if r.pos < r.window or not self._row_finished(r):
                continue
            # Its blocks were registered as chunks filled them, before
            # _row_finished's EOS padding rewrote ``emitted``.
            self._release_lane(r, register=False)
            group = r.group
            if all(pr.done for pr in group.rows.values()) and not group.fut.done():
                trace.finish(group.trace_span)
                group.trace_span = None
                if group.t_submit:
                    SERVE_METRICS.request_finished((time.monotonic() - group.t_submit) * 1e3)
                group.fut.set_result([group.rows[i].emitted for i in range(len(group.prompts))])
