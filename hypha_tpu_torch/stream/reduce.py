"""The tree reduce: a group reducer pre-folds its members' deltas before the
parameter-server shards (counterpart of the reduce half of
``hypha_tpu/stream/reduce.py``, ``:1-506``).

Workers are grouped by the job's plan (``stream.tree.build_reduce_groups``:
sorted peer ids in chunks of G, ``reduce_tree_depth`` levels deep). A
member routes each part's delta ``[reducer, shard]`` with ANY failover
(``worker.connectors.shard_route``); the group's first member runs a
:class:`GroupReducer` next to its training executor. The reducer takes the
members' pushes under the job's per-shard updates tags, folds them with the
same :class:`~hypha_tpu_torch.stream.accum.RoundAccum` arithmetic the shards
use (on the worker node's device), and forwards one partial per (round,
part), stamped ``prefold`` with the summed sample weight and the worker
peers it ``covers``:

  * a partial flushes when every worker of the reducer's subtree is
    represented, after ``$HYPHA_REDUCE_FLUSH_S`` seconds (5 by default)
    from the bucket's first delta otherwise, and again whenever a later
    delta lands: each flush carries the cumulative partial, so the shard's
    duplicate path (un-fold the old partial, fold the new) keeps the round
    exact however the arrivals interleave with the timer;
  * a member's re-send un-folds its superseded delta first;
  * a mid-tree reducer's bucket mixes raw deltas and its child reducers'
    partials, which fold verbatim and whose covers union transitively; it
    forwards to its own parent (``reduce_via``) with the shard as ANY
    failover.

Quantized jobs re-encode the partial in the job's codec with a per-part
error-feedback residual.

:class:`BroadcastRelay` runs the same tree downward for the update
broadcasts (the reference's ``:508-757``): with the job's broadcast tree
on, the parameter server pushes each round's wire to the top-level
reducers (and ungrouped workers and unattached serve leaves) only, under
``<results>.relay`` (:func:`relay_tag`). Each relay saves the wire once,
re-pushes it to its direct children with :func:`tree_broadcast` (the relay
tag for a child reducer, the plain results tag for a leaf, serving
followers included), then injects a plain-tagged copy into its own node
(``Node.inject_push``) for its training loop, with the sender and header
unchanged. A child whose push fails is expanded to its own children, so a
dead relay costs fan-out, not its subtree's round. A relay hop is
at-most-once: a relay that accepted a wire and died before re-pushing it
leaves its subtree without that round.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import tempfile
import time
import uuid
from pathlib import Path

from .. import aio, compress
from ..executor.serialization import save_file
from ..messages import COVERS_KEY, PREFOLD_KEY, SHARD_KEY, FragmentTag
from ..telemetry.ft_metrics import SCALE_METRICS, SHARD_METRICS
from .accum import RoundAccum
from .partition import shard_of
from .tree import children_of, subtree_of, tree_levels, with_serve_leaves

__all__ = ["GroupReducer", "BroadcastRelay", "TreeRuntime", "maybe_start_reducer",
           "maybe_start_relay", "relay_tag", "tree_broadcast", "REDUCE_FLUSH_ENV"]

log = logging.getLogger("hypha.torch.stream.reduce")

# Seconds after a (round, part) bucket's first delta before an incomplete
# partial is flushed anyway: a dead member must not park the group.
REDUCE_FLUSH_ENV = "HYPHA_REDUCE_FLUSH_S"
_FLUSH_DEFAULT = 5.0
_TICK_S = 0.25


def _flush_after() -> float:
    try:
        return float(os.environ.get(REDUCE_FLUSH_ENV, "") or _FLUSH_DEFAULT)
    except ValueError:
        return _FLUSH_DEFAULT


class TreeRuntime:
    """The tree roles one dispatched train job gave this worker: its
    :class:`GroupReducer` (upward folding) and, with the job's broadcast
    tree on, its :class:`BroadcastRelay` (downward fan-out). The worker
    runtimes ``await stop()`` it when the job ends."""

    def __init__(self, reducer=None, relay=None) -> None:
        self.reducer = reducer
        self.relay = relay

    async def stop(self) -> None:
        if self.relay is not None:
            await self.relay.stop()
        if self.reducer is not None:
            await self.reducer.stop()


def maybe_start_reducer(node, spec, device=None,
                        work_dir: "Path | str | None" = None) -> "TreeRuntime | None":
    """Start this worker's tree roles when the dispatched train spec names
    it its group's reducer (``reduce_members`` and a placement map): the
    :class:`GroupReducer`, and the :class:`BroadcastRelay` when the spec
    asks for it (``relay_results``); None for every other job. Both live
    in the worker runtime, beside the training executor, because they
    consume the node's pushes. ``work_dir`` (the job's, which the executor
    removes) holds their files; without one each makes and removes its
    own."""
    cfg = getattr(getattr(spec, "executor", None), "train", None)
    if cfg is None:
        return None
    shard_map = cfg.ps_shards
    if not cfg.reduce_members or shard_map is None or not shard_map.shards:
        return None
    reducer = GroupReducer(node, cfg, work_dir=work_dir, device=device)
    reducer.start()
    log.info("group reducer started: %d members, %d shard(s)", len(cfg.reduce_members),
             len(shard_map.shards))
    relay_dir = None if work_dir is None else Path(work_dir) / "relay"
    return TreeRuntime(reducer=reducer, relay=maybe_start_relay(node, spec, relay_dir))


class _Entry:
    """One accepted child contribution: the saved file, its weight, whether
    it is a prefolded partial, and the worker peers it covers."""

    __slots__ = ("path", "samples", "prefolded", "covers")

    def __init__(self, path: Path, samples: float, prefolded: bool, covers: frozenset) -> None:
        self.path = path
        self.samples = samples
        self.prefolded = prefolded
        self.covers = covers


class _Bucket:
    """One (round, part)'s group state. Entries are keyed as the shard's
    table is (``prefold:`` before a partial's sender): a mid-tree child
    sends both its own delta and its group's partial."""

    def __init__(self, device) -> None:
        self.accum = RoundAccum(device=device)
        self.entries: dict = {}
        self.first_at: "float | None" = None
        self.flushed = 0  # partials shipped so far, re-flushes included
        self.dirty = False  # folds since the last flush
        self.fold_s = 0.0

    def covered(self) -> set:
        """The worker peers the cumulative sum represents."""
        out: set = set()
        for entry in self.entries.values():
            out |= entry.covers
        return out


class GroupReducer:
    """Pre-fold this worker's group's deltas; forward partials per shard.

    ``cfg`` is the reducer's own ``TrainExecutorConfig``: the placement
    (``ps_shards``), the wire codec and the members whose pushes land here
    (``reduce_members``). Its own delta goes to the shard directly from
    its training loop, so it is never expected in a bucket. The sums live
    on ``device`` (CUDA unless the caller asks for the CPU).

    ``flushes`` records every partial shipped (round, part, flush index,
    entries, covers, bytes, seconds folding, encoding and pushing)."""

    def __init__(self, node, cfg, work_dir: "Path | str | None" = None, device=None) -> None:
        shard_map = cfg.ps_shards
        if shard_map is None or not shard_map.shards:
            raise ValueError("GroupReducer needs cfg.ps_shards placement")
        self.node = node
        self.cfg = cfg
        self.device = device
        self.members = set(cfg.reduce_members or [])
        self.shards = list(shard_map.shards)
        self.tags = list(shard_map.tags)
        self.num_shards = len(self.shards)
        self.parts = int(shard_map.fragments) or 1
        # Multi-level placement: the parent partials go to (None: the top,
        # ship to the shard) and the worker set the subtree can cover.
        groups = list(shard_map.groups or [])
        self.parent = cfg.reduce_via or None
        peer_id = getattr(node, "peer_id", "")
        self.expected_cover = (set(subtree_of(groups, peer_id)) if groups
                               else set(self.members)) or set(self.members)
        self.level = tree_levels(groups).get(peer_id, 1) if groups else 1
        self._own_dir = work_dir is None
        self.work_dir = Path(work_dir if work_dir is not None
                             else tempfile.mkdtemp(prefix="hypha-reduce-"))
        self.codec = compress.effective_codec(cfg.delta_codec or "none",
                                              cfg.delta_dtype or "float32")
        self._efs: dict = {}
        self._buckets: dict = {}
        self._flush_after = _flush_after()
        self._task: "asyncio.Task | None" = None
        self._consumer = None
        self.folds = 0
        self.unfolds = 0
        self.partials = 0
        self.flushes: list = []

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        tags = set(self.tags)
        members = set(self.members)

        def wants(push) -> bool:
            # Tag and sender: a reducer may share its node with a shard,
            # and a tag alone would steal direct deltas from non-members.
            r = push.resource
            return isinstance(r, dict) and r.get("resource") in tags and push.peer in members

        self.work_dir.mkdir(parents=True, exist_ok=True)
        self._consumer = self.node.consume_pushes(wants)
        self._task = aio.spawn(self._run(), what="group reducer", logger=log)

    async def stop(self) -> None:
        if self._task is not None:
            await aio.reap(self._task)
            self._task = None
        if self._consumer is not None:
            self._consumer.close()
            self._consumer = None
        if self._own_dir:
            await asyncio.to_thread(shutil.rmtree, self.work_dir, ignore_errors=True)

    # --------------------------------------------------------------- loop

    async def _run(self) -> None:
        assert self._consumer is not None
        while True:
            try:
                push = await self._consumer.next(timeout=_TICK_S)
            except asyncio.TimeoutError:
                await self._flush_due()
                continue
            await self._ingest(push)
            await self._flush_due()

    async def _fold(self, bucket: _Bucket, path: Path, samples: float, sign: float,
                    prefolded: bool) -> None:
        """One fold or un-fold into the bucket's sum, off the event loop."""
        t0 = time.perf_counter()
        await asyncio.to_thread(bucket.accum.fold, path, samples, sign, prefolded)
        bucket.fold_s += time.perf_counter() - t0

    async def _ingest(self, push) -> None:
        peer = push.peer
        meta = push.resource if isinstance(push.resource, dict) else {}
        if peer not in self.members:
            log.warning("reducer: push from non-member %s dropped", peer)
            await push.read_all()
            return
        try:
            round_num = int(meta.get("round", 0))
        except (TypeError, ValueError):
            round_num = 0
        part = self._part_of(meta)
        if part is None:
            log.warning("reducer: untagged push from %s dropped", peer)
            await push.read_all()
            return
        dest = self.work_dir / f"in-{round_num}-{part}-{uuid.uuid4().hex[:8]}"
        await push.save_to(dest)
        try:
            samples = float(meta.get("num_samples", 1.0))
        except (TypeError, ValueError):
            samples = 1.0
        # A child reducer's partial folds verbatim and covers the workers
        # its header lists; a raw delta covers its sender.
        prefolded = bool(meta.get(PREFOLD_KEY))
        covers = (frozenset(str(p) for p in (meta.get(COVERS_KEY) or ())) if prefolded
                  else frozenset((peer,)))
        key = f"prefold:{peer}" if prefolded else peer
        bucket = self._buckets.get((round_num, part))
        if bucket is None:
            bucket = self._buckets[(round_num, part)] = _Bucket(self.device)
        if bucket.first_at is None:
            bucket.first_at = asyncio.get_running_loop().time()
        old = bucket.entries.pop(key, None)
        if old is not None:
            # A re-send: un-fold the superseded delta from its own bytes;
            # the next flush ships the corrected cumulative sum.
            log.warning("reducer: duplicate %s from %s (round %d part %d); replacing",
                        "partial" if prefolded else "delta", peer, round_num, part)
            await self._fold(bucket, old.path, old.samples, -1.0, old.prefolded)
            self.unfolds += 1
            await asyncio.to_thread(old.path.unlink, missing_ok=True)
        await self._fold(bucket, dest, samples, 1.0, prefolded)
        self.folds += 1
        SHARD_METRICS.reduced_deltas.add(1)
        SCALE_METRICS.note_tree_fold(self.level)
        bucket.entries[key] = _Entry(dest, samples, prefolded, covers)
        bucket.dirty = True

    def _part_of(self, meta: dict) -> "int | None":
        tag = FragmentTag.from_header(meta)
        if tag is not None:
            return int(tag.fragment_id)
        if SHARD_KEY in meta:
            # Blocking sharded pushes: part k belongs to shard k.
            try:
                return int(meta[SHARD_KEY])
            except (TypeError, ValueError):
                return None
        resource = meta.get("resource")
        if resource in self.tags:
            return self.tags.index(resource)
        return None

    async def _flush_due(self) -> None:
        now = asyncio.get_running_loop().time()
        for (round_num, part), bucket in list(self._buckets.items()):
            if not bucket.dirty:
                continue
            # Complete when every worker of the subtree is represented.
            complete = bucket.covered() >= self.expected_cover
            overdue = bucket.first_at is not None and now - bucket.first_at >= self._flush_after
            if complete or overdue or bucket.flushed:
                # A delta landing after a flush re-ships at once.
                await self._flush(round_num, part, bucket)

    def _encode(self, wire: Path, part: int, bucket: _Bucket, tag_header) -> None:
        """The partial in the job's codec. SafeTensors codecs write the
        tensors in name order (the reference's ``safetensors`` writer
        orders them so); HQD1 frames keep the fold order."""
        partial = bucket.accum.partial()
        if self.codec == "none":
            save_file(dict(sorted(partial.items())), wire)
        elif self.codec == "bf16":
            compress.write_delta(wire, dict(sorted(partial.items())), self.codec)
        else:
            compress.write_delta(wire, partial, self.codec, ef=self._efs[part], tag=tag_header)

    async def _flush(self, round_num: int, part: int, bucket: _Bucket) -> None:
        owner = shard_of(part, self.num_shards)
        tag_header = None
        if self.parts > 1 or (self.cfg.sync_mode or "blocking") == "stream":
            tag_header = FragmentTag(round=round_num, fragment_id=part,
                                     fragments=self.parts).header()
        if part not in self._efs:
            self._efs[part] = (compress.ErrorFeedback() if self.codec in compress.QUANT_CODECS
                               else None)
        wire = self.work_dir / f"partial-{round_num}-{part}-{bucket.flushed}.safetensors"
        t0 = time.perf_counter()
        await asyncio.to_thread(self._encode, wire, part, bucket, tag_header)
        encode_s = time.perf_counter() - t0
        covered = sorted(bucket.covered())
        header: dict = {
            "resource": self.tags[owner],
            "name": wire.name,
            "round": round_num,
            "num_samples": float(bucket.accum.total_samples),
            PREFOLD_KEY: True,
            # Workers, never intermediate reducers: covers union through
            # child partials, so the shard counts covered workers.
            COVERS_KEY: covered,
        }
        if tag_header:
            header.update(tag_header)
        if self.num_shards > 1:
            header[SHARD_KEY] = owner
        shard_peer = self.shards[owner]
        # Up the tree: the parent first, the owning shard as ANY failover.
        peers = ([self.parent, shard_peer] if self.parent and self.parent != shard_peer
                 else [shard_peer])
        from ..network.node import RequestError
        from ..worker.connectors import push_timeout

        async def any_once() -> None:
            last: "Exception | None" = None
            for peer in peers:
                try:
                    await self.node.push(peer, header, wire)
                    return
                except (RequestError, OSError) as e:
                    last = e
            raise RequestError(f"no peer accepted the partial: {last}")

        nbytes = (await asyncio.to_thread(wire.stat)).st_size
        t1 = time.perf_counter()
        try:
            await aio.retry(
                any_once, attempts=3, base_delay=0.25,
                attempt_timeout=push_timeout(wire) * len(peers),
                retry_on=(RequestError, OSError), what=f"reduce partial to {peers}", logger=log,
            )
        except (RequestError, OSError, asyncio.TimeoutError) as e:
            # The members' ANY failover and the shard own liveness; the
            # next dirty flush tries again.
            log.warning("reducer: partial push r%d part %d to %s failed: %s", round_num, part,
                        peers, e)
            await asyncio.to_thread(wire.unlink, missing_ok=True)
            return
        push_s = time.perf_counter() - t1
        self.flushes.append({
            "round": round_num, "part": part, "flush": bucket.flushed,
            "entries": sorted(bucket.entries), "covers": covered, "bytes": nbytes,
            "fold_s": bucket.fold_s, "encode_s": encode_s, "push_s": push_s,
            "samples": float(bucket.accum.total_samples),
        })
        bucket.flushed += 1
        bucket.dirty = False
        self.partials += 1
        SCALE_METRICS.note_tree_forward(self.level)
        await asyncio.to_thread(wire.unlink, missing_ok=True)
        log.info("reducer: shipped partial r%d part %d flush %d -> %s (%d entries, covers %s, "
                 "weight %.1f): %d bytes, folded %.3f s, encoded %.3f s, pushed %.3f s",
                 round_num, part, bucket.flushed - 1, self.parent or f"shard {owner}",
                 len(bucket.entries), covered, bucket.accum.total_samples, nbytes,
                 bucket.fold_s, encode_s, push_s)
        await self._gc(round_num, part)

    async def _gc(self, round_num: int, part: int) -> None:
        """Retire the buckets of older rounds of the same part: a worker
        ships a part's round r+1 only after merging round r."""
        for key in [k for k in self._buckets if k[1] == part and k[0] < round_num]:
            paths = [e.path for e in self._buckets.pop(key).entries.values()]
            await asyncio.to_thread(lambda ps=paths: [p.unlink(missing_ok=True) for p in ps])


# ---------------------------------------------------------------- broadcast


def relay_tag(results_tag: str) -> str:
    """The tag broadcast-tree wires travel under between tree nodes: apart
    from the plain results tag, so a relay's consumer and its own training
    loop's receive never race for one push."""
    return f"{results_tag}.relay"


async def tree_broadcast(node, header: dict, results_tag: str, groups, targets, wire_path: Path,
                         *, allowed=None, concurrency: int = 8, attempts: int = 2,
                         what: str = "tree broadcast", logger=log) -> tuple:
    """Push one wire down a broadcast-tree hop, expanding failures.

    ``targets`` get the push concurrently, at most ``concurrency`` at once:
    a target with children in ``groups`` under the relay tag, a leaf under
    ``results_tag``. A target whose push fails after ``attempts`` tries is
    replaced by its direct children (those in ``allowed``, the live
    broadcast set, when given), so a dead relay costs this hop fan-out
    instead of severing its subtree. Returns ``(delivered, lost)``:
    ``lost`` counts the peers no path reached (they catch up next round,
    as after a failed direct push)."""
    from ..network.node import RequestError
    from ..worker.connectors import push_timeout

    kids = children_of(groups)

    async def push_one(peer: str) -> bool:
        hdr = {**header, "resource": relay_tag(results_tag) if kids.get(peer) else results_tag}
        try:
            await aio.retry(
                lambda: node.push(peer, hdr, wire_path), attempts=attempts, base_delay=0.25,
                attempt_timeout=push_timeout(wire_path), retry_on=(RequestError, OSError),
                what=f"{what} to {peer}", logger=logger,
            )
            return True
        except (RequestError, OSError, asyncio.TimeoutError) as e:
            logger.warning("%s to %s failed: %s", what, peer, e)
            return False

    delivered = lost = 0
    frontier = [str(p) for p in targets]
    while frontier:
        # push_one never raises, so each wave is one bounded fan-out.
        outcomes = await aio.gather_bounded([(lambda p=p: push_one(p)) for p in frontier],
                                            limit=concurrency)
        nxt: list = []
        for peer, ok in zip(frontier, outcomes):
            if ok:
                delivered += 1
                SCALE_METRICS.relay_pushes.add(1)
                continue
            children = [c for c in kids.get(peer, ()) if allowed is None or c in allowed]
            if children:
                # Around the dead relay: its children take the push from
                # this hop.
                SCALE_METRICS.relay_failovers.add(1)
                logger.warning("%s: relay %s unreachable; expanding to %d children %s", what,
                               peer, len(children), children)
                nxt.extend(children)
            else:
                lost += 1
        frontier = nxt
    return delivered, lost


class BroadcastRelay:
    """Re-push the results-stream wires down this worker's subtree.

    Saves each wire pushed under the relay tag once, re-pushes it to its
    direct children (:func:`tree_broadcast`, the serve leaves that
    ``ShardMap.serve_leaves`` attaches here among them), then injects a
    plain-tagged copy into its own node for the local training loop,
    keeping the sender (the parent hop) and the header verbatim (round,
    epoch, generation, shard, fragment tag), so every gate downstream
    behaves as under the star. ``hops`` records each wire: its header,
    sender, bytes, and the seconds saving and re-pushing it."""

    def __init__(self, node, cfg, work_dir: "Path | str | None" = None) -> None:
        shard_map = cfg.ps_shards
        if shard_map is None:
            raise ValueError("BroadcastRelay needs cfg.ps_shards placement")
        self.node = node
        self.groups = list(shard_map.groups or [])
        # Serve leaves ride the same downward plan as the PS derives it
        # (with_serve_leaves is pure over the placement), never the reduce
        # groups: a reducer must not wait on them.
        serve = list(shard_map.serve_leaves or [])
        self.bcast_groups = with_serve_leaves(self.groups, serve) if serve else self.groups
        self.results_tag = cfg.results.ref.resource or "results"
        self.children = children_of(self.bcast_groups).get(node.peer_id, [])
        self._own_dir = work_dir is None
        self.work_dir = Path(work_dir if work_dir is not None
                             else tempfile.mkdtemp(prefix="hypha-relay-"))
        self._task: "asyncio.Task | None" = None
        self._consumer = None
        self.relayed = 0
        self.hops: list = []

    def start(self) -> None:
        tag = relay_tag(self.results_tag)

        def wants(push) -> bool:
            r = push.resource
            return isinstance(r, dict) and r.get("resource") == tag

        self.work_dir.mkdir(parents=True, exist_ok=True)
        self._consumer = self.node.consume_pushes(wants)
        self._task = aio.spawn(self._run(), what="broadcast relay", logger=log)

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            # Cancel until it sticks: a cancel racing the local drain's
            # event can be swallowed by wait_for (bpo-37658).
            while not task.done():
                task.cancel()
                await asyncio.wait({task}, timeout=0.5)
        if self._consumer is not None:
            self._consumer.close()
            self._consumer = None
        if self._own_dir:
            await asyncio.to_thread(shutil.rmtree, self.work_dir, ignore_errors=True)

    async def _run(self) -> None:
        assert self._consumer is not None
        # One wire at a time: the server chains a fragment's fan-outs, so
        # the broadcast order is part of the protocol.
        while True:
            push = await self._consumer.next()
            try:
                await self._relay(push)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("broadcast relay failed for one wire")

    async def _relay(self, push) -> None:
        meta = push.resource if isinstance(push.resource, dict) else {}
        dest = self.work_dir / f"relay-{uuid.uuid4().hex[:12]}"
        t0 = time.perf_counter()
        nbytes = await push.save_to(dest)
        save_s = time.perf_counter() - t0
        self.relayed += 1
        # Subtree first, own copy second: once the subtree's root merged
        # round r, the subtree was served round r. The injected copy keeps
        # the parent hop as its sender, which the trainer's allowlist (its
        # ancestors beside the shards) admits.
        local_done = asyncio.Event()
        injected = False
        try:
            t1 = time.perf_counter()
            delivered, lost = await tree_broadcast(
                self.node, meta, self.results_tag, self.bcast_groups, self.children, dest,
                what="relay", logger=log)
            push_s = time.perf_counter() - t1
            self.hops.append({"header": dict(meta), "from": push.peer, "bytes": nbytes,
                              "save_s": save_s, "push_s": push_s, "delivered": delivered,
                              "lost": lost})
            log.info("relay: round %s from %s: %d bytes saved in %.3f s, pushed to %s in %.3f s "
                     "(%d delivered, %d lost); header %s", meta.get("round"), push.peer, nbytes,
                     save_s, self.children, push_s, delivered, lost, json.dumps(meta, default=str))
            await self.node.inject_push(push.peer, {**meta, "resource": self.results_tag}, dest,
                                        on_done=local_done.set)
            injected = True
        finally:
            if injected:
                # The local consumer owns the bytes until it finishes; one
                # that never drains (a job mid-teardown) must not pin the
                # file. asyncio.wait, not wait_for (bpo-37658).
                waiter = asyncio.create_task(local_done.wait())
                try:
                    done, _ = await asyncio.wait({waiter}, timeout=120)
                    if not done:
                        log.warning("relay: local consumer never drained the wire")
                finally:
                    waiter.cancel()
            await asyncio.to_thread(dest.unlink, missing_ok=True)


def maybe_start_relay(node, spec, work_dir: "Path | str | None" = None) -> "BroadcastRelay | None":
    """Start a :class:`BroadcastRelay` beside a dispatched train job whose
    spec turns the broadcast tree on (``relay_results``) and names this
    worker a reducer (``reduce_members``); None otherwise."""
    cfg = getattr(getattr(spec, "executor", None), "train", None)
    if cfg is None or not cfg.relay_results:
        return None
    if not cfg.reduce_members or cfg.ps_shards is None:
        return None
    relay = BroadcastRelay(node, cfg, work_dir=work_dir)
    relay.start()
    log.info("broadcast relay started: %d direct children %s", len(relay.children),
             relay.children)
    return relay
