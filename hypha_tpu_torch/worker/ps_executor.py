"""The parameter server: the DiLoCo outer optimizer (counterpart of the
single-shard, non-elastic, non-durable path of
``hypha_tpu/worker/ps_executor.py``).

:class:`ParameterServerExecutor` is the in-runtime executor a worker node
runs for an ``aggregate`` job. Each round it takes one pseudo-gradient
push per worker off the fabric (routed by the job's updates tag, from the
allowed peers only), saves it and folds it into the round's
:class:`~hypha_tpu_torch.stream.accum.RoundAccum` on the node's device as
it lands (a re-send from the same worker replaces its earlier delta, which
is un-folded). When every worker is in, :func:`outer_step` applies
Nesterov, the scheduler is told ``UPDATED`` (before the broadcast, so a
fast worker's ``UPDATE_RECEIVED`` never meets the old round), and the f32
update is pushed to the results peers with bounded fan-out. The fold and
the step are blocking device work and run in worker threads, so the
node's heartbeats and lease renewals go on during a large round.

The broadcast goes out in the job's wire codec (``delta_codec``;
``_encode_broadcast``, the reference's ``:2442-2467``): the f32 update
re-encoded as bf16 SafeTensors or an int8/int4 HQD1 frame of Q(update +
e) on the device, the server keeping its own error-feedback residual e.
``sync_mode`` overlap and stream run :meth:`_stream_rounds` (the
reference's ``:1604-2200``): each delta folds, as it lands, into the
accumulator of the round its ``FragmentTag`` names (a round not open yet
included); a round's update covers its due fragment only, with a
momentum file and a broadcast residual per fragment; and the fan-out runs
in the background, chained per fragment so that a worker never gets a
fragment's rounds out of order.

What raises ``NotImplementedError`` at dispatch, with its ROADMAP.md
label: a ``checkpoint_dir`` (checkpoint resume); elastic quorums
(``quorum_fraction > 0``), several parameter-server shards, the adaptive
options, the broadcast tree and the adoption grace (sharded
PS/FT/rejoin); ``report_metrics_s`` (telemetry); ``serve_peers`` (live
weight swap). A tree-reduce partial arriving at a round fails the job
under the same label as the tree.

The outer step (counterpart of ``ParameterServerExecutor._outer_step``,
``hypha_tpu/worker/ps_executor.py:2382-2440``, with
``hypha_tpu/native.py:157-169`` ``nesterov_update``): the sample-weighted
mean pseudo-gradient ḡ of the workers' deltas, then Nesterov momentum on
it, tensor by tensor on the device:

    m ← μ·m + ḡ;   update ← lr·(μ·m + ḡ)

The update goes to ``update-{round}.safetensors`` and the new momentum
replaces the momentum file atomically (written beside it, then renamed),
as the reference does, so a crash mid-write leaves the old momentum.

The arithmetic is the reference's numpy path (``native.nesterov_update``
without its C++ library): every product and every sum rounds to f32 on
its own, with no fused multiply-add, so it matches that path bit for bit
on the CPU and on the card. The C++ path is built with ``-O3
-march=native``, which lets the compiler fuse ``μ·m + g``; against it the
results agree to f32 rounding.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import math
import os
import shutil
import uuid
from pathlib import Path

import numpy as np
import torch

from .. import aio, compress
from ..executor.serialization import load_file, save_file
from ..hw import default_device
from ..messages import (
    PROTOCOL_PROGRESS,
    FragmentTag,
    JobSpec,
    Progress,
    ProgressKind,
    ProgressResponse,
    ProgressResponseKind,
    TransferStrategy,
)
from ..network.node import RequestError
from ..stream import RoundAccum, effective_fragments, fragment_due
from .connectors import push_timeout
from .job_manager import Execution, JobExecutor

__all__ = ["ParameterServerExecutor", "outer_step"]

log = logging.getLogger("hypha.torch.worker.ps")

# Broadcast fan-out width: enough concurrent streams to fill the uplink
# without opening one per peer on a wide job.
_BROADCAST_CONCURRENCY = 8

# The push-header key of a tree-reduce partial (the reference's
# messages.PREFOLD_KEY).
_PREFOLD_KEY = "prefold"

_FT = "sharded PS/FT/rejoin"


def _copy(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` in f32 on ``device``: a momentum tensor on its way to the
    device, or a result on its way back to the host."""
    return t.to(device, torch.float32)


def _sq_sum(t: torch.Tensor) -> float:
    """Σ t², accumulated in f64 as the reference's norms are."""
    return float(torch.sum(torch.square(t.double())))


def outer_step(
    received: dict,
    momentum_file: Path,
    lr: float,
    mu: float,
    work_dir: Path,
    round_num: int,
    accum: "RoundAccum | None" = None,
    stats: "dict | None" = None,
    device=None,
) -> Path:
    """Nesterov over the round's sample-weighted mean pseudo-gradient.

    ``received`` maps each worker to ``(delta path, samples)``. An
    ``accum`` that already folded every delta as it arrived is used as it
    is; without one (or with an empty one) the received files are folded
    now, on ``device`` (CUDA unless the caller asks for the CPU).
    ``stats``, when given, is filled with the L2 norms of ḡ and of the
    update and the accepted-delta count. Returns the update file's path.
    """
    if accum is None or accum.folds == 0:
        accum = RoundAccum(device=device) if accum is None else accum
        for path, samples in received.values():
            accum.fold(path, samples)
    work_dir, momentum_file = Path(work_dir), Path(momentum_file)
    out = work_dir / f"update-{round_num}.safetensors"
    momentum_tmp = work_dir / "momentum.next.safetensors"
    # Host copies: the device holds only the sum and one tensor's step.
    momentum: dict = dict(load_file(momentum_file)) if momentum_file.is_file() else {}
    update: dict = {}
    g_sq = u_sq = 0.0
    for key, g in accum.mean_items():
        m = momentum.get(key)
        if m is None:
            m = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        elif m.numel() != g.numel():
            # A short tensor from a faulty worker must fail here.
            raise ValueError(f"delta {key!r}: size {g.numel()} != momentum {m.numel()}")
        else:
            m = _copy(m, g.device).reshape(g.shape)
        new_m = torch.mul(m, mu).add_(g)
        upd = torch.mul(new_m, mu).add_(g).mul_(lr)
        if stats is not None:
            g_sq += _sq_sum(g)
            u_sq += _sq_sum(upd)
        momentum[key] = _copy(new_m, "cpu")
        update[key] = _copy(upd, "cpu")
        del g, m, new_m, upd
    if stats is not None:
        stats["delta_norm"] = math.sqrt(g_sq)
        stats["update_norm"] = math.sqrt(u_sq)
        stats["accepted"] = float(len(received))
    save_file(update, out)
    save_file(momentum, momentum_tmp)
    os.replace(momentum_tmp, momentum_file)
    return out


def _unported(cfg) -> None:
    """Raise on every aggregate option this path does not run."""
    checks = [
        (bool(cfg.checkpoint_dir), "checkpoint_dir", "checkpoint resume"),
        (cfg.quorum_fraction > 0, "quorum_fraction", _FT),
        (int(cfg.num_ps_shards or 1) > 1, "num_ps_shards", _FT),
        (bool(cfg.adaptive_steps), "adaptive_steps", _FT),
        (bool(cfg.adaptive_codec), "adaptive_codec", _FT),
        (cfg.broadcast_tree is not None, "broadcast_tree", _FT),
        (bool(cfg.adopt_grace_s), "adopt_grace_s", _FT),
        (bool(cfg.report_metrics_s), "report_metrics_s", "telemetry"),
        (bool(cfg.serve_peers), "serve_peers", "live weight swap"),
    ]
    for bad, option, item in checks:
        if bad:
            raise NotImplementedError(
                f"{option}={getattr(cfg, option)!r} is not ported to the PyTorch parameter "
                f"server (ROADMAP.md, Queue 1: {item})"
            )


def _unlink(paths: list) -> None:
    """Remove parameter-sized files, off the event loop: unlinking a file
    whose pages are still being written back waits for that writeback, and
    a stalled loop misses its lease renewals."""
    for path in paths:
        path.unlink(missing_ok=True)


class ParameterServerExecutor(JobExecutor):
    """The single-shard parameter server on ``device`` (CUDA
    unless the caller asks for the CPU; without CUDA and without that
    request the constructor raises)."""

    def __init__(self, node, work_root: "Path | str", device=None) -> None:
        self.node = node
        self.work_root = Path(work_root)
        self.device = default_device(device)

    async def execute(self, job_id: str, spec: JobSpec, scheduler_peer: str) -> Execution:
        cfg = spec.executor.aggregate
        if cfg is None:
            raise ValueError(f"job {job_id} is not an aggregate job")
        _unported(cfg)
        work_dir = self.work_root / f"hypha-ps-{uuid.uuid4().hex[:12]}"
        work_dir.mkdir(parents=True)
        execution = Execution(job_id)
        task = asyncio.create_task(self._run(execution, job_id, cfg, scheduler_peer, work_dir))

        async def cancel() -> None:
            await aio.reap(task)
            execution.finish("cancelled")

        execution.cancel = cancel  # type: ignore[method-assign]
        return execution

    async def _run(self, execution, job_id, cfg, scheduler_peer, work_dir: Path) -> None:
        allowed = set(cfg.updates.ref.peers or [])
        num_workers = cfg.num_workers or len(allowed)
        if num_workers <= 0:
            execution.finish("failed", "aggregate config names no workers")
            await asyncio.to_thread(shutil.rmtree, work_dir, ignore_errors=True)
            return
        lr, mu = cfg.optimizer.lr, cfg.optimizer.momentum
        # Momentum lives as a SafeTensors file between rounds, as in the
        # reference: the device holds only the round's sum.
        momentum_file = work_dir / "momentum.safetensors"
        tag = cfg.updates.ref.resource

        def wants(push) -> bool:
            # Routed consumer: only this job's pseudo-gradients reach this
            # loop, so a colocated train job's bridge, or another parameter
            # server's job, never eats our deltas.
            r = push.resource
            return isinstance(r, dict) and (tag is None or r.get("resource") == tag)

        consumer = self.node.consume_pushes(wants)
        # The broadcast's wire codec mirrors the upload's; a quantized one
        # feeds its error back into the next update.
        codec = compress.effective_codec(cfg.delta_codec or "none")
        sync_mode = cfg.sync_mode or "blocking"
        round_num = 0
        try:
            if sync_mode != "blocking":
                await self._stream_rounds(
                    execution, job_id, cfg, scheduler_peer, work_dir, consumer, allowed,
                    num_workers, lr, mu, codec, effective_fragments(sync_mode, cfg.fragments))
                return
            bcast_ef = compress.ErrorFeedback() if codec in compress.QUANT_CODECS else None
            while True:
                execution.round = round_num  # the live round, for AdoptAck
                accum = RoundAccum(device=self.device)
                received = await self._collect_round(
                    consumer, job_id, allowed, num_workers, work_dir, round_num, accum)
                update_path = await asyncio.to_thread(
                    outer_step, received, momentum_file, lr, mu, work_dir, round_num,
                    accum=accum, device=self.device)
                del accum
                wire_path = await asyncio.to_thread(
                    self._encode_broadcast, update_path, codec, bcast_ef, work_dir, round_num)
                # Notify BEFORE broadcasting: a worker can merge the update
                # and send UPDATE_RECEIVED the moment the broadcast lands,
                # and the scheduler must have advanced the round by then, or
                # it answers Continue instead of Done and the worker starts
                # a phantom extra round.
                response = await self._notify_updated(
                    scheduler_peer, job_id, round_num, execution)
                await self._broadcast(cfg, wire_path, round_num)
                await asyncio.to_thread(
                    _unlink, [path for path, _ in received.values()] + [update_path, wire_path])
                round_num += 1
                if response.kind == ProgressResponseKind.DONE:
                    execution.finish("completed")
                    return
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.exception("parameter server job %s failed", job_id)
            execution.finish("failed", str(e))
        finally:
            consumer.close()
            await asyncio.to_thread(shutil.rmtree, work_dir, ignore_errors=True)

    @staticmethod
    async def _fold(accum: RoundAccum, entry: tuple, sign: float = 1.0) -> None:
        """Fold one saved delta into the round's sum, off the event loop."""
        await asyncio.to_thread(accum.fold, entry[0], entry[1], sign)

    async def _collect_round(
        self, consumer, job_id: str, allowed: set, num_workers: int, work_dir: Path,
        round_num: int, accum: RoundAccum,
    ) -> dict:
        """Gather one pseudo-gradient per worker: peer -> (path, samples),
        each folded into ``accum`` as it lands."""
        received: dict = {}
        while len(received) < num_workers:
            push = await consumer.next()
            peer = push.peer
            if allowed and peer not in allowed:
                log.warning("ps %s: push from disallowed peer %s", job_id, peer)
                await push.read_all()
                continue
            if isinstance(push.resource, dict) and push.resource.get(_PREFOLD_KEY):
                await push.read_all()
                raise NotImplementedError(
                    f"a tree-reduce partial from {peer} reached the parameter server; the "
                    f"tree reduce is not ported to PyTorch yet (ROADMAP.md, Queue 1: {_FT})"
                )
            if peer in received:
                # A re-send replaces the previous delta instead of
                # mis-counting the round. It lands on the same path, so the
                # old one is un-folded (from its bytes) before the save.
                log.warning("ps %s: duplicate delta from %s; replacing", job_id, peer)
                old = received.pop(peer)
                await self._fold(accum, old, sign=-1.0)
                await asyncio.to_thread(_unlink, [old[0]])
            entry = await self._save_delta(push, work_dir, round_num)
            received[peer] = entry
            await self._fold(accum, entry)
            log.info("ps %s: round %d delta %d/%d (from %s)",
                     job_id, round_num, len(received), num_workers, peer)
        return received

    @staticmethod
    async def _save_delta(push, work_dir: Path, round_num: int, suffix: str = "") -> tuple:
        """Save one pseudo-gradient push; returns (path, sample weight)."""
        name = hashlib.sha256(push.peer.encode()).hexdigest()[:24]
        dest = work_dir / f"delta-{round_num}-{name}{suffix}.safetensors"
        await push.save_to(dest)
        samples = 1.0
        if isinstance(push.resource, dict):
            try:
                samples = float(push.resource.get("num_samples", 1.0))
            except (TypeError, ValueError):
                samples = 1.0
            if not np.isfinite(samples) or samples <= 0:
                samples = 1.0
        return dest, samples

    def _encode_broadcast(self, update_path: Path, codec: str, ef, work_dir: Path,
                          round_num: int, tag: "dict | None" = None) -> Path:
        """Re-encode the f32 update for the wire per the job's codec, on the
        device (counterpart of the reference's ``_encode_broadcast``): "none"
        broadcasts the update file itself; bf16 casts it; int8/int4 write an
        HQD1 frame of Q(update + residual), stamped with ``tag``."""
        if codec == "none":
            return update_path
        wire = work_dir / f"update-{round_num}.wire.safetensors"
        # In name order: the reference re-reads its f32 update through the
        # safetensors library, which orders tensors by name within a dtype,
        # so the frames are byte-identical.
        update = {k: v.to(self.device) for k, v in sorted(load_file(update_path).items())}
        compress.write_delta(wire, update, codec, ef=ef, tag=tag)
        return wire

    @staticmethod
    def _frame_tag_matches(path: Path, tag: FragmentTag) -> bool:
        """An HQD1 frame's own tag agrees with its push header's (an
        untagged file passes: the header is then its only identity)."""
        baked = compress.frame_tag(path)
        if baked is None:
            return True
        try:
            return (int(baked.get("round", tag.round)) == tag.round
                    and int(baked.get("fragment_id", tag.fragment_id)) == tag.fragment_id)
        except (TypeError, ValueError):
            return False

    async def _stream_rounds(self, execution, job_id: str, cfg, scheduler_peer: str,
                             work_dir: Path, consumer, allowed: set, num_workers: int,
                             lr: float, mu: float, codec: str, fragments: int) -> None:
        """The pipelined round loop of ``sync_mode`` overlap and stream
        (counterpart of the reference's ``_stream_rounds``, single shard,
        not elastic, not durable). Round ``r`` closes fragment ``r mod F``
        when every worker's delta for it is in; its update is encoded with
        that fragment's broadcast residual, the scheduler hears ``UPDATED``,
        and the fan-out starts in the background while the next round
        collects. Fan-outs of one fragment are chained (round r+F waits
        for round r); at most F + 1 are out at once."""
        accums: dict = {}   # round -> RoundAccum, the open rounds only
        pending: dict = {}  # round -> {peer: entry} of rounds not open yet
        bcast_efs: dict = {}
        bcast_tasks: set = set()
        last_bcast: dict = {}  # fragment -> its newest fan-out
        round_num = 0
        try:
            while True:
                execution.round = round_num
                received = await self._collect_round_stream(
                    consumer, job_id, allowed, num_workers, work_dir, round_num, fragments,
                    accums, pending)
                frag = fragment_due(round_num, fragments)
                tag = FragmentTag(round=round_num, fragment_id=frag, fragments=fragments)
                accum = accums.pop(round_num, None)
                # One momentum file per fragment: the fragments' tensors are
                # disjoint, so each round reads and writes only its own.
                update_path = await asyncio.to_thread(
                    outer_step, received, work_dir / f"momentum-f{frag}.safetensors", lr, mu,
                    work_dir, round_num, accum=accum, device=self.device)
                del accum
                if frag not in bcast_efs:
                    bcast_efs[frag] = (compress.ErrorFeedback()
                                       if codec in compress.QUANT_CODECS else None)
                wire_path = await asyncio.to_thread(
                    self._encode_broadcast, update_path, codec, bcast_efs[frag], work_dir,
                    round_num, tag.header())
                # Notify before the fan-out (the blocking loop's race note).
                response = await self._notify_updated(
                    scheduler_peer, job_id, round_num, execution)
                last_bcast[frag] = aio.spawn(
                    self._broadcast_and_cleanup(cfg, update_path, wire_path, received, tag,
                                                after=last_bcast.get(frag)),
                    tasks=bcast_tasks, what=f"stream broadcast r{round_num}", logger=log)
                round_num += 1
                live = [t for t in bcast_tasks if not t.done()]
                if len(live) >= fragments + 1:
                    await asyncio.wait(live, return_when=asyncio.FIRST_COMPLETED)
                if response.kind == ProgressResponseKind.DONE:
                    # The last update must still reach the workers: their
                    # DONE comes with the UPDATE_RECEIVED it triggers.
                    await aio.wait_quiet(*bcast_tasks, timeout=60.0)
                    execution.finish("completed")
                    return
        finally:
            await aio.reap(*bcast_tasks)

    async def _collect_round_stream(self, consumer, job_id: str, allowed: set, num_workers: int,
                                    work_dir: Path, round_num: int, fragments: int,
                                    accums: dict, pending: dict) -> dict:
        """Gather round ``round_num``'s fragment deltas, peer -> (path,
        samples). Every delta folds, as it lands, into the accumulator of
        the round its header names: this one or a later one. A delta for a
        closed round, one whose tag names another fragment or count, and an
        HQD1 frame whose own tag contradicts its header are dropped; a
        re-send replaces (un-folds) the sender's earlier delta."""
        received = pending.pop(round_num, {})
        while len(received) < num_workers:
            push = await consumer.next()
            peer = push.peer
            meta = push.resource if isinstance(push.resource, dict) else {}
            if allowed and peer not in allowed:
                log.warning("ps %s: push from disallowed peer %s", job_id, peer)
                await push.read_all()
                continue
            if meta.get(_PREFOLD_KEY):
                await push.read_all()
                raise NotImplementedError(
                    f"a tree-reduce partial from {peer} reached the parameter server; the "
                    f"tree reduce is not ported to PyTorch yet (ROADMAP.md, Queue 1: {_FT})"
                )
            try:
                delta_round = int(meta.get("round", round_num))
            except (TypeError, ValueError):
                delta_round = round_num
            if delta_round < round_num:
                log.warning("ps %s: stale delta for round %d from %s dropped (now %d)",
                            job_id, delta_round, peer, round_num)
                await push.read_all()
                continue
            due = fragment_due(delta_round, fragments)
            tag = FragmentTag.from_header(meta)
            if tag is not None and (tag.fragments != fragments or tag.fragment_id != due):
                log.warning("ps %s: fragment tag mismatch from %s (round %d fragment %d/%d, "
                            "expected %d/%d); dropped", job_id, peer, delta_round,
                            tag.fragment_id, tag.fragments, due, fragments)
                await push.read_all()
                continue
            entry = await self._save_delta(push, work_dir, delta_round,
                                           suffix=f"-{uuid.uuid4().hex[:8]}")
            if tag is not None and not await asyncio.to_thread(
                    self._frame_tag_matches, entry[0], tag):
                # The push header and the frame disagree: trust neither.
                log.warning("ps %s: frame tag mismatch from %s (header %s); dropped",
                            job_id, peer, tag)
                await asyncio.to_thread(_unlink, [entry[0]])
                continue
            accum = accums.setdefault(delta_round, RoundAccum(device=self.device))
            bucket = received if delta_round == round_num else pending.setdefault(delta_round, {})
            old = bucket.pop(peer, None)
            if old is not None:
                log.warning("ps %s: duplicate delta from %s; replacing", job_id, peer)
                await self._fold(accum, old, sign=-1.0)
                await asyncio.to_thread(_unlink, [old[0]])
            bucket[peer] = entry
            await self._fold(accum, entry)
            log.info("ps %s: round %d fragment %d delta %d/%d (from %s%s)", job_id, round_num,
                     fragment_due(round_num, fragments), len(received), num_workers, peer,
                     "" if delta_round == round_num else f", parked r{delta_round}")
        return received

    async def _broadcast_and_cleanup(self, cfg, update_path: Path, wire_path: Path,
                                     received: dict, tag: FragmentTag,
                                     after: "asyncio.Task | None" = None) -> None:
        """One round's background fan-out, then its files go. ``after`` is
        the same fragment's previous fan-out: without the chain a slow link
        could deliver round r+F's update before round r's, and the worker
        would drop the older one as stale."""
        if after is not None:
            await aio.wait_quiet(after)
        try:
            await self._broadcast(cfg, wire_path, tag.round, extra_header=tag.header())
        finally:
            await asyncio.to_thread(
                _unlink, [path for path, _ in received.values()] + [update_path, wire_path])

    async def _broadcast(self, cfg, update_path: Path, round_num: int,
                         extra_header: "dict | None" = None) -> None:
        """Push the update's wire file to every results peer in parallel, at
        most ``_BROADCAST_CONCURRENCY`` streams at once. A peer's failure is
        tolerated (it catches up next round); ``TransferStrategy.ANY``
        stops at the first push that lands. ``extra_header`` (a stream
        round's ``FragmentTag``) joins the push header."""
        peers = cfg.results.ref.peers or []
        strategy = cfg.results.ref.strategy or TransferStrategy.ALL
        header = {"resource": cfg.results.ref.resource or "results",
                  "name": update_path.name, "round": round_num, **(extra_header or {})}
        if not peers:
            return
        sem = asyncio.Semaphore(_BROADCAST_CONCURRENCY)

        async def push_one(peer: str) -> bool:
            async with sem:
                try:
                    # One backed-off re-try rides out a worker's blip.
                    await aio.retry(
                        lambda: self.node.push(peer, header, update_path),
                        attempts=2, base_delay=0.25, attempt_timeout=push_timeout(update_path),
                        retry_on=(RequestError, OSError), what=f"broadcast to {peer}", logger=log,
                    )
                    return True
                except (RequestError, OSError, asyncio.TimeoutError) as e:
                    log.warning("ps: broadcast to %s failed (%s); retry next round", peer, e)
                    return False

        tasks = [asyncio.create_task(push_one(p), name=f"ps-bcast-{p}") for p in peers]
        try:
            if strategy == TransferStrategy.ANY:
                for fut in asyncio.as_completed(tasks):
                    if await fut:
                        break
            else:
                await asyncio.gather(*tasks)
        finally:
            # The losers of an ANY race, or the siblings of a push that
            # raised, are cancelled and awaited, never left streaming a file
            # the job teardown is about to remove.
            await aio.reap(*(t for t in tasks if not t.done()))

    async def _notify_updated(self, scheduler_peer: str, job_id: str, round_num: int,
                              execution=None) -> ProgressResponse:
        gen = getattr(execution, "scheduler_generation", None)
        progress = Progress(
            kind=ProgressKind.UPDATED, job_id=job_id, round=round_num, shard=0,
            # Stamped only once a scheduler restart happened (generation
            # >= 2), so an unrestarted job's UPDATED is the reference's bytes.
            scheduler_generation=gen if gen is not None and gen >= 2 else None,
        )
        resp = await self.node.request(scheduler_peer, PROTOCOL_PROGRESS, progress, timeout=30)
        if not isinstance(resp, ProgressResponse):
            raise RequestError(f"unexpected progress response {resp!r}")
        if execution is not None:
            new_gen = getattr(resp, "generation", None)
            if new_gen is not None:
                if gen is not None and new_gen < gen:
                    # A zombie predecessor answered: its decision must not
                    # drive the round machinery.
                    raise RequestError("stale scheduler generation on UPDATED reply")
                execution.scheduler_generation = new_gen
        return resp
