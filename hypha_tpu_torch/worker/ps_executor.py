"""The parameter server: the DiLoCo outer optimizer (counterpart of the
blocking, single-shard path of ``hypha_tpu/worker/ps_executor.py``).

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

What raises ``NotImplementedError`` at dispatch, with its ROADMAP.md
label: a ``checkpoint_dir`` (checkpoint resume); elastic quorums
(``quorum_fraction > 0``), ``sync_mode`` other than blocking, several
parameter-server shards, a ``delta_codec``, the adaptive options, the
broadcast tree and the adoption grace (codecs/streaming/sharded
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

from .. import aio
from ..executor.serialization import load_file, save_file
from ..hw import default_device
from ..messages import (
    PROTOCOL_PROGRESS,
    JobSpec,
    Progress,
    ProgressKind,
    ProgressResponse,
    ProgressResponseKind,
    TransferStrategy,
)
from ..network.node import RequestError
from ..stream.accum import RoundAccum
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

_FT = "codecs/streaming/sharded PS/FT/rejoin"


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
        ((cfg.sync_mode or "blocking") != "blocking", "sync_mode", _FT),
        (int(cfg.num_ps_shards or 1) > 1, "num_ps_shards", _FT),
        ((cfg.delta_codec or "none") != "none", "delta_codec", _FT),
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
    """The blocking, single-shard parameter server on ``device`` (CUDA
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
        round_num = 0
        try:
            while True:
                execution.round = round_num  # the live round, for AdoptAck
                accum = RoundAccum(device=self.device)
                received = await self._collect_round(
                    consumer, job_id, allowed, num_workers, work_dir, round_num, accum)
                update_path = await asyncio.to_thread(
                    outer_step, received, momentum_file, lr, mu, work_dir, round_num,
                    accum=accum, device=self.device)
                del accum
                # Notify BEFORE broadcasting: a worker can merge the update
                # and send UPDATE_RECEIVED the moment the broadcast lands,
                # and the scheduler must have advanced the round by then, or
                # it answers Continue instead of Done and the worker starts
                # a phantom extra round.
                response = await self._notify_updated(
                    scheduler_peer, job_id, round_num, execution)
                await self._broadcast(cfg, update_path, round_num)
                await asyncio.to_thread(
                    _unlink, [path for path, _ in received.values()] + [update_path])
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
    async def _save_delta(push, work_dir: Path, round_num: int) -> tuple:
        """Save one pseudo-gradient push; returns (path, sample weight)."""
        name = hashlib.sha256(push.peer.encode()).hexdigest()[:24]
        dest = work_dir / f"delta-{round_num}-{name}.safetensors"
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

    async def _broadcast(self, cfg, update_path: Path, round_num: int) -> None:
        """Push the f32 update to every results peer in parallel, at most
        ``_BROADCAST_CONCURRENCY`` streams at once. A peer's failure is
        tolerated (it catches up next round); ``TransferStrategy.ANY``
        stops at the first push that lands."""
        peers = cfg.results.ref.peers or []
        strategy = cfg.results.ref.strategy or TransferStrategy.ALL
        header = {"resource": cfg.results.ref.resource or "results",
                  "name": update_path.name, "round": round_num}
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
