"""The parameter server: the DiLoCo outer optimizer (counterpart of
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

The sharded parameter service (the reference's ``:325-341``, ``:523-540``,
``:1626-1710``, ``:893-907``): with ``num_ps_shards = N`` this executor is
shard ``shard_index`` of N and owns the placement parts ``p`` with
``shard_of(p, N) == shard_index``. Sharded jobs run the pipelined loop in
every sync mode: in stream mode the shard closes only the rounds whose due
fragment it owns (a push for another shard's round is dropped as
misrouted); in blocking mode it closes its own fixed part every round.
Every broadcast and every ``UPDATED`` carries the shard's index
(``SHARD_KEY``, ``Progress.shard``).

Tree-reduce partials (the reference's ``:980-1100``): a push stamped
``prefold`` is a group reducer's Σ samples·Δθ; it folds verbatim and counts
toward the round's close by the workers it ``covers``. The cover sets
reconcile the ANY failover's at-least-once overlaps: a direct delta already
inside an accepted partial is dropped; a partial arriving after its
members' direct deltas un-folds and retires them (sorted order); of two
overlapping partials from different senders the bigger cover wins, a tie
keeping the accepted one; a reducer's cumulative re-flush replaces its
previous partial through the duplicate path.

Fault tolerance in every sync mode and placement (the reference's
``:210-260``, ``:346-389``, ``:754-940``, ``:1057-1102``, ``:1171-2140``,
``:2331-2380``):

  * ``quorum_fraction > 0`` makes the rounds elastic
    (:class:`_ElasticState`): the scheduler's ``MembershipUpdate``
    messages arrive over ``/hypha-ft/0.0.1``; a round (a stream round's
    due part too) closes when every live active worker is covered, or
    after ``round_deadline_s`` at quorum; a delta of a closed round is
    dropped as stale, one of a later round is parked for it; a joined peer
    gets the catch-up Σ of every broadcast update (``ft/rejoin.py``; a
    shard's Σ covers its own parts and its header names the shard), and
    broadcasts go to the active set (frozen at the close in the pipelined
    loop) with the membership epoch in their header;
  * ``checkpoint_dir`` makes the server durable (``ft/durable.py``): every
    accepted delta and partial is journaled (saved under the checkpoint
    root with its sha-256, a partial with the workers it covers), every
    round's wire kept and committed, the outer state (momentum of every
    part, Σ, each part's broadcast residual) checkpointed every
    ``ps_checkpoint_every_rounds`` commits; a server restarted under the
    same job id replays the committed rounds after the snapshot (bit for
    bit, the cover un-folds included), re-sends each part's newest
    broadcast and an empty resync, stamped with its new generation and,
    sharded, its shard (workers re-send only this shard's parts), and
    resumes the interrupted rounds with their journaled folds,
    deduplicating the workers' re-sends. Each shard of a sharded job has
    its own root, journal and generation (``<checkpoint_dir>/ps<k>``); a
    stream shard's journal skips the rounds it does not own. A checkpoint
    root of another job id starts fresh, taking only the momentum copies
    the previous attempt left (``_checkpoint_momentum``).

Broadcasts (``_broadcast``, reference ``:2575-2700``) go to every results
peer, or the round's membership, plus the serving followers
(``serve_peers``), appended after those overrides: a follower is no round
member. With ``broadcast_tree`` (the job's placement) a fan-out of more
than one peer, unless ANY-strategy, pushes only to the tree's top targets
(``stream.tree.top_targets`` over the live set, the followers hung off the
relays by ``with_serve_leaves``), and the relays carry it down
(``stream.reduce.tree_broadcast``, a dead relay expanded to its children).

WAN-adaptive rounds (``ft/adaptive.py``, reference ``:440-470``): with
``adaptive_steps`` every collector records each peer's arrival lag (collect
start to its delta's acceptance; a tree-reduce partial credits its
members) and the ``UPDATED`` notify carries them as ``arrival_s`` (absent
otherwise, so a static job's wire keeps its bytes). With ``adaptive_codec``
(blocking, unsharded, not durable) a ``LinkTable`` times each delta drain
(an abandoned drain counts as a lower-bound sample), the elastic deadline
is stretched by the table's first-round grace while an expected peer is
unmeasured, and the round's update goes out per link
(``_broadcast_adaptive``): each peer's codec from its measured bandwidth,
a quantized link encoded with its own error-feedback residual on the
server's device, every wire stamped with the codec (``CODEC_KEY``), which
the trainer switches its next upload to.

Scheduler recovery (reference ``:301``, ``:2804-2862``): with the job's
adoption grace (``adopt_grace_s``) the execution outlives a dead scheduler
by it, and the ``UPDATED`` notify parks (``_notify_updated_resilient``): on
the second failed attempt in a row the round's broadcast goes out first, so
a quorate round closes and the workers merge without the scheduler, then
the notify retries until the grace ends. Once a round is committed the
execution reports the next round as its own (the ``AdoptAck`` round): a
restarted scheduler credits the committed round and never runs it again.
A notify still parked when the scheduler that adopted the execution
releases its lease (its job ended without the notify) ends with DONE.

With ``report_metrics_s`` the server reports into the scheduler's metrics
collector (``telemetry.metrics_plane``) and attaches the round's quality
numbers (the norms of ḡ and of the update, the accepted deltas) to each
``UPDATED`` under ``metrics["quality"]``.

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
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from .. import aio, compress
from ..executor.serialization import load_file, read_header, save_file
from ..ft.adaptive import LinkTable
from ..ft.durable import (GENERATION_KEY, RESYNC_KEY, DurablePS, FoldRecord,
                          stale_scheduler_response)
from ..ft.membership import PROTOCOL_FT, MembershipUpdate, RoundMembership, quorum_size
from ..ft.rejoin import CATCHUP_KEY, CatchupBuffer
from ..hw import default_device
from ..messages import (
    CODEC_KEY,
    COVERS_KEY,
    PREFOLD_KEY,
    PROTOCOL_PROGRESS,
    SHARD_KEY,
    TRACEPARENT_KEY,
    Ack,
    FragmentTag,
    JobSpec,
    Progress,
    ProgressKind,
    ProgressResponse,
    ProgressResponseKind,
    TransferStrategy,
)
from ..network.node import RequestError
from ..stream import RoundAccum, fragment_due, top_targets, with_serve_leaves
from ..stream.reduce import tree_broadcast
from ..stream.sync import next_owned_round, placement_parts, shard_owns_round
from ..telemetry import trace
from ..telemetry.flight import FLIGHT
from ..telemetry.ft_metrics import FT_METRICS, HET_METRICS, SHARD_METRICS, STREAM_METRICS
from .connectors import push_timeout
from .job_manager import Execution, JobExecutor

__all__ = ["ParameterServerExecutor", "outer_step"]

log = logging.getLogger("hypha.torch.worker.ps")

# Elastic collect poll tick: the longest a membership change or a pending
# rejoin waits before the collect loop notices it.
_ELASTIC_TICK_S = 0.5

# Broadcast fan-out width: enough concurrent streams to fill the uplink
# without opening one per peer on a wide job.
_BROADCAST_CONCURRENCY = 8

# Elastic drain slack: a delta still streaming when the round deadline
# passes gets this much more wall-clock before the collector abandons it
# (pushes are queued at their header, so the deadline must bound the bytes).
_DRAIN_SLACK_S = 0.25

# A tree-reduce partial's key in a round's table: apart from the same
# reducer's own direct delta.
_PREFOLD_PREFIX = "prefold:"


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
    base: "Path | None" = None,
) -> Path:
    """Nesterov over the round's sample-weighted mean pseudo-gradient.

    ``received`` maps each worker to ``(delta path, samples)``. An
    ``accum`` that already folded every delta as it arrived is used as it
    is; without one (or with an empty one) the received files are folded
    now, on ``device`` (CUDA unless the caller asks for the CPU).
    ``stats``, when given, is filled with the L2 norms of ḡ and of the
    update and the accepted-delta count. ``base`` is a momentum file over
    more tensors than this round's (a recovered or warm-started server's
    whole momentum): while ``momentum_file`` does not exist, the round's
    tensors start from it. Returns the update file's path.
    """
    if accum is None or accum.folds == 0:
        accum = RoundAccum(device=device) if accum is None else accum
        for path, samples in received.values():
            accum.fold(path, samples)
    work_dir, momentum_file = Path(work_dir), Path(momentum_file)
    out = work_dir / f"update-{round_num}.safetensors"
    momentum_tmp = work_dir / "momentum.next.safetensors"
    # Host copies: the device holds only the sum and one tensor's step.
    momentum: dict = {}
    if momentum_file.is_file():
        momentum = dict(load_file(momentum_file))
    elif base is not None and Path(base).is_file():
        have = read_header(base)[0]
        momentum = dict(load_file(base, [k for k in accum.keys() if k in have]))
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


class _JobEnded(Exception):
    """The scheduler that adopted a parked notify's execution released its
    lease: its job ended (``_notify_updated_resilient``)."""


def _fire_once(fn):
    """Wrap an async thunk so that only its first call runs it: a round's
    broadcast goes out once, from the parked notify's outage path or after
    the notify, never both and never neither."""
    done = [False]

    async def run() -> None:
        if not done[0]:
            done[0] = True
            await fn()

    return run


def _file_sha(path: Path) -> str:
    """sha-256 of a saved wire file (blocking): the identity the journal
    deduplicates re-sends on."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


class _ElasticState:
    """The server's last adopted membership snapshot plus the rejoin
    catch-up machinery (the reference's ``:210-257``)."""

    def __init__(self, cfg, scheduler_peer: str) -> None:
        self.quorum_fraction = cfg.quorum_fraction
        self.round_deadline_s = cfg.round_deadline_s
        self.scheduler_peer = scheduler_peer
        # Epoch 0 until the scheduler's first MembershipUpdate.
        self.membership = RoundMembership(epoch=0, active=sorted(cfg.updates.ref.peers or []))
        self.catchup = CatchupBuffer()
        self.pending_joins: dict = {}  # peer -> catch-up attempts left
        self.early: dict = {}  # round -> {key: (path, samples)} parked for it
        self.early_covers: dict = {}  # round -> {key: (prefolded, covered workers)}
        self.dur: "DurablePS | None" = None
        # Stamped into catch-up headers: a sharded job's rejoiner waits for
        # one catch-up per shard.
        self.shard = 0
        self.num_shards = 1

    def quorum(self) -> int:
        return quorum_size(self.quorum_fraction, len(self.membership.active))

    def adopt(self, update: MembershipUpdate) -> None:
        """Epoch-gated (an older snapshot can land after a newer one);
        ``joined`` merges regardless: a catch-up owed is owed."""
        if update.membership.epoch >= self.membership.epoch:
            self.membership = update.membership
        for peer in update.joined:
            self.pending_joins.setdefault(peer, 3)


def _unlink(paths: list) -> None:
    """Remove parameter-sized files, off the event loop: unlinking a file
    whose pages are still being written back waits for that writeback, and
    a stalled loop misses its lease renewals."""
    for path in paths:
        path.unlink(missing_ok=True)


class _PsTrace:
    """The server's round-trace contexts (the reference's ``_PsTrace``); a
    no-op when tracing is off.

    The scheduler hands the next round's root context back on every
    UPDATED answer, so quorum_wait / outer_step / broadcast spans parent
    under the round's root from round 1 on; round 0's comes with its first
    delta's header. Per-delta upload and fold spans parent on the context
    in their own push header. A blocking round ends in ``cleanup`` spans
    (the round's files unlinked, the encodes' card memory returned): the
    port's own, since the reference leaves that stretch untraced and a
    merged timeline then shows a gap between the server's rounds."""

    def __init__(self, node: str) -> None:
        self.node = node
        # Bounded per-round contexts: round r's broadcast still needs its
        # context after the UPDATED answer handed over round r+1's, and
        # the pipelined loop keeps several rounds open.
        self._by_round: dict = {}

    def ctx(self, round_num: int) -> "str | None":
        return self._by_round.get(round_num)

    def adopt(self, response, round_num: int) -> None:
        tp = getattr(response, "traceparent", None)
        # A context already filed under an earlier round is skipped: a
        # sharded job's scheduler advances only once every due shard
        # reported, so a non-final shard's answer carries the current
        # round's root, which must not parent the next round's spans.
        if tp and tp not in self._by_round.values():
            self._by_round[round_num] = tp
            while len(self._by_round) > 16:
                self._by_round.pop(min(self._by_round))

    @staticmethod
    def push_ctx(push) -> "str | None":
        """The context a delta push's header carries (None untraced)."""
        r = push.resource
        return r.get(TRACEPARENT_KEY) if isinstance(r, dict) else None

    def adopt_push(self, push, round_num: int) -> None:
        """A round's first delta carries its context too: the server's
        only source for round 0 (no UPDATED answer exists yet)."""
        tp = self.push_ctx(push)
        if tp and round_num not in self._by_round:
            self._by_round[round_num] = tp


class ParameterServerExecutor(JobExecutor):
    """The parameter server, or one shard of it, on ``device`` (CUDA
    unless the caller asks for the CPU; without CUDA and without that
    request the constructor raises)."""

    def __init__(self, node, work_root: "Path | str", device=None) -> None:
        self.node = node
        self.work_root = Path(work_root)
        self.device = default_device(device)

    def _trace_node(self) -> str:
        """The label of this server's spans and events (tests build
        executors without a node)."""
        return getattr(self.node, "peer_id", None) or "ps"

    async def execute(self, job_id: str, spec: JobSpec, scheduler_peer: str) -> Execution:
        cfg = spec.executor.aggregate
        if cfg is None:
            raise ValueError(f"job {job_id} is not an aggregate job")
        work_dir = self.work_root / f"hypha-ps-{uuid.uuid4().hex[:12]}"
        work_dir.mkdir(parents=True)
        execution = Execution(job_id)
        # A scheduler-recoverable job outlives a dead scheduler by the grace
        # (the arbiter defers the lease, the notify parks).
        execution.adopt_grace_s = float(cfg.adopt_grace_s or 0) or None
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
        elastic = _ElasticState(cfg, scheduler_peer) if cfg.quorum_fraction > 0 else None
        lr, mu = cfg.optimizer.lr, cfg.optimizer.momentum
        sync_mode = cfg.sync_mode or "blocking"
        # One shard of N owns a disjoint set of the placement parts (stream
        # fragments, or N blocking sub-deltas); N == 1 is the whole tree.
        num_shards = max(int(cfg.num_ps_shards or 1), 1)
        shard = int(cfg.shard_index or 0)
        parts = placement_parts(sync_mode, cfg.fragments, num_shards)
        pipelined = sync_mode != "blocking" or num_shards > 1
        # A stream shard closes only the rounds whose due fragment it owns:
        # its journal skips the others.
        owned = None
        if num_shards > 1 and sync_mode == "stream":
            def owned(r: int) -> bool:
                return shard_owns_round(sync_mode, r, parts, num_shards, shard)
        # Momentum lives as SafeTensors files between rounds, as in the
        # reference: the device holds only the round's sum. The pipelined
        # loop keeps one file per part beside this one (a recovered or
        # warm-started server's whole momentum).
        momentum_file = work_dir / "momentum.safetensors"
        ckpt_dir = Path(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        membership_reg = None
        if elastic is not None:
            # Registered before anything awaits: the scheduler sends a
            # restarted server its membership right after the dispatch.
            async def on_membership(peer: str, msg: MembershipUpdate) -> Ack:
                if peer != scheduler_peer:
                    return Ack(ok=False, message="membership updates come from the scheduler")
                log.info("ps %s: membership epoch %d (active=%d suspected=%d joined=%s)", job_id,
                         msg.membership.epoch, len(msg.membership.active),
                         len(msg.membership.suspected), msg.joined)
                elastic.adopt(msg)
                if msg.membership.inner_steps:
                    # The adaptive assignment published with the membership:
                    # the per-peer inner-step gauges on the server's side.
                    for p, steps in msg.membership.inner_steps.items():
                        try:
                            HET_METRICS.note_assigned(str(p), int(steps))
                        except (TypeError, ValueError):
                            continue
                    log.info("ps %s: inner steps %s (epoch %d)", job_id,
                             dict(sorted(msg.membership.inner_steps.items())),
                             msg.membership.epoch)
                return Ack(ok=True)

            membership_reg = (self.node.on(PROTOCOL_FT, MembershipUpdate)
                              .match(lambda m: m.job_id == job_id)
                              .respond_with(on_membership))
        # The live metrics plane: registry deltas to the scheduler's
        # collector, and the round's quality (the pseudo-gradient and update
        # norms outer_step computes) on each UPDATED. None (the default):
        # no reporter and no new wire.
        reporter = None
        if cfg.report_metrics_s and self.node is not None:
            from ..telemetry.metrics_plane import MetricsReporter

            def _gen() -> "int | None":
                g = getattr(execution, "scheduler_generation", None)
                return int(g) if g is not None else None

            reporter = MetricsReporter(
                self.node, cfg.metrics_peer or scheduler_peer, job_id,
                interval_s=float(cfg.report_metrics_s), round_fn=lambda: execution.round,
                generation_fn=_gen).start()
        dur: "DurablePS | None" = None
        try:
            if ckpt_dir is not None:
                every = max(int(cfg.ps_checkpoint_every_rounds or 1), 1)
                dur = await asyncio.to_thread(DurablePS.open, ckpt_dir, job_id, every,
                                              owned=owned)
                log.info("ps %s: durable state at %s, generation %d", job_id, ckpt_dir,
                         dur.generation)
                if dur.resume is None:
                    # A full job restart runs under a new job id: momentum
                    # is the only outer state that carries over.
                    for saved in sorted(ckpt_dir.glob("momentum*.safetensors")):
                        await asyncio.to_thread(shutil.copyfile, saved, work_dir / saved.name)
                        log.info("ps %s: momentum restored from %s", job_id, saved)
        except Exception as e:
            # A corrupt durable root or a full disk fails the job visibly.
            log.exception("parameter server job %s failed opening durable state", job_id)
            execution.finish("failed", str(e))
            if membership_reg is not None:
                membership_reg.close()
            if dur is not None:
                await asyncio.to_thread(dur.close)
            await asyncio.to_thread(shutil.rmtree, work_dir, ignore_errors=True)
            return
        tag = cfg.updates.ref.resource

        def wants(push) -> bool:
            # Routed consumer: only this job's pseudo-gradients reach this
            # loop, so a colocated train job's bridge, or another parameter
            # server's job, never eats our deltas.
            r = push.resource
            return isinstance(r, dict) and (tag is None or r.get("resource") == tag)

        consumer = self.node.consume_pushes(wants)
        if elastic is not None:
            elastic.dur = dur
            elastic.shard, elastic.num_shards = shard, num_shards
        # The broadcast's wire codec mirrors the upload's; a quantized one
        # feeds its error back into the next update.
        codec = compress.effective_codec(cfg.delta_codec or "none")
        # WAN-adaptive rounds: per-peer arrival lags reported with UPDATED,
        # and per-link codecs with per-peer residuals (blocking, unsharded,
        # not durable; the job validates the combinations).
        adaptive_steps = bool(cfg.adaptive_steps)
        link: "LinkTable | None" = None
        peer_efs: dict = {}
        if cfg.adaptive_codec and dur is None and num_shards == 1:
            # `is not None`, not `or`: an explicit 0.0 is a threshold.
            link = LinkTable(
                base_codec=codec,
                hi_mbps=float(cfg.codec_bw_hi_mbps) if cfg.codec_bw_hi_mbps is not None else 100.0,
                lo_mbps=float(cfg.codec_bw_lo_mbps) if cfg.codec_bw_lo_mbps is not None else 10.0)
        try:
            bcast_ef = compress.ErrorFeedback() if codec in compress.QUANT_CODECS else None
            round_num = 0
            preload: dict = {}
            recovered: dict = {}
            rec_efs: dict = {}
            if dur is not None and dur.resume is not None:
                round_num, rec_efs, preload, recovered, done = await self._recover(
                    dur, job_id, cfg, scheduler_peer, work_dir, momentum_file, elastic, lr, mu,
                    codec, execution, stream=pipelined, fragments=parts, shard=shard,
                    num_shards=num_shards)
                if bcast_ef is not None and 0 in rec_efs:
                    bcast_ef = rec_efs[0]
                if done:
                    execution.finish("completed")
                    return
            if pipelined:
                await self._stream_rounds(
                    execution, job_id, cfg, scheduler_peer, work_dir, consumer, allowed,
                    num_workers, lr, mu, codec, parts, shard=shard, num_shards=num_shards,
                    sync_mode=sync_mode, elastic=elastic, dur=dur, momentum_file=momentum_file,
                    ckpt_dir=ckpt_dir, round_start=round_num, init_accums=recovered,
                    init_pending=preload, init_efs=rec_efs, adaptive_steps=adaptive_steps)
                return
            park_s = float(cfg.adopt_grace_s or 0)
            ptrace = _PsTrace(self._trace_node())
            while True:
                execution.round = round_num  # the live round, for AdoptAck
                if elastic is not None:
                    execution.epoch = elastic.membership.epoch
                # A recovered round resumes its replayed accumulator.
                accum = recovered.pop(round_num, None)
                preloaded_folded = accum is not None
                if accum is None:
                    accum = RoundAccum(device=self.device)
                if dur is not None:
                    await asyncio.to_thread(dur.note_open, round_num)
                # peer -> collect start to its delta's acceptance (only an
                # adaptive_steps job fills it).
                arrivals: "dict | None" = {} if adaptive_steps else None
                qw_span = trace.begin("quorum_wait", parent=ptrace.ctx(round_num),
                                      attrs={"round": round_num}, node=ptrace.node)
                if elastic is not None:
                    received = await self._collect_round_elastic(
                        consumer, job_id, elastic, cfg, work_dir, round_num, accum, dur,
                        link=link, arrivals=arrivals, ptrace=ptrace)
                else:
                    received = await self._collect_round(
                        consumer, job_id, allowed, num_workers, work_dir, round_num, accum,
                        dur=dur, preloaded=preload.pop(round_num, None),
                        preloaded_folded=preloaded_folded, link=link, arrivals=arrivals,
                        ptrace=ptrace)
                # Round 0's root context arrives only in the first delta's
                # header: the wait span joins it late.
                trace.reparent(qw_span, ptrace.ctx(round_num))
                trace.finish(qw_span)
                if dur is not None:
                    await asyncio.to_thread(dur.note_close, round_num, list(received))
                outer_span = trace.begin("outer_step", parent=ptrace.ctx(round_num),
                                         attrs={"round": round_num}, node=ptrace.node)
                quality = {} if cfg.report_metrics_s else None
                update_path = await asyncio.to_thread(
                    outer_step, received, momentum_file, lr, mu, work_dir, round_num,
                    accum=accum, stats=quality, device=self.device)
                trace.finish(outer_span)
                del accum
                if link is not None:
                    # Per-link broadcast (the static close below, less the
                    # durable commit it cannot have). Σ takes the raw f32
                    # update: each link tracks it within its own residual.
                    if elastic is not None:
                        await asyncio.to_thread(elastic.catchup.accumulate, update_path)
                    bcast_adaptive = _fire_once(
                        lambda _u=update_path, _r=round_num: self._broadcast_adaptive(
                            cfg, _u, _r, elastic, link, peer_efs, work_dir,
                            traceparent=ptrace.ctx(_r)))
                    response = await self._notify_updated_resilient(
                        scheduler_peer, job_id, round_num, execution=execution,
                        arrivals=arrivals, park_s=park_s, on_first_failure=bcast_adaptive,
                        traceparent=ptrace.ctx(round_num), quality=quality)
                    ptrace.adopt(response, round_num + 1)
                    await bcast_adaptive()
                    with trace.span("cleanup", parent=ptrace.ctx(round_num),
                                    attrs={"round": round_num}, node=ptrace.node):
                        await asyncio.to_thread(
                            _unlink, [update_path] + [path for path, _ in received.values()])
                    round_num += 1
                    if elastic is not None:
                        await self._serve_joins(elastic, cfg, round_num, work_dir)
                    if response.kind == ProgressResponseKind.DONE:
                        execution.finish("completed")
                        return
                    continue
                wire_path, sent = await asyncio.to_thread(
                    self._encode_broadcast, update_path, codec, bcast_ef, work_dir, round_num)
                if elastic is not None:
                    # Σ of the updates as the workers decode them, folded
                    # before the durable commit (the checkpoint holds it).
                    if sent is None:
                        await asyncio.to_thread(elastic.catchup.accumulate, wire_path)
                    else:
                        await asyncio.to_thread(elastic.catchup.accumulate_tree, sent)
                del sent
                if dur is not None:
                    wire_name = await asyncio.to_thread(dur.store_wire, round_num, wire_path)
                    await asyncio.to_thread(
                        dur.commit_round, round_num, 0, wire_name,
                        epoch=elastic.membership.epoch if elastic is not None else 0,
                        momentum_file=momentum_file,
                        catchup=elastic.catchup if elastic is not None else None,
                        efs={0: bcast_ef},
                        active=list(elastic.membership.active) if elastic is not None else [])
                    # Committed: the next round this server closes is the
                    # one it reports to a restarted scheduler's hello.
                    execution.round = round_num + 1
                if ckpt_dir is not None:
                    await asyncio.to_thread(self._checkpoint_momentum, momentum_file, ckpt_dir)
                # Notify BEFORE broadcasting: a worker can merge the update
                # and send UPDATE_RECEIVED the moment the broadcast lands,
                # and the scheduler must have advanced the round by then, or
                # it answers Continue instead of Done and the worker starts
                # a phantom extra round. Across a scheduler outage (the
                # notify failed twice) the broadcast goes first: the
                # workers' UPDATE_RECEIVED parks too, so the race cannot
                # bite while the scheduler is down.
                bcast_static = _fire_once(
                    lambda _w=wire_path, _r=round_num: self._broadcast(
                        cfg, _w, _r, elastic,
                        extra_header={GENERATION_KEY: dur.generation} if dur is not None
                        else None, traceparent=ptrace.ctx(_r), span_round=_r))
                response = await self._notify_updated_resilient(
                    scheduler_peer, job_id, round_num, execution=execution, arrivals=arrivals,
                    park_s=park_s, on_first_failure=bcast_static,
                    traceparent=ptrace.ctx(round_num), quality=quality)
                ptrace.adopt(response, round_num + 1)
                if dur is not None:
                    await asyncio.to_thread(
                        dur.note_notified, round_num,
                        response.kind == ProgressResponseKind.DONE)
                await bcast_static()
                # Durable runs keep the delta files: the journal names them
                # until a checkpoint covers their round.
                done_files = [update_path] + ([wire_path] if wire_path != update_path else [])
                if dur is None:
                    done_files += [path for path, _ in received.values()]
                with trace.span("cleanup", parent=ptrace.ctx(round_num),
                                attrs={"round": round_num}, node=ptrace.node):
                    await asyncio.to_thread(_unlink, done_files)
                round_num += 1
                if elastic is not None:
                    await self._serve_joins(elastic, cfg, round_num, work_dir)
                if response.kind == ProgressResponseKind.DONE:
                    self._log_journal(job_id, dur)
                    execution.finish("completed")
                    return
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.exception("parameter server job %s failed", job_id)
            execution.finish("failed", str(e))
        finally:
            if reporter is not None:
                await reporter.stop()
            if membership_reg is not None:
                membership_reg.close()
            consumer.close()
            if dur is not None:
                await asyncio.to_thread(dur.close)
            await asyncio.to_thread(shutil.rmtree, work_dir, ignore_errors=True)

    @staticmethod
    def _log_journal(job_id: str, dur: "DurablePS | None") -> None:
        if dur is not None:
            log.info("ps %s: journal %d records, %d bytes; %d dedup hits", job_id,
                     dur.journal.records_written, dur.journal.bytes_written, dur.dedup_hits)

    # ------------------------------------------------------ crash recovery

    async def _recover(self, dur: DurablePS, job_id: str, cfg, scheduler_peer: str,
                       work_dir: Path, momentum_file: Path, elastic, lr: float, mu: float,
                       codec: str, execution, *, stream: bool = False, fragments: int = 1,
                       shard: int = 0, num_shards: int = 1) -> tuple:
        """Resume the job from its durable state after a restart (the
        reference's ``_recover``). Returns ``(round, {fragment: broadcast
        residual}, preload, accums, done)``: momentum, Σ, the residuals,
        round and epoch come from the checkpoint; each round committed
        after it re-runs its outer step from the journaled folds (partials
        and their covers included); the scheduler is re-notified of the
        last committed round if the journal lacks its answer; an empty
        resync and each fragment's newest committed broadcast go out
        stamped with the new generation (and the shard, so workers re-send
        only this shard's parts; the journal deduplicates the copies that
        landed); the interrupted rounds' folds come back for the collect
        loops. ``stream`` is the pipelined loop (any streaming or sharded
        job): its rounds carry fragment tags and momentum per part, and
        its interrupted accumulators are rebuilt even when elastic."""
        resume = dur.resume
        assert resume is not None
        t0 = time.perf_counter()
        await asyncio.to_thread(dur.restore_momentum, momentum_file)
        bcast_efs: dict = {}
        if codec in compress.QUANT_CODECS:
            for frag, residual in (await asyncio.to_thread(dur.restore_efs)).items():
                ef = compress.ErrorFeedback()
                ef.restore(residual)
                bcast_efs[frag] = ef
        if elastic is not None:
            await asyncio.to_thread(dur.restore_catchup, elastic.catchup)
            if resume.epoch >= elastic.membership.epoch and resume.active:
                # The checkpointed view holds until the scheduler's next
                # (epoch-gated) membership push supersedes it.
                elastic.membership = RoundMembership(epoch=resume.epoch,
                                                     active=sorted(resume.active))
        round_num = resume.next_round
        for rec in resume.committed:
            rnd = int(rec["round"])
            frag = int(rec.get("fragment", 0))
            accum = RoundAccum(device=self.device)
            for fold, sign in dur.replay_ops(rnd):
                await asyncio.to_thread(accum.fold, dur.deltas_dir / fold.file, fold.samples,
                                        sign, fold.prefold)
            part_momentum = self._part_momentum(work_dir, frag) if stream else momentum_file
            update_path = await asyncio.to_thread(
                outer_step, {}, part_momentum, lr, mu, work_dir, rnd, accum=accum,
                device=self.device, base=momentum_file if stream else None)
            del accum
            if codec in compress.QUANT_CODECS and frag not in bcast_efs:
                bcast_efs[frag] = compress.ErrorFeedback()
            tag = (FragmentTag(round=rnd, fragment_id=frag, fragments=fragments).header()
                   if stream else None)
            wire_path, sent = await asyncio.to_thread(
                self._encode_broadcast, update_path, codec, bcast_efs.get(frag), work_dir, rnd,
                tag)
            if rnd == dur.newest_commit(frag):
                await asyncio.to_thread(dur.store_wire, rnd, wire_path)
            if elastic is not None:
                frag_id = frag if stream else None
                if sent is None:
                    await asyncio.to_thread(elastic.catchup.accumulate, wire_path, frag_id)
                else:
                    await asyncio.to_thread(elastic.catchup.accumulate_tree, sent, frag_id)
            del sent
            await asyncio.to_thread(
                _unlink, [update_path] + ([wire_path] if wire_path != update_path else []))
            round_num = rnd + 1
        replay_s = time.perf_counter() - t0
        FT_METRICS.ps_recoveries.add(1)
        FLIGHT.record("ps.recovered", node=self._trace_node(), job=job_id,
                      generation=dur.generation, round=round_num, replayed=len(resume.committed))
        log.warning("ps %s: recovered durable state (generation %d): resuming round %d (%d "
                    "committed rounds replayed in %.3f s)", job_id, dur.generation, round_num,
                    len(resume.committed), replay_s)
        done = False
        last_round = round_num - 1
        if last_round >= 0:
            notified = resume.notified.get(last_round)
            if notified is None:
                # A server and a scheduler that died together recover in
                # either order: the re-notify parks across the scheduler's
                # restart (idempotent by round on its side).
                response = await self._notify_updated_resilient(
                    scheduler_peer, job_id, last_round, execution=execution, shard=shard,
                    park_s=float(cfg.adopt_grace_s or 0))
                done = response.kind == ProgressResponseKind.DONE
                await asyncio.to_thread(dur.note_notified, last_round, done)
            else:
                done = bool(notified)
        resync_extra: dict = {GENERATION_KEY: dur.generation, RESYNC_KEY: True}
        if num_shards > 1:
            # Workers track one generation per shard: the announcement says
            # which shard restarted.
            resync_extra[SHARD_KEY] = shard
        resync = work_dir / "resync.bin"
        await asyncio.to_thread(resync.write_bytes, b"")
        await self._broadcast(cfg, resync, round_num, elastic, extra_header=resync_extra)
        for rnd, frag, path in dur.last_wires():
            extra: dict = {GENERATION_KEY: dur.generation}
            if num_shards > 1:
                extra[SHARD_KEY] = shard
            if stream:
                extra.update(FragmentTag(round=rnd, fragment_id=frag,
                                         fragments=fragments).header())
            await self._broadcast(cfg, path, rnd, elastic, extra_header=extra)
        preload: dict = {}
        accums: dict = {}
        for rnd in dur.pending_rounds(round_num):
            bucket = preload.setdefault(rnd, {})
            for fold in dur.folds_for(rnd):
                bucket[fold.peer] = (dur.deltas_dir / fold.file, fold.samples)
            if elastic is None or stream:
                # The in-flight accumulator, rebuilt by the exact fold and
                # un-fold sequence: bit-equal to the crashed process's.
                accum = accums.setdefault(rnd, RoundAccum(device=self.device))
                for fold, sign in dur.replay_ops(rnd):
                    await asyncio.to_thread(accum.fold, dur.deltas_dir / fold.file,
                                            fold.samples, sign, fold.prefold)
        if elastic is not None and not stream:
            # The elastic collector folds parked entries when their round
            # opens (last-wins per key).
            for rnd, bucket in preload.items():
                elastic.early.setdefault(rnd, {}).update(bucket)
                log.info("ps %s: round %d resumes with journaled deltas from %s", job_id, rnd,
                         sorted(bucket))
            preload = {}
        return round_num, bcast_efs, preload, accums, done

    @staticmethod
    def _part_momentum(work_dir: Path, part: int) -> Path:
        """One part's momentum file: the parts' tensors are disjoint, so a
        pipelined round reads and writes only its own."""
        return work_dir / f"momentum-f{part}.safetensors"

    @staticmethod
    async def _ingest(dur: "DurablePS | None", round_num: int, fragment: int, key: str,
                      entry: tuple, sha: "str | None" = None, prefold: bool = False,
                      covers=()) -> bool:
        """Journal one accepted delta or partial under its table key; False
        = an exact re-send, already journaled: the file goes and nothing
        folds."""
        if dur is None:
            return True
        path, samples = entry
        if sha is None:
            sha = await asyncio.to_thread(_file_sha, path)
        if dur.already_folded(round_num, fragment, key, sha):
            await asyncio.to_thread(_unlink, [path])
            return False
        await asyncio.to_thread(dur.note_fold, FoldRecord(
            round=round_num, fragment=fragment, peer=key, samples=samples, sha=sha,
            file=path.name, prefold=prefold, covers=sorted(covers) if prefold else []))
        return True

    @staticmethod
    async def _classify_push(push, job_id: str, members, round_num: int) -> "int | None":
        """The round a delta claims, or None when it was dropped (a
        non-member sender, or a round already aggregated: stale)."""
        peer = push.peer
        if members is not None and peer not in members:
            log.warning("ps %s: push from non-member peer %s dropped", job_id, peer)
            await push.read_all()
            return None
        delta_round = round_num
        if isinstance(push.resource, dict) and "round" in push.resource:
            try:
                delta_round = int(push.resource["round"])
            except (TypeError, ValueError):
                delta_round = round_num
        if delta_round < round_num:
            log.warning("ps %s: stale delta for round %d from %s dropped (now %d)", job_id,
                        delta_round, peer, round_num)
            FT_METRICS.stale_deltas_dropped.add(1)
            await push.read_all()
            return None
        return delta_round

    @staticmethod
    async def _fold(accum: "RoundAccum | None", entry: tuple, sign: float = 1.0,
                    prefolded: bool = False, span_attrs: "dict | None" = None,
                    parent: "str | None" = None, trace_node: "str | None" = None) -> None:
        """Fold one saved delta (or a partial, verbatim) into the round's
        sum, off the event loop (None: a parked bucket, nothing folded).
        ``span_attrs`` wraps the work in a round-trace ``fold`` span (the
        accepting folds only; un-folds and replays stay spanless)."""
        if accum is None:
            return
        fold_span = (trace.begin("fold", parent=parent, attrs=span_attrs, node=trace_node)
                     if span_attrs is not None and sign > 0 else None)
        await asyncio.to_thread(accum.fold, entry[0], entry[1], sign, prefolded)
        trace.finish(fold_span)

    # ------------------------------------------------ tree-reduce covers

    @staticmethod
    def _push_cover(meta, peer: str) -> tuple:
        """``(prefolded, covered workers)`` of one push: a partial covers
        the workers its ``covers`` header lists, a direct delta its sender."""
        if isinstance(meta, dict) and meta.get(PREFOLD_KEY):
            return True, frozenset(str(p) for p in (meta.get(COVERS_KEY) or []))
        return False, frozenset((peer,))

    @staticmethod
    def _covered(received, covers: dict) -> set:
        """The worker peers the round's accepted entries represent."""
        out: set = set()
        for key in received:
            out |= covers.get(key, (False, frozenset((key,))))[1]
        return out

    @staticmethod
    def _entry_key(prefolded: bool, peer: str) -> str:
        """A reducer's partial must not collide with its own direct delta."""
        return f"{_PREFOLD_PREFIX}{peer}" if prefolded else peer

    @staticmethod
    def _prefold_superseded(covers: dict, cov: frozenset, key: str) -> bool:
        """Drop a new partial that intersects an accepted partial from
        another sender at least as big: overlaps cannot be decomposed, so
        the bigger cover wins and a tie keeps the accepted entry. A
        sender's own re-flush takes the duplicate path instead."""
        return any(p and (cov & c) and len(c) >= len(cov)
                   for k, (p, c) in covers.items() if k != key)

    @staticmethod
    def _direct_covered(covers: dict, peer: str) -> bool:
        """Is a direct delta from ``peer`` already inside an accepted
        partial (the ANY failover delivers at least once)?"""
        return any(p and peer in c for p, c in covers.values())

    async def _retire_covered(self, job_id: str, accum, bucket: dict, covers: dict,
                              cov: frozenset, durable: bool = False) -> None:
        """A partial supersedes what it contains: first every accepted
        partial of another sender that it intersects (each strictly
        smaller, or ``_prefold_superseded`` had dropped the new one), then
        its members' direct deltas, each un-folded and retired in sorted
        order (``DurablePS.replay_ops`` re-derives both loops from the
        partial's journaled covers). ``accum`` None: a parked bucket, not
        folded yet. A ``durable`` server keeps the retired files for that
        replay until a checkpoint covers their round."""
        for okey in sorted(k for k in list(bucket) if k in covers):
            info = covers.get(okey)
            if info is None or not info[0] or not (info[1] & cov):
                continue
            log.warning("ps %s: partial %s overlapped by a newer ancestor partial; un-folding",
                        job_id, okey)
            old = bucket.pop(okey)
            covers.pop(okey, None)
            await self._fold(accum, old, sign=-1.0, prefolded=True)
            if not durable:
                await asyncio.to_thread(_unlink, [old[0]])
        for member in sorted(cov):
            info = covers.get(member)
            if member not in bucket or (info is not None and info[0]):
                continue
            log.warning("ps %s: delta from %s superseded by a tree-reduce partial covering it; "
                        "un-folding", job_id, member)
            old = bucket.pop(member)
            covers.pop(member, None)
            await self._fold(accum, old, sign=-1.0, prefolded=False)
            if not durable:
                await asyncio.to_thread(_unlink, [old[0]])

    async def _collect_round(
        self, consumer, job_id: str, allowed: set, num_workers: int, work_dir: Path,
        round_num: int, accum: RoundAccum, dur: "DurablePS | None" = None,
        preloaded: "dict | None" = None, preloaded_folded: bool = False,
        link: "LinkTable | None" = None, arrivals: "dict | None" = None,
        ptrace: "_PsTrace | None" = None,
    ) -> dict:
        """Gather one pseudo-gradient per worker: key -> (path, samples),
        each folded into ``accum`` as it lands. ``preloaded`` seeds the
        round with a recovered server's journaled folds (already in
        ``accum`` when ``preloaded_folded``). A durable round journals each
        delta and partial (saved under the checkpoint root, uniquely
        named), drops an exact re-send, and drops a delta of a round
        already committed. ``link`` times each drain; ``arrivals`` takes
        each covered peer's lag from the collect's start. ``ptrace`` takes
        the round's context from the first traced push."""
        t_open = asyncio.get_running_loop().time()
        tnode = ptrace.node if ptrace is not None else None
        received: dict = dict(preloaded or {})
        # Entry key -> (prefolded, covered workers): a tree-reduce partial
        # covers its group, everything else its sender. Journaled entries
        # rebuild theirs from the fold records.
        covers: dict = {}
        if dur is not None:
            for f in dur.folds_for(round_num):
                covers[f.peer] = (f.prefold, frozenset(f.covers or (f.peer,)))
        if not preloaded_folded:
            for key, entry in received.items():
                await self._fold(accum, entry,
                                 prefolded=covers.get(key, (False, frozenset()))[0])
        if arrivals is not None:
            # Journal-seeded folds landed before this collect: zero lag.
            for covered_peer in self._covered(received, covers):
                arrivals.setdefault(str(covered_peer), 0.0)
        dest_dir = dur.deltas_dir if dur is not None else work_dir
        while len(self._covered(received, covers)) < num_workers:
            push = await consumer.next()
            peer = push.peer
            if allowed and peer not in allowed:
                log.warning("ps %s: push from disallowed peer %s", job_id, peer)
                await push.read_all()
                continue
            if dur is not None:
                # A recovered server's resync makes every worker re-send;
                # one for a committed round must not fold into this one.
                if await self._classify_push(push, job_id, None, round_num) is None:
                    continue
            prefolded, cov = self._push_cover(push.resource, peer)
            key = self._entry_key(prefolded, peer)
            if prefolded:
                SHARD_METRICS.prefold_partials.add(1)
            if prefolded and self._prefold_superseded(covers, cov, key):
                log.info("ps %s: partial from %s contained in an accepted ancestor partial; "
                         "dropped", job_id, peer)
                await push.read_all()
                continue
            if not prefolded and self._direct_covered(covers, peer):
                log.info("ps %s: delta from %s already covered by a tree-reduce partial; "
                         "dropped", job_id, peer)
                await push.read_all()
                continue
            if dur is None and key in received:
                # A re-send replaces the previous delta instead of
                # mis-counting the round. It lands on the same path, so the
                # old one is un-folded (from its bytes) before the save.
                log.warning("ps %s: duplicate delta from %s; replacing", job_id, peer)
                old = received.pop(key)
                await self._fold(accum, old, sign=-1.0, prefolded=prefolded)
                await asyncio.to_thread(_unlink, [old[0]])
            hasher = hashlib.sha256() if dur is not None else None
            if ptrace is not None:
                ptrace.adopt_push(push, round_num)
            entry = await self._save_delta(
                push, dest_dir, round_num,
                suffix=f"-{uuid.uuid4().hex[:8]}" if dur is not None else "", hasher=hasher,
                key=key, link=link, trace_node=tnode)
            self._note_arrival(arrivals, t_open, peer, prefolded, cov)
            if not await self._ingest(dur, round_num, 0, key, entry,
                                      hasher.hexdigest() if hasher is not None else None,
                                      prefold=prefolded, covers=cov):
                log.info("ps %s: duplicate re-send from %s (journaled); dropped", job_id, peer)
                continue
            if key in received:
                # Durable: un-fold the superseded entry after the save; its
                # file stays for a replay until a checkpoint covers it.
                log.warning("ps %s: duplicate delta from %s; replacing", job_id, peer)
                await self._fold(accum, received.pop(key), sign=-1.0, prefolded=prefolded)
            if prefolded and cov:
                await self._retire_covered(job_id, accum, received, covers, cov,
                                           durable=dur is not None)
            received[key] = entry
            covers[key] = (prefolded, cov)
            await self._fold(accum, entry, prefolded=prefolded,
                             span_attrs={"round": round_num, "peer": peer},
                             parent=_PsTrace.push_ctx(push), trace_node=tnode)
            log.info("ps %s: round %d delta %d/%d (from %s)",
                     job_id, round_num, len(received), num_workers, peer)
        return received

    async def _collect_round_elastic(self, consumer, job_id: str, st: _ElasticState, cfg,
                                     work_dir: Path, round_num: int, accum: RoundAccum,
                                     dur: "DurablePS | None" = None,
                                     link: "LinkTable | None" = None,
                                     arrivals: "dict | None" = None,
                                     ptrace: "_PsTrace | None" = None) -> dict:
        """Quorum + deadline gather: key -> (path, samples). The round
        closes, with at least a quorum of covered workers, once every live
        active worker is covered or ``round_deadline_s`` passed since it
        opened. A stale delta is dropped, a later round's is parked for it,
        a joined peer's catch-up is served from the wait; a delta still
        draining when the quorate round's deadline passes is abandoned.
        Tree-reduce partials reconcile by cover sets as in the plain
        collector. ``link`` times each drain and stretches the deadline by
        its first-round grace while an expected peer is unmeasured (no peer
        is dropped before one upload of it was seen); ``arrivals`` takes
        each covered peer's lag, a parked one's as zero."""
        tnode = ptrace.node if ptrace is not None else None
        received: dict = dict(st.early.pop(round_num, {}))
        covers: dict = dict(st.early_covers.pop(round_num, {}))
        if dur is not None:
            for f in dur.folds_for(round_num):
                covers.setdefault(f.peer, (f.prefold, frozenset(f.covers or (f.peer,))))
        for key, (p, c) in list(covers.items()):
            # A recovery-seeded bucket is a last-wins table: it can hold a
            # partial beside a direct entry the live collector had retired
            # as covered; the directs go before folding.
            if p and c:
                for member in sorted(c):
                    info = covers.get(member)
                    if member in received and not (info and info[0]):
                        received.pop(member)
                        covers.pop(member, None)
        for key, entry in received.items():
            # Parked arrivals were never folded: their round had not opened.
            await self._fold(accum, entry, prefolded=covers.get(key, (False, frozenset()))[0])
        dest_dir = dur.deltas_dir if dur is not None else work_dir
        loop = asyncio.get_running_loop()
        t_open = loop.time()
        if arrivals is not None:
            for covered_peer in self._covered(received, covers):
                arrivals.setdefault(str(covered_peer), 0.0)

        def deadline_at() -> "float | None":
            if st.round_deadline_s <= 0:
                return None
            if link is not None and any(not link.measured(p) for p in st.membership.expected()):
                return t_open + st.round_deadline_s * link.first_round_grace
            return t_open + st.round_deadline_s

        deadline_logged = False
        while True:
            # A rejoiner announced mid-round contributes to THIS round.
            await self._serve_joins(st, cfg, round_num, work_dir)
            deadline = deadline_at()
            covered = self._covered(received, covers)
            expected = st.membership.expected() | covered
            quorate = len(covered) >= st.quorum()
            if received and quorate and covered >= expected:
                break
            now = loop.time()
            if deadline is not None and now >= deadline:
                if quorate:
                    break
                if not deadline_logged:
                    deadline_logged = True
                    log.warning("ps %s: round %d deadline passed with %d/%d deltas; waiting for "
                                "quorum", job_id, round_num, len(received), st.quorum())
            timeout = _ELASTIC_TICK_S
            if deadline is not None and now < deadline:
                timeout = min(timeout, max(deadline - now, 0.05))
            try:
                push = await consumer.next(timeout=timeout)
            except asyncio.TimeoutError:
                continue
            peer = push.peer
            delta_round = await self._classify_push(push, job_id, st.membership.active, round_num)
            if delta_round is None:
                continue
            if ptrace is not None:
                ptrace.adopt_push(push, delta_round)
            prefolded, cov = self._push_cover(push.resource, peer)
            key = self._entry_key(prefolded, peer)
            cov_table = (covers if delta_round == round_num
                         else st.early_covers.get(delta_round, {}))
            if prefolded:
                SHARD_METRICS.prefold_partials.add(1)
            if prefolded and self._prefold_superseded(cov_table, cov, key):
                log.info("ps %s: partial from %s contained in an accepted ancestor partial; "
                         "dropped", job_id, peer)
                await push.read_all()
                continue
            if not prefolded and self._direct_covered(cov_table, peer):
                log.info("ps %s: delta from %s already covered by a tree-reduce partial; "
                         "dropped", job_id, peer)
                await push.read_all()
                continue
            hasher = hashlib.sha256() if dur is not None else None
            # The drain bound applies only once the round is quorate: a
            # quorum-required delta drains however slow its link.
            drain_deadline = (deadline_at() if len(self._covered(received, covers)) >= st.quorum()
                              else None)
            entry = await self._save_delta_bounded(
                push, dest_dir, delta_round, suffix=f"-{uuid.uuid4().hex[:8]}", hasher=hasher,
                deadline=drain_deadline, job_id=job_id, key=key, link=link, trace_node=tnode)
            if entry is None:
                continue
            if delta_round == round_num:
                self._note_arrival(arrivals, t_open, peer, prefolded, cov)
            if not await self._ingest(dur, delta_round, 0, key, entry,
                                      hasher.hexdigest() if hasher is not None else None,
                                      prefold=prefolded, covers=cov):
                log.info("ps %s: duplicate re-send from %s (journaled); dropped", job_id, peer)
                continue
            if delta_round > round_num:
                # Early: a fast worker already merged this round's broadcast
                # and shipped the next delta; credit it forward.
                bucket = st.early.setdefault(delta_round, {})
                old = bucket.pop(key, None)
                if old is not None and dur is None:
                    await asyncio.to_thread(_unlink, [old[0]])
                early_cov = st.early_covers.setdefault(delta_round, {})
                if prefolded and cov:
                    # Nothing in a parked bucket folded yet: the covered
                    # entries just leave the table.
                    await self._retire_covered(job_id, None, bucket, early_cov, cov,
                                               durable=dur is not None)
                bucket[key] = entry
                early_cov[key] = (prefolded, cov)
                log.info("ps %s: round %d delta from %s parked (now %d)", job_id, delta_round,
                         peer, round_num)
                continue
            old = received.pop(key, None)
            if old is not None:
                # Retired only after its replacement fully landed; a durable
                # file stays for a replay until a checkpoint covers it.
                log.warning("ps %s: duplicate delta from %s; replacing", job_id, peer)
                await self._fold(accum, old, sign=-1.0, prefolded=prefolded)
                if dur is None:
                    await asyncio.to_thread(_unlink, [old[0]])
            if prefolded and cov:
                await self._retire_covered(job_id, accum, received, covers, cov,
                                           durable=dur is not None)
            received[key] = entry
            covers[key] = (prefolded, cov)
            await self._fold(accum, entry, prefolded=prefolded,
                             span_attrs={"round": round_num, "peer": peer},
                             parent=_PsTrace.push_ctx(push), trace_node=tnode)
            log.info("ps %s: round %d delta %d (quorum %d, active %d) from %s", job_id, round_num,
                     len(received), st.quorum(), len(st.membership.active), peer)
        self._log_degraded(job_id, st, cfg, round_num, received, covers)
        return received

    def _log_degraded(self, job_id: str, st: _ElasticState, cfg, round_num: int,
                      received: dict, covers: dict) -> None:
        """A round closed with fewer covered workers than the job bought
        (a departed worker never replaced keeps every round degraded), and
        the live active workers whose delta missed the close."""
        covered = self._covered(received, covers)
        full = max(cfg.num_workers, len(st.membership.active))
        if len(covered) < full:
            FT_METRICS.degraded_rounds.add(1)
            log.warning("ps %s: round %d DEGRADED — aggregating %d of %d (departed %s)", job_id,
                        round_num, len(received), full, sorted(st.membership.departed))
        dropped = st.membership.expected() - covered
        if dropped:
            HET_METRICS.note_quorum_drop(round_num, sorted(dropped))
            log.warning("ps %s: round %d quorum drop: %s", job_id, round_num, sorted(dropped))

    @staticmethod
    def _note_arrival(arrivals: "dict | None", t_open: float, peer: str, prefolded: bool,
                      cov) -> None:
        """Record an accepted delta's lag; a tree-reduce partial credits
        every member it covers (else the straggler controller would
        penalize healthy reduced workers as dropped)."""
        if arrivals is None:
            return
        lag = asyncio.get_running_loop().time() - t_open
        if prefolded:
            for member in cov:
                arrivals.setdefault(str(member), lag)
        else:
            arrivals[peer] = lag

    async def _save_delta_bounded(self, push, dest_dir: Path, delta_round: int, *, suffix: str,
                                  hasher, deadline: "float | None",
                                  job_id: str = "", key: "str | None" = None,
                                  link: "LinkTable | None" = None,
                                  trace_node: "str | None" = None) -> "tuple | None":
        """:meth:`_save_delta` with the drain bounded by the round deadline
        (plus ``_DRAIN_SLACK_S``); None when abandoned (the sender's retry
        re-ships it, and the stale guard disposes of the copy). An
        abandoned drain is a measurement too: its bytes over its budget
        bound the link from above, so a link too slow ever to finish still
        engages the codec ladder."""
        save = self._save_delta(push, dest_dir, delta_round, suffix=suffix, hasher=hasher,
                                key=key, link=link, trace_node=trace_node)
        if deadline is None:
            return await save
        budget = max(deadline - asyncio.get_running_loop().time(), 0.0) + _DRAIN_SLACK_S
        try:
            return await asyncio.wait_for(save, timeout=budget)
        except asyncio.TimeoutError:
            log.warning("ps %s: delta drain from %s for round %d abandoned after %.1fs "
                        "(deadline passed mid-transfer)", job_id, push.peer, delta_round, budget)
            FLIGHT.record("ps.drain_abandoned", node=trace_node, peer=push.peer,
                          round=delta_round, budget_s=round(budget, 3), job=job_id)
            push.finish()
            name = hashlib.sha256((key or push.peer).encode()).hexdigest()[:24]
            partial = dest_dir / f"delta-{delta_round}-{name}{suffix}.safetensors"
            if link is not None:
                try:
                    drained = partial.stat().st_size
                except OSError:
                    drained = 0
                link.observe(push.peer, max(drained, 1), budget)
            await asyncio.to_thread(_unlink, [partial])
            return None

    @staticmethod
    async def _save_delta(push, work_dir: Path, round_num: int, suffix: str = "",
                          hasher=None, key: "str | None" = None,
                          link: "LinkTable | None" = None,
                          trace_node: "str | None" = None) -> tuple:
        """Save one pseudo-gradient push; returns (path, sample weight).
        ``hasher`` takes the payload's bytes as they stream to disk (the
        durable journal's sha, without a second read). ``key`` names the
        file when it is not the sender (a reducer's partial beside its own
        delta). ``link`` times the save: the push streams the payload, so
        draining it to disk is the sender's link."""
        name = hashlib.sha256((key or push.peer).encode()).hexdigest()[:24]
        dest = work_dir / f"delta-{round_num}-{name}{suffix}.safetensors"
        # The receiver-side ``upload`` span, header arrival to payload
        # drained: the sender's link, which the timeline's straggler keys
        # on (``peer`` names the sender; its header carries the round's
        # context).
        up_span = trace.begin("upload", parent=_PsTrace.push_ctx(push),
                              attrs={"round": round_num, "peer": push.peer}, node=trace_node)
        t0 = time.monotonic()
        nbytes = await push.save_to(dest, hasher=hasher)
        if up_span is not None:
            try:
                up_span.set_attribute("bytes", int(nbytes) if nbytes else dest.stat().st_size)
            except (TypeError, ValueError, OSError):
                pass
        trace.finish(up_span)
        if link is not None:
            try:
                size = int(nbytes) if nbytes else dest.stat().st_size
            except (TypeError, ValueError, OSError):
                size = 0
            if size > 0:
                link.observe(push.peer, size, time.monotonic() - t0)
        samples = 1.0
        if isinstance(push.resource, dict):
            try:
                samples = float(push.resource.get("num_samples", 1.0))
            except (TypeError, ValueError):
                samples = 1.0
            if not np.isfinite(samples) or samples <= 0:
                samples = 1.0
        return dest, samples

    async def _serve_joins(self, st: _ElasticState, cfg, round_num: int, work_dir: Path) -> None:
        """Push the cumulative-update catch-up to newly joined peers: Σ,
        the next round and the membership epoch (and the generation of a
        durable server, and the shard of a sharded job: its rejoiner waits
        for one catch-up per shard, each Σ over that shard's tensors)."""
        pending = [p for p, n in st.pending_joins.items() if n > 0]
        if not pending:
            return
        path = await asyncio.to_thread(st.catchup.write, work_dir / "catchup.safetensors")
        for peer in pending:
            header = {
                "resource": cfg.results.ref.resource or "results",
                "name": f"catchup-{round_num}.safetensors",
                "round": round_num,
                "epoch": st.membership.epoch,
                CATCHUP_KEY: True,
            }
            if st.num_shards > 1:
                header[SHARD_KEY] = st.shard
            if st.dur is not None:
                header[GENERATION_KEY] = st.dur.generation
            t0 = time.perf_counter()
            try:
                # A couple of backed-off tries a tick: a rejoiner's node may
                # still be binding its listener when the join lands.
                await aio.retry(
                    lambda p=peer: self.node.push(p, header, path),
                    attempts=2, base_delay=0.2, attempt_timeout=push_timeout(path, base=30.0),
                    retry_on=(RequestError, OSError), what=f"catch-up to {peer}", logger=log,
                )
            except (RequestError, OSError, asyncio.TimeoutError) as e:
                st.pending_joins[peer] -= 1
                if st.pending_joins[peer] <= 0:
                    log.error("ps: catch-up to %s failed for good: %s", peer, e)
                    del st.pending_joins[peer]
                continue
            del st.pending_joins[peer]
            FLIGHT.record("ft.catchup_served", node=self._trace_node(), peer=peer,
                          round=round_num, rounds=st.catchup.rounds)
            log.info("ps: served catch-up (%d rounds, next %d) to rejoiner %s: %d bytes in %.3f s"
                     " (shard %d)", st.catchup.rounds, round_num, peer, path.stat().st_size,
                     time.perf_counter() - t0, st.shard)

    def _encode_broadcast(self, update_path: Path, codec: str, ef, work_dir: Path,
                          round_num: int, tag: "dict | None" = None) -> tuple:
        """Re-encode the f32 update for the wire per the job's codec, on the
        device (counterpart of the reference's ``_encode_broadcast``): "none"
        broadcasts the update file itself; bf16 casts it; int8/int4 write an
        HQD1 frame of Q(update + residual), stamped with ``tag``. Returns
        the wire path and the update as the workers will decode it (None
        for "none"), which the rejoin Σ accumulates."""
        if codec == "none":
            return update_path, None
        wire = work_dir / f"update-{round_num}.wire.safetensors"
        # In name order: the reference re-reads its f32 update through the
        # safetensors library, which orders tensors by name within a dtype,
        # so the frames are byte-identical.
        update = {k: v.to(self.device) for k, v in sorted(load_file(update_path).items())}
        sent = compress.write_delta(wire, update, codec, ef=ef, tag=tag)
        return wire, sent

    @staticmethod
    def _checkpoint_momentum(momentum_file: Path, ckpt_dir: Path) -> None:
        """Copy a momentum file into the checkpoint dir under its own name
        (beside, then renamed): the outer state a full job restart
        warm-starts from (a pipelined server keeps one file per part)."""
        if not momentum_file.is_file():
            return
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        tmp = ckpt_dir / ".momentum.tmp"
        shutil.copyfile(momentum_file, tmp)
        os.replace(tmp, ckpt_dir / momentum_file.name)

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
                             lr: float, mu: float, codec: str, fragments: int, *,
                             shard: int, num_shards: int, sync_mode: str,
                             elastic: "_ElasticState | None", dur: "DurablePS | None",
                             momentum_file: Path, ckpt_dir: "Path | None", round_start: int,
                             init_accums: dict, init_pending: dict, init_efs: dict,
                             adaptive_steps: bool = False) -> None:
        """The pipelined round loop of ``sync_mode`` overlap and stream, and
        of every sharded job (counterpart of the reference's
        ``_stream_rounds``). Round ``r`` closes its due part when every
        worker is covered (``elastic``: at quorum, by the deadline); its
        update is encoded with that part's broadcast residual, Σ takes it
        (``elastic``), a durable server stores its wire and commits it, the
        scheduler hears ``UPDATED``, and the fan-out starts in the
        background while the next round collects. Fan-outs of one part are
        chained (round r+F waits for round r); at most F + 1 are out at once.

        ``fragments`` is the placement's part count. A stream shard takes
        only the rounds whose due fragment it owns; a blocking shard closes
        its own part (``shard``) every round. A recovered server starts at
        ``round_start`` with the replayed accumulators, the journaled
        buckets of the rounds it had not closed and its residuals."""
        accums: dict = dict(init_accums)  # round -> RoundAccum, the open rounds
        pending: dict = dict(init_pending)  # round -> {key: entry} not open yet
        pending_covers: dict = {}  # round -> {key: (prefolded, covers)}
        bcast_efs: dict = dict(init_efs)
        bcast_tasks: set = set()
        last_bcast: dict = {}  # part -> its newest fan-out
        sharded = num_shards > 1

        def due_fn(r: int) -> int:
            return shard if sharded and sync_mode != "stream" else fragment_due(r, fragments)

        def next_owned(r: int) -> int:
            if not sharded or sync_mode != "stream":
                return r
            return next_owned_round(sync_mode, r, fragments, num_shards, shard)

        owned_fn = None
        if sharded and sync_mode == "stream":
            def owned_fn(r: int) -> bool:
                return shard_owns_round(sync_mode, r, fragments, num_shards, shard)

        def momentum_files() -> list:
            """The whole momentum: the base file, then the parts over it."""
            return [momentum_file] + sorted(work_dir.glob("momentum-f*.safetensors"))

        round_num = next_owned(round_start)
        ptrace = _PsTrace(self._trace_node())
        park_s = float(cfg.adopt_grace_s or 0)
        try:
            while True:
                execution.round = round_num
                if elastic is not None:
                    execution.epoch = elastic.membership.epoch
                if dur is not None:
                    await asyncio.to_thread(dur.note_open, round_num)
                arrivals: "dict | None" = {} if adaptive_steps else None
                qw_span = trace.begin("quorum_wait", parent=ptrace.ctx(round_num),
                                      attrs={"round": round_num, "fragment": due_fn(round_num)},
                                      node=ptrace.node)
                received = await self._collect_round_stream(
                    consumer, job_id, allowed, num_workers, work_dir, round_num, fragments,
                    accums, pending, due_fn=due_fn, owned_fn=owned_fn,
                    pending_covers=pending_covers, sharded=sharded, cfg=cfg, st=elastic,
                    dur=dur, arrivals=arrivals, ptrace=ptrace)
                trace.reparent(qw_span, ptrace.ctx(round_num))
                trace.finish(qw_span)
                if dur is not None:
                    await asyncio.to_thread(dur.note_close, round_num, list(received))
                frag = due_fn(round_num)
                tag = FragmentTag(round=round_num, fragment_id=frag, fragments=fragments)
                accum = accums.pop(round_num, None)
                part_momentum = self._part_momentum(work_dir, frag)
                outer_span = trace.begin("outer_step", parent=ptrace.ctx(round_num),
                                         attrs={"round": round_num, "fragment": frag},
                                         node=ptrace.node)
                quality = {"fragment": float(frag)} if cfg.report_metrics_s else None
                update_path = await asyncio.to_thread(
                    outer_step, received, part_momentum, lr, mu, work_dir, round_num,
                    accum=accum, stats=quality, device=self.device, base=momentum_file)
                trace.finish(outer_span)
                del accum
                if frag not in bcast_efs:
                    bcast_efs[frag] = (compress.ErrorFeedback()
                                       if codec in compress.QUANT_CODECS else None)
                wire_path, sent = await asyncio.to_thread(
                    self._encode_broadcast, update_path, codec, bcast_efs[frag], work_dir,
                    round_num, tag.header())
                if elastic is not None:
                    # Σ at close time, in close order (never from the
                    # background fan-out), before the durable commit.
                    if sent is None:
                        await asyncio.to_thread(elastic.catchup.accumulate, wire_path, frag)
                    else:
                        await asyncio.to_thread(elastic.catchup.accumulate_tree, sent, frag)
                del sent
                if dur is not None:
                    wire_name = await asyncio.to_thread(dur.store_wire, round_num, wire_path)
                    await asyncio.to_thread(
                        dur.commit_round, round_num, frag, wire_name,
                        epoch=elastic.membership.epoch if elastic is not None else 0,
                        momentum_file=momentum_files(),
                        catchup=elastic.catchup if elastic is not None else None,
                        efs=bcast_efs,
                        active=list(elastic.membership.active) if elastic is not None else [])
                    execution.round = next_owned(round_num + 1)  # committed
                if ckpt_dir is not None:
                    await asyncio.to_thread(self._checkpoint_momentum, part_momentum, ckpt_dir)
                header = dict(tag.header())
                if dur is not None:
                    header[GENERATION_KEY] = dur.generation
                if sharded:
                    header[SHARD_KEY] = shard
                # The fan-out's peers are frozen at close: a rejoiner joining
                # while it is pending gets this round inside its catch-up.
                peers = list(elastic.membership.active) if elastic is not None else None

                async def spawn_bcast(_u=update_path, _w=wire_path, _rcv=received, _tag=tag,
                                      _hdr=header, _frag=frag, _peers=peers) -> None:
                    last_bcast[_frag] = aio.spawn(
                        self._broadcast_and_cleanup(
                            cfg, _u, _w, _rcv, _tag, _hdr, after=last_bcast.get(_frag),
                            elastic=elastic, peers=_peers, keep_received=dur is not None,
                            traceparent=ptrace.ctx(_tag.round)),
                        tasks=bcast_tasks, what=f"stream broadcast r{_tag.round}", logger=log)

                launch_bcast = _fire_once(spawn_bcast)
                # Notify before the fan-out (the blocking loop's race note,
                # and its exception across a scheduler outage).
                response = await self._notify_updated_resilient(
                    scheduler_peer, job_id, round_num, execution=execution, shard=shard,
                    arrivals=arrivals, park_s=park_s, on_first_failure=launch_bcast,
                    traceparent=ptrace.ctx(round_num), quality=quality)
                ptrace.adopt(response, next_owned(round_num + 1))
                if dur is not None:
                    await asyncio.to_thread(dur.note_notified, round_num,
                                            response.kind == ProgressResponseKind.DONE)
                await launch_bcast()
                STREAM_METRICS.fragment_closed(frag)
                if sharded:
                    SHARD_METRICS.shard_rounds_closed.add(1)
                round_num = next_owned(round_num + 1)
                if elastic is not None:
                    await self._serve_joins(elastic, cfg, round_num, work_dir)
                live = [t for t in bcast_tasks if not t.done()]
                if len(live) >= fragments + 1:
                    await asyncio.wait(live, return_when=asyncio.FIRST_COMPLETED)
                if response.kind == ProgressResponseKind.DONE:
                    # The last update must still reach the workers: their
                    # DONE comes with the UPDATE_RECEIVED it triggers.
                    await aio.wait_quiet(*bcast_tasks, timeout=60.0)
                    self._log_journal(job_id, dur)
                    execution.finish("completed")
                    return
        finally:
            await aio.reap(*bcast_tasks)

    async def _collect_round_stream(self, consumer, job_id: str, allowed: set, num_workers: int,
                                    work_dir: Path, round_num: int, fragments: int,
                                    accums: dict, pending: dict, *, due_fn=None, owned_fn=None,
                                    pending_covers: "dict | None" = None,
                                    sharded: bool = False, cfg=None,
                                    st: "_ElasticState | None" = None,
                                    dur: "DurablePS | None" = None,
                                    arrivals: "dict | None" = None,
                                    ptrace: "_PsTrace | None" = None) -> dict:
        """Gather round ``round_num``'s part deltas, key -> (path, samples),
        until every worker is covered, or, with ``st`` (elastic), until the
        live active workers are covered at quorum or the round deadline
        passed at quorum. Every delta folds, as it lands, into the
        accumulator of the round its header names: this one or a later
        one. A delta for a closed round, one from a non-member, one for a
        round another shard owns (``owned_fn``), one whose tag names
        another part or count (``due_fn`` gives a round's part), and an
        HQD1 frame whose own tag contradicts its header are dropped; a
        re-send replaces (un-folds) the sender's earlier delta; partials
        reconcile by cover sets; a durable server (``dur``) journals each
        accepted push under the round's part and drops an exact re-send.
        ``arrivals`` takes each peer covered for this round with its lag
        (a delta parked before the collect opened: zero)."""
        if due_fn is None:
            def due_fn(r: int) -> int:
                return fragment_due(r, fragments)
        tnode = ptrace.node if ptrace is not None else None
        if pending_covers is None:
            pending_covers = {}
        received = pending.pop(round_num, {})
        covers: dict = pending_covers.pop(round_num, {})
        if dur is not None:
            for f in dur.folds_for(round_num):
                covers.setdefault(f.peer, (f.prefold, frozenset(f.covers or (f.peer,))))
        dest_dir = dur.deltas_dir if dur is not None else work_dir
        loop = asyncio.get_running_loop()
        t_open = loop.time()
        if arrivals is not None:
            for covered_peer in self._covered(received, covers):
                arrivals.setdefault(str(covered_peer), 0.0)
        deadline = None
        if st is not None and st.round_deadline_s > 0:
            deadline = loop.time() + st.round_deadline_s
        deadline_logged = False
        while True:
            timeout = None
            if st is not None:
                await self._serve_joins(st, cfg, round_num, work_dir)
                covered = self._covered(received, covers)
                expected = st.membership.expected() | covered
                quorate = len(covered) >= st.quorum()
                if received and quorate and covered >= expected:
                    break
                now = loop.time()
                if deadline is not None and now >= deadline:
                    if quorate:
                        break
                    if not deadline_logged:
                        deadline_logged = True
                        log.warning("ps %s: round %d (fragment %d) deadline passed with %d/%d "
                                    "deltas; waiting for quorum", job_id, round_num,
                                    due_fn(round_num), len(received), st.quorum())
                timeout = _ELASTIC_TICK_S
                if deadline is not None and now < deadline:
                    timeout = min(timeout, max(deadline - now, 0.05))
            elif len(self._covered(received, covers)) >= num_workers:
                break
            try:
                push = await consumer.next(timeout=timeout)
            except asyncio.TimeoutError:
                continue
            peer = push.peer
            meta = push.resource if isinstance(push.resource, dict) else {}
            members = st.membership.active if st is not None else (allowed or None)
            delta_round = await self._classify_push(push, job_id, members, round_num)
            if delta_round is None:
                continue
            if ptrace is not None:
                ptrace.adopt_push(push, delta_round)
            if owned_fn is not None and not owned_fn(delta_round):
                # Another shard's round: this shard never opens it.
                SHARD_METRICS.misrouted_pushes.add(1)
                log.warning("ps %s: push for round %d from %s is another shard's; dropped",
                            job_id, delta_round, peer)
                await push.read_all()
                continue
            prefolded, cov = self._push_cover(meta, peer)
            key = self._entry_key(prefolded, peer)
            if prefolded:
                SHARD_METRICS.prefold_partials.add(1)
            due = due_fn(delta_round)
            tag = FragmentTag.from_header(meta)
            if tag is not None and (tag.fragments != fragments or tag.fragment_id != due):
                # On a sharded run a mismatched tag is the stale-placement
                # signal.
                if sharded:
                    SHARD_METRICS.misrouted_pushes.add(1)
                log.warning("ps %s: fragment tag mismatch from %s (round %d fragment %d/%d, "
                            "expected %d/%d); dropped", job_id, peer, delta_round,
                            tag.fragment_id, tag.fragments, due, fragments)
                await push.read_all()
                continue
            bucket = received if delta_round == round_num else pending.setdefault(delta_round, {})
            cov_table = (covers if delta_round == round_num
                         else pending_covers.setdefault(delta_round, {}))
            if prefolded and self._prefold_superseded(cov_table, cov, key):
                log.info("ps %s: partial from %s contained in an accepted ancestor partial; "
                         "dropped", job_id, peer)
                await push.read_all()
                continue
            if not prefolded and self._direct_covered(cov_table, peer):
                log.info("ps %s: delta from %s already covered by a tree-reduce partial; "
                         "dropped", job_id, peer)
                await push.read_all()
                continue
            # Saved under a unique name, validated, then any duplicate is
            # retired: a corrupt re-send never destroys the folded original.
            hasher = hashlib.sha256() if dur is not None else None
            drain_deadline = None
            if st is not None and deadline is not None \
                    and len(self._covered(received, covers)) >= st.quorum():
                drain_deadline = deadline
            entry = await self._save_delta_bounded(
                push, dest_dir, delta_round, suffix=f"-{uuid.uuid4().hex[:8]}", hasher=hasher,
                deadline=drain_deadline, job_id=job_id, key=key, trace_node=tnode)
            if entry is None:
                continue
            if tag is not None and not await asyncio.to_thread(
                    self._frame_tag_matches, entry[0], tag):
                # The push header and the frame disagree: trust neither.
                log.warning("ps %s: frame tag mismatch from %s (header %s); dropped",
                            job_id, peer, tag)
                await asyncio.to_thread(_unlink, [entry[0]])
                continue
            if not await self._ingest(dur, delta_round, due, key, entry,
                                      hasher.hexdigest() if hasher is not None else None,
                                      prefold=prefolded, covers=cov):
                log.info("ps %s: duplicate re-send from %s (journaled); dropped", job_id, peer)
                continue
            accum = accums.setdefault(delta_round, RoundAccum(device=self.device))
            old = bucket.pop(key, None)
            if old is not None:
                log.warning("ps %s: duplicate %s from %s; replacing", job_id,
                            "partial" if prefolded else "delta", peer)
                await self._fold(accum, old, sign=-1.0, prefolded=prefolded)
                if dur is None:
                    await asyncio.to_thread(_unlink, [old[0]])
            if prefolded and cov:
                await self._retire_covered(job_id, accum, bucket, cov_table, cov,
                                           durable=dur is not None)
            bucket[key] = entry
            cov_table[key] = (prefolded, cov)
            if delta_round == round_num:
                self._note_arrival(arrivals, t_open, peer, prefolded, cov)
            await self._fold(accum, entry, prefolded=prefolded,
                             span_attrs={"round": delta_round, "peer": peer, "fragment": due},
                             parent=_PsTrace.push_ctx(push), trace_node=tnode)
            log.info("ps %s: round %d part %d %s %d (from %s%s%s)", job_id, round_num,
                     due_fn(round_num), "partial" if prefolded else "delta", len(received),
                     peer, f", covers {sorted(cov)}" if prefolded else "",
                     "" if delta_round == round_num else f", parked r{delta_round}")
        if st is not None:
            self._log_degraded(job_id, st, cfg, round_num, received, covers)
        return received

    async def _broadcast_and_cleanup(self, cfg, update_path: Path, wire_path: Path,
                                     received: dict, tag: FragmentTag, header: dict,
                                     after: "asyncio.Task | None" = None, elastic=None,
                                     peers: "list | None" = None,
                                     keep_received: bool = False,
                                     traceparent: "str | None" = None) -> None:
        """One round's background fan-out, then its files go (a durable
        server keeps the received files for its journal's replay).
        ``after`` is the same part's previous fan-out: without the chain a
        slow link could deliver round r+F's update before round r's, and
        the worker would drop the older one as stale. ``peers`` is the
        elastic membership frozen at the round's close."""
        if after is not None:
            await aio.wait_quiet(after)
        try:
            await self._broadcast(cfg, wire_path, tag.round, elastic, extra_header=header,
                                  peers_override=peers, traceparent=traceparent,
                                  span_round=tag.round)
        finally:
            done = [update_path, wire_path]
            if not keep_received:
                done += [path for path, _ in received.values()]
            await asyncio.to_thread(_unlink, done)

    async def _broadcast_adaptive(self, cfg, update_path: Path, round_num: int, elastic,
                                  link: LinkTable, peer_efs: dict, work_dir: Path,
                                  traceparent: "str | None" = None) -> None:
        """Per-link broadcast (the reference's ``:2478-2573``): peers grouped
        by the codec their measured link maps to. "none" ships the f32
        update file itself; another unquantized codec is encoded once for
        its group; each quantized peer gets its own encode with its own
        ``ErrorFeedback`` on the server's device (a shared residual would
        absorb another link's error), kept across codec changes. Every
        wire carries its codec (``CODEC_KEY``) and fans out through
        :meth:`_broadcast`."""
        peers = (list(elastic.membership.active) if elastic is not None
                 else list(cfg.results.ref.peers or []))
        if not peers:
            return
        by_codec: dict = {}
        for peer in peers:
            by_codec.setdefault(link.codec_for(peer), []).append(peer)
        tree_box: dict = {}

        def update_tree() -> dict:
            # Loaded once, only if a link needs an encode; in name order,
            # as the reference's safetensors read gives it.
            if "tree" not in tree_box:
                tree_box["tree"] = {k: v.to(self.device)
                                    for k, v in sorted(load_file(update_path).items())}
            return tree_box["tree"]

        def encode(wire: Path, codec: str, ef) -> None:
            t0 = time.perf_counter()
            compress.write_delta(wire, update_tree(), codec, ef=ef)
            log.info("ps: round %d %s wire %s encoded in %.3f s (%d bytes)", round_num, codec,
                     wire.name, time.perf_counter() - t0, wire.stat().st_size)

        sends: list = []
        scratch: list = []
        try:
            for codec, group in sorted(by_codec.items()):
                if codec in compress.QUANT_CODECS:
                    for peer in group:
                        ef = peer_efs.get(peer)
                        if ef is None:
                            ef = peer_efs[peer] = compress.ErrorFeedback()
                        tag = hashlib.sha256(peer.encode()).hexdigest()[:12]
                        wire = work_dir / f"update-{round_num}.{tag}.wire.safetensors"
                        await asyncio.to_thread(encode, wire, codec, ef)
                        scratch.append(wire)
                        sends.append((wire, codec, [peer]))
                elif codec == "none":
                    sends.append((update_path, codec, list(group)))
                else:
                    wire = work_dir / f"update-{round_num}.{codec}.wire.safetensors"
                    await asyncio.to_thread(encode, wire, codec, None)
                    scratch.append(wire)
                    sends.append((wire, codec, list(group)))
            tree_box.clear()
            tasks = [asyncio.create_task(
                self._broadcast(cfg, wire, round_num, elastic, extra_header={CODEC_KEY: codec},
                                peers_override=group, traceparent=traceparent,
                                span_round=round_num), name=f"ps-abcast-{codec}")
                for wire, codec, group in sends]
            try:
                await asyncio.gather(*tasks)
            finally:
                await aio.reap(*(t for t in tasks if not t.done()))
        finally:
            with trace.span("cleanup", parent=traceparent, attrs={"round": round_num},
                            node=self._trace_node()):
                await asyncio.to_thread(_unlink, scratch)
                if self.device.type == "cuda":
                    # The encodes' transients (the update tree, each frame's
                    # decoded tensors) go back to the card, which the job's
                    # trainers may share; the residuals stay.
                    torch.cuda.empty_cache()

    async def _broadcast(self, cfg, update_path: Path, round_num: int, elastic=None,
                         extra_header: "dict | None" = None,
                         peers_override: "list | None" = None,
                         traceparent: "str | None" = None,
                         span_round: "int | None" = None) -> None:
        """Push the update's wire file to every results peer in parallel, at
        most ``_BROADCAST_CONCURRENCY`` streams at once. A peer's failure is
        tolerated (it catches up next round); ``TransferStrategy.ANY``
        stops at the first push that lands. An elastic round goes to the
        membership's active set (``peers_override`` when the pipelined
        loop froze it at the close), with its epoch in the header.
        ``extra_header`` (a stream round's ``FragmentTag``, a durable
        server's generation, a shard's index) joins the push header.
        ``traceparent`` (a traced job's round broadcasts only) stamps the
        round's context into the header and, with ``span_round``, wraps
        the fan-out in a ``broadcast`` span; resync, catch-up and
        re-broadcast callers pass neither and keep their header bytes."""
        peers = cfg.results.ref.peers or []
        strategy = cfg.results.ref.strategy or TransferStrategy.ALL
        header = {"resource": cfg.results.ref.resource or "results",
                  "name": update_path.name, "round": round_num, **(extra_header or {})}
        trace.inject(header, traceparent)
        if elastic is not None:
            peers = list(elastic.membership.active)
            header["epoch"] = elastic.membership.epoch
        if peers_override is not None:
            peers = list(peers_override)
        # Serving followers join after both overrides (which rewrite the
        # set to the round's members): they are no round members.
        serve_peers = [str(p) for p in (cfg.serve_peers or [])]
        peers = list(peers) + [p for p in serve_peers if p not in peers]
        if not peers:
            return
        tree_map = cfg.broadcast_tree
        tree_groups = list(tree_map.groups or []) if tree_map is not None else []
        if tree_groups and strategy != TransferStrategy.ANY and len(peers) > 1:
            # The top-level relays (and ungrouped or orphaned peers) only;
            # the relays re-push down their subtrees. A follower whose relay
            # is live rides the relay hop.
            bcast_groups = with_serve_leaves(tree_groups,
                                             serve_peers + list(tree_map.serve_leaves or []))
            targets = top_targets(bcast_groups, peers)
            t0 = time.perf_counter()
            bcast_span = (trace.begin("broadcast", parent=traceparent, node=self._trace_node(),
                                      attrs={"round": span_round, "peers": len(peers),
                                             "tree": True})
                          if span_round is not None else None)
            try:
                delivered, lost = await tree_broadcast(
                    self.node, header, str(header["resource"]), bcast_groups, targets,
                    update_path, allowed=set(peers), concurrency=_BROADCAST_CONCURRENCY,
                    what="ps tree broadcast", logger=log)
            finally:
                trace.finish(bcast_span)
            log.info("ps: tree broadcast round %d to %s of %s in %.3f s (%d delivered, %d lost)",
                     round_num, targets, peers, time.perf_counter() - t0, delivered, lost)
            if lost:
                log.warning("ps: tree broadcast left %d peer(s) unreached; they catch up next "
                            "round", lost)
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

        bcast_span = (trace.begin("broadcast", parent=traceparent, node=self._trace_node(),
                                  attrs={"round": span_round, "peers": len(peers)})
                      if span_round is not None else None)
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
            trace.finish(bcast_span)

    async def _notify_updated(self, scheduler_peer: str, job_id: str, round_num: int,
                              execution=None, shard: int = 0,
                              arrivals: "dict | None" = None,
                              traceparent: "str | None" = None,
                              quality: "dict | None" = None) -> ProgressResponse:
        """One UPDATED notify; a reply from an older scheduler generation
        than the one adopted (a zombie's) raises, so it is retried."""
        gen = getattr(execution, "scheduler_generation", None)
        progress = Progress(
            kind=ProgressKind.UPDATED, job_id=job_id, round=round_num, shard=shard,
            # Stamped only once a scheduler restart happened (generation
            # >= 2), so an unrestarted job's UPDATED is the reference's bytes.
            scheduler_generation=gen if gen is not None and gen >= 2 else None,
            traceparent=traceparent,
        )
        if arrivals is not None:
            # Only adaptive_steps jobs attach the key: a static UPDATED
            # keeps its bytes.
            progress.metrics = {"arrival_s": {p: round(t, 6) for p, t in arrivals.items()}}
        if quality:
            # The metrics plane: the round's quality numbers (pseudo-gradient
            # and update norms, accepted deltas). Only a reporting job
            # attaches the key: the static wire is untouched.
            progress.metrics = {**progress.metrics, "quality": dict(quality)}
        resp = await self.node.request(scheduler_peer, PROTOCOL_PROGRESS, progress, timeout=30)
        if not isinstance(resp, ProgressResponse):
            raise RequestError(f"unexpected progress response {resp!r}")
        log.info("ps %s: round %d UPDATED%s (answered %s)%s", job_id, round_num,
                 f" shard {shard}" if shard else "", resp.kind.value,
                 f"; arrival_s {progress.metrics['arrival_s']}" if arrivals is not None else "")
        if execution is not None:
            new_gen, stale = stale_scheduler_response(resp, gen)
            if stale:
                # A zombie predecessor answered: its decision must not
                # drive the round machinery.
                FT_METRICS.stale_generation_dropped.add(1)
                log.warning("ps %s: round %d UPDATED answered by stale scheduler generation %s "
                            "(adopted %s); dropped", job_id, round_num, resp.generation, gen)
                raise RequestError("stale scheduler generation on UPDATED reply")
            execution.scheduler_generation = new_gen
        return resp

    async def _notify_updated_resilient(self, scheduler_peer: str, job_id: str, round_num: int,
                                        *, shard: int = 0, arrivals: "dict | None" = None,
                                        execution=None, park_s: float = 0.0,
                                        on_first_failure=None,
                                        traceparent: "str | None" = None,
                                        quality: "dict | None" = None) -> ProgressResponse:
        """An UPDATED notify that survives a scheduler outage. Without
        ``park_s`` (recovery off) it is one attempt. With it, the second
        failed attempt in a row runs ``on_first_failure`` (the round's
        broadcast: a quorate round closes without the scheduler), then the
        notify retries in ``aio.retry`` until the restarted scheduler
        answers or ``park_s`` runs out. Two failures, not one: one blip
        against a live scheduler must not reorder notify and broadcast,
        since the workers' UPDATE_RECEIVED is not parked then.

        A scheduler that adopted the execution during the park and then
        let the lease it re-armed lapse has released the job: the park
        stops with DONE and the execution completes, where it would fail
        at ``park_s``. This server reports the round after a committed one
        in its AdoptAck, so a scheduler without the port's ``_owed`` (the
        reference's) can complete the job from the adoption alone and never
        answer the notify. A live adopter renews the lease and answers the
        notify once its progress handler is up, however long its adoption
        takes."""
        if park_s <= 0:
            return await self._notify_updated(scheduler_peer, job_id, round_num, execution,
                                              shard=shard, arrivals=arrivals,
                                              traceparent=traceparent, quality=quality)
        failures = [0]
        t0 = time.perf_counter()
        gen0 = getattr(execution, "scheduler_generation", None)

        async def once() -> ProgressResponse:
            try:
                return await self._notify_updated(scheduler_peer, job_id, round_num, execution,
                                                  shard=shard, arrivals=arrivals,
                                                  traceparent=traceparent, quality=quality)
            except (RequestError, OSError, asyncio.TimeoutError) as e:
                released = getattr(execution, "adopter_released", None)
                if (getattr(execution, "scheduler_generation", None) != gen0
                        and released is not None and released()):
                    raise _JobEnded() from e
                failures[0] += 1
                if failures[0] == 2 and on_first_failure is not None:
                    FLIGHT.record("ps.notify_parked", node=self._trace_node(), job=job_id,
                                  round=round_num, shard=shard)
                    log.warning("ps %s: round %d UPDATED failed twice; broadcasting before the "
                                "scheduler answers", job_id, round_num)
                    await on_first_failure()
                raise

        try:
            resp = await aio.retry(once, base_delay=0.5, max_delay=5.0, deadline=park_s,
                                   retry_on=(RequestError, OSError),
                                   what=f"updated r{round_num} -> scheduler", logger=log)
        except _JobEnded:
            FLIGHT.record("ps.notify_ended", node=self._trace_node(), job=job_id,
                          round=round_num, shard=shard)
            log.warning("ps %s: round %d UPDATED: scheduler generation %s adopted this execution "
                        "and released its lease; its job ended, so the server completes (%d "
                        "parked attempt(s) in %.3f s)", job_id, round_num,
                        execution.scheduler_generation, failures[0], time.perf_counter() - t0)
            return ProgressResponse(kind=ProgressResponseKind.DONE)
        if failures[0]:
            log.warning("ps %s: round %d UPDATED answered after %d parked attempt(s) in %.3f s "
                        "(scheduler generation %s, round %s)", job_id, round_num, failures[0],
                        time.perf_counter() - t0, resp.generation, resp.round)
        return resp
