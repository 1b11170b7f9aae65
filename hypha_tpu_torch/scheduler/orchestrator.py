"""The scheduler orchestrator: allocate → wire → dispatch → supervise (a copy
of ``hypha_tpu/scheduler/orchestrator.py``, with every wire codec and sync
mode, the sharded parameter service and the tree reduce, and with elastic
membership, rejoin and each parameter-server shard's own restart).

Reference call stack being reproduced (SURVEY.md §3.1,
crates/scheduler/src/bin/hypha-scheduler.rs:54-432):

  1. auction ``num_workers`` train workers + ``num_ps_shards`` parameter
     server executions, distinct peers first (GreedyWorkerAllocator over
     gossip);
  2. accept offers by first lease renewal (WorkerHandle) and keep the
     renewal loops alive — a renewal failure is the worker-failure signal;
  3. per-worker batch size = floor(offered.gpu / required.gpu) clamped to
     ``max_batch_size`` (hypha-scheduler.rs:320-322);
  4. resolve the dataset's data provider from the discovery records;
  5. spawn DataScheduler (slice assignment), ProgressTracker +
     BatchScheduler (the DiLoCo control plane) and the MetricsBridge;
  6. dispatch an aggregate job to each shard (``<id>-ps<k>`` under the
     updates tag ``updates:<id>.s<k>`` when there are several) and a train
     job per worker, carrying the ``ShardMap`` placement and, with
     ``reduce_group_size >= 2``, each worker's tree role (``reduce_via``,
     ``reduce_members``; ``stream.tree.build_reduce_groups``);
  7. supervise: job completes when the batch scheduler reports every
     worker DONE; a sharded round advances on ``UPDATED`` from every due
     shard. With ``job.ft`` a failed shard is restarted alone (below).

Without ``job.ft``, any failure — a failed or cancelled job status, a
lease renewal failure, no progress message within the watchdog's deadline
— fails the attempt with ``JobFailed``; ``max_attempts > 1`` re-runs the
whole job (with a ``checkpoint_dir``, the trainers resume from their
checkpoints and the parameter server from its momentum copy). The
no-progress watchdog is per-round: without ``status_timeout`` the deadline
derives from the synchronization simulation's projected round time once
every worker has timing statistics.

With ``job.ft`` (every sync mode and placement; the reference's
``:1542-2086``) a train worker's failure degrades the round set instead:
``_depart`` drops it from the ``MembershipView`` (every parameter-server
shard hears each new epoch over ``/hypha-ft/0.0.1``), and
``_rejoin_worker`` auctions a replacement, joins it, has every shard
queue its catch-up (a JOINED update fails while any shard restarts, so the
rejoin retries) and dispatches it with ``rejoin=True``. The replacement
gets the tree role its peer id has in the plan: none, as in the reference,
so a rejoiner pushes to the shards directly while its dead predecessor's
reducer flushes the rest of the group. φ-accrual suspicion
(``ft/detector.py``, fed by every progress message and lease renewal) marks
silent workers, so the servers stop waiting for them past quorum. With a
``checkpoint_dir`` and ``ps_restart_attempts`` left, a failed shard is
re-auctioned alone under the SAME peer id and its own aggregate job
re-dispatched unchanged, while the other shards keep closing their rounds;
its durable journal under ``<checkpoint_dir>/ps`` (``/ps<k>`` with several
shards) resumes its rounds.

With ``broadcast_tree`` the reducers also relay the update broadcasts down
their groups (``relay_results``; ``stream/reduce.py`` ``BroadcastRelay``),
every worker's results allowlist admits its ancestor relays beside the
shards, and each shard's aggregate spec carries the placement
(``broadcast_tree``). ``serve_peers`` are serving followers: the shards
push them every round after the membership overrides, and under a tree
the placement's ``serve_leaves`` hangs them off the relays.

With ``adaptive_steps`` a ``StragglerController`` (base steps: the round's
samples over the fleet's summed batch) drives the batch scheduler, and each
round's assignments ride the membership the servers receive
(``RoundMembership.inner_steps``); the aggregate spec carries
``adaptive_steps``, ``adaptive_codec`` and the codec thresholds, each None
when off so a static job's spec keeps its bytes.

With ``scheduler_recovery`` (which needs ``ft`` and ``checkpoint_dir``) the
scheduler is restartable (the reference's ``:321-396``, ``:1126-1505``): a
``DurableScheduler`` journal under ``<checkpoint_dir>/scheduler`` records the
plan, every dispatch, the round frontier, each membership epoch and the
spent shard restarts, and the dispatched specs carry the adoption grace
(``adopt_grace_s``: workers hold their leases and park their control sends
that long). A scheduler started under the same peer id finds the journal,
bumps the generation, re-arms the journaled leases, sends ``SchedulerHello``
to every recorded execution and fast-forwards to the rounds the
``AdoptAck``s report (``BatchScheduler.adopt_round``): nothing is
re-dispatched or re-auctioned. An execution that does not answer within
``scheduler_adopt_deadline_s`` departs (a train worker, then the rejoin
auction) or is restarted (a shard); no adoptable journal, or nothing alive,
falls back to a fresh run. A finished job wipes its journal. The
reference's ``FT_METRICS`` counts (``scheduler_recoveries``,
``adopted_executions``, ``stale_generation_dropped``) are logged when the
job ends and kept in ``Orchestrator.counts``.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from pathlib import Path
from typing import Any

from .. import aio, messages
from ..executor import DEFAULT_PREFETCH_SLICES
from ..ft.adaptive import StragglerController
from ..ft.detector import PhiAccrualDetector
from ..ft.durable import DEFAULT_ADOPT_DEADLINE_S, DEFAULT_ADOPT_GRACE_S, DurableScheduler
from ..ft.membership import PROTOCOL_FT, MembershipUpdate, MembershipView, quorum_size
from ..messages import (
    AGGREGATE_EXECUTOR_NAME,
    PROTOCOL_API,
    PROTOCOL_PROGRESS,
    TRAIN_EXECUTOR_NAME,
    AdoptAck,
    AggregateExecutorConfig,
    SchedulerHello,
    ShardMap,
    DataRecord,
    Executor,
    ExecutorDescriptor,
    Fetch,
    JobSpec,
    Progress,
    Receive,
    Reference,
    Send,
    TrainExecutorConfig,
    WorkerSpec,
)
from ..network.node import Node, RequestError
from ..stream import ancestors_of, build_reduce_groups, placement_parts, shards_due_at
from .allocator import GreedyWorkerAllocator
from .batch_scheduler import BatchScheduler
from .data_scheduler import DataScheduler
from .job_config import DiLoCoJob
from .metrics_bridge import MetricsBridge, MetricsConnector
from .simulation import project
from .task import DispatchError, StatusRouter, Task
from .trackers import ProgressTracker, WorkerState
from .worker_handle import WorkerHandle

__all__ = ["Orchestrator", "JobResult", "JobFailed", "AllocationError", "AdoptionFailed"]

log = logging.getLogger("hypha.torch.scheduler.orchestrator")

# Watchdog fallback while no per-round projection exists (no statistics
# yet, or a worker without a single timed batch).
DEFAULT_STATUS_TIMEOUT = 600.0
# Adaptive per-round deadline = clamp(factor · projected_round_time,
# floor, DEFAULT_STATUS_TIMEOUT).
ROUND_DEADLINE_FACTOR = 5.0
ROUND_DEADLINE_FLOOR_S = 60.0


class AllocationError(RuntimeError):
    pass


class JobFailed(RuntimeError):
    pass


class AdoptionFailed(RuntimeError):
    """A restarted scheduler could not adopt its predecessor's executions
    (no adoptable journal, or nothing alive): ``run`` falls back to a
    fresh attempt."""


class JobResult:
    def __init__(self, job_id: str, rounds: int, metrics: list, attempt: int = 0,
                 ft: "dict | None" = None) -> None:
        self.job_id = job_id
        self.rounds = rounds
        self.metrics = metrics  # [(peer, round, {name: value})]
        self.attempt = attempt  # 0 = first attempt succeeded (no restart)
        # With job.ft: {"epoch", "active", "suspected", "departed", "rejoins"}.
        self.ft = ft


class _RunContext:
    """Everything one attempt's supervision needs."""

    def __init__(self) -> None:
        self.job: DiLoCoJob | None = None
        self.ft = None  # the job's FTConfig when elastic
        self.base_id = ""
        self.updates_tag = ""
        self.results_tag = ""
        self.handles: dict[str, WorkerHandle] = {}
        # One entry per parameter-server shard: its handle (None while it
        # restarts), job id, peer, updates tag and aggregate spec.
        self.ps_handles: list = []
        self.ps_job_ids: list[str] = []
        self.ps_peers: list[str] = []
        self.shard_tags: list[str] = []
        self.ps_specs: list[JobSpec] = []
        # The placement workers route by (None: one server, no groups) and
        # the tree-reduce plan, [reducer, *members] each.
        self.shard_map: "ShardMap | None" = None
        self.reduce_groups: list = []
        self.router: StatusRouter | None = None
        self.tracker: ProgressTracker | None = None
        self.data_scheduler: DataScheduler | None = None
        self.complete: asyncio.Event | None = None
        self.activity: list[float] = []
        self.status_timeout: float | None = None
        self.auction_timeout = 2.0
        self.detector: PhiAccrualDetector | None = None
        self.membership: MembershipView | None = None
        # Straggler-adaptive inner steps (job.adaptive_steps), and the last
        # round whose assignments were published.
        self.adaptive: "StragglerController | None" = None
        self.assign_published = -1
        self.rejoin_count = 0
        self.notify_tasks: set = set()
        self.ps_restarts = 0
        self.ps_restarting: set = set()
        # The longest silence between two progress messages, and the
        # least deadline the watchdog held: logged when the job completes.
        self.progress_gap_max_s = 0.0
        self.watchdog_min_s = float("inf")
        # Scheduler recovery: the journal (None when off), the adoption
        # grace stamped into the dispatched specs, the batch scheduler and
        # the last round journaled.
        self.dur: "DurableScheduler | None" = None
        self.adopt_grace: "float | None" = None
        self.batch_scheduler: "BatchScheduler | None" = None
        self.round_journaled = -1


class Orchestrator:
    def __init__(
        self,
        node: Node,
        metrics_connector: MetricsConnector | None = None,
    ) -> None:
        self.node = node
        self.allocator = GreedyWorkerAllocator(node)
        self.metrics_bridge = MetricsBridge(metrics_connector)
        # The reference's FT_METRICS counts of scheduler recovery.
        self.counts = {"scheduler_recoveries": 0, "adopted_executions": 0,
                       "stale_generation_dropped": 0}

    # ------------------------------------------------------------ allocation

    @staticmethod
    def _train_worker_spec(job: DiLoCoJob) -> WorkerSpec:
        return WorkerSpec(
            resources=job.resources.worker,
            executor=[
                ExecutorDescriptor(executor_class="train", name=TRAIN_EXECUTOR_NAME)
            ],
        )

    async def _allocate_train(
        self, job: DiLoCoJob, *, auction_timeout: float, attempts: int
    ) -> list:
        res = job.resources
        train_spec = self._train_worker_spec(job)
        for attempt in range(attempts):
            offers = await self.allocator.request(
                train_spec, res.worker_price, auction_timeout, res.num_workers
            )
            if len(offers) >= res.num_workers:
                return offers[: res.num_workers]
            log.warning(
                "auction %d/%d: %d/%d train offers",
                attempt + 1, attempts, len(offers), res.num_workers,
            )
        raise AllocationError(f"could not allocate {res.num_workers} train workers")

    async def _allocate_ps(
        self, job: DiLoCoJob, taken: set, *, auction_timeout: float, attempts: int,
        count: int = 1,
    ) -> list:
        """Auction ``count`` parameter-server (shard) executions. Distinct
        peers first, distinct from the train workers and then from each
        other, so each shard's traffic leaves its own NIC; a peer already
        sold as a train worker hosts one when its capacity covers both
        leases, and peers are reused round-robin when the mesh is small."""
        res = job.resources
        ps_spec = WorkerSpec(
            resources=res.parameter_server,
            executor=[
                ExecutorDescriptor(executor_class="aggregate", name=AGGREGATE_EXECUTOR_NAME)
            ],
        )
        for _attempt in range(attempts):
            offers = await self.allocator.request(
                ps_spec, res.parameter_server_price, auction_timeout, count + len(taken)
            )
            if not offers:
                continue
            distinct = [o for o in offers if o.peer_id not in taken]
            ranked = distinct + [o for o in offers if o.peer_id in taken]
            picked: list = []
            seen: set = set()
            for offer in ranked:  # one offer per distinct peer first
                if offer.peer_id not in seen:
                    picked.append(offer)
                    seen.add(offer.peer_id)
                if len(picked) == count:
                    return picked
            while picked and len(picked) < count:
                picked.append(ranked[len(picked) % len(ranked)])
            if len(picked) == count:
                return picked
        raise AllocationError(f"could not allocate {count} parameter server shard(s)")

    @staticmethod
    def batch_size_for(offered, required, max_batch: int | None) -> int:
        """floor(offered/required) on the accelerator axis, clamped
        (hypha-scheduler.rs:320-322 sizes by gpu; tpu chips when the job
        asks for them)."""
        if required.tpu > 0:
            size = int(offered.tpu // required.tpu)
        elif required.gpu > 0:
            size = int(offered.gpu // required.gpu)
        else:
            size = max_batch or 1
        size = max(1, size)
        if max_batch is not None:
            size = min(size, max_batch)
        return size

    # ------------------------------------------------------------------ run

    async def run(
        self,
        job: DiLoCoJob,
        *,
        auction_timeout: float = 2.0,
        allocation_attempts: int = 3,
        status_timeout: float | None = None,
        max_attempts: int = 1,
        retry_backoff: float = 11.0,
    ) -> JobResult:
        """Run the job; with ``max_attempts > 1``, a failed attempt is
        re-run from scratch against whatever workers the auction finds, and
        a job with a ``checkpoint_dir`` warm-starts it from the last
        completed round. With ``job.ft``, single train-worker failures
        never reach this level: they degrade the round and trigger a
        rejoin. ``retry_backoff`` defaults past the 10 s lease TTL so the failed
        attempt's leases lapse and the surviving workers' capacity frees
        before re-auctioning. ``status_timeout=None`` uses the per-round
        adaptive watchdog (simulation-projected round time).
        """
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        last: JobFailed | AllocationError | None = None
        sched_root = self._scheduler_root(job)
        for attempt in range(max_attempts):
            if attempt:
                log.warning(
                    "job attempt %d/%d failed (%s); retrying in %.0fs",
                    attempt, max_attempts, last, retry_backoff,
                )
                await asyncio.sleep(retry_backoff)
            # A journal left by a dead predecessor: its executions may still
            # be training, so adopt them in place. An adoption failure falls
            # back to the fresh run below, which wipes the stale journal.
            if attempt == 0 and sched_root is not None and DurableScheduler.has_state(sched_root):
                try:
                    result = await self._resume_once(
                        job, auction_timeout=auction_timeout, status_timeout=status_timeout)
                    result.attempt = attempt
                    return result
                except AdoptionFailed as e:
                    log.warning("scheduler recovery could not adopt the previous attempt (%s); "
                                "falling back to a fresh run", e)
                except (JobFailed, AllocationError) as e:
                    last = e
                    continue
            try:
                result = await self._run_once(
                    job,
                    auction_timeout=auction_timeout,
                    allocation_attempts=allocation_attempts,
                    status_timeout=status_timeout,
                )
                result.attempt = attempt
                return result
            except (JobFailed, AllocationError) as e:
                last = e
        assert last is not None
        raise last

    @staticmethod
    def _scheduler_root(job: DiLoCoJob) -> "Path | None":
        if job.scheduler_recovery and job.checkpoint_dir and job.ft is not None \
                and job.ft.enabled:
            return Path(job.checkpoint_dir) / "scheduler"
        return None

    @staticmethod
    def _adopt_grace(ft) -> float:
        return (ft.scheduler_adopt_grace_s if ft.scheduler_adopt_grace_s is not None
                else DEFAULT_ADOPT_GRACE_S)

    # ------------------------------------------------------------- job specs

    def _train_spec(self, ctx: _RunContext, suffix: str, handle: WorkerHandle,
                    rejoin: bool = False) -> JobSpec:
        job = ctx.job
        # Placement peers, not live handles: a worker dispatched while a
        # shard restarts still wires every shard's results stream.
        if ctx.shard_map is not None and ctx.shard_map.shards:
            ps_peers = list(ctx.shard_map.shards)
        else:
            ps_peers = list(ctx.ps_peers)
        assert job is not None and ps_peers, "plan the streams first"
        # This worker's tree role: a group's first member folds the others
        # (reduce_members); the rest push through it (reduce_via). A
        # mid-tree reducer gets both.
        reduce_via = None
        reduce_members: list = []
        for group in ctx.reduce_groups:
            if handle.peer_id == group[0]:
                reduce_members = list(group[1:])
            elif handle.peer_id in group:
                reduce_via = group[0]
        # Broadcast tree: reducers relay the results down their subtree, and
        # any ancestor can be the hop that delivers (around a dead relay
        # too), so every worker's allowlist admits its whole chain.
        tree_on = bool(job.broadcast_tree) and bool(ctx.reduce_groups)
        results_peers = list(ps_peers)
        if tree_on:
            results_peers += [a for a in ancestors_of(ctx.reduce_groups, handle.peer_id)
                              if a not in results_peers]
        # The input pipeline's window, resolved here so the trainer's
        # prefetcher, the fetch reference and the data scheduler's slice
        # retirement see one number. None (the pipeline off) stamps no field.
        prefetch_depth = ((job.prefetch_slices or DEFAULT_PREFETCH_SLICES)
                          if job.input_pipeline else None)
        return JobSpec(
            job_id=f"{ctx.base_id}-{suffix}",
            executor=Executor(
                kind="train",
                name=TRAIN_EXECUTOR_NAME,
                train=TrainExecutorConfig(
                    model=job.model,
                    data=Fetch(Reference.from_scheduler(self.node.peer_id, job.dataset,
                                                        prefetch=prefetch_depth)),
                    updates=Send(Reference.from_peers([ps_peers[0]], ctx.updates_tag)),
                    results=Receive(Reference.from_peers(results_peers, ctx.results_tag)),
                    ps_shards=ctx.shard_map,
                    reduce_via=reduce_via,
                    reduce_members=reduce_members,
                    relay_results=True if tree_on and reduce_members else None,
                    optimizer=job.inner_optimizer,
                    batch_size=handle.batch_size,
                    preprocessor=job.preprocessor,
                    scheduler=job.lr_scheduler,
                    loss=job.loss,
                    sharding=job.sharding,
                    lora=job.lora,
                    delta_dtype=job.delta_dtype,
                    delta_codec=job.delta_codec,
                    sync_mode=job.sync_mode,
                    fragments=job.num_fragments,
                    rejoin=rejoin,
                    # Workers hold their leases and park their control sends
                    # this long across a scheduler outage (None: recovery
                    # off, no new wire field).
                    adopt_grace_s=ctx.adopt_grace,
                    input_pipeline=True if prefetch_depth is not None else None,
                    prefetch_slices=prefetch_depth,
                    checkpoint=({"dir": f"{job.checkpoint_dir}/{handle.peer_id}",
                                 "every_rounds": job.checkpoint_every}
                                if job.checkpoint_dir else None),
                ),
            ),
        )

    def _plan_streams(
        self,
        ctx: _RunContext,
        job: DiLoCoJob,
        worker_peers: list[str],
        ps_peers: list[str],
        num_shards: int = 1,
        parts: "int | None" = None,
    ) -> None:
        """Derive the attempt's stream identities from its peer lists:
        job-unique tags (push routing keys on them, so several jobs, or a
        parameter server colocated with a train job, can share worker
        nodes), per-shard job ids and updates tags, the tree-reduce groups,
        the ``ShardMap`` placement and the per-shard aggregate specs. A pure
        function of (base id, peers, job)."""
        if len(ps_peers) != num_shards:
            raise ValueError(f"{num_shards} parameter server shard(s), got {ps_peers}")
        if parts is None:
            parts = placement_parts(job.sync_mode, job.num_fragments, num_shards)
        ctx.ps_peers = list(ps_peers)
        ctx.updates_tag = f"updates:{ctx.base_id}"
        ctx.results_tag = f"results:{ctx.base_id}"
        if num_shards == 1:
            ctx.shard_tags = [ctx.updates_tag]
            ctx.ps_job_ids = [f"{ctx.base_id}-ps"]
        else:
            ctx.shard_tags = [f"{ctx.updates_tag}.s{k}" for k in range(num_shards)]
            ctx.ps_job_ids = [f"{ctx.base_id}-ps{k}" for k in range(num_shards)]
        # Sorted peer ids in chunks of G, reduce_tree_depth levels deep;
        # depth 1 is the single-level plan (singleton groups dropped).
        group_size = int(job.reduce_group_size or 0)
        depth = int(job.reduce_tree_depth or 0) or 1
        ctx.reduce_groups = (build_reduce_groups(worker_peers, group_size, depth)
                             if group_size >= 2 else [])
        # The placement: built for any sharded or tree-reduced job; a plain
        # single-server job ships None, the unsharded wire.
        ctx.shard_map = None
        if num_shards > 1 or ctx.reduce_groups:
            # A pure function of the job spec, effective from dispatch:
            # workers route by shard tag, never by a later round.
            ctx.shard_map = ShardMap(
                round=0, shards=list(ps_peers), tags=list(ctx.shard_tags), fragments=parts,
                groups=[list(g) for g in ctx.reduce_groups],
                tree_depth=depth if depth >= 2 else None,
            )
        # Serving followers ride the broadcast as extra leaves, never the
        # reduce groups: under a tree they hang off the relay heads
        # (stream.tree.with_serve_leaves over the placement's
        # serve_leaves); otherwise each shard pushes them (serve_peers).
        serve_peers = [str(p) for p in (job.serve_peers or [])]
        if ctx.shard_map is not None and serve_peers and job.broadcast_tree:
            ctx.shard_map.serve_leaves = list(serve_peers)
        tree = ctx.shard_map if job.broadcast_tree and ctx.reduce_groups else None
        ctx.ps_specs = [
            JobSpec(
                job_id=ctx.ps_job_ids[k],
                executor=Executor(
                    kind="aggregate",
                    name=AGGREGATE_EXECUTOR_NAME,
                    aggregate=AggregateExecutorConfig(
                        updates=Receive(Reference.from_peers(worker_peers, ctx.shard_tags[k])),
                        results=Send(Reference.from_peers(worker_peers, ctx.results_tag)),
                        optimizer=job.outer_optimizer,
                        num_workers=len(worker_peers),
                        checkpoint_dir=((f"{job.checkpoint_dir}/ps" if num_shards == 1
                                         else f"{job.checkpoint_dir}/ps{k}")
                                        if job.checkpoint_dir else None),
                        ps_checkpoint_every_rounds=job.ps_checkpoint_every_rounds,
                        quorum_fraction=ctx.ft.quorum_fraction if ctx.ft else 0.0,
                        round_deadline_s=ctx.ft.round_deadline_s if ctx.ft else 0.0,
                        delta_codec=job.delta_codec,
                        sync_mode=job.sync_mode,
                        fragments=job.num_fragments,
                        shard_index=k,
                        num_ps_shards=num_shards,
                        # The adaptive knobs are None, not False, when off:
                        # a static job's spec carries no new field.
                        adaptive_steps=True if job.adaptive_steps else None,
                        adaptive_codec=True if job.adaptive_codec else None,
                        codec_bw_hi_mbps=job.codec_bw_hi_mbps if job.adaptive_codec else None,
                        codec_bw_lo_mbps=job.codec_bw_lo_mbps if job.adaptive_codec else None,
                        broadcast_tree=tree,
                        serve_peers=serve_peers or None,
                        # The server parks its UPDATED notify, broadcast
                        # first, across a scheduler outage.
                        adopt_grace_s=ctx.adopt_grace,
                    ),
                ),
            )
            for k in range(num_shards)
        ]

    @staticmethod
    def _plan_record(ctx: _RunContext, ps_peers: list) -> dict:
        """The journaled plan: what ``_plan_streams`` cannot re-derive (the
        base id, the peers) and the lease and batch bindings adoption needs."""
        return {
            "base_id": ctx.base_id,
            "workers": {peer: {"lease_id": h.lease_id, "batch_size": h.batch_size}
                        for peer, h in ctx.handles.items()},
            "ps_peers": list(ps_peers),
        }

    @staticmethod
    async def _journal_dispatch(ctx: _RunContext, job_id: str, handle: WorkerHandle, kind: str,
                                shard: "int | None" = None) -> None:
        if ctx.dur is None:
            return
        # Off the loop: the record is fsync'd.
        await asyncio.to_thread(ctx.dur.note_dispatch, job_id, handle.peer_id, handle.lease_id,
                                kind, shard, handle.batch_size or None)

    @staticmethod
    def _journal_round_soon(ctx: _RunContext) -> None:
        """Journal a frontier advance off the loop, fire and forget (a lost
        round record costs re-deriving one round from the AdoptAcks)."""
        if ctx.dur is None or ctx.tracker is None or ctx.tracker.round <= ctx.round_journaled:
            return
        ctx.round_journaled = ctx.tracker.round
        ctrl = ctx.adaptive.snapshot() if ctx.adaptive is not None else None
        aio.spawn(asyncio.to_thread(ctx.dur.note_round, ctx.tracker.round, ctrl),
                  tasks=ctx.notify_tasks, what="scheduler journal round", logger=log)

    async def _start_data(self, ctx: _RunContext, job: DiLoCoJob) -> None:
        """Dataset discovery + slice scheduler (hypha-scheduler.rs:269,435-457)."""
        raw = await self.node.get_record(job.dataset)
        if raw is None:
            raise JobFailed(f"no data record for dataset {job.dataset!r}")
        record = messages.decode(raw)
        if not isinstance(record, DataRecord):
            raise JobFailed(f"bad data record {record!r}")
        providers = await self.node.find_providers(job.dataset)
        if not providers:
            raise JobFailed(f"no provider for dataset {job.dataset!r}")
        ctx.data_scheduler = DataScheduler(
            self.node, providers[0], job.dataset, record.num_slices
        )
        ctx.data_scheduler.start()

    @staticmethod
    def _make_adaptive(ctx: _RunContext, job: DiLoCoJob) -> None:
        """The straggler controller of an ``adaptive_steps`` job; its base is
        what a uniform pool runs a round: the round's samples over one sweep
        of the fleet's batch sizes."""
        if not job.adaptive_steps:
            return
        total_batch = sum(h.batch_size for h in ctx.handles.values())
        ctx.adaptive = StragglerController(base_steps=max(
            1, round(job.rounds.avg_samples_between_updates / max(total_batch, 1))))

    def _start_control(self, ctx: _RunContext, num_shards: int = 1, parts: int = 1,
                       generation: "int | None" = None):
        """Stand up the DiLoCo control plane: BatchScheduler + the
        /hypha-progress handler; a sharded round advances on UPDATED from
        every due shard. ``generation`` is None on a fresh run (unstamped
        responses) and the bumped generation on recovery. Returns
        (collected_metrics, registration)."""
        ctx.complete = asyncio.Event()
        collected: list = []
        ctx.activity = [asyncio.get_running_loop().time()]  # watchdog feed

        def on_metrics(peer: str, round_num: int, metrics: dict) -> None:
            collected.append((peer, round_num, metrics))
            self.metrics_bridge.on_metrics(peer, round_num, metrics)

        sync_mode = ctx.job.sync_mode if ctx.job is not None else "blocking"
        batch_scheduler = BatchScheduler(
            ctx.tracker, on_metrics=on_metrics, on_complete=ctx.complete.set,
            shards_due=((lambda r: shards_due_at(sync_mode, r, parts, num_shards))
                        if num_shards > 1 else None),
            adaptive=ctx.adaptive,
            generation=generation,
        )
        ctx.batch_scheduler = batch_scheduler

        async def on_progress(peer: str, progress: Progress):
            # Every progress message, from any peer, resets the watchdog.
            now = asyncio.get_running_loop().time()
            ctx.progress_gap_max_s = max(ctx.progress_gap_max_s, now - ctx.activity[0])
            ctx.activity[0] = now
            if ctx.detector is not None:
                # Every progress message is a liveness signal.
                ctx.detector.heartbeat(peer)
            response = batch_scheduler.on_progress(peer, progress)
            self._journal_round_soon(ctx)
            if (ctx.adaptive is not None and ctx.membership is not None
                    and ctx.tracker.round > ctx.assign_published):
                # A round advanced: publish its assignments with the
                # membership (a lost snapshot is repaired by the next).
                ctx.assign_published = ctx.tracker.round
                self._notify_membership_soon(ctx)
            return response

        progress_reg = self.node.on(PROTOCOL_PROGRESS, Progress).respond_with(on_progress)
        return collected, progress_reg

    async def _run_once(
        self,
        job: DiLoCoJob,
        *,
        auction_timeout: float = 2.0,
        allocation_attempts: int = 3,
        status_timeout: float | None = None,
    ) -> JobResult:
        ft = job.ft if (job.ft is not None and job.ft.enabled) else None
        log.info("auctioning %d train workers", job.resources.num_workers)
        worker_offers = await self._allocate_train(
            job, auction_timeout=auction_timeout, attempts=allocation_attempts
        )
        ctx = _RunContext()
        ctx.job = job
        ctx.ft = ft
        ctx.status_timeout = status_timeout
        ctx.auction_timeout = auction_timeout
        sched_root = self._scheduler_root(job)
        if sched_root is not None:
            ctx.adopt_grace = self._adopt_grace(ft)
        progress_reg = None
        tasks: list[Task] = []
        try:
            # Acceptance: first renewal converts each temp lease — must happen
            # within the 500 ms offer window, so BEFORE the PS auction runs
            # (worker.rs:75; rfc/2025-08-04 "Lease Renewal"). Bounded
            # fan-out, not a serial walk; insertion stays in offer order so
            # worker indices are deterministic. Handles are recorded as they
            # are created, so if one offer fails mid-fan-out the siblings
            # already created still reach ctx.handles and the cleanup below
            # releases their leases instead of leaking them until expiry.
            created: "list[WorkerHandle | None]" = [None] * len(worker_offers)

            async def _create(i: int, offer) -> None:
                created[i] = await WorkerHandle.create(self.node, offer)

            try:
                await aio.gather_bounded(
                    [
                        (lambda i=i, o=offer: _create(i, o))
                        for i, offer in enumerate(worker_offers)
                    ],
                    limit=16,
                )
            finally:
                for handle in created:
                    if handle is not None:
                        ctx.handles[handle.peer_id] = handle
            num_shards = max(int(job.num_ps_shards or 1), 1)
            ps_offers = await self._allocate_ps(
                job, set(ctx.handles),
                auction_timeout=auction_timeout, attempts=allocation_attempts,
                count=num_shards,
            )
            for offer in ps_offers:
                ctx.ps_handles.append(await WorkerHandle.create(self.node, offer))

            for handle in ctx.handles.values():
                handle.batch_size = self.batch_size_for(
                    handle.offer.resources,
                    job.resources.worker,
                    job.rounds.max_batch_size,
                )

            await self._start_data(ctx, job)

            ctx.tracker = ProgressTracker(
                parameter_server=[h.peer_id for h in ctx.ps_handles],
                update_target=job.rounds.avg_samples_between_updates,
                update_epochs=job.rounds.update_rounds,
            )
            for peer, handle in ctx.handles.items():
                ctx.tracker.add_worker(peer, handle.batch_size)

            if ft is not None:
                ctx.detector = PhiAccrualDetector(threshold=ft.phi_threshold)
                ctx.membership = MembershipView(list(ctx.handles))
                for handle in ctx.handles.values():
                    handle.on_renew = ctx.detector.heartbeat

            parts = placement_parts(job.sync_mode, job.num_fragments, num_shards)
            self._make_adaptive(ctx, job)
            collected, progress_reg = self._start_control(ctx, num_shards, parts)

            ctx.router = StatusRouter(self.node)
            ctx.base_id = str(uuid.uuid4())
            self._plan_streams(
                ctx, job, list(ctx.handles), [h.peer_id for h in ctx.ps_handles],
                num_shards, parts,
            )
            if sched_root is not None:
                # Opened fresh (an earlier attempt's journal must not be
                # adopted against this attempt's executions), and the plan
                # persisted before anything runs.
                ctx.dur = await asyncio.to_thread(DurableScheduler.open, sched_root, fresh=True)
                await asyncio.to_thread(
                    ctx.dur.note_plan,
                    self._plan_record(ctx, [h.peer_id for h in ctx.ps_handles]))
            for k, (spec, ps_handle) in enumerate(zip(ctx.ps_specs, ctx.ps_handles)):
                tasks.append(await Task.dispatch(self.node, ctx.router, spec, [ps_handle]))
                await self._journal_dispatch(ctx, spec.job_id, ps_handle, "aggregate", shard=k)
            # Train dispatches fan out with bounded concurrency (each is
            # an independent request to a distinct peer); the journal takes
            # them in worker order afterwards.
            pairs = [(self._train_spec(ctx, f"w{i}", handle), handle)
                     for i, handle in enumerate(ctx.handles.values())]
            dispatched = await aio.gather_bounded(
                [(lambda s=spec, h=handle: Task.dispatch(self.node, ctx.router, s, [h]))
                 for spec, handle in pairs],
                limit=8,
            )
            for (spec, handle), task in zip(pairs, dispatched):
                tasks.append(task)
                await self._journal_dispatch(ctx, spec.job_id, handle, "train")
            log.info("job %s dispatched: parameter server on %s, train on %s", ctx.base_id,
                     [h.peer_id for h in ctx.ps_handles], list(ctx.handles))

            await self._supervise(ctx, tasks)
            return await self._finish(ctx, collected)
        finally:
            await self._teardown(ctx, progress_reg)

    async def _finish(self, ctx: _RunContext, collected: list) -> JobResult:
        """The job completed: log, wipe the scheduler journal (a finished
        job must not be adopted by the next run), and report."""
        log.info("job %s: largest progress gap %.3f s; the watchdog's least deadline "
                 "%.3f s", ctx.base_id, ctx.progress_gap_max_s, ctx.watchdog_min_s)
        ft_summary = None
        if ctx.membership is not None:
            snap = ctx.membership.snapshot()
            ft_summary = {"epoch": snap.epoch, "active": snap.active,
                          "suspected": snap.suspected, "departed": snap.departed,
                          "rejoins": ctx.rejoin_count, "ps_restarts": ctx.ps_restarts}
        if ctx.dur is not None:
            journal = ctx.dur.journal
            dropped = ctx.batch_scheduler.stale_generation_dropped if ctx.batch_scheduler else 0
            log.info("job %s: scheduler journal generation %d, %d records, %d bytes; "
                     "recovery counts %s", ctx.base_id, ctx.dur.generation,
                     journal.records_written, journal.bytes_written,
                     {**self.counts, "stale_generation_dropped":
                      self.counts["stale_generation_dropped"] + dropped})
            await asyncio.to_thread(ctx.dur.complete)
        return JobResult(ctx.base_id, ctx.tracker.round, collected, ft=ft_summary)

    async def _teardown(self, ctx: _RunContext, progress_reg) -> None:
        """Release what one attempt held (also when it was cancelled: a
        killed scheduler leaves its journal for its successor)."""
        for task in ctx.notify_tasks:
            task.cancel()
        if ctx.notify_tasks:
            await asyncio.gather(*list(ctx.notify_tasks), return_exceptions=True)
        if ctx.batch_scheduler is not None:
            self.counts["stale_generation_dropped"] += \
                ctx.batch_scheduler.stale_generation_dropped
        if ctx.dur is not None:
            await asyncio.to_thread(ctx.dur.close)
        if progress_reg is not None:
            progress_reg.close()
        if ctx.data_scheduler is not None:
            ctx.data_scheduler.stop()
        if ctx.router is not None:
            ctx.router.close()
        for handle in ctx.handles.values():
            await handle.release()
        for ps_handle in ctx.ps_handles:
            if ps_handle is not None:
                await ps_handle.release()
        await self.metrics_bridge.close()

    # --------------------------------------------------- scheduler recovery

    async def _adopt_executions(self, ctx: _RunContext, records: dict, round_hint: int,
                                deadline_s: float, clock=None) -> dict:
        """The SchedulerHello/AdoptAck handshake over the API protocol.
        ``records`` maps job id -> {"peer": ...}. Unanswered peers are asked
        again, every sweep at once and each request bounded by what is left
        of ``deadline_s`` (``clock`` injects the time), until they answer
        (``running``, ``gone`` or ``stale``) or the deadline passes; the
        caller sends the rest down the depart or shard-restart path.
        Returns job id -> AdoptAck."""
        assert ctx.dur is not None
        now = clock or asyncio.get_running_loop().time
        stop_at = now() + max(deadline_s, 0.0)
        acks: dict = {}
        pending = dict(records)

        async def ask(job_id: str, rec: dict, timeout: float) -> tuple:
            hello = SchedulerHello(generation=ctx.dur.generation, job_id=job_id,
                                   round=round_hint)
            try:
                resp = await self.node.request(str(rec.get("peer", "")), PROTOCOL_API, hello,
                                               timeout=timeout)
            except (RequestError, OSError, asyncio.TimeoutError) as e:
                log.info("adoption hello for %s failed: %s", job_id, e)
                return job_id, None
            return job_id, resp if isinstance(resp, AdoptAck) else None

        first_pass = True
        while pending and (first_pass or now() < stop_at):
            first_pass = False
            timeout = min(5.0, max(stop_at - now(), 0.5))
            for job_id, resp in await asyncio.gather(
                    *(ask(job_id, rec, timeout) for job_id, rec in pending.items())):
                if resp is None:
                    continue
                acks[job_id] = resp
                rec = pending.pop(job_id, None) or {}
                if resp.state == "running":
                    self.counts["adopted_executions"] += 1
                log.info("adoption: %s on %s answered %s (round %d, epoch %d)", job_id,
                         rec.get("peer", ""), resp.state, resp.round, resp.epoch)
            if pending and now() < stop_at:
                await asyncio.sleep(0.3)
        return acks

    async def _resume_once(self, job: DiLoCoJob, *, auction_timeout: float = 2.0,
                           status_timeout: float | None = None) -> JobResult:
        """Adopt a dead predecessor's executions instead of re-auctioning.

        The journal gives the plan (every stream identity re-derives from
        the base id), the live dispatches and the last frontier; the fleet
        gives the truth: each AdoptAck reports its execution's round, so
        the scheduler fast-forwards to where training is (a round that
        closed during the outage is never run again). An execution whose
        lease re-arm fails or whose ack does not come by the deadline goes
        down the depart/rejoin (train) or shard-restart path once
        supervision starts."""
        ft = job.ft if (job.ft is not None and job.ft.enabled) else None
        sched_root = self._scheduler_root(job)
        assert ft is not None and sched_root is not None
        try:
            dur = await asyncio.to_thread(DurableScheduler.open, sched_root)
        except Exception as e:
            raise AdoptionFailed(f"scheduler journal unreadable: {e}") from e
        if dur.resume is None:
            await asyncio.to_thread(dur.close)
            raise AdoptionFailed("journal holds no adoptable plan")
        res = dur.resume
        ctx = _RunContext()
        ctx.job, ctx.ft, ctx.dur = job, ft, dur
        ctx.status_timeout = status_timeout
        ctx.auction_timeout = auction_timeout
        ctx.adopt_grace = self._adopt_grace(ft)
        ctx.base_id = res.base_id
        ctx.rejoin_count = res.rejoins
        ctx.ps_restarts = res.ps_restarts
        num_shards = max(int(job.num_ps_shards or 1), 1)
        parts = placement_parts(job.sync_mode, job.num_fragments, num_shards)
        plan_workers: dict = dict(res.plan.get("workers") or {})
        ps_peers = [str(p) for p in (res.plan.get("ps_peers") or [])]
        if not plan_workers or len(ps_peers) != num_shards:
            await asyncio.to_thread(dur.close)
            raise AdoptionFailed("journaled plan is incomplete")
        log.warning("scheduler recovery: generation %d adopting job %s at round %d (%d "
                    "journaled executions)", dur.generation, ctx.base_id, res.round,
                    len(res.dispatches))
        progress_reg = None
        tasks: list[Task] = []
        try:
            # The original worker set re-derives the tags, groups and specs
            # the live executions were dispatched with.
            self._plan_streams(ctx, job, sorted(plan_workers), ps_peers, num_shards, parts)
            # The newest dispatch of each execution; a train record of a
            # departed peer (a rejoin superseded it) is skipped through the
            # journaled membership's active list.
            member = res.member or {}
            active = [str(p) for p in (member.get("active") or sorted(plan_workers))]
            lease_ids = {peer: str(rec.get("lease_id", "")) for peer, rec in plan_workers.items()}
            batch_sizes = {peer: int(rec.get("batch_size", 1) or 1)
                           for peer, rec in plan_workers.items()}
            train_jobs: dict = {}  # peer -> job id
            for job_id, rec in res.dispatches.items():
                if rec.get("kind") != "train":
                    continue
                peer = str(rec.get("peer", ""))
                train_jobs[peer] = job_id
                lease_ids[peer] = str(rec.get("lease_id", ""))
                if rec.get("batch_size"):
                    batch_sizes[peer] = int(rec["batch_size"])
            # Re-arm the journaled leases: the workers held them through the
            # outage (the adoption grace), so the first renewal resumes
            # liveness where the dead loop stopped.
            dead_workers: list = []
            for peer in active:
                if peer not in lease_ids or peer not in train_jobs:
                    dead_workers.append(peer)
                    continue
                try:
                    handle = await WorkerHandle.adopt(self.node, peer, lease_ids[peer])
                except (RequestError, OSError, asyncio.TimeoutError) as e:
                    log.warning("adoption: lease re-arm for %s failed: %s", peer, e)
                    dead_workers.append(peer)
                    continue
                handle.batch_size = batch_sizes.get(peer, 1)
                ctx.handles[peer] = handle
            ctx.ps_handles = [None] * num_shards
            for k, ps_job_id in enumerate(ctx.ps_job_ids):
                rec = res.dispatches.get(ps_job_id)
                if rec is None:
                    continue
                try:
                    ctx.ps_handles[k] = await WorkerHandle.adopt(
                        self.node, str(rec.get("peer", "")), str(rec.get("lease_id", "")))
                except (RequestError, OSError, asyncio.TimeoutError) as e:
                    log.warning("adoption: lease re-arm for ps shard %d failed: %s", k, e)
            if not ctx.handles and all(h is None for h in ctx.ps_handles):
                raise AdoptionFailed("nothing alive to adopt")

            hello_records = {train_jobs[peer]: {"peer": peer} for peer in ctx.handles}
            for k, ps_job_id in enumerate(ctx.ps_job_ids):
                if ctx.ps_handles[k] is not None:
                    hello_records[ps_job_id] = {
                        "peer": (res.dispatches.get(ps_job_id) or {}).get("peer", "")}
            deadline_s = (ft.scheduler_adopt_deadline_s
                          if ft.scheduler_adopt_deadline_s is not None
                          else DEFAULT_ADOPT_DEADLINE_S)
            acks = await self._adopt_executions(ctx, hello_records, res.round, deadline_s)
            running = {job_id: ack for job_id, ack in acks.items()
                       if ack.ok and ack.state == "running"}
            # A finished job adopted post mortem: every execution is gone and
            # the journal's frontier covers the plan.
            if not running and res.round >= job.rounds.update_rounds:
                await asyncio.to_thread(dur.complete)
                return JobResult(ctx.base_id, res.round, [])
            if not running:
                raise AdoptionFailed("no execution answered the hello")

            await self._start_data(ctx, job)
            ctx.tracker = ProgressTracker(
                parameter_server=ps_peers,
                update_target=job.rounds.avg_samples_between_updates,
                update_epochs=job.rounds.update_rounds,
            )
            ctx.detector = PhiAccrualDetector(threshold=ft.phi_threshold)
            # The dead peers are tracked and members too: the prelude sends
            # them down _depart once supervision starts.
            members: list = []
            for peer in active:
                if peer in ctx.handles or peer in dead_workers:
                    ctx.tracker.add_worker(peer, batch_sizes.get(peer, 1))
                    members.append(peer)
            ctx.membership = MembershipView(members)
            # Past the journaled epoch: the first push after the restart
            # supersedes what the servers adopted (they gate on the epoch).
            ctx.membership.epoch = int(member.get("epoch", 0)) + 1
            ctx.membership.departed = {str(p) for p in (member.get("departed") or [])}
            for handle in ctx.handles.values():
                handle.on_renew = ctx.detector.heartbeat
            self._make_adaptive(ctx, job)
            collected, progress_reg = self._start_control(ctx, num_shards, parts,
                                                          generation=dur.generation)
            ctx.router = StatusRouter(self.node)
            # Fast-forward, never rewind: an adopted shard's round is an
            # UPDATED the predecessor processed or that died with it.
            shard_rounds = {k: running[ps_job_id].round
                            for k, ps_job_id in enumerate(ctx.ps_job_ids)
                            if ps_job_id in running}
            assert ctx.batch_scheduler is not None
            adopted_round = ctx.batch_scheduler.adopt_round(res.round, shard_rounds,
                                                            ctrl=res.ctrl)
            ctx.round_journaled = adopted_round
            await asyncio.to_thread(ctx.dur.note_round, adopted_round,
                                    ctx.adaptive.snapshot() if ctx.adaptive is not None
                                    else None)
            self.counts["scheduler_recoveries"] += 1
            log.warning("scheduler recovery: adopted %d/%d executions, fast-forwarded round "
                        "%d -> %d", len(running), len(hello_records), res.round, adopted_round)
            # The adopted jobs' statuses on the existing channels: no
            # re-dispatch, the jobs are running.
            for job_id in running:
                tasks.append(Task.attach(ctx.router, job_id))
            # The fleet's membership under the new epoch.
            self._notify_membership_soon(ctx)

            async def prelude(add) -> None:
                for peer in list(ctx.membership.active):
                    job_id = train_jobs.get(peer)
                    if job_id is None or job_id not in running:
                        await self._depart(ctx, peer, "no adoption ack", add)
                for k, ps_job_id in enumerate(ctx.ps_job_ids):
                    if ps_job_id not in running:
                        self._request_ps_restart(ctx, k, "no adoption ack", add)

            await self._supervise(ctx, tasks, prelude=prelude)
            return await self._finish(ctx, collected)
        finally:
            await self._teardown(ctx, progress_reg)

    # ------------------------------------------------------------ supervision

    def _effective_timeout(self, ctx: _RunContext) -> float:
        """Per-round no-progress deadline.

        Explicit ``status_timeout`` wins. Otherwise, once every tracked
        worker has batch-timing statistics, the synchronization simulation
        projects a full round from scratch and the deadline is
        ``clamp(5 × projected, 60 s, 600 s)`` — recomputed every tick, so
        it tracks speed changes.
        """
        if ctx.status_timeout is not None:
            return ctx.status_timeout
        tracker = ctx.tracker
        if tracker is None or not tracker.has_full_stats():
            return DEFAULT_STATUS_TIMEOUT
        projection = project(
            tracker.update_target,
            tracker.sims(fresh=True),
            time_cap_ms=float("inf"),
            updates_cap=1_000_000_000,
        )
        deadline = ROUND_DEADLINE_FACTOR * projection.time_ms / 1000.0
        return min(max(deadline, ROUND_DEADLINE_FLOOR_S), DEFAULT_STATUS_TIMEOUT)

    async def _watch_status(self, task: Task) -> tuple[str, str, str]:
        """Resolve when ``task`` reports failed/cancelled on some worker."""
        while True:
            peer, status = await task.next_status()
            log.info("job %s on %s: %s %s",
                     status.job_id, peer, status.state, status.message)
            if status.state == "failed":
                return peer, status.job_id, status.message or "failed"
            if status.state == "cancelled":
                return peer, status.job_id, "cancelled"

    async def _supervise(self, ctx: _RunContext, tasks: list[Task], prelude=None) -> None:
        """Wait for completion; tolerate a train worker's loss when elastic.

        Failure signals: per-task failed/cancelled job statuses, per-handle
        lease-renewal failures and (elastic only) φ-accrual suspicion,
        polled every tick. Without ``job.ft`` any failure aborts the
        attempt (hypha-scheduler.rs:372-412 select loop). A parameter
        server failure restarts it when the job allows (else aborts). The
        no-PROGRESS watchdog resets on every progress message, so a long
        but steadily-reporting job is never killed."""
        assert ctx.complete is not None
        waiters: dict[asyncio.Task, tuple[str, Any]] = {}

        def add(kind: str, payload: Any, coro) -> None:
            waiters[asyncio.create_task(coro, name=kind)] = (kind, payload)

        add("complete", None, ctx.complete.wait())
        for task in tasks:
            add("status", task, self._watch_status(task))
        for handle in ctx.handles.values():
            add("worker", handle, _await_failure(handle))
        for ps_handle in ctx.ps_handles:
            if ps_handle is not None:
                add("ps-worker", ps_handle, _await_failure(ps_handle))
        loop = asyncio.get_running_loop()
        try:
            if prelude is not None:
                # After an adoption: the executions whose AdoptAck never
                # came enter the failure paths, watched by the same `add`.
                await prelude(add)
            while True:
                timeout_s = self._effective_timeout(ctx)
                ctx.watchdog_min_s = min(ctx.watchdog_min_s, timeout_s)
                last = ctx.activity[0] if ctx.activity else loop.time()
                remaining = (last + timeout_s) - loop.time()
                if remaining <= 0:
                    raise JobFailed(f"no progress in {timeout_s:.0f}s")
                done, _ = await asyncio.wait(
                    waiters,
                    timeout=min(remaining, 1.0),
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if ctx.membership is not None:
                    self._poll_suspicion(ctx)
                if not done:
                    continue  # re-check the watchdog, keep waiting
                # Completion wins ties: when a worker's lease-renewal failure
                # lands in the same asyncio.wait round as job completion
                # (plausible during teardown), the job must not be reported
                # failed and re-executed.
                if any(waiters[t][0] == "complete" for t in done):
                    return
                for t in done:
                    kind, payload = waiters.pop(t)
                    if t.cancelled():
                        # A released handle's failure future (its peer
                        # already departed through another signal).
                        continue
                    if kind == "status":
                        peer, job_id, reason = t.result()
                        if job_id in ctx.ps_job_ids:
                            self._request_ps_restart(
                                ctx, ctx.ps_job_ids.index(job_id),
                                f"{job_id} failed on {peer}: {reason}", add)
                        elif ctx.ft is None:
                            raise JobFailed(f"{job_id} failed on {peer}: {reason}")
                        else:
                            await self._depart(ctx, peer, f"{job_id}: {reason}", add)
                    elif kind == "ps-worker":
                        if payload not in ctx.ps_handles:
                            continue  # a released handle's stale signal
                        self._request_ps_restart(
                            ctx, ctx.ps_handles.index(payload), str(t.result()), add)
                    elif kind == "worker":
                        failure = t.result()
                        if ctx.ft is None:
                            raise JobFailed(str(failure))
                        await self._depart(ctx, getattr(failure, "peer_id", ""), str(failure),
                                           add)
                    elif kind == "ps-restart":
                        ctx.ps_restarting.discard(payload)
                        revived = t.result()
                        if revived is None:
                            raise JobFailed(
                                f"parameter server shard {payload} restart failed (after "
                                f"{ctx.ps_restarts} attempt(s))")
                        handle, task = revived
                        add("status", task, self._watch_status(task))
                        add("ps-worker", handle, _await_failure(handle))
                    elif kind == "rejoin":
                        joined = t.result()
                        if joined is not None:
                            handle, task = joined
                            add("status", task, self._watch_status(task))
                            add("worker", handle, _await_failure(handle))
                        else:
                            log.warning("rejoin gave up; continuing degraded at %d active "
                                        "workers", len(ctx.membership.active)
                                        if ctx.membership else -1)
        finally:
            for t in waiters:
                t.cancel()
            await asyncio.gather(*waiters, return_exceptions=True)

    # ----------------------------------------------------- PS crash recovery

    def _request_ps_restart(self, ctx: _RunContext, shard: int, reason: str, add) -> None:
        """A parameter server failure signal: queue a restart, or fail the
        attempt. Eligible only when the job is elastic, has
        ``ps_restart_attempts`` left and a ``checkpoint_dir`` (without the
        journal a re-dispatched server would restart the round counter
        under workers mid-round). A second signal of one outage folds into
        the restart in flight."""
        if shard in ctx.ps_restarting:
            log.info("ps shard %d failure signal during restart (%s); ignored", shard, reason)
            return
        eligible = (
            ctx.ft is not None
            and ctx.ft.ps_restart_attempts > 0
            and ctx.ps_restarts < ctx.ft.ps_restart_attempts
            and ctx.job is not None
            and bool(ctx.job.checkpoint_dir)
            and len(ctx.ps_specs) > shard
        )
        if not eligible:
            raise JobFailed(f"parameter server shard {shard} failed: {reason}")
        ctx.ps_restarts += 1
        ctx.ps_restarting.add(shard)
        if ctx.dur is not None:
            # A recovered scheduler resumes the budget, not a fresh one.
            aio.spawn(asyncio.to_thread(ctx.dur.note_ps_restarts, ctx.ps_restarts),
                      tasks=ctx.notify_tasks, what="scheduler journal ps-restart", logger=log)
        log.warning("parameter server shard %d failed (%s); restart attempt %d/%d", shard,
                    reason, ctx.ps_restarts, ctx.ft.ps_restart_attempts)
        add("ps-restart", shard, self._restart_ps(ctx, shard))

    async def _restart_ps(self, ctx: _RunContext, shard: int) -> "tuple | None":
        """Re-auction the SAME peer and re-dispatch the aggregate job
        unchanged: every worker's streams name that peer, so recovery is a
        process restarting on its host, not a migration. The job finds its
        journal under its own checkpoint dir and resumes the round."""
        assert ctx.ft is not None and ctx.job is not None
        failed = ctx.ps_handles[shard]
        old_peer = failed.peer_id if failed is not None else ctx.ps_peers[shard]
        if failed is not None:
            await failed.release()
            ctx.ps_handles[shard] = None
        res = ctx.job.resources
        ps_spec = WorkerSpec(
            resources=res.parameter_server,
            executor=[ExecutorDescriptor(executor_class="aggregate", name=AGGREGATE_EXECUTOR_NAME)],
        )
        # The restarted node needs a beat to bind and re-register.
        deadline = loop_time() + max(ctx.ft.ps_restart_backoff_s, 0.1) * 20
        attempt = 0
        while loop_time() < deadline:
            if attempt:
                await asyncio.sleep(ctx.ft.ps_restart_backoff_s)
            attempt += 1
            try:
                offers = await self.allocator.request(
                    ps_spec, res.parameter_server_price, ctx.auction_timeout, 8)
            except Exception as e:
                log.warning("ps restart auction failed: %s", e)
                continue
            same = [o for o in offers if o.peer_id == old_peer]
            if not same:
                log.info("ps restart: no offer from %s yet (%d others)", old_peer, len(offers))
                continue
            handle: "WorkerHandle | None" = None
            try:
                handle = await WorkerHandle.create(self.node, same[0])
                task = await Task.dispatch(self.node, ctx.router, ctx.ps_specs[shard], [handle])
            except asyncio.CancelledError:
                if handle is not None:
                    await handle.release()
                raise
            except (RequestError, DispatchError) as e:
                log.warning("ps shard %d restart dispatch failed: %s", shard, e)
                if handle is not None:
                    await handle.release()
                continue
            ctx.ps_handles[shard] = handle
            await self._journal_dispatch(ctx, ctx.ps_specs[shard].job_id, handle, "aggregate",
                                         shard=shard)
            if ctx.membership is not None:
                # Bring the recovered server's checkpointed view up to date.
                self._notify_membership_soon(ctx)
            log.warning("parameter server shard %d restarted on %s", shard, old_peer)
            return handle, task
        return None

    # ------------------------------------------------------- elastic details

    def _poll_suspicion(self, ctx: _RunContext) -> None:
        """φ threshold crossings -> suspected; heartbeats again ->
        reinstated. Advisory (the server stops waiting past quorum but still
        takes their deltas); only peers that should be heartbeating are
        judged: one that shipped its delta (UPDATING) or finished (DONE) is
        silent by protocol."""
        assert ctx.membership is not None and ctx.detector is not None
        assert ctx.tracker is not None
        changed = False
        for peer in list(ctx.membership.active):
            if peer in ctx.tracker.peers and ctx.tracker.state(peer) in (
                    WorkerState.UPDATING, WorkerState.DONE):
                continue
            if ctx.detector.suspected(peer):
                if ctx.membership.suspect(peer):
                    log.warning("worker %s suspected (phi=%.1f >= %.1f)", peer,
                                ctx.detector.phi(peer), ctx.detector.threshold)
                    changed = True
            elif ctx.membership.reinstate(peer):
                log.info("worker %s re-healed (phi=%.1f)", peer, ctx.detector.phi(peer))
                changed = True
        if changed:
            self._notify_membership_soon(ctx)

    def _notify_membership_soon(self, ctx: _RunContext, joined: "list | None" = None) -> None:
        """Fire-and-forget membership push (a lost update is repaired by
        the next one)."""
        aio.spawn(self._notify_membership(ctx, joined), tasks=ctx.notify_tasks,
                  what="membership notify", logger=log)

    async def _notify_membership(self, ctx: _RunContext, joined: "list | None" = None) -> bool:
        """Push the current snapshot to the parameter server; False when
        the push failed. A ``joined`` notification is load-bearing: it is
        the only message that queues the rejoiner's catch-up."""
        assert ctx.membership is not None and ctx.ps_handles
        ok = True
        snapshot = ctx.membership.snapshot()
        dur = getattr(ctx, "dur", None)  # tests drive this with bare namespaces
        if dur is not None:
            # Journaled before the push: a restarted scheduler must never
            # adopt an older epoch than one a server saw.
            await asyncio.to_thread(
                dur.note_member,
                {"epoch": snapshot.epoch, "active": list(snapshot.active),
                 "departed": list(snapshot.departed)},
                ctx.rejoin_count)
        adaptive = getattr(ctx, "adaptive", None)
        if adaptive is not None:
            # None while empty, so the wire keeps its bytes until the
            # first assignment exists.
            snapshot.inner_steps = adaptive.assignments() or None
        for k, handle in enumerate(ctx.ps_handles):
            if handle is None:
                # Restarting: a plain snapshot is repaired after the
                # re-dispatch, a join is not.
                if joined:
                    ok = False
                continue
            update = MembershipUpdate(job_id=ctx.ps_job_ids[k], membership=snapshot,
                                      joined=list(joined or []))
            try:
                await self.node.request(handle.peer_id, PROTOCOL_FT, update, timeout=10)
            except RequestError as e:
                log.warning("membership update to PS shard %d failed: %s", k, e)
                ok = False
        return ok

    async def _depart(self, ctx: _RunContext, peer: str, reason: str, add) -> None:
        """A train worker is gone: degrade the round set, maybe rejoin."""
        assert ctx.membership is not None and ctx.tracker is not None
        assert ctx.ft is not None and ctx.job is not None
        if peer not in ctx.membership.active:
            return  # a second signal (lease failure + failed status)
        log.warning("worker %s departed (%s); degrading round set", peer, reason)
        ctx.membership.depart(peer)
        if ctx.detector is not None:
            ctx.detector.remove(peer)
        handle = ctx.handles.pop(peer, None)
        if handle is not None:
            await handle.release()
        if peer in ctx.tracker.peers:
            ctx.tracker.remove_worker(peer)
        if ctx.data_scheduler is not None:
            ctx.data_scheduler.remove_worker(peer)
        # Below the quorum of the replicas the job bought, the round
        # average has lost its meaning: last-resort restart.
        floor = quorum_size(ctx.ft.quorum_fraction, ctx.job.resources.num_workers)
        if len(ctx.membership.active) < floor:
            raise JobFailed(f"quorum lost: {len(ctx.membership.active)} active < {floor} "
                            f"(of {ctx.job.resources.num_workers} bought)")
        self._notify_membership_soon(ctx)
        if ctx.tracker.rounds_left > 1 and ctx.ft.rejoin_attempts > 0:
            add("rejoin", peer, self._rejoin_worker(ctx, peer, loop_time()))
        else:
            log.info("not rejoining for %s (%d rounds left)", peer, ctx.tracker.rounds_left)

    async def _rejoin_worker(self, ctx: _RunContext, departed_peer: str,
                             departed_at: float) -> "tuple | None":
        """Auction a replacement and enter it at the next epoch: it builds
        θ₀ and catches up from the server's Σ (``ft/rejoin.py``). Returns
        (handle, task), or None after ``rejoin_attempts`` tries."""
        assert ctx.ft is not None and ctx.job is not None
        assert ctx.membership is not None and ctx.tracker is not None
        spec_ws = self._train_worker_spec(ctx.job)
        for attempt in range(ctx.ft.rejoin_attempts):
            if attempt:
                await asyncio.sleep(ctx.ft.rejoin_backoff_s)
            try:
                offers = await self.allocator.request(
                    spec_ws, ctx.job.resources.worker_price, ctx.auction_timeout,
                    len(ctx.membership.active) + 1)
            except Exception as e:
                log.warning("rejoin auction failed: %s", e)
                continue
            candidates = [o for o in offers if o.peer_id not in ctx.membership.active]
            if not candidates:
                log.info("rejoin %d/%d: no fresh offers (got %d)", attempt + 1,
                         ctx.ft.rejoin_attempts, len(offers))
                continue
            offer = candidates[0]
            peer = offer.peer_id
            handle: "WorkerHandle | None" = None
            added = False
            try:
                handle = await WorkerHandle.create(self.node, offer)
                handle.batch_size = self.batch_size_for(
                    offer.resources, ctx.job.resources.worker, ctx.job.rounds.max_batch_size)
                if ctx.detector is not None:
                    handle.on_renew = ctx.detector.heartbeat
                # Tracker and membership BEFORE dispatch: the worker's first
                # STATUS must find it tracked, and the server must have
                # queued its catch-up before the executor waits for it.
                ctx.tracker.add_worker(peer, handle.batch_size)
                ctx.membership.join(peer)
                added = True
                if not await self._notify_membership(ctx, joined=[peer]):
                    raise RequestError("join notification to PS failed")
                spec = self._train_spec(ctx, f"r{ctx.rejoin_count}", handle, rejoin=True)
                task = await Task.dispatch(self.node, ctx.router, spec, [handle])
            except asyncio.CancelledError:
                await self._rollback_rejoin(ctx, peer, handle, added)
                raise
            except (RequestError, DispatchError) as e:
                log.warning("rejoin: attempt with %s failed: %s", peer, e)
                await self._rollback_rejoin(ctx, peer, handle, added)
                continue
            ctx.handles[peer] = handle
            ctx.rejoin_count += 1
            await self._journal_dispatch(ctx, spec.job_id, handle, "train")
            log.info("worker %s rejoined for %s at epoch %d (%.0f ms after departure)", peer,
                     departed_peer, ctx.membership.epoch, (loop_time() - departed_at) * 1000.0)
            return handle, task
        return None

    async def _rollback_rejoin(self, ctx: _RunContext, peer: str,
                               handle: "WorkerHandle | None", added: bool) -> None:
        """Undo a half-done rejoin attempt (failed or cancelled)."""
        if added:
            assert ctx.tracker is not None and ctx.membership is not None
            if peer in ctx.tracker.peers:
                ctx.tracker.remove_worker(peer)
            ctx.membership.depart(peer)
            self._notify_membership_soon(ctx)
        if handle is not None:
            await handle.release()


def loop_time() -> float:
    return asyncio.get_running_loop().time()


async def _await_failure(handle: WorkerHandle):
    return await asyncio.shield(handle.failed)
