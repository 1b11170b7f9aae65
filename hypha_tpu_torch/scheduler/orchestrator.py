"""The scheduler orchestrator: allocate → wire → dispatch → supervise (a copy
of ``hypha_tpu/scheduler/orchestrator.py`` for the
single-parameter-server, non-elastic path — the one the JAX CLI runs with
default settings — with every wire codec and sync mode).

Reference call stack being reproduced (SURVEY.md §3.1,
crates/scheduler/src/bin/hypha-scheduler.rs:54-432):

  1. auction ``num_workers`` train workers + 1 parameter server
     (GreedyWorkerAllocator over gossip);
  2. accept offers by first lease renewal (WorkerHandle) and keep the
     renewal loops alive — a renewal failure is the worker-failure signal;
  3. per-worker batch size = floor(offered.gpu / required.gpu) clamped to
     ``max_batch_size`` (hypha-scheduler.rs:320-322);
  4. resolve the dataset's data provider from the discovery records;
  5. spawn DataScheduler (slice assignment), ProgressTracker +
     BatchScheduler (the DiLoCo control plane) and the MetricsBridge;
  6. dispatch the aggregate job to the PS and a train job per worker;
  7. supervise: job completes when the batch scheduler reports every
     worker DONE.

Any failure — a failed or cancelled job status, a lease renewal failure,
no progress message within the watchdog's deadline — fails the attempt
with ``JobFailed``; ``max_attempts > 1`` re-runs the whole job. The
no-progress watchdog is per-round: without ``status_timeout`` the deadline
derives from the synchronization simulation's projected round time once
every worker has timing statistics.

Not ported (the job refuses their options, ``job_config.py``): the
adoption and resume path of a restarted scheduler (**scheduler
recovery**), and the parameter server's restart, φ-accrual suspicion,
elastic membership, depart and rejoin, sharded and tree-reduced parameter
services and adaptive steps (**sharded PS/FT/rejoin**).
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any

from .. import aio, messages
from ..messages import (
    AGGREGATE_EXECUTOR_NAME,
    PROTOCOL_PROGRESS,
    TRAIN_EXECUTOR_NAME,
    AggregateExecutorConfig,
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
from ..network.node import Node
from .allocator import GreedyWorkerAllocator
from .batch_scheduler import BatchScheduler
from .data_scheduler import DataScheduler
from .job_config import DiLoCoJob
from .metrics_bridge import MetricsBridge, MetricsConnector
from .simulation import project
from .task import StatusRouter, Task
from .trackers import ProgressTracker
from .worker_handle import WorkerHandle

__all__ = ["Orchestrator", "JobResult", "JobFailed", "AllocationError"]

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


class JobResult:
    def __init__(self, job_id: str, rounds: int, metrics: list, attempt: int = 0) -> None:
        self.job_id = job_id
        self.rounds = rounds
        self.metrics = metrics  # [(peer, round, {name: value})]
        self.attempt = attempt  # 0 = first attempt succeeded (no restart)


class _RunContext:
    """Everything one attempt's supervision needs."""

    def __init__(self) -> None:
        self.job: DiLoCoJob | None = None
        self.base_id = ""
        self.updates_tag = ""
        self.results_tag = ""
        self.handles: dict[str, WorkerHandle] = {}
        # The one parameter server: its handle, job id, peer and updates
        # tag (lists, as the reference keeps one per shard).
        self.ps_handles: list[WorkerHandle] = []
        self.ps_job_ids: list[str] = []
        self.ps_peers: list[str] = []
        self.shard_tags: list[str] = []
        self.ps_specs: list[JobSpec] = []
        self.router: StatusRouter | None = None
        self.tracker: ProgressTracker | None = None
        self.data_scheduler: DataScheduler | None = None
        self.complete: asyncio.Event | None = None
        self.activity: list[float] = []
        self.status_timeout: float | None = None


class Orchestrator:
    def __init__(
        self,
        node: Node,
        metrics_connector: MetricsConnector | None = None,
    ) -> None:
        self.node = node
        self.allocator = GreedyWorkerAllocator(node)
        self.metrics_bridge = MetricsBridge(metrics_connector)

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
        self, job: DiLoCoJob, taken: set, *, auction_timeout: float, attempts: int
    ) -> list:
        """Auction the parameter server's execution: a peer distinct from
        the train workers first; a peer already sold as a train worker
        hosts it when its capacity covers both leases."""
        res = job.resources
        ps_spec = WorkerSpec(
            resources=res.parameter_server,
            executor=[
                ExecutorDescriptor(executor_class="aggregate", name=AGGREGATE_EXECUTOR_NAME)
            ],
        )
        for _attempt in range(attempts):
            offers = await self.allocator.request(
                ps_spec, res.parameter_server_price, auction_timeout, 1 + len(taken)
            )
            if not offers:
                continue
            distinct = [o for o in offers if o.peer_id not in taken]
            return [(distinct or offers)[0]]
        raise AllocationError("could not allocate 1 parameter server shard(s)")

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
        re-run from scratch against whatever workers the auction finds.
        ``retry_backoff`` defaults past the 10 s lease TTL so the failed
        attempt's leases lapse and the surviving workers' capacity frees
        before re-auctioning. ``status_timeout=None`` uses the per-round
        adaptive watchdog (simulation-projected round time).
        """
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        last: JobFailed | AllocationError | None = None
        for attempt in range(max_attempts):
            if attempt:
                log.warning(
                    "job attempt %d/%d failed (%s); retrying in %.0fs",
                    attempt, max_attempts, last, retry_backoff,
                )
                await asyncio.sleep(retry_backoff)
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

    # ------------------------------------------------------------- job specs

    def _train_spec(self, ctx: _RunContext, suffix: str, handle: WorkerHandle) -> JobSpec:
        job = ctx.job
        assert job is not None and ctx.ps_peers, "plan the streams first"
        return JobSpec(
            job_id=f"{ctx.base_id}-{suffix}",
            executor=Executor(
                kind="train",
                name=TRAIN_EXECUTOR_NAME,
                train=TrainExecutorConfig(
                    model=job.model,
                    data=Fetch(Reference.from_scheduler(self.node.peer_id, job.dataset)),
                    updates=Send(Reference.from_peers([ctx.ps_peers[0]], ctx.updates_tag)),
                    results=Receive(Reference.from_peers(list(ctx.ps_peers), ctx.results_tag)),
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
                ),
            ),
        )

    def _plan_streams(
        self,
        ctx: _RunContext,
        job: DiLoCoJob,
        worker_peers: list[str],
        ps_peers: list[str],
    ) -> None:
        """Derive the attempt's stream identities from its peer lists:
        job-unique tags (push routing keys on them, so several jobs, or a
        parameter server colocated with a train job, can share worker
        nodes), the parameter server's job id and its aggregate spec."""
        if len(ps_peers) != 1:
            raise ValueError(f"one parameter server, got {ps_peers}")
        ctx.ps_peers = list(ps_peers)
        ctx.updates_tag = f"updates:{ctx.base_id}"
        ctx.results_tag = f"results:{ctx.base_id}"
        ctx.shard_tags = [ctx.updates_tag]
        ctx.ps_job_ids = [f"{ctx.base_id}-ps"]
        ctx.ps_specs = [
            JobSpec(
                job_id=ctx.ps_job_ids[0],
                executor=Executor(
                    kind="aggregate",
                    name=AGGREGATE_EXECUTOR_NAME,
                    aggregate=AggregateExecutorConfig(
                        updates=Receive(Reference.from_peers(worker_peers, ctx.shard_tags[0])),
                        results=Send(Reference.from_peers(worker_peers, ctx.results_tag)),
                        optimizer=job.outer_optimizer,
                        num_workers=len(worker_peers),
                        ps_checkpoint_every_rounds=job.ps_checkpoint_every_rounds,
                        delta_codec=job.delta_codec,
                        sync_mode=job.sync_mode,
                        fragments=job.num_fragments,
                    ),
                ),
            )
        ]

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

    def _start_control(self, ctx: _RunContext):
        """Stand up the DiLoCo control plane: BatchScheduler + the
        /hypha-progress handler. Returns (collected_metrics, registration)."""
        ctx.complete = asyncio.Event()
        collected: list = []
        ctx.activity = [asyncio.get_running_loop().time()]  # watchdog feed

        def on_metrics(peer: str, round_num: int, metrics: dict) -> None:
            collected.append((peer, round_num, metrics))
            self.metrics_bridge.on_metrics(peer, round_num, metrics)

        batch_scheduler = BatchScheduler(
            ctx.tracker, on_metrics=on_metrics, on_complete=ctx.complete.set
        )

        async def on_progress(peer: str, progress: Progress):
            # Every progress message, from any peer, resets the watchdog.
            ctx.activity[0] = asyncio.get_running_loop().time()
            return batch_scheduler.on_progress(peer, progress)

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
        worker_offers = await self._allocate_train(
            job, auction_timeout=auction_timeout, attempts=allocation_attempts
        )
        ctx = _RunContext()
        ctx.job = job
        ctx.status_timeout = status_timeout
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
            ps_offers = await self._allocate_ps(
                job, set(ctx.handles),
                auction_timeout=auction_timeout, attempts=allocation_attempts,
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

            collected, progress_reg = self._start_control(ctx)

            ctx.router = StatusRouter(self.node)
            ctx.base_id = str(uuid.uuid4())
            self._plan_streams(
                ctx, job, list(ctx.handles), [h.peer_id for h in ctx.ps_handles]
            )
            for spec, ps_handle in zip(ctx.ps_specs, ctx.ps_handles):
                tasks.append(await Task.dispatch(self.node, ctx.router, spec, [ps_handle]))
            # Train dispatches fan out with bounded concurrency (each is
            # an independent request to a distinct peer).
            tasks += await aio.gather_bounded(
                [
                    (
                        lambda s=self._train_spec(ctx, f"w{i}", handle), h=handle:
                        Task.dispatch(self.node, ctx.router, s, [h])
                    )
                    for i, handle in enumerate(ctx.handles.values())
                ],
                limit=8,
            )

            await self._supervise(ctx, tasks)
            return JobResult(ctx.base_id, ctx.tracker.round, collected)
        finally:
            if progress_reg is not None:
                progress_reg.close()
            if ctx.data_scheduler is not None:
                ctx.data_scheduler.stop()
            if ctx.router is not None:
                ctx.router.close()
            for handle in ctx.handles.values():
                await handle.release()
            for ps_handle in ctx.ps_handles:
                await ps_handle.release()
            await self.metrics_bridge.close()

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

    async def _supervise(self, ctx: _RunContext, tasks: list[Task]) -> None:
        """Wait for completion; any failure aborts the attempt.

        Failure signals: per-task failed/cancelled job statuses and
        per-handle lease-renewal failures (hypha-scheduler.rs:372-412
        select loop). The no-PROGRESS watchdog resets on every progress
        message, so a long but steadily-reporting job is never killed."""
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
            add("ps-worker", ps_handle, _await_failure(ps_handle))
        loop = asyncio.get_running_loop()
        try:
            while True:
                timeout_s = self._effective_timeout(ctx)
                last = ctx.activity[0] if ctx.activity else loop.time()
                remaining = (last + timeout_s) - loop.time()
                if remaining <= 0:
                    raise JobFailed(f"no progress in {timeout_s:.0f}s")
                done, _ = await asyncio.wait(
                    waiters,
                    timeout=min(remaining, 1.0),
                    return_when=asyncio.FIRST_COMPLETED,
                )
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
                        continue
                    if kind == "status":
                        peer, job_id, reason = t.result()
                        if job_id in ctx.ps_job_ids:
                            raise JobFailed(
                                f"parameter server shard {ctx.ps_job_ids.index(job_id)} "
                                f"failed: {job_id} failed on {peer}: {reason}"
                            )
                        raise JobFailed(f"{job_id} failed on {peer}: {reason}")
                    if kind == "ps-worker":
                        raise JobFailed(
                            f"parameter server shard {ctx.ps_handles.index(payload)} "
                            f"failed: {t.result()}"
                        )
                    if kind == "worker":
                        raise JobFailed(str(t.result()))
        finally:
            for t in waiters:
                t.cancel()
            await asyncio.gather(*waiters, return_exceptions=True)


async def _await_failure(handle: WorkerHandle):
    return await asyncio.shield(handle.failed)
