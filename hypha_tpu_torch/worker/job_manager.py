"""Job routing and lifecycle tracking (a copy of
``hypha_tpu/worker/job_manager.py``).

Reference: crates/worker/src/job_manager.rs:85-211 — routes
``Executor::Train`` to the process executor and ``Executor::Aggregate`` to
the in-runtime parameter-server executor, tracks active jobs, cancels jobs
linked to an expired lease, reports ``JobStatus`` lifecycle events to the
scheduler over the API protocol.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Any

from .. import aio
from ..messages import PROTOCOL_API, JobSpec, JobStatus
from ..network.node import Node, RequestError

__all__ = ["Execution", "JobExecutor", "JobManager"]

log = logging.getLogger("hypha.torch.worker.jobs")


class Execution:
    """A running job: await ``wait()`` for the terminal state, or cancel."""

    def __init__(self, job_id: str) -> None:
        self.job_id = job_id
        # Durable control plane (ft.durable): live progress the executor
        # keeps current so a restarted scheduler's SchedulerHello can be
        # answered with the execution's TRUE round/epoch (AdoptAck), plus
        # the adoption grace (None = not adoptable, today's behavior) and
        # the last adopted scheduler generation (stale-hello guard).
        self.round = 0
        self.epoch = 0
        self.adopt_grace_s: float | None = None
        self.scheduler_generation: int | None = None
        self._result: asyncio.Future[JobStatus] = (
            asyncio.get_event_loop().create_future()
        )

    async def wait(self) -> JobStatus:
        return await asyncio.shield(self._result)

    def finish(self, state: str, message: str = "") -> None:
        if not self._result.done():
            self._result.set_result(
                JobStatus(job_id=self.job_id, state=state, message=message)
            )

    async def cancel(self) -> None:
        self.finish("cancelled")


class JobExecutor:
    """Executor interface (crates/worker/src/executor/mod.rs)."""

    async def execute(
        self, job_id: str, spec: JobSpec, scheduler_peer: str
    ) -> Execution:
        raise NotImplementedError


@dataclass(slots=True)
class _ActiveJob:
    execution: Execution
    lease_id: str
    monitor: asyncio.Task = field(default=None)  # type: ignore[assignment]


class JobManager:
    """Routes jobs to executors keyed by (class, name) and supervises them.

    ``executors`` maps an executor-class ("train"/"aggregate") + name to a
    JobExecutor instance, mirroring the worker config's executor table
    (crates/worker/src/config.rs:114-191).
    """

    def __init__(self, node: Node, executors: dict[tuple[str, str], JobExecutor]) -> None:
        self.node = node
        self.executors = executors
        self._active: dict[str, _ActiveJob] = {}

    def supported(self) -> list[tuple[str, str]]:
        return list(self.executors)

    async def execute(
        self, spec: JobSpec, lease_id: str, scheduler_peer: str
    ) -> Execution:
        key = (spec.executor.kind, spec.executor.name)
        executor = self.executors.get(key)
        if executor is None:
            raise ValueError(f"no executor for {key}")
        if spec.job_id in self._active:
            raise ValueError(f"job {spec.job_id} already running")
        execution = await executor.execute(spec.job_id, spec, scheduler_peer)
        job = _ActiveJob(execution=execution, lease_id=lease_id)
        job.monitor = aio.spawn(
            self._monitor(spec.job_id, execution, scheduler_peer),
            what=f"job monitor {spec.job_id}",
            logger=log,
        )
        self._active[spec.job_id] = job
        await self._report(
            scheduler_peer, JobStatus(job_id=spec.job_id, state="running")
        )
        return execution

    async def _monitor(
        self, job_id: str, execution: Execution, scheduler_peer: str
    ) -> None:
        try:
            status = await execution.wait()
        except asyncio.CancelledError:
            raise
        finally:
            self._active.pop(job_id, None)
        await self._report(scheduler_peer, status)

    async def _report(self, scheduler_peer: str, status: JobStatus) -> None:
        try:
            await self.node.request(scheduler_peer, PROTOCOL_API, status, timeout=10)
        except RequestError as e:
            log.warning("could not report %s for job %s: %s", status.state, status.job_id, e)

    def jobs_for_lease(self, lease_id: str) -> list[str]:
        return [jid for jid, j in self._active.items() if j.lease_id == lease_id]

    def lease_bindings(self) -> list[tuple[str, str]]:
        """(job_id, lease_id) for every active job (adoption lease re-arm)."""
        return [(jid, j.lease_id) for jid, j in self._active.items()]

    def get(self, job_id: str) -> Execution | None:
        """The live execution for ``job_id`` (None when not running) —
        the re-adoption handshake's lookup (arbiter SchedulerHello)."""
        job = self._active.get(job_id)
        return job.execution if job is not None else None

    def adopt_grace_for_lease(self, lease_id: str) -> float:
        """The longest adoption grace any of the lease's jobs carries.

        Scheduler crash recovery (ft.durable): a dead scheduler stops
        renewing, but executions of a recoverable job must outlive the
        lease expiry by this many seconds so the restarted scheduler can
        re-adopt them in place. 0 = no adoptable job, prune immediately
        (today's exact behavior).
        """
        grace = 0.0
        for job in self._active.values():
            if job.lease_id != lease_id:
                continue
            g = job.execution.adopt_grace_s
            if g is not None and g > grace:
                grace = float(g)
        return grace

    async def cancel_job(self, job_id: str) -> None:
        job = self._active.get(job_id)
        if job is not None:
            await job.execution.cancel()

    async def cancel_for_lease(self, lease_id: str) -> None:
        """Expired lease ⇒ its jobs die (crates/worker/src/arbiter.rs:96-141)."""
        for jid in self.jobs_for_lease(lease_id):
            log.info("cancelling job %s (lease %s expired)", jid, lease_id)
            await self._active[jid].execution.cancel()

    async def shutdown(self) -> None:
        for job in list(self._active.values()):
            await job.execution.cancel()
        for job in list(self._active.values()):
            await aio.wait_quiet(job.monitor, timeout=10)

    def __len__(self) -> int:
        return len(self._active)
