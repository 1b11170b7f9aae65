"""Task handle: dispatch a job to leased workers and stream its status (a
copy of ``hypha_tpu/scheduler/task.py``; ``Task.attach`` re-watches a job
that a restarted scheduler adopted).

Reference: crates/scheduler/src/task.rs:20-128 — a ``Task`` dispatches a
``DispatchJob`` to a set of workers and exposes the stream of ``JobStatus``
updates filtered by its job id; the status route is registered once by the
runtime (a single JobStatus RPC handler) and fanned out here.
"""

from __future__ import annotations

import asyncio
import logging

from ..messages import (
    PROTOCOL_API,
    Ack,
    CancelJob,
    DispatchJob,
    DispatchJobResponse,
    JobSpec,
    JobStatus,
)
from ..network.node import Node
from .worker_handle import WorkerHandle

__all__ = ["Task", "StatusRouter", "DispatchError"]

log = logging.getLogger("hypha.torch.scheduler.task")


class DispatchError(RuntimeError):
    pass


class StatusRouter:
    """One JobStatus handler for the whole scheduler, fanned out by job id
    (the reference aborts per-task handlers on drop; here tasks
    unsubscribe themselves)."""

    def __init__(self, node: Node) -> None:
        self._queues: dict[str, asyncio.Queue] = {}
        self._registration = node.on(PROTOCOL_API, JobStatus).respond_with(self._on_status)

    async def _on_status(self, peer: str, status: JobStatus) -> Ack:
        queue = self._queues.get(status.job_id)
        if queue is not None:
            await queue.put((peer, status))
        return Ack(ok=True)

    def watch(self, job_id: str) -> asyncio.Queue:
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[job_id] = queue
        return queue

    def unwatch(self, job_id: str) -> None:
        self._queues.pop(job_id, None)

    def close(self) -> None:
        self._registration.close()


class Task:
    """A dispatched job across one or more workers."""

    def __init__(self, router: StatusRouter, spec: JobSpec) -> None:
        self.spec = spec
        self.job_id = spec.job_id
        self._router = router
        self._statuses = router.watch(spec.job_id)

    @classmethod
    async def dispatch(
        cls,
        node: Node,
        router: StatusRouter,
        spec: JobSpec,
        workers: list[WorkerHandle],
    ) -> "Task":
        """Send DispatchJob to every worker; any rejection fails the task
        (task.rs:27-108)."""
        task = cls(router, spec)
        accepted: list[WorkerHandle] = []
        try:
            for worker in workers:
                resp = await node.request(
                    worker.peer_id,
                    PROTOCOL_API,
                    DispatchJob(lease_id=worker.lease_id, spec=spec),
                    timeout=30,
                )
                if not isinstance(resp, DispatchJobResponse) or not resp.accepted:
                    msg = getattr(resp, "message", "rejected")
                    raise DispatchError(
                        f"worker {worker.peer_id} rejected job {spec.job_id}: {msg}"
                    )
                accepted.append(worker)
        except Exception:
            # Roll back the workers that already accepted — without this they
            # would run the half-dispatched job until their lease lapsed.
            for worker in accepted:
                try:
                    await node.request(
                        worker.peer_id,
                        PROTOCOL_API,
                        CancelJob(lease_id=worker.lease_id, job_id=spec.job_id),
                        timeout=10,
                    )
                except Exception as e:  # best-effort; lease expiry backstops
                    log.warning(
                        "rollback of job %s on %s failed: %s",
                        spec.job_id, worker.peer_id, e,
                    )
            task.close()
            raise
        return task

    @classmethod
    def attach(cls, router: StatusRouter, job_id: str) -> "Task":
        """Watch an already-running job's statuses without dispatching: an
        execution adopted by a restarted scheduler is still running, and a
        second ``DispatchJob`` would be refused."""
        task = cls.__new__(cls)
        task.spec = None
        task.job_id = job_id
        task._router = router
        task._statuses = router.watch(job_id)
        return task

    async def next_status(self, timeout: float | None = None) -> tuple[str, JobStatus]:
        getter = self._statuses.get()
        if timeout is None:
            return await getter
        return await asyncio.wait_for(getter, timeout)

    def close(self) -> None:
        self._router.unwatch(self.job_id)
