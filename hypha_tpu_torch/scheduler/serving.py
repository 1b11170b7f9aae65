"""Scheduler-side serving plane: one deployment, kept alive (counterpart
of ``hypha_tpu/scheduler/serving.py`` for ``num_workers=1`` without
routing).

The serving analog of the orchestrator's training supervision: auction a
worker with the infer executor (``GreedyWorkerAllocator``), dispatch
``Executor(kind="infer")`` (``Task``, ``StatusRouter``), hold the lease
through its renewal loop (``WorkerHandle``), and on a failure — a failed
or cancelled job status, a lost lease — tear the deployment down,
re-auction and re-dispatch (``redeployments`` counts them). The backend
announces ``serve:<name>`` itself and clients reach it directly
(``worker/infer_executor.py`` ``generate_remote``). ``stop`` ends the run;
the teardown cancels the job on the worker and releases the lease.

The dispatched config is the JAX supervisor's single-deployment wire:
``load_report_s = 0`` and no additive field set. Everything that turns the
JAX supervisor into a request router — ``num_workers > 1``, ``route``,
``queue_limit``, ``prefix_affinity``, its φ-accrual ejector and the
``ServeLoad`` heartbeats — raises naming **serving router**; the fleet
cache and KV migration, the metrics plane and live weight swap raise
naming theirs.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from dataclasses import dataclass

from .. import aio
from ..messages import (
    INFER_EXECUTOR_NAME,
    PROTOCOL_API,
    CancelJob,
    Executor,
    ExecutorDescriptor,
    InferExecutorConfig,
    JobSpec,
    PriceRange,
    WorkerSpec,
)
from ..network.node import Node
from ..resources import Resources
from .allocator import GreedyWorkerAllocator
from .task import StatusRouter, Task
from .worker_handle import WorkerHandle

__all__ = ["ServingSupervisor"]

log = logging.getLogger("hypha.torch.scheduler.serving")

AUCTION_TIMEOUT_S = 2.0  # how long one auction collects offers
RETRY_PAUSE_S = 1.0  # between a failed or empty auction and the next


def _refuse(option: str, label: str) -> None:
    raise NotImplementedError(
        f"ServingSupervisor {option} is not ported to PyTorch yet "
        f"(ROADMAP.md, Queue 1: {label})"
    )


@dataclass
class _Deployment:
    handle: WorkerHandle
    task: Task
    job_id: str
    status_wait: "asyncio.Task | None" = None


class ServingSupervisor:
    """Keeps one serving deployment alive across worker failures."""

    def __init__(
        self,
        node: Node,
        model: dict,
        serve_name: str,
        *,
        resources: "Resources | None" = None,
        price: "PriceRange | None" = None,
        max_new_tokens: int = 256,
        max_batch: int = 8,
        num_workers: int = 1,
        route: "bool | None" = None,
        queue_limit: int = 0,
        pool_block_size: int = 0,
        pool_blocks: int = 0,
        pool_prefill_chunk: int = 0,
        pool_prefix_cache: bool = False,
        pool_spec_ngram: int = 0,
        pool_spec_draft: int = 0,
        pool_ragged: bool = False,
        pool_kv_quant: str = "",
        pool_spec_layers: int = 0,
        fleet_cache: bool = False,
        kv_migration: bool = False,
        prefix_affinity: bool = False,
        eos_token_id: "int | None" = None,
        report_metrics_s: "float | None" = None,
        metrics=None,
        serve_follow_rounds=None,
    ) -> None:
        if int(num_workers) > 1:
            _refuse("num_workers > 1", "serving router")
        if route:
            _refuse("route=True", "serving router")
        if queue_limit:
            _refuse("queue_limit", "serving router")
        if prefix_affinity:
            _refuse("prefix_affinity", "serving router")
        if fleet_cache or kv_migration:
            _refuse("fleet_cache / kv_migration", "fleet cache and KV migration")
        if report_metrics_s or metrics is not None:
            _refuse("report_metrics_s / metrics", "telemetry")
        if serve_follow_rounds is not None:
            _refuse("serve_follow_rounds", "live weight swap")
        self.node = node
        self.serve_name = serve_name
        self._config = InferExecutorConfig(
            model=model,
            serve_name=serve_name,
            max_new_tokens=max_new_tokens,
            max_batch=max_batch,
            pool_block_size=pool_block_size,
            pool_blocks=pool_blocks,
            pool_prefill_chunk=pool_prefill_chunk,
            pool_prefix_cache=pool_prefix_cache,
            pool_spec_ngram=pool_spec_ngram,
            pool_spec_draft=pool_spec_draft,
            pool_ragged=pool_ragged,
            pool_kv_quant=pool_kv_quant,
            pool_spec_layers=pool_spec_layers,
            eos_token_id=eos_token_id,
            # No router listens for ServeLoad heartbeats.
            load_report_s=0.0,
        )
        self._resources = resources or Resources(gpu=1.0, memory=100.0)
        self._price = price or PriceRange(bid=1.0, max=10.0)
        self._allocator = GreedyWorkerAllocator(node)
        self._router = StatusRouter(node)
        self._deployment: "_Deployment | None" = None
        self._stop = asyncio.Event()
        self.redeployments = 0  # failures recovered (observability/tests)

    async def run(self) -> None:
        """Supervise until :meth:`stop`; returns after teardown."""
        try:
            while not self._stop.is_set():
                if self._deployment is None:
                    try:
                        self._deployment = await self._deploy()
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        # A worker dying mid-acceptance (or any transient
                        # dispatch error) must not kill the supervisor
                        # whose whole job is elastic recovery.
                        log.warning("deploy of %s failed (%s); retrying", self.serve_name, e)
                if self._deployment is None:
                    await self._pause()
                    continue
                dep = self._deployment
                if dep.status_wait is None or dep.status_wait.done():
                    dep.status_wait = aio.spawn(
                        dep.task.next_status(), what="serving status waiter", logger=log
                    )
                stop_wait = aio.spawn(self._stop.wait(), what="serving stop waiter")
                done, _ = await asyncio.wait(
                    {stop_wait, dep.status_wait, dep.handle.failed},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                stop_wait.cancel()
                if self._stop.is_set():
                    return
                if self._failed(dep, done):
                    self.redeployments += 1
                    await self._teardown(dep)
                    self._deployment = None
        finally:
            await self._teardown(self._deployment)
            self._deployment = None
            self._router.close()

    async def stop(self) -> None:
        self._stop.set()

    def _failed(self, dep: _Deployment, done: set) -> bool:
        """True when the deployment must be torn down and replaced."""
        if dep.handle.failed in done:
            log.warning("serving worker %s failed (%s); redeploying",
                        dep.handle.peer_id, dep.handle.failed.result())
            return True
        if dep.status_wait in done and not dep.status_wait.cancelled():
            peer, status = dep.status_wait.result()
            if status.state == "running":
                return False  # informational; keep watching
            log.warning("serving job %s reported %s on %s; redeploying",
                        dep.job_id, status.state, peer)
            return True
        return False

    async def _deploy(self) -> "_Deployment | None":
        spec = WorkerSpec(
            resources=self._resources,
            executor=[ExecutorDescriptor(executor_class="infer", name=INFER_EXECUTOR_NAME)],
        )
        offers = await self._allocator.request(
            spec, self._price, timeout=AUCTION_TIMEOUT_S, num_workers=1
        )
        if not offers:
            log.info("no offers for serving %s; retrying", self.serve_name)
            return None
        handle = await WorkerHandle.create(self.node, offers[0])
        job = JobSpec(
            job_id=f"serve-{self.serve_name}-0-{uuid.uuid4().hex[:8]}",
            executor=Executor(kind="infer", name=INFER_EXECUTOR_NAME, infer=self._config),
        )
        dispatched = False
        try:
            task = await Task.dispatch(self.node, self._router, job, [handle])
            dispatched = True
        except Exception as e:
            log.warning("dispatch of %s to %s failed: %s", job.job_id, handle.peer_id, e)
            raise
        finally:
            # The lease is live (renewal loop running): any non-dispatch
            # exit, cancellation included, must release it or the worker's
            # capacity leaks to a zombie lease on every retry.
            if not dispatched:
                await handle.release()
        log.info("serving %s deployed on %s (job %s)", self.serve_name, handle.peer_id,
                 job.job_id)
        return _Deployment(handle=handle, task=task, job_id=job.job_id)

    async def _pause(self) -> None:
        try:
            await asyncio.wait_for(self._stop.wait(), RETRY_PAUSE_S)
        except asyncio.TimeoutError:
            pass

    async def _teardown(self, dep: "_Deployment | None") -> None:
        if dep is None:
            return
        if dep.status_wait is not None:
            dep.status_wait.cancel()
        dep.task.close()
        try:  # stop serving now; lease expiry backstops a dead worker
            await self.node.request(
                dep.handle.peer_id, PROTOCOL_API,
                CancelJob(lease_id=dep.handle.lease_id, job_id=dep.job_id),
                timeout=10,
            )
        except Exception as e:
            log.debug("cancel of %s on %s failed: %s", dep.job_id, dep.handle.peer_id, e)
        try:
            await dep.handle.release()
        except Exception:
            pass
