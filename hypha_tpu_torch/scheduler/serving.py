"""Scheduler-side serving plane: N routed deployments, kept alive
(counterpart of ``hypha_tpu/scheduler/serving.py``).

The serving analog of the orchestrator's training supervision: auction a
worker with the infer executor (``GreedyWorkerAllocator``), dispatch
``Executor(kind="infer")`` (``Task``, ``StatusRouter``), hold the lease
through its renewal loop (``WorkerHandle``), and on a failure — a failed
or cancelled job status, a lost lease, an ejection — tear the deployment
down, re-auction and re-dispatch (``redeployments`` counts them). Each of
the ``num_workers`` slots is deployed, failed and re-auctioned on its own.

``num_workers > 1`` (or ``route=True``) makes the supervisor a **request
router**, as in the reference:

* each deployment serves under a backend name ``<name>@<slot>``; the
  supervisor announces ``serve:<name>`` once a backend exists and answers
  ``/hypha-generate`` by forwarding to the least-loaded backend (queue
  depth + in-flight requests, free KV blocks as the tiebreak), trying the
  next one on a ``RequestError``;
* backends heartbeat ``ServeLoad`` every ``LOAD_REPORT_S``; only a
  backend that has sent one is routable, and fresh loads are preferred.
  The heartbeats feed a φ-accrual detector (``ft/detector.py``): a
  backend whose φ passes ``PHI_THRESHOLD`` after ``EJECT_GRACE_S`` of
  silence is ejected, its lease handle failed with ``WorkerFailure(peer,
  "phi-accrual ejection")``, and its slot re-auctioned. Lease renewals do
  not feed φ;
* ``queue_limit``: when every backend is at the line, the answer is
  ``ok=False`` with ``retry_after_ms = 50 x (min depth - limit + 1)``;
* ``prefix_affinity``: the backend that owns a prompt's first
  ``AFFINITY_TOKENS`` ids (rendezvous hash over the backend names) goes to
  the front, unless it is more than ``AFFINITY_SKEW`` requests deeper than
  the best one. The owner is ``max(..., key=hash((key, name)))``, as in the
  reference: Python salts string hashes per process, so the owner is
  stable within one router process only;
* ``fleet_cache``: backends send a digest of their hottest cached chains
  on each heartbeat; the router folds them into a directory (backend ->
  ``{chain hash: hits}``), routes a prompt to the backend that holds its
  deepest chain (the same skew guard; the rendezvous owner when nobody
  holds it), and when load sends it elsewhere stamps ``pull_peer`` /
  ``pull_serve`` so the landing backend pulls the blocks from the holder;
* ``kv_migration``: each heartbeat ack names the least-loaded other fresh
  backend, where the backend ships a request it preempts.

The reference's timing and affinity knobs are constants here, at the
reference's defaults, which its CLI always uses. ``num_workers=1``
without ``route`` dispatches the single-deployment wire
(``load_report_s = 0``, the public name); the backend announces itself and
clients reach it directly. The metrics plane and live weight swap raise
naming their labels. Where the reference bumps its serving metrics, this
class keeps plain counters (``routed``, ``rejected``, ``affinity_routed``,
``redeployments``, ``ejections``, and the directory's ``directory_entries``)
and logs them when it stops.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import time
import uuid
from dataclasses import dataclass

from .. import aio
from ..executor.block_cache import chain_hashes
from ..ft.detector import PhiAccrualDetector
from ..messages import (
    INFER_EXECUTOR_NAME,
    PROTOCOL_API,
    PROTOCOL_GENERATE,
    PROTOCOL_SERVE,
    CancelJob,
    Executor,
    ExecutorDescriptor,
    GenerateRequest,
    GenerateResponse,
    InferExecutorConfig,
    JobSpec,
    PriceRange,
    ServeLoad,
    ServeLoadAck,
    WorkerSpec,
)
from ..network.node import Node, RequestError
from ..resources import Resources
from ..worker.infer_executor import serve_key
from .allocator import GreedyWorkerAllocator
from .task import StatusRouter, Task
from .worker_handle import WorkerFailure, WorkerHandle

__all__ = ["ServingSupervisor"]

log = logging.getLogger("hypha.torch.scheduler.serving")

AUCTION_TIMEOUT_S = 2.0  # how long one auction collects offers
RETRY_PAUSE_S = 1.0  # between a failed or empty auction and the next
LOAD_REPORT_S = 1.0  # a routed backend's heartbeat period
PHI_THRESHOLD = 8.0  # the ejector's suspicion level
EJECT_CHECK_S = 0.25  # between two ejection passes
# φ alone fires on sub-second stalls at a fast heartbeat cadence; an
# absolute silence is required too. The 5 s floor rides out a first pool
# submit that holds the worker's event loop.
EJECT_GRACE_S = max(10.0 * LOAD_REPORT_S, 5.0)
AFFINITY_TOKENS = 64  # the prompt ids whose owner affinity looks up
AFFINITY_SKEW = 4  # how much deeper than the best the owner may be
REQUEST_TIMEOUT_S = 120.0  # one forwarded request


def _refuse(option: str, label: str) -> None:
    raise NotImplementedError(
        f"ServingSupervisor {option} is not ported to PyTorch yet "
        f"(ROADMAP.md, Queue 1: {label})"
    )


@dataclass
class _Deployment:
    slot: int
    handle: WorkerHandle
    task: Task
    job_id: str
    backend_name: str
    status_wait: "asyncio.Task | None" = None
    load: "ServeLoad | None" = None
    load_at: float = 0.0
    inflight: int = 0


class ServingSupervisor:
    """Keeps ``num_workers`` serving deployments alive across worker
    failures, routing requests across them when there is more than one."""

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
        fleet_digest_k: int = 32,
        prefix_affinity: bool = False,
        eos_token_id: "int | None" = None,
        report_metrics_s: "float | None" = None,
        metrics=None,
        serve_follow_rounds=None,
    ) -> None:
        if report_metrics_s or metrics is not None:
            _refuse("report_metrics_s / metrics", "telemetry")
        if serve_follow_rounds is not None:
            _refuse("serve_follow_rounds", "live weight swap")
        self.node = node
        self.serve_name = serve_name
        self.num_workers = max(int(num_workers), 1)
        # Routing is on exactly when there is something to balance;
        # num_workers=1 without route=True keeps the single-deployment wire.
        self.route = (self.num_workers > 1) if route is None else bool(route)
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
            # None when off, so the dispatched config stays byte-identical.
            pool_fleet_cache=True if fleet_cache else None,
            pool_kv_migration=True if kv_migration else None,
            fleet_digest_k=int(fleet_digest_k) if fleet_cache else None,
            queue_limit=queue_limit,
            eos_token_id=eos_token_id,
            load_report_s=LOAD_REPORT_S if self.route else 0.0,
        )
        self.prefix_affinity = bool(prefix_affinity)
        # The fleet cache's directory: backend name -> {chain hash: hits},
        # replaced whole by each heartbeat's digest.
        self.fleet_cache = bool(fleet_cache)
        self.kv_migration = bool(kv_migration)
        self._digests: dict = {}
        self.queue_limit = max(int(queue_limit), 0)
        self._resources = resources or Resources(gpu=1.0, memory=100.0)
        self._price = price or PriceRange(bid=1.0, max=10.0)
        self._allocator = GreedyWorkerAllocator(node)
        self._router = StatusRouter(node)
        self._detector = PhiAccrualDetector(threshold=PHI_THRESHOLD)
        self._deployments: "list[_Deployment | None]" = [None] * self.num_workers
        self._regs: list = []
        self._announced = False
        self._stop = asyncio.Event()
        self.redeployments = 0  # failures recovered
        self.ejections = 0  # φ-accrual ejections (a subset of the above)
        self.routed = 0  # requests a backend answered through the router
        self.rejected = 0  # queue_limit rejections with retry-after
        self.affinity_routed = 0  # requests sent to their prefix owner

    # ------------------------------------------------------------------ run

    async def run(self) -> None:
        """Supervise until :meth:`stop`; returns after teardown."""
        eject_task: "asyncio.Task | None" = None
        if self.route:
            self._regs.append(
                self.node.on(PROTOCOL_SERVE, ServeLoad)
                # Backends report under `<name>@<slot>`; dispatch is
                # first-handler-wins, so without this match a second
                # supervisor on the same node would take these heartbeats.
                .match(lambda m: m.serve_name.split("@", 1)[0] == self.serve_name)
                .respond_with(self._on_load)
            )
            self._regs.append(
                self.node.on(PROTOCOL_GENERATE, GenerateRequest)
                .match(lambda m: m.serve_name == self.serve_name)
                .concurrency(64)
                .respond_with(self._route_request)
            )
            eject_task = aio.spawn(self._eject_loop(), what="serving ejector", logger=log)
        try:
            while not self._stop.is_set():
                await self._fill_slots()
                if not any(d is not None for d in self._deployments):
                    await self._pause()
                    continue
                if self.route and not self._announced:
                    # Announce once a backend exists, so clients never
                    # find a router with nothing behind it; retried each
                    # pass until it lands.
                    try:
                        await self.node.provide(serve_key(self.serve_name))
                        self._announced = True
                    except RequestError as e:
                        log.warning("router announce for %s failed: %s", self.serve_name, e)
                stop_wait = aio.spawn(self._stop.wait(), what="serving stop waiter")
                waiters: dict = {}
                for dep in self._deployments:
                    if dep is None:
                        continue
                    if dep.status_wait is None or dep.status_wait.done():
                        dep.status_wait = aio.spawn(
                            dep.task.next_status(), what="serving status waiter", logger=log
                        )
                    waiters[dep.status_wait] = dep
                    waiters[dep.handle.failed] = dep
                # An empty slot (or an unannounced router) retries on the
                # pause cadence even while the healthy slots stay quiet.
                needs_tick = any(d is None for d in self._deployments) or (
                    self.route and not self._announced
                )
                done, _ = await asyncio.wait(
                    {stop_wait, *waiters},
                    return_when=asyncio.FIRST_COMPLETED,
                    timeout=RETRY_PAUSE_S if needs_tick else None,
                )
                stop_wait.cancel()
                if self._stop.is_set():
                    return
                for waiter in done:
                    if waiter is stop_wait:
                        continue
                    dep = waiters.get(waiter)
                    if dep is None or self._deployments[dep.slot] is not dep:
                        continue
                    if self._handle_event(dep, waiter):
                        self.redeployments += 1
                        await self._teardown(dep)
                        self._deployments[dep.slot] = None
        finally:
            # Counted before the teardowns empty the directory.
            log.info("serving %s router: %s", self.serve_name, json.dumps(self.counters()))
            await aio.reap(eject_task)
            for dep in self._deployments:
                if dep is not None:
                    await self._teardown(dep)
            self._deployments = [None] * self.num_workers
            for reg in self._regs:
                reg.close()
            self._regs.clear()
            if self._announced:
                try:
                    await self.node.unprovide(serve_key(self.serve_name))
                except Exception:
                    pass
                self._announced = False
            self._router.close()

    async def stop(self) -> None:
        self._stop.set()

    def counters(self) -> dict:
        """The plain counters the reference keeps as serving metrics."""
        return {"routed": self.routed, "rejected": self.rejected,
                "affinity_routed": self.affinity_routed,
                "redeployments": self.redeployments, "ejections": self.ejections,
                "directory_entries": sum(len(d) for d in self._digests.values())}

    # ------------------------------------------------------------- routing

    def _live_backends(self) -> list:
        return [d for d in self._deployments if d is not None]

    def _score(self, dep: _Deployment) -> tuple:
        """Lower is better: queued + in-flight work, then the most free
        blocks. Only called on backends whose ``load`` is set."""
        return (dep.load.queue_depth + dep.inflight, -dep.load.free_blocks)

    def _req_hashes(self, req: GenerateRequest) -> list:
        """The chain hashes of the request's first prompt, the directory's
        keys; empty with the fleet cache off or no digest yet."""
        bs = self._config.pool_block_size or 0
        if not self.fleet_cache or bs <= 0 or not self._digests or not req.prompts:
            return []
        return chain_hashes(list(req.prompts[0]), bs)

    def _chain_depth(self, backend_name: str, hashes: list) -> int:
        """How many leading blocks of ``hashes`` the backend advertises (a
        chain hash implies its whole prefix)."""
        dig = self._digests.get(backend_name)
        if not dig:
            return 0
        for i in range(len(hashes), 0, -1):
            if hashes[i - 1] in dig:
                return i
        return 0

    def _directory_owner(self, backends: list, hashes: list):
        """The backend holding the deepest chain of the prompt per the
        digests, ties to the least loaded; None when nobody holds one."""
        best, best_depth = None, 0
        for d in backends:
            depth = self._chain_depth(d.backend_name, hashes)
            if depth > best_depth or (
                depth == best_depth and depth > 0 and self._score(d) < self._score(best)
            ):
                best, best_depth = d, depth
        return best

    def _pull_source(self, dep: _Deployment, hashes: list):
        """``(peer id, backend name)`` of a backend other than ``dep`` that
        holds a strictly deeper chain of the prompt, or None."""
        if not hashes:
            return None
        best, best_depth = None, self._chain_depth(dep.backend_name, hashes)
        for d in self._live_backends():
            if d is dep or d.load is None:
                continue
            depth = self._chain_depth(d.backend_name, hashes)
            if depth > best_depth:
                best, best_depth = d, depth
        if best is None:
            return None
        return best.handle.peer_id, best.backend_name

    def _apply_affinity(self, backends: list, req: GenerateRequest) -> list:
        """Move the backend that owns this prompt's prefix to the front of
        the least-loaded order, unless it is more than ``AFFINITY_SKEW``
        requests deeper than the best one. The owner is the directory's
        holder of the prompt's deepest chain, else (with
        ``prefix_affinity``) the rendezvous owner."""
        if len(backends) < 2 or not req.prompts:
            return backends
        owner = self._directory_owner(backends, self._req_hashes(req))
        if owner is None:
            if not self.prefix_affinity:
                return backends
            key = tuple(req.prompts[0][:AFFINITY_TOKENS])
            owner = max(backends, key=lambda d: hash((key, d.backend_name)))
        best = backends[0]  # already sorted by _score
        depth = lambda d: d.load.queue_depth + d.inflight  # noqa: E731
        if depth(owner) - depth(best) > AFFINITY_SKEW:
            return backends
        if owner is not best:
            backends = [owner] + [d for d in backends if d is not owner]
        self.affinity_routed += 1
        return backends

    async def _route_request(self, peer: str, req: GenerateRequest) -> GenerateResponse:
        # Only a backend that has heartbeated is routable: a fresh job is
        # still loading its model and has no handler yet.
        reported = [d for d in self._live_backends() if d.load is not None]
        # Prefer fresh loads: a backend whose reporter died keeps a frozen
        # score; fall back to stale-but-live ones rather than fail.
        now = time.monotonic()
        fresh = [d for d in reported if now - d.load_at <= EJECT_GRACE_S]
        backends = sorted(fresh or reported, key=self._score)
        if not backends:
            return GenerateResponse(tokens=[], ok=False, retry_after_ms=250.0)
        backends = self._apply_affinity(backends, req)
        if self.queue_limit:
            depths = [d.load.queue_depth + d.inflight for d in backends]
            if min(depths) >= self.queue_limit:
                # Every backend is at the line: the hint grows with how
                # deep the best one is.
                self.rejected += 1
                return GenerateResponse(
                    tokens=[], ok=False,
                    retry_after_ms=50.0 * (min(depths) - self.queue_limit + 1),
                )
        busy_hint = 0.0
        last: "Exception | None" = None
        req_hashes = self._req_hashes(req)
        for dep in backends:
            # Not the deepest holder: name the holder to pull from (None,
            # off the wire, with no holder or the fleet cache off).
            pull = self._pull_source(dep, req_hashes)
            fwd = dataclasses.replace(
                req, serve_name=dep.backend_name,
                pull_peer=pull[0] if pull else None, pull_serve=pull[1] if pull else None)
            dep.inflight += 1
            try:
                resp = await self.node.request(
                    dep.handle.peer_id, PROTOCOL_GENERATE, fwd, timeout=REQUEST_TIMEOUT_S
                )
            except RequestError as e:
                last = e
                continue
            finally:
                dep.inflight -= 1
            if getattr(resp, "ok", True):
                self.routed += 1
                return resp
            busy_hint = max(busy_hint, resp.retry_after_ms)
        if busy_hint > 0.0:
            return GenerateResponse(tokens=[], ok=False, retry_after_ms=busy_hint)
        raise RequestError(
            f"all {len(backends)} backends of {self.serve_name!r} failed: {last}"
        )

    async def _on_load(self, peer: str, load: ServeLoad) -> ServeLoadAck:
        for dep in self._live_backends():
            if dep.job_id == load.job_id and dep.handle.peer_id == peer:
                dep.load = load
                dep.load_at = time.monotonic()
                self._detector.heartbeat(peer)
                if load.cache_digest is not None:
                    # Replaced whole: a chain evicted there leaves the
                    # directory at the next heartbeat.
                    self._digests[dep.backend_name] = {
                        int(h): int(c) for h, c in load.cache_digest}
                return self._ack(dep)
        return ServeLoadAck(ok=False)  # a job already torn down

    def _ack(self, dep: _Deployment) -> ServeLoadAck:
        """The heartbeat's answer; with KV migration on it names the
        least-loaded other fresh backend as the migration target."""
        if not self.kv_migration:
            return ServeLoadAck(ok=True)
        now = time.monotonic()
        others = [d for d in self._live_backends()
                  if d is not dep and d.load is not None and now - d.load_at <= EJECT_GRACE_S]
        if not others:
            return ServeLoadAck(ok=True)
        target = min(others, key=self._score)
        return ServeLoadAck(ok=True, migrate_peer=target.handle.peer_id,
                            migrate_serve=target.backend_name)

    async def _eject_loop(self) -> None:
        """Fail the lease handle of a backend whose heartbeats stopped; the
        supervision loop then treats it as a worker death."""
        while True:
            await asyncio.sleep(EJECT_CHECK_S)
            self._eject_pass()

    def _eject_pass(self) -> None:
        now = time.monotonic()
        for dep in self._live_backends():
            peer = dep.handle.peer_id
            if dep.load is None:
                # Still loading its model: no heartbeats to judge by; a
                # death there fails the lease renewal instead.
                continue
            if now - dep.load_at < EJECT_GRACE_S:
                continue
            if not self._detector.suspected(peer):
                continue
            self.ejections += 1
            self._detector.remove(peer)
            log.warning("ejecting serving worker %s (phi over threshold %.1f)",
                        peer, self._detector.threshold)
            if not dep.handle.failed.done():
                dep.handle.failed.set_result(WorkerFailure(peer, "phi-accrual ejection"))

    # ------------------------------------------------------------------ impl

    async def _fill_slots(self) -> None:
        """Deploy into every empty slot."""
        for slot in range(self.num_workers):
            if self._deployments[slot] is not None or self._stop.is_set():
                continue
            try:
                dep = await self._deploy(slot)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # A worker dying mid-acceptance (or any transient dispatch
                # error) must not kill the supervisor whose whole job is
                # elastic recovery.
                log.warning("deploy of %s slot %d failed (%s); retrying",
                            self.serve_name, slot, e)
                dep = None
            if dep is not None:
                self._deployments[slot] = dep

    def _handle_event(self, dep: _Deployment, waiter) -> bool:
        """True when the deployment must be torn down and replaced."""
        if waiter is dep.handle.failed:
            log.warning("serving worker %s failed (%s); redeploying",
                        dep.handle.peer_id, dep.handle.failed.result())
            return True
        if waiter is dep.status_wait and not waiter.cancelled():
            peer, status = waiter.result()
            if status.state == "running":
                return False  # informational; keep watching
            log.warning("serving job %s reported %s on %s; redeploying",
                        dep.job_id, status.state, peer)
            return True
        return False

    def _backend_name(self, slot: int) -> str:
        # Routed backends serve under an internal name, so clients only
        # ever discover the router's serve:<name>.
        return f"{self.serve_name}@{slot}" if self.route else self.serve_name

    async def _deploy(self, slot: int) -> "_Deployment | None":
        spec = WorkerSpec(
            resources=self._resources,
            executor=[ExecutorDescriptor(executor_class="infer", name=INFER_EXECUTOR_NAME)],
        )
        # Distinct peers first: ask for enough offers that an unused worker
        # can outbid stacking a second replica on a taken one (same-peer
        # still wins when nothing else offers).
        taken = {d.handle.peer_id for d in self._live_backends()}
        offers = await self._allocator.request(
            spec, self._price, timeout=AUCTION_TIMEOUT_S, num_workers=len(taken) + 1
        )
        offers.sort(key=lambda o: o.peer_id in taken)
        if not offers:
            log.info("no offers for serving %s slot %d; retrying", self.serve_name, slot)
            return None
        handle = await WorkerHandle.create(self.node, offers[0])
        backend = self._backend_name(slot)
        config = dataclasses.replace(self._config, serve_name=backend)
        job = JobSpec(
            job_id=f"serve-{self.serve_name}-{slot}-{uuid.uuid4().hex[:8]}",
            executor=Executor(kind="infer", name=INFER_EXECUTOR_NAME, infer=config),
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
        log.info("serving %s slot %d deployed on %s (job %s)",
                 self.serve_name, slot, handle.peer_id, job.job_id)
        return _Deployment(slot=slot, handle=handle, task=task, job_id=job.job_id,
                           backend_name=backend)

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
        self._detector.remove(dep.handle.peer_id)
        # Its cached chains went with it: no longer a pull source.
        self._digests.pop(dep.backend_name, None)
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
