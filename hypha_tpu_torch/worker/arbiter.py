"""The dRAP auction, worker side (a copy of ``hypha_tpu/worker/arbiter.py``).

Reference: crates/worker/src/arbiter.rs — the worker subscribes to the
auction topic, windows incoming priced task-ads (100 msgs / 200 ms), filters
by supported executors + price floor + capacity, scores with the resource
evaluator, takes a short temporary lease per offer (500 ms double-booking
guard) and counter-offers; the scheduler's first ``RenewLease`` converts the
temporary lease into a live one (renewal-as-acceptance,
rfc/2025-08-04 "Lease Renewal"); a prune loop cancels jobs of expired
leases every 250 ms; ``DispatchJob`` is only honored under an active lease
owned by the dispatching peer.

Timing constants are the reference's (arbiter.rs:25-29). The re-adoption
handshake (``_on_hello``) leaves a flight-recorder record
(``scheduler.adopted``); a hello from an older scheduler generation
counts into ``FT_METRICS.stale_generation_dropped``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from .. import aio
from ..messages import (
    PROTOCOL_API,
    TOPIC_WORKER,
    Ack,
    AdoptAck,
    CancelJob,
    DispatchJob,
    DispatchJobResponse,
    ExecutorDescriptor,
    RenewLease,
    RenewLeaseResponse,
    RequestWorker,
    SchedulerHello,
    WorkerOffer,
)
from ..resources import ResourceEvaluator, WeightedResourceEvaluator
from ..leases import LeaseNotFound
from ..network.node import Node, RequestError
from ..network.utils import batched
from ..telemetry.ft_metrics import FT_METRICS
from .job_manager import JobManager
from .lease_manager import LeaseManager

__all__ = [
    "Arbiter",
    "OfferConfig",
    "OFFER_WINDOW_LIMIT",
    "OFFER_WINDOW_S",
    "OFFER_TIMEOUT_S",
    "LEASE_TIMEOUT_S",
    "PRUNE_INTERVAL_S",
]

log = logging.getLogger("hypha.torch.worker.arbiter")

# Reference constants (crates/worker/src/arbiter.rs:25-29).
OFFER_WINDOW_LIMIT = 100
OFFER_WINDOW_S = 0.200
OFFER_TIMEOUT_S = 0.500
LEASE_TIMEOUT_S = 10.0
PRUNE_INTERVAL_S = 0.250


@dataclass(slots=True)
class OfferConfig:
    """Worker pricing (crates/worker/src/config.rs:54-104)."""

    price: float = 1.0
    floor: float = 0.0  # reject ads bidding below this
    strategy: str = "flexible"  # "flexible" | "whole"


@dataclass(slots=True)
class Arbiter:
    node: Node
    lease_manager: LeaseManager
    job_manager: JobManager
    offer: OfferConfig = field(default_factory=OfferConfig)
    evaluator: ResourceEvaluator = field(default_factory=WeightedResourceEvaluator)
    _tasks: list = field(default_factory=list)
    _registrations: list = field(default_factory=list)
    _subscription: object = None

    async def start(self) -> None:
        self._registrations.append(
            self.node.on(PROTOCOL_API, RenewLease).respond_with(self._on_renew)
        )
        self._registrations.append(
            self.node.on(PROTOCOL_API, DispatchJob).respond_with(self._on_dispatch)
        )
        self._registrations.append(
            self.node.on(PROTOCOL_API, CancelJob).respond_with(self._on_cancel)
        )
        self._registrations.append(
            self.node.on(PROTOCOL_API, SchedulerHello).respond_with(
                self._on_hello
            )
        )
        self._subscription = await self.node.subscribe(TOPIC_WORKER)
        self._tasks.append(asyncio.create_task(self._auction_loop()))
        self._tasks.append(asyncio.create_task(self._prune_loop()))

    async def stop(self) -> None:
        for reg in self._registrations:
            reg.close()
        if self._subscription is not None:
            await self._subscription.close()
        await aio.reap(*self._tasks)
        await self.job_manager.shutdown()

    # ----------------------------------------------------------- auction

    async def _auction_loop(self) -> None:
        """Window ads and answer them (arbiter.rs:89-93, 284-303)."""

        async def ads():
            async for _origin, msg in self._subscription:
                if isinstance(msg, RequestWorker):
                    yield msg

        async for batch in batched(ads(), OFFER_WINDOW_LIMIT, OFFER_WINDOW_S):
            try:
                await self._process_requests(batch)
            except Exception as e:  # an auction round must never kill the loop
                log.warning("auction round failed: %s", e)

    async def _process_requests(self, requests: list[RequestWorker]) -> None:
        """Filter → score → offer, best-paying ads first (arbiter.rs:328-437)."""
        supported = set(self.job_manager.supported())
        viable: list[tuple[float, RequestWorker]] = []
        for req in requests:
            if req.spec is None or not req.reply_to:
                continue
            wanted = [(d.executor_class, d.name) for d in req.spec.executor]
            if not all(w in supported for w in wanted):
                continue  # can't run what's asked (arbiter.rs:337-353)
            if req.bid < self.offer.floor:
                continue  # under our floor (arbiter.rs:355-360)
            if self.lease_manager.resources.available().checked_sub(
                req.spec.resources
            ) is None:
                continue  # doesn't fit right now (arbiter.rs:362-373)
            score = self.evaluator.evaluate(req.bid, req.spec.resources)
            viable.append((score, req))
        # Highest price per weighted unit first (arbiter.rs:375-381).
        viable.sort(key=lambda sr: -sr[0])
        for _score, req in viable:
            await self._make_offer(req)

    async def _make_offer(self, req: RequestWorker) -> None:
        assert req.spec is not None
        if self.offer.strategy == "whole":
            # Offer everything we have at max(price, bid) (arbiter.rs:389-392).
            resources = self.lease_manager.resources.available()
            price = max(self.offer.price, req.bid)
        else:
            resources = req.spec.resources
            price = max(self.offer.price, req.bid)
        try:
            lease = self.lease_manager.request(req.reply_to, resources, OFFER_TIMEOUT_S)
        except Exception as e:
            log.debug("cannot lease for offer: %s", e)
            return
        offer = WorkerOffer(
            request_id=req.id,
            lease_id=lease.id,
            peer_id=self.node.peer_id,
            resources=resources,
            price=price,
            expires_in=OFFER_TIMEOUT_S,
            executors=[
                ExecutorDescriptor(executor_class=c, name=n)
                for (c, n) in self.job_manager.supported()
            ],
        )
        try:
            await self.node.request(req.reply_to, PROTOCOL_API, offer, timeout=5)
        except RequestError as e:
            # Offer undeliverable: free the temp lease (arbiter.rs:413-434).
            log.debug("offer to %s failed: %s", req.reply_to, e)
            try:
                self.lease_manager.remove(lease.id)
            except LeaseNotFound:
                pass

    # ------------------------------------------------------------- leases

    async def _on_renew(self, peer: str, msg: RenewLease) -> RenewLeaseResponse:
        """First renewal = acceptance; owner-checked (arbiter.rs:143-201)."""
        lease = self.lease_manager.renew(msg.lease_id, peer, LEASE_TIMEOUT_S)
        return RenewLeaseResponse(lease_id=lease.id, timeout=LEASE_TIMEOUT_S)

    async def _prune_loop(self) -> None:
        while True:
            await asyncio.sleep(PRUNE_INTERVAL_S)
            now = time.time()
            for lease in self.lease_manager.ledger.list_expired():
                # Adoption grace (ft.durable): a lease backing a
                # scheduler-recoverable job outlives its expiry — the dead
                # scheduler stopped renewing, but the execution must stay
                # adoptable until the restarted scheduler's hello (which
                # renews it) or the grace runs out (then the normal
                # expiry cancellation below fires).
                grace = self.job_manager.adopt_grace_for_lease(lease.id)
                if grace > 0 and now < lease.timeout + grace:
                    continue
                if not lease.is_expired():
                    continue  # renewed between the scan and here
                try:
                    self.lease_manager.remove(lease.id)
                except LeaseNotFound:
                    # Removed concurrently (an undeliverable-offer rollback
                    # while a previous iteration's cancel awaited): already
                    # gone, and an unhandled KeyError here would kill the
                    # prune loop for the worker's lifetime.
                    continue
                log.info("lease %s expired", lease.id)
                await self.job_manager.cancel_for_lease(lease.id)

    def _lease_lapsed(self, lease_id: str) -> bool:
        """The lease expired unrenewed, or is gone."""
        try:
            return self.lease_manager.get(lease_id).is_expired()
        except LeaseNotFound:
            return True

    async def _on_hello(self, peer: str, msg: SchedulerHello) -> AdoptAck:
        """Execution re-adoption (ft.durable DurableScheduler).

        A restarted scheduler claims a journaled execution: reply with its
        TRUE round/epoch so the scheduler fast-forwards, record the
        generation (the training/PS loops drop any response stamped with
        an older one), and re-arm the backing lease — renewals resume and
        the adoption grace ends. A hello from an OLDER generation than one
        already adopted is a zombie predecessor and is refused. The
        execution's ``adopter_released`` then reads whether that lease has
        lapsed since (the adopter stopped renewing it: its job ended).
        """
        execution = self.job_manager.get(msg.job_id)
        if execution is None:
            return AdoptAck(
                job_id=msg.job_id, state="gone",
                generation=msg.generation, ok=False,
            )
        last = execution.scheduler_generation
        if last is not None and msg.generation < last:
            FT_METRICS.stale_generation_dropped.add(1)
            return AdoptAck(
                job_id=msg.job_id, round=execution.round,
                epoch=execution.epoch, state="stale",
                generation=last, ok=False,
            )
        execution.scheduler_generation = msg.generation
        # Re-arm the lease backing this job so renewals resume from here.
        for active_job_id, lease_id in self.job_manager.lease_bindings():
            if active_job_id != msg.job_id:
                continue
            execution.adopter_released = lambda _id=lease_id: self._lease_lapsed(_id)
            try:
                self.lease_manager.renew(lease_id, peer, LEASE_TIMEOUT_S)
            except (LeaseNotFound, PermissionError) as e:
                log.warning(
                    "adoption hello for %s: lease %s re-arm failed: %s",
                    msg.job_id, lease_id, e,
                )
            break
        from ..telemetry.flight import FLIGHT

        FLIGHT.record("scheduler.adopted", node=getattr(self.node, "peer_id", None) or "worker",
                      job=msg.job_id, generation=msg.generation, round=execution.round)
        log.info(
            "execution %s adopted by scheduler generation %d (round %d)",
            msg.job_id, msg.generation, execution.round,
        )
        return AdoptAck(
            job_id=msg.job_id, round=execution.round,
            epoch=execution.epoch, state="running",
            generation=msg.generation, ok=True,
        )

    # ------------------------------------------------------------ dispatch

    async def _on_dispatch(self, peer: str, msg: DispatchJob) -> DispatchJobResponse:
        """Execute only under an active lease owned by the dispatching peer
        (arbiter.rs:203-276)."""
        try:
            lease = self.lease_manager.get(msg.lease_id)
        except LeaseNotFound:
            return DispatchJobResponse(accepted=False, message="no such lease")
        if lease.leasable.peer_id != peer:
            return DispatchJobResponse(accepted=False, message="lease not yours")
        if lease.is_expired():
            return DispatchJobResponse(accepted=False, message="lease expired")
        try:
            await self.job_manager.execute(msg.spec, msg.lease_id, peer)
        except Exception as e:
            return DispatchJobResponse(accepted=False, message=str(e))
        return DispatchJobResponse(accepted=True)

    async def _on_cancel(self, peer: str, msg: CancelJob) -> Ack:
        """Owner-checked job rollback (same lease validation as dispatch)."""
        try:
            lease = self.lease_manager.get(msg.lease_id)
        except LeaseNotFound:
            return Ack(ok=False, message="no such lease")
        if lease.leasable.peer_id != peer:
            return Ack(ok=False, message="lease not yours")
        if msg.job_id not in self.job_manager.jobs_for_lease(msg.lease_id):
            # A lease only authorizes cancelling its own jobs — another
            # scheduler's lease must not be able to kill this one's job.
            return Ack(ok=False, message="job not under this lease")
        await self.job_manager.cancel_job(msg.job_id)
        return Ack(ok=True)
