"""The dRAP auction, scheduler side: broadcast a priced ad, greedily
aggregate counter-offers, lease the winners (a copy of
``hypha_tpu/scheduler/allocator.py``).

Reference: crates/scheduler/src/allocator.rs —
``GreedyWorkerAllocator.request`` registers a temporary WorkerOffer handler,
publishes the ad on the auction topic, and drives a
``GreedyOfferAggregator``: deadline-driven collection that rejects offers
over the price cap, scores with the resource evaluator, keeps the best N
with per-peer diversity, tightens its deadline to the earliest offer expiry
minus a 100 ms buffer, and returns early once N offers are in
(:67-166 request flow, :276-419 aggregator, :209-247 Candidates).
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..messages import (
    PROTOCOL_API,
    TOPIC_WORKER,
    Ack,
    PriceRange,
    RequestWorker,
    WorkerOffer,
    WorkerSpec,
)
from ..network.node import Node
from ..resources import ResourceEvaluator, WeightedResourceEvaluator

__all__ = ["Candidates", "GreedyWorkerAllocator", "EXPIRY_BUFFER_S"]

log = logging.getLogger("hypha.torch.scheduler.allocator")

# Deadline tightens to earliest offer expiry minus this (allocator.rs:375).
EXPIRY_BUFFER_S = 0.100


class Candidates:
    """Best-N offers, one per peer (allocator.rs:209-247 try_insert)."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        # peer -> (score, offer, local_expiry): expiry is this host's clock at
        # offer arrival plus the offer's relative TTL — never a remote clock.
        self._by_peer: dict[str, tuple[float, WorkerOffer, float]] = {}

    def try_insert(self, score: float, offer: WorkerOffer, local_expiry: float) -> bool:
        entry = (score, offer, local_expiry)
        existing = self._by_peer.get(offer.peer_id)
        if existing is not None:
            if score < existing[0]:  # lower score = cheaper per unit = better
                self._by_peer[offer.peer_id] = entry
                return True
            return False
        if len(self._by_peer) < self.capacity:
            self._by_peer[offer.peer_id] = entry
            return True
        worst_peer, (worst_score, _, _) = max(
            self._by_peer.items(), key=lambda kv: kv[1][0]
        )
        if score < worst_score:
            del self._by_peer[worst_peer]
            self._by_peer[offer.peer_id] = entry
            return True
        return False

    def __len__(self) -> int:
        return len(self._by_peer)

    def best(self) -> list[WorkerOffer]:
        return [o for _s, o, _e in sorted(self._by_peer.values(), key=lambda e: e[0])]

    def earliest_expiry(self) -> float | None:
        if not self._by_peer:
            return None
        return min(e for _s, _o, e in self._by_peer.values())


class GreedyWorkerAllocator:
    def __init__(
        self,
        node: Node,
        evaluator: ResourceEvaluator | None = None,
    ) -> None:
        self.node = node
        self.evaluator = evaluator or WeightedResourceEvaluator()

    async def request(
        self,
        spec: WorkerSpec,
        price: PriceRange,
        timeout: float,
        num_workers: int,
    ) -> list[WorkerOffer]:
        """Run one auction round; returns up to ``num_workers`` accepted
        offers (each backed by a temporary lease on the worker)."""
        request = RequestWorker(
            spec=spec, timeout=timeout, bid=price.bid, reply_to=self.node.peer_id
        )
        offers: asyncio.Queue[WorkerOffer] = asyncio.Queue()

        async def on_offer(peer: str, offer: WorkerOffer) -> Ack:
            if offer.request_id != request.id:
                return Ack(ok=False, message="stale auction")
            if offer.peer_id != peer:
                return Ack(ok=False, message="offer peer mismatch")
            await offers.put(offer)
            return Ack(ok=True)

        registration = self.node.on(PROTOCOL_API, WorkerOffer).respond_with(on_offer)
        try:
            await self.node.publish(TOPIC_WORKER, request)
            return await self._aggregate(offers, price, timeout, num_workers)
        finally:
            registration.close()

    async def _aggregate(
        self,
        offers: asyncio.Queue[WorkerOffer],
        price: PriceRange,
        timeout: float,
        num_workers: int,
    ) -> list[WorkerOffer]:
        candidates = Candidates(num_workers)
        deadline = time.time() + timeout
        while True:
            now = time.time()
            earliest = candidates.earliest_expiry()
            effective = deadline
            if earliest is not None:
                # Offers are backed by 500 ms temp leases; decide before the
                # earliest one lapses (allocator.rs:375).
                effective = min(deadline, earliest - EXPIRY_BUFFER_S)
            remaining = effective - now
            if remaining <= 0:
                break
            try:
                offer = await asyncio.wait_for(offers.get(), remaining)
            except asyncio.TimeoutError:
                break
            if offer.price > price.max:
                log.debug("offer %.3f over cap %.3f", offer.price, price.max)
                continue
            score = self.evaluator.evaluate(offer.price, offer.resources)
            candidates.try_insert(score, offer, time.time() + offer.expires_in)
            if len(candidates) >= num_workers:
                break  # early return (allocator.rs:124-135)
        return candidates.best()
