"""Scheduler-side worker handle: lease renewal as liveness (a copy of
``hypha_tpu/scheduler/worker_handle.py``).

Reference: crates/scheduler/src/worker.rs:59-177 — the ``Worker`` handle
owns a background renewal loop that re-renews at 2/3 of the granted
timeout; the *first* renewal converts the worker's temporary offer lease
into a live one (acceptance), and a renewal failure is the scheduler's
worker-failure detector, surfacing through ``failed``. ``adopt``, which
re-arms a journaled lease after a scheduler restart, raises naming
**scheduler recovery** (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import asyncio
import logging

from .. import aio
from ..messages import PROTOCOL_API, RenewLease, RenewLeaseResponse, WorkerOffer
from ..network.node import Node, RequestError

__all__ = ["WorkerHandle", "WorkerFailure"]

log = logging.getLogger("hypha.torch.scheduler.worker")


class WorkerFailure(RuntimeError):
    def __init__(self, peer_id: str, reason: str) -> None:
        super().__init__(f"worker {peer_id} failed: {reason}")
        self.peer_id = peer_id
        self.reason = reason


class WorkerHandle:
    """An allocated worker under a live, continuously-renewed lease."""

    def __init__(self, node: Node, offer: WorkerOffer) -> None:
        self.node = node
        self.offer = offer
        self.peer_id = offer.peer_id
        self.lease_id = offer.lease_id
        self.batch_size: int = 0  # set by the scheduler's sizing rule
        self.failed: asyncio.Future[WorkerFailure] = (
            asyncio.get_running_loop().create_future()
        )
        self._renewal: asyncio.Task | None = None
        self._released = False

    @classmethod
    async def create(cls, node: Node, offer: WorkerOffer) -> "WorkerHandle":
        """Accept the offer: first renewal locks the lease in, then the
        renewal loop keeps it alive (worker.rs:75-146)."""
        handle = cls(node, offer)
        timeout = await handle._renew()
        handle._renewal = asyncio.create_task(handle._renewal_loop(timeout))
        return handle

    @classmethod
    async def adopt(
        cls, node: Node, peer_id: str, lease_id: str
    ) -> "WorkerHandle":
        """Re-arm a JOURNALED lease after a scheduler restart: not ported."""
        raise NotImplementedError(
            "re-adopting a journaled lease is not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1: scheduler recovery)"
        )

    async def _renew(self) -> float:
        resp = await self.node.request(
            self.peer_id,
            PROTOCOL_API,
            RenewLease(lease_id=self.lease_id),
            timeout=5.0,
        )
        if not isinstance(resp, RenewLeaseResponse):
            raise RequestError(f"unexpected renew response {resp!r}")
        return resp.timeout

    async def _renewal_loop(self, timeout: float) -> None:
        """Re-renew at 2/3 of the granted validity (worker.rs:103-117).

        One immediate retry before declaring failure: renewing at 2/3 of
        the TTL leaves a third of it unspent, so a single RPC timeout on a
        loaded host must not depose a healthy worker — a dead node fails
        both attempts fast and detection latency stays unchanged."""
        while not self._released:
            await asyncio.sleep(timeout * 2 / 3)
            if self._released:
                return
            try:
                try:
                    timeout = await self._renew()
                except RequestError as e:
                    log.warning(
                        "renewal of %s failed (%s); one retry", self.peer_id, e
                    )
                    timeout = await self._renew()
            except RequestError as e:
                # Resolved with (not raised as) the failure so an un-awaited
                # handle doesn't log "exception never retrieved".
                if not self.failed.done():
                    self.failed.set_result(WorkerFailure(self.peer_id, str(e)))
                return

    async def release(self) -> None:
        """Stop renewing; the worker-side lease expires on its own and the
        prune loop reclaims the resources."""
        self._released = True
        await aio.reap(self._renewal)
        if not self.failed.done():
            self.failed.cancel()
