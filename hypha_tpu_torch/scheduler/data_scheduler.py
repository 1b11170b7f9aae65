"""DataScheduler: assign unique dataset slices to training workers (a copy
of ``hypha_tpu/scheduler/data_scheduler.py``).

Reference: crates/scheduler/src/scheduling/data_scheduler.rs:28-103 — an RPC
handler on the API protocol answering ``Data{dataset}`` requests with
``{data_provider, index}``, backed by the :class:`SliceTracker`'s
peer-affinity / work-stealing / epoch policy.

The reference's tracker marks a slice processed the moment it is assigned;
ours separates assignment from completion, so the handler retires a peer's
previous slice when that peer asks for the next one — same observable
behavior (every request returns a fresh slice; a dead worker's in-flight
slice can be reclaimed via ``remove_worker``).

Not ported: a request's ``prefetch`` window (a worker holding several
slices at once), which raises naming **input_pipeline** (ROADMAP.md,
Queue 1). Every request without it gets the reference's exact hold-one
behavior and response bytes.
"""

from __future__ import annotations

import logging

from ..messages import PROTOCOL_API, DataRequest, DataResponse
from ..network.node import Node
from .trackers import SliceTracker

__all__ = ["DataScheduler"]

log = logging.getLogger("hypha.torch.scheduler.data")


class DataScheduler:
    def __init__(
        self, node: Node, data_provider: str, dataset: str, num_slices: int
    ) -> None:
        self.node = node
        self.data_provider = data_provider
        self.dataset = dataset
        self.tracker = SliceTracker(num_slices)
        # peer -> (epoch, slice) it holds: the epoch guards retirement — a
        # slice handed out before an epoch wrap must not be marked
        # processed in the new epoch (it would silently never be served
        # that epoch).
        self._last: dict[str, tuple[int, int]] = {}
        self._registration = None

    def start(self) -> None:
        async def on_data(peer: str, msg: DataRequest) -> DataResponse:
            index = self.assign(peer, prefetch=msg.prefetch)
            log.debug("slice %d of %s -> %s", index, self.dataset, peer)
            return DataResponse(data_provider=self.data_provider, index=index)

        # Predicate-routed: several DataSchedulers (one per dataset) can
        # share the API protocol on one scheduler node.
        self._registration = (
            self.node.on(PROTOCOL_API, DataRequest)
            .match(lambda msg: msg.dataset == self.dataset)
            .respond_with(on_data)
        )

    def assign(self, peer: str, prefetch: int | None = None) -> int:
        """Retire the peer's held slice, then pick the next one."""
        if prefetch is not None:
            raise NotImplementedError(
                f"a slice prefetch window (prefetch={prefetch}) is not ported to "
                "PyTorch yet (ROADMAP.md, Queue 1: input_pipeline)"
            )
        held = self._last.pop(peer, None)
        if held is not None and held[0] == self.tracker.epoch:
            self.tracker.mark_processed(held[1])
        index = self.tracker.next(peer)
        self._last[peer] = (self.tracker.epoch, index)
        return index

    def held_of(self, peer: str) -> list[int]:
        """Slices the peer currently holds (tests/metrics)."""
        held = self._last.get(peer)
        return [] if held is None else [held[1]]

    def remove_worker(self, peer: str) -> None:
        """Reclaim a dead worker's held slice (tracker/slice.rs:105-114)."""
        self._last.pop(peer, None)
        self.tracker.remove_worker(peer)

    def stop(self) -> None:
        if self._registration is not None:
            self._registration.close()
            self._registration = None
