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

The input pipeline: a request carrying ``prefetch=k`` declares that the
worker holds up to ``k`` assigned slices at once (it fetches ahead while
training on the oldest), so retirement waits until the window is full and
then retires the oldest held slice, in consumption order, and only when
it was handed out in the current epoch. ``remove_worker`` reclaims every
held slice. Only answers to such requests carry the tracker's epoch:
requests without the field keep the exact hold-one behavior and answer
bytes.
"""

from __future__ import annotations

import logging
from collections import deque

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
        # peer -> deque of (epoch, slice) it holds, oldest first: the epoch
        # guards retirement — a slice handed out before an epoch wrap must
        # not be marked processed in the new epoch (it would silently never
        # be served that epoch). A peer without a prefetch window holds one.
        self._last: dict[str, deque] = {}
        self._registration = None

    def start(self) -> None:
        async def on_data(peer: str, msg: DataRequest) -> DataResponse:
            index = self.assign(peer, prefetch=msg.prefetch)
            log.debug("slice %d of %s -> %s", index, self.dataset, peer)
            resp = DataResponse(data_provider=self.data_provider, index=index)
            if msg.prefetch is not None:
                # Prefetching workers key their slice cache by (dataset,
                # epoch, index); other answers keep their bytes (epoch None
                # is omitted on the wire).
                resp.epoch = self.tracker.epoch
            return resp

        # Predicate-routed: several DataSchedulers (one per dataset) can
        # share the API protocol on one scheduler node.
        self._registration = (
            self.node.on(PROTOCOL_API, DataRequest)
            .match(lambda msg: msg.dataset == self.dataset)
            .respond_with(on_data)
        )

    def assign(self, peer: str, prefetch: int | None = None) -> int:
        """Retire the peer's oldest held slice once its window is full,
        then pick the next one; ``prefetch=None`` holds one slice (retire
        the previous on every request)."""
        window = max(int(prefetch), 1) if prefetch is not None else 1
        held = self._last.setdefault(peer, deque())
        while len(held) >= window:
            epoch, prev = held.popleft()
            if epoch == self.tracker.epoch:
                self.tracker.mark_processed(prev)
        index = self.tracker.next(peer, exclude={i for e, i in held if e == self.tracker.epoch})
        held.append((self.tracker.epoch, index))
        return index

    def held_of(self, peer: str) -> list[int]:
        """Slices the peer currently holds, oldest first (tests/metrics)."""
        return [i for _, i in self._last.get(peer, ())]

    def remove_worker(self, peer: str) -> None:
        """Reclaim every slice a dead worker holds (tracker/slice.rs:105-114)."""
        self._last.pop(peer, None)
        self.tracker.remove_worker(peer)

    def stop(self) -> None:
        if self._registration is not None:
            self._registration.close()
            self._registration = None
