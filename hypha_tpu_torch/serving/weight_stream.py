"""Live weight swap: a serving worker follows a training job round by round
(counterpart of ``hypha_tpu/serving/weight_stream.py``).

The follower is one more leaf of the parameter server's update broadcast:
pushed directly in a flat job, or hung off a relay under a broadcast tree
(``stream.tree.with_serve_leaves``). The broadcast carries per-round
updates ``u_r``, not weights, so the served model is ``θ_r = θ_0 + Σ u_i``
and two invariants hold:

* **contiguity**: updates apply in strict round order from
  ``WeightFollow.round + 1``; a skipped round would serve a model no
  trainer held. :class:`WeightStager` stages out-of-order wires and
  releases only whole rounds contiguous with the last applied one;
* **atomicity**: a round spanning several fragment wires is assembled on
  the host first; the pool applies it at a chunk boundary
  (``DecodePool.request_swap``, then ``_apply_swap`` on the serve thread),
  where no forward is in flight.

:class:`WeightSubscriber` is the networked half: a ``Connector`` receive
loop on the broadcast's tag that honours the results stream's markers as
the trainers do. A generation change is noted; resync announcements (no
payload) and rejoin catch-ups (a cumulative Σ, which would apply history
twice) are dropped and counted; stale re-sends are dropped and counted by
the stager. A round lost for good wedges the follower at its last applied
round, which it keeps serving; ``stats()["held_rounds"]`` shows the gap.
"""

from __future__ import annotations

import asyncio
import logging
import tempfile
from pathlib import Path
from typing import Any

from .. import aio
from ..compress import read_delta
from ..ft.durable import RESYNC_KEY, restart_signal
from ..ft.rejoin import CATCHUP_KEY
from ..messages import FragmentTag, Receive, Reference, WeightFollow
from ..worker.connectors import Connector

__all__ = ["WeightStager", "WeightSubscriber", "follow_for"]

log = logging.getLogger("hypha.torch.serving.weight_stream")


def follow_for(results_tag: str, ps_peers: list, *, groups: "list | None" = None,
               start_round: int = 0, ps_generation: int = 0, fragments: int = 0,
               pin_round: "int | None" = None, keep_previous: bool = False) -> WeightFollow:
    """A follower's :class:`WeightFollow`, its allowlist derived as a
    trainer's is: the shard peers plus every relay head of the reduce
    ``groups`` (a dead relay's wire can come through any head; an unlisted
    sender's push is dropped, which would wedge the follower)."""
    heads = {g[0] for g in (groups or []) if len(g) >= 2}
    allowed = sorted({str(p) for p in ps_peers} | {str(h) for h in heads})
    return WeightFollow(
        results=Receive(Reference.from_peers(allowed, results_tag)),
        round=int(start_round), ps_generation=int(ps_generation), fragments=int(fragments),
        pin_round=pin_round, keep_previous=keep_previous,
    )


class WeightStager:
    """Round assembly for a follower; host state only.

    :meth:`offer` takes each decoded wire and returns the ``(round,
    update)`` pairs that became whole and contiguous with
    ``applied_round``, in apply order. A round's fragments carry disjoint
    tensors and merge by addition (a re-send overwrites its fragment in
    staging first, so nothing adds twice). ``fragments`` pins the wires a
    round needs; 0 reads it from each wire's fragment tag (an untagged wire
    is a round of one)."""

    def __init__(self, *, start_round: int = 0, ps_generation: int = 0,
                 fragments: int = 0) -> None:
        self.applied_round = int(start_round)
        self.generation = int(ps_generation)
        self.fragments = int(fragments)
        self._staging: dict = {}  # round -> fragment id -> {name: tensor}
        self._expect: dict = {}  # round -> wires needed
        self.dropped_stale = 0
        self.rounds_ready = 0
        self.generation_changes = 0

    def held_rounds(self) -> list:
        """Rounds staged but not releasable: non-empty long after traffic
        means a gap wedged the follower."""
        return sorted(self._staging)

    def _complete(self, round_num: int) -> bool:
        have = self._staging.get(round_num)
        if not have:
            return False
        return len(have) >= (self.fragments or self._expect.get(round_num, 1))

    def note_generation(self, ps_generation: Any) -> None:
        """Adopt a server generation seen on a wire. Round numbers go on
        across a restart, so staging is kept: a recovered server re-sends
        its last committed round, which overwrites."""
        if ps_generation is None:
            return
        gen = int(ps_generation)
        if gen != self.generation:
            self.generation_changes += 1
            self.generation = gen

    def offer(self, round_num: int, arrays: dict, *, fragment_id: int = 0, fragments: int = 1,
              ps_generation: Any = None) -> list:
        """Stage one decoded wire; return the rounds it made releasable. A
        wire of a round already applied (a re-send, a relay duplicate) is
        dropped and counted; a future round stages until the gap closes."""
        self.note_generation(ps_generation)
        r = int(round_num)
        if r <= self.applied_round:
            self.dropped_stale += 1
            return []
        self._staging.setdefault(r, {})[int(fragment_id)] = arrays
        self._expect[r] = max(self._expect.get(r, 1), int(fragments), 1)
        ready: list = []
        while self._complete(self.applied_round + 1):
            nxt = self.applied_round + 1
            parts = self._staging.pop(nxt)
            self._expect.pop(nxt, None)
            merged: dict = {}
            for fid in sorted(parts):
                for name, arr in parts[fid].items():
                    merged[name] = merged[name] + arr if name in merged else arr
            self.applied_round = nxt
            self.rounds_ready += 1
            ready.append((nxt, merged))
        return ready


class WeightSubscriber:
    """Broadcast wire -> stager -> the pool's swap request.

    ``pool`` has ``request_swap(updates, *, round_num, generation,
    keep_previous)`` and ``pin_round`` (``DecodePool``'s, both
    thread-safe). Frames dequantize on ``device`` (the pool's). The node
    stays the caller's; :meth:`stop` cancels the loop."""

    def __init__(self, node: Any, follow: WeightFollow, pool: Any, *,
                 work_dir: "Path | str | None" = None, device=None) -> None:
        self.follow = follow
        self.pool = pool
        self.device = device
        self._conn = Connector(node)
        self._dir = Path(work_dir) if work_dir is not None else None
        self._task: "asyncio.Task | None" = None
        self.stager = WeightStager(start_round=follow.round, ps_generation=follow.ps_generation,
                                   fragments=follow.fragments)
        self.fragments_received = 0
        self.bytes_received = 0
        self.dropped_markers = 0  # resync announcements and catch-ups
        self.decode_errors = 0
        self.swaps_requested = 0

    def start(self) -> None:
        """Spawn the receive loop on the running event loop."""
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self.run())

    async def stop(self) -> None:
        if self._task is not None:
            await aio.reap(self._task)
            self._task = None

    def stats(self) -> dict:
        return {
            "applied_round": self.stager.applied_round,
            "ps_generation": self.stager.generation,
            "fragments_received": self.fragments_received,
            "bytes_received": self.bytes_received,
            "rounds_ready": self.stager.rounds_ready,
            "held_rounds": self.stager.held_rounds(),
            "dropped_stale": self.stager.dropped_stale,
            "dropped_markers": self.dropped_markers,
            "decode_errors": self.decode_errors,
            "swaps_requested": self.swaps_requested,
        }

    async def run(self) -> None:
        """Receive wires until cancelled; a rollback pin applies before the
        first wire, so no early swap races it."""
        if self.follow.results is None:
            raise ValueError("WeightFollow.results is required to subscribe")
        if self.follow.pin_round is not None:
            self.pool.pin_round(self.follow.pin_round)
        dest = self._dir or Path(tempfile.mkdtemp(prefix="weight-stream-"))
        async for rf in self._conn.receive(self.follow.results, dest):
            try:
                await self._handle(rf)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — one bad wire, not the loop
                self.decode_errors += 1
                log.exception("weight-stream wire from %s failed", rf.from_peer)
            finally:
                Path(rf.path).unlink(missing_ok=True)

    async def _handle(self, rf: Any) -> None:
        meta = rf.meta or {}
        gen, _resend = restart_signal(meta, self.stager.generation)
        if meta.get(RESYNC_KEY) or meta.get(CATCHUP_KEY):
            self.dropped_markers += 1
            self.stager.note_generation(gen)
            log.info("weight stream: dropped a %s marker from %s",
                     "resync" if meta.get(RESYNC_KEY) else "catch-up", rf.from_peer)
            return
        tag = FragmentTag.from_header(meta)
        if tag is not None:
            round_num, fid, total = tag.round, tag.fragment_id, tag.fragments
        else:
            try:
                round_num = int(meta.get("round", 0) or 0)
            except (TypeError, ValueError):
                round_num = 0
            fid, total = 0, 1
        # Off the event loop: reading and dequantizing a large wire must
        # not stall other receives.
        arrays = await asyncio.to_thread(read_delta, Path(rf.path), self.device)
        self.fragments_received += 1
        self.bytes_received += int(rf.size or 0)
        ready = self.stager.offer(round_num, arrays, fragment_id=fid, fragments=total,
                                  ps_generation=gen)
        log.info("weight stream: round %d fragment %d/%d from %s: %d bytes; %d round(s) ready, "
                 "held %s, stale dropped %d", round_num, fid, total, rf.from_peer,
                 int(rf.size or 0), len(ready), self.stager.held_rounds(),
                 self.stager.dropped_stale)
        for r, update in ready:
            self.pool.request_swap(update, round_num=r, generation=self.stager.generation,
                                   keep_previous=self.follow.keep_previous)
            self.swaps_requested += 1
