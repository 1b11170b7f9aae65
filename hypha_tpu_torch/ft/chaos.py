"""Deterministic fault injection for tests and the smoke (counterpart of
``hypha_tpu/ft/chaos.py``).

A :class:`ChaosController` watches the per-round metrics stream the
orchestrator's ``MetricsBridge`` sees (wire :meth:`~ChaosController.
metrics_hook` into a ``CallbackConnector``, or call
:meth:`~ChaosController.on_round_metrics` from a harness) and fires
scripted actions at round boundaries against in-process
:class:`~hypha_tpu_torch.worker.runtime.WorkerNode` objects:

  * ``kill`` (spec ``kill-worker:<round>``) — crash a train worker: its node
    stops first (its heartbeats and pushes stop mid-round), then the worker
    stops, cancelling its jobs (a trainer process gets SIGTERM, then
    SIGKILL after the grace);
  * ``kill-ps`` (spec ``kill-ps:<round>``) — the same against the parameter
    server's node; the harness restarts a node under the same peer id, and
    the durable journal and the generation handshake resume the round;
  * ``delay`` — ``delay_s`` before every outbound push of the worker;
  * ``partition`` — every outbound push and request of the worker fails;
  * ``partition-ps`` — for ``delay_s`` seconds every push between the
    parameter server and the other workers fails (both directions), then
    heals: the connectors' retries and the journal's dedup keep the round;
  * ``kill-scheduler`` (spec ``kill-scheduler:<round>``) — the same against
    the scheduler's node (its entry is anything with ``.node`` and
    ``.stop()``); the harness restarts a scheduler under the same peer id,
    which finds its journal and adopts the live executions;
  * ``partition-scheduler`` — for ``delay_s`` seconds every request and
    push from the other nodes toward the scheduler fails, then heals: the
    parked status sends and the server's parked notify keep the job.

Degrade kinds model a steady condition and fire on attach (``at_round=0``)
unless the spec pins a round:

  * ``slow-worker:<peer>:<x>`` — each Status round-trip is stretched so a
    batch takes ~``x`` times its natural wall-clock (the trainer waits for
    the Status answer between batches);
  * ``bw-cap:<peer>:<mbps>`` — every push from and to the peer, and every
    pull payload over its link, trickles at the cap, so the receiver
    measures the cap mid-transfer (the server's ``LinkTable``);
  * ``jitter:<peer>:<s>`` — a seeded pseudo-random delay in ``[0, s]`` on
    every push touching the peer (the reference's delay sequence).

Action ``at_round=r`` fires the first time metrics for round ``r-1`` are
observed, i.e. while round ``r`` runs; ``at_round=0`` fires on attach.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

from .. import aio

__all__ = ["ChaosAction", "ChaosController", "parse_chaos_spec", "parse_chaos_specs"]

log = logging.getLogger("hypha.torch.ft.chaos")

_KINDS = (
    "kill", "delay", "partition", "kill-ps", "partition-ps",
    "kill-scheduler", "partition-scheduler",
    "slow", "bw-cap", "jitter",
)

# Kinds that model a steady condition: they attach at once unless the spec
# pins a round.
_DEGRADE_KINDS = ("slow", "bw-cap", "jitter")

# A throttled push's chunk: small enough that a capped delta spreads over
# many sleeps, so the receiver sees the cap mid-stream.
_THROTTLE_CHUNK = 16 * 1024


@dataclass(slots=True)
class ChaosAction:
    kind: str  # one of _KINDS
    target: str  # peer id
    at_round: int = 1
    delay_s: float = 0.0
    factor: float = 1.0
    rate_bps: float = 0.0
    fired_at: "float | None" = None  # the clock when the action ran

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}")
        if self.at_round < 0:
            raise ValueError("at_round must be >= 0")
        if self.kind == "slow" and self.factor < 1.0:
            raise ValueError("slow-worker factor must be >= 1.0")
        if self.kind == "bw-cap" and self.rate_bps <= 0:
            raise ValueError("bw-cap rate must be positive")


def _is_number(token: str) -> bool:
    try:
        float(token)
    except ValueError:
        return False
    return True


def parse_chaos_spec(spec: str, target: str) -> ChaosAction:
    """Parse ONE chaos spec (the reference's grammar). ``target`` is the
    default victim; ``bw-cap:w1:10`` and ``slow-worker:w2:4`` name theirs."""
    parts = spec.split(":")
    head = parts[0]
    if head in ("kill-worker", "kill"):
        kind = "kill"
    elif head in ("delay-worker", "delay"):
        kind = "delay"
    elif head in ("partition-worker", "partition"):
        kind = "partition"
    elif head in ("kill-ps", "partition-ps", "kill-scheduler", "partition-scheduler"):
        kind = head
    elif head in ("slow-worker", "slow"):
        kind = "slow"
    elif head == "bw-cap":
        kind = "bw-cap"
    elif head in ("jitter", "jitter-link"):
        kind = "jitter"
    else:
        raise ValueError(f"unknown chaos spec {spec!r}")
    args = parts[1:]
    if kind in _DEGRADE_KINDS:
        if args and not _is_number(args[0]):
            target = args[0]
            args = args[1:]
        elif kind == "bw-cap":
            raise ValueError(f"bw-cap needs a peer: bw-cap:<peer>:<mbps> ({spec!r})")
        if kind == "slow":
            factor = float(args[0]) if args else 4.0
            at_round = int(args[1]) if len(args) > 1 else 0
            return ChaosAction(kind=kind, target=target, at_round=at_round, factor=factor)
        if kind == "bw-cap":
            if not args:
                raise ValueError(f"bw-cap needs a rate: bw-cap:<peer>:<mbps> ({spec!r})")
            rate_bps = float(args[0]) * 1e6
            at_round = int(args[1]) if len(args) > 1 else 0
            return ChaosAction(kind=kind, target=target, at_round=at_round, rate_bps=rate_bps)
        delay_s = float(args[0]) if args else 0.25
        at_round = int(args[1]) if len(args) > 1 else 0
        return ChaosAction(kind=kind, target=target, at_round=at_round, delay_s=delay_s)
    at_round = int(args[0]) if args else 1
    default_delay = 3.0 if kind in ("partition-ps", "partition-scheduler") else 1.0
    delay_s = float(args[1]) if len(args) > 1 else default_delay
    return ChaosAction(kind=kind, target=target, at_round=at_round, delay_s=delay_s)


def parse_chaos_specs(spec: str, target: str) -> list:
    """Parse a comma-composed spec (``kill-worker:2,kill-ps:3``)."""
    actions = [parse_chaos_spec(part.strip(), target) for part in spec.split(",")
               if part.strip()]
    if not actions:
        raise ValueError(f"empty chaos spec {spec!r}")
    return actions


class ChaosController:
    """Runs scripted actions against in-process worker nodes. ``workers``
    maps peer id -> anything with ``.stop()`` and ``.node``."""

    def __init__(self, actions: list, workers: dict,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.actions = list(actions)
        self.workers = dict(workers)
        self._clock = clock
        self._tasks: set = set()
        self.fired: list = []
        for action in self.actions:
            if action.at_round == 0:
                self._fire(action)

    def metrics_hook(self, inner: "Callable[[str, int, dict], None] | None" = None):
        """A ``(peer, round, metrics)`` callback that drives the schedule
        and chains to ``inner``."""

        def on_metrics(peer: str, round_num: int, metrics: dict) -> None:
            self.on_round_metrics(round_num)
            if inner is not None:
                inner(peer, round_num, metrics)

        return on_metrics

    def on_round_metrics(self, round_num: int) -> None:
        """Metrics for ``round_num`` were seen (the end of that round)."""
        for action in self.actions:
            if action.fired_at is None and action.at_round <= round_num + 1:
                self._fire(action)

    def _fire(self, action: ChaosAction) -> None:
        action.fired_at = self._clock()
        self.fired.append(action)
        # Flight-recorder breadcrumb: a stalled round's forensics show when
        # the injected fault fired, beside the retries and drops it caused.
        from ..telemetry.flight import FLIGHT

        FLIGHT.record(f"chaos.{action.kind}", node=action.target, target=action.target,
                      at_round=action.at_round, delay_s=action.delay_s, factor=action.factor,
                      rate_bps=action.rate_bps)
        worker = self.workers.get(action.target)
        if worker is None:
            log.warning("chaos: no worker %r to %s", action.target, action.kind)
            return
        log.info("chaos: %s %s (round trigger %d)", action.kind, action.target, action.at_round)
        if action.kind in ("kill", "kill-ps", "kill-scheduler"):
            aio.spawn(self._kill(worker), tasks=self._tasks, what="chaos kill", logger=log)
        elif action.kind == "delay":
            self._wrap_push_delay(worker.node, action.delay_s)
        elif action.kind == "partition":
            self._partition(worker.node)
        elif action.kind == "partition-ps":
            self._partition_ps(action.target, action.delay_s)
        elif action.kind == "partition-scheduler":
            self._partition_scheduler(action.target, action.delay_s)
        elif action.kind == "slow":
            self._wrap_slow_cpu(worker.node, action.factor)
        elif action.kind == "bw-cap":
            self._wrap_bw_cap(action.target, action.rate_bps)
        elif action.kind == "jitter":
            self._wrap_jitter(action.target, action.delay_s)

    @staticmethod
    async def _kill(worker: Any) -> None:
        """Crash semantics: sever the node first (instant network death),
        then stop the worker, which cancels its jobs."""
        node_stop = getattr(getattr(worker, "node", None), "stop", None)
        try:
            if callable(node_stop):
                await node_stop()
            await worker.stop()
        except Exception as e:
            log.warning("chaos kill: stop raised %s", e)

    @staticmethod
    def _wrap_push_delay(node: Any, delay_s: float) -> None:
        orig_push = node.push

        async def delayed_push(peer_id: str, resource: Any, source) -> int:
            await asyncio.sleep(delay_s)
            return await orig_push(peer_id, resource, source)

        node.push = delayed_push

    # ------------------------------------------------------- degrade wraps

    @staticmethod
    def _wrap_slow_cpu(node: Any, factor: float) -> None:
        """A slow-CPU worker: stretch every per-batch Status round-trip.

        The training thread synchronously awaits each Status response
        between batches, so sleeping ``(factor - 1) × compute`` in the
        request path makes every inner batch take ~``factor``× its
        natural wall-clock — real to the scheduler's timing statistics,
        the PS round deadline, and the worker alike. The compute estimate
        is the gap since we released the PREVIOUS Status (excluding our
        own injected sleeps, so the slowdown is a stable multiplier
        instead of compounding geometrically)."""
        from ..messages import PROTOCOL_PROGRESS, ProgressKind

        orig_request = node.request
        state = {"last": None}

        async def slow_request(peer_id: str, protocol: str, msg: Any, **kw) -> Any:
            if protocol == PROTOCOL_PROGRESS:
                if getattr(msg, "kind", None) != ProgressKind.STATUS:
                    # Round boundary (update / metrics / update-received):
                    # the gap to the NEXT status is broadcast wait, not
                    # compute — stretching it would model a slow NETWORK
                    # (and make the φ detector see huge one-off stalls),
                    # not a slow CPU. Drop the baseline instead.
                    state["last"] = None
                    return await orig_request(peer_id, protocol, msg, **kw)
                now = time.monotonic()
                last = state["last"]
                if last is not None and now > last:
                    await asyncio.sleep((factor - 1.0) * (now - last))
                result = await orig_request(peer_id, protocol, msg, **kw)
                state["last"] = time.monotonic()
                return result
            return await orig_request(peer_id, protocol, msg, **kw)

        node.request = slow_request

    @staticmethod
    def _throttled_source(source, rate_bps: float):
        """Wrap a push source (bytes | file path) in an async iterator that
        trickles chunks at ``rate_bps`` BITS/second — the receiver sees
        the cap DURING the transfer (its save_to measures it), not as an
        up-front delay it cannot attribute to the link."""

        async def gen():
            if isinstance(source, (bytes, bytearray, memoryview)):
                data = bytes(source)
                for i in range(0, max(len(data), 1), _THROTTLE_CHUNK):
                    chunk = data[i : i + _THROTTLE_CHUNK]
                    await asyncio.sleep(len(chunk) * 8.0 / rate_bps)
                    if chunk:
                        yield chunk
                return
            f = await asyncio.to_thread(open, source, "rb")
            try:
                while True:
                    chunk = await asyncio.to_thread(f.read, _THROTTLE_CHUNK)
                    if not chunk:
                        break
                    await asyncio.sleep(len(chunk) * 8.0 / rate_bps)
                    yield chunk
            finally:
                await asyncio.to_thread(f.close)

        return gen()

    def _maybe_throttled(self, source, rate_bps: float):
        """Throttle byte/file sources; pass anything already streaming
        (an async iterator — e.g. a previously wrapped source) through."""
        if isinstance(source, (bytes, bytearray, memoryview, str, Path)):
            return self._throttled_source(source, rate_bps)
        return source

    def _wrap_bw_cap(self, target: str, rate_bps: float) -> None:
        """Cap every push AND pull payload on the target's LINK (both
        directions): its own uploads (delta pushes) and served pulls
        (a capped DATA NODE's slice streams), plus pushes/pull payloads
        toward it from every other node the controller holds (update
        broadcasts, catch-ups, slices it pulls)."""
        for name, worker in self.workers.items():
            node = getattr(worker, "node", None)
            if node is None:
                continue
            handler = getattr(node, "_pull_handler", None)
            if handler is not None:
                if name == target:

                    async def capped_pull(
                        peer: str, resource: Any, _h=handler
                    ):
                        return self._maybe_throttled(
                            await _h(peer, resource), rate_bps
                        )

                else:

                    async def capped_pull(
                        peer: str, resource: Any, _h=handler
                    ):
                        source = await _h(peer, resource)
                        if peer != target:
                            return source
                        return self._maybe_throttled(source, rate_bps)

                node.on_pull(capped_pull)
            orig_push = node.push

            if name == target:

                async def capped_push(
                    peer_id: str, resource: Any, source, _orig=orig_push
                ) -> int:
                    return await _orig(
                        peer_id, resource,
                        self._throttled_source(source, rate_bps),
                    )

            else:

                async def capped_push(
                    peer_id: str, resource: Any, source, _orig=orig_push
                ) -> int:
                    if peer_id != target:
                        return await _orig(peer_id, resource, source)
                    return await _orig(
                        peer_id, resource,
                        self._throttled_source(source, rate_bps),
                    )

            node.push = capped_push

    def _wrap_jitter(self, target: str, max_delay_s: float) -> None:
        """Deterministic pseudo-random delay in [0, max_delay_s] on every
        push touching the target's link — seeded per target, so a re-run
        sees the identical delay sequence."""
        rng = random.Random(f"hypha-chaos-jitter:{target}:{max_delay_s}")

        for name, worker in self.workers.items():
            node = getattr(worker, "node", None)
            if node is None:
                continue
            orig_push = node.push
            mine = name == target

            async def jittery_push(
                peer_id: str, resource: Any, source,
                _orig=orig_push, _mine=mine,
            ) -> int:
                if _mine or peer_id == target:
                    await asyncio.sleep(rng.uniform(0.0, max_delay_s))
                return await _orig(peer_id, resource, source)

            node.push = jittery_push

    def _partition_ps(self, ps_peer: str, duration_s: float) -> None:
        """Sever the data plane between ``ps_peer`` and every other worker
        for ``duration_s`` seconds, then heal. Workers' pushes toward the
        PS (and the PS's broadcasts out) fail with RequestError — the
        exact shape a mid-restart PS presents — so the client retry path
        (aio.retry in the connectors) is what keeps the round alive."""
        from ..network.node import RequestError

        undo: list[tuple[Any, Any]] = []
        for name, worker in self.workers.items():
            node = getattr(worker, "node", None)
            if node is None:
                continue
            orig_push = node.push
            if name == ps_peer:

                async def ps_push(peer_id: str, resource: Any, source) -> int:
                    raise RequestError(
                        "chaos partition-ps: broadcast push dropped"
                    )

                node.push = ps_push
            else:

                async def worker_push(
                    peer_id: str, resource: Any, source, _orig=orig_push
                ) -> int:
                    if peer_id == ps_peer:
                        raise RequestError(
                            f"chaos partition-ps: push to {ps_peer} dropped"
                        )
                    return await _orig(peer_id, resource, source)

                node.push = worker_push
            undo.append((node, orig_push))

        async def heal() -> None:
            await asyncio.sleep(duration_s)
            for node, orig_push in undo:
                node.push = orig_push
            log.info("chaos: partition-ps around %s healed", ps_peer)

        aio.spawn(heal(), tasks=self._tasks, what="chaos heal", logger=log)

    def _partition_scheduler(self, sched_peer: str, duration_s: float) -> None:
        """Sever every other node's uplink to the scheduler for
        ``duration_s`` seconds, then heal: requests (Status,
        UpdateReceived, Updated, JobStatus) and pushes toward it fail with
        RequestError, the shape a dead or restarting scheduler presents.
        The scheduler's own lease renewals go through: this is uplink
        loss, not the crash (``kill-scheduler``)."""
        from ..network.node import RequestError

        undo: list = []
        for name, worker in self.workers.items():
            node = getattr(worker, "node", None)
            if name == sched_peer or node is None:
                continue
            orig_push, orig_request = node.push, node.request

            async def cut_push(peer_id: str, resource: Any, source, _orig=orig_push) -> int:
                if peer_id == sched_peer:
                    raise RequestError(
                        f"chaos partition-scheduler: push to {sched_peer} dropped")
                return await _orig(peer_id, resource, source)

            async def cut_request(peer_id: str, protocol: str, msg: Any, _orig=orig_request,
                                  **kw) -> Any:
                if peer_id == sched_peer:
                    raise RequestError(
                        f"chaos partition-scheduler: request to {sched_peer} dropped")
                return await _orig(peer_id, protocol, msg, **kw)

            node.push, node.request = cut_push, cut_request
            undo.append((node, orig_push, orig_request))

        async def heal() -> None:
            await asyncio.sleep(duration_s)
            for node, orig_push, orig_request in undo:
                node.push, node.request = orig_push, orig_request
            log.info("chaos: partition-scheduler around %s healed", sched_peer)

        aio.spawn(heal(), tasks=self._tasks, what="chaos heal", logger=log)

    @staticmethod
    def _partition(node: Any) -> None:
        from ..network.node import RequestError

        async def dead_push(peer_id: str, resource: Any, source) -> int:
            raise RequestError(f"chaos partition: push to {peer_id} dropped")

        async def dead_request(peer_id: str, protocol: str, msg: Any, **kw) -> Any:
            raise RequestError(f"chaos partition: request to {peer_id} dropped")

        node.push = dead_push
        node.request = dead_request

    def fired_at(self, target: str) -> "float | None":
        for action in self.fired:
            if action.target == target:
                return action.fired_at
        return None

    async def drain(self) -> None:
        """Wait for the kills in flight."""
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
