"""Deterministic fault injection for tests and the smoke (counterpart of
the event half of ``hypha_tpu/ft/chaos.py``).

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
    the durable journal and the generation handshake resume the round.

Action ``at_round=r`` fires the first time metrics for round ``r-1`` are
observed, i.e. while round ``r`` runs; ``at_round=0`` fires on attach.
:func:`parse_chaos_spec` parses every spec the reference knows (``delay``,
``partition``, ``partition-ps``, ``kill-scheduler``,
``partition-scheduler``, ``slow-worker``, ``bw-cap``, ``jitter`` too), and
the controller refuses those at construction: they are not ported
(ROADMAP.md, Queue 1: adaptive rounds and chaos kinds).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable

from .. import aio

__all__ = ["ChaosAction", "ChaosController", "parse_chaos_spec", "parse_chaos_specs"]

log = logging.getLogger("hypha.torch.ft.chaos")

_KINDS = (
    "kill", "delay", "partition", "kill-ps", "partition-ps",
    "kill-scheduler", "partition-scheduler",
    "slow", "bw-cap", "jitter",
)

# The kinds the port runs.
_PORTED = ("kill", "kill-ps")

# Kinds that model a steady condition: they attach at once unless the spec
# pins a round.
_DEGRADE_KINDS = ("slow", "bw-cap", "jitter")


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
    """Runs scripted kills against in-process worker nodes. ``workers``
    maps peer id -> anything with ``.stop()`` and ``.node``."""

    def __init__(self, actions: list, workers: dict,
                 clock: Callable[[], float] = time.monotonic) -> None:
        for action in actions:
            if action.kind not in _PORTED:
                raise NotImplementedError(
                    f"chaos action {action.kind!r} is not ported to PyTorch yet (ROADMAP.md, "
                    "Queue 1: adaptive rounds and chaos kinds)")
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
        worker = self.workers.get(action.target)
        if worker is None:
            log.warning("chaos: no worker %r to %s", action.target, action.kind)
            return
        log.info("chaos: %s %s (round trigger %d)", action.kind, action.target, action.at_round)
        aio.spawn(self._kill(worker), tasks=self._tasks, what="chaos kill", logger=log)

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

    def fired_at(self, target: str) -> "float | None":
        for action in self.fired:
            if action.target == target:
                return action.fired_at
        return None

    async def drain(self) -> None:
        """Wait for the kills in flight."""
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
