"""MetricsBridge: route per-round training metrics to a sink (a copy of
``hypha_tpu/scheduler/metrics_bridge.py``; the Aim connector posts with
``urllib`` from the standard library, as the reference's does).

Reference: crates/scheduler/src/metrics_bridge.rs:19-146 — multiplexes
``(peer, round, metrics)`` from the batch scheduler into a ``Connector``:
``NoOpConnector`` or ``AimConnector`` (one HTTP POST per metric to
``http://{status_bridge}/status`` carrying
``AimMetrics{worker_id, round, metric_name, value}``, which the
reference's 13-line FastAPI shim in front of Aim receives).
"""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.request
from typing import Callable

from .. import aio

__all__ = [
    "MetricsConnector",
    "NoOpConnector",
    "CallbackConnector",
    "AimConnector",
    "MetricsBridge",
]

log = logging.getLogger("hypha.torch.scheduler.metrics")


class MetricsConnector:
    def track(self, worker_id: str, round_num: int, name: str, value: float) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class NoOpConnector(MetricsConnector):
    def track(self, worker_id: str, round_num: int, name: str, value: float) -> None:
        log.info("metrics %s round=%d %s=%s", worker_id, round_num, name, value)


class CallbackConnector(MetricsConnector):
    """Test/embedding sink."""

    def __init__(self, fn: Callable[[str, int, str, float], None]) -> None:
        self.fn = fn

    def track(self, worker_id: str, round_num: int, name: str, value: float) -> None:
        self.fn(worker_id, round_num, name, value)


class AimConnector(MetricsConnector):
    """POST AimMetrics to the status bridge (metrics_bridge.rs:126-146).

    Posts run in background threads so a slow/dead dashboard can never stall
    the control plane; failures are logged and dropped.
    """

    def __init__(self, status_bridge: str) -> None:
        base = status_bridge if "://" in status_bridge else f"http://{status_bridge}"
        self.url = base.rstrip("/") + "/status"
        self._pending: set[asyncio.Task] = set()

    def track(self, worker_id: str, round_num: int, name: str, value: float) -> None:
        payload = {
            "worker_id": worker_id,
            "round": round_num,
            "metric_name": name,
            "value": value,
        }
        coro = asyncio.to_thread(self._post, payload)
        try:
            aio.spawn(coro, tasks=self._pending, what="metrics post", logger=log)
        except RuntimeError:  # no loop (sync contexts / tests)
            coro.close()
            self._post(payload)

    def _post(self, payload: dict) -> None:
        req = urllib.request.Request(
            self.url,
            data=json.dumps(payload).encode(),
            headers={"content-type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5):  # noqa: S310
                pass
        except Exception as e:
            log.warning("aim connector post failed: %s", e)

    async def close(self) -> None:
        if self._pending:
            await asyncio.gather(*self._pending, return_exceptions=True)


class MetricsBridge:
    """Fan (peer, round, {name: value}) out to the connector — the shape the
    batch scheduler's ``on_metrics`` callback delivers."""

    def __init__(self, connector: MetricsConnector | None = None) -> None:
        self.connector = connector or NoOpConnector()

    def on_metrics(self, peer: str, round_num: int, metrics: dict) -> None:
        for name, value in metrics.items():
            try:
                self.connector.track(peer, round_num, name, float(value))
            except (TypeError, ValueError):
                log.warning("non-numeric metric %s=%r from %s", name, value, peer)

    async def close(self) -> None:
        await self.connector.close()
