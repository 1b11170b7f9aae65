"""Readiness probing over ``/hypha-health/0.0.1`` (a copy of
``hypha_tpu/health.py``).

Every node type serves the same two-message health protocol
(reference: crates/messages/src/lib.rs:47-63 — ``{} -> {healthy: bool}``)
and the ``probe`` CLI subcommand dials it as a deployment smoke test
(reference: crates/scheduler/src/bin/hypha-scheduler.rs:494-535).
"""

from __future__ import annotations

from typing import Callable

from .messages import PROTOCOL_HEALTH, HealthRequest, HealthResponse
from .network.node import HandlerRegistration, Node

__all__ = ["serve_health", "probe"]


def serve_health(node: Node, ready: Callable[[], bool] = lambda: True) -> HandlerRegistration:
    """Register the health responder; ``ready`` is the node-specific readiness
    predicate (the worker's is listen+bootstrap,
    reference: crates/worker/src/bin/hypha-worker.rs:85-87,199-200)."""

    async def on_health(_peer: str, _msg: HealthRequest) -> HealthResponse:
        return HealthResponse(healthy=bool(ready()))

    return node.on(PROTOCOL_HEALTH, HealthRequest).respond_with(on_health)


async def probe(node: Node, addr: str, timeout: float = 10.0) -> bool:
    """Dial ``addr`` and ask whether the peer is healthy."""
    peer = await node.dial(addr)
    resp = await node.request(peer, PROTOCOL_HEALTH, HealthRequest(), timeout=timeout)
    return isinstance(resp, HealthResponse) and resp.healthy
