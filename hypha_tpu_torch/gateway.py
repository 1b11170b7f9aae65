"""Gateway runtime: the network anchor (a copy of ``hypha_tpu/gateway.py``).

The gateway is the bootstrap/registry/relay node — it serves the record and
provider registry (the reference's Kademlia in ``Mode::Server``,
crates/gateway/src/network.rs:152), relays peer address books so nodes can
find each other, answers health probes, and runs no compute
(reference: crates/gateway — SURVEY.md §2.1 #8).

In this framework the registry service itself lives in
:class:`~hypha_tpu_torch.network.node.Node` (``registry_server=True``); this module
is the thin runtime composing it with health serving and lifecycle, the role
of ``hypha-gateway.rs``'s ``run()``.
"""

from __future__ import annotations

import logging

from .health import serve_health
from .network.node import Node
from .network.fabric import Transport

__all__ = ["Gateway"]

log = logging.getLogger("hypha.torch.gateway")


class Gateway:
    """Composes a registry-server Node with health serving."""

    def __init__(
        self,
        transport: Transport | None,
        peer_id: str | None = None,
        node: Node | None = None,
        **node_kwargs,
    ) -> None:
        # ``node`` injection: a caller may hand in a Node it built itself.
        self.node = node or Node(
            transport, peer_id=peer_id, registry_server=True, **node_kwargs
        )
        self._health = None
        self._running = False

    @property
    def peer_id(self) -> str:
        return self.node.peer_id

    async def start(self, listen: list[str] | None = None) -> None:
        await self.node.start(listen)
        # Gateway readiness = listening; it has no upstream bootstrap.
        self._running = True
        self._health = serve_health(self.node, lambda: self._running)
        log.info("gateway %s listening on %s", self.peer_id, self.node.listen_addrs)

    async def stop(self) -> None:
        self._running = False
        if self._health is not None:
            self._health.close()
        await self.node.stop()
