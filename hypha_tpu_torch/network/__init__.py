"""The fabric: typed CBOR RPC, gossip, gateway registry and raw push/pull
byte streams over pluggable transports (a copy of ``hypha_tpu/network/``:
``fabric.py``, ``node.py`` and ``utils.py``).

A torch node speaks the JAX package's wire byte for byte — frames, RPC
envelopes, registry ops, push and pull headers — so either package's
nodes share one network (``tests/test_torch_network.py``). Not ported:
``secure.py``'s mTLS node, whose ``secure_node`` raises, with
``certs.py``, and ``mux.py`` (ROADMAP.md, Queue 1: mTLS; network/mux.py).
"""

from .fabric import (
    FrameError,
    MemoryTransport,
    Stream,
    TcpTransport,
    Transport,
    read_frame,
    write_frame,
)
from .node import HandlerRegistration, Node, RequestError

__all__ = [
    "Node",
    "RequestError",
    "HandlerRegistration",
    "Transport",
    "MemoryTransport",
    "TcpTransport",
    "Stream",
    "FrameError",
    "read_frame",
    "write_frame",
]
