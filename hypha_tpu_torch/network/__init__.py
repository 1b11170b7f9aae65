"""The fabric: typed CBOR RPC, signed gossip, gateway registry and raw
push/pull byte streams over pluggable transports (a copy of
``hypha_tpu/network/``: ``fabric.py``, ``node.py``, ``mux.py``,
``secure.py`` and ``utils.py``).

A torch node speaks the JAX package's wire byte for byte — frames, RPC
envelopes, registry ops, push and pull headers, signed gossip frames, mux
frames — so either package's nodes share one network, under mTLS too
(``tests/test_torch_network.py``, ``tests/test_torch_certs.py``).
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
from .mux import MuxTransport
from .node import HandlerRegistration, Node, RequestError

__all__ = [
    "Node",
    "RequestError",
    "HandlerRegistration",
    "Transport",
    "MemoryTransport",
    "TcpTransport",
    "MuxTransport",
    "Stream",
    "FrameError",
    "read_frame",
    "write_frame",
]
