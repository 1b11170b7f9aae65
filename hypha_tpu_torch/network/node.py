"""The Node: one identity on the fabric, with typed services (a copy of
``hypha_tpu/network/node.py``).

This is the framework's equivalent of a composed libp2p swarm and the
reference's ``hypha-network`` behaviours (crates/network/src/lib.rs:37-47).
One asyncio accept-loop per node owns every inbound stream; the public
async methods are the interfaces:

  * typed CBOR RPC with fluent, first-wins handler registration
    (reference: crates/network/src/request_response.rs:44-55 fluent API,
    :503-519 first-wins matching, auto-unregister on drop :492-500);
  * gossip pub/sub with flood + message-id dedup
    (reference: crates/network/src/gossipsub.rs);
  * record/provider discovery anchored on gateway registry servers
    (reference: crates/network/src/kad.rs — Kademlia anchored on gateways);
  * raw push/pull tensor byte streams with bounded headers and inbound
    accept limits (reference: crates/network/src/stream_push.rs:16-89,
    stream_pull.rs:21-146).

Wire handshake (every stream): dialer sends one frame
``{from, proto, addr}`` — ``addr`` is the dialer's primary listen address so
the responder can dial back (the identify role). Under mTLS the responder
verifies ``from`` equals the certificate-derived peer id.

Gossip signing runs on the port's pure-Python Ed25519 (``ed25519.py``);
``Node.gossip_counts`` holds the frames this node signed, verified and
dropped for a bad or missing signature, and ``gossip_verify_s`` the
seconds of the latest verifications. Every RPC's request and response
frame counts into the per-protocol control-byte counters
(``SCALE_METRICS.note_control``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import socket
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Awaitable, Callable

from .. import aio, messages
from ..telemetry.ft_metrics import SCALE_METRICS
from .fabric import MAX_FRAME, FrameError, Stream, Transport, copy_stream

__all__ = [
    "Node",
    "RequestError",
    "HandlerRegistration",
    "Subscription",
    "PushStream",
    "PROTOCOL_GOSSIP",
    "PROTOCOL_REGISTRY",
    "PROTOCOL_PUSH",
    "PROTOCOL_PULL",
]

log = logging.getLogger("hypha.torch.network")

# Signed gossip frames carry a timestamp covered by the signature; frames
# outside this window (stale or future-dated) are dropped, bounding replay
# of captured frames to the window even after the seen-cache evicts them.
GOSSIP_MAX_SKEW_S = 120.0

PROTOCOL_GOSSIP = "/hypha-gossip/0.0.1"
PROTOCOL_REGISTRY = "/hypha-registry/0.0.1"
# Circuit relay through the gateway — the fabric's answer to the reference's
# libp2p relay server + circuit listen addresses (crates/gateway/src/
# network.rs:41-48 relay::Behaviour; crates/network/src/listen.rs:25-131
# relay-circuit listeners). Streams between two NAT'd peers are spliced
# byte-for-byte at the gateway.
PROTOCOL_RELAY = "/hypha-relay/0.0.1"
# Direct-connection upgrade over an established circuit — the fabric's
# DCUtR role (reference: dcutr in every node's behaviour,
# crates/scheduler/src/network.rs:46-95): peers exchange their direct
# addresses through the relay and both sides attempt direct dials; once one
# lands in the address book, _stream_to's direct-first ordering migrates
# traffic off the circuit.
PROTOCOL_DCUTR = "/hypha-dcutr/0.0.1"
# Per-peer cooldown between upgrade attempts (a NAT that never opens would
# otherwise burn a dial volley on every relayed RPC).
DCUTR_RETRY_S = 30.0
# Tensor stream protocol ids follow the reference names
# (crates/network/src/stream_push.rs:16, stream_pull.rs:21).
PROTOCOL_PUSH = "/hypha-tensor-stream/push"
PROTOCOL_PULL = "/hypha-tensor-stream/pull"

# Header frames on tensor streams are capped at 1 MiB
# (reference: crates/network/src/stream_pull.rs:28).
MAX_STREAM_HEADER = 1024 * 1024
# Inbound tensor streams accepted concurrently per protocol
# (reference: accept_with_limit(.., 8), stream_push.rs:56).
ACCEPT_LIMIT = 8
# Providers age out unless re-announced (clients refresh every 30 s).
PROVIDER_TTL = 90.0
# How long the relay waits for the reserved peer to dial back and accept a
# circuit before failing the dialer's connect.
RELAY_ACCEPT_TIMEOUT = 15.0
# Concurrent relayed circuits one dialer may hold open on a gateway; each
# circuit pins two sockets + a splice task for its lifetime.
RELAY_MAX_CIRCUITS_PER_PEER = 8
# Per-gateway bound on one registry op (dial + request + reply).
REGISTRY_OP_TIMEOUT = 10.0

_SEEN_CAP = 4096  # gossip dedup cache entries


class RequestError(RuntimeError):
    """Remote handler failed or RPC transport failed."""


class ExcludedAddressError(ConnectionError):
    """Dial target falls inside a configured ``exclude_cidrs`` range."""


def _parse_cidrs(cidrs: list[str]):
    import ipaddress

    return [ipaddress.ip_network(c, strict=False) for c in cidrs]


def _gossip_seen_key(
    msg_id: str, sig: bytes | None, canonical: bytes = b""
) -> str:
    """Dedup key binding the message id to the signature AND the canonical
    signed bytes, so a forged frame (altered body/origin/ts, or a reused
    genuine signature over altered data) can never occupy the genuine
    frame's dedup slot — while byte-identical flood copies still dedup
    cheaply (one sha256, no Ed25519 verify) and repeated identical
    forgeries dedup too."""
    if sig is None:
        return msg_id
    import hashlib

    return msg_id + ":" + hashlib.sha256(canonical + sig).hexdigest()[:16]


def _gossip_sign_bytes(
    topic: str, msg_id: str, origin: str, ts_ns: int, body: bytes
) -> bytes:
    """Canonical byte string covered by a gossip signature: every field a
    relay could tamper with, under a domain-separation prefix."""
    from .. import codec

    return codec.dumps(["hypha-gossip-sig", topic, msg_id, origin, ts_ns, body])


def _gossip_verify(
    topic: str, msg_id: str, origin: str, ts_ns: int, body: bytes, key: bytes, sig: bytes
) -> bool:
    """Self-certifying verification: the embedded SPKI public key must hash
    to the claimed origin peer id (same derivation as cert identities), and
    the Ed25519 signature must cover the canonical frame bytes. No key
    distribution needed — the id IS the key hash."""
    from ..certs import peer_id_from_spki_der
    from ..ed25519 import load_public_key_spki

    try:
        if peer_id_from_spki_der(key) != origin:
            return False
        return load_public_key_spki(key).verify(
            sig, _gossip_sign_bytes(topic, msg_id, origin, ts_ns, body))
    except (ValueError, TypeError):
        return False


def _addr_host(addr: str) -> str:
    return addr.rpartition(":")[0].strip("[]")


def _addr_ip(addr: str):
    """The literal IP of a ``host:port`` fabric address, or None for
    non-IP addresses (memory transport, hostnames)."""
    import ipaddress

    try:
        return ipaddress.ip_address(_addr_host(addr))
    except ValueError:
        return None


@dataclass(slots=True)
class _Handler:
    protocol: str
    msg_type: type | None
    fn: Callable[[str, Any], Awaitable[Any]]
    semaphore: asyncio.Semaphore
    registration: "HandlerRegistration"
    predicate: Callable[[Any], bool] | None = None

    def matches(self, msg: Any) -> bool:
        if self.msg_type is not None and not isinstance(msg, self.msg_type):
            return False
        return self.predicate is None or bool(self.predicate(msg))


class HandlerRegistration:
    """Handle returned by ``respond_with``; unregister via close()/ctx-mgr.

    Mirrors the reference's auto-unregister-on-drop handler streams
    (crates/network/src/request_response.rs:492-500).
    """

    def __init__(self, node: "Node") -> None:
        self._node = node
        self._handler: _Handler | None = None
        self.closed = False

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._node._unregister(self._handler)

    def __enter__(self) -> "HandlerRegistration":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class HandlerBuilder:
    """Fluent RPC handler registration: ``node.on(proto, Type)
    .concurrency(8).respond_with(handler)`` — reference fluent API shape
    (crates/network/src/request_response.rs:44-55)."""

    def __init__(self, node: "Node", protocol: str, msg_type: type | None) -> None:
        self._node = node
        self._protocol = protocol
        self._msg_type = msg_type
        self._concurrency = 16
        self._predicate: Callable[[Any], bool] | None = None

    def concurrency(self, n: int) -> "HandlerBuilder":
        self._concurrency = n
        return self

    def match(self, predicate: Callable[[Any], bool]) -> "HandlerBuilder":
        """Only dispatch messages the predicate accepts — handlers are
        matched first-wins (request_response.rs:222-259), so predicates let
        several handlers of the same type share a protocol (e.g. one
        DataScheduler per dataset)."""
        self._predicate = predicate
        return self

    def respond_with(
        self, fn: Callable[[str, Any], Awaitable[Any]]
    ) -> HandlerRegistration:
        """fn(peer_id, msg) -> response message (raised errors become
        RequestError at the caller)."""
        reg = HandlerRegistration(self._node)
        handler = _Handler(
            protocol=self._protocol,
            msg_type=self._msg_type,
            fn=fn,
            semaphore=asyncio.Semaphore(self._concurrency),
            registration=reg,
            predicate=self._predicate,
        )
        reg._handler = handler
        self._node._register(handler)
        return reg

    def into_stream(self, buffer: int = 64) -> "RequestStream":
        """Async iterator of (peer, msg, respond) triples."""
        stream = RequestStream(buffer)

        async def fn(peer: str, msg: Any) -> Any:
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            await stream._queue.put((peer, msg, fut))
            return await fut

        stream.registration = self.respond_with(fn)
        return stream


class RequestStream:
    def __init__(self, buffer: int) -> None:
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=buffer)
        self.registration: HandlerRegistration | None = None

    def __aiter__(self) -> "RequestStream":
        return self

    async def __anext__(self) -> tuple[str, Any, Callable[[Any], None]]:
        peer, msg, fut = await self._queue.get()

        def respond(response: Any) -> None:
            if not fut.done():
                fut.set_result(response)

        return peer, msg, respond

    def close(self) -> None:
        if self.registration:
            self.registration.close()


class Subscription:
    """A live gossip subscription; async-iterate (from_peer, msg)."""

    def __init__(self, node: "Node", topic: str, buffer: int = 256) -> None:
        self._node = node
        self.topic = topic
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=buffer)
        self.closed = False

    def _deliver(self, from_peer: str, msg: Any) -> None:
        if self.closed:
            return
        try:
            self._queue.put_nowait((from_peer, msg))
        except asyncio.QueueFull:
            log.warning("gossip subscriber slow; dropping message on %s", self.topic)

    def __aiter__(self) -> "Subscription":
        return self

    async def __anext__(self) -> tuple[str, Any]:
        if self.closed:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is None:  # close() sentinel
            raise StopAsyncIteration
        return item

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            await self._node._unsubscribe(self)
            # Wake a consumer already blocked in __anext__.
            try:
                self._queue.put_nowait(None)
            except asyncio.QueueFull:
                pass


class PushConsumer:
    """A routed inbound-push subscription (see Node.consume_pushes)."""

    def __init__(
        self, node: "Node", predicate: Callable[["PushStream"], bool], buffer: int
    ) -> None:
        self._node = node
        self.predicate = predicate
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=buffer)
        self.closed = False

    async def next(self, timeout: float | None = None) -> "PushStream":
        getter = self._queue.get()
        return await (getter if timeout is None else asyncio.wait_for(getter, timeout))

    def __aiter__(self) -> "PushConsumer":
        return self

    async def __anext__(self) -> "PushStream":
        return await self._queue.get()

    def close(self) -> None:
        """Stop routing to this consumer. Anything already buffered but
        undrained is released so senders aren't pinned forever."""
        if self.closed:
            return
        self.closed = True
        try:
            self._node._push_consumers.remove(self)
        except ValueError:
            pass
        while not self._queue.empty():
            push = self._queue.get_nowait()
            push.finish()


def _write_and_hash(f, data: bytes, hasher) -> None:
    """One executor hop for write + digest (hashlib releases the GIL on
    large buffers, so both stay off the event loop)."""
    f.write(data)
    hasher.update(data)


def _drain_socket_to_file(sock, buffered: bytes, path) -> int:
    """Blocking drain: recv_into an mmap of ``path`` until EOF.

    Runs in a worker thread with reading paused on the asyncio transport
    (fabric.raw_socket_handoff), so this thread is the socket's only
    reader. The file is grown in 64 MiB steps and truncated to the exact
    byte count at EOF; ``recv_into`` against the mmap writes kernel
    buffers straight into the page cache.

    asyncio hands out a TransportSocket that forbids mode changes (and the
    O_NONBLOCK status is shared with the transport's writer side anyway),
    so the fd is dup()ed into a real socket object and drained
    non-blocking with select() — which also gives the idle timeout a
    thread needs, since it can't be cancelled and a dead sender must
    surface as ConnectionError instead of a leaked thread."""
    import mmap as _mmap
    import os
    import select as _select

    grow = 64 << 20
    total = 0
    s = socket.socket(fileno=os.dup(sock.fileno()))
    try:
        with open(path, "wb+") as f:
            if buffered:
                f.write(buffered)
                total = len(buffered)
            f.truncate(total + grow)
            mm = _mmap.mmap(f.fileno(), 0)
            try:
                while True:
                    if total == mm.size():
                        f.truncate(total + grow)
                        mm.resize(total + grow)
                    try:
                        n = s.recv_into(memoryview(mm)[total:])
                    except (BlockingIOError, InterruptedError):
                        # poll, not select: select() raises on fds >= 1024,
                        # and a large fleet's node can easily sit above that.
                        p = _select.poll()
                        p.register(s, _select.POLLIN)
                        if not p.poll(60_000):
                            raise ConnectionError("push drain timed out")
                        continue
                    if n == 0:
                        break
                    total += n
            finally:
                mm.close()
            f.truncate(total)
    finally:
        s.close()
    return total


@dataclass(slots=True)
class PushStream:
    """An accepted inbound push: header + raw byte reader."""

    peer: str
    resource: Any
    stream: Stream
    _done: Callable[[], None] = field(default=lambda: None)

    async def read_all(self, chunk: int = 1 << 20) -> bytes:
        parts = []
        while True:
            data = await self.stream.read(chunk)
            if not data:
                break
            parts.append(data)
        self.finish()
        return b"".join(parts)

    async def save_to(self, path, chunk: int = 1 << 22, hasher=None) -> int:
        """Stream to disk without buffering the whole payload (the reference
        file-mediates all tensor transfers, bridge.rs:392-504).

        Default path: 4 MiB buffered reads with thread-offloaded writes —
        chunk size, not the thread hop, is the first-order cost (r4 sweep).

        Opt-in fast path (``HYPHA_RAW_DRAIN=1``, plain-TCP push connections
        only): the raw socket is handed to a dedicated thread that
        ``recv_into``s an mmap of the destination file — one
        kernel→page-cache copy, zero event-loop involvement. This closes
        DISTBENCH r4's named double-copy gap and measures ~26% faster on a
        CLEAN page cache (972 vs 771 MB/s singles), but under sustained
        writeback pressure on a slow virtio disk the mmap page-fault path
        throttles harder than write() and LOSES (DISTBENCH_r05 A/B:
        ~220-530 vs ~760-780 sustained) — so it stays off by default and
        is the right switch only for hosts with fast local disks. TLS /
        mux / relay streams always use the buffered path (their bytes
        must pass through the event loop).

        ``hasher``: optional hashlib object updated with every chunk as it
        is written — a receiver that needs a digest of the payload (the
        durable PS journal's dedup key) gets it in the same pass instead
        of re-reading the file; requesting one forces the buffered path,
        since the raw-drain handoff never surfaces the bytes."""
        import os as _os

        handoff = None
        if hasher is None and _os.environ.get("HYPHA_RAW_DRAIN") == "1":
            handoff = getattr(self.stream, "raw_socket_handoff", None)
        handoff = handoff() if handoff is not None else None
        if handoff is not None:
            sock, buffered = handoff
            try:
                total = await asyncio.to_thread(
                    _drain_socket_to_file, sock, buffered, path
                )
            finally:
                # finish() even on a failed drain — otherwise the accept
                # semaphore slot leaks and _handle_push waits forever; 8
                # timed-out senders would wedge all inbound pushes.
                self.finish()
            credit = getattr(self.stream, "credit_inbound", None)
            if credit is not None:
                credit(total)
            return total
        loop = asyncio.get_running_loop()
        total = 0
        try:
            # open() seeks/stats on the calling thread — off the loop too.
            f = await asyncio.to_thread(open, path, "wb")
            try:
                while True:
                    data = await self.stream.read(chunk)
                    if not data:
                        break
                    if hasher is None:
                        await loop.run_in_executor(None, f.write, data)
                    else:
                        await loop.run_in_executor(
                            None, _write_and_hash, f, data, hasher
                        )
                    total += len(data)
            finally:
                await asyncio.to_thread(f.close)
        finally:
            # Same wedge as the raw path: a sender dying mid-push must
            # still release the accept-semaphore slot, or ACCEPT_LIMIT
            # failed senders stop all inbound pushes.
            self.finish()
        return total

    def finish(self) -> None:
        """Release the accept slot and let the transport close the stream.
        Called automatically by read_all/save_to at EOF."""
        self._done()


class _LocalFileStream(Stream):
    """A read-only Stream over a local file — the payload carrier for
    :meth:`Node.inject_push` (a broadcast relay handing its own node the
    wire it just saved, without a loopback dial)."""

    def __init__(self, path) -> None:
        self._path = path
        self._f = None
        self._eof = False

    async def read(self, n: int = 65536) -> bytes:
        if self._eof:
            return b""
        if self._f is None:
            self._f = await asyncio.to_thread(open, self._path, "rb")
        data = await asyncio.get_running_loop().run_in_executor(
            None, self._f.read, n
        )
        if not data:
            self._eof = True
        return data

    async def write(self, data: bytes) -> None:
        raise OSError("injected push streams are read-only")

    async def close(self) -> None:
        if self._f is not None:
            f, self._f = self._f, None
            await asyncio.to_thread(f.close)

    async def abort(self) -> None:
        await self.close()


class _CountingStream(Stream):
    """Wraps a stream, crediting reads to the node's inbound byte counter
    (the reference's bandwidth-instrumented muxer role,
    crates/telemetry/src/bandwidth.rs:30-62)."""

    def __init__(self, inner: Stream, node: "Node") -> None:
        self._inner = inner
        self._node = node

    async def read(self, n: int = 65536) -> bytes:
        data = await self._inner.read(n)
        self._node.bytes_in += len(data)
        return data

    async def write(self, data: bytes) -> None:
        await self._inner.write(data)
        self._node.bytes_out += len(data)

    def raw_socket_handoff(self):
        inner = getattr(self._inner, "raw_socket_handoff", None)
        return inner() if inner is not None else None

    def credit_inbound(self, n: int) -> None:
        self._node.bytes_in += n

    async def close(self) -> None:
        await self._inner.close()

    async def abort(self) -> None:
        await self._inner.abort()


class _RelayStream(Stream):
    """A stream riding a gateway circuit. The TLS certificate on the socket
    is the *gateway's*, so certificate-derived identity checks don't apply;
    instead the stream carries the peer id the (cert-verified, trusted
    infrastructure) gateway attested for the far end. End-to-end payload
    privacy through the relay matches the deployment's trust in gateways —
    the reference's relay server likewise terminates transport security per
    hop (crates/gateway/src/network.rs:41-48)."""

    def __init__(self, inner: Stream, attested_peer: str) -> None:
        self._inner = inner
        self.attested_peer = attested_peer

    async def read(self, n: int = 65536) -> bytes:
        return await self._inner.read(n)

    async def write(self, data: bytes) -> None:
        await self._inner.write(data)

    async def close(self) -> None:
        await self._inner.close()

    async def abort(self) -> None:
        await self._inner.abort()


class Node:
    """One fabric identity: listen addresses, peerstore, typed services."""

    def __init__(
        self,
        transport: Transport,
        peer_id: str | None = None,
        bootstrap: list[str] | None = None,
        registry_server: bool = False,
        expected_peer_id: Callable[[Stream], str | None] | None = None,
        relay_server: bool | None = None,
        relay_listen: bool = False,
        advertise_listen: bool = True,
        exclude_cidrs: list[str] | None = None,
        gossip_key=None,
    ) -> None:
        self.transport = transport
        self.peer_id = peer_id or f"peer-{uuid.uuid4().hex[:16]}"
        self.listen_addrs: list[str] = []
        self.external_addrs: list[str] = []
        self._bootstrap_addrs = list(bootstrap or [])
        self._bootstrap_peers: set[str] = set()
        self._bootstrapped = asyncio.Event()
        self._registry_server = registry_server
        self._expected_peer_id = expected_peer_id
        # peerstore: peer_id -> ordered unique addrs
        self._peers: dict[str, list[str]] = {}
        # RPC handlers, first-wins in registration order per protocol
        self._handlers: dict[str, list[_Handler]] = {}
        # gossip state
        self._subs: dict[str, list[Subscription]] = {}
        self._gossip_peers: set[str] = set()
        self._seen: OrderedDict[str, None] = OrderedDict()
        # registry server state (gateway role)
        self._records: dict[str, bytes] = {}
        self._providers: dict[str, dict[str, float]] = {}  # key -> peer -> ts
        self._addr_book: dict[str, list[str]] = {}  # registered peer addrs
        self._provided: set[str] = set()  # keys this node announces (client)
        # tensor streams
        self._push_queue: asyncio.Queue = asyncio.Queue()
        self._push_consumers: list["PushConsumer"] = []
        self._push_sem = asyncio.Semaphore(ACCEPT_LIMIT)
        self._pull_sem = asyncio.Semaphore(ACCEPT_LIMIT)
        self._pull_handler: Callable[[str, Any, Stream], Awaitable[None]] | None = None
        self._tasks: set[asyncio.Task] = set()
        self._closed = False
        # relay (gateway circuit) state: gateways serve circuits by default
        # (reference: the gateway IS the relay server, gateway/network.rs:44)
        self._relay_server = registry_server if relay_server is None else relay_server
        self._relay_listen = relay_listen
        self._advertise_listen = advertise_listen
        self._relay_controls: dict[str, Stream] = {}  # reserved peer -> ctrl
        self._relay_pending: dict[str, dict] = {}  # circuit id -> record
        self._relay_active: dict[str, int] = {}  # dialer peer -> live circuits
        self._dcutr_last: dict[str, float] = {}  # peer -> last upgrade try
        # Addresses never dialed, enforced on EVERY dial — the reference
        # checks its CIDR exclusion list on each outbound connection
        # (crates/network/src/dial.rs:28-41,164).
        self._exclude_nets = _parse_cidrs(exclude_cidrs or [])
        # ed25519.Ed25519PrivateKey (the node-cert key) for gossip message
        # signing — the reference signs gossipsub messages with the swarm
        # keypair (crates/scheduler/src/network.rs:132-136). When a key is
        # present the mesh is permissioned and unsigned/invalid frames are
        # DROPPED; keyless (dev-mode) nodes accept unsigned frames but
        # still reject frames whose signature fails to verify.
        self._gossip_key = gossip_key
        self.gossip_counts = {"signed": 0, "verified": 0, "dropped": 0}
        self.gossip_verify_s: deque = deque(maxlen=4096)  # the latest verifications
        # inbound/outbound byte counters (telemetry bandwidth role,
        # reference crates/telemetry/src/bandwidth.rs)
        self.bytes_in = 0
        self.bytes_out = 0
        self.bytes_relayed = 0

    # ------------------------------------------------------------------ core

    def _spawn(self, coro, what: str = "") -> asyncio.Task:
        return aio.spawn(coro, tasks=self._tasks, what=what, logger=log)

    async def start(self, listen: list[str] | None = None) -> None:
        for addr in listen or ["", ]:
            bound = await self.transport.listen(addr, self._on_stream)
            self.listen_addrs.append(bound)
        if self._bootstrap_addrs:
            self._spawn(self._bootstrap_loop())
            if self._relay_listen:
                # Keep a circuit reservation alive at every gateway — the
                # reference's relay-circuit listen addresses
                # (crates/network/src/listen.rs:25-131).
                for gw in self._bootstrap_addrs:
                    self._spawn(self._relay_reserve_loop(gw))
        else:
            self._bootstrapped.set()  # self-anchored (tests / gateway itself)

    async def stop(self) -> None:
        self._closed = True
        # Wake consumers blocked on push_streams()/next_push().
        self._push_queue.put_nowait(None)
        for consumer in list(self._push_consumers):
            consumer.close()
        for sub_list in self._subs.values():
            for sub in list(sub_list):
                sub.closed = True
                try:
                    sub._queue.put_nowait(None)
                except asyncio.QueueFull:
                    pass
        await aio.reap(*list(self._tasks))
        await self.transport.close()

    def add_peer_addr(self, peer_id: str, addr: str) -> None:
        addrs = self._peers.setdefault(peer_id, [])
        if addr and addr not in addrs:
            addrs.append(addr)

    def primary_addr(self) -> str:
        if self.external_addrs:
            return self.external_addrs[0]
        return self.listen_addrs[0] if self.listen_addrs else ""

    async def dial(self, addr: str, proto: str = PROTOCOL_REGISTRY) -> str:
        """Dial an address to learn/verify the peer behind it (identify).
        Under mTLS the claimed id must match the certificate-derived one."""
        stream = await self._open_raw(addr, proto)
        try:
            await stream.write_frame({"t": "identify"})
            reply = await stream.read_frame()
            peer = reply.get("peer", "")
            if peer and self._expected_peer_id is not None:
                actual = self._expected_peer_id(stream)
                if actual is not None and actual != peer:
                    raise RequestError(
                        f"{addr} claims {peer} but presents certificate of {actual}"
                    )
            if peer:
                self.add_peer_addr(peer, addr)
            return peer
        finally:
            await stream.close()

    # -------------------------------------------------------------- accepting

    async def _on_stream(self, stream: Stream) -> None:
        try:
            hello = await stream.read_frame(MAX_STREAM_HEADER)
            peer = hello.get("from", "")
            proto = hello.get("proto", "")
            addr = hello.get("addr", "")
        except Exception as e:
            log.debug("bad handshake: %s", e)
            await stream.abort()
            return
        if isinstance(stream, _RelayStream):
            # Identity through a circuit comes from the gateway's attestation
            # (the gateway cert-verified the dialer); the socket cert is the
            # gateway's and proves nothing about the far end.
            if stream.attested_peer and peer != stream.attested_peer:
                log.warning(
                    "relayed peer id %s does not match gateway attestation %s",
                    peer, stream.attested_peer,
                )
                await stream.abort()
                return
        elif self._expected_peer_id is not None:
            expected = self._expected_peer_id(stream)
            if expected is not None and expected != peer:
                log.warning("peer id %s does not match certificate %s", peer, expected)
                await stream.abort()
                return
        if peer and addr:
            self.add_peer_addr(peer, addr)
        owned = True  # push streams hand ownership to the consumer
        try:
            if proto == PROTOCOL_GOSSIP:
                await self._handle_gossip(peer, stream)
            elif proto == PROTOCOL_RELAY:
                await self._handle_relay(peer, stream)
            elif proto == PROTOCOL_DCUTR:
                await self._handle_dcutr(peer, stream)
            elif proto == PROTOCOL_REGISTRY:
                await self._handle_registry(peer, stream)
            elif proto == PROTOCOL_PUSH:
                await self._handle_push(peer, stream)
                owned = False
            elif proto == PROTOCOL_PULL:
                await self._handle_pull(peer, stream)
            else:
                await self._handle_rpc(peer, proto, stream)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.debug("stream error (%s from %s): %s", proto, peer, e)
        finally:
            if owned:
                await stream.close()

    # ------------------------------------------------------------------- rpc

    def on(self, protocol: str, msg_type: type | None = None) -> HandlerBuilder:
        return HandlerBuilder(self, protocol, msg_type)

    def _register(self, handler: _Handler) -> None:
        self._handlers.setdefault(handler.protocol, []).append(handler)

    def _unregister(self, handler: _Handler | None) -> None:
        if handler is None:
            return
        lst = self._handlers.get(handler.protocol, [])
        if handler in lst:
            lst.remove(handler)

    async def _handle_rpc(self, peer: str, proto: str, stream: Stream) -> None:
        body = await stream.read_frame()
        try:
            msg = messages.decode(body)
        except Exception as e:
            await stream.write_frame({"ok": False, "error": f"decode: {e}"})
            return
        handler = next(
            (h for h in self._handlers.get(proto, []) if h.matches(msg)), None
        )
        if handler is None:
            await stream.write_frame(
                {"ok": False, "error": f"no handler for {type(msg).__name__} on {proto}"}
            )
            return
        async with handler.semaphore:
            try:
                response = await handler.fn(peer, msg)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.debug("handler error on %s: %s", proto, e)
                await stream.write_frame({"ok": False, "error": str(e)})
                return
        sent = await stream.write_frame({"ok": True, "body": messages.encode(response)})
        SCALE_METRICS.note_control(proto, sent)

    async def request(
        self, peer_id: str, protocol: str, msg: Any, timeout: float = 30.0
    ) -> Any:
        """Typed RPC to a peer; raises RequestError on failure."""
        try:
            return await asyncio.wait_for(
                self._request_inner(peer_id, protocol, msg), timeout
            )
        except asyncio.TimeoutError:
            raise RequestError(
                f"request {type(msg).__name__} to {peer_id} timed out"
            ) from None

    async def _request_inner(self, peer_id: str, protocol: str, msg: Any) -> Any:
        stream = await self._stream_to(peer_id, protocol)
        try:
            # PreEncoded payloads skip re-serialization: a scheduler
            # fanning one membership snapshot out to N parameter-service
            # shards encodes it once (the reference's messages.PreEncoded)
            # and every send ships the same bytes.
            pre = getattr(msg, "__pre_encoded__", None)
            sent = await stream.write_frame(pre if pre is not None else messages.encode(msg))
            SCALE_METRICS.note_control(protocol, sent)
            reply = await stream.read_frame()
        except (FrameError, ConnectionError, OSError) as e:
            raise RequestError(f"rpc to {peer_id} failed: {e}") from e
        finally:
            await stream.close()
        if not isinstance(reply, dict) or "ok" not in reply:
            raise RequestError(f"malformed rpc reply from {peer_id}")
        if not reply["ok"]:
            raise RequestError(reply.get("error", "remote error"))
        return messages.decode(reply["body"])

    # ---------------------------------------------------------------- dialing

    async def _check_dialable(self, addr: str) -> None:
        """Every outbound dial funnels through here — the reference enforces
        its CIDR exclusion on each dial attempt against the *resolved*
        connection address (dial.rs:28-41,164), so hostnames are resolved
        and every A/AAAA answer checked; spelling an excluded IP as a DNS
        name does not evade the policy."""
        if not self._exclude_nets:
            return
        ips = []
        ip = _addr_ip(addr)
        if ip is not None:
            ips = [ip]
        else:
            host = _addr_host(addr)
            if host:
                import ipaddress
                import socket

                try:
                    infos = await asyncio.get_running_loop().getaddrinfo(
                        host, None, type=socket.SOCK_STREAM
                    )
                    ips = [ipaddress.ip_address(i[4][0]) for i in infos]
                except (OSError, ValueError):
                    # Not a resolvable host — a transport-specific address
                    # (memory fabric etc.); no IP policy applies.
                    return
        for ip in ips:
            for net in self._exclude_nets:
                if ip.version == net.version and ip in net:
                    raise ExcludedAddressError(f"{addr} is in excluded CIDR {net}")

    async def _open_raw(self, addr: str, proto: str) -> Stream:
        await self._check_dialable(addr)
        stream = await self.transport.dial(addr)
        await stream.write_frame(
            {"from": self.peer_id, "proto": proto, "addr": self.primary_addr()}
        )
        return stream

    async def _stream_to(self, peer_id: str, proto: str) -> Stream:
        try:
            return await self._stream_to_known(peer_id, proto)
        except RequestError as first:
            # Every known route failed. A peer that RESTARTED (PS crash
            # recovery, ft.durable) re-registers with the gateway under
            # fresh addresses, but a stale peerstore entry would otherwise
            # shadow the lookup forever — purge and re-resolve once.
            stale = self._peers.pop(peer_id, None)
            found = await self._lookup_peer(peer_id)
            if not any(a for a in found if not stale or a not in stale):
                if stale:
                    self._peers.setdefault(peer_id, stale)
                raise
            try:
                return await self._stream_to_known(peer_id, proto)
            except RequestError:
                raise first

    async def _stream_to_known(self, peer_id: str, proto: str) -> Stream:
        addrs = list(self._peers.get(peer_id, []))
        if not addrs:
            found = await self._lookup_peer(peer_id)
            addrs = list(found)
        # Direct routes first; circuit routes are the fallback. If the peer
        # advertises no relay address, its gateways still might hold a
        # reservation — try ours last (dial-fallback-to-relay).
        addrs.sort(key=lambda a: a.startswith("relay:"))
        if not any(a.startswith("relay:") for a in addrs):
            addrs += [f"relay:{gw}" for gw in self._bootstrap_addrs]
        last_err: Exception | None = None
        for addr in addrs:
            if addr.startswith("relay:"):
                try:
                    stream = await self._dial_via_relay(
                        addr[len("relay:"):], peer_id, proto
                    )
                except (ConnectionError, OSError, FrameError, RequestError) as e:
                    last_err = e
                    continue
                # Circuit in use → try to upgrade to a direct connection in
                # the background (DCUtR role); future dials prefer direct.
                self._maybe_upgrade_direct(addr[len("relay:"):], peer_id)
                return stream
            try:
                stream = await self._open_raw(addr, proto)
            except (ConnectionError, OSError) as e:
                last_err = e
                continue
            # Under mTLS, the server's certificate must prove the peer id we
            # meant to reach (PeerID = cert-key-hash; rfc/2025-05-30_mtls.md).
            if self._expected_peer_id is not None:
                actual = self._expected_peer_id(stream)
                if actual is not None and actual != peer_id:
                    await stream.abort()
                    known = self._peers.get(peer_id, [])
                    if addr in known:  # a concurrent call may have removed it
                        known.remove(addr)
                    last_err = RequestError(
                        f"{addr} presented certificate of {actual}, wanted {peer_id}"
                    )
                    continue
            return stream
        raise RequestError(f"no route to {peer_id}: {last_err}")

    # ----------------------------------------------------------------- relay
    #
    # Wire (all frames ride PROTOCOL_RELAY streams after the normal hello):
    #   listener -> gateway   {"t":"reserve"}            long-lived control
    #   gateway  -> listener  {"t":"incoming","circuit","from"}   on control
    #   dialer   -> gateway   {"t":"connect","target"}   becomes circuit leg A
    #   listener -> gateway   {"t":"accept","circuit"}   becomes circuit leg B
    # After both legs ack'd the gateway splices A<->B byte-for-byte; the
    # dialer then speaks the ordinary stream protocol through the circuit.
    # Reference: crates/gateway/src/network.rs:41-48 (relay server),
    # crates/network/src/listen.rs:25-131 (circuit listen addresses).

    async def _handle_relay(self, peer: str, stream: Stream) -> None:
        frame = await stream.read_frame()
        t = frame.get("t")
        if not self._relay_server:
            await stream.write_frame({"ok": False, "error": "not a relay server"})
            return
        if t == "reserve":
            old = self._relay_controls.get(peer)
            self._relay_controls[peer] = stream
            if old is not None:
                await old.abort()
            await stream.write_frame({"ok": True})
            log.debug("relay reservation for %s", peer)
            try:
                # Park until the listener drops; EOF tears the reservation.
                while await stream.read(65536):
                    pass
            finally:
                if self._relay_controls.get(peer) is stream:
                    del self._relay_controls[peer]
        elif t == "connect":
            target = frame.get("target", "")
            ctrl = self._relay_controls.get(target)
            if ctrl is None:
                await stream.write_frame(
                    {"ok": False, "error": f"no relay reservation for {target}"}
                )
                return
            # Per-peer circuit cap: a splice pins two sockets and a pump
            # task for the circuit's lifetime, so an uncapped dialer could
            # hold arbitrarily many gateway FDs (VERDICT r3 weak #6 — the
            # reference bounds relayed connections the same way its stream
            # accepts are bounded, stream_push.rs:56).
            if self._relay_active.get(peer, 0) >= RELAY_MAX_CIRCUITS_PER_PEER:
                await stream.write_frame(
                    {"ok": False,
                     "error": f"relay circuit cap reached for {peer}"}
                )
                return
            circuit = uuid.uuid4().hex
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._relay_pending[circuit] = {"dialer": peer, "fut": fut}
            self._relay_active[peer] = self._relay_active.get(peer, 0) + 1
            try:
                try:
                    await ctrl.write_frame(
                        {"t": "incoming", "circuit": circuit, "from": peer}
                    )
                    leg_b, done = await asyncio.wait_for(fut, RELAY_ACCEPT_TIMEOUT)
                except (asyncio.TimeoutError, FrameError, ConnectionError, OSError) as e:
                    self._relay_pending.pop(circuit, None)
                    await stream.write_frame(
                        {"ok": False, "error": f"relay accept failed: {e!r}"}
                    )
                    return
                try:
                    # The ok-frame write can itself fail (dialer timed out
                    # and dropped); done.set() must run regardless or the
                    # parked accept handler and the listener leg leak.
                    await stream.write_frame({"ok": True, "peer": target})
                    await self._splice(stream, leg_b)
                finally:
                    done.set()
            finally:
                n = self._relay_active.get(peer, 1) - 1
                if n <= 0:
                    self._relay_active.pop(peer, None)
                else:
                    self._relay_active[peer] = n
        elif t == "accept":
            rec = self._relay_pending.pop(frame.get("circuit", ""), None)
            if rec is None or rec["fut"].done():
                await stream.write_frame({"ok": False, "error": "unknown circuit"})
                return
            await stream.write_frame({"ok": True, "peer": rec["dialer"]})
            done = asyncio.Event()
            rec["fut"].set_result((stream, done))
            # Hold the accept handler open for the life of the circuit — the
            # transport closes the socket when this returns.
            await done.wait()
        else:
            await stream.write_frame({"ok": False, "error": f"unknown relay op {t!r}"})

    async def _splice(self, a: Stream, b: Stream) -> None:
        """Pump bytes both ways until both directions EOF; half-close each
        destination as its source drains so in-flight replies survive."""

        async def pump(src: Stream, dst: Stream) -> None:
            try:
                self.bytes_relayed += await copy_stream(src, dst)
            finally:
                try:
                    await dst.close()
                except (ConnectionError, OSError):
                    pass

        await asyncio.gather(pump(a, b), pump(b, a), return_exceptions=True)

    async def _relay_reserve_loop(self, gw_addr: str) -> None:
        """Keep one circuit reservation alive at ``gw_addr``; advertise the
        circuit address so other peers can route to us through it."""
        backoff = 0.25
        relay_addr = f"relay:{gw_addr}"
        while not self._closed:
            try:
                stream = await self._open_raw(gw_addr, PROTOCOL_RELAY)
                try:
                    await stream.write_frame({"t": "reserve"})
                    reply = await stream.read_frame()
                    if not reply.get("ok", False):
                        raise RequestError(reply.get("error", "reserve refused"))
                    if relay_addr not in self.external_addrs:
                        self.external_addrs.append(relay_addr)
                    log.debug("relay reservation live at %s", gw_addr)
                    backoff = 0.25
                    while True:
                        frame = await stream.read_frame()
                        if frame.get("t") == "incoming":
                            self._spawn(
                                self._relay_accept(gw_addr, frame.get("circuit", ""))
                            )
                finally:
                    await stream.abort()
            except asyncio.CancelledError:
                raise
            except (ConnectionError, OSError, FrameError, RequestError) as e:
                log.debug("relay reservation at %s dropped: %s", gw_addr, e)
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 5.0)

    async def _relay_accept(self, gw_addr: str, circuit: str) -> None:
        """Dial back to the gateway to complete an announced circuit, then
        serve it like any inbound stream."""
        try:
            stream = await self._open_raw(gw_addr, PROTOCOL_RELAY)
        except (ConnectionError, OSError) as e:
            log.debug("relay accept dial to %s failed: %s", gw_addr, e)
            return
        try:
            await stream.write_frame({"t": "accept", "circuit": circuit})
            reply = await stream.read_frame()
            if not reply.get("ok", False):
                raise RequestError(reply.get("error", "accept refused"))
            dialer = reply.get("peer", "")
        except (FrameError, ConnectionError, OSError, RequestError) as e:
            log.debug("relay accept for circuit %s failed: %s", circuit, e)
            await stream.abort()
            return
        await self._on_stream(_RelayStream(stream, attested_peer=dialer))

    async def _dial_via_relay(self, gw_addr: str, target: str, proto: str) -> Stream:
        """Open a circuit to ``target`` through the gateway at ``gw_addr``.
        Returns the raw circuit; the caller speaks ``proto`` through it
        starting with the ordinary hello frame."""
        stream = await self._open_raw(gw_addr, PROTOCOL_RELAY)
        try:
            await stream.write_frame({"t": "connect", "target": target})
            reply = await asyncio.wait_for(
                stream.read_frame(), RELAY_ACCEPT_TIMEOUT + 5.0
            )
        except (FrameError, ConnectionError, OSError, asyncio.TimeoutError) as e:
            await stream.abort()
            raise RequestError(f"relay connect via {gw_addr} failed: {e!r}") from e
        if not reply.get("ok", False):
            await stream.abort()
            raise RequestError(reply.get("error", "relay connect refused"))
        attested = reply.get("peer", "")
        if attested and attested != target:
            await stream.abort()
            raise RequestError(f"relay attested {attested}, wanted {target}")
        relayed = _RelayStream(stream, attested_peer=attested)
        await relayed.write_frame(
            {"from": self.peer_id, "proto": proto, "addr": self.primary_addr()}
        )
        return relayed

    # ----------------------------------------------------------------- dcutr
    #
    # Wire (one PROTOCOL_DCUTR stream through a circuit, dialer-initiated):
    #   dialer   -> listener  {"t":"holepunch","addrs":[...direct addrs]}
    #   listener -> dialer    {"ok":true,"addrs":[...direct addrs]}
    # Then BOTH sides attempt direct dials of the other's list (the
    # simultaneous attempts are what open NAT pinholes for TCP; on an open
    # network the first reverse dial simply lands). A working address enters
    # the address book via dial()'s identify, after which _stream_to's
    # direct-before-relay ordering routes around the gateway.

    def _direct_addrs(self) -> list[str]:
        # Wildcard binds (0.0.0.0 / [::]) are listenable but not dialable;
        # advertising them would waste slots in the capped dial volley.
        out = []
        for a in [*self.listen_addrs, *self.external_addrs]:
            if a.startswith("relay:"):
                continue
            host = a.rsplit(":", 1)[0].strip("[]")
            if host in ("0.0.0.0", "::", ""):
                continue
            out.append(a)
        return out

    def _maybe_upgrade_direct(self, gw_addr: str, peer_id: str) -> None:
        """Throttled background direct-upgrade attempt for ``peer_id``.
        (No book-based skip: the book may hold direct addrs that do NOT
        work — that is exactly why this dial fell back to the relay.)"""
        now = time.monotonic()
        if now - self._dcutr_last.get(peer_id, -DCUTR_RETRY_S) < DCUTR_RETRY_S:
            return
        self._prune_dcutr(now)
        self._dcutr_last[peer_id] = now
        self._spawn(self._direct_upgrade(gw_addr, peer_id))

    def _prune_dcutr(self, now: float) -> None:
        """Entries older than the retry window carry no throttle information;
        dropping them bounds the table against peers churning fresh ids."""
        if len(self._dcutr_last) < 1024:
            return
        cutoff = now - DCUTR_RETRY_S
        self._dcutr_last = {
            p: t for p, t in self._dcutr_last.items() if t >= cutoff
        }

    # Peer-supplied candidate lists are capped: each failed candidate costs
    # up to a 5 s dial wait, so an uncapped hostile list would pin a
    # background task for hours.
    DCUTR_MAX_CANDIDATES = 8

    async def _try_direct(self, peer_id: str, addrs: list[str]) -> None:
        """Dial candidates until one identifies as ``peer_id``; dial()
        records the working address in the address book."""
        for addr in addrs[: self.DCUTR_MAX_CANDIDATES]:
            try:
                got = await asyncio.wait_for(self.dial(addr), 5.0)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.debug("dcutr: direct dial %s failed: %s", addr, e)
                continue
            if got == peer_id:
                log.debug("dcutr: direct route to %s via %s", peer_id, addr)
                return
        log.debug("dcutr: no direct route to %s (tried %d)", peer_id, len(addrs))

    async def _direct_upgrade(self, gw_addr: str, target: str) -> None:
        """Dialer side: exchange direct addresses over a fresh circuit, then
        race a direct dial while the listener dials us back."""
        try:
            stream = await self._dial_via_relay(gw_addr, target, PROTOCOL_DCUTR)
        except (ConnectionError, OSError, FrameError, RequestError) as e:
            log.debug("dcutr: circuit to %s failed: %s", target, e)
            return
        try:
            await stream.write_frame(
                {"t": "holepunch", "addrs": self._direct_addrs()}
            )
            reply = await asyncio.wait_for(stream.read_frame(), 10.0)
        except (FrameError, ConnectionError, OSError, asyncio.TimeoutError) as e:
            log.debug("dcutr: exchange with %s failed: %s", target, e)
            return
        finally:
            await stream.close()
        if reply.get("ok"):
            addrs = [a for a in reply.get("addrs", []) if isinstance(a, str)]
            await self._try_direct(target, addrs)

    async def _handle_dcutr(self, peer: str, stream: Stream) -> None:
        frame = await stream.read_frame()
        if frame.get("t") != "holepunch":
            await stream.write_frame({"ok": False, "error": "unknown dcutr op"})
            return
        await stream.write_frame({"ok": True, "addrs": self._direct_addrs()})
        # The dial-back volley is throttled like the initiating side — a
        # peer opening dcutr streams in a loop must not multiply background
        # dial tasks (the address list is additionally capped in
        # _try_direct).
        now = time.monotonic()
        if now - self._dcutr_last.get(peer, -DCUTR_RETRY_S) < DCUTR_RETRY_S:
            return
        self._prune_dcutr(now)
        self._dcutr_last[peer] = now
        addrs = [a for a in frame.get("addrs", []) if isinstance(a, str)]
        # Dial back outside the circuit's lifetime.
        self._spawn(self._try_direct(peer, addrs))

    # ---------------------------------------------------------------- gossip

    def add_gossip_peer(self, peer_id: str) -> None:
        if peer_id != self.peer_id:
            self._gossip_peers.add(peer_id)

    async def subscribe(self, topic: str, buffer: int = 256) -> Subscription:
        sub = Subscription(self, topic, buffer)
        self._subs.setdefault(topic, []).append(sub)
        return sub

    async def _unsubscribe(self, sub: Subscription) -> None:
        lst = self._subs.get(sub.topic, [])
        if sub in lst:
            lst.remove(sub)

    async def publish(self, topic: str, msg: Any) -> None:
        """Flood ``msg`` to the mesh. When the node has a ``gossip_key``
        (every mTLS node does), the frame carries an Ed25519 signature by
        the origin's cert key and receivers verify key-hash == origin, so
        the ``origin`` delivered to subscribers is authenticated end-to-end
        across relays (reference: signed gossipsub,
        crates/scheduler/src/network.rs:132-136), and a signed timestamp
        bounds replay of captured frames to GOSSIP_MAX_SKEW_S. Within that
        window a mesh member can still re-flood a captured frame, so treat
        gossip as advertisement, not authorization — security-relevant
        follow-ups (offers, leases, dispatch) run over cert-verified RPC.
        Keyless dev-mode nodes flood unsigned and accept unsigned."""
        msg_id = uuid.uuid4().hex
        body = messages.encode(msg)
        key = sig = None
        ts_ns = time.time_ns()
        if self._gossip_key is not None:
            key = self._gossip_key.public_key().spki_der()
            canonical = _gossip_sign_bytes(topic, msg_id, self.peer_id, ts_ns, body)
            sig = self._gossip_key.sign(canonical)
            self.gossip_counts["signed"] += 1
            self._mark_seen(_gossip_seen_key(msg_id, sig, canonical))
        else:
            self._mark_seen(_gossip_seen_key(msg_id, None))
        self._deliver_local(topic, self.peer_id, body)
        await self._gossip_fanout(
            topic, msg_id, self.peer_id, body, exclude=set(),
            key=key, sig=sig, ts_ns=ts_ns,
        )

    def _mark_seen(self, msg_id: str) -> bool:
        """Returns True if this id is new."""
        if msg_id in self._seen:
            return False
        self._seen[msg_id] = None
        while len(self._seen) > _SEEN_CAP:
            self._seen.popitem(last=False)
        return True

    def _deliver_local(self, topic: str, origin: str, body: bytes) -> None:
        subs = self._subs.get(topic)
        if not subs:
            return
        try:
            msg = messages.decode(body)
        except Exception as e:
            log.debug("dropping undecodable gossip on %s: %s", topic, e)
            return
        for sub in list(subs):
            sub._deliver(origin, msg)

    async def _gossip_fanout(
        self,
        topic: str,
        msg_id: str,
        origin: str,
        body: bytes,
        exclude: set[str],
        key: bytes | None = None,
        sig: bytes | None = None,
        ts_ns: int = 0,
    ) -> None:
        frame = {
            "t": "pub",
            "topic": topic,
            "id": msg_id,
            "origin": origin,
            "data": body,
        }
        if key is not None and sig is not None:
            # Relays forward the ORIGIN's key+signature untouched, so
            # verification is end-to-end regardless of the flood path.
            frame["key"] = key
            frame["sig"] = sig
            frame["ts"] = ts_ns
        targets = [p for p in self._gossip_peers if p not in exclude]
        # Fire in parallel; unreachable peers are dropped from the mesh.
        results = await asyncio.gather(
            *(self._send_gossip(p, frame) for p in targets), return_exceptions=True
        )
        for peer, res in zip(targets, results):
            if isinstance(res, Exception):
                log.debug("gossip peer %s unreachable: %s", peer, res)
                self._gossip_peers.discard(peer)

    async def _send_gossip(self, peer_id: str, frame: dict) -> None:
        stream = await self._stream_to(peer_id, PROTOCOL_GOSSIP)
        try:
            await stream.write_frame(frame)
        finally:
            await stream.close()

    async def _handle_gossip(self, peer: str, stream: Stream) -> None:
        frame = await stream.read_frame()
        # Any peer speaking gossip to us joins our mesh (bidirectional flood).
        if peer:
            self.add_gossip_peer(peer)
        t = frame.get("t")
        if t == "pub":
            msg_id = frame.get("id", "")
            topic = frame.get("topic", "")
            origin = frame.get("origin", peer)
            body = frame.get("data", b"")
            key, sig = frame.get("key"), frame.get("sig")
            ts_ns = int(frame.get("ts", 0))
            # Dedup keyed on (id, canonical-bytes, sig) BEFORE the Ed25519
            # verify: identical flood copies of a genuine frame short-circuit
            # without paying verification, while any forgery reusing the id
            # hashes to a different key, misses the cache, fails verification
            # — and cannot poison the dedup entry of the real message.
            canonical = (
                _gossip_sign_bytes(topic, msg_id, origin, ts_ns, body)
                if sig is not None
                else b""
            )
            if not self._mark_seen(_gossip_seen_key(msg_id, sig, canonical)):
                return
            if key is not None and sig is not None:
                if abs(time.time_ns() - ts_ns) > GOSSIP_MAX_SKEW_S * 1e9:
                    self.gossip_counts["dropped"] += 1
                    log.warning(
                        "dropping gossip on %s: frame from %s outside the "
                        "freshness window (replay or clock skew)", topic, origin,
                    )
                    return
                t0 = time.perf_counter()
                ok = _gossip_verify(topic, msg_id, origin, ts_ns, body, key, sig)
                self.gossip_verify_s.append(time.perf_counter() - t0)
                if not ok:
                    self.gossip_counts["dropped"] += 1
                    log.warning(
                        "dropping gossip on %s: bad signature for origin %s "
                        "(relayed by %s)", topic, origin, peer,
                    )
                    return
                self.gossip_counts["verified"] += 1
            elif self._gossip_key is not None:
                # This node runs a signed mesh; unsigned frames are dropped
                # (reference: gossipsub ValidationMode::Strict).
                self.gossip_counts["dropped"] += 1
                log.warning(
                    "dropping unsigned gossip on %s from %s", topic, peer
                )
                return
            self._deliver_local(topic, origin, body)
            self._spawn(
                self._gossip_fanout(
                    topic, msg_id, origin, body, exclude={peer},
                    key=key, sig=sig, ts_ns=ts_ns,
                )
            )
        # "sub"/"unsub" frames are accepted for forward-compat; flood
        # forwarding does not require remote subscription state.

    # -------------------------------------------------------------- discovery

    async def _bootstrap_loop(self) -> None:
        """Dial every gateway until at least one registration succeeds; keep
        registrations and provider announcements fresh (the reference's kad
        bootstrap + identify role). Unreachable gateways back off
        exponentially (250 ms → 5 s)."""
        backoff = 0.25
        while not self._closed:
            ok = False
            for addr in self._bootstrap_addrs:
                try:
                    peer = await self._register_with_gateway(addr)
                    if peer:
                        self._bootstrap_peers.add(peer)
                        self.add_gossip_peer(peer)
                        ok = True
                except (ConnectionError, OSError, FrameError, RequestError) as e:
                    log.debug("bootstrap dial %s failed: %s", addr, e)
            if ok:
                backoff = 0.25
                self._bootstrapped.set()
                for key in list(self._provided):  # refresh provider TTLs
                    try:
                        await self.provide(key)
                    except RequestError:
                        pass
                await asyncio.sleep(30.0)  # refresh registration
            else:
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    async def _register_with_gateway(self, addr: str) -> str:
        stream = await self._open_raw(addr, PROTOCOL_REGISTRY)
        try:
            await stream.write_frame(
                {"t": "register", "peer": self.peer_id, "addrs": self._my_addrs()}
            )
            reply = await stream.read_frame()
            peer = reply.get("peer", "")
            if peer:
                self.add_peer_addr(peer, addr)
            return peer
        finally:
            await stream.close()

    def _my_addrs(self) -> list[str]:
        """Addresses to advertise. A NAT'd node (``advertise_listen=False``)
        publishes only its external/circuit addresses — its listen addrs are
        private-network noise to other peers; the DCUtR exchange is the
        channel that hands those candidates to a peer at upgrade time."""
        if not self._advertise_listen:
            return list(dict.fromkeys(self.external_addrs))
        return list(dict.fromkeys(self.external_addrs + self.listen_addrs))

    async def wait_for_bootstrap(self, timeout: float = 60.0) -> None:
        await asyncio.wait_for(self._bootstrapped.wait(), timeout)

    # Registry ops that mutate state replicate to EVERY reachable gateway —
    # the reference's records/providers replicate across the Kademlia DHT
    # (crates/network/src/kad.rs:482-700); with first-reachable-only writes
    # a gateway crash lost records until the 30 s refresh re-announced them
    # (VERDICT r3 missing #3).
    _REGISTRY_WRITE_OPS = frozenset({"put", "provide", "unprovide"})

    async def _registry_one(self, addr: str, frame: dict) -> dict:
        # Bounded per gateway: with writes fanning out to every gateway, an
        # accepting-but-silent one must not stall the op (the healthy
        # gateways are the whole point of replication). Timeout surfaces as
        # ConnectionError so the caller's failover handles it uniformly.
        async def op() -> dict:
            stream = await self._open_raw(addr, PROTOCOL_REGISTRY)
            try:
                await stream.write_frame(frame)
                return await stream.read_frame()
            finally:
                await stream.close()

        try:
            # wait_for, not asyncio.timeout: the latter is Python 3.11+.
            return await asyncio.wait_for(op(), REGISTRY_OP_TIMEOUT)
        except (TimeoutError, asyncio.TimeoutError) as e:
            raise ConnectionError(f"registry op timed out at {addr}") from e

    async def _registry_call(self, frame: dict) -> dict:
        """Run a registry op against gateways (or locally if self-anchored).

        Writes go to all reachable gateways (success = at least one ack);
        ``find`` merges providers across gateways; other reads return the
        first POSITIVE answer, falling back to a negative one only when no
        gateway answers positively — so a lookup keeps resolving while the
        gateway that took the original write is down.
        """
        if self._registry_server or not self._bootstrap_addrs:
            return self._registry_apply("", frame)
        t = frame.get("t")
        last: Exception | None = None
        if t in self._REGISTRY_WRITE_OPS:
            # Concurrent fan-out: k unreachable gateways must cost one
            # REGISTRY_OP_TIMEOUT, not k of them — write ops run inside
            # periodic re-announce loops that share the event loop with
            # lease heartbeats.
            results = await asyncio.gather(
                *(self._registry_one(a, frame) for a in self._bootstrap_addrs),
                return_exceptions=True,
            )
            acks: list[dict] = []
            for r in results:
                if isinstance(r, (ConnectionError, OSError, FrameError)):
                    last = r
                elif isinstance(r, BaseException):
                    raise r
                else:
                    acks.append(r)
            for reply in acks:
                if reply.get("ok", False):
                    return reply
            if acks:
                return acks[0]
            raise RequestError(f"no gateway reachable: {last}")
        if t == "find":
            merged: dict[str, dict] = {}
            reached = False
            for addr in self._bootstrap_addrs:
                try:
                    reply = await self._registry_one(addr, frame)
                except (ConnectionError, OSError, FrameError) as e:
                    last = e
                    continue
                reached = True
                for p in reply.get("providers", []):
                    merged.setdefault(p.get("peer", ""), p)
            if not reached:
                raise RequestError(f"no gateway reachable: {last}")
            return {"ok": True, "providers": list(merged.values())}
        negative: dict | None = None
        for addr in self._bootstrap_addrs:
            try:
                reply = await self._registry_one(addr, frame)
            except (ConnectionError, OSError, FrameError) as e:
                last = e
                continue
            if reply.get("ok", False):
                return reply
            if negative is None:
                negative = reply
        if negative is not None:
            return negative
        raise RequestError(f"no gateway reachable: {last}")

    async def put_record(self, key: str, value: bytes) -> None:
        reply = await self._registry_call({"t": "put", "key": key, "value": value})
        if not reply.get("ok", False):
            raise RequestError(reply.get("error", "put failed"))

    async def get_record(self, key: str) -> bytes | None:
        reply = await self._registry_call({"t": "get", "key": key})
        return reply.get("value") if reply.get("ok", False) else None

    async def provide(self, key: str) -> None:
        self._provided.add(key)  # re-announced by the bootstrap refresh loop
        reply = await self._registry_call(
            {"t": "provide", "key": key, "peer": self.peer_id, "addrs": self._my_addrs()}
        )
        if not reply.get("ok", False):
            raise RequestError(reply.get("error", "provide failed"))

    async def unprovide(self, key: str) -> None:
        """Withdraw a provider announcement: stop the refresh loop from
        re-announcing AND delete the registry entry now (clients must not
        keep discovering a dead server until the TTL sweep)."""
        self._provided.discard(key)
        try:
            await self._registry_call(
                {"t": "unprovide", "key": key, "peer": self.peer_id}
            )
        except RequestError as e:
            # Best effort: with the refresh stopped, PROVIDER_TTL ages the
            # entry out anyway.
            log.debug("unprovide %s failed: %s", key, e)

    async def find_providers(self, key: str) -> list[str]:
        reply = await self._registry_call({"t": "find", "key": key})
        providers = reply.get("providers", [])
        for p in providers:
            for a in p.get("addrs", []):
                self.add_peer_addr(p["peer"], a)
        return [p["peer"] for p in providers]

    async def _lookup_peer(self, peer_id: str) -> list[str]:
        try:
            reply = await self._registry_call({"t": "lookup", "peer": peer_id})
        except RequestError:
            return []
        addrs = reply.get("addrs", []) if reply.get("ok", False) else []
        for a in addrs:
            self.add_peer_addr(peer_id, a)
        return addrs

    def _registry_apply(self, from_peer: str, frame: dict) -> dict:
        """Server-side registry ops (gateway role, kad Mode::Server)."""
        t = frame.get("t")
        if t == "identify":
            return {"ok": True, "peer": self.peer_id}
        if t == "register":
            # Identity comes from the handshake (cert-verified under mTLS),
            # never from the frame body — a trusted-but-malicious peer must
            # not be able to overwrite another peer's address book entry.
            peer, addrs = from_peer or frame.get("peer", ""), frame.get("addrs", [])
            if peer:
                self._addr_book[peer] = list(addrs)
                self.add_gossip_peer(peer)
                for a in addrs:
                    self.add_peer_addr(peer, a)
            return {"ok": True, "peer": self.peer_id}
        if t == "put":
            self._records[frame.get("key", "")] = frame.get("value", b"")
            return {"ok": True}
        if t == "get":
            key = frame.get("key", "")
            if key in self._records:
                return {"ok": True, "value": self._records[key]}
            return {"ok": False, "error": f"no record {key!r}"}
        if t == "provide":
            key, peer = frame.get("key", ""), from_peer or frame.get("peer", "")
            self._providers.setdefault(key, {})[peer] = time.time()
            if frame.get("addrs"):
                self._addr_book[peer] = list(frame["addrs"])
            return {"ok": True}
        if t == "unprovide":
            key, peer = frame.get("key", ""), from_peer or frame.get("peer", "")
            self._providers.get(key, {}).pop(peer, None)
            return {"ok": True}
        if t == "find":
            # Drop providers that stopped refreshing (crashed data nodes must
            # age out; clients re-announce every 30 s from _bootstrap_loop).
            entries = self._providers.get(frame.get("key", ""), {})
            cutoff = time.time() - PROVIDER_TTL
            for p in [p for p, ts in entries.items() if ts < cutoff]:
                del entries[p]
            out = [
                {"peer": p, "addrs": self._addr_book.get(p, [])} for p in entries
            ]
            return {"ok": True, "providers": out}
        if t == "lookup":
            peer = frame.get("peer", "")
            addrs = self._addr_book.get(peer)
            if addrs is None:
                return {"ok": False, "error": f"unknown peer {peer}"}
            return {"ok": True, "addrs": addrs}
        return {"ok": False, "error": f"unknown registry op {t!r}"}

    async def _handle_registry(self, peer: str, stream: Stream) -> None:
        frame = await stream.read_frame()
        if not self._registry_server and frame.get("t") not in ("identify",):
            await stream.write_frame({"ok": False, "error": "not a registry server"})
            return
        await stream.write_frame(self._registry_apply(peer, frame))

    # --------------------------------------------------------- tensor streams

    async def push(self, peer_id: str, resource: Any, source) -> int:
        """Open a push stream: header frame, then raw bytes from ``source``
        (bytes | file path | async byte iterator). Returns bytes sent."""
        t0 = time.perf_counter()
        stream = await self._stream_to(peer_id, PROTOCOL_PUSH)
        try:
            await stream.write_frame(messages.encode(resource))
            if isinstance(
                source, (bytes, bytearray, memoryview, str)
            ) or hasattr(source, "__fspath__"):
                # Lump-sum accounting keeps the sendfile fast path.
                n = await self._write_source(stream, source)
                self.bytes_out += n
                if not isinstance(source, (bytes, bytearray, memoryview)):
                    # A file: a Δθ or an update, the round's bulk transfer.
                    log.info("push to %s: %d bytes in %.3f s; header %s", peer_id, n,
                             time.perf_counter() - t0, json.dumps(resource, default=str))
            else:
                # Streamed (iterator) sources credit the outbound counter
                # chunk by chunk: a slow / throttled transfer must read as
                # its true rate on the bandwidth gauges, not as one burst
                # at completion (the metrics plane's link rollups compare
                # rates across peers).
                n = await self._write_source(_CountingStream(stream, self), source)
            return n
        finally:
            await stream.close()

    async def _write_source(self, stream: Stream, source) -> int:
        """Stream bytes | file path | async iterator | Stream into ``stream``."""
        if isinstance(source, (bytes, bytearray, memoryview)):
            data = bytes(source)
            await stream.write(data)
            return len(data)
        if isinstance(source, str) or hasattr(source, "__fspath__"):
            loop = asyncio.get_running_loop()
            # Zero-copy fast path (the data node's hot serve loop, reference
            # tensor_data.rs:8-16 io::copy): kernel sendfile on plain TCP;
            # asyncio streams the fallback itself under TLS.
            transport = getattr(stream, "sendfile_transport", lambda: None)()
            if transport is not None:
                f = await asyncio.to_thread(open, source, "rb")
                try:
                    return await loop.sendfile(transport, f, fallback=True)
                except (AttributeError, NotImplementedError, RuntimeError):
                    pass  # transport without sendfile support: chunked copy
                finally:
                    await asyncio.to_thread(f.close)
            total = 0
            f = await asyncio.to_thread(open, source, "rb")
            try:
                while True:
                    chunk = await loop.run_in_executor(None, f.read, 1 << 20)
                    if not chunk:
                        break
                    await stream.write(chunk)
                    total += len(chunk)
            finally:
                await asyncio.to_thread(f.close)
            return total
        return await copy_stream(source, stream)

    async def _handle_push(self, peer: str, stream: Stream) -> None:
        header = await stream.read_frame(MAX_STREAM_HEADER)
        resource = messages.decode(header)
        await self._push_sem.acquire()
        finished = asyncio.Event()

        def done() -> None:
            if not finished.is_set():
                finished.set()
                self._push_sem.release()

        push = PushStream(
            peer=peer,
            resource=resource,
            stream=_CountingStream(stream, self),
            _done=done,
        )
        # Route to the first registered consumer whose predicate matches;
        # unmatched pushes land on the shared default queue. Predicate
        # routing is what lets one node host several stream consumers at
        # once (a parameter-server job AND a train job's receive, or two
        # jobs' bridges) without eating each other's transfers.
        target = self._push_queue
        for consumer in self._push_consumers:
            try:
                matches = consumer.predicate(push)
            except Exception:
                matches = False
            if matches:
                target = consumer._queue
                break
        await target.put(push)
        # Keep the transport connection alive until the consumer drains it
        # (TCP closes the socket when the accept callback returns).
        await finished.wait()

    async def inject_push(
        self,
        peer: str,
        resource: Any,
        path,
        on_done: Callable[[], None] | None = None,
    ) -> None:
        """Deliver a LOCAL push into this node's own consumer routing.

        A broadcast-tree relay (``stream.reduce.BroadcastRelay``)
        receives a wire addressed to its subtree and must also hand it to
        the training loop on the SAME node — dialing oneself would burn a
        socket and an accept slot for a file already on local disk.
        ``peer`` attributes the push to its true origin (the sending hop),
        so receiver-side allowlists behave exactly as for a wire push.
        ``on_done`` fires when the consumer finishes with the stream
        (save_to/read_all EOF), after which the caller may unlink ``path``.
        Bypasses the inbound accept semaphore deliberately: local delivery
        must not contend with (or deadlock behind) 8 slow remote senders.
        """
        stream = _LocalFileStream(path)
        fired = False

        def done() -> None:
            nonlocal fired
            if fired:
                return
            fired = True
            # Best-effort file-handle cleanup; the event loop is running,
            # so schedule rather than await.
            aio.spawn(stream.close(), what="inject_push close", logger=log)
            if on_done is not None:
                on_done()

        push = PushStream(
            peer=peer, resource=resource, stream=stream, _done=done
        )
        target = self._push_queue
        for consumer in self._push_consumers:
            try:
                matches = consumer.predicate(push)
            except Exception:
                matches = False
            if matches:
                target = consumer._queue
                break
        await target.put(push)

    def consume_pushes(
        self, predicate: Callable[[PushStream], bool], buffer: int = 64
    ) -> "PushConsumer":
        """Register a routed push consumer (first registered, first matched).
        Close it to unroute; buffered pushes can still be drained after.

        Pushes that arrived BEFORE registration (e.g. a parameter-server
        broadcast landing between two of the executor's receive windows) sit
        on the default queue; reclaim the matching ones now.
        """
        consumer = PushConsumer(self, predicate, buffer)
        self._push_consumers.append(consumer)
        leftover = []
        while not self._push_queue.empty():
            item = self._push_queue.get_nowait()
            if item is None:  # stop sentinel: keep for other consumers
                leftover.append(item)
                continue
            try:
                matched = predicate(item)
            except Exception:
                matched = False
            if matched and not consumer._queue.full():
                consumer._queue.put_nowait(item)
            else:
                leftover.append(item)
        for item in leftover:
            self._push_queue.put_nowait(item)
        return consumer

    async def push_streams(self) -> AsyncIterator[PushStream]:
        """Async iterator over accepted inbound pushes; terminates on node
        stop. ``read_all``/``save_to`` release the accept slot at EOF."""
        while not self._closed:
            item = await self._push_queue.get()
            if item is None:  # stop() sentinel; re-arm for other consumers
                self._push_queue.put_nowait(None)
                return
            yield item

    async def next_push(self, timeout: float | None = None) -> PushStream:
        getter = self._push_queue.get()
        item = await (getter if timeout is None else asyncio.wait_for(getter, timeout))
        if item is None:
            self._push_queue.put_nowait(None)
            raise RequestError("node stopped")
        return item

    def on_pull(self, handler: Callable[[str, Any], Awaitable[Any]]) -> None:
        """Register the pull server: handler(peer, resource) returns the
        payload source (bytes | file path | async iterator). A status frame
        precedes the payload on the wire, so handler failures surface as
        RequestError at the puller instead of an empty payload
        (reference: data node serve loop, hypha-data.rs:187-209)."""
        self._pull_handler = handler

    async def _handle_pull(self, peer: str, stream: Stream) -> None:
        header = await stream.read_frame(MAX_STREAM_HEADER)
        resource = messages.decode(header)
        async with self._pull_sem:
            if self._pull_handler is None:
                await stream.write_frame({"ok": False, "error": "no pull handler"})
                return
            try:
                source = await self._pull_handler(peer, resource)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                await stream.write_frame({"ok": False, "error": str(e)})
                return
            await stream.write_frame({"ok": True})
            self.bytes_out += await self._write_source(stream, source)

    async def pull(self, peer_id: str, resource: Any) -> Stream:
        """Open a pull stream: send the bounded resource header, check the
        status frame, return the byte stream of the payload (reference:
        stream_pull.rs:66-103 — 8-byte LE length + bounded header)."""
        stream = await self._stream_to(peer_id, PROTOCOL_PULL)
        try:
            await stream.write_frame(messages.encode(resource))
            status = await stream.read_frame()
        except (FrameError, ConnectionError, OSError) as e:
            await stream.abort()
            raise RequestError(f"pull from {peer_id} failed: {e}") from e
        if not status.get("ok", False):
            await stream.abort()
            raise RequestError(status.get("error", "pull refused"))
        return _CountingStream(stream, self)
