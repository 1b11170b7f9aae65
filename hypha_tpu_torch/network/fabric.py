"""Transports and framed streams (a copy of ``hypha_tpu/network/fabric.py``).

The fabric's wire unit is a *stream*: an ordered, reliable, bidirectional
byte pipe. Control messages ride in *frames* — an 8-byte little-endian
length followed by a CBOR body, with a hard header cap — matching the
reference's pull-stream wire shape (reference:
crates/network/src/stream_pull.rs:21-103: 8-byte LE length + bounded
header, 1 MiB cap). Bulk tensor bytes are written raw after the header
frame, never CBOR-wrapped.

Two transports:

  * :class:`MemoryTransport` — in-process fabric for tests, the role
    ``libp2p-swarm-test`` plays in the reference (SURVEY.md §4): real
    concurrent streams, no sockets.
  * :class:`TcpTransport` — asyncio TCP, optionally wrapped in mTLS
    (``ssl.SSLContext`` built by :mod:`hypha_tpu_torch.certs`); one TCP
    connection per logical stream (parallel streams beat multiplexing on throughput,
    reference rfc/2025-03-25-libp2p_network_stack.md:17-29).
"""

from __future__ import annotations

import asyncio
import logging
import ssl
import struct
from typing import Any, AsyncIterator, Awaitable, Callable

from .. import aio
from .. import codec

__all__ = [
    "FrameError",
    "MAX_FRAME",
    "Stream",
    "Transport",
    "MemoryTransport",
    "TcpTransport",
    "read_frame",
    "write_frame",
]

log = logging.getLogger("hypha.torch.network.fabric")

# Bound on a single control frame (headers, RPC bodies). Tensor payloads are
# raw bytes and unaffected. Reference caps stream headers at 1 MiB
# (crates/network/src/stream_pull.rs:28); RPC bodies get 32 MiB headroom for
# large specs.
MAX_FRAME = 32 * 1024 * 1024
# StreamReader buffer limit. asyncio's 64 KiB default caps every read() at
# 64 KiB, which on the bulk-push path costs one event-loop pass + one
# worker-thread hop per 64 KiB — a first-order throughput limit on a
# single-core host (measured in DISTBENCH: the 4 MiB limit nearly doubled
# loopback stream throughput).
STREAM_BUFFER_LIMIT = 4 * 1024 * 1024

_LEN = struct.Struct("<Q")


class FrameError(ValueError):
    pass


class Stream:
    """A bidirectional byte stream. Concrete transports subclass."""

    async def read(self, n: int = 65536) -> bytes:
        """Read up to n bytes; b'' on EOF."""
        raise NotImplementedError

    async def read_exactly(self, n: int) -> bytes:
        chunks: list[bytes] = []
        got = 0
        while got < n:
            chunk = await self.read(n - got)
            if not chunk:
                raise FrameError(f"EOF after {got}/{n} bytes")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    async def write(self, data: bytes) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        """Close the write side (half-close); reader sees EOF after drain."""
        raise NotImplementedError

    async def abort(self) -> None:
        """Tear down both directions."""
        await self.close()

    # -- framing ------------------------------------------------------------
    async def write_frame(self, obj: Any) -> int:
        return await write_frame(self, obj)

    async def read_frame(self, max_size: int = MAX_FRAME) -> Any:
        return await read_frame(self, max_size)


async def write_frame(stream: Stream, obj: Any) -> int:
    """Write one length-prefixed frame; returns the frame's wire size
    (prefix + body) so callers can account per-protocol control bytes
    without re-serializing."""
    body = codec.dumps(obj)
    if len(body) > MAX_FRAME:
        raise FrameError(f"frame too large: {len(body)}")
    await stream.write(_LEN.pack(len(body)) + body)
    return 8 + len(body)


async def read_frame(stream: Stream, max_size: int = MAX_FRAME) -> Any:
    header = await stream.read_exactly(8)
    (n,) = _LEN.unpack(header)
    if n > max_size:
        raise FrameError(f"frame of {n} bytes exceeds cap {max_size}")
    return codec.loads(await stream.read_exactly(n))


AcceptCallback = Callable[[Stream], Awaitable[None]]


class Transport:
    """Creates and accepts streams addressed by transport-specific strings."""

    async def listen(self, addr: str, on_stream: AcceptCallback) -> str:
        """Start accepting; returns the bound address (port resolved)."""
        raise NotImplementedError

    async def dial(self, addr: str) -> Stream:
        raise NotImplementedError

    async def close(self) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Memory transport
# ---------------------------------------------------------------------------


class _MemoryStream(Stream):
    """One direction-pair of queues; EOF is modeled with a None sentinel."""

    def __init__(self, rx: asyncio.Queue, tx: asyncio.Queue) -> None:
        self._rx = rx
        self._tx = tx
        self._buf = b""
        self._eof = False
        self._closed = False

    @classmethod
    def pair(cls) -> tuple["_MemoryStream", "_MemoryStream"]:
        # Bounded queues provide backpressure like a TCP window.
        a2b: asyncio.Queue = asyncio.Queue(maxsize=64)
        b2a: asyncio.Queue = asyncio.Queue(maxsize=64)
        return cls(b2a, a2b), cls(a2b, b2a)

    async def read(self, n: int = 65536) -> bytes:
        if not self._buf:
            if self._eof:
                return b""
            chunk = await self._rx.get()
            if chunk is None:
                self._eof = True
                return b""
            self._buf = chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    async def write(self, data: bytes) -> None:
        if self._closed:
            raise FrameError("write on closed stream")
        if data:
            await self._tx.put(bytes(data))

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            await self._tx.put(None)


class MemoryTransport(Transport):
    """In-process fabric; a shared hub maps addresses to listeners."""

    def __init__(self, hub: dict[str, AcceptCallback] | None = None) -> None:
        # All transports created from one hub can reach each other.
        self.hub: dict[str, AcceptCallback] = hub if hub is not None else {}
        self._listening: list[str] = []
        self._tasks: set[asyncio.Task] = set()
        self._counter = 0

    def shared(self) -> "MemoryTransport":
        """Another transport on the same hub (another in-process node)."""
        return MemoryTransport(self.hub)

    async def listen(self, addr: str, on_stream: AcceptCallback) -> str:
        if not addr or addr.endswith(":0"):
            self._counter += 1
            addr = f"mem:{id(self.hub) & 0xFFFF}-{len(self.hub)}-{self._counter}"
        if addr in self.hub:
            raise OSError(f"address in use: {addr}")
        self.hub[addr] = on_stream
        self._listening.append(addr)
        return addr

    async def dial(self, addr: str) -> Stream:
        try:
            on_stream = self.hub[addr]
        except KeyError:
            raise ConnectionRefusedError(addr) from None
        ours, theirs = _MemoryStream.pair()
        aio.spawn(on_stream(theirs), tasks=self._tasks, what="fabric accept")
        return ours

    async def close(self) -> None:
        for addr in self._listening:
            self.hub.pop(addr, None)
        self._listening.clear()
        await aio.reap(*list(self._tasks))


# ---------------------------------------------------------------------------
# TCP transport
# ---------------------------------------------------------------------------


class _TcpStream(Stream):
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._reader = reader
        self._writer = writer

    async def read(self, n: int = 65536) -> bytes:
        return await self._reader.read(n)

    async def write(self, data: bytes) -> None:
        self._writer.write(data)
        await self._writer.drain()

    async def close(self) -> None:
        try:
            if self._writer.can_write_eof():
                self._writer.write_eof()
            else:  # TLS cannot half-close; full close after drain
                self._writer.close()
        except (ConnectionError, RuntimeError):
            pass

    async def abort(self) -> None:
        try:
            self._writer.close()
        except ConnectionError:
            pass

    def sendfile_transport(self):
        """The underlying transport, for ``loop.sendfile`` (kernel zero-copy
        file→socket on plain TCP; asyncio falls back internally under TLS)."""
        return self._writer.transport

    def raw_socket_handoff(self):
        """Hand the raw socket to a thread-side drain, or None.

        The receiver mirror of ``sendfile_transport``: bulk pushes drain
        fastest with blocking ``recv_into`` straight into an mmap of the
        destination file (one kernel→page-cache copy, no event-loop
        scheduling per chunk — DISTBENCH r4's remaining gap). Only valid
        on plain TCP (TLS bytes need the event-loop's decrypt) and only
        when the caller will consume the stream to EOF: reading is paused
        here and never resumed. Returns ``(socket, buffered)`` where
        ``buffered`` is whatever the event loop had already read ahead.
        """
        if self._writer.get_extra_info("ssl_object") is not None:
            return None
        sock = self._writer.get_extra_info("socket")
        if sock is None:
            return None
        try:
            self._writer.transport.pause_reading()
        except (NotImplementedError, RuntimeError):
            return None
        try:
            buffered = bytes(self._reader._buffer)
            self._reader._buffer.clear()
        except (AttributeError, TypeError):
            # Private-API drift (StreamReader._buffer): undo the pause so
            # the fallback read loop isn't left waiting on a transport
            # that will never feed it.
            try:
                self._writer.transport.resume_reading()
            except (NotImplementedError, RuntimeError):
                pass
            return None
        return sock, buffered

    async def drain(self) -> None:
        await self._writer.drain()

    def peer_certificate(self) -> dict | None:
        ssl_obj = self._writer.get_extra_info("ssl_object")
        return ssl_obj.getpeercert() if ssl_obj else None

    def peer_certificate_der(self) -> bytes | None:
        ssl_obj = self._writer.get_extra_info("ssl_object")
        return ssl_obj.getpeercert(binary_form=True) if ssl_obj else None


class TcpTransport(Transport):
    """addr format: ``host:port``. TLS contexts from hypha_tpu_torch.certs.

    The server side accepts plain TCP and then runs the TLS handshake on
    the connection itself, so a refused peer (an untrusted or revoked
    certificate, a plain-TCP client) is logged with OpenSSL's reason and
    counted. ``counts`` holds the connections dialed and accepted (under
    TLS, each one a completed handshake) and the handshakes refused."""

    def __init__(self, server_ssl=None, client_ssl=None) -> None:
        self._server_ssl = server_ssl
        self._client_ssl = client_ssl
        self.counts = {"dialed": 0, "accepted": 0, "refused": 0}
        self._servers: list[asyncio.base_events.Server] = []
        self._conn_tasks: set[asyncio.Task] = set()

    async def listen(self, addr: str, on_stream: AcceptCallback) -> str:
        host, _, port = addr.rpartition(":")
        host = host or "127.0.0.1"

        async def handle(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
            # Track the handler task: since Python 3.12 Server.wait_closed()
            # blocks until every handler returns, so close() must be able to
            # cancel handlers parked on idle reads or undrained pushes.
            task = asyncio.current_task()
            if task is not None:
                self._conn_tasks.add(task)
                task.add_done_callback(self._conn_tasks.discard)
            if self._server_ssl is not None:
                try:
                    await writer.start_tls(self._server_ssl)
                except (ssl.SSLError, OSError, asyncio.TimeoutError) as e:
                    self.counts["refused"] += 1
                    log.warning("TLS handshake from %s refused: %s",
                                writer.get_extra_info("peername"),
                                getattr(e, "verify_message", None) or e)
                    writer.close()
                    return
            self.counts["accepted"] += 1
            stream = _TcpStream(reader, writer)
            try:
                await on_stream(stream)
            finally:
                try:
                    writer.close()
                except ConnectionError:
                    pass

        server = await asyncio.start_server(
            handle, host, int(port), limit=STREAM_BUFFER_LIMIT,
        )
        self._servers.append(server)
        bound = server.sockets[0].getsockname()
        return f"{host}:{bound[1]}"

    async def dial(self, addr: str) -> Stream:
        host, _, port = addr.rpartition(":")
        server_hostname = None
        if self._client_ssl is not None:
            # PeerID auth happens at the fabric layer (cert-key-hash), not
            # via DNS names; disable hostname checks like the reference's
            # mTLS fork does (rfc/2025-05-30_mtls.md).
            server_hostname = ""
        reader, writer = await asyncio.open_connection(
            host, int(port), ssl=self._client_ssl,
            server_hostname=server_hostname, limit=STREAM_BUFFER_LIMIT,
        )
        self.counts["dialed"] += 1
        return _TcpStream(reader, writer)

    async def close(self) -> None:
        for server in self._servers:
            server.close()
        for task in list(self._conn_tasks):
            task.cancel()
        for server in self._servers:
            await aio.wait_quiet(server.wait_closed())
        self._servers.clear()


async def copy_stream(
    src: Stream | AsyncIterator[bytes], dst: Stream, chunk: int = 1 << 20
) -> int:
    """Pump bytes src→dst; returns byte count. The fabric's io::copy."""
    total = 0
    if isinstance(src, Stream):
        while True:
            data = await src.read(chunk)
            if not data:
                break
            await dst.write(data)
            total += len(data)
    else:
        async for data in src:
            await dst.write(data)
            total += len(data)
    return total
