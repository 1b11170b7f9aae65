"""Stream-multiplexing transport: many logical streams, one connection
(a copy of ``hypha_tpu/network/mux.py``).

The reference's transport stack layers a muxer (yamux) over TCP+TLS and also
runs QUIC — both give N logical streams per connection/handshake
(crates/scheduler/src/network.rs:109-131). The base fabric here deliberately
uses one TCP connection per stream for BULK throughput (the reference's own
RFC measured parallel streams beating yamux, rfc/2025-03-25:17-29), but that
costs a TCP+mTLS handshake per RPC — painful on the chatty auction path.
``MuxTransport`` is the second transport: it wraps any base
:class:`Transport` and multiplexes logical streams over one persistent
connection per remote address.

Wire format (one muxed connection): frames of

    [4B stream_id LE][1B flag][4B length LE][payload]

flags: 1=OPEN (dialer-initiated stream; ids odd from dialer, even from
listener), 2=DATA, 3=CLOSE (half-close, EOF after drain), 4=RESET (abort).
Per-stream inbound buffers are bounded (``window`` bytes); a sender that
overruns a slow consumer blocks on the shared connection — the documented
head-of-line tradeoff vs the parallel-connection base transport (use that
for bulk tensor pushes; mux for RPC).

TLS identity: logical streams expose the underlying connection's peer
certificate, so PeerID = cert-key-hash checks work unchanged.

``MuxTransport.counts`` holds the logical streams dialed and accepted
(the base transport counts its connections), so a node can show what one
connection per peer saves.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Callable

from .. import aio
from .fabric import AcceptCallback, Stream, Transport

__all__ = ["MuxTransport"]

log = logging.getLogger("hypha.torch.network.mux")

_HDR = struct.Struct("<IBI")
_OPEN, _DATA, _CLOSE, _RESET = 1, 2, 3, 4
_MAX_CHUNK = 1 << 20


class _MuxStream(Stream):
    """One logical stream riding a muxed connection."""

    def __init__(self, conn: "_MuxConn", sid: int) -> None:
        self._conn = conn
        self.sid = sid
        self._rx: asyncio.Queue = asyncio.Queue()
        self._buf = b""
        self._eof = False
        self._closed = False
        # Window accounting: bytes queued here but not yet read. Credited
        # back either by read() or — for streams closed/reset/aborted with
        # unread data — by _detach(), so an abandoned stream can never stall
        # the connection's window permanently.
        self._undrained = 0
        self._detached = False

    # -- reading ------------------------------------------------------------
    async def read(self, n: int = 65536) -> bytes:
        if not self._buf:
            if self._eof:
                return b""
            chunk = await self._rx.get()
            if chunk is None:
                self._eof = True
                return b""
            if not self._detached:
                self._undrained -= len(chunk)
                self._conn._credit(len(chunk))
            self._buf = chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _deliver(self, data: bytes | None) -> None:
        if data is not None and not self._detached:
            self._undrained += len(data)
        self._rx.put_nowait(data)

    def _detach(self) -> None:
        """Return any unread bytes to the connection window (the stream may
        still be drained afterwards; those reads no longer credit)."""
        if not self._detached:
            self._detached = True
            if self._undrained:
                self._conn._credit(self._undrained)
                self._undrained = 0

    # -- writing ------------------------------------------------------------
    async def write(self, data: bytes) -> None:
        if self._closed:
            raise ConnectionError("write on closed mux stream")
        mv = memoryview(bytes(data))
        for off in range(0, len(mv), _MAX_CHUNK):
            await self._conn.send(self.sid, _DATA, mv[off : off + _MAX_CHUNK])

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                await self._conn.send(self.sid, _CLOSE, b"")
            except (ConnectionError, OSError):
                pass

    async def abort(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                await self._conn.send(self.sid, _RESET, b"")
            except (ConnectionError, OSError):
                pass
        # Unregister so late frames for this sid are dropped, and return the
        # window credit for anything buffered.
        self._conn._streams.pop(self.sid, None)
        self._detach()
        self._deliver(None)

    # -- identity pass-through ---------------------------------------------
    def peer_certificate(self):
        fn = getattr(self._conn.base, "peer_certificate", None)
        return fn() if fn else None

    def peer_certificate_der(self):
        fn = getattr(self._conn.base, "peer_certificate_der", None)
        return fn() if fn else None


class _MuxConn:
    """One muxed base connection: frame pump + stream table."""

    def __init__(
        self,
        base: Stream,
        dialer: bool,
        on_stream: AcceptCallback | None,
        window: int = 4 << 20,
    ) -> None:
        self.base = base
        self._dialer = dialer
        self._on_stream = on_stream
        self._streams: dict[int, _MuxStream] = {}
        self._next_id = 1 if dialer else 2
        self._wlock = asyncio.Lock()
        self._window = window
        self._inflight = 0
        self._has_credit = asyncio.Event()
        self._has_credit.set()
        self.closed = False
        self._tasks: set[asyncio.Task] = set()
        self._pump_task = aio.spawn(self._pump(), what="mux pump", logger=log)

    def _credit(self, n: int) -> None:
        self._inflight -= n
        if self._inflight <= self._window:
            self._has_credit.set()

    async def send(self, sid: int, flag: int, payload) -> None:
        if self.closed:
            raise ConnectionError("mux connection closed")
        async with self._wlock:
            # ONE write per frame, always: a caller's wait_for() cancelling
            # between a split header/payload pair would tear the frame and
            # desync every stream on the connection. The concatenation copy
            # (~30 us/MiB) is the price of cancellation atomicity.
            await self.base.write(_HDR.pack(sid, flag, len(payload)) + bytes(payload))

    def open_stream(self) -> _MuxStream:
        sid = self._next_id
        self._next_id += 2
        stream = _MuxStream(self, sid)
        self._streams[sid] = stream
        return stream

    async def _pump(self) -> None:
        try:
            while True:
                # Flow control: stop reading the base socket while undrained
                # inbound buffers exceed the window — kernel TCP backpressure
                # then throttles the remote sender. (Connection-level, not
                # per-stream credits: the head-of-line tradeoff in the module
                # docstring. Never gate WRITES on local inbound state — that
                # couples directions and can deadlock request/reply pairs.)
                await self._has_credit.wait()
                hdr = await self.base.read_exactly(_HDR.size)
                sid, flag, length = _HDR.unpack(hdr)
                if length > _MAX_CHUNK:
                    # Our writer chunks at _MAX_CHUNK; a larger claim is a
                    # corrupt or hostile peer — drop the connection rather
                    # than buffering toward the advertised size.
                    log.warning("mux frame of %d bytes exceeds cap; dropping conn", length)
                    break
                payload = await self.base.read_exactly(length) if length else b""
                if flag == _OPEN:
                    if self._on_stream is None:
                        # Dial-side connection with no inbound handler: a
                        # registered-but-unconsumed stream would eat window
                        # credit forever. Refuse it — from a spawned task,
                        # never awaiting a write inside the read pump (a
                        # non-draining peer could wedge the connection).
                        aio.spawn(
                            self._reset_quietly(sid),
                            tasks=self._tasks,
                            what="mux stream reset",
                            logger=log,
                        )
                        continue
                    stream = _MuxStream(self, sid)
                    self._streams[sid] = stream
                    if payload:
                        self._inflight += len(payload)
                        stream._deliver(payload)
                    aio.spawn(
                        self._serve(stream),
                        tasks=self._tasks,
                        what="mux stream serve",
                        logger=log,
                    )
                elif flag == _DATA:
                    stream = self._streams.get(sid)
                    if stream is not None:
                        self._inflight += len(payload)
                        if self._inflight > self._window:
                            self._has_credit.clear()
                        stream._deliver(payload)
                elif flag in (_CLOSE, _RESET):
                    stream = self._streams.pop(sid, None)
                    if stream is not None:
                        stream._detach()
                        stream._deliver(None)
        except asyncio.CancelledError:
            raise  # finally still tears the connection down
        except Exception:
            pass
        finally:
            await self._teardown()

    async def _reset_quietly(self, sid: int) -> None:
        try:
            await self.send(sid, _RESET, b"")
        except (ConnectionError, OSError):
            pass

    async def _serve(self, stream: _MuxStream) -> None:
        try:
            await self._on_stream(stream)
        finally:
            await stream.close()

    async def _teardown(self) -> None:
        self.closed = True
        for stream in list(self._streams.values()):
            stream._detach()
            stream._deliver(None)
        self._streams.clear()
        for task in list(self._tasks):
            task.cancel()
        try:
            await self.base.abort()
        except Exception:
            pass

    async def close(self) -> None:
        await aio.reap(self._pump_task)


class MuxTransport(Transport):
    """Wraps a base transport; one persistent muxed connection per address."""

    def __init__(self, base: Transport) -> None:
        self.base = base
        self.counts = {"streams_dialed": 0, "streams_accepted": 0}
        self._conns: dict[str, _MuxConn] = {}
        self._dial_locks: dict[str, asyncio.Lock] = {}
        self._accepted: list[_MuxConn] = []

    async def listen(self, addr: str, on_stream: AcceptCallback) -> str:
        async def counted(stream: Stream) -> None:
            self.counts["streams_accepted"] += 1
            await on_stream(stream)

        async def on_conn(base_stream: Stream) -> None:
            conn = _MuxConn(base_stream, dialer=False, on_stream=counted)
            self._accepted.append(conn)
            # Hold the base accept open for the connection's lifetime, then
            # prune — a long-lived listener with client churn must not
            # accumulate dead connections.
            try:
                await aio.wait_quiet(conn._pump_task)
            finally:
                try:
                    self._accepted.remove(conn)
                except ValueError:
                    pass

        return await self.base.listen(addr, on_conn)

    async def dial(self, addr: str) -> Stream:
        lock = self._dial_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            conn = self._conns.get(addr)
            if conn is None or conn.closed:
                base_stream = await self.base.dial(addr)
                conn = _MuxConn(base_stream, dialer=True, on_stream=None)
                self._conns[addr] = conn
        stream = conn.open_stream()
        await conn.send(stream.sid, _OPEN, b"")
        self.counts["streams_dialed"] += 1
        return stream

    async def close(self) -> None:
        for conn in list(self._conns.values()) + list(self._accepted):
            await conn.close()
        self._conns.clear()
        self._accepted.clear()
        await self.base.close()
