"""The Job Bridge: the executor-facing API, HTTP over a per-job unix socket
(counterpart of ``hypha_tpu/worker/bridge.py``).

An HTTP server on a 0600 unix socket inside the job's work dir, giving the
out-of-process executor exactly four capabilities and nothing else:

  * ``POST /resources/fetch``   — materialize a Fetch reference under
    ``work_dir/artifacts``;
  * ``POST /resources/send``    — ship a work-dir file to peers in the
    background (drained on ``stop``);
  * ``POST /resources/receive`` — SSE stream of ``{path,size,from_peer}``
    pointers as files land in ``work_dir/incoming``;
  * ``POST /status/send``       — proxy a Progress message to the scheduler
    over the progress protocol, returning its response;
  * ``GET /openapi.json``       — self-description.

Path safety: no absolute paths, no ``..`` traversal. The same routes,
status codes and bodies as the reference, so either package's client
talks to either package's bridge.

``node`` is the fabric's Node, or any object with ``async request(peer,
protocol, msg, timeout)``; ``connector`` defaults to a
:class:`~hypha_tpu_torch.worker.connectors.Connector` on that node, and
may be any object with its ``fetch``/``send``/``receive``.
``progress_probe``, when given, sees every Progress the executor sends
(the worker runtime keeps an execution's live round with it).
``status_retry_s > 0`` (a scheduler-recoverable job's adoption grace) parks
a status send that fails in ``aio.retry`` for that many seconds, so a
scheduler outage costs backed-off re-attempts instead of a failed training
loop: the restarted scheduler answers the re-attempt. ``parked`` counts the
failed attempts, and a send answered after any is logged.
"""

from __future__ import annotations

import asyncio
import json
import logging
import socket
import time
from pathlib import Path

from .. import aio, messages
from ..messages import PROTOCOL_PROGRESS, Fetch, Progress, Receive, Send
from ..network.node import RequestError
from .connectors import Connector

__all__ = ["Bridge", "BridgeError", "MAX_BODY", "safe_rel"]

log = logging.getLogger("hypha.torch.worker.bridge")

MAX_BODY = 8 * 1024 * 1024

_OPENAPI = {
    "openapi": "3.0.0",
    "info": {"title": "hypha job bridge", "version": "0.0.1"},
    "paths": {
        "/resources/fetch": {"post": {}},
        "/resources/send": {"post": {}},
        "/resources/receive": {"post": {}},
        "/status/send": {"post": {}},
    },
}

_REASONS = {200: "OK", 202: "Accepted", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large", 500: "Internal Server Error"}


class BridgeError(ValueError):
    pass


def safe_rel(work_dir: Path, rel: str) -> Path:
    """Resolve a client-supplied relative path inside the work dir (reject
    absolute paths and traversal)."""
    p = Path(rel)
    if p.is_absolute():
        raise BridgeError(f"absolute path not allowed: {rel}")
    if ".." in p.parts:
        raise BridgeError(f"path traversal not allowed: {rel}")
    return work_dir / p


class Bridge:
    def __init__(
        self,
        node,
        work_dir: Path,
        job_id: str,
        scheduler_peer: str,
        connector=None,
        status_retry_s: float = 0.0,
        progress_probe=None,
    ) -> None:
        self.node = node
        self.work_dir = Path(work_dir)
        self.job_id = job_id
        self.scheduler_peer = scheduler_peer
        self.connector = connector or Connector(node, scheduler_peer)
        self.progress_probe = progress_probe
        self.status_retry_s = float(status_retry_s or 0.0)
        self.parked = 0  # failed status attempts parked across an outage
        self.socket_path = self.work_dir / "bridge.sock"
        self._server: "asyncio.base_events.Server | None" = None
        self._send_tasks: set = set()
        self._conn_tasks: set = set()

    async def start(self) -> Path:
        self.work_dir.mkdir(parents=True, exist_ok=True, mode=0o700)
        # Bind + chmod before listen: the socket must never be connectable
        # by other local users, even for an instant.
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(str(self.socket_path))
        self.socket_path.chmod(0o600)
        sock.listen(16)
        self._server = await asyncio.start_unix_server(self._handle, sock=sock)
        return self.socket_path

    async def stop(self) -> None:
        # Stop accepting first, so no new sends can start behind the drain.
        if self._server is not None:
            self._server.close()
        # Sever live connections (idle keep-alives, parked SSE receives):
        # wait_closed would otherwise block on them forever.
        for task in list(self._conn_tasks):
            task.cancel()
        if self._server is not None:
            await aio.wait_quiet(self._server.wait_closed(), timeout=10.0)
        # Drain in-flight background sends — the executor's final
        # pseudo-gradient is typically still uploading when it exits.
        # Re-snapshot each pass: a request already in flight when the
        # server closed may still have added a task after the first one.
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 60.0
        while True:
            pending = [t for t in self._send_tasks if not t.done()]
            if not pending:
                break
            remaining = deadline - loop.time()
            if remaining <= 0:
                for task in pending:
                    log.warning("bridge stop: abandoning unfinished send")
                    task.cancel()
                break
            await asyncio.wait(pending, timeout=remaining)
        self.socket_path.unlink(missing_ok=True)

    # ------------------------------------------------------------- server

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        # Track the handler task: Server.wait_closed() blocks until every
        # handler returns, so stop() must be able to cancel handlers parked
        # on an idle keep-alive read or a blocked SSE stream.
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        # HTTP/1.1 keep-alive: the executor's per-batch status heartbeats
        # ride one connection.
        try:
            while True:
                request_line = await reader.readline()
                if not request_line:
                    return  # client closed
                parts = request_line.decode("latin-1").split()
                if len(parts) < 2:
                    return
                method, path = parts[0], parts[1]
                headers: dict = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                length = int(headers.get("content-length", "0"))
                if length > MAX_BODY:
                    await self._respond(writer, 413, {"error": "body too large"})
                    return
                body = await reader.readexactly(length) if length else b""
                if method == "POST" and path == "/resources/receive":
                    # SSE takes over the connection until the client leaves.
                    await self._receive(json.loads(body or b"{}"), reader, writer)
                    return
                await self._route(method, path, body, writer)
                if headers.get("connection", "").lower() == "close":
                    return
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception as e:  # a request's failure answers 500, the server runs on
            log.warning("bridge request failed: %s", e, exc_info=True)
            try:
                await self._respond(writer, 500, {"error": str(e)})
            except (ConnectionError, RuntimeError):
                pass
        finally:
            try:
                writer.close()
            except ConnectionError:
                pass

    async def _respond(self, writer: asyncio.StreamWriter, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        writer.write(
            f"HTTP/1.1 {status} {_REASONS.get(status, '?')}\r\n"
            f"content-type: application/json\r\n"
            f"content-length: {len(body)}\r\n\r\n".encode() + body
        )
        await writer.drain()

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter) -> None:
        if method == "GET" and path == "/openapi.json":
            await self._respond(writer, 200, _OPENAPI)
        elif method == "POST" and path == "/resources/fetch":
            await self._fetch(json.loads(body or b"{}"), writer)
        elif method == "POST" and path == "/resources/send":
            await self._send(json.loads(body or b"{}"), writer)
        elif method == "POST" and path == "/status/send":
            await self._status(json.loads(body or b"{}"), writer)
        else:
            await self._respond(writer, 404, {"error": f"no route {method} {path}"})

    # ------------------------------------------------------------- routes

    async def _fetch(self, body: dict, writer: asyncio.StreamWriter) -> None:
        fetch = messages.from_json_dict(body.get("fetch"))
        if not isinstance(fetch, Fetch):
            await self._respond(writer, 400, {"error": "body.fetch must be a Fetch"})
            return
        paths = await self.connector.fetch(fetch, self.work_dir / "artifacts")
        await self._respond(
            writer, 200, {"paths": [str(p.relative_to(self.work_dir)) for p in paths]}
        )

    async def _send(self, body: dict, writer: asyncio.StreamWriter) -> None:
        send = messages.from_json_dict(body.get("send"))
        if not isinstance(send, Send):
            await self._respond(writer, 400, {"error": "body.send must be a Send"})
            return
        path = safe_rel(self.work_dir, str(body.get("path", "")))
        if not path.is_file():
            await self._respond(writer, 400, {"error": f"no such file {body.get('path')}"})
            return
        resource = str(body.get("resource", "updates"))
        meta = body.get("meta") or {}
        if not isinstance(meta, dict):
            await self._respond(writer, 400, {"error": "body.meta must be an object"})
            return
        # Background copy: don't block the executor loop.
        aio.spawn(
            self.connector.send(send, path, resource, meta),
            tasks=self._send_tasks, what="background send", logger=log,
        )
        await self._respond(writer, 202, {"ok": True})

    async def _receive(self, body: dict, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        receive = messages.from_json_dict(body.get("receive"))
        if not isinstance(receive, Receive):
            await self._respond(writer, 400, {"error": "body.receive must be a Receive"})
            return
        # The connector's receive is opened before the stream's headers go
        # out, so a route it cannot serve answers 500, not a broken stream.
        gen = self.connector.receive(receive, self.work_dir / "incoming")
        writer.write(
            b"HTTP/1.1 200 OK\r\ncontent-type: text/event-stream\r\n"
            b"cache-control: no-cache\r\n\r\n"
        )
        await writer.drain()
        # The client closing its connection must stop this loop — otherwise
        # it would keep consuming pushes and block bridge shutdown.
        client_gone = asyncio.create_task(reader.read())
        nxt = None
        try:
            while True:
                nxt = asyncio.create_task(anext(gen))
                done, _ = await asyncio.wait({nxt, client_gone},
                                             return_when=asyncio.FIRST_COMPLETED)
                if nxt not in done:
                    await aio.reap(nxt)
                    break
                try:
                    rf = nxt.result()
                except StopAsyncIteration:
                    break
                event = {
                    "path": str(rf.path.relative_to(self.work_dir)),
                    "size": rf.size,
                    "from_peer": rf.from_peer,
                    "resource": rf.resource,
                    # Full push header (round, epoch, catch-up flags).
                    "meta": rf.meta,
                }
                try:
                    writer.write(f"data: {json.dumps(event)}\n\n".encode())
                    await writer.drain()
                except (ConnectionError, RuntimeError):
                    break
        finally:
            # On stop() this handler is cancelled mid-wait: the pending
            # anext must end too, or it outlives the loop.
            await aio.reap(client_gone, nxt)
            try:
                await gen.aclose()
            except RuntimeError:
                # A cancelled-but-unfinished anext can leave the generator
                # running; aclose() then refuses. The consumer is closed
                # either way.
                pass

    async def _status_parked(self, progress: Progress):
        """Send one status, re-trying a failure until ``status_retry_s``
        runs out (the scheduler's answer is idempotent by round)."""
        failed = 0
        t0 = time.perf_counter()

        async def once():
            nonlocal failed
            try:
                return await self.node.request(
                    self.scheduler_peer, PROTOCOL_PROGRESS, progress, timeout=30
                )
            except (RequestError, OSError, asyncio.TimeoutError):
                failed += 1
                self.parked += 1
                raise

        response = await aio.retry(
            once, base_delay=0.5, max_delay=5.0, deadline=self.status_retry_s,
            retry_on=(RequestError, OSError),
            what=f"status {progress.kind.value} of {self.job_id} -> scheduler", logger=log,
        )
        if failed:
            log.warning("job %s: status %s answered after %d parked attempt(s) in %.3f s "
                        "(scheduler generation %s, round %s)", self.job_id,
                        progress.kind.value, failed, time.perf_counter() - t0,
                        getattr(response, "generation", None),
                        getattr(response, "round", None))
        return response

    async def _status(self, body: dict, writer: asyncio.StreamWriter) -> None:
        progress = messages.from_json_dict(body.get("progress"))
        if not isinstance(progress, Progress):
            await self._respond(writer, 400, {"error": "body.progress must be Progress"})
            return
        progress.job_id = progress.job_id or self.job_id
        if self.progress_probe is not None:
            self.progress_probe(progress)
        if self.status_retry_s <= 0:
            response = await self.node.request(
                self.scheduler_peer, PROTOCOL_PROGRESS, progress, timeout=30
            )
        else:
            response = await self._status_parked(progress)
        await self._respond(writer, 200, {"response": messages.to_json_dict(response)})
