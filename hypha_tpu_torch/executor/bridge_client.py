"""Executor-side Job-Bridge client: HTTP over the job's unix socket
(counterpart of ``hypha_tpu/executor/bridge_client.py``).

The same four capabilities as the reference's ``Session``: ``fetch``,
``send_resource``, ``send_status``, and ``receive`` — an SSE context
manager yielding JSON file pointers as tensors land. The reference is
built on ``httpx``; this one uses ``http.client`` over an ``AF_UNIX``
socket, so the port needs nothing outside the standard library here.

Each thread's short requests (the per-batch heartbeats, fetches, pushes)
share one keep-alive connection of that thread's own, as ``httpx``'s pool
gives each concurrent request its own: the input pipeline's prefetch
thread holds a ``fetch`` open until the bridge has pulled and written the
slice, and the training loop's heartbeats must not wait behind it (the
bridge serves each connection on its own). Before reusing a connection,
the client checks that the bridge has not closed it while it sat idle, so
a request is never sent into a dead connection and never sent twice. Each
``receive`` opens a connection of its own and holds it for the stream's
life; leaving the context closes it, which ends the bridge's side of the
stream.
"""

from __future__ import annotations

import http.client
import json
import select
import socket
import threading
from contextlib import contextmanager
from typing import Any, Iterator

from .. import messages
from ..messages import Fetch, Progress, ProgressResponse, Receive, Send

__all__ = ["BridgeHTTPError", "Session"]


class BridgeHTTPError(RuntimeError):
    """The bridge answered with an error status (4xx/5xx)."""

    def __init__(self, method: str, path: str, status: int, body: bytes) -> None:
        super().__init__(f"{method} {path}: HTTP {status}: {body[:500].decode(errors='replace')}")
        self.status = status
        self.body = body


class _UnixConnection(http.client.HTTPConnection):
    """An HTTP/1.1 connection to a unix socket path."""

    def __init__(self, socket_path: str, timeout: "float | None") -> None:
        super().__init__("bridge", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.settimeout(self.timeout)
            sock.connect(self._socket_path)
        except OSError:
            sock.close()
            raise
        self.sock = sock


def _json_body(payload: dict) -> tuple:
    body = json.dumps(payload).encode()
    return body, {"content-type": "application/json", "content-length": str(len(body))}


class Session:
    def __init__(self, socket_path: str, timeout: float = 300.0) -> None:
        self._path = str(socket_path)
        self._timeout = timeout
        self._local = threading.local()  # .conn: this thread's connection
        self._conns: dict = {}  # thread -> its connection, for close()
        self._lock = threading.Lock()

    def _thread_conn(self) -> _UnixConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = _UnixConnection(self._path, self._timeout)
            with self._lock:
                # A streaming sync starts a thread per flight: close the
                # connections of threads that have ended.
                for thread in [t for t in self._conns if not t.is_alive()]:
                    self._conns.pop(thread).close()
                self._conns[threading.current_thread()] = conn
        return conn

    def close(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for conn in conns:
            conn.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------

    def _post(self, path: str, payload: dict) -> Any:
        conn = self._thread_conn()
        if conn.sock is not None and select.select([conn.sock], [], [], 0)[0]:
            # Readable while idle: the bridge closed this keep-alive
            # connection (EOF) after its last answer. Start a new one.
            conn.close()
        body, headers = _json_body(payload)
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except BaseException:
            conn.close()
            raise
        if resp.will_close or resp.status >= 500:
            # The bridge closes the connection after a 500 without saying
            # so; its FIN can trail the answer, so the idle check above
            # would miss it and the next request would meet a reset.
            conn.close()
        if resp.status >= 400:
            raise BridgeHTTPError("POST", path, resp.status, data)
        return json.loads(data) if data else None

    def fetch(self, fetch: Fetch) -> list:
        """Materialize a reference under work_dir/artifacts; returns the
        work-dir-relative paths."""
        return self._post("/resources/fetch", {"fetch": messages.to_json_dict(fetch)})["paths"]

    def send_resource(
        self,
        send: Send,
        path: str,
        resource: str = "updates",
        meta: "dict[str, Any] | None" = None,
    ) -> None:
        """Ship a work-dir file to peers (runs in the worker's background).
        ``meta`` rides the stream header (e.g. num_samples for the parameter
        server's sample-weighted mean)."""
        self._post("/resources/send", {
            "send": messages.to_json_dict(send),
            "path": path,
            "resource": resource,
            "meta": meta or {},
        })

    def send_status(self, progress: Progress) -> ProgressResponse:
        """Report progress; returns the scheduler's control decision."""
        out = self._post("/status/send", {"progress": messages.to_json_dict(progress)})
        resp = messages.from_json_dict(out["response"])
        if not isinstance(resp, ProgressResponse):
            raise ValueError(f"unexpected status response {resp!r}")
        return resp

    @contextmanager
    def receive(self, receive: Receive) -> Iterator[Iterator[dict]]:
        """SSE stream of ``{path,size,from_peer,resource,meta}`` pointers."""
        conn = _UnixConnection(self._path, None)  # a stream waits as long as it must
        resp = None
        try:
            body, headers = _json_body({"receive": messages.to_json_dict(receive)})
            conn.request("POST", "/resources/receive", body=body, headers=headers)
            resp = conn.getresponse()
            if resp.status >= 400:
                raise BridgeHTTPError("POST", "/resources/receive", resp.status, resp.read())

            def events() -> Iterator[dict]:
                while True:
                    line = resp.readline()
                    if not line:
                        return
                    if line.startswith(b"data: "):
                        yield json.loads(line[len(b"data: "):])

            yield events()
        finally:
            # The response holds the socket open on its own (a streamed
            # response leaves the connection): close both, so the bridge
            # sees the stream end at once and stops routing pushes to it.
            if resp is not None:
                resp.close()
            conn.close()
