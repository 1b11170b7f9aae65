"""Executor-side Job-Bridge client: HTTP over the job's unix socket
(counterpart of ``hypha_tpu/executor/bridge_client.py``).

The same four capabilities as the reference's ``Session``: ``fetch``,
``send_resource``, ``send_status``, and ``receive`` — an SSE context
manager yielding JSON file pointers as tensors land. The reference is
built on ``httpx``; this one uses ``http.client`` over an ``AF_UNIX``
socket, so the port needs nothing outside the standard library here.

The per-batch heartbeats and the other short requests share one
keep-alive connection. Before reusing it, the client checks that the
bridge has not closed it while it sat idle (as ``httpx``'s pool does),
so a request is never sent into a dead connection and never sent twice.
Each ``receive`` opens a connection of its own and holds it for the
stream's life; leaving the context closes it, which ends the bridge's
side of the stream. A lock serializes the short requests, so a streaming
sync's flight thread can push while the training loop sends heartbeats.
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
        self._conn = _UnixConnection(self._path, timeout)
        self._lock = threading.Lock()

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------

    def _post(self, path: str, payload: dict) -> Any:
        with self._lock:
            return self._post_locked(path, payload)

    def _post_locked(self, path: str, payload: dict) -> Any:
        conn = self._conn
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
            conn.close()
