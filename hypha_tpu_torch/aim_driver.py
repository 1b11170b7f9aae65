"""The metrics sink the scheduler's ``AimConnector``
(``scheduler/metrics_bridge.py``) posts to (port of
``hypha_tpu/aim_driver.py``).

The reference's driver is a FastAPI shim exposing ``POST /status`` and
forwarding ``AimMetrics{worker_id, round, metric_name, value}`` into
``aim.Run.track``. This is a dependency-free asyncio HTTP server. The port
imports the standard library only, so where the reference hands each
metric to an Aim run when ``aim`` is importable, this sink keeps it in its
bounded tail, appends it to a JSONL file and logs it.

Run: ``python -m hypha_tpu_torch.aim_driver --port 8875 [--out metrics.jsonl]``
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
from pathlib import Path

__all__ = ["StatusSink", "serve", "build_parser"]

log = logging.getLogger("hypha.aim_driver")


class StatusSink:
    def __init__(self, out_path: str | Path | None = None) -> None:
        from collections import deque

        self.out_path = Path(out_path) if out_path else None
        # Bounded: a multi-day job posts metrics forever; keep the tail for
        # introspection, count the rest.
        self.received: "deque[dict]" = deque(maxlen=4096)
        self.total = 0

    def track(self, payload: dict) -> None:
        if not isinstance(payload, dict):
            raise TypeError(f"status payload must be an object, got {type(payload).__name__}")
        self.received.append(payload)
        self.total += 1
        if self.out_path is not None:
            with open(self.out_path, "a") as f:
                f.write(json.dumps(payload) + "\n")
        log.info(
            "metric %s[%s] round=%s = %s",
            payload.get("metric_name"),
            payload.get("worker_id"),
            payload.get("round"),
            payload.get("value"),
        )


async def _handle(sink: StatusSink, reader, writer) -> None:
    try:
        while True:
            request_line = await reader.readline()
            if not request_line:
                return
            parts = request_line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            length = int(headers.get("content-length", "0"))
            body = await reader.readexactly(length) if length else b""
            if method == "POST" and path == "/status":
                try:
                    sink.track(json.loads(body or b"{}"))
                    status, reply = 200, b'{"ok": true}'
                except (json.JSONDecodeError, TypeError) as e:
                    status, reply = 400, json.dumps({"error": str(e)}).encode()
            else:
                status, reply = 404, b'{"error": "no route"}'
            writer.write(
                f"HTTP/1.1 {status} {'OK' if status == 200 else 'ERR'}\r\n"
                f"content-type: application/json\r\n"
                f"content-length: {len(reply)}\r\n\r\n".encode() + reply
            )
            await writer.drain()
            if headers.get("connection", "").lower() == "close":
                return
    except (asyncio.IncompleteReadError, ConnectionError):
        pass
    finally:
        try:
            writer.close()
        except ConnectionError:
            pass


async def serve(
    host: str = "127.0.0.1", port: int = 8875, out_path: str | None = None
):
    """Start the sink server; returns (server, sink)."""
    sink = StatusSink(out_path)
    server = await asyncio.start_server(
        lambda r, w: _handle(sink, r, w), host, port
    )
    return server, sink


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hypha-aim-driver", description="hypha metrics status sink"
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8875)
    parser.add_argument("--out", help="also append metrics to this JSONL file")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")

    async def run() -> None:
        server, _sink = await serve(args.host, args.port, args.out)
        addr = server.sockets[0].getsockname()
        log.info("aim driver on %s:%s", addr[0], addr[1])
        async with server:
            await server.serve_forever()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
