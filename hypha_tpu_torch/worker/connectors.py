"""Data-plane connectors: how job artifacts move (counterpart of
``hypha_tpu/worker/connectors.py``).

What is ported: ``fetch_uri`` (``http(s)`` streamed to disk, ``file://``
copied), ``ReceivedFile`` (one landed file and its push header) and a
``Connector`` whose ``uri`` fetch works. The routes that move tensors
between peers (the scheduler-mediated slice pull, the ``peers`` pushes of
``send`` and ``receive``) need the fabric's ``Node``, which is not ported
(ROADMAP.md, Queue 1: the network layer); HuggingFace Hub downloads wait
for HF checkpoints. Each raises ``NotImplementedError`` naming its label.

Received file names are SHA-256-hashed before hitting the filesystem
(``_safe_name``), matching the reference's path-injection defense.
"""

from __future__ import annotations

import asyncio
import hashlib
import shutil
import urllib.parse
import urllib.request
from pathlib import Path
from typing import AsyncIterator

from ..messages import Fetch, Receive, Send

__all__ = ["Connector", "ReceivedFile", "fetch_uri"]


def _safe_name(name: str) -> str:
    """Collapse any peer-supplied name to a flat digest-based filename."""
    return hashlib.sha256(name.encode()).hexdigest()[:32]


def _network_layer(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the fabric's Node, which is not ported to PyTorch yet "
        "(ROADMAP.md, Queue 1: the network layer)"
    )


class ReceivedFile:
    def __init__(
        self,
        path: Path,
        size: int,
        from_peer: str,
        resource: str,
        meta: "dict | None" = None,
    ) -> None:
        self.path = path
        self.size = size
        self.from_peer = from_peer
        self.resource = resource
        # Full push header (round, epoch, catchup, num_samples, ...): the
        # executor-side control data that rides each tensor stream.
        self.meta = meta or {}


def fetch_uri(uri: str, dest_dir: Path) -> Path:
    """Blocking URI download (run via to_thread): http(s) streamed to disk,
    file:// copied. Scheme-validated."""
    parsed = urllib.parse.urlparse(uri)
    if parsed.scheme not in ("http", "https", "file"):
        raise ValueError(f"unsupported URI scheme {parsed.scheme!r}")
    dest_dir.mkdir(parents=True, exist_ok=True)
    name = Path(parsed.path).name or "download"
    dest = dest_dir / name
    if parsed.scheme == "file":
        src = Path(urllib.request.url2pathname(parsed.path))
        shutil.copyfile(src, dest)  # streams; checkpoints don't fit in RAM
        return dest
    with urllib.request.urlopen(uri) as resp, open(dest, "wb") as f:  # noqa: S310
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    return dest


class Connector:
    """Routes Reference variants to transports."""

    async def fetch(self, fetch: Fetch, dest_dir: Path) -> list:
        ref = fetch.ref
        variant = ref.variant()
        if variant == "uri":
            return [await asyncio.to_thread(fetch_uri, ref.uri, dest_dir)]
        if variant == "huggingface":
            raise NotImplementedError(
                "HuggingFace Hub downloads are not ported to PyTorch yet "
                "(ROADMAP.md, Queue 1: HF checkpoints)"
            )
        if variant == "scheduler":
            raise _network_layer("a scheduler-assigned slice fetch")
        if variant == "peers":
            raise ValueError("peers variant is receive-only for fetch")
        raise ValueError(f"unknown fetch variant {variant}")

    async def send(
        self, send: Send, path: Path, resource: str, meta: "dict | None" = None
    ) -> None:
        raise _network_layer("a push to peers")

    def receive(self, receive: Receive, dest_dir: Path) -> AsyncIterator[ReceivedFile]:
        raise _network_layer("receiving pushes from peers")
