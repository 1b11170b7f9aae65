"""Data-plane connectors: how job artifacts move (counterpart of
``hypha_tpu/worker/connectors.py``).

``Connector(node, scheduler_peer)`` routes each Reference variant:

  * ``uri`` — ``fetch_uri`` (``http(s)`` streamed to disk, ``file://``
    copied);
  * ``scheduler`` — the scheduler-mediated slice pull: a ``DataRequest``
    to the scheduler names a data node and an index, then the slice is
    pulled from that node over a pull stream;
  * ``peers`` — ``send`` pushes a file to the reference's peers (ALL:
    every peer must get it; ANY: the first success wins), with the
    caller's ``meta`` on the push header and a jittered re-push across a
    receiver's outage; ``receive`` yields the pushes that land from the
    allowed peers under the reference's resource tag, and leaves every
    other push to the node's other consumers.

Not ported: the on-disk slice cache of pipelined jobs (a ``prefetch``
window; ROADMAP.md, Queue 1: input_pipeline), ``shard_route`` (sharded
parameter service; sharded PS/FT/rejoin), HuggingFace
Hub downloads (HF checkpoints) and the data-plane byte counters
(telemetry). Each raises ``NotImplementedError`` naming its label.

Received file names are SHA-256-hashed before hitting the filesystem
(``_safe_name``), matching the reference's path-injection defense.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import shutil
import urllib.parse
import urllib.request
from pathlib import Path
from typing import AsyncIterator

from .. import aio
from ..messages import (
    PROTOCOL_API,
    DataRequest,
    DataResponse,
    DataSlice,
    Fetch,
    Receive,
    Reference,
    Send,
    TransferStrategy,
)
from ..network.node import PushStream, RequestError

__all__ = ["Connector", "ReceivedFile", "fetch_uri", "push_timeout", "shard_route"]

log = logging.getLogger("hypha.torch.worker.connector")


def _safe_name(name: str) -> str:
    """Collapse any peer-supplied name to a flat digest-based filename."""
    return hashlib.sha256(name.encode()).hexdigest()[:32]


# Outbound tensor pushes retry with jittered backoff (aio.retry) for up to
# this many seconds: a parameter-server restart or a transient partition
# costs a few re-attempts, not a lost delta and a wedged round.
PUSH_RETRY_DEADLINE_S = 120.0


def push_timeout(path: Path) -> float:
    """Per-attempt wall-clock bound for a parameter-sized push: 60 s plus
    the payload at a floor rate of 10 MB/s, so a push black-holed by a
    silent partition fails in time to retry while a slow multi-GB transfer
    is never cut mid-flight."""
    try:
        size = path.stat().st_size
    except OSError:
        size = 0
    return 60.0 + size / (10 * 1024 * 1024)


def shard_route(shard_map, part: int, reduce_via: "str | None" = None):
    """The reference's Send route of one placement part's delta push (a
    sharded parameter service), which the port does not run."""
    raise NotImplementedError(
        "routing delta parts to parameter-server shards is not ported to PyTorch yet "
        "(ROADMAP.md, Queue 1: sharded PS/FT/rejoin)"
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
    """Routes Reference variants to transports. ``node`` is the fabric's
    :class:`~hypha_tpu_torch.network.node.Node`; without one only the
    ``uri`` fetch works."""

    def __init__(self, node=None, scheduler_peer: str = "", slice_cache=None) -> None:
        if slice_cache is not None:
            raise NotImplementedError(
                "the on-disk slice cache of pipelined jobs is not ported to PyTorch yet "
                "(ROADMAP.md, Queue 1: input_pipeline)"
            )
        self.node = node
        self.scheduler_peer = scheduler_peer

    def _fabric(self, what: str):
        if self.node is None:
            raise ValueError(f"{what} needs a Connector built on the fabric's Node")
        return self.node

    # -------------------------------------------------------------- fetch

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
            return [await self._fetch_slice(ref, dest_dir)]
        if variant == "peers":
            raise ValueError("peers variant is receive-only for fetch")
        raise ValueError(f"unknown fetch variant {variant}")

    async def _fetch_slice(self, ref: Reference, dest_dir: Path) -> Path:
        """Scheduler-mediated slice fetch: ask for an assignment, pull it."""
        node = self._fabric("a scheduler-assigned slice fetch")
        if ref.prefetch is not None:
            raise NotImplementedError(
                f"a slice prefetch window (prefetch={ref.prefetch}) is not ported to "
                "PyTorch yet (ROADMAP.md, Queue 1: input_pipeline)"
            )
        scheduler = ref.scheduler_peer or self.scheduler_peer
        if not scheduler:
            raise ValueError("no scheduler peer for slice fetch")
        resp = await node.request(
            scheduler, PROTOCOL_API, DataRequest(dataset=ref.dataset or "", peer_id=node.peer_id),
        )
        if not isinstance(resp, DataResponse):
            raise RequestError(f"unexpected data response {resp!r}")
        dest_dir.mkdir(parents=True, exist_ok=True)
        stem = _safe_name(ref.dataset or "slice")
        dest = (dest_dir / f"{stem}-e{resp.epoch}-{resp.index:06d}" if resp.epoch is not None
                else dest_dir / f"{stem}-{resp.index:06d}")
        stream = await node.pull(resp.data_provider,
                                 DataSlice(dataset=ref.dataset or "", index=resp.index))
        loop = asyncio.get_running_loop()
        try:
            f = await asyncio.to_thread(open, dest, "wb")
            try:
                while True:
                    chunk = await stream.read(1 << 20)
                    if not chunk:
                        break
                    await loop.run_in_executor(None, f.write, chunk)
            finally:
                await asyncio.to_thread(f.close)
        finally:
            await stream.close()
        return dest

    # --------------------------------------------------------------- send

    async def send(
        self, send: Send, path: Path, resource: str, meta: "dict | None" = None
    ) -> None:
        """Push a local file to the reference's peers. ALL: every peer must
        get it; ANY: the first success wins. ``meta`` keys ride the stream
        header (the parameter server reads ``num_samples`` for its weighted
        mean); the reserved keys win.

        Failed pushes retry with jittered backoff up to
        ``PUSH_RETRY_DEADLINE_S`` seconds, so a worker re-pushes across a
        receiver's outage instead of failing the round.
        """
        node = self._fabric("a push to peers")
        path = Path(path)
        ref = send.ref
        peers = ref.peers or []
        strategy = ref.strategy or TransferStrategy.ALL
        header = {**(meta or {}), "resource": resource, "name": path.name}
        deadline = PUSH_RETRY_DEADLINE_S
        # Per-attempt bound: only an attempt's timeout can interrupt a push
        # black-holed by a silent partition; the deadline is read between.
        attempt_timeout = push_timeout(path)
        if strategy == TransferStrategy.ANY:

            async def any_once() -> None:
                last: "Exception | None" = None
                for peer in peers:
                    try:
                        await node.push(peer, header, path)
                        return
                    except (RequestError, OSError) as e:
                        # A peer that resets mid-push must not stop the
                        # failover to the next one within this attempt.
                        last = e
                raise RequestError(f"no peer accepted {resource}: {last}")

            try:
                await aio.retry(
                    any_once, base_delay=0.25, max_delay=5.0, deadline=deadline,
                    attempt_timeout=attempt_timeout * max(len(peers), 1),
                    retry_on=(RequestError, OSError), what=f"push {resource} (any)", logger=log,
                )
            except asyncio.TimeoutError as e:
                raise RequestError(f"push {resource} (any) timed out after {deadline}s") from e
            return
        failures = []
        # One retry budget across the whole peer list: the peers are pushed
        # in turn, and every peer still gets at least one attempt.
        stop_at = asyncio.get_running_loop().time() + deadline
        for peer in peers:
            try:
                await aio.retry(
                    lambda p=peer: node.push(p, header, path),
                    base_delay=0.25, max_delay=5.0, attempt_timeout=attempt_timeout,
                    deadline=max(stop_at - asyncio.get_running_loop().time(), 0.0),
                    retry_on=(RequestError, OSError), what=f"push {resource} to {peer}",
                    logger=log,
                )
            except (RequestError, OSError, asyncio.TimeoutError) as e:
                failures.append((peer, e))
        if failures:
            raise RequestError(f"send failures: {failures}")

    # ------------------------------------------------------------- receive

    def receive(self, receive: Receive, dest_dir: Path) -> AsyncIterator[ReceivedFile]:
        """Yield files as they land from allowed peers; unknown senders are
        drained and dropped.

        Routed: when the Receive reference carries a resource tag, only
        pushes with that tag are consumed — other consumers on the same node
        (another job's bridge, a parameter-server loop) keep theirs.
        """
        return self._receive(self._fabric("receiving pushes from peers"), receive, Path(dest_dir))

    async def _receive(self, node, receive: Receive, dest_dir: Path) -> AsyncIterator[ReceivedFile]:
        allowed = set(receive.ref.peers or [])
        tag = receive.ref.resource

        def wants(push: PushStream) -> bool:
            if tag is None:
                return True  # untagged receive: catch-all
            r = push.resource
            return isinstance(r, dict) and r.get("resource") == tag

        dest_dir.mkdir(parents=True, exist_ok=True)
        consumer = node.consume_pushes(wants)
        try:
            async for push in consumer:
                try:
                    if allowed and push.peer not in allowed:
                        log.warning("dropping push from disallowed peer %s", push.peer)
                        await push.read_all()  # drain to release the accept slot
                        continue
                    resource, name = _push_names(push)
                    dest = dest_dir / f"{_safe_name(push.peer + '-' + name)}.bin"
                    size = await push.save_to(dest)
                except asyncio.CancelledError:
                    # Consumer went away mid-transfer: release the accept
                    # slot so the sender's connection isn't pinned forever.
                    push.finish()
                    raise
                meta = push.resource if isinstance(push.resource, dict) else {}
                yield ReceivedFile(dest, size, push.peer, resource, meta)
        finally:
            consumer.close()


def _push_names(push: PushStream) -> tuple:
    res = push.resource
    if isinstance(res, dict):
        return str(res.get("resource", "")), str(res.get("name", "push"))
    if isinstance(res, DataSlice):
        return res.dataset, f"{res.dataset}-{res.index}"
    return "", "push"
