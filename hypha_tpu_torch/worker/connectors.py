"""Data-plane connectors: how job artifacts move (counterpart of
``hypha_tpu/worker/connectors.py``).

``Connector(node, scheduler_peer)`` routes each Reference variant:

  * ``uri`` — ``fetch_uri`` (``http(s)`` streamed to disk, ``file://``
    copied);
  * ``scheduler`` — the scheduler-mediated slice pull: a ``DataRequest``
    to the scheduler names a data node and an index, then the slice is
    pulled from that node over a pull stream. A pipelined job's reference
    carries its ``prefetch`` window, which the request forwards (the
    scheduler then holds that many slices for the worker and stamps the
    epoch on its answer); such a fetch lands under an epoch-unique name and
    is served from, and fills, the worker's on-disk ``SliceCache``;
  * ``peers`` — ``send`` pushes a file to the reference's peers (ALL:
    every peer must get it; ANY: the first success wins), with the
    caller's ``meta`` on the push header and a jittered re-push across a
    receiver's outage; ``receive`` yields the pushes that land from the
    allowed peers under the reference's resource tag, and leaves every
    other push to the node's other consumers.

``shard_route`` gives the Send of one placement part's delta under a
sharded parameter service: the owning shard under its updates tag, behind
the group's reducer with ANY failover when the job reduces in a tree.

The bytes each slice pull moves count into ``DATA_METRICS.bytes_pulled``.
Not ported: HuggingFace Hub downloads, which raise ``NotImplementedError``
naming **HF Hub** (ROADMAP.md, Queue 1).

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
from ..telemetry.ft_metrics import DATA_METRICS

__all__ = ["Connector", "ReceivedFile", "fetch_uri", "push_timeout", "shard_route"]

log = logging.getLogger("hypha.torch.worker.connector")


def _safe_name(name: str) -> str:
    """Collapse any peer-supplied name to a flat digest-based filename."""
    return hashlib.sha256(name.encode()).hexdigest()[:32]


# Outbound tensor pushes retry with jittered backoff (aio.retry) for up to
# this many seconds: a parameter-server restart or a transient partition
# costs a few re-attempts, not a lost delta and a wedged round.
PUSH_RETRY_DEADLINE_S = 120.0


def push_timeout(path: Path, base: float = 60.0) -> float:
    """Per-attempt wall-clock bound for a parameter-sized push: ``base``
    seconds plus the payload at a floor rate of 10 MB/s, so a push
    black-holed by a silent partition fails in time to retry while a slow
    multi-GB transfer is never cut mid-flight."""
    try:
        size = path.stat().st_size
    except OSError:
        size = 0
    return base + size / (10 * 1024 * 1024)


def shard_route(shard_map, part: int, reduce_via: "str | None" = None) -> tuple:
    """``(send, owner shard, tag)`` of one placement part's delta push: part
    ``p`` lands on shard ``shard_of(p, N)`` under that shard's updates tag.
    With a tree reduce the group's reducer is tried first, with ANY
    failover, so a dead reducer degrades the member to direct pushes (the
    shard reconciles the overlap by cover sets)."""
    from ..stream.partition import shard_of

    if not shard_map.shards:
        raise ValueError("shard_route needs a populated ShardMap")
    owner = shard_of(part, len(shard_map.shards))
    owner_peer = shard_map.shards[owner]
    tag = shard_map.tags[owner] if shard_map.tags else "updates"
    peers = [owner_peer]
    strategy = TransferStrategy.ALL
    if reduce_via and reduce_via != owner_peer:
        peers = [reduce_via, owner_peer]
        strategy = TransferStrategy.ANY
    return Send(Reference.from_peers(peers, tag, strategy)), owner, tag


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
    ``uri`` fetch works. ``slice_cache`` (a
    :class:`~hypha_tpu_torch.worker.slice_cache.SliceCache`, optional) backs
    the slice fetches of pipelined jobs."""

    def __init__(self, node=None, scheduler_peer: str = "", slice_cache=None) -> None:
        self.node = node
        self.scheduler_peer = scheduler_peer
        self.slice_cache = slice_cache

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
                "(ROADMAP.md, Queue 1: HF Hub)"
            )
        if variant == "scheduler":
            return [await self._fetch_slice(ref, dest_dir)]
        if variant == "peers":
            raise ValueError("peers variant is receive-only for fetch")
        raise ValueError(f"unknown fetch variant {variant}")

    async def _fetch_slice(self, ref: Reference, dest_dir: Path) -> Path:
        """Scheduler-mediated slice fetch: ask for an assignment, pull it.

        A pipelined job's fetch (``ref.prefetch`` set) forwards its window,
        names the file by the answer's epoch (the trainer may still be
        reading this index's file of the previous epoch), and is served
        from the slice cache, or fills it, around the network pull."""
        node = self._fabric("a scheduler-assigned slice fetch")
        scheduler = ref.scheduler_peer or self.scheduler_peer
        if not scheduler:
            raise ValueError("no scheduler peer for slice fetch")
        dataset = ref.dataset or ""
        resp = await node.request(
            scheduler, PROTOCOL_API,
            DataRequest(dataset=dataset, peer_id=node.peer_id, prefetch=ref.prefetch),
        )
        if not isinstance(resp, DataResponse):
            raise RequestError(f"unexpected data response {resp!r}")
        dest_dir.mkdir(parents=True, exist_ok=True)
        stem = _safe_name(ref.dataset or "slice")
        dest = (dest_dir / f"{stem}-e{resp.epoch}-{resp.index:06d}" if resp.epoch is not None
                else dest_dir / f"{stem}-{resp.index:06d}")
        cache = self.slice_cache if ref.prefetch is not None and resp.epoch is not None else None
        if cache is not None and await asyncio.to_thread(cache.get, dataset, resp.epoch,
                                                         resp.index, dest):
            return dest
        stream = await node.pull(resp.data_provider, DataSlice(dataset=dataset, index=resp.index))
        loop = asyncio.get_running_loop()
        pulled = 0
        try:
            f = await asyncio.to_thread(open, dest, "wb")
            try:
                while True:
                    chunk = await stream.read(1 << 20)
                    if not chunk:
                        break
                    pulled += len(chunk)
                    await loop.run_in_executor(None, f.write, chunk)
            finally:
                await asyncio.to_thread(f.close)
        except BaseException:
            # A pull cut short (the data node died) leaves no partial slice.
            dest.unlink(missing_ok=True)
            raise
        finally:
            await stream.close()
        DATA_METRICS.bytes_pulled.add(pulled)
        if cache is not None:
            await asyncio.to_thread(cache.put, dataset, resp.epoch, resp.index, dest)
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
