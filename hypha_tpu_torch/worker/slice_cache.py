"""Bounded on-disk LRU cache of dataset slices, keyed (dataset, epoch,
index) (counterpart of ``hypha_tpu/worker/slice_cache.py``).

A rejoining or restarted worker re-pulls nothing it already holds: the
cache lives under the worker's ``work_root`` (which outlives each job's
work dir), so a re-dispatched execution's slice fetches hit disk instead of
the data node. Entries carry a SHA-256 sidecar computed while the bytes
stream in, and every read re-hashes during the copy-out: a corrupt or
truncated entry (a partial write before a crash, bit rot) is evicted and
falls back to a network refetch instead of feeding the model garbage.

Eviction is LRU by entry mtime (touched on every hit), bounded by
``max_bytes`` (``$HYPHA_SLICE_CACHE_MB``, default 512). All methods are
synchronous file I/O: callers on an event loop run them through
``asyncio.to_thread`` (the connector does).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from pathlib import Path

from ..telemetry.ft_metrics import DATA_METRICS

__all__ = ["SliceCache", "DEFAULT_CACHE_BYTES"]

log = logging.getLogger("hypha.torch.worker.slice_cache")

_CACHE_MB_ENV = "HYPHA_SLICE_CACHE_MB"
DEFAULT_CACHE_BYTES = 512 * 1024 * 1024
_CHUNK = 1 << 20


def _default_bytes() -> int:
    raw = os.environ.get(_CACHE_MB_ENV, "")
    try:
        return int(float(raw) * 1024 * 1024) if raw else DEFAULT_CACHE_BYTES
    except ValueError:
        return DEFAULT_CACHE_BYTES


def _copy_hashed(src: Path, dst: Path) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f, open(dst, "wb") as g:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
            g.write(chunk)
    return h.hexdigest()


class SliceCache:
    def __init__(self, root: Path | str, max_bytes: int | None = None) -> None:
        self.root = Path(root)
        self.max_bytes = max_bytes if max_bytes is not None else _default_bytes()
        self._lock = threading.Lock()

    @staticmethod
    def _stem(dataset: str) -> str:
        return hashlib.sha256(dataset.encode()).hexdigest()[:16]

    def _entry(self, dataset: str, epoch: int, index: int) -> Path:
        return self.root / f"{self._stem(dataset)}-e{int(epoch)}-{int(index):06d}.slice"

    def _promote_locked(self, dataset: str, epoch: int, index: int, entry: Path) -> None:
        """A slice's CONTENT is a pure function of (dataset, index) — the
        data node serves immutable files — so an entry cached under a
        previous epoch is byte-identical work. Rename the newest such
        entry (and its sidecar) to the current epoch's key: cross-epoch
        hits instead of one dead generation of entries per wrap, while
        the accounting key stays (dataset, epoch, index)."""
        older = sorted(
            self.root.glob(f"{self._stem(dataset)}-e*-{int(index):06d}.slice"),
            key=lambda p: p.stat().st_mtime,
        )
        if not older:
            return
        prev = older[-1]
        prev_sidecar = prev.with_suffix(".sha256")
        if not prev_sidecar.is_file():
            return
        try:
            prev.replace(entry)
            prev_sidecar.replace(entry.with_suffix(".sha256"))
        except OSError:
            pass

    # ----------------------------------------------------------------- get

    def get(self, dataset: str, epoch: int, index: int, dest: Path) -> bool:
        """Copy the cached slice to ``dest`` (re-hashing on the way out);
        False — and the entry evicted — when absent or corrupt."""
        entry = self._entry(dataset, epoch, index)
        sidecar = entry.with_suffix(".sha256")
        with self._lock:
            if not entry.is_file() or not sidecar.is_file():
                self._promote_locked(dataset, epoch, index, entry)
            if not entry.is_file() or not sidecar.is_file():
                DATA_METRICS.cache_misses.add(1)
                return False
            want = sidecar.read_text().strip()
            dest.parent.mkdir(parents=True, exist_ok=True)
            try:
                got = _copy_hashed(entry, dest)
            except OSError as e:
                log.warning("slice cache read failed (%s); refetching", e)
                got = ""
            if got != want:
                DATA_METRICS.cache_corrupt.add(1)
                DATA_METRICS.cache_misses.add(1)
                log.warning(
                    "slice cache entry %s corrupt (sha mismatch); evicting",
                    entry.name,
                )
                entry.unlink(missing_ok=True)
                sidecar.unlink(missing_ok=True)
                dest.unlink(missing_ok=True)
                return False
            # LRU touch: hits keep the entry young.
            os.utime(entry)
            DATA_METRICS.cache_hits.add(1)
            return True

    # ----------------------------------------------------------------- put

    def put(self, dataset: str, epoch: int, index: int, src: Path) -> None:
        """Insert (atomically: tmp + rename, sidecar last) and evict LRU
        entries beyond ``max_bytes``."""
        entry = self._entry(dataset, epoch, index)
        tmp = entry.with_suffix(".tmp")
        with self._lock:
            self.root.mkdir(parents=True, exist_ok=True)
            try:
                digest = _copy_hashed(src, tmp)
                tmp.replace(entry)
                entry.with_suffix(".sha256").write_text(digest + "\n")
            except OSError as e:
                log.warning("slice cache insert failed: %s", e)
                tmp.unlink(missing_ok=True)
                return
            self._evict_locked(keep=entry)

    def _evict_locked(self, keep: Path | None = None) -> None:
        entries = sorted(
            (p for p in self.root.glob("*.slice") if p.is_file()),
            key=lambda p: p.stat().st_mtime,
        )
        total = sum(p.stat().st_size for p in entries)
        for victim in entries:
            if total <= self.max_bytes:
                break
            if keep is not None and victim == keep:
                continue  # never evict the slice just inserted
            total -= victim.stat().st_size
            victim.unlink(missing_ok=True)
            victim.with_suffix(".sha256").unlink(missing_ok=True)
            DATA_METRICS.cache_evictions.add(1)

    # ------------------------------------------------------------- queries

    def entries(self) -> int:
        return sum(1 for _ in self.root.glob("*.slice"))

    def bytes_used(self) -> int:
        return sum(p.stat().st_size for p in self.root.glob("*.slice"))
