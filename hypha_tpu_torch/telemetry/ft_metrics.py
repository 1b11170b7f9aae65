"""Input-pipeline instruments (the ``DataMetrics`` bundle of
``hypha_tpu/telemetry/ft_metrics.py``): the process-global
:data:`DATA_METRICS` that the trainer's input stream, its slice prefetcher,
the worker's connector and its slice cache record into. The trainer logs
``data metrics: {snapshot}`` when it ends."""

from __future__ import annotations

import threading

from . import Counter

__all__ = ["DataMetrics", "DATA_METRICS"]


class DataMetrics:
    """Input-pipeline instruments.

    * ``input_wait_seconds``    — wall-clock the TRAINING thread spent
      blocked waiting for the next batch; ``input_waits`` counts the waits.
    * ``boundary_wait_seconds`` — the subset of input waits spent
      acquiring a SLICE (scheduler round-trip + data-node pull + disk
      write on the sync path, queue wait on the prefetch path);
      ``boundary_waits`` counts them.
    * ``slice_fetch_seconds``   — time actually pulling slices, wherever
      it ran (training thread or the background prefetcher), plus
      ``slices_fetched`` / ``bytes_pulled``.
    * ``prefetch_queue_depth``  — ready-and-unconsumed prefetched slices
      (gauge: last sample; ``peak`` kept separately) and
      ``prefetch_errors`` (fetch attempts the prefetcher retried).
    * ``cache hits/misses``     — on-disk slice-LRU outcomes
      (``worker/slice_cache.py``), plus evictions and corrupt-entry
      refetches.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.input_wait_seconds = 0.0
        self.input_waits = 0
        self.boundary_wait_seconds = 0.0
        self.boundary_waits = 0
        self.slice_fetch_seconds = 0.0
        self._queue_depth = 0.0
        self.peak_queue_depth = 0.0
        self.slices_fetched = Counter("hypha.data.slices_fetched")
        self.bytes_pulled = Counter("hypha.data.bytes_pulled")
        self.prefetch_errors = Counter("hypha.data.prefetch_errors")
        self.cache_hits = Counter("hypha.data.cache_hits")
        self.cache_misses = Counter("hypha.data.cache_misses")
        self.cache_evictions = Counter("hypha.data.cache_evictions")
        self.cache_corrupt = Counter("hypha.data.cache_corrupt")

    def note_input_wait(self, seconds: float) -> None:
        """The training loop waited this long for its next batch (host
        assembly and any slice acquisition that ran inline)."""
        with self._lock:
            self.input_wait_seconds += max(float(seconds), 0.0)
            self.input_waits += 1

    def note_boundary_wait(self, seconds: float) -> None:
        """A slice acquisition blocked the stream this long (a subset of
        the input waits, kept apart so the slice-boundary stall can be
        read on its own)."""
        with self._lock:
            self.boundary_wait_seconds += max(float(seconds), 0.0)
            self.boundary_waits += 1

    def note_fetch(self, seconds: float) -> None:
        """One slice materialized (training thread or prefetcher); the
        pulling connector credits the wire bytes (a cache hit moves none)."""
        with self._lock:
            self.slice_fetch_seconds += max(float(seconds), 0.0)
        self.slices_fetched.add(1)

    def note_queue_depth(self, depth: float) -> None:
        with self._lock:
            self._queue_depth = float(depth)
            self.peak_queue_depth = max(self.peak_queue_depth, float(depth))

    def snapshot(self) -> dict:
        with self._lock:
            wait_s = self.input_wait_seconds
            waits = self.input_waits
            boundary_s = self.boundary_wait_seconds
            boundaries = self.boundary_waits
            fetch_s = self.slice_fetch_seconds
            depth = self._queue_depth
            peak = self.peak_queue_depth
        return {
            "input_wait_seconds": wait_s,
            "input_waits": waits,
            "boundary_wait_seconds": boundary_s,
            "boundary_waits": boundaries,
            "mean_boundary_wait_s": boundary_s / boundaries if boundaries else 0.0,
            "slice_fetch_seconds": fetch_s,
            "slices_fetched": self.slices_fetched.value(),
            "bytes_pulled": self.bytes_pulled.value(),
            "prefetch_queue_depth": depth,
            "peak_prefetch_queue_depth": peak,
            "prefetch_errors": self.prefetch_errors.value(),
            "cache_hits": self.cache_hits.value(),
            "cache_misses": self.cache_misses.value(),
            "cache_evictions": self.cache_evictions.value(),
            "cache_corrupt": self.cache_corrupt.value(),
        }

    def reset(self) -> None:
        """Fresh instruments (tests isolate runs this way)."""
        self.__init__()


DATA_METRICS = DataMetrics()
