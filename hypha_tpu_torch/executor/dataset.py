"""Scheduler-assigned SafeTensors slices -> training batches (counterpart of
``hypha_tpu/executor/dataset.py``).

An infinite generator asks for the next slice path, reads the file through
the port's own SafeTensors reader, optionally runs a preprocessor over the
slice (``executor/preprocess.py``), and yields the slice's samples (each
tensor's leading axis indexes samples); batching stacks ``batch_size``
consecutive samples, dropping a ragged tail. Batches are CPU tensors
(``int64``/``int32`` token ids as stored); the trainer moves them to the
device.

The input pipeline (``pipeline=True``): the same infinite stream, with

  * **slice prefetch** — a bounded background :class:`SlicePrefetcher`
    thread runs ``fetch_slice()`` (the bridge's scheduler round trip, the
    data-node pull and the disk write) up to ``prefetch`` slices ahead
    while the current slice trains, so a slice boundary costs a queue pop;
  * **whole-slice batches** — :func:`slice_batches` hands out contiguous
    views of the slice tensors, and joins a slice's ragged tail to the
    next slice's head.

Both assemblies yield the same batch values in the same order;
``pipeline=False`` (the default) runs the per-sample path unchanged.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

from ..telemetry import trace
from ..telemetry.ft_metrics import DATA_METRICS
from . import DEFAULT_PREFETCH_SLICES
from .serialization import load_file, read_header

__all__ = ["load_slice", "slice_samples", "batches", "slice_batches", "stream_batches",
           "SlicePrefetcher", "DEFAULT_PREFETCH_SLICES"]

log = logging.getLogger("hypha.torch.executor.dataset")


def _sample_count(tensors: dict, path) -> int:
    """The leading-axis sample count shared by every tensor (clamped, with
    a warning, when they differ); an empty slice is an error."""
    if not tensors:
        raise ValueError(f"slice {path}: no tensors to train on")
    counts = {k: int(v.shape[0]) if v.dim() else 0 for k, v in tensors.items()}
    n = min(counts.values())
    if len(set(counts.values())) > 1:
        log.warning("slice %s: ragged sample counts %s; using %d", path, counts, n)
    if n == 0:
        raise ValueError(f"slice {path}: zero samples (counts {counts})")
    return n


def load_slice(path: "Path | str", input_names: "list[str] | None" = None,
               preprocessor: "Callable[[dict], dict] | None" = None) -> dict:
    """One slice as whole tensors trimmed to the common sample count. With a
    preprocessor every tensor is read, the preprocessor runs, and then the
    result is filtered to ``input_names``; without one only ``input_names``
    are read."""
    if preprocessor is None:
        if input_names:
            missing = [k for k in input_names if k not in read_header(path)[0]]
            if missing:
                raise KeyError(f"slice {path}: missing input tensors {missing}")
        tensors = load_file(path, input_names or None)
    else:
        tensors = preprocessor(load_file(path))
        if input_names:
            tensors = {k: tensors[k] for k in input_names}
    n = _sample_count(tensors, path)
    return {k: v[:n] for k, v in tensors.items()}


def slice_samples(path: "Path | str", input_names: "list[str] | None" = None,
                  preprocessor: "Callable[[dict], dict] | None" = None) -> Iterator[dict]:
    """Per-sample dicts of one slice."""
    tensors = load_slice(path, input_names, preprocessor)
    n = next(iter(tensors.values())).shape[0]
    for i in range(n):
        yield {k: v[i] for k, v in tensors.items()}


def batches(samples: Iterator[dict], batch_size: int) -> Iterator[dict]:
    """Stack consecutive samples into static-shape batches."""
    buf: list[dict] = []
    for sample in samples:
        buf.append(sample)
        if len(buf) == batch_size:
            yield {k: torch.stack([s[k] for s in buf]) for k in buf[0]}
            buf.clear()


def slice_batches(slices: Iterator[dict], batch_size: int) -> Iterator[dict]:
    """Batches from whole-slice tensors: the same values in the same order
    as :func:`batches` over their samples, as views where a batch lies in
    one slice; a slice's ragged tail joins the next slice's head."""
    B = int(batch_size)
    if B <= 0:
        raise ValueError("batch_size must be positive")
    carry = None
    keys = None
    for tensors in slices:
        if keys is None:
            keys = sorted(tensors)
        elif sorted(tensors) != keys:
            raise ValueError(f"slice key mismatch mid-stream: {sorted(tensors)} vs {keys}")
        n = min(int(v.shape[0]) for v in tensors.values())
        start = 0
        if carry is not None:
            have = int(next(iter(carry.values())).shape[0])
            need = B - have
            if n < need:
                carry = {k: torch.cat([carry[k], tensors[k][:n]]) for k in tensors}
                continue
            yield {k: torch.cat([carry[k], tensors[k][:need]]) for k in tensors}
            carry, start = None, need
        full = (n - start) // B
        for i in range(full):
            lo = start + i * B
            yield {k: v[lo: lo + B] for k, v in tensors.items()}
        rem = start + full * B
        if rem < n:
            carry = {k: v[rem:n] for k, v in tensors.items()}


class SlicePrefetcher:
    """Bounded background slice fetcher: at most ``depth`` fetched-ahead
    slices exist at once (the queue bound throttles the producer), so a
    slice boundary on the training thread costs a queue pop while the next
    slice's scheduler round trip and pull are already under way.

    A failed fetch (a data node mid-restart, a scheduler blip) is retried
    with exponential backoff (``retry_base_s`` doubling, capped at 5 s) for
    up to ``retry_deadline_s`` seconds; after that the error surfaces on
    :meth:`take`.
    """

    _ERROR = "error"

    def __init__(self, fetch_slice: Callable[[], str], depth: int = DEFAULT_PREFETCH_SLICES,
                 retry_deadline_s: float = 60.0, retry_base_s: float = 0.25) -> None:
        self.depth = max(int(depth), 1)
        self._fetch = fetch_slice
        self._retry_deadline_s = float(retry_deadline_s)
        self._retry_base_s = float(retry_base_s)
        self._q: "queue.Queue[tuple[str, Any]]" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._main, daemon=True, name="slice-prefetch")
        self._thread.start()

    def _main(self) -> None:
        while not self._stop.is_set():
            failed_since: "float | None" = None
            attempt = 0
            while True:
                try:
                    path = self._fetch()
                    break
                except Exception as e:  # noqa: BLE001 - surfaced on take()
                    DATA_METRICS.prefetch_errors.add(1)
                    now = time.monotonic()
                    failed_since = failed_since if failed_since is not None else now
                    if self._stop.is_set() or now - failed_since >= self._retry_deadline_s:
                        self._q.put((self._ERROR, e))
                        return
                    delay = min(self._retry_base_s * (2.0 ** attempt), 5.0)
                    attempt += 1
                    log.warning("slice prefetch failed (%s); retrying in %.2fs", e, delay)
                    if self._stop.wait(delay):
                        return
            self._q.put(("path", path))
            DATA_METRICS.note_queue_depth(self._q.qsize())

    def take(self) -> str:
        """The next ready slice path, blocking until the prefetcher lands
        one (the blocked time is the slice-boundary stall left)."""
        kind, value = self._q.get()
        DATA_METRICS.note_queue_depth(self._q.qsize())
        if kind == self._ERROR:
            raise RuntimeError(f"slice prefetch failed: {value}") from (
                value if isinstance(value, BaseException) else None)
        return value

    def close(self) -> None:
        """Stop fetching; unblock a producer parked on the full queue."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except Exception:  # Empty, or module globals gone at interpreter exit
                break
        self._thread.join(timeout=5.0)


def _boundary_wait(acquire: Callable[[], str], span_ctx=None) -> str:
    """Time and trace the training thread's slice acquisition: the
    slice-boundary stall the prefetcher exists to hide. ``span_ctx`` is a
    zero-argument callable returning ``(traceparent, node)``, so the
    ``input_wait`` span joins the current round's trace (a no-op when
    tracing is off)."""
    parent, node = span_ctx() if span_ctx is not None else (None, None)
    span = trace.begin("input_wait", parent=parent, node=node)
    t0 = time.monotonic()
    try:
        return acquire()
    finally:
        trace.finish(span)
        DATA_METRICS.note_boundary_wait(time.monotonic() - t0)


def stream_batches(
    fetch_slice: Callable[[], str],
    batch_size: int,
    input_names: "list[str] | None" = None,
    preprocessor: "Callable | None" = None,
    *,
    pipeline: bool = False,
    prefetch: "int | None" = None,
    unlink_consumed: bool = False,
    span_ctx: "Callable[[], tuple[Any, Any]] | None" = None,
) -> Iterator[dict]:
    """The infinite batch stream: ``fetch_slice()`` blocks until the
    scheduler assigns the next slice and returns its local path.

    ``pipeline=False`` is the synchronous per-sample path; ``pipeline=True``
    prefetches ``prefetch`` slices ahead (``DEFAULT_PREFETCH_SLICES`` when
    unset) and batches whole slices: the same values in the same order.
    ``unlink_consumed`` deletes each pipelined slice file once its tensors
    are in memory (pipelined fetches land under epoch-unique names, so a
    long job would otherwise keep one file per slice and epoch).
    ``span_ctx`` parents each slice wait's ``input_wait`` span."""
    if not pipeline:
        def samples() -> Iterator[dict]:
            while True:
                yield from slice_samples(_boundary_wait(fetch_slice, span_ctx), input_names, preprocessor)

        return batches(samples(), batch_size)

    def slices(prefetcher: SlicePrefetcher) -> Iterator[dict]:
        while True:
            path = _boundary_wait(prefetcher.take, span_ctx)
            tensors = load_slice(path, input_names, preprocessor)
            if unlink_consumed:
                Path(path).unlink(missing_ok=True)
            yield tensors

    def pipelined() -> Iterator[dict]:
        # The prefetcher starts with the first batch asked for; closing the
        # stream stops its thread at once.
        prefetcher = SlicePrefetcher(fetch_slice, depth=prefetch or DEFAULT_PREFETCH_SLICES)
        try:
            yield from slice_batches(slices(prefetcher), batch_size)
        finally:
            prefetcher.close()

    return pipelined()
