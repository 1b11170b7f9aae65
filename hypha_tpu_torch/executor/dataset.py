"""Scheduler-assigned SafeTensors slices -> training batches (counterpart of
the synchronous path of ``hypha_tpu/executor/dataset.py``).

An infinite generator asks for the next slice path, reads the file through
the port's own SafeTensors reader, and yields the slice's samples (each
tensor's leading axis indexes samples); batching stacks ``batch_size``
consecutive samples, dropping a ragged tail. Batches are CPU tensors
(``int64``/``int32`` token ids as stored); the trainer moves them to the
device. The background prefetch pipeline (``pipeline=True``) is not ported
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Iterator

import torch

from .serialization import load_file

__all__ = ["load_slice", "slice_samples", "batches", "slice_batches", "stream_batches"]

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


def load_slice(path: "Path | str", input_names: "list[str] | None" = None) -> dict:
    """One slice as whole tensors trimmed to the common sample count; only
    ``input_names`` are read when given."""
    tensors = load_file(path, input_names or None)
    n = _sample_count(tensors, path)
    return {k: v[:n] for k, v in tensors.items()}


def slice_samples(path: "Path | str", input_names: "list[str] | None" = None) -> Iterator[dict]:
    """Per-sample dicts of one slice."""
    tensors = load_slice(path, input_names)
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


def stream_batches(
    fetch_slice: Callable[[], str],
    batch_size: int,
    input_names: "list[str] | None" = None,
    preprocessor: "Callable | None" = None,
    *,
    pipeline: bool = False,
) -> Iterator[dict]:
    """The infinite batch stream: ``fetch_slice()`` blocks until the
    scheduler assigns the next slice and returns its local path."""
    if pipeline:
        raise NotImplementedError(
            "the async input pipeline is not ported (ROADMAP.md, Queue 1: input_pipeline)"
        )
    if preprocessor is not None:
        raise NotImplementedError(
            "slice preprocessors are not ported (ROADMAP.md, Queue 1: preprocessor)"
        )

    def samples() -> Iterator[dict]:
        while True:
            yield from slice_samples(fetch_slice(), input_names)

    return batches(samples(), batch_size)
