"""Worker rejoin: catch a replacement up to the current global weights
(counterpart of ``hypha_tpu/ft/rejoin.py``).

The parameter server never holds full weights, but every worker starts
from the same θ₀ (the seed, or the job's ``source`` file), so

    θ_r = θ₀ + Σ_{k<r} update_k

and the server keeps the running Σ of the updates it broadcast (one
param-sized f32 tree on the host, as numpy, exactly as the reference
keeps it, so both packages' sums are byte-equal). A rejoining worker is
dispatched with ``rejoin=True``, builds θ₀, waits on its results stream for
the push whose header carries ``catchup: True`` (Σ, the authoritative next
round and the membership epoch), merges it and enters the inner loop at
that round. :func:`await_catchup` skips stray round broadcasts that race in
first: their content is inside any later Σ.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..compress import read_delta
from ..executor.serialization import save_file

__all__ = ["CatchupBuffer", "await_catchup", "merge_catchup_arrays", "sum_updates", "CATCHUP_KEY"]

# Header key marking a results-stream push as a rejoin catch-up.
CATCHUP_KEY = "catchup"


def _host_f32(value) -> np.ndarray:
    """``value`` (a tensor on any device, or an array) as host f32 numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value, np.float32)


class CatchupBuffer:
    """The parameter server's running Σ of broadcast updates (f32, host).

    Empty until the first outer step: a worker joining during round 0
    receives an empty catch-up. ``fragment_rounds`` counts the updates
    folded per fragment (None for unfragmented jobs), as the reference's."""

    def __init__(self) -> None:
        self._cum: dict = {}
        self.rounds = 0
        self.fragment_rounds: dict = {}
        self._written: "tuple | None" = None  # (rounds, path) of the last write

    def accumulate(self, update_path: "Path | str", fragment_id: "int | None" = None) -> None:
        """Fold one round's update file (any wire codec, decoded on the
        host: what every worker merged) into the sum."""
        self.accumulate_tree(read_delta(update_path, device="cpu"), fragment_id=fragment_id)

    def accumulate_tree(self, update: dict, fragment_id: "int | None" = None) -> None:
        """Fold one round's already-decoded update tree (tensors on any
        device, or arrays) into the sum."""
        for key, value in update.items():
            arr = _host_f32(value)
            prev = self._cum.get(key)
            if prev is None:
                self._cum[key] = arr.copy()
            elif prev.shape != arr.shape:
                raise ValueError(f"catchup {key!r}: update shape {arr.shape} != {prev.shape}")
            else:
                prev += arr
        self.rounds += 1
        self.fragment_rounds[fragment_id] = self.fragment_rounds.get(fragment_id, 0) + 1

    def state(self) -> tuple:
        """(cumulative sum, rounds, fragment_rounds) for the durable
        parameter server's checkpoint."""
        return dict(self._cum), self.rounds, dict(self.fragment_rounds)

    def restore(self, cum: dict, rounds: int, fragment_rounds: dict) -> None:
        self._cum = {k: _host_f32(v).copy() for k, v in cum.items()}
        self.rounds = int(rounds)
        self.fragment_rounds = dict(fragment_rounds)
        self._written = None

    def write(self, path: "Path | str") -> Path:
        """Materialize the sum for a catch-up push (written beside, then
        renamed), once per accumulation state. Tensors go in name order, as
        the reference's ``safetensors`` writer orders one dtype."""
        path = Path(path)
        if self._written == (self.rounds, str(path)) and path.is_file():
            return path
        tmp = path.with_suffix(".tmp")
        save_file(dict(sorted(self._cum.items())), tmp)
        tmp.replace(path)
        self._written = (self.rounds, str(path))
        return path

    def is_empty(self) -> bool:
        return not self._cum


def await_catchup(events: Iterator[dict],
                  on_skip: "Callable[[dict], None] | None" = None) -> dict:
    """Consume bridge receive events until the catch-up arrives; returns
    it (its ``meta`` carries ``round`` and ``epoch``). Events before it go
    to ``on_skip`` and are dropped."""
    for event in events:
        meta = event.get("meta") or {}
        if meta.get(CATCHUP_KEY):
            return event
        if on_skip is not None:
            on_skip(event)
    raise RuntimeError("results stream ended before the rejoin catch-up arrived")


def merge_catchup_arrays(params: dict, cum: dict) -> dict:
    """Host-side θ₀ + Σ (f32 sum, then the parameter's dtype)."""
    merged = dict(params)
    for key, value in cum.items():
        if key not in merged:
            raise KeyError(f"catchup tensor {key!r} not in params")
        base = merged[key]
        merged[key] = (base.astype(np.float32) + value).astype(base.dtype)
    return merged


def sum_updates(paths: Iterable) -> dict:
    """Σ over a list of update files (a mirror of :class:`CatchupBuffer`)."""
    buf = CatchupBuffer()
    for p in paths:
        buf.accumulate(p)
    return dict(buf._cum)
