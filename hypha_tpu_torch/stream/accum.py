"""The streaming sample-weighted delta accumulator (counterpart of
``hypha_tpu/stream/accum.py``).

The parameter server folds each arriving delta into a running f32 partial
sum Σ samples·Δθ as it lands, and ``fold(…, sign=-1)`` un-folds a replaced
duplicate; :meth:`RoundAccum.mean` finishes the weighted mean when the
round closes. Here the sum lives on a torch device (CUDA unless the caller
asks for the CPU), and the delta files are read one at a time through the
port's own SafeTensors reader (f32 or bf16, widened exactly to f32).

The arithmetic is the reference's, step for step: each fold multiplies the
delta by ``float32(sign * samples)`` and then adds the product, two
roundings and no fused multiply-add, as numpy does; ``mean`` divides by
``float32(Σ samples)``. So a fold sequence gives the reference's bits, on
the CPU and on the card alike (the divisor is a device tensor, because a
CUDA division by a host scalar multiplies by its reciprocal instead).

``prefolded`` folds accept a partial sum that is already sample-weighted:
the payload adds verbatim (scaled only by ``sign`` for un-folds) while the
shipped ``samples`` still advance the weight total. A delta file may be
in any per-job wire format (``compress.read_delta``): an HQD1 frame
dequantizes on the accumulator's device, a SafeTensors file (f32 or bf16)
is read on the host and moves there one tensor at a time.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from ..compress.frame import read_delta
from ..hw import default_device

__all__ = ["RoundAccum"]

class RoundAccum:
    """Streaming sample-weighted fold of one round's delta files.

    Holds ONE param-sized f32 tree (Σ samples·Δθ) on ``device`` instead of
    every worker's delta; tensors move to the device one at a time, so a
    whole delta never sits there beside the sum."""

    def __init__(self, device=None) -> None:
        self.device = default_device(device)
        self._acc: dict = {}
        self._shapes: dict = {}
        self.total_samples = 0.0
        self.folds = 0

    def fold(self, path: "Path | str", samples: float, sign: float = 1.0,
             prefolded: bool = False) -> None:
        self.fold_tree(read_delta(path, self.device), samples, sign, prefolded)

    def fold_tree(self, tree: dict, samples: float, sign: float = 1.0,
                  prefolded: bool = False) -> None:
        """Fold an already-decoded delta tree (name -> tensor or array)."""
        if self._shapes and set(tree) != set(self._shapes):
            raise ValueError("workers sent deltas with mismatched keys")
        # A prefolded payload is already Σ samples·Δ: only the sign applies.
        scale = float(np.float32(sign) if prefolded else np.float32(sign * samples))
        tensors = {k: torch.as_tensor(v) for k, v in tree.items()}
        for key, t in tensors.items():  # every shape checked before anything folds
            shape = self._shapes.get(key)
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"delta {key!r}: mismatched shape {tuple(t.shape)} vs {shape}")
        for key, t in tensors.items():
            self._shapes.setdefault(key, tuple(t.shape))
            contrib = torch.mul(t.to(self.device, torch.float32), scale)
            prev = self._acc.get(key)
            if prev is None:
                self._acc[key] = contrib
            else:
                prev.add_(contrib)
            del contrib
        self.total_samples += sign * samples
        self.folds += 1 if sign > 0 else -1

    def _denom(self) -> torch.Tensor:
        if not self._acc:
            raise ValueError("no deltas folded")
        return torch.tensor(max(self.total_samples, 1e-20), dtype=torch.float32,
                            device=self.device)

    def keys(self) -> list:
        """The names folded so far, in fold order."""
        return list(self._acc)

    def mean_items(self) -> Iterator[tuple]:
        """``(name, ḡ)`` one tensor at a time: :meth:`mean` without holding
        a second param-sized tree on the device."""
        denom = self._denom()
        for key, v in self._acc.items():
            yield key, v / denom

    def mean(self) -> dict:
        """The sample-weighted mean ḡ = Σ samples·Δθ / Σ samples (f32)."""
        return dict(self.mean_items())

    def partial(self) -> dict:
        """The raw weighted partial sum Σ samples·Δθ (f32)."""
        if not self._acc:
            raise ValueError("no deltas folded")
        return dict(self._acc)
