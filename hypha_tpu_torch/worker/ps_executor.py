"""The parameter server's outer step (counterpart of the arithmetic core of
``hypha_tpu/worker/ps_executor.py``: ``ParameterServerExecutor._outer_step``
at ``:2382-2440``, with ``hypha_tpu/native.py:157-169``
``nesterov_update``).

One round: the sample-weighted mean pseudo-gradient ḡ of the workers'
deltas (folded by :class:`~hypha_tpu_torch.stream.accum.RoundAccum`), then
Nesterov momentum on it, tensor by tensor on the device:

    m ← μ·m + ḡ;   update ← lr·(μ·m + ḡ)

The update goes to ``update-{round}.safetensors`` and the new momentum
replaces the momentum file atomically (written beside it, then renamed),
as the reference does, so a crash mid-write leaves the old momentum.

The arithmetic is the reference's numpy path (``native.nesterov_update``
without its C++ library): every product and every sum rounds to f32 on
its own, with no fused multiply-add, so it matches that path bit for bit
on the CPU and on the card. The C++ path is built with ``-O3
-march=native``, which lets the compiler fuse ``μ·m + g``; against it the
results agree to f32 rounding.

The executor around this step (receiving pushes, folding them as they
land, broadcasting the update, the round journal) is not ported
(ROADMAP.md, Queue 1: the parameter-server executor).
"""

from __future__ import annotations

import math
import os
from pathlib import Path

import torch

from ..executor.serialization import load_file, save_file
from ..stream.accum import RoundAccum

__all__ = ["outer_step"]


def _copy(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` in f32 on ``device``: a momentum tensor on its way to the
    device, or a result on its way back to the host."""
    return t.to(device, torch.float32)


def _sq_sum(t: torch.Tensor) -> float:
    """Σ t², accumulated in f64 as the reference's norms are."""
    return float(torch.sum(torch.square(t.double())))


def outer_step(
    received: dict,
    momentum_file: Path,
    lr: float,
    mu: float,
    work_dir: Path,
    round_num: int,
    accum: "RoundAccum | None" = None,
    stats: "dict | None" = None,
    device=None,
) -> Path:
    """Nesterov over the round's sample-weighted mean pseudo-gradient.

    ``received`` maps each worker to ``(delta path, samples)``. An
    ``accum`` that already folded every delta as it arrived is used as it
    is; without one (or with an empty one) the received files are folded
    now, on ``device`` (CUDA unless the caller asks for the CPU).
    ``stats``, when given, is filled with the L2 norms of ḡ and of the
    update and the accepted-delta count. Returns the update file's path.
    """
    if accum is None or accum.folds == 0:
        accum = RoundAccum(device=device) if accum is None else accum
        for path, samples in received.values():
            accum.fold(path, samples)
    work_dir, momentum_file = Path(work_dir), Path(momentum_file)
    out = work_dir / f"update-{round_num}.safetensors"
    momentum_tmp = work_dir / "momentum.next.safetensors"
    # Host copies: the device holds only the sum and one tensor's step.
    momentum: dict = dict(load_file(momentum_file)) if momentum_file.is_file() else {}
    update: dict = {}
    g_sq = u_sq = 0.0
    for key, g in accum.mean_items():
        m = momentum.get(key)
        if m is None:
            m = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        elif m.numel() != g.numel():
            # A short tensor from a faulty worker must fail here.
            raise ValueError(f"delta {key!r}: size {g.numel()} != momentum {m.numel()}")
        else:
            m = _copy(m, g.device).reshape(g.shape)
        new_m = torch.mul(m, mu).add_(g)
        upd = torch.mul(new_m, mu).add_(g).mul_(lr)
        if stats is not None:
            g_sq += _sq_sum(g)
            u_sq += _sq_sum(upd)
        momentum[key] = _copy(new_m, "cpu")
        update[key] = _copy(upd, "cpu")
        del g, m, new_m, upd
    if stats is not None:
        stats["delta_norm"] = math.sqrt(g_sq)
        stats["update_norm"] = math.sqrt(u_sq)
        stats["accepted"] = float(len(received))
    save_file(update, out)
    save_file(momentum, momentum_tmp)
    os.replace(momentum_tmp, momentum_file)
    return out
