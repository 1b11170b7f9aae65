"""DiLoCo delta algebra and the outer Nesterov step (counterpart of
``hypha_tpu/executor/diloco.py``), on ``{name: tensor}`` maps (a module's
state dict, or the flat names of a SafeTensors file).

  * pseudo-gradient: Δθ = θ_t − θ_0 against the round's anchor, in f32;
  * worker merge: θ_new = θ + update (the update already holds
    lr·(μ·m + ḡ));
  * outer step (parameter server): m ← μ·m + ḡ; update = lr·(μ·m + ḡ),
    with ḡ the (optionally sample-weighted) mean of the workers' Δθ.

Every function returns new tensors and leaves its inputs alone, as the
JAX functions do.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = [
    "extract_delta",
    "merge_update",
    "merge_update_f32",
    "apply_updates",
    "average_deltas",
    "nesterov_init",
    "nesterov_outer_step",
]


def extract_delta(params: Mapping, anchor: Mapping) -> dict:
    """Δθ = θ_t − θ_0, each leaf subtracted and returned in f32 (XLA widens
    a bf16 difference that is cast to f32 in the same way)."""
    return {k: p.float() - anchor[k].float() for k, p in params.items()}


def merge_update(params: Mapping, update: Mapping) -> dict:
    """θ + update with the update cast to each leaf's dtype first."""
    return {k: (p + update[k].to(device=p.device, dtype=p.dtype)).to(p.dtype)
            for k, p in params.items()}


def merge_update_f32(params: Mapping, update: Mapping) -> dict:
    """θ + update added in f32, then cast to each leaf's dtype."""
    return {k: (params[k].float() + update[k].to(params[k].device).float()).to(params[k].dtype)
            for k in update}


def apply_updates(params: Mapping, updates: list) -> dict:
    """θ + Σ updates, summed and added in f32 before the per-leaf cast."""
    if not updates:
        return dict(params)
    out = {}
    for k, p in params.items():
        total = sum(u[k].to(p.device).float() for u in updates)
        out[k] = (p.float() + total).to(p.dtype)
    return out


def average_deltas(deltas: list, weights=None) -> dict:
    """The mean of the workers' pseudo-gradients; ``weights`` (per-worker
    sample counts) make it the sample-weighted mean."""
    if not deltas:
        raise ValueError("no deltas")
    if weights is None:
        w = torch.full((len(deltas),), 1.0 / len(deltas), dtype=torch.float32)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32)
        w = w / torch.clamp(w.sum(), min=1e-20)
    out = {}
    for k in deltas[0]:
        stacked = torch.stack([d[k].float() for d in deltas])
        out[k] = torch.tensordot(w.to(stacked.device), stacked, dims=1)
    return out


def nesterov_init(params: Mapping) -> dict:
    """Zero f32 momentum shaped like each leaf."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def nesterov_outer_step(momentum: Mapping, mean_delta: Mapping, lr: float, mu: float) -> tuple:
    """One outer step: ``(new_momentum, update_to_broadcast)``, as torch's
    SGD(nesterov=True) on the ascent-direction pseudo-gradient. Each
    μ·x + g is one fused multiply-add (``addcmul``), as XLA compiles the
    JAX step, so the two agree bit for bit."""
    new_m, update = {}, {}
    for k, g in mean_delta.items():
        g = g.float()
        mu32 = torch.tensor(mu, dtype=torch.float32, device=g.device)
        m = torch.addcmul(g, momentum[k].to(g.device), mu32)
        new_m[k] = m
        update[k] = torch.tensor(lr, dtype=torch.float32, device=g.device) * torch.addcmul(g, m, mu32)
    return new_m, update
