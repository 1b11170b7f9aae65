"""LoRA fine-tuning: adapter-only training (counterpart of
``hypha_tpu/executor/lora.py``).

The base weights stay frozen (``requires_grad`` off) and only the low-rank
adapters of ``models/llama.py`` (``lora_rank``) get gradients, optimizer
state and pushes, so a round boundary carries megabytes instead of the
whole model.

The split works on ``state_dict``-style maps by name: a parameter whose
name holds ``_lora_`` is an adapter, every other one is the frozen base.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..messages import Loss
from .train import AdamW, make_train_step

__all__ = ["is_lora", "split_lora", "merge_lora", "fold_lora", "make_lora_train_step"]


def is_lora(name: str) -> bool:
    return "_lora_" in name


def split_lora(params: dict) -> tuple:
    """``{name: tensor}`` -> ``(adapters, frozen_base)`` by name."""
    adapters = {k: v for k, v in params.items() if is_lora(k)}
    return adapters, {k: v for k, v in params.items() if not is_lora(k)}


def merge_lora(adapters: dict, frozen: dict) -> dict:
    """The inverse of :func:`split_lora` (adapters win on a clash)."""
    return {**frozen, **adapters}


@torch.no_grad()
def fold_lora(params: dict, alpha: float, rank: int) -> dict:
    """Fold the adapters into their projections for adapter-free serving:
    ``W' = W + (α/r)·(A B)ᵀ``, the product in the adapters' dtype and cast
    to ``W``'s (the port's ``W`` is ``[out, in]``, the transpose of the
    reference's kernel). Returns a map with no ``_lora_`` names, which a
    ``lora_rank=0`` model loads."""
    scale = alpha / rank
    out = {k: v for k, v in params.items() if not is_lora(k)}
    for name, a in params.items():
        if not name.endswith("_lora_a"):
            continue
        target = name.removesuffix("_lora_a")
        b = params[f"{target}_lora_b"]
        w = out[f"{target}.weight"]
        delta = (a @ b.to(a.device)) * scale
        out[f"{target}.weight"] = w + delta.T.to(w.device, w.dtype)
    return out


def make_lora_train_step(model: torch.nn.Module, optimizer: AdamW,
                         loss_kind: Loss = Loss.CROSS_ENTROPY, *, causal_lm: bool = True,
                         has_aux: bool = False, labels_aligned: bool = False) -> Callable:
    """The LoRA step: every parameter of ``model`` outside ``optimizer``
    (built over the adapters) is frozen here (``requires_grad`` off, so the
    backward computes no weight gradient for it), and the optimizer clips,
    decays and updates the adapters alone. Loss and label layouts are
    ``make_loss_fn``'s, shared with the full-parameter step; returns what
    ``make_train_step``'s step does."""
    trained = {id(p) for p in optimizer.params}
    for p in model.parameters():
        if id(p) not in trained:
            p.requires_grad_(False)
    return make_train_step(model, optimizer, loss_kind, causal_lm=causal_lm, has_aux=has_aux,
                           labels_aligned=labels_aligned)
