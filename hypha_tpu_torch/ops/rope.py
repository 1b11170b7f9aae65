"""Rotary position embeddings (counterpart of ``hypha_tpu/ops/rope.py``):
split-half rotation (not interleaved), computed in f32."""

from __future__ import annotations

import torch

__all__ = ["rope_frequencies", "apply_rope"]


def rope_frequencies(
    head_dim: int,
    max_len: int,
    theta: float = 10_000.0,
    device: "torch.device | str | None" = None,
) -> tuple:
    """(cos, sin) tables of shape [max_len, head_dim // 2], f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv = 1.0 / (theta**exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(
    x: torch.Tensor,  # [B, S, H, D]
    cos: torch.Tensor,  # [max_len, D // 2]
    sin: torch.Tensor,
    positions: "torch.Tensor | None" = None,  # [B, S] absolute positions
) -> torch.Tensor:
    S = x.shape[1]
    if positions is None:
        c = cos[:S][None, :, None, :]
        s = sin[:S][None, :, None, :]
    else:
        # Out-of-range positions clamp, as JAX gathers do: idle pool lanes
        # park past the window, and their rows are never read.
        positions = torch.clamp(positions, max=cos.shape[0] - 1)
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
