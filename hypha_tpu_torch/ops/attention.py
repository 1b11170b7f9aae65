"""Multi-head attention core, GQA-aware (counterpart of
``hypha_tpu/ops/attention.py``). Shapes are [batch, seq, heads, head_dim]
throughout, as in the JAX package, so tests compare like with like."""

from __future__ import annotations

import torch
from einops import repeat

__all__ = ["dot_product_attention"]


def dot_product_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    causal: bool = True,
    mask: "torch.Tensor | None" = None,  # bool, broadcastable to [B, H, Sq, Sk]
    softmax_scale: "float | None" = None,
    q_offset=0,  # int, or int32 [B] per-row offsets
    window: "int | None" = None,
    k_start: "torch.Tensor | None" = None,  # int32 [B]: keys below are masked
) -> torch.Tensor:
    """Scaled dot-product attention with the JAX reference's numerics:
    logits in the input dtype, then softmax in f32; ``q_offset`` shifts the
    causal diagonal (per row when a [B] vector); ``window`` keeps keys in
    (i - window, i]; ``k_start`` masks keys below a per-row floor. Fully
    masked rows give exact zeros. Calls are counted in
    ``dot_product_attention.calls``."""
    dot_product_attention.calls += 1
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if H != Hkv:
        if H % Hkv:
            raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
        k = repeat(k, "b s h d -> b s (h g) d", g=H // Hkv)
        v = repeat(v, "b s h d -> b s (h g) d", g=H // Hkv)

    scale = softmax_scale if softmax_scale is not None else D**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = logits.float()

    if causal or window is not None or k_start is not None:
        offset = torch.as_tensor(q_offset, dtype=torch.int64, device=q.device)
        qi = offset.reshape(-1, 1, 1) + torch.arange(Sq, device=q.device)[None, :, None]
        ki = torch.arange(Sk, device=q.device)[None, None, :]
        keep = qi >= ki if causal else torch.ones((), dtype=torch.bool, device=q.device)
        if window is not None:
            keep = keep & (ki > qi - window)
        if k_start is not None:
            keep = keep & (ki >= k_start.reshape(-1, 1, 1))
        logits = torch.where(keep[:, None], logits, float("-inf"))
    if mask is not None:
        logits = torch.where(mask, logits, float("-inf"))

    weights = torch.nan_to_num(torch.exp(logits - logits.amax(-1, keepdim=True)))
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-20)
    weights = weights.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


dot_product_attention.calls = 0
