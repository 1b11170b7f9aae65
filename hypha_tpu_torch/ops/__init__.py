"""Compute ops of the port (counterpart of ``hypha_tpu/ops``): attention,
RoPE, RMSNorm, the KV cache, and ragged paged attention with its Hopper
kernel."""

from .attention import dot_product_attention
from .kvcache import KVCache
from .paged_attention import (
    PagedKV,
    paged_attention,
    ragged_block_attention,
    ragged_paged_attention,
)
from .rmsnorm import rms_norm
from .rope import apply_rope, rope_frequencies

__all__ = [
    "dot_product_attention",
    "KVCache",
    "PagedKV",
    "paged_attention",
    "ragged_block_attention",
    "ragged_paged_attention",
    "rms_norm",
    "apply_rope",
    "rope_frequencies",
]
