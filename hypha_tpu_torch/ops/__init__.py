"""Compute ops of the port (counterpart of ``hypha_tpu/ops``): attention,
RoPE, RMSNorm, the KV cache, ragged paged attention with its Hopper
kernel, and flash attention with its forward, dQ and dK/dV kernels."""

from .attention import dot_product_attention
from .flash_attention import flash_attention
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
    "flash_attention",
    "KVCache",
    "PagedKV",
    "paged_attention",
    "ragged_block_attention",
    "ragged_paged_attention",
    "rms_norm",
    "apply_rope",
    "rope_frequencies",
]
