"""Ragged attention over the paged KV pool (counterpart of
``hypha_tpu/ops/paged_attention.py``).

Two implementations of one function, and a dispatcher that picks by where
the tensors live:

* :func:`ragged_block_attention` — the plain PyTorch version, with the
  reference's two branches: at full occupancy the dense gather through the
  block table plus ``dot_product_attention`` (bit-compatible with the
  dense paged path), otherwise an f32 masked-block streaming softmax over
  chunks of table entries, bounded by the largest lane occupancy. The CPU
  tests run it, and ``chip_smoke.py`` holds the kernel against it.
* :func:`ragged_paged_attention` — the hand-written Hopper kernel
  (``csrc/ragged_paged_attention.cu``), which replaces the Pallas
  ``_ragged_kernel`` (hypha_tpu/ops/paged_attention.py:213-277). It reads
  the pool in place in its ``[(blocks+1)*bs, Hkv, D]`` layout and walks
  each lane's table, skipping sentinel entries, entries past the lane's
  occupancy and blocks past its causal frontier. It has two routes, picked
  by :func:`_ragged_route`: bf16 prefill chunks on the tensor cores
  (``mma.sync``), decode and every f32 call on CUDA cores.

:func:`paged_attention` launches the kernel exactly when ``q`` is a CUDA
tensor. There is no fallback: a card that is not sm_90, or a kernel that
fails to build or launch, raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from einops import repeat

from .attention import dot_product_attention
from .kvcache import _physical

__all__ = [
    "PagedKV",
    "paged_attention",
    "ragged_block_attention",
    "ragged_paged_attention",
]

_NEG_INF = float("-inf")


class PagedKV(NamedTuple):
    """The raw paged-cache view handed to :func:`paged_attention`."""

    k: torch.Tensor  # [(blocks+1)*block_size, Hkv, D] payload
    v: torch.Tensor
    k_scale: "torch.Tensor | None"  # [(blocks+1)*block_size, Hkv] f32, int8 mode
    v_scale: "torch.Tensor | None"
    table: torch.Tensor  # [B, max_blocks] int32; ``blocks`` = sentinel


def _dequant(payload, scale, out_dtype):
    """Per-row max-abs dequant; a zero scale decodes to exact zeros."""
    if scale is None:
        return payload.to(out_dtype)
    return (payload.float() * scale[..., None]).to(out_dtype)


def _dense_branch(q, kv: PagedKV, *, blocks, block_size, q_offset, k_start, window):
    B, max_blocks = kv.table.shape
    decode_len = max_blocks * block_size
    win = torch.arange(decode_len, device=q.device)[None, :].expand(B, decode_len)
    phys = _physical(kv.table, win, block_size, max_blocks, blocks)
    full_k = _dequant(kv.k[phys], None if kv.k_scale is None else kv.k_scale[phys], q.dtype)
    full_v = _dequant(kv.v[phys], None if kv.v_scale is None else kv.v_scale[phys], q.dtype)
    return dot_product_attention(
        q, full_k, full_v, causal=True, q_offset=q_offset, window=window, k_start=k_start,
    )


def _streaming_branch(q, kv: PagedKV, count, *, blocks, block_size, q_offset,
                      k_start, window, blocks_per_iter):
    B, Sq, Hq, D = q.shape
    max_blocks = kv.table.shape[1]
    C = blocks_per_iter
    span = C * block_size
    # Sentinel padding to a C multiple, so no chunk re-reads a block.
    pad = (-max_blocks) % C
    table = kv.table
    if pad:
        table = torch.nn.functional.pad(table, (0, pad), value=blocks)
    n_iter = -(-int(count.max()) // C)
    dev = q.device
    scale = D**-0.5
    qf = q.float()
    m = torch.full((B, Hq, Sq), _NEG_INF, device=dev)
    l = torch.zeros((B, Hq, Sq), device=dev)
    acc = torch.zeros((B, Hq, Sq, D), device=dev)
    qi = q_offset.long()[:, None] + torch.arange(Sq, device=dev)[None, :]  # [B, Sq]
    for j in range(n_iter):
        b0 = j * C
        blk = table[:, b0 : b0 + C]  # [B, C]
        rows = (
            torch.clamp(blk, 0, blocks).long()[:, :, None] * block_size
            + torch.arange(block_size, device=dev)[None, None, :]
        ).reshape(B, span)
        k_blk = _dequant(kv.k[rows], None if kv.k_scale is None else kv.k_scale[rows], torch.float32)
        v_blk = _dequant(kv.v[rows], None if kv.v_scale is None else kv.v_scale[rows], torch.float32)
        if Hq != k_blk.shape[2]:
            g = Hq // k_blk.shape[2]
            k_blk = repeat(k_blk, "b s h d -> b s (h g) d", g=g)
            v_blk = repeat(v_blk, "b s h d -> b s (h g) d", g=g)
        ki = b0 * block_size + torch.arange(span, device=dev)  # [span]
        keep = qi[:, :, None] >= ki[None, None, :]
        if window is not None:
            keep = keep & (ki[None, None, :] > qi[:, :, None] - window)
        if k_start is not None:
            keep = keep & (ki[None, None, :] >= k_start.long()[:, None, None])
        # Sentinel entries never contribute, whatever their payload holds.
        keep = keep & torch.repeat_interleave(blk != blocks, block_size, dim=1)[:, None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk) * scale
        s = torch.where(keep[:, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.exp(torch.where(torch.isneginf(m), 0.0, m - m_new))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
        m = m_new
    # Fully masked rows (idle lanes, l == 0) give exact zeros.
    o = acc / torch.clamp(l, min=1e-20)[..., None]
    return o.transpose(1, 2).to(q.dtype)


def ragged_block_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D], RoPE'd
    kv: PagedKV,
    *,
    blocks: int,
    block_size: int,
    q_offset: torch.Tensor,  # int32 [B]
    k_start: "torch.Tensor | None" = None,  # int32 [B]
    window: "int | None" = None,
    blocks_per_iter: int = 0,
) -> torch.Tensor:
    """Plain PyTorch ragged paged attention, the kernel's reference: dense
    gather at full occupancy, masked-block streaming softmax otherwise."""
    max_blocks = kv.table.shape[1]
    count = (kv.table != blocks).sum(dim=1)
    if blocks_per_iter <= 0:
        blocks_per_iter = max(1, min(max_blocks, 256 // max(block_size, 1)))
    kw = dict(blocks=blocks, block_size=block_size, q_offset=q_offset,
              k_start=k_start, window=window)
    if bool((count == max_blocks).all()):
        return _dense_branch(q, kv, **kw)
    return _streaming_branch(q, kv, count, blocks_per_iter=blocks_per_iter, **kw)


# ------------------------------------------------------------ Hopper kernel

_Q_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_ROUTES = {"simt": 0, "mma": 1}
# Query rows from which bf16 calls take the tensor-core route. Measured on
# an H100 80GB HBM3 at 700 W, 8 lanes x 512 cached positions, 32 heads of
# 128, both routes on the same inputs (chip_smoke.py, phase kernels):
# Sq 64, mma 0.062 ms against simt 1.288; Sq 16, 0.069 against 0.441. At
# Sq 1 (decode) mma was faster too (0.038 against 0.078 ms; int8 pools
# 0.070 against 0.082; GQA 32/8 0.066 against 0.068), but decode stays on
# the simt kernel for now: its f32 softmax matches the plain version to
# 1e-4 where bf16 P gives 2e-3, and the decode step is host-bound (the
# kernel is ~2 ms of a ~46 ms step), so moving it is its own change.
MMA_MIN_ROWS = 16


def _ragged_route(sq: int, q_dtype: torch.dtype) -> str:
    """The kernel for a call: ``"mma"`` (bf16 tensor cores) for bf16 q with
    a prefill chunk of at least :data:`MMA_MIN_ROWS` query rows, ``"simt"``
    (f32 on CUDA cores) for decode and for every f32 call, whose card
    tolerance (1e-4) bf16 products cannot meet. Both are hand-written
    kernels held against the plain version on the card: a choice by
    shape, not a fallback."""
    return "mma" if q_dtype == torch.bfloat16 and sq >= MMA_MIN_ROWS else "simt"


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ragged_paged_attention: {msg}")


def _require_card(q: torch.Tensor) -> None:
    from ..hw import require_sm90

    _check(q.is_cuda, "q must be a CUDA tensor")
    require_sm90(q.device)


def _stream(q: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)


def ragged_paged_attention(
    q: torch.Tensor,
    kv: PagedKV,
    *,
    blocks: int,
    block_size: int,
    q_offset: torch.Tensor,
    k_start: "torch.Tensor | None" = None,
    window: "int | None" = None,
) -> torch.Tensor:
    """Launch the sm_90a kernel on CUDA tensors (same contract as
    :func:`ragged_block_attention`), on the route :func:`_ragged_route`
    picks. Adds one to ``ragged_paged_attention.launches`` and to the
    route's count (``.mma_launches`` or ``.simt_launches``) per launch."""
    return _launch(q, kv, _ragged_route(q.shape[1], q.dtype), blocks=blocks,
                   block_size=block_size, q_offset=q_offset, k_start=k_start, window=window)


def _launch(q, kv: PagedKV, route: str, *, blocks, block_size, q_offset, k_start=None,
            window=None):
    """Launch one route of the kernel (``chip_smoke.py`` times both routes
    on the same inputs through this)."""
    from ._build import load_library

    _require_card(q)
    B, Sq, Hq, D = q.shape
    rows, Hkv, Dk = kv.k.shape
    _check(q.dtype in _Q_DTYPES, f"q dtype {q.dtype} (bfloat16 | float32)")
    _check(route in _ROUTES, f"route {route!r} (simt | mma)")
    _check(route == "simt" or q.dtype == torch.bfloat16, "the mma route takes bfloat16 q only")
    _check(D in (64, 128) and Dk == D, f"head_dim {D} / pool {Dk} (64 | 128)")
    _check(Hq % Hkv == 0, f"{Hq} query heads not a multiple of {Hkv} kv heads")
    _check(rows == (blocks + 1) * block_size, f"pool rows {rows} != (blocks+1)*block_size")
    _check(tuple(kv.v.shape) == tuple(kv.k.shape), "k/v pool shapes differ")
    quant = kv.k_scale is not None
    if quant:
        _check(kv.k.dtype == torch.int8 and kv.v.dtype == torch.int8, "int8 pools expected")
        for s in (kv.k_scale, kv.v_scale):
            _check(s is not None and s.dtype == torch.float32 and tuple(s.shape) == (rows, Hkv),
                   "scales must be f32 [rows, Hkv]")
    else:
        _check(kv.k.dtype == q.dtype and kv.v.dtype == q.dtype, "pool dtype must equal q dtype")
    _check(kv.table.dtype == torch.int32 and kv.table.dim() == 2 and kv.table.shape[0] == B,
           "table must be int32 [B, max_blocks]")
    if k_start is None:
        k_start = torch.zeros((B,), dtype=torch.int32, device=q.device)
    for name, t in (("q_offset", q_offset), ("k_start", k_start)):
        _check(t.dtype == torch.int32 and tuple(t.shape) == (B,), f"{name} must be int32 [B]")
    tensors = [q, kv.k, kv.v, kv.table, q_offset, k_start]
    if quant:
        tensors += [kv.k_scale, kv.v_scale]
    for t in tensors:
        _check(t.device == q.device, "all tensors must be on q's device")
        _check(t.is_contiguous(), "all tensors must be contiguous")
        _check(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = load_library()
    ptr = ctypes.c_void_p
    err = lib.ragged_paged_attention(
        ptr(q.data_ptr()), ptr(kv.k.data_ptr()), ptr(kv.v.data_ptr()),
        ptr(kv.k_scale.data_ptr() if quant else 0),
        ptr(kv.v_scale.data_ptr() if quant else 0),
        ptr(kv.table.data_ptr()), ptr(q_offset.data_ptr()), ptr(k_start.data_ptr()),
        ptr(out.data_ptr()),
        B, Sq, Hq, Hkv, D, blocks, block_size, kv.table.shape[1],
        0 if window is None else int(window), int(window is not None),
        _Q_DTYPES[q.dtype], int(quant), _ROUTES[route], _stream(q),
    )
    if err != 0:
        msg = lib.ragged_paged_attention_error(err).decode()
        raise RuntimeError(f"ragged_paged_attention launch failed ({route}): {msg} ({err})")
    ragged_paged_attention.launches += 1
    if route == "mma":
        ragged_paged_attention.mma_launches += 1
    else:
        ragged_paged_attention.simt_launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.mma_launches = 0
ragged_paged_attention.simt_launches = 0


def paged_attention(
    q: torch.Tensor,
    kv: PagedKV,
    *,
    blocks: int,
    block_size: int,
    q_offset: torch.Tensor,
    k_start: "torch.Tensor | None" = None,
    window: "int | None" = None,
    use_kernel: "bool | None" = None,
) -> torch.Tensor:
    """Ragged paged attention dispatcher: the Hopper kernel when ``q`` is a
    CUDA tensor, the plain version on the CPU. ``use_kernel=True`` on CPU
    tensors raises instead of running the plain version. Plain-path calls
    are counted in ``paged_attention.plain_calls``."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        if not q.is_cuda:
            raise RuntimeError("the ragged paged-attention kernel needs CUDA tensors")
        return ragged_paged_attention(
            q, kv, blocks=blocks, block_size=block_size, q_offset=q_offset,
            k_start=k_start, window=window,
        )
    paged_attention.plain_calls += 1
    return ragged_block_attention(
        q, kv, blocks=blocks, block_size=block_size, q_offset=q_offset,
        k_start=k_start, window=window,
    )


paged_attention.plain_calls = 0
