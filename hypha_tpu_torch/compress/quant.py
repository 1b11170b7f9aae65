"""Chunkwise max-abs quantization, int8 and packed int4 (counterpart of
``hypha_tpu/compress/quant.py``, its numpy path, which
``native/hypha_quant.cpp`` repeats in C++).

The tensor is flattened and cut into ``chunk``-element spans; each span
gets one f32 scale ``maxabs / qmax`` and its values round to
``rint(v * (qmax / maxabs))`` clamped to ±qmax, half to even. int4 packs
two two's-complement nibbles per byte (element ``2j`` in the low nibble),
independent of chunking, so the payload is ``ceil(n/2)`` bytes.

Here the arithmetic is torch operations on the tensor's own device (the
card's quantizer is the trainer's and the parameter server's), and each f32
operation is the reference's: ``inv = qmax / maxabs`` once per chunk as an
IEEE division by a device tensor (never a host scalar, which CUDA turns
into a product by the reciprocal), then the bare product ``v * inv``,
``torch.round`` (half to even, as ``np.rint``) and the clamp. So payload
and scales are the reference's bytes, on the CPU and on the card.

A chunk whose max-abs is zero or non-finite (``amax`` propagates NaN as
``np.max`` does) encodes as zeros with scale 0: no non-finite value reaches
the integer cast, and a NaN/Inf delta contributes nothing.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_CHUNK", "QMAX", "quantize", "dequantize", "payload_nbytes"]

# Span per f32 scale: 0.1% scale overhead on an int8 payload.
DEFAULT_CHUNK = 4096

QMAX = {"int8": 127.0, "int4": 7.0}


def _check(codec: str, chunk: int) -> None:
    if codec not in QMAX:
        raise ValueError(f"quantizing codec must be int8|int4, got {codec!r}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if codec == "int4" and chunk % 2:
        raise ValueError(f"int4 chunk must be even, got {chunk}")


def payload_nbytes(n: int, codec: str) -> int:
    """Quantized payload size for ``n`` elements."""
    return n if codec == "int8" else (n + 1) // 2


def _chunk_view(a: torch.Tensor, chunk: int) -> torch.Tensor:
    """Zero-pad a flat tensor to whole chunks, shaped (nchunks, chunk)."""
    n = a.numel()
    nchunks = (n + chunk - 1) // chunk
    if n != nchunks * chunk:
        padded = torch.zeros(nchunks * chunk, dtype=a.dtype, device=a.device)
        padded[:n] = a
        a = padded
    return a.view(nchunks, chunk)


def quantize(src: torch.Tensor, codec: str, chunk: int = DEFAULT_CHUNK) -> tuple:
    """Quantize a tensor (any shape, read as flat f32) -> (uint8 payload,
    f32 per-chunk scales), both on ``src``'s device."""
    _check(codec, chunk)
    a = torch.as_tensor(src).detach().to(torch.float32).contiguous().reshape(-1)
    n, dev = a.numel(), a.device
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev), \
            torch.zeros(0, dtype=torch.float32, device=dev)
    qmax = torch.tensor(QMAX[codec], dtype=torch.float32, device=dev)
    view = _chunk_view(a, chunk)
    maxabs = view.abs().amax(dim=1)  # NaN propagates
    ok = torch.isfinite(maxabs) & (maxabs > 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inv = torch.where(ok, qmax / maxabs, zero)
    scales = torch.where(ok, maxabs / qmax, zero)
    q = torch.round(view * inv[:, None])
    q.clamp_(-QMAX[codec], QMAX[codec])
    # Zero the degraded chunks before the cast: a NaN never reaches it.
    q = torch.where(ok[:, None], q, zero).to(torch.int8).reshape(-1)[:n]
    if codec == "int8":
        return q.view(torch.uint8), scales
    nib = (q & 0xF).to(torch.uint8)
    if n % 2:
        nib = torch.cat([nib, torch.zeros(1, dtype=torch.uint8, device=dev)])
    return nib[0::2] | (nib[1::2] << 4), scales


def dequantize(payload: torch.Tensor, scales: torch.Tensor, n: int, codec: str,
               chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Invert :func:`quantize` -> flat f32 tensor of ``n`` elements on the
    payload's device."""
    _check(codec, chunk)
    q = torch.as_tensor(payload).reshape(-1)
    s = torch.as_tensor(scales).to(q.device, torch.float32).reshape(-1)
    if q.numel() != payload_nbytes(n, codec):
        raise ValueError(f"{codec} payload is {q.numel()} bytes; {n} elements need "
                         f"{payload_nbytes(n, codec)}")
    nchunks = (n + chunk - 1) // chunk
    if n and s.numel() != nchunks:
        raise ValueError(f"{s.numel()} scales for {n} elements at chunk {chunk} "
                         f"(need {nchunks})")
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=q.device)
    if codec == "int8":
        vals = q.view(torch.int8).to(torch.float32)
    else:
        nib = torch.empty(q.numel() * 2, dtype=torch.uint8, device=q.device)
        nib[0::2] = q & 0xF
        nib[1::2] = q >> 4
        # Sign-extend the 4-bit two's complement nibble.
        vals = ((nib.to(torch.int16) ^ 8) - 8).to(torch.float32)[:n]
    # The product of each value with its chunk's scale: full chunks as a
    # (nchunks, chunk) view, the short tail on its own.
    full = n // chunk
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if full:
        torch.mul(vals[: full * chunk].view(full, chunk), s[:full, None],
                  out=out[: full * chunk].view(full, chunk))
    if full * chunk < n:
        torch.mul(vals[full * chunk:], s[full], out=out[full * chunk:])
    return out
