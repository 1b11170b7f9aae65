"""Flash attention with its backward (counterpart of
``hypha_tpu/ops/flash_attention.py``).

The function, in the ``[B, S, H, D]`` layout with GQA (query head ``h``
reads kv head ``h // (H // Hkv)``), the causal mask ``key <= query`` and
an optional sliding window (Mistral: query ``i`` sees keys in
``(i - window, i]``):

    S = Q Kᵀ · scale        O = softmax(S) V        L = logsumexp_k(S)
    P = exp(S − L)          Δ = rowsum(dO ∘ O)
    dV = Pᵀ dO              dS = P ∘ (dO Vᵀ − Δ)
    dQ = dS K · scale       dK = dSᵀ Q · scale

A fully masked row gives O = 0 and L = −inf, and P = 0 in the backward.

Two implementations:

* :func:`flash_forward_reference`, :func:`flash_dq_reference` and
  :func:`flash_dkv_reference` (with :func:`flash_backward_reference`, the
  two together) — the plain PyTorch versions, the formulas above with the
  score matrix written out (S×S memory). They repeat the kernels' bf16
  roundings: P is rounded to the value dtype before P V and Pᵀ dO, dS to
  the input dtype before dS K and dSᵀ Q. The CPU tests run them, and
  ``chip_smoke.py`` holds the kernels against them.
* :func:`flash_forward_cuda`, :func:`flash_dq_cuda` and
  :func:`flash_dkv_cuda` — the hand-written Hopper kernels
  (``csrc/flash_attention.cu``) that replace the Pallas ``_fwd_kernel``,
  ``_dq_kernel`` and ``_dkv_kernel`` (hypha_tpu/ops/flash_attention.py:115,
  :177, :222). They read q/k/v in place through their strides, mask the
  ragged edge and the window themselves (any S), and save nothing of size
  S×S. The route follows the dtype: bf16 forward, dQ and dK/dV run on the
  tensor cores (``flash_fwd_mma_kernel``, ``flash_dq_mma_kernel``,
  ``flash_dkv_mma_kernel``: ``mma.sync``, ``cp.async``-fed tiles); f32
  runs on CUDA cores (``flash_fwd_kernel``, ``flash_dq_kernel``,
  ``flash_dkv_kernel``), whose f32 sums meet the card tests' 1e-4.

:func:`flash_attention` is differentiable through a
``torch.autograd.Function`` (the JAX package's ``custom_vjp``): its forward
saves q, k, v, o and L, its backward launches the dQ and dK/dV kernels. On
CUDA tensors it launches the kernels or raises; the plain versions run
only for tensors on the CPU. Launches are counted in
``flash_attention.fwd_launches``, ``.dq_launches`` and ``.dkv_launches``,
plain calls in ``flash_attention.plain_calls``.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "flash_attention",
    "flash_forward_reference",
    "flash_backward_reference",
    "flash_dq_reference",
    "flash_dkv_reference",
    "flash_forward_cuda",
    "flash_dq_cuda",
    "flash_dkv_cuda",
]

_NEG_INF = float("-inf")


def _scale(q: torch.Tensor, softmax_scale) -> float:
    return float(softmax_scale) if softmax_scale is not None else q.shape[-1] ** -0.5


def _expand_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, H, D] in f32, kv head h // reps per query head."""
    x = x.float()
    reps = heads // x.shape[2]
    return x if reps == 1 else x.repeat_interleave(reps, dim=2)


def _scores(q, k, causal: bool, scale: float, window) -> torch.Tensor:
    """Masked f32 logits [B, H, Sq, Sk]."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k, q.shape[2])) * scale
    if causal or window is not None:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        keep = qi >= ki if causal else torch.ones((), dtype=torch.bool, device=q.device)
        if window is not None:
            keep = keep & (ki > qi - window)
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_forward_reference(q, k, v, causal: bool = True, scale: "float | None" = None,
                            window: "int | None" = None):
    """Plain forward: ``(o [B, Sq, H, D] in q's dtype, L f32 [B, H, Sq])``."""
    scale = _scale(q, scale)
    s = _scores(q, k, causal, scale, window)
    m = s.amax(-1, keepdim=True)
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - safe)  # masked logits give exp(-inf) = 0
    l = p.sum(-1, keepdim=True)
    den = torch.clamp(l, min=1e-20)
    pv = p.to(v.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", pv, _expand_kv(v, q.shape[2])) / den.permute(0, 2, 1, 3)
    lse = torch.where(torch.isfinite(m), m + torch.log(den), torch.full_like(m, _NEG_INF))
    return o.to(q.dtype), lse[..., 0]


def _backward_parts(q, k, v, o, lse, do, causal, scale, window):
    """P and dS [B, H, Sq, Sk] in f32, recomputed from L as the kernels do."""
    H = q.shape[2]
    s = _scores(q, k, causal, scale, window)
    L = lse[..., None]
    p = torch.where(torch.isfinite(L), torch.exp(s - L), torch.zeros_like(s))
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]  # [B, H, Sq, 1]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, _expand_kv(v, H))
    return p, p * (dp - delta)


def flash_dq_reference(q, k, v, o, lse, do, causal: bool = True,
                       scale: "float | None" = None, window: "int | None" = None) -> torch.Tensor:
    """Plain dQ = dS K · scale, in q's dtype (dS rounded to q's dtype)."""
    scale = _scale(q, scale)
    _, ds = _backward_parts(q, k, v, o, lse, do, causal, scale, window)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), _expand_kv(k, q.shape[2]))
    return (dq * scale).to(q.dtype)


def flash_dkv_reference(q, k, v, o, lse, do, causal: bool = True,
                        scale: "float | None" = None, window: "int | None" = None) -> tuple:
    """Plain dK = dSᵀ Q · scale and dV = Pᵀ dO, summed over each kv head's
    GQA group, in the dtypes of k and v."""
    scale = _scale(q, scale)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    p, ds = _backward_parts(q, k, v, o, lse, do, causal, scale, window)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    if H != Hkv:  # the GQA sum over each kv head's group
        dk = dk.reshape(B, Sk, Hkv, H // Hkv, D).sum(3)
        dv = dv.reshape(B, Sk, Hkv, H // Hkv, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_reference(q, k, v, o, lse, do, causal: bool = True,
                             scale: "float | None" = None, window: "int | None" = None):
    """Plain backward: ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    dq = flash_dq_reference(q, k, v, o, lse, do, causal, scale, window)
    return (dq, *flash_dkv_reference(q, k, v, o, lse, do, causal, scale, window))


# ----------------------------------------------------------- Hopper kernels

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _check_inputs(q, k, v, *rest) -> None:
    from ..hw import require_sm90

    _check(q.is_cuda, "q must be a CUDA tensor")
    require_sm90(q.device)
    _check(q.dim() == 4 and k.dim() == 4, "q, k, v must be [B, S, heads, D]")
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dk = k.shape
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (bfloat16 | float32)")
    _check(D in (64, 128) and Dk == D, f"head_dim {D} / {Dk} (64 | 128)")
    _check(k.shape[0] == B and tuple(v.shape) == tuple(k.shape), "k/v shapes differ")
    _check(Hkv > 0 and H % Hkv == 0, f"{H} query heads not a multiple of {Hkv} kv heads")
    vec = 16 // q.element_size()
    for t in (q, k, v, *rest):
        _check(t.device == q.device, "all tensors must be on q's device")
        _check(t.dtype == q.dtype, "q, k, v (and o, dO) must share one dtype")
        _check(t.stride(-1) == 1, "the head_dim axis must be contiguous")
        _check(all(s % vec == 0 for s in t.stride()[:3]), "strides must be 16-byte multiples")
        _check(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")


def _strides(*tensors) -> ctypes.Array:
    vals = []
    for t in tensors:
        vals += list(t.stride()[:3])
    vals += [0] * (15 - len(vals))
    return (ctypes.c_longlong * 15)(*vals)


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error(err).decode()
        raise RuntimeError(f"flash attention {what} launch failed: {msg} ({err})")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _window(window) -> int:
    """The kernels' window argument: 0 for none."""
    if window is None:
        return 0
    _check(1 <= int(window) < 2**31, f"window {window} (1 .. 2**31 - 1, or None)")
    return int(window)


def flash_forward_cuda(q, k, v, causal: bool = True, scale: "float | None" = None,
                       window: "int | None" = None):
    """Launch the forward kernel: ``(o, L)`` as :func:`flash_forward_reference`
    (bf16: ``flash_fwd_mma_kernel`` on the tensor cores; f32:
    ``flash_fwd_kernel`` on CUDA cores). Adds one to
    ``flash_attention.fwd_launches``."""
    from ._build import load_library

    _check_inputs(q, k, v)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or Sk == 0:
        o.zero_()
        lse.fill_(_NEG_INF)
        return o, lse
    lib = load_library("flash_attention.cu")
    ptr = ctypes.c_void_p
    err = lib.flash_attention_forward(
        ptr(q.data_ptr()), ptr(k.data_ptr()), ptr(v.data_ptr()), ptr(o.data_ptr()),
        ptr(lse.data_ptr()), B, H, Hkv, Sq, Sk, D, _strides(q, k, v), _scale(q, scale),
        int(causal), _window(window), _DTYPES[q.dtype], _stream(q),
    )
    _raise(lib, err, "forward")
    flash_attention.fwd_launches += 1
    return o, lse


def _backward_args(q, k, v, o, lse, do):
    _check_inputs(q, k, v, o, do)
    B, Sq, H, _ = q.shape
    _check(tuple(o.shape) == tuple(q.shape) and tuple(do.shape) == tuple(q.shape),
           "o and dO must have q's shape")
    _check(lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, Sq) and lse.is_contiguous()
           and lse.device == q.device, "L must be contiguous f32 [B, H, Sq]")
    ptr = ctypes.c_void_p
    return tuple(ptr(t.data_ptr()) for t in (q, k, v, o, do, lse))


def _dims(q, k):
    B, Sq, H, D = q.shape
    return B, H, k.shape[2], Sq, k.shape[1], D


def flash_dq_cuda(q, k, v, o, lse, do, causal: bool = True,
                  scale: "float | None" = None, window: "int | None" = None) -> torch.Tensor:
    """Launch the dQ kernel (as :func:`flash_dq_reference`; bf16:
    ``flash_dq_mma_kernel`` on the tensor cores, f32: ``flash_dq_kernel`` on
    CUDA cores). Adds one to ``flash_attention.dq_launches``."""
    from ._build import load_library

    args = _backward_args(q, k, v, o, lse, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_()
    lib = load_library("flash_attention.cu")
    err = lib.flash_attention_backward_dq(
        *args, ctypes.c_void_p(dq.data_ptr()), *_dims(q, k), _strides(q, k, v, o, do),
        _scale(q, scale), int(causal), _window(window), _DTYPES[q.dtype], _stream(q),
    )
    _raise(lib, err, "dQ")
    flash_attention.dq_launches += 1
    return dq


def flash_dkv_cuda(q, k, v, o, lse, do, causal: bool = True,
                   scale: "float | None" = None, window: "int | None" = None) -> tuple:
    """Launch the dK/dV kernel (as :func:`flash_dkv_reference`; bf16:
    ``flash_dkv_mma_kernel`` on the tensor cores, f32: ``flash_dkv_kernel``
    on CUDA cores). Adds one to ``flash_attention.dkv_launches``."""
    from ._build import load_library

    args = _backward_args(q, k, v, o, lse, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    if dk.numel() == 0 or q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    lib = load_library("flash_attention.cu")
    err = lib.flash_attention_backward_dkv(
        *args, ctypes.c_void_p(dk.data_ptr()), ctypes.c_void_p(dv.data_ptr()), *_dims(q, k),
        _strides(q, k, v, o, do), _scale(q, scale), int(causal), _window(window),
        _DTYPES[q.dtype], _stream(q),
    )
    _raise(lib, err, "dK/dV")
    flash_attention.dkv_launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernels on CUDA tensors, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        if q.is_cuda:
            o, lse = flash_forward_cuda(q, k, v, causal, scale, window)
        else:
            flash_attention.plain_calls += 1
            o, lse = flash_forward_reference(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        saved = (*ctx.saved_tensors, do.contiguous(), *ctx.args)
        if do.is_cuda:
            dq = flash_dq_cuda(*saved)
            dk, dv = flash_dkv_cuda(*saved)
        else:
            flash_attention.plain_calls += 1
            dq, dk, dv = flash_backward_reference(*saved)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: "float | None" = None,
    window: "int | None" = None,
) -> torch.Tensor:
    """Differentiable flash attention with the JAX package's ``[B, S, H, D]``
    convention and GQA; ``softmax_scale`` defaults to ``D ** -0.5``;
    ``window`` keeps keys in (i - window, i] for query i."""
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    return _FlashAttention.apply(q, k, v, bool(causal), _scale(q, softmax_scale), window)


flash_attention.fwd_launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
flash_attention.plain_calls = 0
