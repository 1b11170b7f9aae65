"""Seeded weights bit-equal to the JAX package's ``model.init``.

The JAX package draws θ₀ with ``model.init(jax.random.key(seed), inputs)``
(``hypha_tpu/executor/training.py:672``,
``hypha_tpu/worker/infer_executor.py:674``, ``:699``). This module computes
the same bits with torch ops, so that a JAX and a torch worker seeded alike
start from one θ₀:

* **threefry2x32** (20 rounds, rotations 13/15/26/6 and 17/29/16/24, key
  parity ``0x1BD11BDA``) in int64 with 32-bit masks, as ``jax._src.prng``
  computes it; ``key(seed)``, ``fold_in`` and ``split`` on top of it.
* **random bits** under ``jax_threefry_partitionable`` (JAX 0.9's default):
  element ``i`` of a leaf hashes its flat index as two u32 words, so any
  index range of a leaf can be drawn alone.
* **uniform**, **normal** and **truncated normal** as ``jax.random`` builds
  them (``_uniform``, ``_normal_real``, ``_truncated_normal``), with
  ``erf_inv`` as XLA's CPU backend lowers it: Giles' polynomial over
  ``-log1p(-x²)``, where ``log1p`` is XLA's own expansion (a Cephes
  rational function near 0, otherwise ``log(1 + x)`` through an exponent
  split and a polynomial). Each step is one f32 torch op, so it rounds
  once, as each LLVM instruction does; none contracts into a fused
  multiply-add. The two bounds of a truncated normal go through XLA's
  ``erf``, which does use fused multiply-adds: they are host scalars and
  are computed exactly (:func:`_fma32`).
* **flax's parameter keys**: a scope's ``make_rng`` counts per scope, and
  the key of a parameter is the root key folded with the SHA-1 of its
  scope path and counter (``flax/core/scope.py`` ``_fold_in_static``,
  without the separator byte unless ``flax_fix_rng_separator`` is set).

On a CUDA tensor, :func:`draw` launches one elementwise kernel
(``ops/csrc/seed_init.cu``) that runs the same sequence of correctly
rounded f32 operations; 20 rounds of int64 torch ops over the 6.7 G
elements of a 7B model would take hours. It ports no TPU kernel: the
reference draws with XLA. On the CPU the torch ops above run.
"""

from __future__ import annotations

import ctypes
import hashlib
from fractions import Fraction

import numpy as np
import torch

__all__ = [
    "key", "fold_in", "split", "fold_in_static", "param_key", "random_bits",
    "uniform", "erf_inv", "draw", "draw_plain", "lecun_scale", "seed_launches",
]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = np.float32

# Launches of the CUDA draw kernel (``chip_smoke.py`` reads and resets it).
seed_launches = {"draw": 0}


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under key ``(k1, k2)``:
    Python ints or int64 tensors holding u32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> tuple:
    """``jax.random.key(seed)``'s key words: the seed's high and low u32."""
    seed = int(seed)
    return ((seed >> 32) & MASK, seed & MASK)


def fold_in(k: tuple, data: int) -> tuple:
    """``jax.random.fold_in``: threefry of the counter ``(0, data)``."""
    return threefry2x32(k[0], k[1], 0, int(data) & MASK)


def split(k: tuple, num: int = 2) -> list:
    """``jax.random.split`` under partitionable counters: key ``i`` is
    threefry of ``(0, i)``."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def fold_in_static(k: tuple, data, *, separator: bool = False) -> tuple:
    """flax's ``_fold_in_static``: fold the first four bytes of the SHA-1 of
    the names and counters in ``data`` into ``k``."""
    if not data:
        return k
    m = hashlib.sha1()
    for x in data:
        if separator:
            m.update(b"\x00")
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return fold_in(k, int.from_bytes(m.digest()[:4], byteorder="big"))


def param_key(root: tuple, scope: tuple, counter: int) -> tuple:
    """The key flax hands the ``counter``-th parameter (from 1) declared in
    the module at ``scope`` (the names from the root down), under flax
    0.12.3's default ``flax_fix_rng_separator = False``."""
    return fold_in_static(root, (*scope, counter))


def random_bits(k: tuple, start: int, stop: int, device="cpu") -> torch.Tensor:
    """32 random bits of the flat elements ``start..stop-1`` of a leaf, as
    u32 values in int64."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k[0], k[1], idx >> 32, idx & MASK)
    return b0 ^ b1


def _t(x, device) -> torch.Tensor:
    return torch.tensor(_F32(x), dtype=torch.float32, device=device)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a·b + c`` rounded once, as a fused multiply-add: the product is
    exact in f64, the sum is taken exactly (TwoSum) and rounded to odd in
    f64, whose rounding to f32 is then the correctly rounded result."""
    p = a.double() * (b.double() if torch.is_tensor(b) else float(b))
    c = c.double() if torch.is_tensor(c) else torch.tensor(float(c), dtype=torch.float64,
                                                            device=p.device)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    outward = (err > 0) == (s > 0)
    bits = torch.where(inexact_even, torch.where(outward, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).to(torch.float32)


def uniform(bits: torch.Tensor, minval, maxval) -> torch.Tensor:
    """``jax.random.uniform`` in f32 from its bits: the mantissa trick, then
    ``f·(max - min) + min`` (one fused multiply-add on XLA's CPU backend)."""
    dev = bits.device
    lo, span = _F32(minval), _F32(_F32(maxval) - _F32(minval))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - _t(1.0, dev)
    return torch.maximum(_t(lo, dev), _fma(f, _F32(span), _F32(lo)))


# XLA's CPU log(y), as it lowers it: y = m·2^e with m in [0.5, 1), a
# polynomial in the reduced m, and e·ln2 split into two constants. LLVM
# contracts each multiply feeding an add into a fused multiply-add; the
# ones left apart are exact or have a second use.
def _bits(*words):
    return tuple(np.uint32(w).view(np.float32) for w in words)


(_LOG_SQRTHF,) = _bits(0x3F3504F3)
_LOG_P = _bits(0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
               0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
_LOG_Q1, _LOG_Q2 = _bits(0xB95E8083, 0x3F318000)
# XLA's log1p near 0 (|x| < sqrt(2) - 1): a Cephes rational function.
_LOG1P_NUM = _bits(0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
                   0x426473AD, 0x41A05101)
_LOG1P_DEN = _bits(0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
                   0x42707982)
(_LOG1P_SMALL,) = _bits(0x3ED413CD)


def _xla_log(y: torch.Tensor) -> torch.Tensor:
    """For 0 < y <= 1, the only inputs a draw gives it (XLA's special
    cases for 0, infinities and NaN are left out)."""
    dev = y.device
    one = _t(1.0, dev)
    ym = torch.where(y > _t(2.0**-126, dev), y, _t(2.0**-126, dev))
    bits = ym.view(torch.int32)
    e = ((bits >> 23) & 0x1FF) - 127  # y > 0 here: the sign bit is clear
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    ef = e.to(torch.float32) + one
    small = m < _t(_LOG_SQRTHF, dev)
    x = (m - one) + torch.where(small, m, _t(0.0, dev))
    ef = ef - torch.where(small, one, _t(0.0, dev))
    z = x * x
    x3 = z * x
    p = [_F32(c) for c in _LOG_P]
    a = _fma(_fma(x, p[0], p[1]), x, p[2])
    b = _fma(_fma(x, p[3], p[4]), x, p[5])
    c = _fma(_fma(x, p[6], p[7]), x, p[8])
    a = _fma(_fma(a, x3, b), x3, c)
    a = _fma(a, x3, ef * _t(_LOG_Q1, dev))
    out = (x - z * _t(0.5, dev)) + a
    return out + ef * _t(_LOG_Q2, dev)  # exact: a small integer times 355/512


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    dev = x.device
    one = _t(1.0, dev)
    large = _xla_log(x + one)
    d = x * _t(0.0, dev) + one
    for c in _LOG1P_DEN:
        d = _fma(d, x, _F32(c))
    n = x * _t(0.0, dev) + _t(_LOG1P_NUM[0], dev)
    for c in _LOG1P_NUM[1:]:
        n = _fma(n, x, _F32(c))
    x2 = x * x
    small = x + (x2 * _t(-0.5, dev) + (x * x2) * (n / d))  # x2·-0.5 is exact
    return torch.where(torch.abs(x) < _t(_LOG1P_SMALL, dev), small, large)


# Giles' single-precision erf_inv, the coefficients for w < 5 and w >= 5.
_ERFINV_LO = tuple(_F32(c) for c in (
    "2.81022636e-08", "3.43273939e-07", "-3.5233877e-06", "-4.39150654e-06",
    "0.00021858087", "-0.00125372503", "-0.00417768164", "0.246640727", "1.50140941"))
_ERFINV_HI = tuple(_F32(c) for c in (
    "-0.000200214257", "0.000100950558", "0.00134934322", "-0.00367342844",
    "0.00573950773", "-0.0076224613", "0.00943887047", "1.00167406", "2.83297682"))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` on the CPU, op for op, for |x| < 1 (a draw's
    uniform never reaches 1; XLA's x·inf there is left out)."""
    dev = x.device
    w = -_xla_log1p(x * -x)
    lo = w < _t(5.0, dev)
    # torch.sqrt of f32 is not correctly rounded on every CPU; in f64 it is,
    # and rounding that to f32 is the correctly rounded f32 root.
    root = torch.sqrt(w.double()).float()
    w = torch.where(lo, w + _t(-2.5, dev), root + _t(-3.0, dev))
    p = torch.where(lo, _t(_ERFINV_LO[0], dev), _t(_ERFINV_HI[0], dev))
    for a, b in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = _fma(p, w, torch.where(lo, _t(a, dev), _t(b, dev)))
    return p * x


def _round32(q: Fraction) -> np.float32:
    """``q`` rounded to the nearest f32, ties to even."""
    r = _F32(float(q))
    cands = (np.nextafter(r, _F32(-np.inf)), r, np.nextafter(r, _F32(np.inf)))
    def dist(c):
        return abs(Fraction(float(c)) - q)
    best = min(cands, key=lambda c: (dist(c), int(c.view(np.uint32)) & 1))
    return _F32(best)


def _fma32(a, b, c) -> np.float32:
    return _round32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


(_ERF_CLAMP, _INV_SQRT2) = _bits(0x406F9C68, 0x3F3504F3)
_ERF_NUM = _bits(0x39702D51, 0x3B5F5DA2, 0x3D50B6EB, 0x3E3DA740, 0x3F906EBA)
_ERF_DEN = _bits(0xB3FD3906, 0x37C588DF, 0x3A856D28, 0x3C6687D4, 0x3DE34C21,
                 0x3EFEB44A, 0x3F800000)


def _erf32(v) -> np.float32:
    """XLA's f32 ``erf`` of a host scalar (``x · rsqrt2``, clamped, then a
    rational function whose steps are fused multiply-adds)."""
    x = _F32(_F32(v) * _INV_SQRT2)
    x = min(max(x, -_ERF_CLAMP), _ERF_CLAMP)
    z = _F32(x * x)
    n = _fma32(z, _F32(_ERF_NUM[0]), _F32(_ERF_NUM[1]))
    for c in _ERF_NUM[2:]:
        n = _fma32(n, z, _F32(c))
    n = _F32(x * n)
    d = _fma32(z, _F32(_ERF_DEN[0]), _F32(_ERF_DEN[1]))
    for c in _ERF_DEN[2:]:
        d = _fma32(d, z, _F32(c))
    return _F32(n / d)


_SQRT2 = _F32(np.sqrt(2))
_NORMAL_LO = np.nextafter(_F32(-1.0), _F32(0.0))
# lecun_normal's truncated normal lies on (-2, 2), before its scale.
_TRUNC_LOWER, _TRUNC_UPPER = -2.0, 2.0


def _scalars(kind: str, mul: float) -> dict:
    """The host constants of one draw: the uniform's bounds, the clip and
    the scale."""
    if kind == "normal":
        lo, hi, clip = _NORMAL_LO, _F32(1.0), None
    elif kind == "truncated_normal":
        lo, hi = _erf32(_TRUNC_LOWER), _erf32(_TRUNC_UPPER)
        clip = (np.nextafter(_F32(_TRUNC_LOWER), _F32(np.inf)),
                np.nextafter(_F32(_TRUNC_UPPER), _F32(-np.inf)))
    else:
        raise ValueError(f"unknown draw kind {kind!r}")
    return {"lo": _F32(lo), "hi": _F32(hi), "span": _F32(_F32(hi) - _F32(lo)), "clip": clip,
            "mul": _F32(mul)}


def _sample(k, start, stop, device, s) -> torch.Tensor:
    u = uniform(random_bits(k, start, stop, device), s["lo"], s["hi"])
    out = _t(_SQRT2, u.device) * erf_inv(u)
    if s["clip"] is not None:
        lo, hi = s["clip"]
        out = torch.minimum(torch.maximum(out, _t(lo, u.device)), _t(hi, u.device))
    return out * _t(s["mul"], u.device)


def lecun_scale(fan_in: int) -> np.float32:
    """flax's ``lecun_normal`` scale: ``sqrt(f32(1/fan_in)) / 0.8796...``."""
    return _F32(np.sqrt(_F32(1.0 / fan_in)) / _F32(0.87962566103423978))


def draw_plain(k: tuple, kind: str, start: int, stop: int, *, mul: float,
               device="cpu") -> torch.Tensor:
    """Elements ``start..stop-1`` of ``initializer(key, shape) `` in f32:
    ``kind`` "normal" is ``normal(stddev=mul)``, "truncated_normal" is the
    truncated normal on (-2, 2) times ``mul`` (lecun_normal)."""
    return _sample(k, start, stop, device, _scalars(kind, mul))


_CHUNK = 1 << 22  # elements of one CPU pass: bounds the int64 temporaries


def draw(k: tuple, kind: str, out: torch.Tensor, start: int = 0, *, mul: float) -> torch.Tensor:
    """Fill the flat f32 tensor ``out`` with elements ``start..start+n-1`` of
    the draw. A CUDA tensor takes the kernel; a CPU tensor the torch ops, in
    chunks."""
    if out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError("draw fills a contiguous f32 tensor")
    flat = out.view(-1)
    n = flat.numel()
    if out.is_cuda:
        _launch(k, kind, flat, start, _scalars(kind, mul))
        return out
    for i in range(0, n, _CHUNK):
        j = min(n, i + _CHUNK)
        flat[i:j] = draw_plain(k, kind, start + i, start + j, mul=mul)
    return out


def _launch(k, kind, flat, start, s) -> None:
    from ..ops._build import load_library

    lib = load_library("seed_init.cu")
    clip = s["clip"]
    rc = lib.seed_init_draw(
        ctypes.c_void_p(flat.data_ptr()), ctypes.c_longlong(start),
        ctypes.c_longlong(flat.numel()), ctypes.c_uint(k[0]), ctypes.c_uint(k[1]),
        float(s["lo"]), float(s["span"]), int(clip is not None),
        float(clip[0] if clip else 0.0), float(clip[1] if clip else 0.0), float(s["mul"]),
        ctypes.c_void_p(torch.cuda.current_stream(flat.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"seed_init_draw: {lib.seed_init_error(rc).decode()}")
    seed_launches["draw"] += 1
