"""The port's Hopper kernels against their plain PyTorch versions, on the card.

These tests need an sm_90 GPU and skip elsewhere. They import neither JAX
nor the JAX package, so they run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hypha_tpu_torch.ops.paged_attention import (
    PagedKV,
    paged_attention,
    ragged_block_attention,
    ragged_paged_attention,
)

pytestmark = pytest.mark.cuda

# f32: the kernel sums in another order than the plain version; bf16: the
# output rounds to 8 mantissa bits (inputs are unit-variance).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90)")
    return torch.device("cuda")


def _case(seed, *, B, sq, hq, hkv, D, bs, max_blocks, dtype, quant, device, idle=(), poison=1e4):
    """A pool-valid paged state: prefix-packed disjoint tables, queries
    inside each lane's allocated region, garbage and unallocated blocks
    poisoned, ``idle`` lanes all-sentinel."""
    rng = np.random.default_rng(seed)
    blocks = B * max_blocks + 3
    rows = (blocks + 1) * bs
    k = rng.standard_normal((rows, hkv, D)).astype(np.float32)
    v = rng.standard_normal((rows, hkv, D)).astype(np.float32)
    table = np.full((B, max_blocks), blocks, np.int32)
    free = list(rng.permutation(blocks))
    occ = rng.integers(1, max_blocks + 1, size=B)
    qoff = np.zeros(B, np.int32)
    used = np.zeros(blocks + 1, bool)
    for b in range(B):
        if b in idle:
            qoff[b] = max_blocks * bs
            continue
        for j in range(occ[b]):
            table[b, j] = free.pop()
            used[table[b, j]] = True
        hi = occ[b] * bs - sq
        lo = max((occ[b] - 1) * bs - sq + 1, 0)
        qoff[b] = int(rng.integers(lo, hi + 1)) if hi >= lo else 0
    for blk in np.flatnonzero(~used):
        k[blk * bs : (blk + 1) * bs] = poison
        v[blk * bs : (blk + 1) * bs] = poison
    q = torch.from_numpy(rng.standard_normal((B, sq, hq, D)).astype(np.float32))

    def pools(kk, vv):
        kt, vt = torch.from_numpy(kk), torch.from_numpy(vv)
        if not quant:
            return kt.to(dtype), vt.to(dtype), None, None
        from hypha_tpu_torch.ops.kvcache import _quantize_rows

        kq, ks = _quantize_rows(kt)
        vq, vs = _quantize_rows(vt)
        return kq, vq, ks, vs

    kv = PagedKV(*pools(k, v), torch.from_numpy(table))
    kv = PagedKV(*(None if t is None else t.to(device) for t in kv))
    return q.to(dtype).to(device), kv, torch.from_numpy(qoff).to(device), blocks, used


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "hq,hkv,D,bs,sq",
    [(4, 4, 64, 4, 1), (8, 2, 128, 16, 5), (32, 8, 128, 16, 64), (32, 32, 128, 48, 9)],
)
def test_kernel_matches_plain(cuda, quant, dtype, hq, hkv, D, bs, sq):
    B, max_blocks = 4, 6
    q, kv, qoff, blocks, _ = _case(
        7, B=B, sq=sq, hq=hq, hkv=hkv, D=D, bs=bs, max_blocks=max_blocks,
        dtype=dtype, quant=quant, device=cuda, idle=(2,),
    )
    kstart = torch.tensor([0, 3, 0, 1], dtype=torch.int32, device=cuda)
    for window, ks in ((None, None), (2 * bs, kstart)):
        kw = dict(blocks=blocks, block_size=bs, q_offset=qoff, k_start=ks, window=window)
        got = ragged_paged_attention(q, kv, **kw)
        torch.cuda.synchronize()
        ref = ragged_block_attention(q, kv, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype], f"max abs err {err}"
        assert torch.all(got[2] == 0), "idle lane must be exactly zero"


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("sq", [4, 64])  # the simt route, then the mma route
def test_kernel_ignores_unreachable_blocks(cuda, sq, quant):
    """Re-poisoning every block no lane may read leaves the output bits."""
    kw = dict(B=3, sq=sq, hq=8, hkv=2, D=128, bs=16, max_blocks=5,
              dtype=torch.bfloat16, quant=quant, device=cuda)
    q, kv, qoff, blocks, used = _case(11, poison=1e4, **kw)
    a = ragged_paged_attention(q, kv, blocks=blocks, block_size=16, q_offset=qoff)
    for blk in np.flatnonzero(~used):
        kv.k[blk * 16 : (blk + 1) * 16] = -3e4 if not quant else -7
        kv.v[blk * 16 : (blk + 1) * 16] = 7e3 if not quant else 9
    b = ragged_paged_attention(q, kv, blocks=blocks, block_size=16, q_offset=qoff)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# The mma route: bf16 q, Sq >= 16. Sq 37 and 69 leave partial 16-row
# fragments, 69 a second 64-row query tile; the lanes hold up to 192 keys,
# so the key loop crosses several 64-key tiles and, at block size 48,
# tiles that straddle blocks.
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,hkv,D", [(8, 8, 64), (32, 8, 128)])
@pytest.mark.parametrize("bs,max_blocks", [(4, 48), (16, 12), (48, 4)])
@pytest.mark.parametrize("sq", [16, 37, 64, 69])
def test_mma_route_matches_plain(cuda, sq, bs, max_blocks, hq, hkv, D, quant):
    from hypha_tpu_torch.ops.paged_attention import _ragged_route

    assert _ragged_route(sq, torch.bfloat16) == "mma"
    q, kv, qoff, blocks, _ = _case(
        sq * 7 + bs, B=4, sq=sq, hq=hq, hkv=hkv, D=D, bs=bs, max_blocks=max_blocks,
        dtype=torch.bfloat16, quant=quant, device=cuda, idle=(2,),
    )
    kstart = torch.tensor([0, 5, 0, 70], dtype=torch.int32, device=cuda)
    for window, ks in ((None, None), (None, kstart), (40, None), (3 * bs, kstart)):
        kw = dict(blocks=blocks, block_size=bs, q_offset=qoff, k_start=ks, window=window)
        before = ragged_paged_attention.mma_launches
        got = ragged_paged_attention(q, kv, **kw)
        torch.cuda.synchronize()
        assert ragged_paged_attention.mma_launches == before + 1
        ref = ragged_block_attention(q, kv, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16], f"max abs err {err} (window {window})"
        assert torch.all(got[2] == 0), "idle lane must be exactly zero"


def test_dispatcher_launches_kernel_on_cuda(cuda):
    q, kv, qoff, blocks, _ = _case(
        3, B=2, sq=1, hq=4, hkv=4, D=64, bs=8, max_blocks=3,
        dtype=torch.bfloat16, quant=False, device=cuda,
    )
    before = ragged_paged_attention.launches
    plain = paged_attention.plain_calls
    paged_attention(q, kv, blocks=blocks, block_size=8, q_offset=qoff)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    assert paged_attention.plain_calls == plain


# ------------------------------------------------------- flash attention


def _flash_case(seed, B, Sq, Sk, H, Hkv, D, dtype, device):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype).to(device)

    return t(B, Sq, H, D), t(B, Sk, Hkv, D), t(B, Sk, Hkv, D), t(B, Sq, H, D)


# f32: another summation order; bf16: P and dS round to 8 mantissa bits
# inside the kernels at other points of the online softmax than in the
# plain version. Gradients are held against the case's largest |gradient|.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,Sq,Sk,H,Hkv,D,causal",
    [
        (2, 256, 256, 4, 4, 64, True),
        (1, 200, 200, 8, 2, 128, True),  # GQA, ragged tiles
        (1, 130, 70, 4, 2, 64, False),  # Sq != Sk
        (1, 70, 130, 4, 4, 128, True),  # causal with Sk > Sq
    ],
)
def test_flash_kernels_match_plain(cuda, dtype, B, Sq, Sk, H, Hkv, D, causal):
    _check_flash_kernels(cuda, dtype, B, Sq, Sk, H, Hkv, D, causal, None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,S,H,Hkv,D,causal,window",
    [
        (1, 300, 8, 2, 128, True, 100),  # tiles wholly behind the window skipped
        (1, 200, 4, 4, 64, False, 70),  # not causal: keys from i - 69 to the end
        (1, 130, 4, 2, 64, True, 3),  # each query sees itself and two keys before
    ],
)
def test_flash_kernels_window_matches_plain(cuda, dtype, B, S, H, Hkv, D, causal, window):
    _check_flash_kernels(cuda, dtype, B, S, S, H, Hkv, D, causal, window)


def _check_flash_kernels(cuda, dtype, B, Sq, Sk, H, Hkv, D, causal, window):
    from hypha_tpu_torch.ops.flash_attention import (
        flash_backward_reference,
        flash_dkv_cuda,
        flash_dq_cuda,
        flash_forward_cuda,
        flash_forward_reference,
    )

    q, k, v, do = _flash_case(5, B, Sq, Sk, H, Hkv, D, dtype, cuda)
    o, lse = flash_forward_cuda(q, k, v, causal, None, window)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal, None, window)
    tol = FLASH_TOL[dtype]
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    live = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[live] - lse_ref[live]).abs().max().item() <= tol
    assert torch.all(o[~live.transpose(1, 2)] == 0), "a row that sees no key has o = 0"
    args = (q, k, v, o, lse, do, causal, None, window)

    def backward():
        dq = flash_dq_cuda(*args)
        dk, dv = flash_dkv_cuda(*args)
        torch.cuda.synchronize()
        return dq, dk, dv

    grads = backward()
    refs = flash_backward_reference(*args)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), (name, err)
    again = backward()  # no atomics: dQ, dK and dV give the same bits again
    for name, g, a in zip(("dq", "dk", "dv"), grads, again):
        assert torch.equal(a, g), name


# The bf16 backward on the tensor cores (flash_dq_mma_kernel: 128-row
# query tiles; flash_dkv_mma_kernel: 64-key CTAs over 64-row query tiles)
# at its edges: Sq not a multiple of 16, 64 or 128; causal with Sk > Sq;
# GQA 32/8 under a window; rows that see no key (L = -inf: their P must be
# 0, never NaN), at head_dim 64 and 128.
@pytest.mark.parametrize(
    "B,Sq,Sk,H,Hkv,D,causal,window",
    [
        (1, 1000, 1000, 8, 2, 128, True, None),
        (2, 77, 77, 4, 4, 64, True, None),
        (1, 77, 200, 4, 2, 128, True, None),  # causal, Sk > Sq
        (1, 200, 77, 4, 4, 64, False, None),  # Sk < Sq
        (1, 1000, 1000, 32, 8, 128, True, 256),  # GQA 32/8 under a window
        (1, 300, 300, 32, 8, 64, False, 100),
        (1, 200, 77, 4, 2, 64, True, 50),  # queries from 126 on see no key
        (1, 77, 77, 4, 2, 128, False, 5),
    ],
)
def test_flash_backward_mma_edges(cuda, B, Sq, Sk, H, Hkv, D, causal, window):
    _check_flash_kernels(cuda, torch.bfloat16, B, Sq, Sk, H, Hkv, D, causal, window)


@pytest.mark.parametrize(
    "B,S,H,Hkv,D,causal,window",
    [(2, 300, 4, 2, 128, True, None), (1, 200, 4, 4, 64, False, None), (1, 300, 8, 2, 128, True, 100)],
)
def test_flash_forward_bit_identical(cuda, B, S, H, Hkv, D, causal, window):
    """The bf16 forward (tensor cores, no atomics) gives the same o and L
    bits on a second launch."""
    from hypha_tpu_torch.ops.flash_attention import flash_forward_cuda

    q, k, v, _ = _flash_case(13, B, S, S, H, Hkv, D, torch.bfloat16, cuda)
    o1, l1 = flash_forward_cuda(q, k, v, causal, None, window)
    o2, l2 = flash_forward_cuda(q, k, v, causal, None, window)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def test_flash_attention_autograd_counts_launches(cuda):
    from hypha_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, do = _flash_case(9, 1, 128, 128, 4, 2, 64, torch.bfloat16, cuda)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (flash_attention.fwd_launches, flash_attention.dq_launches,
              flash_attention.dkv_launches, flash_attention.plain_calls)
    out = flash_attention(q, k, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    after = (flash_attention.fwd_launches, flash_attention.dq_launches,
             flash_attention.dkv_launches, flash_attention.plain_calls)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))
