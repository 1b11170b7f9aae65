"""The port's Hopper kernel against its plain PyTorch version, on the card.

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


def test_kernel_ignores_unreachable_blocks(cuda):
    """Re-poisoning every block no lane may read leaves the output bits."""
    kw = dict(B=3, sq=4, hq=8, hkv=2, D=128, bs=16, max_blocks=5,
              dtype=torch.bfloat16, quant=False, device=cuda)
    q, kv, qoff, blocks, used = _case(11, poison=1e4, **kw)
    a = ragged_paged_attention(q, kv, blocks=blocks, block_size=16, q_offset=qoff)
    for blk in np.flatnonzero(~used):
        kv.k[blk * 16 : (blk + 1) * 16] = -3e4
        kv.v[blk * 16 : (blk + 1) * 16] = 7e3
    b = ragged_paged_attention(q, kv, blocks=blocks, block_size=16, q_offset=qoff)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


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
