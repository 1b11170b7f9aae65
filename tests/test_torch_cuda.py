"""The port's Hopper kernels against their plain PyTorch versions, on the card.

These tests need an sm_90 GPU and skip elsewhere. They import neither JAX
nor the JAX package, so they run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import time

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
@pytest.mark.parametrize("sq", [1, 4, 64])  # the decode, simt and mma routes
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
    before = (ragged_paged_attention.launches, ragged_paged_attention.decode_launches)
    plain = paged_attention.plain_calls
    paged_attention(q, kv, blocks=blocks, block_size=8, q_offset=qoff)
    torch.cuda.synchronize()
    assert (ragged_paged_attention.launches, ragged_paged_attention.decode_launches) == (
        before[0] + 1, before[1] + 1)
    assert paged_attention.plain_calls == plain


# The decode route: bf16 q, Sq 1 (ragged_decode_kernel, and its merge
# kernel past one key split). G 1, 4 and 7 query heads per kv head; block
# sizes 4, 16 and 48 with lanes of up to 192 keys (6 tiles of 32, whose
# bounds cut the 48-key blocks); the wrapper's own split count, one split,
# 3, and 16 (more splits than tiles: some see no key); windows and k_start
# floors (lane 3's floor of 70 may hide every key).
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs,max_blocks", [(4, 48), (16, 12), (48, 4)])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (32, 8), (28, 4)])
def test_decode_route_matches_plain(cuda, hq, hkv, bs, max_blocks, D, quant):
    from hypha_tpu_torch.ops.paged_attention import _launch, _ragged_route

    assert _ragged_route(1, torch.bfloat16) == "decode"
    q, kv, qoff, blocks, used = _case(
        bs * 13 + hq + D, B=4, sq=1, hq=hq, hkv=hkv, D=D, bs=bs, max_blocks=max_blocks,
        dtype=torch.bfloat16, quant=quant, device=cuda, idle=(2,),
    )
    kstart = torch.tensor([0, 5, 0, 70], dtype=torch.int32, device=cuda)
    masks = ((None, None), (None, kstart), (40, None), (3 * bs, kstart))
    outs, worst = [], 0.0
    for window, ks in masks:
        kw = dict(blocks=blocks, block_size=bs, q_offset=qoff, k_start=ks, window=window)
        ref = ragged_block_attention(q, kv, **kw)
        before = ragged_paged_attention.decode_launches
        got = ragged_paged_attention(q, kv, **kw)
        again = ragged_paged_attention(q, kv, **kw)
        torch.cuda.synchronize()
        assert ragged_paged_attention.decode_launches == before + 2
        assert torch.equal(got, again), "a second launch must give the same bits"
        outs.append(got)
        for splits in (None, 1, 3, 16):
            out = got if splits is None else _launch(q, kv, "decode", splits=splits, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            worst = max(worst, err)
            assert err <= TOL[torch.bfloat16], f"max abs err {err} (window {window}, splits {splits})"
            assert torch.all(out[2] == 0), "idle lane must be exactly zero"
    # Re-poison every block no lane may read: the output bits must stay.
    for blk in np.flatnonzero(~used):
        kv.k[blk * bs : (blk + 1) * bs] = -3e4 if not quant else -7
        kv.v[blk * bs : (blk + 1) * bs] = 7e3 if not quant else 9
    for (window, ks), got in zip(masks, outs):
        again = ragged_paged_attention(q, kv, blocks=blocks, block_size=bs, q_offset=qoff,
                                       k_start=ks, window=window)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"poisoned blocks changed the output (window {window})"
    print(f"decode route max abs err {worst:.3e}")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("sq,qoff", [(64, (320, 351)), (16, (330, 335)), (1, (351, 320))])
def test_routes_over_shared_prefix_blocks(cuda, sq, qoff, quant):
    """The prefix cache's inputs: two lanes map the same 20 physical blocks
    first, and each chunk starts past or inside that cached prefix, at an
    offset that is no multiple of the chunk. Every route equals the plain
    version, and a lane's output does not depend on the other lane."""
    from hypha_tpu_torch.ops.kvcache import _quantize_rows
    from hypha_tpu_torch.ops.paged_attention import _launch

    rng = np.random.default_rng(sq)
    bs, max_blocks, hq, hkv, D = 16, 32, 32, 8, 128
    blocks = 2 * max_blocks + 4
    rows = (blocks + 1) * bs
    k = torch.from_numpy(rng.standard_normal((rows, hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((rows, hkv, D)).astype(np.float32))
    ids = list(rng.permutation(blocks))
    shared = [ids.pop() for _ in range(20)]
    table = np.full((2, max_blocks), blocks, np.int32)
    for lane, off in enumerate(qoff):
        n = -(-(off + sq) // bs)
        table[lane, :n] = shared + [ids.pop() for _ in range(n - 20)]
    if quant:
        (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    kv = PagedKV(*(None if t is None else t.to(cuda) for t in (k, v, ks, vs)),
                 torch.from_numpy(table).to(cuda))
    q = torch.from_numpy(rng.standard_normal((2, sq, hq, D)).astype(np.float32))
    q = q.to(torch.bfloat16).to(cuda)
    kw = dict(blocks=blocks, block_size=bs, q_offset=torch.tensor(qoff, dtype=torch.int32,
                                                                  device=cuda))
    ref = ragged_block_attention(q, kv, **kw)
    for route in ("mma", "simt") + (("decode",) if sq == 1 else ()):
        out = _launch(q, kv, route, **kw)
        assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16], route
        if route == "decode":
            continue  # its split count depends on the number of lanes
        alone = _launch(q[:1], PagedKV(kv.k, kv.v, kv.k_scale, kv.v_scale, kv.table[:1]), route,
                        blocks=blocks, block_size=bs, q_offset=kw["q_offset"][:1])
        assert torch.equal(alone[0], out[0]), route


@pytest.mark.parametrize("quant", [False, True])
def test_copy_blocks_on_the_card_equals_the_cpu(cuda, quant):
    from hypha_tpu_torch.ops.kvcache import KVCache, copy_blocks

    caches = {}
    for dev in ("cpu", cuda):
        torch.manual_seed(0)
        c = KVCache(num_layers=2, batch=2, decode_len=64, num_kv_heads=2, head_dim=64,
                    dtype=torch.bfloat16, device=dev, per_row=True, blocks=9, block_size=16,
                    kv_quant="int8" if quant else "")
        for name in ("k", "v", "k_scale", "v_scale"):
            for leaf in getattr(c, name) or ():
                leaf.copy_((torch.randn(leaf.shape) * 50).to(leaf.dtype))
        copy_blocks(c, [1, 4, 7], torch.tensor([8, 0, 2]), 16)
        caches[dev if dev == "cpu" else "cuda"] = c
    for name in ("k", "v", "k_scale", "v_scale"):
        for a, b in zip(getattr(caches["cpu"], name) or (), getattr(caches["cuda"], name) or ()):
            assert b.is_cuda and torch.equal(a, b.cpu())


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_prefix_cached_pool_on_the_card_answers_as_uncached(cuda, kv_quant):
    """A tiny model's pool on the card with the prefix cache on gives the
    uncached pool's tokens for requests that share a prefix cached by an
    earlier one, in a pool small enough to preempt, and calls no plain
    attention."""
    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.worker.infer_executor import load_model

    model = load_model({"family": "llama", "preset": "tiny", "config": TINY_CONFIG, "seed": 4},
                       device="cuda")
    shared = [(i * 7 + 3) % 250 + 1 for i in range(48)]
    prompts = [shared + [5, 6], shared + [1] * 31, shared + [9] * 16, shared + [1] * 31,
               shared[:40] + [2, 2, 2]]
    n_new = [60, 20, 30, 20, 25]
    out = {}
    for cache in (True, False):
        pool = DecodePool(model, slots=4, max_len=512, steps_per_call=8, block_size=16,
                          num_blocks=24, reserve_blocks=0, ragged=True, kv_quant=kv_quant,
                          prefix_cache=cache)
        plain0 = paged_attention.plain_calls
        try:
            first = pool.submit([prompts[0]], n_new[0])
            while pool.prefill_chunks < 1:
                time.sleep(0.001)
            futs = [first] + [pool.submit([p], n) for p, n in zip(prompts[1:], n_new[1:])]
            out[cache] = ([f.result(timeout=300) for f in futs], pool.hit_blocks,
                          pool.cow_copies, pool.preemptions)
        finally:
            pool.close()
        assert paged_attention.plain_calls == plain0
    assert out[True][0] == out[False][0]
    assert out[True][1] > 0 and out[False][1] == 0


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_blocks_move_between_card_pools_bit_for_bit(cuda, kv_quant):
    """The fleet cache on the card: a chain extracted from one pool goes
    through the wire helpers and lands in another pool bit for bit (int8
    payloads with their scale rows); a prefill chunk that starts after the
    landed prefix, read from the receiving pool's own tensors, equals the
    plain version on the mma route; and the receiving pool answers the
    warm prompt as the sending one, in one prefill chunk, with no plain
    attention call."""
    from hypha_tpu_torch.executor.block_cache import chain_hashes
    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.ops.kvcache import leaves_from_wire, leaves_to_wire
    from hypha_tpu_torch.ops.paged_attention import _launch
    from hypha_tpu_torch.worker.infer_executor import load_model

    model = load_model({"family": "llama", "preset": "tiny", "config": TINY_CONFIG, "seed": 5},
                       device="cuda")
    opts = dict(slots=4, max_len=512, steps_per_call=8, block_size=16, num_blocks=64,
                prefill_chunk=16, ragged=True, kv_quant=kv_quant, prefix_cache=True,
                fleet_cache=True)
    prompt = [(i * 7 + 3) % 250 + 1 for i in range(48)]
    hashes = chain_hashes(prompt, 16)
    a, b = DecodePool(model, **opts), DecodePool(model, **opts)
    try:
        a.submit([prompt], 8).result(timeout=300)
        served = a.serve_chain(hashes).result(timeout=60)
        assert served["hashes"] == hashes
        landed = leaves_from_wire(leaves_to_wire(served["leaves"]))
        assert b.inject_chain(hashes, landed, None, None).result(timeout=60) == 3
        back = b.serve_chain(hashes).result(timeout=60)["leaves"]
        assert list(back) == list(served["leaves"])
        for key, t in served["leaves"].items():
            assert back[key].dtype == t.dtype and torch.equal(
                back[key].view(torch.uint8), t.view(torch.uint8)), key
        # One 16-row chunk at q_offset 48 over the landed blocks, layer 0.
        cfg, ids = model.config, [b._alloc.block_for(h) for h in hashes]
        spare = next(i for i in range(b.num_blocks) if i not in ids)
        table = torch.full((1, 512 // 16), b.num_blocks, dtype=torch.int32)
        table[0, :4] = torch.tensor(ids + [spare])
        c = b._cache
        kv = PagedKV(c.k[0], c.v[0], None if c.k_scale is None else c.k_scale[0],
                     None if c.v_scale is None else c.v_scale[0], table.to(cuda))
        q = torch.randn(1, 16, cfg.num_heads, cfg.head_dim,
                        generator=torch.Generator().manual_seed(1)).to(torch.bfloat16).to(cuda)
        kw = dict(blocks=b.num_blocks, block_size=16,
                  q_offset=torch.tensor([48], dtype=torch.int32, device=cuda))
        out, ref = _launch(q, kv, "mma", **kw), ragged_block_attention(q, kv, **kw)
        assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]
        warm = prompt + [9] * 5
        before, plain0 = b.prefill_chunks, paged_attention.plain_calls
        mma0 = ragged_paged_attention.mma_launches
        got_b = b.submit([warm], 8).result(timeout=300)
        assert b.prefill_chunks - before == 1
        assert ragged_paged_attention.mma_launches - mma0 == cfg.num_layers
        assert got_b == a.submit([warm], 8).result(timeout=300)
        assert paged_attention.plain_calls == plain0
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,hkv,D", [(8, 8, 64), (32, 8, 128)])
def test_simt_route_at_decode_shape(cuda, hq, hkv, D, quant):
    """The CUDA-core kernel still takes bf16 decode when asked for it
    (chip_smoke.py times it beside the decode route)."""
    from hypha_tpu_torch.ops.paged_attention import _launch

    q, kv, qoff, blocks, _ = _case(
        29, B=4, sq=1, hq=hq, hkv=hkv, D=D, bs=16, max_blocks=12,
        dtype=torch.bfloat16, quant=quant, device=cuda, idle=(2,),
    )
    kw = dict(blocks=blocks, block_size=16, q_offset=qoff)
    before = ragged_paged_attention.simt_launches
    got = _launch(q, kv, "simt", **kw)
    torch.cuda.synchronize()
    assert ragged_paged_attention.simt_launches == before + 1
    err = (got.float() - ragged_block_attention(q, kv, **kw).float()).abs().max().item()
    assert err <= TOL[torch.bfloat16], f"max abs err {err}"
    assert torch.all(got[2] == 0)


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


# ------------------------------------------------- the parameter server's step


def _delta_files(tmp_path, seed):
    """Three delta files (one bf16), every tensor at its own scale."""
    from hypha_tpu_torch.executor.serialization import save_file

    g = torch.Generator().manual_seed(seed)
    shapes = {"params/embed_tokens": (512, 64), "params/norm/weight": (64,),
              "params/layers_0/mlp/down_proj/kernel": (3, 257, 5)}
    files = []
    for i in range(3):
        tree = {k: torch.randn(s, generator=g) * 10.0 ** float(torch.empty(()).uniform_(-5, 1, generator=g))
                for k, s in shapes.items()}
        if i == 1:
            tree = {k: v.bfloat16() for k, v in tree.items()}
        files.append(save_file(tree, tmp_path / f"delta-{seed}-{i}.safetensors"))
    return files


def test_fold_and_outer_step_on_cuda_equal_the_cpu(cuda, tmp_path):
    """RoundAccum (fold, un-fold, mean) and outer_step over two rounds with a
    momentum file: the card gives the CPU's bits."""
    from hypha_tpu_torch.executor.serialization import load_file
    from hypha_tpu_torch.stream.accum import RoundAccum
    from hypha_tpu_torch.worker.ps_executor import outer_step

    def bits(t):
        return t.detach().cpu().view(torch.int32)

    samples = [300.0, 101.0, 7.0]
    for r in range(2):
        files = _delta_files(tmp_path, r)
        accs = {d: RoundAccum(device=d) for d in ("cpu", cuda)}
        for acc in accs.values():
            for f, s in zip(files, samples):
                acc.fold(f, s)
            acc.fold(files[1], samples[1], sign=-1.0)
            acc.fold(files[1], 55.0)
        assert accs[cuda].partial()["params/norm/weight"].is_cuda
        host, card = accs["cpu"].mean(), accs[cuda].mean()
        assert all(torch.equal(bits(host[k]), bits(card[k])) for k in host)
        received = {f"w{i}": (f, s) for i, (f, s) in enumerate(zip(files, samples))}
        stats = {}
        for d in ("cpu", cuda):
            wd = tmp_path / ("host" if d == "cpu" else "card")
            wd.mkdir(exist_ok=True)
            stats[d] = {}
            outer_step(received, wd / "momentum.safetensors", 0.7, 0.9, wd, r, accum=accs[d],
                       stats=stats[d], device=d)
        for name in (f"update-{r}.safetensors", "momentum.safetensors"):
            a, b = load_file(tmp_path / "host" / name), load_file(tmp_path / "card" / name)
            assert set(a) == set(b) and all(torch.equal(bits(a[k]), bits(b[k])) for k in a), name
        assert stats["cpu"] == pytest.approx(stats[cuda], rel=1e-12)


def test_session_bridge_round_trip(cuda, tmp_path):
    """The port's Session against the port's Bridge on this machine: fetch,
    status, send and the SSE receive of what the stand-in server sent back."""
    import asyncio
    import threading

    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.executor.bridge_client import Session
    from hypha_tpu_torch.worker.bridge import Bridge
    from hypha_tpu_torch.worker.connectors import ReceivedFile, fetch_uri

    class Node:
        async def request(self, peer, protocol, msg, timeout=30.0):
            return m.ProgressResponse(kind=m.ProgressResponseKind.SCHEDULE_UPDATE, counter=msg.batch_size)

    class Connector:
        def __init__(self):
            self.landed = asyncio.Queue()

        async def fetch(self, fetch, dest):
            return [await asyncio.to_thread(fetch_uri, fetch.ref.uri, dest)]

        async def send(self, send, path, resource, meta=None):
            dest = work / "incoming" / "echo.bin"
            dest.parent.mkdir(exist_ok=True)
            dest.write_bytes(path.read_bytes()[::-1])
            await self.landed.put(ReceivedFile(dest, dest.stat().st_size, "ps", "results", meta))

        async def receive(self, receive, dest):
            while True:
                yield await self.landed.get()

    work = tmp_path / "work"
    src = tmp_path / "weights.bin"
    src.write_bytes(bytes(range(256)) * 8)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    bridge = Bridge(Node(), work, "j", "sched", Connector())
    sock = asyncio.run_coroutine_threadsafe(bridge.start(), loop).result(10)
    try:
        ref = m.Reference.from_peers(["ps"], "updates")
        with Session(str(sock)) as s:
            assert s.fetch(m.Fetch(m.Reference.from_uri(src.as_uri()))) == ["artifacts/weights.bin"]
            for n in (1, 2, 3):  # heartbeats on one keep-alive connection
                assert s.send_status(m.Progress(kind=m.ProgressKind.STATUS, batch_size=n)).counter == n
            (work / "d.bin").write_bytes(b"abc")
            s.send_resource(m.Send(ref), "d.bin", meta={"round": 4})
            with s.receive(m.Receive(ref)) as events:
                event = next(events)
        assert event == {"path": "incoming/echo.bin", "size": 3, "from_peer": "ps",
                         "resource": "results", "meta": {"round": 4}}
        assert (work / event["path"]).read_bytes() == b"cba"
    finally:
        asyncio.run_coroutine_threadsafe(bridge.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
    assert not sock.exists()


# ------------------------------------------------- the worker runtime on the card


def test_worker_nodes_run_a_job_on_the_card(cuda):
    """The port's fabric (``chip_smoke.run_node_job``): two worker nodes each
    running the in-process trainer on the card through the flash kernels,
    and the parameter server folding and stepping on the card, auctioned,
    dispatched and driven by the port's scheduler over TCP."""
    import asyncio
    import shutil
    import tempfile
    from pathlib import Path

    import chip_smoke
    from hypha_tpu_torch.ops.attention import dot_product_attention
    from hypha_tpu_torch.ops.flash_attention import flash_attention

    # head_dim 64: the kernels take 64 or 128.
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"hidden_size": 256}, "seed": 0}
    rounds, steps, workers, layers = 2, 3, 2, 2
    counts = (flash_attention.fwd_launches, flash_attention.dq_launches,
              flash_attention.dkv_launches, flash_attention.plain_calls, dot_product_attention.calls)
    root = Path(tempfile.mkdtemp(prefix="tc"))  # bridge sockets: paths under 108 bytes
    try:
        run = asyncio.run(asyncio.wait_for(chip_smoke.run_node_job(
            root, model, device="cuda", rounds=rounds, steps=steps, batch=2, seq=128, period=64,
            lr=3e-3, limit_s=240, workers=workers, train_runtime="in-process"), 300))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert chip_smoke.node_problems(run, rounds=rounds,
                                    expect=chip_smoke.flat_f32_spec(model)) == []
    assert len(run["rec"]["fold_s"]) == rounds * workers
    # One launch of each kernel per layer per batch the scheduler heard of.
    launches = layers * sum(p["kind"] == "status" for p in run["rec"]["progress"])
    now = (flash_attention.fwd_launches, flash_attention.dq_launches,
           flash_attention.dkv_launches, flash_attention.plain_calls, dot_product_attention.calls)
    assert [b - a for a, b in zip(counts, now)] == [launches, launches, launches, 0, 0]


def test_parameter_server_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The port's ParameterServerExecutor fed the same pushes (three
    workers, one re-sending; one delta bf16) on the CPU and on the card:
    the broadcast updates of two rounds are equal bit for bit."""
    import asyncio

    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.executor.serialization import load_file
    from hypha_tpu_torch.network import MemoryTransport, Node
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor

    workers, samples = ("w0", "w1", "w2"), (300.0, 101.0, 7.0)
    files = {r: _delta_files(tmp_path, r) for r in range(2)}

    async def serve(device, name):
        hub = MemoryTransport()
        nodes = {p: Node(hub.shared(), peer_id=p) for p in ("ps", "sched", *workers)}
        for n in nodes.values():
            await n.start()
        for x in nodes.values():
            for y in nodes.values():
                if x is not y:
                    x.add_peer_addr(y.peer_id, y.listen_addrs[0])

        async def on_progress(peer, p):
            return m.ProgressResponse(kind=m.ProgressResponseKind.DONE if p.round
                                      else m.ProgressResponseKind.OK)

        nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
        spec = m.JobSpec(job_id="agg", executor=m.Executor(
            kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
                updates=m.Receive(m.Reference.from_peers(list(workers), "updates")),
                results=m.Send(m.Reference.from_peers(["w0"], "results")),
                optimizer=m.Nesterov(lr=0.7, momentum=0.9))))
        out = tmp_path / name
        execution = await ParameterServerExecutor(nodes["ps"], out, device=device).execute(
            "agg", spec, "sched")
        results = nodes["w0"].consume_pushes(lambda push: push.resource["resource"] == "results")
        got = []
        for r in range(2):
            sends = list(zip(workers, files[r], samples))
            if r == 0:  # w1 first sends w2's file, then its own: the first is un-folded
                sends.insert(0, ("w1", files[0][2], 55.0))
            for w, path, n in sends:
                await nodes[w].push("ps", {"resource": "updates", "name": path.name, "round": r,
                                           "num_samples": n}, path)
            push = await results.next(timeout=60)
            await push.save_to(out / f"got-{r}.safetensors")
            got.append(load_file(out / f"got-{r}.safetensors"))
        status = await asyncio.wait_for(execution.wait(), 60)
        for n in nodes.values():
            await n.stop()
        assert status.state == "completed", status
        return got

    host, card = asyncio.run(serve("cpu", "host")), asyncio.run(serve(cuda, "card"))
    for r, (a, b) in enumerate(zip(host, card)):
        assert set(a) == set(b) and a
        for k in a:
            assert a[k].dtype == b[k].dtype == torch.float32, (r, k)
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), (r, k)


def test_parked_notify_broadcasts_first_on_the_card(cuda, tmp_path):
    """A durable parameter server of a scheduler-recoverable job (the
    adoption grace set) whose round-1 UPDATED fails twice, as across a
    scheduler outage: on the card as on the CPU the round's broadcast goes
    out before the notify is answered, and the three rounds' updates are
    equal bit for bit."""
    import asyncio

    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.executor.serialization import load_file
    from hypha_tpu_torch.network import MemoryTransport, Node
    from hypha_tpu_torch.network.node import RequestError
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor

    workers, samples = ("w0", "w1", "w2"), (300.0, 101.0, 7.0)
    files = {r: _delta_files(tmp_path, 10 + r) for r in range(3)}

    async def serve(device, name):
        hub = MemoryTransport()
        nodes = {p: Node(hub.shared(), peer_id=p) for p in ("ps", "sched", *workers)}
        for n in nodes.values():
            await n.start()
        for x in nodes.values():
            for y in nodes.values():
                if x is not y:
                    x.add_peer_addr(y.peer_id, y.listen_addrs[0])
        events, fails = [], [2]

        async def on_progress(peer, p):
            events.append(("notified", p.round))
            return m.ProgressResponse(kind=m.ProgressResponseKind.DONE if p.round >= 2
                                      else m.ProgressResponseKind.OK)

        nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
        request = nodes["ps"].request

        async def outage(peer, protocol, msg, **kw):
            if protocol == m.PROTOCOL_PROGRESS and msg.round == 1 and fails[0]:
                fails[0] -= 1
                raise RequestError("scheduler down")
            return await request(peer, protocol, msg, **kw)

        nodes["ps"].request = outage
        out = tmp_path / name
        spec = m.JobSpec(job_id="agg", executor=m.Executor(
            kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
                updates=m.Receive(m.Reference.from_peers(list(workers), "updates")),
                results=m.Send(m.Reference.from_peers(["w0"], "results")),
                optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=3,
                checkpoint_dir=str(out / "ckpt"), adopt_grace_s=30.0)))
        ps = ParameterServerExecutor(nodes["ps"], out, device=device)
        broadcast = ps._broadcast

        async def noted(cfg, path, round_num, *a, **kw):
            events.append(("broadcast", round_num))
            return await broadcast(cfg, path, round_num, *a, **kw)

        ps._broadcast = noted
        execution = await ps.execute("agg", spec, "sched")
        results = nodes["w0"].consume_pushes(lambda push: push.resource["resource"] == "results")
        got = []
        for r in range(3):
            for w, path, n in zip(workers, files[r], samples):
                await nodes[w].push("ps", {"resource": "updates", "name": path.name, "round": r,
                                           "num_samples": n}, path)
            push = await results.next(timeout=60)
            await push.save_to(out / f"got-{r}.safetensors")
            got.append(load_file(out / f"got-{r}.safetensors"))
        status = await asyncio.wait_for(execution.wait(), 60)
        for n in nodes.values():
            await n.stop()
        assert status.state == "completed", status
        return got, events

    (host, host_events), (card, card_events) = (asyncio.run(serve("cpu", "host")),
                                                asyncio.run(serve(cuda, "card")))
    assert card_events == host_events == [("notified", 0), ("broadcast", 0), ("broadcast", 1),
                                          ("notified", 1), ("notified", 2), ("broadcast", 2)]
    for r, (a, b) in enumerate(zip(host, card)):
        assert set(a) == set(b) and a
        for k in a:
            assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), (r, k)


@pytest.mark.parametrize("codec,chunk", [("int8", 4096), ("int8", 7), ("int4", 4096), ("int4", 6)])
def test_quantize_on_the_card_equals_the_cpu(cuda, codec, chunk):
    """compress.quantize / dequantize on the card: the CPU's bytes over odd
    lengths, a zero chunk, NaN and Inf chunks and .5 ties."""
    from hypha_tpu_torch.compress import dequantize, quantize

    rng = np.random.default_rng(chunk)
    qmax = {"int8": 127, "int4": 7}[codec]
    cases = [np.float32([0.3]), (rng.standard_normal(5 * chunk + 3) * 1e-3).astype(np.float32),
             np.arange(-2 * qmax, 2 * qmax + 1, dtype=np.float32) / 2]
    a = (rng.standard_normal(4 * chunk + 1) * 3).astype(np.float32)
    a[:chunk], a[chunk + 1], a[2 * chunk] = 0.0, np.nan, -np.inf
    cases.append(a)
    for x in cases:
        t = torch.from_numpy(x)
        hp, hs = quantize(t, codec, chunk)
        cp, cs = quantize(t.to(cuda), codec, chunk)
        assert cp.is_cuda and torch.equal(cp.cpu(), hp) and torch.equal(cs.cpu(), hs)
        hd = dequantize(hp, hs, x.size, codec, chunk)
        cd = dequantize(cp, cs, x.size, codec, chunk)
        assert torch.equal(cd.cpu().view(torch.int32), hd.view(torch.int32))


def test_parameter_server_folds_int8_stream_frames_on_the_card(cuda, tmp_path):
    """The port's stream loop (int8, two fragments, two workers, four
    rounds) on the card and on the CPU: the broadcast HQD1 frames are the
    same bytes, and the server's round sums were folded on the card."""
    import asyncio

    from hypha_tpu_torch import compress
    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.network import MemoryTransport, Node
    from hypha_tpu_torch.stream import RoundAccum, partition_names
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor

    workers, samples, F, rounds = ("w0", "w1"), (300.0, 7.0), 2, 4
    shapes = {"params/embed_tokens": (512, 64), "params/layers_0/mlp/down_proj/kernel": (96, 64),
              "params/norm/weight": (64,), "params/layers_0/self_attn/q_proj/kernel": (64, 64)}
    parts = partition_names({n: int(np.prod(s)) for n, s in shapes.items()}, F)
    rng = np.random.default_rng(2)
    efs = {(w, f): compress.ErrorFeedback() for w in workers for f in range(F)}
    frames = {}
    for r in range(rounds):
        for w in workers:
            tag = m.FragmentTag(round=r, fragment_id=r % F, fragments=F).header()
            tree = {n: torch.from_numpy(rng.standard_normal(shapes[n]).astype(np.float32) * 1e-2)
                    for n in parts[r % F]}
            path = tmp_path / f"delta-{w}-{r}"
            compress.write_delta(path, tree, "int8", ef=efs[(w, r % F)], tag=tag)
            frames[(w, r)] = (path, tag)
    devices: list = []
    fold = RoundAccum.fold

    def noted_fold(self, *args, **kw):
        devices.append(self.device.type)
        return fold(self, *args, **kw)

    async def serve(device, name):
        hub = MemoryTransport()
        nodes = {p: Node(hub.shared(), peer_id=p) for p in ("ps", "sched", *workers)}
        for n in nodes.values():
            await n.start()
        for x in nodes.values():
            for y in nodes.values():
                if x is not y:
                    x.add_peer_addr(y.peer_id, y.listen_addrs[0])

        async def on_progress(peer, p):
            return m.ProgressResponse(kind=m.ProgressResponseKind.DONE if p.round >= rounds - 1
                                      else m.ProgressResponseKind.OK)

        nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
        spec = m.JobSpec(job_id="agg", executor=m.Executor(
            kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
                updates=m.Receive(m.Reference.from_peers(list(workers), "updates")),
                results=m.Send(m.Reference.from_peers(["w0"], "results")),
                optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=len(workers),
                delta_codec="int8", sync_mode="stream", fragments=F)))
        out = tmp_path / name
        execution = await ParameterServerExecutor(nodes["ps"], out, device=device).execute(
            "agg", spec, "sched")
        results = nodes["w0"].consume_pushes(lambda push: push.resource["resource"] == "results")
        for r in range(rounds):
            for w, n in zip(workers, samples):
                path, tag = frames[(w, r)]
                await nodes[w].push("ps", {"resource": "updates", "name": path.name,
                                           "num_samples": n, **tag}, path)
        got = {}
        for _ in range(rounds):
            push = await results.next(timeout=60)
            dest = out / f"got-{push.resource['round']}"
            await push.save_to(dest)
            got[push.resource["round"]] = dest.read_bytes()
        status = await asyncio.wait_for(execution.wait(), 60)
        for n in nodes.values():
            await n.stop()
        assert status.state == "completed", status
        return got

    RoundAccum.fold = noted_fold
    try:
        host = asyncio.run(serve("cpu", "host"))
        devices.clear()
        card = asyncio.run(serve(cuda, "card"))
    finally:
        RoundAccum.fold = fold
    assert devices == ["cuda"] * (rounds * len(workers))
    assert sorted(host) == sorted(card) == list(range(rounds))
    for r in range(rounds):
        assert card[r][:4] == b"HQD1" and card[r] == host[r], r


# ------------------------------------------------------ the node CLI on the card


class _LogLines:
    """Collect the messages of every log record while open."""

    def __init__(self) -> None:
        import logging

        self.lines: list = []
        self._handler = logging.Handler()
        self._handler.emit = lambda record: self.lines.append(record.getMessage())
        self._root = logging.getLogger()

    def __enter__(self):
        import logging

        self._level = self._root.level
        self._root.setLevel(logging.INFO)
        self._root.addHandler(self._handler)
        return self

    def __exit__(self, *exc) -> None:
        self._root.removeHandler(self._handler)
        self._root.setLevel(self._level)

    def json_after(self, marker: str) -> list:
        import json

        return [json.loads(line.split(marker, 1)[1]) for line in self.lines if marker in line]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _conf(cls, **over):
    from hypha_tpu_torch import config as tcfg

    return tcfg.builder(cls).with_overrides(over).build().validate().value


# A tiny Llama the kernels take (head_dim 64): 4 heads of 64, 2 layers; a
# 512-position window, so the serving pool (max_len 512, prefill chunk 64)
# has room for a prompt, its new tokens and the resume slack.
TINY_CONFIG = {"hidden_size": 256, "max_seq_len": 512}
CLI_TINY = {"job.model_family": "llama", "job.model_preset": "tiny",
            "job.model_type": "causal-lm", "job.model_config": TINY_CONFIG}


async def _cli_train(root, device) -> object:
    """The CLI runners (gateway, data node, a worker whose trainer is a
    process of its own, a worker hosting the parameter server, and the
    scheduler's train kind) in one event loop: a 2-round DiLoCo job."""
    import asyncio

    from hypha_tpu_torch import cli
    from hypha_tpu_torch.executor.serialization import save_file
    from hypha_tpu_torch.node_config import (
        DataNodeConfig, GatewayConfig, SchedulerConfig, WorkerConfig,
    )

    data = root / "data"
    data.mkdir()
    g = torch.Generator().manual_seed(3)
    for i in range(4):
        ids = ((torch.randint(0, 64, (8, 1), generator=g) + torch.arange(128)) % 64)
        save_file({"input_ids": ids.to(torch.int32)}, data / f"slice_{i}.safetensors")
    gw = f"127.0.0.1:{_free_port()}"
    net = {"network.gateways": [gw]}
    confs = [
        (cli._run_gateway, _conf(GatewayConfig, **{"network.listen": [gw]}), {}),
        (cli._run_data, _conf(DataNodeConfig, datasets={"counting": str(data)}, **net), {}),
        (cli._run_worker, _conf(WorkerConfig, name="w0", work_root=str(root / "w0"), **net,
                                **{"resources.gpu": 1, "resources.cpu": 8,
                                   "resources.memory": 65536, "offer.strategy": "whole",
                                   "executor.runtime": "process"}), {"device": device}),
        (cli._run_worker, _conf(WorkerConfig, name="psw", work_root=str(root / "ps"), **net,
                                **{"resources.cpu": 8, "resources.memory": 65536}),
         {"device": device}),
    ]
    sched = _conf(SchedulerConfig, **net, **CLI_TINY, **{
        "job.dataset": "counting", "job.update_rounds": 2,
        "job.avg_samples_between_updates": 8, "job.max_batch_size": 2, "job.num_workers": 1,
        "job.worker_gpu": 0.5, "job.inner_lr": 3e-3, "job.worker_memory": 10,
        "job.ps_memory": 10})
    stops = [asyncio.Event() for _ in confs]
    tasks = []
    try:
        for (run, conf, kw), stop in zip(confs, stops):
            tasks.append(asyncio.create_task(run(conf, stop=stop, **kw)))
            await asyncio.sleep(0.5)
        await asyncio.sleep(3.0)  # the workers join the gossip mesh before the auction
        return await asyncio.wait_for(cli._run_scheduler(sched), 600)
    finally:
        for stop, task in zip(reversed(stops), reversed(tasks)):
            stop.set()
            await asyncio.wait_for(task, 60)


async def _cli_serve(root, device, prompts, n_new) -> list:
    """The CLI runners' serve kind: a gateway, a worker and the scheduler's
    serving supervisor; the answers of ``generate_remote`` over loopback."""
    import asyncio

    from hypha_tpu_torch import cli
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.node_config import GatewayConfig, SchedulerConfig, WorkerConfig
    from hypha_tpu_torch.worker.infer_executor import generate_remote

    gw = f"127.0.0.1:{_free_port()}"
    net = {"network.gateways": [gw]}
    confs = [
        (cli._run_gateway, _conf(GatewayConfig, **{"network.listen": [gw]}), {}),
        (cli._run_worker, _conf(WorkerConfig, name="w0", work_root=str(root), **net,
                                **{"resources.gpu": 1, "offer.strategy": "whole"}),
         {"device": device}),
        (cli._run_scheduler, _conf(SchedulerConfig, **net, **CLI_TINY, **{
            "job.kind": "serve", "job.serve_name": "tiny", "job.model_seed": 4,
            "job.serve_max_batch": 4, "job.serve_block_size": 16, "job.serve_ragged": True,
            "job.serve_max_new_tokens": 32}), {}),
    ]
    stops = [asyncio.Event() for _ in confs]
    tasks = []
    client = Node(TcpTransport(), peer_id="client", bootstrap=[gw])
    try:
        for (run, conf, kw), stop in zip(confs, stops):
            tasks.append(asyncio.create_task(run(conf, stop=stop, **kw)))
            await asyncio.sleep(0.3)
        await client.start(["127.0.0.1:0"])
        await client.wait_for_bootstrap()
        return list(await asyncio.wait_for(asyncio.gather(*(
            generate_remote(client, "tiny", [p], n) for p, n in zip(prompts, n_new))), 300))
    finally:
        await client.stop()
        for stop, task in zip(reversed(stops), reversed(tasks)):
            stop.set()
            await asyncio.wait_for(task, 60)


def test_cli_runners_train_through_the_flash_kernels(cuda):
    """The scheduler's train kind through the CLI runners on the card: the
    trainer process logs its attention launches, all through the flash
    kernels."""
    import asyncio
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(tempfile.mkdtemp(prefix="tc"))  # bridge sockets: paths under 108 bytes
    try:
        with _LogLines() as logs:
            result = asyncio.run(_cli_train(root, "cuda"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == 2
    losses = [m["loss"] for _peer, _round, m in result.metrics if "loss" in m]
    assert losses and all(np.isfinite(losses))
    (launches,) = logs.json_after("attention launches: ")
    assert launches["fwd"] > 0 and launches["dq"] > 0 and launches["dkv"] > 0, launches
    assert launches["fwd"] % 2 == 0 and launches["flash_plain"] == 0 and launches["dense"] == 0


def test_cli_serve_job_answers_through_the_ragged_kernel(cuda):
    """The scheduler's serve kind through the CLI runners on the card: the
    answers over loopback equal the in-process pool's on the same model,
    and the worker's launch line counts the mma and decode routes of the
    ragged kernel, in multiples of the 2 layers, and no plain call."""
    import asyncio
    import shutil
    import tempfile
    from pathlib import Path

    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.worker.infer_executor import load_model

    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8] * 6, [9] * 40, [(i * 7 + 3) % 200 + 1 for i in range(90)]]
    n_new = [12, 30, 20, 25]
    root = Path(tempfile.mkdtemp(prefix="ts"))  # unix socket paths under 108 bytes
    try:
        with _LogLines() as logs:
            got = asyncio.run(_cli_serve(root, "cuda", prompts, n_new))
        left = list(root.iterdir())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    model = load_model({"family": "llama", "preset": "tiny", "config": TINY_CONFIG, "seed": 4},
                       device="cuda")
    pool = DecodePool(model, slots=4, max_len=512, steps_per_call=8, block_size=16, ragged=True)
    try:
        want = [pool.submit([p], n).result(timeout=300) for p, n in zip(prompts, n_new)]
    finally:
        pool.close()
    assert got == want
    assert not left
    # The worker logs its counts each time it goes idle and when the job
    # ends; the last line holds the job's totals.
    lc = logs.json_after("serve launches: ")[-1]
    assert lc["mma"] > 0 and lc["decode"] > 0 and lc["mma"] % 2 == 0 and lc["decode"] % 2 == 0, lc
    assert lc["plain"] == 0 and lc["fallbacks"] == 0 and lc["requests"] == len(prompts)


def test_mtls_and_signed_gossip_on_the_card_machine(cuda, tmp_path):
    """The card machine's OpenSSL takes the port's Ed25519 certificates in
    TLS 1.3: a PKI from the port's certutil, an mTLS RPC each way between
    two port nodes (peer ids from the certificates), a signed gossip frame
    each way verified by the port's Ed25519, and a revoked node refused."""
    import asyncio
    import ssl

    from hypha_tpu_torch import certs, certutil
    from hypha_tpu_torch.messages import PROTOCOL_HEALTH, HealthRequest, HealthResponse
    from hypha_tpu_torch.network import FrameError
    from hypha_tpu_torch.network.secure import secure_node

    for args in (["root"], ["org", "--name", "o"], ["node", "--org", "o", "--name", "a"],
                 ["node", "--org", "o", "--name", "b"], ["node", "--org", "o", "--name", "x"],
                 ["revoke", "--org", "o", "--cert", str(tmp_path / "x.crt")]):
        assert certutil.main([args[0], "--out", str(tmp_path), *args[1:]]) == 0
    crl = tmp_path / "o.crl"

    def node(name):
        return secure_node(tmp_path / f"{name}.crt", tmp_path / f"{name}.key",
                           tmp_path / "trust.crt", crl)

    async def main():
        a, b, x = node("a"), node("b"), node("x")
        for n in (a, b, x):
            await n.start(["127.0.0.1:0"])
        try:
            for n in (a, b):
                n.on(PROTOCOL_HEALTH, HealthRequest).respond_with(
                    lambda peer, msg: _healthy(peer))
            assert await a.dial(b.listen_addrs[0]) == b.peer_id
            assert b.peer_id == certs.peer_id_from_cert_pem((tmp_path / "b.crt").read_bytes())
            assert (await a.request(b.peer_id, PROTOCOL_HEALTH, HealthRequest())).healthy
            assert (await b.request(a.peer_id, PROTOCOL_HEALTH, HealthRequest())).healthy
            a.add_gossip_peer(b.peer_id)
            b.add_gossip_peer(a.peer_id)
            for pub, sub_node in ((a, b), (b, a)):
                sub = await sub_node.subscribe("ads")
                await pub.publish("ads", {"from": pub.peer_id})
                origin, msg = await asyncio.wait_for(sub.__anext__(), 10)
                assert origin == pub.peer_id and msg == {"from": pub.peer_id}
                await sub.close()
            assert a.gossip_counts["verified"] == b.gossip_counts["verified"] == 1
            with pytest.raises((ssl.SSLError, ConnectionError, OSError, FrameError)):
                await x.dial(a.listen_addrs[0])
        finally:
            for n in (a, b, x):
                await n.stop()
        return ssl.OPENSSL_VERSION

    async def _healthy(peer):
        return HealthResponse(healthy=True)

    print(asyncio.run(asyncio.wait_for(main(), 60)))


def test_checkpoint_from_the_card_resumes_bit_equal(cuda, tmp_path):
    """A tiny Llama trained on the card through the flash kernels: 3 steps,
    a checkpoint of params and optimizer state from the card's tensors, 3
    more steps; a fresh model restored from that checkpoint and given the
    same 3 batches ends bit-equal to the uninterrupted one."""
    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.executor import checkpoint as ckpt
    from hypha_tpu_torch.executor.train import build_optimizer, make_train_step
    from hypha_tpu_torch.models.registry import build_model
    from hypha_tpu_torch.ops.flash_attention import flash_attention

    spec = {"family": "llama", "preset": "tiny", "config": TINY_CONFIG}
    g = torch.Generator().manual_seed(9)
    batches = [{"input_ids": torch.randint(0, 256, (2, 64), generator=g).to(cuda)}
               for _ in range(6)]

    def trainer(seed):
        model, _ = build_model(spec, device=cuda, attn_impl=flash_attention)
        model.init_weights(seed)
        opt = build_optimizer(list(model.parameters()), m.Adam(lr=3e-3, weight_decay=0.01))
        return model, opt, make_train_step(model, opt)

    model, opt, step = trainer(0)
    for b in batches[:3]:
        step(b)
    ckpt.save_train_checkpoint(tmp_path, *ckpt.train_state(model, opt), opt.count, 1)
    for b in batches[3:]:
        step(b)
    fresh, fresh_opt, fresh_step = trainer(1)
    params, opt_state, step_n, rnd, _ = ckpt.load_train_checkpoint(
        tmp_path, *ckpt.train_state(fresh, fresh_opt))
    ckpt.restore_train_state(fresh, fresh_opt, params, opt_state)
    assert (step_n, rnd, fresh_opt.count) == (3, 1, 3)
    for b in batches[3:]:
        fresh_step(b)
    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert all(torch.equal(a, b) for a, b in zip(opt.mu + opt.nu, fresh_opt.mu + fresh_opt.nu))


def test_outer_step_replayed_from_the_journal_gives_the_stored_wire(cuda, tmp_path, monkeypatch):
    """The port's durable parameter server on the card (int8 broadcasts,
    a checkpoint every 2 rounds) killed in round 1 and restarted on its
    journal: it re-runs round 0's outer step and encode from the journaled
    folds, and the wire it stores equals the one the first run stored, byte
    for byte; the job then completes."""
    import asyncio
    import hashlib

    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.ft import durable
    from hypha_tpu_torch.network import MemoryTransport, Node
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor

    stored = []
    real = durable.DurablePS.store_wire

    def hashed(self, round_num, wire_src):
        stored.append((self.generation, round_num,
                       hashlib.sha256(wire_src.read_bytes()).hexdigest()))
        return real(self, round_num, wire_src)

    monkeypatch.setattr(durable.DurablePS, "store_wire", hashed)
    workers, samples = ("w0", "w1", "w2"), (300.0, 101.0, 7.0)
    files = {r: _delta_files(tmp_path, r) for r in range(2)}

    async def main():
        hub = MemoryTransport()
        nodes = {p: Node(hub.shared(), peer_id=p) for p in ("ps", "sched", *workers)}
        for n in nodes.values():
            await n.start()
        for x in nodes.values():
            for y in nodes.values():
                if x is not y:
                    x.add_peer_addr(y.peer_id, y.listen_addrs[0])

        async def on_progress(peer, p):
            return m.ProgressResponse(kind=m.ProgressResponseKind.DONE if p.round
                                      else m.ProgressResponseKind.OK)

        nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
        spec = m.JobSpec(job_id="agg", executor=m.Executor(
            kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
                updates=m.Receive(m.Reference.from_peers(list(workers), "updates")),
                results=m.Send(m.Reference.from_peers(["w0"], "results")),
                optimizer=m.Nesterov(lr=0.7, momentum=0.9), delta_codec="int8",
                checkpoint_dir=str(tmp_path / "ckpt"), ps_checkpoint_every_rounds=2)))
        results = nodes["w0"].consume_pushes(lambda push: push.resource["resource"] == "results")
        execution = await ParameterServerExecutor(nodes["ps"], tmp_path / "a", device=cuda).execute(
            "agg", spec, "sched")
        for r in range(2):
            for w, path, n in zip(workers, files[r], samples):
                await nodes[w].push("ps", {"resource": "updates", "name": path.name, "round": r,
                                           "num_samples": n}, path)
                if r == 1 and w == "w0":  # kill the server with one round-1 delta journaled
                    await asyncio.sleep(0.5)
                    await execution.cancel()
                    execution = await ParameterServerExecutor(
                        nodes["ps"], tmp_path / "b", device=cuda).execute("agg", spec, "sched")
            while True:  # the round's update (skipping the resync and the re-broadcast)
                push = await results.next(timeout=60)
                await push.read_all()
                meta = push.resource
                if not meta.get("ps_resync") and meta["round"] == r and \
                        meta.get("ps_generation") == (1 if r == 0 else 2):
                    break
        status = await asyncio.wait_for(execution.wait(), 60)
        for n in nodes.values():
            await n.stop()
        return status

    status = asyncio.run(main())
    assert status.state == "completed", status
    round0 = [(g, h) for g, r, h in stored if r == 0]
    assert [g for g, _ in round0] == [1, 2] and round0[0][1] == round0[1][1], stored


def test_durable_stream_shard_replay_on_the_card_gives_the_live_wire(cuda, tmp_path, monkeypatch):
    """Shard 1 of 2 under stream sync (2 fragments, int8, elastic and
    durable) on the card: round 1 takes a member's failed-over direct delta,
    then its reducer's partial covering it (the direct one un-folded), then
    the reducer's own delta; the shard is killed with round 3's first delta
    journaled and restarted on its journal. The round-1 wire it re-encodes
    from the journal equals the live one byte for byte, and the job
    completes."""
    import asyncio
    import hashlib

    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.ft import durable
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor

    stored = []
    real = durable.DurablePS.store_wire

    def hashed(self, round_num, wire_src):
        stored.append((self.generation, round_num,
                       hashlib.sha256(wire_src.read_bytes()).hexdigest()))
        return real(self, round_num, wire_src)

    monkeypatch.setattr(durable.DurablePS, "store_wire", hashed)
    files = {r: _delta_files(tmp_path, r) for r in (1, 3)}
    workers = ["red", "w1", "w2"]  # red reduces the group and pushes its own delta

    async def main():
        nodes = await _memory_mesh(["ps", "sched", "red", "w1"])

        async def on_progress(peer, p):
            return m.ProgressResponse(kind=m.ProgressResponseKind.DONE if p.round >= 3
                                      else m.ProgressResponseKind.OK)

        nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
        spec = m.JobSpec(job_id="agg-s1", executor=m.Executor(
            kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
                updates=m.Receive(m.Reference.from_peers(workers, "updates.s1")),
                results=m.Send(m.Reference.from_peers(["w1"], "results")),
                optimizer=m.Nesterov(lr=0.7, momentum=0.9), delta_codec="int8",
                num_workers=3, quorum_fraction=0.5, round_deadline_s=60.0,
                sync_mode="stream", fragments=2, shard_index=1, num_ps_shards=2,
                checkpoint_dir=str(tmp_path / "ckpt"), ps_checkpoint_every_rounds=2)))
        results = nodes["w1"].consume_pushes(lambda push: push.resource["resource"] == "results")

        def header(r, name, samples, **extra):
            return {"resource": "updates.s1", "name": name, "round": r, "num_samples": samples,
                    "shard": 1, **extra}

        partial = {"prefold": True, "covers": ["w1", "w2"]}
        execution = await ParameterServerExecutor(nodes["ps"], tmp_path / "a", device=cuda).execute(
            "agg-s1", spec, "sched")
        sends = {1: [("w1", header(1, "d", 4.0), files[1][1]),
                     ("red", header(1, "p", 8.0, **partial), files[1][2]),
                     ("red", header(1, "r", 4.0), files[1][0])],
                 3: [("red", header(3, "r", 4.0), files[3][0]),
                     ("red", header(3, "p", 8.0, **partial), files[3][2])]}
        for r in (1, 3):
            for i, (peer, head, path) in enumerate(sends[r]):
                await nodes[peer].push("ps", head, path)
                if r == 3 and i == 0:  # kill the shard with round 3's first delta journaled
                    await asyncio.sleep(0.5)
                    await execution.cancel()
                    execution = await ParameterServerExecutor(
                        nodes["ps"], tmp_path / "b", device=cuda).execute("agg-s1", spec, "sched")
            while True:  # the round's update, skipping the resync and the re-broadcast
                push = await results.next(timeout=60)
                await push.read_all()
                meta = push.resource
                if not meta.get("ps_resync") and meta["round"] == r and \
                        meta.get("ps_generation") == (1 if r == 1 else 2):
                    break
        status = await asyncio.wait_for(execution.wait(), 60)
        for n in nodes.values():
            await n.stop()
        return status

    status = asyncio.run(main())
    assert status.state == "completed", status
    round1 = [(g, h) for g, r, h in stored if r == 1]
    assert [g for g, _ in round1] == [1, 2] and round1[0][1] == round1[1][1], stored


def test_rejoin_catchup_union_on_the_card_equals_the_cpu(cuda, tmp_path):
    """A stream rejoiner under two shards merges both catch-ups (each Σ over
    its own tensors) into θ₀ on the card and on the CPU: the same θ bit for
    bit, and it enters at the lesser of the shards' rounds."""
    import contextlib

    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.executor.serialization import save_file
    from hypha_tpu_torch.executor.training import _rejoin
    from hypha_tpu_torch.models.convert import state_to_flat
    from hypha_tpu_torch.models.registry import build_model

    spec = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
            "config": {"dtype": "float32"}, "seed": 0}
    cpu_model, _ = build_model(spec, device="cpu")
    cpu_model.init_weights(0)
    flat = state_to_flat(cpu_model, cpu_model.state_dict())
    names = sorted(flat)
    g = torch.Generator().manual_seed(3)
    sums = [{n: torch.randn(flat[n].shape, generator=g) * 1e-2 for n in names[k::2]}
            for k in (0, 1)]
    cfg = m.TrainExecutorConfig(
        model=spec, data=m.Fetch(m.Reference.from_uri("file:///unused")),
        updates=m.Send(m.Reference.from_peers(["a"], "u")),
        results=m.Receive(m.Reference.from_peers(["a", "b"], "r")),
        optimizer=m.Adam(lr=1e-3), batch_size=2, sync_mode="stream", fragments=2,
        ps_shards=m.ShardMap(shards=["a", "b"], tags=["u.s0", "u.s1"], fragments=2))

    class Session:
        def __init__(self, work):
            self.events = []
            for k, (rnd, tree) in enumerate(zip((4, 3), sums)):
                save_file(tree, work / f"c{k}.safetensors")
                self.events.append({"path": f"c{k}.safetensors",
                                    "meta": {"catchup": True, "round": rnd, "shard": k}})

        def receive(self, ref):
            return contextlib.nullcontext(iter(self.events))

    out = {}
    for where, dev in (("host", torch.device("cpu")), ("card", cuda)):
        work = tmp_path / where
        work.mkdir()
        model, _ = build_model(spec, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        params = model.state_dict()
        anchor = {k: v.detach().clone() for k, v in params.items()}
        rnd = _rejoin(Session(work), cfg, work, model, params, anchor, dev)
        out[where] = (rnd, {k: v.cpu() for k, v in state_to_flat(model, params).items()})
    (rc, tc), (rg, tg) = out["host"], out["card"]
    assert rc == rg == 3
    for n in names:
        assert torch.equal(tc[n], tg[n]), n
        assert not torch.equal(tc[n], flat[n]), n


async def _memory_mesh(peer_ids):
    from hypha_tpu_torch.network import MemoryTransport, Node

    hub = MemoryTransport()
    nodes = {p: Node(hub.shared(), peer_id=p) for p in peer_ids}
    for n in nodes.values():
        await n.start()
    for x in nodes.values():
        for y in nodes.values():
            if x is not y:
                x.add_peer_addr(y.peer_id, y.listen_addrs[0])
    return nodes


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_group_reducer_partial_on_the_card_equals_the_cpu(cuda, tmp_path, codec):
    """A GroupReducer folding three members' deltas (f32 and bf16 files, or
    int8 frames; one member re-sends, so its first delta is un-folded) on
    the card and on the CPU: every partial the shard receives is the same
    file, the int8 frames with their error-feedback residual included."""
    import asyncio
    import types

    from hypha_tpu_torch import compress
    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.executor.serialization import load_file
    from hypha_tpu_torch.stream.reduce import GroupReducer

    members, samples = ("w1", "w2", "w3"), (300.0, 101.0, 7.0)
    files = {r: _delta_files(tmp_path, 10 + r) for r in range(2)}
    if codec == "int8":
        for r, paths in files.items():
            for i, path in enumerate(paths):
                frame = path.with_suffix(".hqd1")
                compress.write_delta(frame, {k: v.float() for k, v in load_file(path).items()},
                                     "int8", tag={"round": r, "fragment_id": 0, "fragments": 2})
                paths[i] = frame

    async def reduce(device, name):
        nodes = await _memory_mesh(["red", "ps0", "ps1", *members])
        smap = m.ShardMap(round=0, shards=["ps0", "ps1"], tags=["u.s0", "u.s1"], fragments=2,
                          groups=[["red", *members]])
        cfg = types.SimpleNamespace(ps_shards=smap, reduce_members=list(members), reduce_via=None,
                                    delta_codec=codec, delta_dtype="float32", sync_mode="blocking")
        red = GroupReducer(nodes["red"], cfg, work_dir=tmp_path / name, device=device)
        red.start()
        got = []
        for r in range(2):
            sends = list(zip(members, files[r], samples))
            if r == 0:  # w1 first sends w3's file, then its own
                sends.insert(0, ("w1", files[0][2], 55.0))
            for w, path, n in sends:
                await nodes[w].push("red", {"resource": "u.s0", "name": path.name, "round": r,
                                            "num_samples": n, "shard": 0, "fragment_id": 0,
                                            "fragments": 2}, path)
                await asyncio.sleep(0.3)  # arrivals in this order
            for _ in range(600):  # the round's partial: every member in
                if red.partials > r:
                    break
                await asyncio.sleep(0.1)
            while len(got) < red.partials:
                push = await nodes["ps0"].next_push(timeout=60)
                dest = tmp_path / f"{name}-{len(got)}"
                await push.save_to(dest)
                got.append((dict(push.resource), dest.read_bytes()))
        await red.stop()
        for n in nodes.values():
            await n.stop()
        return got, (red.folds, red.unfolds)

    host, card = asyncio.run(reduce("cpu", "host")), asyncio.run(reduce(cuda, "card"))
    assert host[1] == card[1] and host[1][1] == 1
    assert len(host[0]) == len(card[0]) >= 2
    for (hh, hb), (ch, cb) in zip(host[0], card[0]):
        assert hh == ch and hh["prefold"] is True
        assert hb == cb, hh


def test_two_shards_on_the_card_equal_one_server(cuda, tmp_path):
    """Two parameter-server shards (blocking, each its own part of the
    tree) and one server over the whole tree, all on the card, fed the
    same deltas for two rounds: every tensor of every update is equal bit
    for bit."""
    import asyncio

    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.executor.serialization import load_file, save_file
    from hypha_tpu_torch.stream import partition_names
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor

    workers, samples = ("w0", "w1", "w2"), (300.0, 101.0, 7.0)
    files = {r: _delta_files(tmp_path, 20 + r) for r in range(2)}
    first = load_file(files[0][0])
    parts = partition_names({k: v.numel() for k, v in first.items()}, 2)
    split = {}
    for r, paths in files.items():
        for i, path in enumerate(paths):
            tree = load_file(path)
            for p, names in enumerate(parts):
                split[(r, i, p)] = save_file({n: tree[n] for n in names},
                                             tmp_path / f"part-{r}-{i}-{p}.safetensors")

    async def serve(shards):
        names = [f"ps{k}" for k in range(shards)]
        nodes = await _memory_mesh([*names, "sched", *workers])

        async def on_progress(peer, p):
            return m.ProgressResponse(kind=m.ProgressResponseKind.DONE if p.round
                                      else m.ProgressResponseKind.OK)

        nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
        executions = []
        for k, name in enumerate(names):
            extra = {"shard_index": k, "num_ps_shards": shards} if shards > 1 else {}
            spec = m.JobSpec(job_id=f"agg-{name}", executor=m.Executor(
                kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
                    updates=m.Receive(m.Reference.from_peers(list(workers), f"u{k}")),
                    results=m.Send(m.Reference.from_peers(["w0"], "results")),
                    optimizer=m.Nesterov(lr=0.7, momentum=0.9), **extra)))
            executions.append(await ParameterServerExecutor(
                nodes[name], tmp_path / f"s{shards}-{name}", device=cuda).execute(
                    f"agg-{name}", spec, "sched"))
        results = nodes["w0"].consume_pushes(lambda push: push.resource["resource"] == "results")
        got = []
        for r in range(2):
            for i, (w, n) in enumerate(zip(workers, samples)):
                if shards == 1:
                    await nodes[w].push("ps0", {"resource": "u0", "name": "d", "round": r,
                                                "num_samples": n}, files[r][i])
                    continue
                for p in range(2):
                    await nodes[w].push(f"ps{p}", {
                        "resource": f"u{p}", "name": "d", "round": r, "num_samples": n,
                        "shard": p, "fragment_id": p, "fragments": 2}, split[(r, i, p)])
            update = {}
            for _ in range(shards):
                push = await results.next(timeout=60)
                dest = tmp_path / f"got-{shards}-{r}-{len(update)}.safetensors"
                await push.save_to(dest)
                update.update(load_file(dest))
            got.append(update)
        states = [(await asyncio.wait_for(e.wait(), 60)).state for e in executions]
        for n in nodes.values():
            await n.stop()
        assert states == ["completed"] * shards
        return got

    one, two = asyncio.run(serve(1)), asyncio.run(serve(2))
    for r in range(2):
        assert set(one[r]) == set(two[r]) == set(first)
        for k in first:
            assert torch.equal(one[r][k].view(torch.int32), two[r][k].view(torch.int32)), (r, k)



def _swap_deltas(model, seed: int, scale: float) -> dict:
    """One seeded f32 update per parameter, in the wire's names and layout
    (kernels ``[in, out]``), on the host."""
    from hypha_tpu_torch.models.convert import flat_names

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (pname, transposed) in flat_names(model).items():
        shape = tuple(model.get_parameter(pname).shape)
        out[f"params/{name}"] = torch.randn(shape[::-1] if transposed else shape,
                                            generator=gen) * scale
    return out


def _host_fold(names: dict, leaves: dict, *deltas) -> dict:
    """``leaves`` (parameter name -> CPU tensor) with each update applied as
    the pool applies it: ``(leaf.float() + u.float()).to(leaf.dtype)``."""
    leaves = dict(leaves)
    for d in deltas:
        for k, u in d.items():
            pname, transposed = names[k.removeprefix("params/")]
            leaf = leaves[pname]
            leaves[pname] = (leaf.float() + (u.T if transposed else u).float()).to(leaf.dtype)
    return leaves


def _wait_round(pool, round_num, timeout=120.0):
    deadline = time.monotonic() + timeout
    while pool.weight_state()[0] != round_num:
        assert time.monotonic() < deadline, pool.weight_state()
        time.sleep(0.01)


def _cpu_leaves(model) -> dict:
    return {p: t.detach().cpu().clone() for p, t in model.named_parameters()}


def test_weight_swap_on_the_card_is_bit_equal_to_the_cpu_fold(cuda):
    """Live weight swap on the card (bf16 leaves; two rounds, a rollback to
    the first, two deferred rounds folded with the undo, the roll-forward):
    the served leaves equal the same updates folded on the CPU, bit for
    bit, and the digest the pool logs is the CPU fold's."""
    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.executor.training import theta_checksum
    from hypha_tpu_torch.models.convert import flat_names
    from hypha_tpu_torch.worker.infer_executor import load_model

    model = load_model({"family": "llama", "preset": "tiny", "config": TINY_CONFIG, "seed": 4},
                       device="cuda")
    assert model.embed_tokens.dtype == torch.bfloat16
    names = flat_names(model)
    us = [_swap_deltas(model, 30 + i, 0.01) for i in range(4)]
    theta0 = _cpu_leaves(model)
    pool = DecodePool(model, slots=2, max_len=64, block_size=16, ragged=True)
    try:
        pool.request_swap(us[0], round_num=1, keep_previous=True)
        _wait_round(pool, 1)
        pool.request_swap(us[1], round_num=2, keep_previous=True)
        _wait_round(pool, 2)
        pool.pin_round(1)
        _wait_round(pool, 1)
        back = _cpu_leaves(model)
        pool.request_swap(us[2], round_num=3)
        pool.request_swap(us[3], round_num=4)
        pool.pin_round(None)
        _wait_round(pool, 4)
        got = _cpu_leaves(model)
        digest = pool.swap_log[-1]["digest"]
    finally:
        pool.close()
    at1 = _host_fold(names, theta0, us[0])
    at2 = _host_fold(names, at1, us[1])
    # The pool's pending sum: the undone round 2 (θ₂ - θ₁ in f32, wire
    # layout), then rounds 3 and 4, each added in f32.
    pend = {}
    for k in us[2]:
        pname, transposed = names[k.removeprefix("params/")]
        undo = at2[pname].float() - at1[pname].float()
        pend[k] = ((undo.T if transposed else undo) + us[2][k]) + us[3][k]
    want = _host_fold(names, at1, pend)
    assert set(back) == set(got) == set(want)
    for p in want:
        assert torch.equal(back[p].view(torch.int16), at1[p].view(torch.int16)), p
        assert torch.equal(got[p].view(torch.int16), want[p].view(torch.int16)), p
    assert digest == theta_checksum({n: want[pname] for n, (pname, _) in names.items()})


def test_weight_swap_under_decode_traffic_serves_the_folded_model(cuda):
    """Requests decode through the ragged kernel while a round flips: none
    fails or comes back short, and after the flip the pool's greedy tokens
    (the ragged kernel's decode and mma routes) equal ``generate`` on the
    CPU-folded weights."""
    from hypha_tpu_torch.executor.generate import generate
    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.models.convert import flat_names
    from hypha_tpu_torch.ops.paged_attention import ragged_paged_attention
    from hypha_tpu_torch.worker.infer_executor import load_model

    spec = {"family": "llama", "preset": "tiny", "config": TINY_CONFIG, "seed": 4}
    model = load_model(spec, device="cuda")
    u1 = _swap_deltas(model, 77, 0.05)
    folded = load_model(spec, device="cuda")
    folded.load_state_dict(_host_fold(flat_names(folded), _cpu_leaves(folded), u1))
    probe = [(i * 7 + 3) % 200 + 1 for i in range(40)]
    pool = DecodePool(model, slots=4, max_len=512, steps_per_call=8, block_size=16, ragged=True)
    try:
        busy = [pool.submit([[3 + i, 1, 4, 1, 5] * (i + 1)], 48) for i in range(3)]
        time.sleep(0.05)
        ragged_paged_attention.decode_launches = ragged_paged_attention.mma_launches = 0
        pool.request_swap(u1, round_num=1)
        _wait_round(pool, 1)
        got = pool.submit([probe], 24).result(timeout=300)
        outs = [f.result(timeout=300) for f in busy]
        launches = (ragged_paged_attention.decode_launches, ragged_paged_attention.mma_launches)
    finally:
        pool.close()
    assert all(len(o[0]) == 48 for o in outs)
    assert launches[0] > 0 and launches[1] > 0, launches
    with torch.inference_mode():
        want = generate(folded, [probe], 24).tolist()
    assert got == want
    assert pool._alloc.generation == 1 and pool.swaps_applied == 1


def test_adaptive_broadcast_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The server's per-link broadcast (``_broadcast_adaptive``) over three
    peers on a base codec of "none": a fast link ships the f32 update
    itself, a mid one int8 then int4 (a switch in round 1), a slow one
    int4, each quantized link on its own residual. On the card and on the
    CPU every wire is byte-equal with the same header, and every residual
    is equal bit for bit."""
    import asyncio
    from pathlib import Path

    from hypha_tpu_torch import messages as m
    from hypha_tpu_torch.executor.serialization import save_file
    from hypha_tpu_torch.ft.adaptive import LinkTable
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor

    class Spy:
        def __init__(self):
            self.pushes = []

        async def push(self, peer, header, source):
            data = Path(source).read_bytes()
            self.pushes.append((peer, dict(header), data))
            return len(data)

    rates = {"fast": (8e8, 8e8), "mid": (5e7, 8e5), "slow": (8e5, 8e5)}
    cfg = m.AggregateExecutorConfig(
        updates=m.Receive(m.Reference.from_peers(list(rates), "u")),
        results=m.Send(m.Reference.from_peers(list(rates), "r")),
        optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=3)
    rng = np.random.default_rng(17)
    updates = [{"b/w": (rng.standard_normal((257, 33)) * 1e-2).astype(np.float32),
                "a/v": rng.standard_normal(4099).astype(np.float32)} for _ in range(2)]

    def broadcast(device, root):
        root.mkdir()
        node = Spy()
        ps = ParameterServerExecutor(node, root, device=device)
        table = LinkTable(base_codec="none", hi_mbps=100.0, lo_mbps=10.0, alpha=1.0)
        efs, out = {}, []
        for r, update in enumerate(updates):
            for peer, rate in rates.items():
                table.observe(peer, 10 ** 6, 8e6 / rate[r])
            path = root / f"update-{r}.safetensors"
            save_file({k: torch.from_numpy(v) for k, v in update.items()}, path)
            node.pushes.clear()
            asyncio.run(ps._broadcast_adaptive(cfg, path, r, None, table, efs, root))
            out.append(sorted(node.pushes, key=lambda x: x[0]))
        return out, {p: {k: v.cpu() for k, v in ef.state().items()} for p, ef in efs.items()}

    host, host_res = broadcast("cpu", tmp_path / "host")
    card, card_res = broadcast(cuda, tmp_path / "card")
    assert card == host
    codecs = [{p: h["codec"] for p, h, _ in pushes} for pushes in card]
    assert codecs == [{"fast": "none", "mid": "int8", "slow": "int4"},
                      {"fast": "none", "mid": "int4", "slow": "int4"}]
    assert set(card_res) == set(host_res) == {"mid", "slow"}
    for p in card_res:
        for k in host_res[p]:
            assert torch.equal(card_res[p][k].view(torch.int32), host_res[p][k].view(torch.int32))


def test_trainer_codec_switch_on_the_card_uploads_the_cpus_bytes(cuda, tmp_path):
    """The trainer's upload across per-link hints (int8, then int4 with
    the residual carried, an equal hint ignored, then none): the same
    seeded Δθ written on the card and on the CPU gives byte-equal files."""
    from hypha_tpu_torch import compress
    from hypha_tpu_torch.executor.training import codec_hint

    rng = np.random.default_rng(23)
    deltas = [{"w": (rng.standard_normal((129, 65)) * 1e-3).astype(np.float32),
               "v": (rng.standard_normal(1001) * 1e-4).astype(np.float32)} for _ in range(4)]
    hints = ["int4", "int4", "none", "none"]

    def uploads(device, root):
        root.mkdir()
        codec, ef, out = "int8", compress.ErrorFeedback(), []
        for r, delta in enumerate(deltas):
            path = root / f"delta-{r}.safetensors"
            compress.write_delta(path, {k: torch.from_numpy(v).to(device) for k, v in delta.items()},
                                 codec, ef=ef if codec in compress.QUANT_CODECS else None)
            out.append((codec, path.read_bytes()))
            hint = codec_hint({"codec": hints[r]}, codec)
            if hint is not None:
                codec = hint
        return out

    host, card = uploads("cpu", tmp_path / "host"), uploads(cuda, tmp_path / "card")
    assert [c for c, _ in card] == ["int8", "int4", "int4", "none"]
    assert card == host
