"""Port parity: the KV cache. int8 row quantization and physical-row
addressing bitwise against hypha_tpu.ops.kvcache, and the paged pools
after a prefill and three decode steps against the JAX decode model's
cache."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DecodePair, paged_script, tiny_pair
from hypha_tpu.ops.kvcache import _physical as j_physical
from hypha_tpu.ops.kvcache import _quantize_rows as j_quant
from hypha_tpu_torch.ops.kvcache import KVCache, _physical, _quantize_rows


def test_quantize_rows_bitwise():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 2, 8)).astype(np.float32) * 3
    x[1] = 0.0  # zero row -> zero scale
    x[2, 0, 3] = np.inf  # non-finite rows -> zero payload, zero scale
    x[3, 1, 0] = np.nan
    x[4, 0] = np.arange(8) - 3.5  # exact half steps: round half to even
    x[5, 1] = 1e-30
    payload, scale = _quantize_rows(torch.from_numpy(x))
    jp, js = j_quant(jnp.asarray(x))
    assert payload.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(payload.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))


def test_physical_bitwise():
    blocks, bs, max_blocks = 9, 4, 5
    table = np.array([[3, 7, 0, 9, 9], [9, 9, 9, 9, 9], [2, 12, -1, 9, 9]], np.int32)
    cols = np.array([[0, 5, 9, 13, 19, 20], [0, 1, 2, 3, 4, 5], [-1, 3, 6, 9, 30, 40]], np.int32)
    got = _physical(torch.from_numpy(table), torch.from_numpy(cols), bs, max_blocks, blocks)
    ref = j_physical(jnp.asarray(table), jnp.asarray(cols), bs, max_blocks, blocks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_paged_pools_after_prefill_and_decode(kv_quant):
    jm, variables, tm = tiny_pair("llama")
    blocks, bs = 12, 4
    pair = DecodePair(jm, variables, tm, B=3, L=32, blocks=blocks, bs=bs, kv_quant=kv_quant)
    for toks, idx, start, table in paged_script(np.random.default_rng(1), blocks=blocks, bs=bs):
        pair.step(toks, idx, start, table)
    live = blocks * bs  # the garbage block's rows hold whichever idle write won
    for layer in range(tm.config.num_layers):
        jc = pair.jcache[f"layers_{layer}"]["self_attn"]
        for name in ("k", "v"):
            got = getattr(pair.tcache, name)[layer].numpy()[:live]
            ref = np.asarray(jc[name])[:live]
            if kv_quant:
                # K/V agree to float rounding, so a payload may sit one
                # step apart where the value lands on a rounding edge.
                assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
                sc = getattr(pair.tcache, f"{name}_scale")[layer].numpy()[:live]
                np.testing.assert_allclose(sc, np.asarray(jc[f"{name}_scale"])[:live], rtol=1e-5, atol=1e-7)
            else:
                np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    written = (np.abs(pair.tcache.k[0].numpy()[:live].astype(np.float32)).sum(axis=(1, 2)) > 0).sum()
    assert written == 2 * (8 + 3), "two lanes wrote prefill + decode rows"


def test_per_row_writes_past_the_window_are_dropped():
    cache = KVCache(num_layers=1, batch=2, decode_len=4, num_kv_heads=1, head_dim=2,
                    dtype=torch.float32, device="cpu", per_row=True)
    k = torch.arange(1, 13, dtype=torch.float32).reshape(2, 3, 1, 2)
    full_k, _ = cache.update(0, k, -k, torch.tensor([2, 0], dtype=torch.int32))
    assert torch.equal(full_k[0, 2:], k[0, :2])  # row 0: position 4 dropped
    assert torch.equal(full_k[1, :3], k[1])
    assert torch.all(full_k[0, :2] == 0) and torch.all(full_k[1, 3] == 0)


def test_scalar_mode_clamps_the_write_start():
    """dynamic_update_slice semantics: a write that would overrun the
    window lands at the last S positions."""
    cache = KVCache(num_layers=1, batch=1, decode_len=4, num_kv_heads=1, head_dim=1,
                    dtype=torch.float32, device="cpu")
    k = torch.ones(1, 2, 1, 1)
    full_k, _ = cache.update(0, k, k, 3)
    assert full_k.flatten().tolist() == [0.0, 0.0, 1.0, 1.0]


def test_validation():
    kw = dict(num_layers=1, batch=1, decode_len=8, num_kv_heads=1, head_dim=2,
              dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):
        KVCache(ragged=True, **kw)
    with pytest.raises(ValueError):
        KVCache(per_row=True, blocks=4, block_size=3, **kw)
    with pytest.raises(ValueError):
        KVCache(per_row=True, blocks=4, block_size=4, kv_quant="int4", **kw)
