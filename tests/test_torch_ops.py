"""Port parity: RMSNorm, RoPE and dot_product_attention of hypha_tpu_torch
against hypha_tpu on the same numpy inputs (f32, atol 1e-5)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypha_tpu.ops.attention import dot_product_attention as j_attn
from hypha_tpu.ops.rmsnorm import rms_norm as j_rms
from hypha_tpu.ops.rope import apply_rope as j_rope
from hypha_tpu.ops.rope import rope_frequencies as j_freqs
from hypha_tpu_torch.ops.attention import dot_product_attention as t_attn
from hypha_tpu_torch.ops.rmsnorm import rms_norm as t_rms
from hypha_tpu_torch.ops.rope import apply_rope as t_rope
from hypha_tpu_torch.ops.rope import rope_frequencies as t_freqs

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    w = rng.standard_normal(32).astype(np.float32)
    _close(t_rms(torch.from_numpy(x), torch.from_numpy(w), 1e-6), j_rms(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_rms_norm_keeps_input_dtype():
    x = torch.randn(2, 3, 8, dtype=torch.bfloat16)
    assert t_rms(x, torch.ones(8)).dtype == torch.bfloat16


@pytest.mark.parametrize("positions", [False, True])
def test_rope_matches(positions):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    tc, ts = t_freqs(16, 64, 10_000.0)
    jc, js = j_freqs(16, 64, 10_000.0)
    _close(tc, jc)
    _close(ts, js)
    pos = rng.integers(0, 64, size=(2, 6)).astype(np.int32) if positions else None
    got = t_rope(torch.from_numpy(x), tc, ts, None if pos is None else torch.from_numpy(pos))
    ref = j_rope(jnp.asarray(x), jc, js, None if pos is None else jnp.asarray(pos))
    _close(got, ref)


def test_rope_clamps_positions_past_the_table():
    """Parked pool lanes sit past the window; the gather clamps, as JAX's."""
    x = np.ones((1, 2, 1, 8), np.float32)
    pos = np.array([[15, 40]], np.int32)
    tc, ts = t_freqs(8, 16)
    jc, js = j_freqs(8, 16)
    _close(t_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(pos)),
           j_rope(jnp.asarray(x), jc, js, jnp.asarray(pos)))


CASES = {
    "causal_mha": dict(h=4, hkv=4, sq=6, sk=6),
    "gqa": dict(h=8, hkv=2, sq=5, sk=5),
    "vector_offset": dict(h=4, hkv=2, sq=3, sk=12, q_offset=[2, 9]),
    "window": dict(h=4, hkv=2, sq=7, sk=7, window=3),
    "k_start": dict(h=4, hkv=2, sq=2, sk=10, q_offset=[4, 8], k_start=[1, 6]),
    # Row 0's queries sit before its k_start: fully masked -> exact zeros.
    "fully_masked_rows": dict(h=2, hkv=1, sq=3, sk=8, q_offset=[0, 5], k_start=[6, 0]),
    "non_causal": dict(h=2, hkv=2, sq=4, sk=6, causal=False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dot_product_attention_matches(name):
    c = dict(CASES[name])
    rng = np.random.default_rng(len(name))
    B, D = 2, 16
    q = rng.standard_normal((B, c["sq"], c["h"], D)).astype(np.float32)
    k = rng.standard_normal((B, c["sk"], c["hkv"], D)).astype(np.float32)
    v = rng.standard_normal((B, c["sk"], c["hkv"], D)).astype(np.float32)
    causal = c.get("causal", True)
    kw_t, kw_j = dict(causal=causal), dict(causal=causal)
    if "q_offset" in c:
        off = np.asarray(c["q_offset"], np.int32)
        kw_t["q_offset"], kw_j["q_offset"] = torch.from_numpy(off), jnp.asarray(off)
    if "k_start" in c:
        ks = np.asarray(c["k_start"], np.int32)
        kw_t["k_start"], kw_j["k_start"] = torch.from_numpy(ks), jnp.asarray(ks)
    if "window" in c:
        kw_t["window"] = kw_j["window"] = c["window"]
    got = t_attn(*(torch.from_numpy(a) for a in (q, k, v)), **kw_t)
    ref = j_attn(*(jnp.asarray(a) for a in (q, k, v)), **kw_j)
    _close(got, ref)
    if name == "fully_masked_rows":
        assert torch.all(got[0, :3] == 0)
