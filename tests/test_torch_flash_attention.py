"""Port parity: flash attention. The port's ``flash_attention`` on CPU
tensors (its plain forward and backward, through the autograd Function)
against the JAX package's Pallas kernels run in interpret mode, as
tests/test_compute.py runs them: S = 256 with 128-row blocks, so every
kernel walks a 2 x 2 tile grid, D = 64, MHA and GQA (4 query heads over 2
kv heads), causal and not, f32 and bf16. Checked: o, the row logsumexp L
(the Pallas forward's lane-replicated ``lse[..., 0]``), and dq, dk, dv
against ``jax.grad``. The sliding window, which the Pallas kernels lack,
is held against the JAX package's dense ``dot_product_attention(window=)``,
alone and inside a Mistral-style tiny Llama."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import tiny_pair
from hypha_tpu.ops.attention import dot_product_attention as jax_dense
from hypha_tpu.ops.flash_attention import _fwd_impl
from hypha_tpu.ops.flash_attention import flash_attention as jax_flash
from hypha_tpu_torch.ops.attention import dot_product_attention
from hypha_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_backward_reference,
    flash_forward_reference,
)

B, S, H, D, BLOCK = 1, 256, 4, 64, 128
# f32: the same f32 arithmetic summed in another order (online softmax over
# 128-key tiles vs one dense softmax): measured <= 1e-6, bound 1e-5.
# bf16: outputs round to 8 mantissa bits and P, dS are rounded to bf16 at
# other points (the kernel's P is relative to the running row max, the
# plain version's to the final one): bound 2e-2 on unit-variance inputs.
# Gradients are held against the case's largest |gradient|.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, hkv, dtype):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, D), (B, S, hkv, D), (B, S, hkv, D), (B, S, H, D)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":  # the same bf16 values in both packages
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrs]
    return arrs


def _jax(arrs, causal, dtype):
    q, k, v, do = (jnp.asarray(a, dtype) for a in arrs)
    hkv = k.shape[2]

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True)

    o, vjp = jax.vjp(f, q, k, v)
    grads = vjp(do)

    def bhsd(x):
        return x.transpose(0, 2, 1, 3).reshape(-1, S, D)

    _, lse = _fwd_impl(bhsd(q), bhsd(k), bhsd(v), causal, D**-0.5, BLOCK, BLOCK, True, H, hkv)
    as_np = [np.asarray(jnp.asarray(x, jnp.float32)) for x in (o, *grads)]
    return as_np[0], np.asarray(lse[..., 0]).reshape(B, H, S), as_np[1:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_kernels(causal, hkv, dtype):
    arrs = _inputs(10 * causal + hkv, hkv, dtype)
    o_ref, lse_ref, grads_ref = _jax(arrs, causal, dtype)

    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrs)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = flash_attention.plain_calls
    o = flash_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert flash_attention.plain_calls == before + 2  # forward + backward, on the host
    _, lse = flash_forward_reference(q.detach(), k.detach(), v.detach(), causal)

    tol = TOL[dtype]
    np.testing.assert_allclose(o.detach().float().numpy(), o_ref, atol=tol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=tol, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert g.dtype == tdt
        err = np.abs(g.float().numpy() - r).max()
        assert err <= tol * np.abs(r).max(), (name, err)


def test_dead_rows_give_zero_gradients():
    """A row with L = -inf (every key masked) has P = 0 in the backward:
    exact zero gradients, no NaN from -inf - -inf."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 3, 4, 8), (1, 5, 2, 8), (1, 5, 2, 8)))
    o, lse = flash_forward_reference(q, k, v, causal=False)
    lse[:, :, 1] = float("-inf")
    dq, dk, dv = flash_backward_reference(q, k, v, o, lse, torch.ones_like(o), causal=False)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    assert torch.equal(dq[:, 1], torch.zeros_like(dq[:, 1]))
    lse[:] = float("-inf")
    dq, dk, dv = flash_backward_reference(q, k, v, o, lse, torch.ones_like(o), causal=False)
    assert not (dq.any() or dk.any() or dv.any())


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_windowed_flash_matches_jax_dense_attention(causal, hkv):
    """f32, S 100, window 37: the same f32 arithmetic in another order,
    bound 1e-5 (outputs) and 1e-5 of the largest |gradient|."""
    rng = np.random.default_rng(3 + hkv)
    s, window = 100, 37
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((B, s, H, D), (B, s, hkv, D), (B, s, hkv, D), (B, s, H, D))]

    def f(q, k, v):
        return jax_dense(q, k, v, causal=causal, window=window)

    o_ref, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrs[:3]))
    grads_ref = [np.asarray(g) for g in vjp(jnp.asarray(arrs[3]))]

    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    o = flash_attention(q, k, v, causal=causal, window=window)
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(arrs[3]))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=1e-5, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv"), grads, grads_ref):
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (name, err)


def test_mistral_window_trains_through_flash():
    """A tiny Mistral (window 5 < S 12) with ``flash_attention`` installed
    runs its windowed attention through flash, forward and backward, and
    never through the dense path: logits match the JAX model (f32, 1e-4 as
    the other family tests), gradients match the port's dense windowed
    attention within 1e-5 of the largest |gradient|."""
    jm, variables, tm = tiny_pair("mistral")
    assert tm.config.sliding_window == 5
    ids = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(np.int32)
    ref = np.asarray(jm.apply(variables, ids))
    grads = []
    for impl in (dot_product_attention, flash_attention):
        for layer in tm.layers:
            layer.self_attn.attn_impl = impl
        dense, plain = dot_product_attention.calls, flash_attention.plain_calls
        logits = tm(torch.from_numpy(ids))
        np.testing.assert_allclose(logits.detach().numpy(), ref, atol=1e-4, rtol=0)
        params = list(tm.parameters())
        grads.append(torch.autograd.grad(logits.square().mean(), params))
        if impl is flash_attention:
            assert dot_product_attention.calls == dense
            assert flash_attention.plain_calls == plain + 2 * len(tm.layers)
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)
