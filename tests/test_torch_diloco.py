"""Port parity: the DiLoCo delta algebra and the outer Nesterov step,
against the JAX package on the same numpy leaves. f32 leaves agree bit for
bit (the Nesterov recurrence's μ·x + g is one fused multiply-add in both);
bf16 leaves keep their dtype exactly where the JAX functions keep it."""

from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from hypha_tpu.executor import diloco as J
from hypha_tpu_torch.executor import diloco as T

SHAPES = {"a": (64, 33), "b": (1000,), "c": (3, 5, 7)}


def _leaves(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32).astype(dtype) for k, s in SHAPES.items()}


def _j(leaves):
    return {k: jnp.asarray(v) for k, v in leaves.items()}


def _t(leaves):
    out = {}
    for k, v in leaves.items():
        if v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _assert_same(jtree, ttree):
    assert set(jtree) == set(ttree)
    for k, jv in jtree.items():
        jv = np.asarray(jv)
        tv = ttree[k]
        if tv.dtype == torch.bfloat16:
            assert jv.dtype == ml_dtypes.bfloat16, k
            np.testing.assert_array_equal(jv.view(np.int16), tv.view(torch.int16).numpy())
        else:
            assert jv.dtype == np.dtype(str(tv.dtype).removeprefix("torch.")), k
            np.testing.assert_array_equal(jv, tv.numpy())


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_extract_delta(dtype):
    p, a = _leaves(0, dtype), _leaves(1, dtype)
    _assert_same(J.extract_delta(_j(p), _j(a)), T.extract_delta(_t(p), _t(a)))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_merge_update(dtype):
    p, u = _leaves(2, dtype), _leaves(3)
    _assert_same(J.merge_update(_j(p), _j(u)), T.merge_update(_t(p), _t(u)))
    _assert_same(J.merge_update_f32(_j(p), _j(u)), T.merge_update_f32(_t(p), _t(u)))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_apply_updates(dtype):
    p = _leaves(4, dtype)
    us = [_leaves(5 + i) for i in range(3)]
    _assert_same(J.apply_updates(_j(p), [_j(u) for u in us]),
                 T.apply_updates(_t(p), [_t(u) for u in us]))
    _assert_same(J.apply_updates(_j(p), []), T.apply_updates(_t(p), []))


@pytest.mark.parametrize("weights", [None, [3.0, 1.0, 2.0]])
def test_average_deltas(weights):
    ds = [_leaves(10 + i) for i in range(3)]
    _assert_same(J.average_deltas([_j(d) for d in ds], weights),
                 T.average_deltas([_t(d) for d in ds], weights))
    with pytest.raises(ValueError):
        T.average_deltas([])


def test_nesterov_outer_steps():
    m_j = J.nesterov_init(_j(_leaves(20)))
    m_t = T.nesterov_init(_t(_leaves(20)))
    _assert_same(m_j, m_t)
    for r in range(3):  # momentum carried across rounds
        g = _leaves(30 + r)
        m_j, u_j = J.nesterov_outer_step(m_j, _j(g), 0.7, 0.9)
        m_t, u_t = T.nesterov_outer_step(m_t, _t(g), 0.7, 0.9)
        _assert_same(m_j, m_t)
        _assert_same(u_j, u_t)
