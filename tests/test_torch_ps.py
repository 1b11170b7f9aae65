"""Port parity: the parameter server's arithmetic. ``RoundAccum`` against
``hypha_tpu/stream/accum.py`` on the same f32 and bf16 delta files (fold,
un-fold, prefolded, mean, partial) bit for bit; ``outer_step`` against
``ParameterServerExecutor._outer_step`` over two rounds with a momentum
file, bit for bit against its numpy path and within f32 rounding against
its C++ path (built with ``-march=native``, which may fuse multiply-adds)."""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from hypha_tpu import native
from hypha_tpu.stream.accum import RoundAccum as JAccum
from hypha_tpu.worker.ps_executor import ParameterServerExecutor
from hypha_tpu_torch.stream.accum import RoundAccum
from hypha_tpu_torch.worker.ps_executor import outer_step

SHAPES = {"params/embed_tokens": (96, 16), "params/layers_0/self_attn/q_proj/kernel": (16, 16),
          "params/norm/weight": (16,), "params/layers_0/mlp/down_proj/kernel": (3, 5, 7)}
SAMPLES = [300.0, 101.0, 7.0]


def _deltas(tmp_path, seed=0):
    """Three delta files (the second in bf16), each tensor at its own
    scale, as workers ship them."""
    rng = np.random.default_rng(seed)
    files = []
    for i in range(3):
        tree = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-5, 1)).astype(np.float32)
                for k, s in SHAPES.items()}
        if i == 1:
            tree = {k: v.astype(ml_dtypes.bfloat16) for k, v in tree.items()}
        path = tmp_path / f"delta-{seed}-{i}.safetensors"
        save_file(tree, str(path))
        files.append(path)
    return files


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        got = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
        assert got.dtype == np.float32 and got.shape == a[k].shape, k
        np.testing.assert_array_equal(got, a[k], err_msg=k)


@pytest.mark.parametrize("sequence", [
    "fold",          # three workers, one a bf16 file
    "unfold",        # a duplicate replaced: fold, un-fold, fold again
    "prefolded",     # a group reducer's partial sum beside a direct delta
])
def test_round_accum_matches_jax_bit_for_bit(tmp_path, sequence):
    files = _deltas(tmp_path)
    steps = [(f, s, 1.0, False) for f, s in zip(files, SAMPLES)]
    if sequence == "unfold":
        steps += [(files[1], SAMPLES[1], -1.0, False), (files[1], 55.0, 1.0, False)]
    if sequence == "prefolded":
        pre = JAccum()
        for f, s in zip(files[:2], SAMPLES[:2]):
            pre.fold(f, s)
        part = tmp_path / "partial.safetensors"
        save_file(pre.partial(), str(part))
        steps = [(part, SAMPLES[0] + SAMPLES[1], 1.0, True), (files[2], SAMPLES[2], 1.0, False),
                 (part, SAMPLES[0] + SAMPLES[1], -1.0, True)]
    j, p = JAccum(), RoundAccum(device="cpu")
    for path, samples, sign, prefolded in steps:
        j.fold(path, samples, sign, prefolded)
        p.fold(path, samples, sign, prefolded)
    assert (p.total_samples, p.folds) == (j.total_samples, j.folds)
    _same(j.partial(), p.partial())
    _same(j.mean(), p.mean())


def test_round_accum_rejects_what_jax_rejects(tmp_path):
    files = _deltas(tmp_path)
    bad_keys = {"params/other": np.zeros(3, np.float32)}
    bad_shape = {**{k: np.zeros(s, np.float32) for k, s in SHAPES.items()},
                 "params/norm/weight": np.zeros(17, np.float32)}
    for acc in (JAccum(), RoundAccum(device="cpu")):
        acc.fold(files[0], 1.0)
        with pytest.raises(ValueError, match="mismatched keys"):
            acc.fold_tree(bad_keys, 1.0)
        with pytest.raises(ValueError, match="mismatched shape"):
            acc.fold_tree(bad_shape, 1.0)
    with pytest.raises(ValueError, match="no deltas"):
        RoundAccum(device="cpu").mean()
    # A malformed HQD1 frame (an empty CBOR header): both refuse it.
    frame = tmp_path / "frame.bin"
    frame.write_bytes(b"HQD1" + b"\0" * 16)
    for acc in (JAccum(), RoundAccum(device="cpu")):
        with pytest.raises(ValueError):
            acc.fold(frame, 1.0)


@pytest.mark.parametrize("c_path", [False, True], ids=["numpy", "native"])
def test_outer_step_matches_jax_over_two_rounds(tmp_path, monkeypatch, c_path):
    if not c_path:
        monkeypatch.setattr(native, "_load", lambda: None)
    assert (native._load() is not None) == c_path
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    for r in range(2):
        files = _deltas(tmp_path, seed=r)
        received = {f"w{i}": (f, s) for i, (f, s) in enumerate(zip(files, SAMPLES))}
        jstats, pstats = {}, {}
        jout = ParameterServerExecutor._outer_step(
            None, received, jdir / "momentum.safetensors", 0.7, 0.9, jdir, r, stats=jstats)
        pacc = RoundAccum(device="cpu")
        for path, samples in received.values():
            pacc.fold(path, samples)
        pout = outer_step(received, pdir / "momentum.safetensors", 0.7, 0.9, pdir, r,
                          accum=pacc if r else None, stats=pstats, device="cpu")
        assert pout.name == jout.name == f"update-{r}.safetensors"
        assert not (pdir / "momentum.next.safetensors").exists()
        for jf, pf in ((jout, pout), (jdir / "momentum.safetensors", pdir / "momentum.safetensors")):
            ref, got = load_file(str(jf)), load_file(str(pf))
            if c_path:  # fused multiply-adds: within f32 rounding of each tensor's size
                assert set(ref) == set(got)
                for k in ref:
                    assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape
                    tol = 2.0 ** -22 * float(np.abs(ref[k]).max())
                    assert float(np.abs(got[k] - ref[k]).max()) <= tol, k
            else:
                _same(ref, got)
        assert set(pstats) == set(jstats) == {"delta_norm", "update_norm", "accepted"}
        for k in jstats:
            assert pstats[k] == pytest.approx(jstats[k], rel=1e-6), k


def test_outer_step_rejects_a_short_momentum(tmp_path):
    files = _deltas(tmp_path)
    mom = tmp_path / "momentum.safetensors"
    save_file({k: np.zeros(int(np.prod(s)) + (k == "params/norm/weight"), np.float32)
               for k, s in SHAPES.items()}, str(mom))
    with pytest.raises(ValueError, match="size"):
        outer_step({"w": (files[0], 1.0)}, mom, 0.7, 0.9, tmp_path, 0, device="cpu")
