"""Port parity: slice batches. The port's synchronous stream, per-sample
batches and whole-slice batches against the JAX package's, on the same
SafeTensors slices (written by the ``safetensors`` package): the same
values in the same order, exactly."""

from __future__ import annotations

import numpy as np
import pytest
from safetensors.numpy import save_file

from hypha_tpu.executor import dataset as J
from hypha_tpu_torch.executor import dataset as T


def _slices(tmp_path, sizes=(5, 3, 7, 2)):
    rng = np.random.default_rng(4)
    paths = []
    for i, n in enumerate(sizes):
        p = tmp_path / f"s{i}.safetensors"
        save_file({"input_ids": rng.integers(0, 100, (n, 6)).astype(np.int32),
                   "labels": rng.integers(0, 100, (n, 6)).astype(np.int64)}, str(p))
        paths.append(str(p))
    return paths


def _same(jb, tb):
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), jb[k])
        assert tb[k].numpy().dtype == jb[k].dtype


@pytest.mark.parametrize("batch_size", [1, 4, 6])
def test_stream_matches(tmp_path, batch_size):
    paths = _slices(tmp_path)

    def fetcher():
        it = iter(paths * 3)
        return lambda: next(it)

    js = J.stream_batches(fetcher(), batch_size, ["input_ids"])
    ts = T.stream_batches(fetcher(), batch_size, ["input_ids"])
    for _ in range(sum((5, 3, 7, 2)) * 2 // batch_size):
        _same(next(js), next(ts))


def test_slice_batches_match(tmp_path):
    paths = _slices(tmp_path)
    jb = list(J.slice_batches((J.load_slice(p) for p in paths), 4))
    tb = list(T.slice_batches((T.load_slice(p) for p in paths), 4))
    assert len(jb) == len(tb) == 4
    for a, b in zip(jb, tb):
        _same(a, b)
    only = T.load_slice(paths[0], ["labels"])
    assert list(only) == ["labels"]


def test_unported_stream_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="input_pipeline"):
        T.stream_batches(lambda: "", 2, pipeline=True)
    with pytest.raises(NotImplementedError, match="preprocessor"):
        T.stream_batches(lambda: "", 2, preprocessor=lambda t: t)
