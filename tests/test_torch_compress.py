"""Port parity: the wire codecs (``hypha_tpu_torch/compress``) against
``hypha_tpu/compress`` on its numpy path (``native._load`` patched to
None, as tests/test_torch_ps.py does).

  * ``quantize``: payload and scales byte-equal over a seeded corpus (int8
    at chunk 4096 and 7, int4 at 4096 and 6; odd lengths, an exact zero
    chunk, NaN and Inf chunks, ties at .5, n < chunk, n = 0);
    ``dequantize`` bit-equal; ``ErrorFeedback`` bit-equal over 3 rounds;
  * ``write_delta``: int8 and int4 HQD1 files byte-identical, tagged and
    untagged, with and without error feedback; ``none`` and ``bf16``
    SafeTensors files read back in each package with the same names,
    dtypes, shapes and bits;
  * ``read_delta`` and ``frame_tag`` read the other package's files, and
    ``frame_tag`` gives None on malformed headers; ``RoundAccum`` folds a
    JAX frame bit for bit as the JAX accumulator does.
"""

from __future__ import annotations

import struct
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from hypha_tpu import compress as jc
from hypha_tpu import native
from hypha_tpu.stream.accum import RoundAccum as JAccum
from hypha_tpu_torch import compress as tc
from hypha_tpu_torch.stream import RoundAccum as TAccum

CASES = [("int8", 4096), ("int8", 7), ("int4", 4096), ("int4", 6)]


@pytest.fixture(autouse=True)
def numpy_path(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)


def _corpus(codec: str, chunk: int) -> list:
    """Seeded flat f32 arrays with every edge the quantizer names."""
    rng = np.random.default_rng(chunk)
    out = [np.zeros(0, np.float32), np.float32([0.3]), np.float32([-2.0, 5.0, 0.0])]
    for n in (chunk - 1, chunk, 3 * chunk + 1, 5 * chunk + 3):
        out.append((rng.standard_normal(n) * 10 ** rng.uniform(-6, 2)).astype(np.float32))
    a = (rng.standard_normal(4 * chunk + 1) * 3).astype(np.float32)
    a[:chunk] = 0.0                      # an exact zero chunk
    a[chunk + 1] = np.nan                # a NaN chunk
    a[2 * chunk] = np.inf                # an Inf chunk
    a[3 * chunk: 3 * chunk + 4] = [-np.inf, 1.0, 2.0, 3.0]
    out.append(a)
    qmax = {"int8": 127, "int4": 7}[codec]
    ties = np.arange(-2 * qmax, 2 * qmax + 1, dtype=np.float32) / 2  # every half step
    ties[0] = -qmax  # max-abs qmax: scale 1, so v * inv = v exactly and .5 ties to even
    out.append(ties)
    out.append(np.float32([1e-36, -3e-39, 2e-39, 0.0, 1e-45]))  # subnormal elements
    return out


@pytest.mark.parametrize("codec,chunk", CASES, ids=[f"{c}-{k}" for c, k in CASES])
def test_quantize_is_byte_equal(codec, chunk):
    for i, a in enumerate(_corpus(codec, chunk)):
        jp, js = jc.quantize(a, codec, chunk)
        tp, ts = tc.quantize(torch.from_numpy(a.copy()), codec, chunk)
        assert tp.dtype == torch.uint8 and ts.dtype == torch.float32
        assert tp.numpy().tobytes() == jp.tobytes(), (codec, chunk, i)
        assert ts.numpy().tobytes() == js.tobytes(), (codec, chunk, i)
        jd = jc.dequantize(jp, js, a.size, codec, chunk)
        td = tc.dequantize(tp, ts, a.size, codec, chunk)
        assert td.numpy().tobytes() == jd.tobytes(), (codec, chunk, i)
        assert np.isfinite(td.numpy()).all()
    # A shaped tensor quantizes as its row-major flattening.
    m = np.random.default_rng(1).standard_normal((5, 9)).astype(np.float32)
    assert tc.quantize(torch.from_numpy(m), codec, chunk)[0].numpy().tobytes() == \
        jc.quantize(m.ravel(), codec, chunk)[0].tobytes()


def test_quantize_refuses_what_the_reference_refuses():
    for codec, chunk in (("int2", 8), ("int8", 0), ("int4", 7)):
        with pytest.raises(ValueError):
            jc.quantize(np.ones(4, np.float32), codec, chunk)
        with pytest.raises(ValueError):
            tc.quantize(torch.ones(4), codec, chunk)
    p, s = tc.quantize(torch.ones(10), "int8", 4)
    with pytest.raises(ValueError, match="payload"):
        tc.dequantize(p[:-1], s, 10, "int8", 4)
    with pytest.raises(ValueError, match="scales"):
        tc.dequantize(p, s[:-1], 10, "int8", 4)


def test_error_feedback_is_bit_equal_over_three_rounds():
    rng = np.random.default_rng(9)
    shapes = {"a": (7, 33), "b": (100,), "s": ()}
    jef, tef = jc.ErrorFeedback(), tc.ErrorFeedback()
    for r in range(3):
        flat = {n: (rng.standard_normal(s) * (r + 1)).astype(np.float32) for n, s in shapes.items()}
        jcomp = jef.compensate(flat)
        tcomp = tef.compensate({n: torch.from_numpy(np.array(v)) for n, v in flat.items()})
        jdec, tdec = {}, {}
        for n, v in jcomp.items():
            p, s = jc.quantize(np.atleast_1d(v).ravel(), "int8", 16)
            jdec[n] = jc.dequantize(p, s, v.size, "int8", 16).reshape(np.atleast_1d(v).shape)
            tp, ts = tc.quantize(tcomp[n], "int8", 16)
            tdec[n] = tc.dequantize(tp, ts, tcomp[n].numel(), "int8", 16)
        for n in shapes:
            assert tcomp[n].numpy().tobytes() == np.asarray(jcomp[n]).tobytes(), (r, n)
        jef.absorb(jcomp, jdec)
        tef.absorb(tcomp, tdec)
        for n in shapes:
            assert tef._residual[n].numpy().tobytes() == jef._residual[n].tobytes(), (r, n)
    # A reshaped tensor drops its residual on both sides.
    assert torch.equal(tef.compensate({"b": torch.ones(4, 25)})["b"], torch.ones(4, 25))
    assert np.array_equal(jef.compensate({"b": np.ones((4, 25), np.float32)})["b"],
                          np.ones((4, 25), np.float32))


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"params/embed_tokens": (rng.standard_normal((40, 16)) * 0.01).astype(np.float32),
            "params/layers_0/mlp/down_proj/kernel": rng.standard_normal((3, 5, 7)).astype(np.float32),
            "params/norm/weight": rng.standard_normal(13).astype(np.float32),
            "params/scalar": np.float32(0.25),
            "params/zeros": np.zeros(9, np.float32)}


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("tagged", [False, True], ids=["untagged", "tagged"])
def test_write_delta_frames_are_byte_identical(tmp_path, codec, tagged):
    tag = {"round": 3, "fragment_id": 1, "fragments": 4} if tagged else None
    jef, tef = jc.ErrorFeedback(), tc.ErrorFeedback()
    for r in range(3):  # error feedback carried across rounds
        tree = _tree(r)
        jdec = jc.write_delta(tmp_path / f"j{r}", tree, codec, ef=jef, tag=tag)
        tdec = tc.write_delta(tmp_path / f"t{r}",
                              {k: torch.from_numpy(np.array(v)) for k, v in tree.items()},
                              codec, ef=tef, tag=tag)
        assert (tmp_path / f"t{r}").read_bytes() == (tmp_path / f"j{r}").read_bytes(), r
        for n in tree:
            assert tdec[n].numpy().tobytes() == np.asarray(jdec[n]).tobytes(), (r, n)
        assert not list(tmp_path.glob("*.tmp.*"))
    # Without error feedback, at another chunk.
    jc.write_delta(tmp_path / "jn", _tree(7), codec, chunk=6)
    tc.write_delta(tmp_path / "tn", {k: torch.from_numpy(np.array(v)) for k, v in _tree(7).items()},
                   codec, chunk=6)
    assert (tmp_path / "tn").read_bytes() == (tmp_path / "jn").read_bytes()
    # Each package reads the other's frame.
    for path in (tmp_path / "j2", tmp_path / "t2"):
        a = jc.read_delta(path)
        b = tc.read_delta(path, device="cpu")
        assert list(a) == list(b) == list(_tree(2))
        for n in a:
            assert b[n].dtype == torch.float32 and tuple(b[n].shape) == a[n].shape
            assert b[n].numpy().tobytes() == a[n].tobytes()
        assert jc.frame_tag(path) == tc.frame_tag(path) == tag


@pytest.mark.parametrize("codec", ["none", "bf16"])
def test_safetensors_codecs_read_back_in_both_packages(tmp_path, codec):
    tree = _tree(4)
    tree["params/ints"] = np.arange(6, dtype=np.int32)
    jc.write_delta(tmp_path / "j", tree, codec)
    tc.write_delta(tmp_path / "t", {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}, codec)
    want_dtype = {k: (ml_dtypes.bfloat16 if codec == "bf16" and np.asarray(v).dtype == np.float32
                      else np.asarray(v).dtype) for k, v in tree.items()}
    for path in (tmp_path / "j", tmp_path / "t"):
        assert not jc.is_frame(path) and not tc.is_frame(path)
        assert jc.frame_tag(path) is None and tc.frame_tag(path) is None
        a = jc.read_delta(path)
        b = tc.read_delta(path, device="cpu")
        assert set(a) == set(b) == set(tree)
        for n in tree:
            assert a[n].dtype == want_dtype[n], (path.name, n)
            assert tuple(b[n].shape) == a[n].shape == np.atleast_1d(tree[n]).shape
            bits = b[n].view(torch.int16) if b[n].dtype == torch.bfloat16 else b[n]
            assert bits.numpy().tobytes() == a[n].tobytes(), (path.name, n)


def test_frame_tag_and_readers_refuse_malformed_frames(tmp_path):
    good = tmp_path / "good"
    tc.write_delta(good, {"w": torch.ones(8)}, "int8", tag={"round": 1, "fragment_id": 0,
                                                          "fragments": 2})
    data = good.read_bytes()
    (hlen,) = struct.unpack("<I", data[4:8])
    cases = {
        "short": b"HQD1\x01",
        "huge": b"HQD1" + struct.pack("<I", 65 * 1024 * 1024) + b"\0" * 8,
        "past-end": b"HQD1" + struct.pack("<I", 1000) + b"\xa0",
        "not-cbor": b"HQD1" + struct.pack("<I", 2) + b"\xff\xff",
        "not-a-map": b"HQD1" + struct.pack("<I", 1) + b"\x01",
        "payload-cut": data[: 8 + hlen + 3],
    }
    for name, blob in cases.items():
        path = tmp_path / name
        path.write_bytes(blob)
        if name != "payload-cut":
            assert tc.frame_tag(path) is None and jc.frame_tag(path) is None, name
        with pytest.raises(ValueError):
            jc.read_frame(path)
        with pytest.raises(ValueError):
            tc.read_frame(path, device="cpu")
    assert tc.frame_tag(tmp_path / "missing") is None
    assert tc.frame_tag(good) == {"round": 1, "fragment_id": 0, "fragments": 2}


def test_effective_codec_equals_jax():
    for codec in tc.CODECS:
        for dtype in ("float32", "bfloat16"):
            assert tc.effective_codec(codec, dtype) == jc.effective_codec(codec, dtype)
    assert tc.CODECS == jc.CODECS and tc.QUANT_CODECS == jc.QUANT_CODECS
    with pytest.raises(ValueError):
        tc.effective_codec("fp8")


@pytest.mark.parametrize("codec", ["int8", "int4", "bf16"])
def test_round_accum_folds_any_wire_format_as_jax(tmp_path, codec):
    ja, ta = JAccum(), TAccum(device="cpu")
    for i, samples in enumerate((3.0, 5.0, 2.0)):
        path = tmp_path / f"d{i}"
        jc.write_delta(path, {k: v for k, v in _tree(i).items() if k != "params/scalar"}, codec)
        ja.fold(path, samples)
        ta.fold(path, samples)
    jm, tm = ja.mean(), ta.mean()
    assert set(jm) == set(tm)
    for n in jm:
        assert tm[n].numpy().tobytes() == jm[n].tobytes(), n
