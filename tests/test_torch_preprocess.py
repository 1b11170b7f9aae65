"""Port parity: slice preprocessors (``hypha_tpu_torch/executor/
preprocess.py``) against ``hypha_tpu/executor/preprocess.py``
(``tests/test_preprocess.py``'s cases): the HF processors built offline
(the tokenizer from ``tokenizers``' ``WordLevel``, as the reference's
fixture does), applied to the same seeded slices, give the JAX package's
outputs exactly, in the dataset's sync and pipelined streams and in
``run_training``, whose losses stay within 1e-4 of the JAX trainer's."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from hypha_tpu.executor import dataset as JD
from hypha_tpu.executor import preprocess as J
from hypha_tpu.messages import Preprocessor as JPre
from hypha_tpu_torch.executor import dataset as TD
from hypha_tpu_torch.executor import preprocess as T
from hypha_tpu_torch.messages import Preprocessor as TPre

WORDS = ["hello", "world", "tpu", "train", "gpu", "h100"]


def _text_rows(texts: list, width: int = 24) -> np.ndarray:
    out = np.zeros((len(texts), width), np.uint8)
    for i, t in enumerate(texts):
        b = t.encode()[:width]
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


def _texts(rng, n: int) -> list:
    return [" ".join(rng.choice(WORDS, int(rng.integers(1, 6)))) for _ in range(n)]


@pytest.fixture()
def tokenizer_dir(tmp_path):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"[UNK]": 0, "[PAD]": 1, "hello": 2, "world": 3, "tpu": 4, "train": 5}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    d = tmp_path / "tok"
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "[PAD]",
        "unk_token": "[UNK]", "model_max_length": 8}))
    return d


def _same(jout: dict, tout: dict) -> None:
    assert sorted(jout) == sorted(tout)
    for k in jout:
        assert tout[k].numpy().dtype == np.asarray(jout[k]).dtype, k
        np.testing.assert_array_equal(tout[k].numpy(), jout[k])


def test_kinds_and_their_auto_classes_are_the_references():
    assert [k.value for k in TPre] == [k.value for k in JPre]
    assert {k.value: v for k, v in T._AUTO_CLASSES.items()} == \
        {k.value: v for k, v in J._AUTO_CLASSES.items()}


@pytest.mark.parametrize("options", [None, {"max_length": 6}], ids=["defaults", "max_length"])
def test_tokenizer_kind_tokenizes_text_rows_as_the_reference(tokenizer_dir, options):
    rng = np.random.default_rng(0)
    rows, labels = _text_rows(_texts(rng, 5)), np.arange(5)
    jout = J.make_apply(J.load_processor(JPre.TOKENIZER, tokenizer_dir), JPre.TOKENIZER,
                        ["text"], options)({"text": rows, "labels": labels})
    tout = T.make_apply(T.load_processor(TPre.TOKENIZER, tokenizer_dir), TPre.TOKENIZER,
                        ["text"], options)({"text": torch.from_numpy(rows.copy()),
                                            "labels": torch.from_numpy(labels.copy())})
    _same(jout, tout)
    assert "text" not in tout
    assert tout["input_ids"].shape == (5, (options or {}).get("max_length", 8))


def test_text_rows_decode_as_the_reference():
    rows = _text_rows(["hello world", "", "héllo", "x" * 30])
    assert T._decode_text_rows(rows) == J._decode_text_rows(rows)
    for mod in (J, T):
        with pytest.raises(ValueError, match="uint8"):
            mod._decode_text_rows(rows.astype(np.int32))


def test_image_processor_kind_as_the_reference(tmp_path):
    d = tmp_path / "imgproc"
    d.mkdir()
    (d / "preprocessor_config.json").write_text(json.dumps({
        "image_processor_type": "ViTImageProcessor", "do_resize": True,
        "size": {"height": 8, "width": 8}, "do_normalize": True,
        "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5], "do_rescale": True}))
    imgs = (np.random.default_rng(0).random((3, 12, 12, 3)) * 255).astype(np.uint8)
    jout = J.make_apply(J.load_processor(JPre.IMAGE_PROCESSOR, d), JPre.IMAGE_PROCESSOR,
                        ["images"])({"images": imgs, "labels": np.arange(3)})
    tout = T.make_apply(T.load_processor("image-processor", d), TPre.IMAGE_PROCESSOR,
                        ["images"])({"images": torch.from_numpy(imgs.copy()),
                                     "labels": torch.arange(3)})
    _same(jout, tout)
    assert tout["pixel_values"].shape == (3, 3, 8, 8)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_streams_with_and_without_a_preprocessor(tokenizer_dir, tmp_path, pipeline):
    """A preprocessed job trains on tokenized ids, a bare one on the raw
    rows; both packages' streams give the same batches in both forms."""
    rng = np.random.default_rng(1)
    paths = []
    for i, n in enumerate((4, 3, 5)):
        p = tmp_path / f"slice{i}.safetensors"
        save_file({"text": _text_rows(_texts(rng, n)),
                   "labels": rng.integers(0, 9, (n,)).astype(np.int64)}, str(p))
        paths.append(str(p))
    japply = J.make_apply(J.load_processor(JPre.TOKENIZER, tokenizer_dir), JPre.TOKENIZER,
                          ["text"])
    tapply = T.make_apply(T.load_processor(TPre.TOKENIZER, tokenizer_dir), TPre.TOKENIZER,
                          ["text"])
    kw = {"pipeline": True, "prefetch": 2} if pipeline else {}
    for names, jpre, tpre in ((["input_ids", "labels"], japply, tapply),
                              (["text"], None, None)):
        jit, tit = iter(paths * 2), iter(paths * 2)
        js = JD.stream_batches(lambda: next(jit), 2, names, jpre)
        ts = TD.stream_batches(lambda: next(tit), 2, names, tpre, **kw)
        try:
            for _ in range(6):
                jb, tb = next(js), next(ts)
                _same(jb, tb)
                assert sorted(tb) == sorted(names)
        finally:
            ts.close()
        if jpre is not None:
            assert tb["input_ids"].shape == (2, 8) and tb["input_ids"].dtype != np.uint8
        else:
            assert tb["text"].numpy().dtype == np.uint8


def test_build_preprocessor_from_a_spec_through_the_session(tokenizer_dir):
    class FakeSession:
        def __init__(self):
            self.fetched = []

        def fetch(self, ref):
            self.fetched.append(ref)
            return [f"tok/{p.name}" for p in sorted(tokenizer_dir.iterdir())]

    source = {"_t": "Fetch", "ref": {"_t": "Reference", "uri": "file:///tok"}}
    spec = {"kind": "tokenizer", "source": source, "inputs": ["text"]}
    rows = _text_rows(["hello tpu", "world train world"])
    js, ts = FakeSession(), FakeSession()
    jout = J.build_preprocessor(spec, js, tokenizer_dir.parent)({"text": rows})
    tout = T.build_preprocessor(spec, ts, tokenizer_dir.parent)(
        {"text": torch.from_numpy(rows.copy())})
    _same(jout, tout)
    assert ts.fetched[0].ref.uri == js.fetched[0].ref.uri == "file:///tok"


@pytest.mark.parametrize("spec", [{"kind": "tokenizer", "path": "/tmp/x"},
                                  {"kind": "tokenizer", "inputs": ["text"]}],
                         ids=["no inputs", "no source"])
def test_build_preprocessor_validation(spec):
    assert T.build_preprocessor({}, None, None) is J.build_preprocessor({}, None, None) is None
    errors = []
    for mod in (J, T):
        with pytest.raises(ValueError) as info:
            mod.build_preprocessor(spec, None, None)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_run_training_with_a_tokenizer_matches_the_jax_trainer(tokenizer_dir, tmp_path):
    """A job whose slices are text rows, tokenized by the job's
    preprocessor, from one θ₀: the port's trainer (sync and pipelined)
    against the JAX trainer, losses within 1e-4; the port's two runs equal
    float for float."""
    from _torch_parity import tiny_pair
    from test_torch_data_pipeline import _Session, _spec

    from hypha_tpu import messages as jmsg
    from hypha_tpu.executor.serialization import flatten_tree
    from hypha_tpu.executor.training import run_training as jrun
    from hypha_tpu_torch import messages as tmsg
    from hypha_tpu_torch.executor.training import run_training as trun

    rng = np.random.default_rng(2)
    texts = [_text_rows(_texts(rng, n)) for n in (5, 3, 7, 2)]
    theta0 = flatten_tree(tiny_pair("llama", seed=7, num_layers=2)[1])

    class TextSession(_Session):
        def fetch(self, ref):
            if ref.ref.uri == "file:///weights":
                return super().fetch(ref)
            with self.lock:
                i = self.fetches
                self.fetches += 1
            path = self.dir / "artifacts" / f"slice{i}.safetensors"
            save_file({"text": texts[i % len(texts)]}, str(path))
            return [f"artifacts/{path.name}"]

    pre = {"kind": "tokenizer", "path": str(tokenizer_dir), "inputs": ["text"]}
    results = {}
    for name, msgs, over in (("jax", jmsg, {}), ("port", tmsg, {}),
                             ("port-pipelined", tmsg,
                              {"input_pipeline": True, "prefetch_slices": 2})):
        work = tmp_path / name
        work.mkdir()
        save_file(theta0, str(work / "theta0.safetensors"))
        spec = _spec(msgs, True, preprocessor=pre, **over)
        spec.executor.train.model["input_names"] = ["input_ids"]
        session = TextSession(work, msgs, work / "theta0.safetensors")
        if msgs is jmsg:
            results[name] = jrun(session, work, spec, max_batches=64)
        else:
            results[name] = trun(session, work, spec, max_batches=64, device="cpu")
    assert results["port"].batches == results["jax"].batches == 9
    np.testing.assert_allclose(results["port"].losses, results["jax"].losses, atol=1e-4, rtol=0)
    assert results["port-pipelined"].losses == results["port"].losses
