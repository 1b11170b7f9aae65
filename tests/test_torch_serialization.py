"""Port parity: the port's own SafeTensors reader and writer against the
``safetensors`` package (bit-equal both ways, bf16 as raw bits, int32,
scalars), flat names, the ``messages`` subset's JSON form against the JAX
package's, and serving weights loaded without the ``safetensors``
package."""

from __future__ import annotations

import json
import sys

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

from hypha_tpu import messages as jmsg
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor.serialization import (
    flatten,
    load_file,
    read_header,
    save_file,
    unflatten,
)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params/layers_0/self_attn/q_proj/kernel": rng.standard_normal((5, 7)).astype(np.float32),
        "params/embed_tokens": rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
        "input_ids": rng.integers(0, 1000, (4, 9)).astype(np.int32),
        "ids64": rng.integers(-5, 5, (6,)).astype(np.int64),
        "half": rng.standard_normal((2, 3)).astype(np.float16),
        "scalar": np.asarray(2.5, np.float32),
        "mask": rng.integers(0, 2, (3,)).astype(bool),
    }


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_reads_files_written_by_safetensors(tmp_path):
    ref = _arrays()
    st_save(ref, str(tmp_path / "a.safetensors"))
    got = load_file(tmp_path / "a.safetensors")
    assert set(got) == set(ref)
    for k, v in ref.items():
        t = got[k]
        assert tuple(t.shape) == v.shape
        raw = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(raw, _bits(v))
    assert got["params/embed_tokens"].dtype == torch.bfloat16
    assert got["input_ids"].dtype == torch.int32
    only = load_file(tmp_path / "a.safetensors", ["input_ids"])
    assert list(only) == ["input_ids"]
    with pytest.raises(KeyError):
        load_file(tmp_path / "a.safetensors", ["nope"])


def test_safetensors_reads_files_written_here(tmp_path):
    ref = _arrays(1)
    tensors = {k: torch.from_numpy(np.array(_bits(v))) for k, v in ref.items()}
    tensors["params/embed_tokens"] = tensors["params/embed_tokens"].view(torch.bfloat16)
    tensors["transposed"] = torch.arange(12, dtype=torch.float32).reshape(3, 4).T
    save_file(tensors, tmp_path / "b.safetensors", metadata={"round": 3})
    got = st_load(str(tmp_path / "b.safetensors"))
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(_bits(got[k]), _bits(v))
    np.testing.assert_array_equal(got["transposed"], np.arange(12, dtype=np.float32).reshape(3, 4).T)
    _, meta, _ = read_header(tmp_path / "b.safetensors")
    assert meta == {"round": "3"}
    # numpy inputs (ml_dtypes bf16 included) write the same bytes.
    save_file(ref, tmp_path / "c.safetensors")
    again = st_load(str(tmp_path / "c.safetensors"))
    for k, v in ref.items():
        np.testing.assert_array_equal(_bits(again[k]), _bits(v))


def test_flatten_round_trip():
    tree = {"params": {"layers_0": {"w": 1, "b": 2}, "embed": 3}}
    flat = flatten(tree)
    assert flat == {"params/layers_0/w": 1, "params/layers_0/b": 2, "params/embed": 3}
    assert unflatten(flat) == tree


def _job():
    cfg = jmsg.TrainExecutorConfig(
        model={
            "model_type": "causal-lm", "family": "llama", "seed": 3,
            "config": {"hidden_size": 64, "num_layers": 2},
            "source": jmsg.to_json_dict(jmsg.Fetch(jmsg.Reference.from_uri("file:///w"))),
        },
        data=jmsg.Fetch(jmsg.Reference.from_scheduler("sched", "toy")),
        updates=jmsg.Send(jmsg.Reference.from_peers(["ps"], "updates")),
        results=jmsg.Receive(jmsg.Reference.from_peers(["ps"], "results")),
        optimizer=jmsg.Adam(lr=3e-4, betas=(0.9, 0.95), weight_decay=0.1),
        batch_size=4,
        scheduler=jmsg.LRScheduler(jmsg.LRSchedulerKind.WSD, 10, 100, 0.8),
        loss=jmsg.Loss.CROSS_ENTROPY,
    )
    return jmsg.JobSpec(job_id="j1", executor=jmsg.Executor("train", "diloco-transformer", train=cfg))


@pytest.mark.parametrize("msg", [
    _job(),
    jmsg.Progress(kind=jmsg.ProgressKind.METRICS, job_id="j", round=2,
                  metrics={"loss": 1.5, "samples": 8.0}),
    jmsg.ProgressResponse(kind=jmsg.ProgressResponseKind.SCHEDULE_UPDATE, counter=3),
    jmsg.Nesterov(lr=0.5),
])
def test_messages_read_the_same_in_both_packages(msg):
    d = json.loads(json.dumps(jmsg.to_json_dict(msg)))
    port = tmsg.from_json_dict(d)
    assert type(port).__name__ == type(msg).__name__
    assert tmsg.to_json_dict(port) == d
    assert jmsg.to_json_dict(jmsg.from_json_dict(tmsg.to_json_dict(port))) == d


def test_port_spec_fields():
    spec = tmsg.from_json_dict(json.loads(json.dumps(jmsg.to_json_dict(_job()))))
    cfg = spec.executor.train
    assert cfg.optimizer.betas == (0.9, 0.95)
    assert cfg.scheduler.kind is tmsg.LRSchedulerKind.WSD
    assert cfg.updates.ref.resource == "updates"
    assert isinstance(tmsg.from_json_dict(cfg.model["source"]), tmsg.Fetch)


def test_serving_weights_load_without_safetensors(tmp_path, monkeypatch):
    from _torch_parity import tiny_pair

    from hypha_tpu.executor.serialization import flatten_tree
    from hypha_tpu_torch.worker.infer_executor import load_model

    _, variables, tm = tiny_pair("llama", seed=4)
    path = tmp_path / "w.safetensors"
    st_save(flatten_tree(variables), str(path))
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError):
        import safetensors.numpy  # noqa: F401  (the package is unavailable from here on)
    model = load_model({"family": "llama", "preset": "tiny", "weights": str(path),
                        "serve_dtype": "float32"}, device="cpu")
    for (name, p), (_, ref) in zip(model.state_dict().items(), tm.state_dict().items()):
        assert torch.equal(p, ref), name
