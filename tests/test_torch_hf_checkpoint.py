"""Port parity: HF-format checkpoints of the Llama lineage as initial
weights. A random-init ``transformers`` ``LlamaForCausalLM`` and a
tied-embedding ``Qwen2ForCausalLM`` (2 layers, hidden 64), written by
``save_pretrained`` as one SafeTensors file, as a sharded directory with
its ``.index.json`` and as ``pytorch_model.bin``, load into the JAX
package and the port to the same parameters: through the trainer's
``source`` (``_init_model``, LoRA adapters left at their init) and through
the serving loader's ``weights``. The converter's name mapping, tied-head
materialisation and loud failures are the reference's."""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypha_tpu import messages as jmsg
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.executor.training import _init_model as jax_init_model
from hypha_tpu.models import convert as JC
from hypha_tpu.worker.infer_executor import InProcessInferExecutor as JInfer
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor.training import _init_model as port_init_model
from hypha_tpu_torch.models import convert as TC
from hypha_tpu_torch.models.convert import llama_params_to_flat
from hypha_tpu_torch.models.registry import build_model
from hypha_tpu_torch.worker.infer_executor import load_model

transformers = pytest.importorskip("transformers")

SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


def _hf_model(kind: str):
    torch.manual_seed(0)
    if kind == "llama":
        cfg = transformers.LlamaConfig(**SMALL, tie_word_embeddings=False)
        model = transformers.LlamaForCausalLM(cfg)
    else:  # Qwen2 with q/k/v biases and a tied head (no lm_head.weight on disk)
        cfg = transformers.Qwen2Config(**SMALL, tie_word_embeddings=True)
        model = transformers.Qwen2ForCausalLM(cfg)
    with torch.no_grad():  # every tensor non-trivial: norms and biases too
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model, cfg.to_dict()


@pytest.fixture(scope="module", params=["llama", "qwen2"])
def repo(request, tmp_path_factory):
    """One model written three ways: ``single`` (model.safetensors),
    ``sharded`` (shards + index.json) and ``bin`` (pytorch_model.bin)."""
    kind = request.param
    model, hf = _hf_model(kind)
    root = tmp_path_factory.mktemp(kind)
    model.save_pretrained(root / "single", safe_serialization=True)
    model.save_pretrained(root / "sharded", safe_serialization=True, max_shard_size="100KB")
    model.save_pretrained(root / "bin", safe_serialization=False)
    assert (root / "sharded" / "model.safetensors.index.json").is_file()
    assert (root / "bin" / "pytorch_model.bin").is_file()
    return {"kind": kind, "root": root, "hf": hf, "model": model}


def _spec(kind: str, hf: dict, lora=None, **model):
    spec = {"model_type": "causal-lm", "family": kind, "hf_config": hf, "seed": 0,
            "config": {"dtype": "float32"}, **model,
            "source": jmsg.to_json_dict(jmsg.Fetch(jmsg.Reference.from_uri("file:///ckpt")))}
    return jmsg.TrainExecutorConfig(
        model=spec, data=jmsg.Fetch(jmsg.Reference.from_uri("file:///slices")),
        updates=jmsg.Send(jmsg.Reference.from_peers(["ps"], "updates")),
        results=jmsg.Receive(jmsg.Reference.from_peers(["ps"], "results")),
        optimizer=jmsg.Adam(lr=1e-3), batch_size=2, lora=lora)


class _Fetch:
    """The bridge session's ``fetch``: the layout's files, relative."""

    def __init__(self, work_dir: Path, layout: Path) -> None:
        self.files = sorted(str(p.relative_to(work_dir)) for p in layout.iterdir())

    def fetch(self, ref):
        return self.files


@pytest.mark.parametrize("layout", ["single", "sharded", "bin"])
@pytest.mark.parametrize("lora", [None, {"rank": 4, "targets": ["q_proj", "o_proj"]}])
def test_trainer_source_loads_the_same_parameters(repo, layout, lora):
    """Each package's ``_init_model`` on the HF files: the base parameters
    equal bit for bit (f32 both), the tied Qwen2 head the embeddings; with
    LoRA the base comes from the checkpoint and the adapters keep their
    seeded init (``B`` zero)."""
    kind, root = repo["kind"], repo["root"]
    cfg = _spec(kind, repo["hf"], lora)
    session = _Fetch(root, root / layout)
    first = {"input_ids": np.zeros((1, 8), np.int32)}
    _jm, jparams, _c, _a = jax_init_model(cfg, session, root, first)
    tcfg = tmsg.from_json_dict(jmsg.to_json_dict(cfg))
    tm = port_init_model(tcfg, session, root, torch.device("cpu"))
    jflat = flatten_tree(jparams)
    tflat = llama_params_to_flat(tm)
    assert set(tflat) == set(jflat)
    base = [n for n in jflat if "_lora_" not in n]
    for name in base:
        np.testing.assert_array_equal(tflat[name], jflat[name], err_msg=name)
    hf_state = repo["model"].state_dict()
    embed = hf_state["model.embed_tokens.weight"].numpy()
    np.testing.assert_array_equal(tflat["params/embed_tokens"], embed)
    if kind == "llama":
        kernel = hf_state["model.layers.1.self_attn.k_proj.weight"].numpy().T
        np.testing.assert_array_equal(tflat["params/layers_1/self_attn/k_proj/kernel"], kernel)
    else:
        assert "params/lm_head" not in tflat  # tied, as the checkpoint's config says
        bias = hf_state["model.layers.0.self_attn.v_proj.bias"].numpy()
        np.testing.assert_array_equal(tflat["params/layers_0/self_attn/v_proj/bias"], bias)
    adapters = [n for n in tflat if "_lora_" in n]
    assert len(adapters) == (2 * 2 * 2 if lora else 0)
    for name in adapters:
        if name.endswith("_lora_b"):
            assert not tflat[name].any() and not np.asarray(jflat[name]).any()


@pytest.mark.parametrize("layout", ["single", "sharded", "bin"])
@pytest.mark.parametrize("serve_dtype", ["bfloat16", "float32"])
def test_serving_weights_load_the_same_parameters(repo, layout, serve_dtype):
    """``load_model``'s ``weights``: a directory (or its ``.index.json``)
    streams through ``convert_checkpoint`` in the serving dtype; a single
    file converts as a whole. Equal bit for bit to the JAX package's
    ``_load_model`` in both dtypes, and the f32 model's logits (computing
    in f32) equal the ``transformers`` model's within 1e-4."""
    kind, root = repo["kind"], repo["root"]
    path = root / layout
    if layout == "single":
        path = path / "model.safetensors"
    elif layout == "bin":
        path = path / "pytorch_model.bin"
    spec = {"family": kind, "hf_config": repo["hf"], "weights": str(path),
            "serve_dtype": serve_dtype, "config": {"dtype": "float32"}}
    _jm, jparams = JInfer._load_model(None, {**spec, "model_type": "causal-lm"})
    tm = load_model(spec, device="cpu")
    assert all(p.dtype == getattr(torch, serve_dtype) for p in tm.parameters())
    jflat = flatten_tree(jparams)
    tstate = TC.state_to_flat(tm, tm.state_dict())
    assert set(tstate) == set(jflat)
    for name, t in tstate.items():
        want = np.asarray(jnp.asarray(jflat[name]).astype(jnp.float32))
        np.testing.assert_array_equal(t.float().numpy(), want, err_msg=name)
    if layout == "sharded":  # the index file itself, as the reference takes it
        again = load_model({**spec, "weights": str(root / layout / "model.safetensors.index.json")},
                           device="cpu")
        for (name, a), b in zip(tm.state_dict().items(), again.state_dict().values()):
            assert torch.equal(a, b), name
    if serve_dtype == "float32":
        ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 12)))
        with torch.no_grad():
            want = repo["model"](ids).logits.numpy()
            got = tm(ids).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_names_map_as_the_references(repo):
    """Every HF name of the checkpoint maps where the reference's
    converter maps it: the port's ``state_dict`` name is the reference's
    flat name in PyTorch spelling (no transpose: HF ``Linear`` is
    ``[out, in]`` like the port's)."""
    kind = repo["kind"]
    keys = list(repo["model"].state_dict()) + ["model.rotary_emb.inv_freq", "other.weight"]
    for key in keys:
        want = JC.HF_CONVERTERS[kind](key)
        got = TC.HF_CONVERTERS[kind](key)
        if want is None:
            assert got is None, key
            continue
        flat, _transpose = want
        assert got == TC._torch_name(flat)[0], key
    with pytest.raises(KeyError):
        TC.HF_CONVERTERS[kind]("model.layers.0.self_attn.rotary.weight")


def test_tied_checkpoint_materialises_an_untied_head(repo):
    """A checkpoint without ``lm_head.weight`` into an untied model: the
    head is the embeddings, in both converters."""
    state = TC.load_checkpoint_files([repo["root"] / "single" / "model.safetensors"])
    state.pop("lm_head.weight", None)
    model, _ = build_model({"family": repo["kind"], "hf_config": repo["hf"],
                            "config": {"tie_word_embeddings": False}}, device="cpu")
    out = TC.convert_state_dict(repo["kind"], state, model)
    assert torch.equal(out["lm_head"], out["embed_tokens"])
    streamed = TC.convert_checkpoint(repo["kind"], repo["root"] / "sharded", model)
    if repo["kind"] == "qwen2":
        assert torch.equal(model.lm_head, model.embed_tokens)
        assert set(streamed) == set(out)


def test_missing_and_misshaped_tensors_fail_loudly(repo):
    state = TC.load_checkpoint_files([repo["root"] / "bin" / "pytorch_model.bin"])
    model, _ = build_model({"family": repo["kind"], "hf_config": repo["hf"]}, device="cpu")
    short = {k: v for k, v in state.items() if "layers.1.mlp.up_proj" not in k}
    with pytest.raises(KeyError, match="missing"):
        TC.convert_state_dict(repo["kind"], short, model)
    bad = dict(state)
    bad["model.norm.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        TC.convert_state_dict(repo["kind"], bad, model)
    with pytest.raises(ValueError, match="no HF converter"):
        TC.convert_state_dict("gpt2", state, model)
    index = json.loads((repo["root"] / "sharded" / "model.safetensors.index.json").read_text())
    assert set(TC.ShardedCheckpoint(repo["root"] / "sharded").keys()) == set(index["weight_map"])


@pytest.mark.parametrize("family", ["llama", "qwen2", "qwen3", "gemma"])
def test_hf_state_dict_round_trips(family):
    """``hf_state_dict`` names a model's base as the family's HF
    checkpoints do: converting it back gives every tensor unchanged, and
    the reference's converter maps each name to the same place."""
    model, _ = build_model({"family": family, "preset": "tiny"} if family == "llama" else
                           {"family": family, "config": {
                               "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
                               "num_layers": 2, "num_heads": 4, "num_kv_heads": 2}},
                           device="cpu")
    model.init_weights(3)
    state = model.state_dict()
    hf = TC.hf_state_dict(state)
    back = TC.convert_state_dict(family, hf, model)
    assert set(back) == set(state)
    for name, t in state.items():
        assert torch.equal(back[name], t), name
        flat, _ = JC.HF_CONVERTERS[family](next(k for k in hf if hf[k] is t))
        assert TC._torch_name(flat)[0] == name
