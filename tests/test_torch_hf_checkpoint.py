"""Port parity: HF-format checkpoints as initial weights. Random-init
``transformers`` models of the Llama lineage (2 layers, hidden 64:
``LlamaForCausalLM``, a tied-embedding ``Qwen2ForCausalLM``, a windowed
``MistralForCausalLM``, ``Qwen3ForCausalLM`` with QK-norm and a tied
``GemmaForCausalLM``), written by ``save_pretrained`` as one SafeTensors
file, as a sharded directory with its ``.index.json`` and as
``pytorch_model.bin``, load into the JAX package and the port to the same
parameters: through the trainer's ``source`` (``_init_model``, LoRA
adapters left at their init) and through the serving loader's
``weights``. The converter's name mapping, tied-head materialisation and
loud failures are the reference's. A ``MixtralForCausalLM`` (experts
stacked by the converters) loads through both packages' converters, in
memory and streamed, to the same parameters and logits, and serves
through the port's infer executor."""

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
    elif kind == "qwen2":  # q/k/v biases and a tied head (no lm_head.weight on disk)
        cfg = transformers.Qwen2Config(**SMALL, tie_word_embeddings=True)
        model = transformers.Qwen2ForCausalLM(cfg)
    elif kind == "mistral":  # a window shorter than the logits check's 12 positions
        cfg = transformers.MistralConfig(**SMALL, sliding_window=6, tie_word_embeddings=False)
        model = transformers.MistralForCausalLM(cfg)
    elif kind == "qwen3":  # QK-norm, head_dim set apart from hidden / heads
        cfg = transformers.Qwen3Config(**SMALL, head_dim=16, tie_word_embeddings=False)
        model = transformers.Qwen3ForCausalLM(cfg)
    else:  # Gemma: offset norms, GeGLU, scaled embeddings, a tied head
        cfg = transformers.GemmaConfig(**SMALL, head_dim=32)
        model = transformers.GemmaForCausalLM(cfg)
    with torch.no_grad():  # every tensor non-trivial: norms and biases too
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model, cfg.to_dict()


@pytest.fixture(scope="module", params=["llama", "qwen2", "mistral", "qwen3", "gemma"])
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
    kernel = hf_state["model.layers.1.self_attn.k_proj.weight"].numpy().T
    np.testing.assert_array_equal(tflat["params/layers_1/self_attn/k_proj/kernel"], kernel)
    if repo["hf"]["tie_word_embeddings"]:
        assert "params/lm_head" not in tflat  # tied, as the checkpoint's config says
    if kind == "qwen2":
        bias = hf_state["model.layers.0.self_attn.v_proj.bias"].numpy()
        np.testing.assert_array_equal(tflat["params/layers_0/self_attn/v_proj/bias"], bias)
    if kind == "qwen3":
        norm = hf_state["model.layers.0.self_attn.k_norm.weight"].numpy()
        np.testing.assert_array_equal(tflat["params/layers_0/self_attn/k_norm"], norm)
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
    if repo["hf"]["tie_word_embeddings"]:
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


# ------------------------------------------------------------------- Mixtral

MOE_SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                 num_experts_per_tok=2, max_position_embeddings=128, tie_word_embeddings=False)
# The registry builds Mixtral from its default config plus these overrides
# (the reference's MixtralConfig has no from_hf), matching MOE_SMALL.
MOE_CONFIG = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2,
              "num_heads": 4, "num_kv_heads": 2, "num_experts": 4, "experts_per_token": 2,
              "max_seq_len": 128, "rope_theta": 1e6, "dtype": "float32"}


@pytest.fixture(scope="module")
def moe_repo(tmp_path_factory):
    """A random-init ``MixtralForCausalLM`` (every tensor with noise) as one
    SafeTensors file and as a sharded directory with its index."""
    torch.manual_seed(21)
    cfg = transformers.MixtralConfig(**MOE_SMALL)
    model = transformers.MixtralForCausalLM(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    root = tmp_path_factory.mktemp("mixtral")
    model.save_pretrained(root / "single", safe_serialization=True)
    model.save_pretrained(root / "sharded", safe_serialization=True, max_shard_size="100KB")
    assert (root / "sharded" / "model.safetensors.index.json").is_file()
    return {"root": root, "model": model.eval()}


@pytest.mark.parametrize("how", ["in memory", "streamed"])
def test_mixtral_checkpoint_converts_alike_in_both_packages(moe_repo, how):
    """``convert_state_dict`` (the whole state dict) and the streaming
    ``convert_checkpoint`` (the sharded repo, each expert stack emitted as
    its last slice arrives) of both packages give equal f32 parameters;
    the port's logits equal the ``transformers`` model's within 1e-4, as
    the JAX model's do."""
    import dataclasses

    import jax

    from hypha_tpu.models.mixtral import Mixtral as JMixtral
    from hypha_tpu.models.mixtral import MixtralConfig as JMC

    jcfg = dataclasses.replace(JMC(), **MOE_CONFIG)
    template = JMixtral(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    tm, _ = build_model({"family": "mixtral", "config": MOE_CONFIG}, device="cpu")
    root = moe_repo["root"]
    if how == "in memory":
        state = TC.load_checkpoint_files([root / "single" / "model.safetensors"])
        jparams = JC.convert_state_dict("mixtral", {k: v.float().numpy() for k, v in state.items()},
                                        template)
        TC.load_state(tm, TC.convert_state_dict("mixtral", state, tm))
    else:
        stacks: list = []
        jparams = JC.convert_checkpoint("mixtral", root / "sharded", template)
        TC.convert_checkpoint("mixtral", root / "sharded", tm,
                              put=lambda n, t: stacks.append(n) or tm.state_dict()[n].copy_(t))
        assert "layers.1.moe.w_down" in stacks
    jflat, tflat = flatten_tree(jparams), llama_params_to_flat(tm)
    assert set(tflat) == set(jflat)
    for name, arr in jflat.items():
        np.testing.assert_array_equal(tflat[name], arr, err_msg=name)
    hf = moe_repo["model"].state_dict()
    w1 = hf["model.layers.1.block_sparse_moe.experts.2.w1.weight"].numpy()
    np.testing.assert_array_equal(tflat["params/layers_1/moe/w_gate"][2], w1.T)
    ids = np.random.default_rng(0).integers(0, 256, (2, 12))
    with torch.no_grad():
        want = moe_repo["model"](torch.from_numpy(ids)).logits.numpy()
        got, _aux = tm(torch.from_numpy(ids), dropless=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    jlogits, _ = JMixtral(jcfg, dropless=True).apply(jparams, ids)
    np.testing.assert_allclose(np.asarray(jlogits), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_mixtral_trainer_source_loads_the_same_parameters(moe_repo, layout):
    """Each package's ``_init_model`` on the HF Mixtral files as the job's
    ``source`` (the registry's default config plus the overrides, as the
    reference's ``MixtralConfig`` has no ``from_hf``): equal f32
    parameters, the experts stacked; a LoRA job is refused by both
    (``MixtralConfig`` has no LoRA fields)."""
    root = moe_repo["root"]
    cfg = _spec("mixtral", moe_repo["model"].config.to_dict(), config=MOE_CONFIG)
    session = _Fetch(root, root / layout)
    first = {"input_ids": np.zeros((1, 8), np.int32)}
    _jm, jparams, _c, has_aux = jax_init_model(cfg, session, root, first)
    tm = port_init_model(tmsg.from_json_dict(jmsg.to_json_dict(cfg)), session, root,
                         torch.device("cpu"))
    assert has_aux
    jflat, tflat = flatten_tree(jparams), llama_params_to_flat(tm)
    assert set(tflat) == set(jflat)
    for name, arr in jflat.items():
        np.testing.assert_array_equal(tflat[name], arr, err_msg=name)
    lora = _spec("mixtral", moe_repo["model"].config.to_dict(), lora={"rank": 4},
                 config=MOE_CONFIG)
    with pytest.raises(TypeError):
        jax_init_model(lora, session, root, first)
    with pytest.raises(TypeError):
        port_init_model(tmsg.from_json_dict(jmsg.to_json_dict(lora)), session, root,
                        torch.device("cpu"))


def test_mixtral_checkpoint_refuses_a_missing_expert(moe_repo):
    """A stack with an expert missing fails loudly, streamed or not, and a
    Mixtral checkpoint without its head gets none from the embeddings."""
    tm, _ = build_model({"family": "mixtral", "config": MOE_CONFIG}, device="cpu")
    state = TC.load_checkpoint_files([moe_repo["root"] / "single" / "model.safetensors"])
    with pytest.raises(KeyError, match="not contiguous"):
        TC.convert_state_dict("mixtral", {k: v for k, v in state.items()
                                          if "experts.1.w3" not in k}, tm)
    with pytest.raises(KeyError, match="missing"):
        TC.convert_state_dict("mixtral", {k: v for k, v in state.items()
                                          if k != "lm_head.weight"}, tm)


def test_mixtral_repo_serves_through_the_infer_executor(moe_repo):
    """The HF repo directory as ``weights`` of a Mixtral infer job on the
    port's executor over ``MemoryTransport`` (the counterpart of the JAX
    package's ``test_serving_mixtral_from_hf_repo``): the answers are
    greedy-deterministic, equal ``generate`` on the same weights, and the
    continuous pool served them (``auto`` scheduling)."""
    import asyncio

    from hypha_tpu_torch.executor.generate import generate
    from hypha_tpu_torch.messages import (INFER_EXECUTOR_NAME, Executor, InferExecutorConfig,
                                          JobSpec)
    from hypha_tpu_torch.network import MemoryTransport, Node
    from hypha_tpu_torch.worker.continuous import PoolServer
    from hypha_tpu_torch.worker.infer_executor import InProcessInferExecutor, generate_remote

    model = {"family": "mixtral", "config": MOE_CONFIG, "weights": str(moe_repo["root"] / "sharded"),
             "serve_dtype": "float32"}
    prompts = [[3, 1, 4], [1, 5, 9, 2, 6]]

    async def main():
        hub = MemoryTransport()
        gw = Node(hub.shared(), peer_id="gw", registry_server=True)
        await gw.start()
        worker = Node(hub.shared(), peer_id="w", bootstrap=[gw.listen_addrs[0]])
        client = Node(hub.shared(), peer_id="c", bootstrap=[gw.listen_addrs[0]])
        await worker.start()
        await client.start()
        await worker.wait_for_bootstrap(5)
        await client.wait_for_bootstrap(5)
        ex = InProcessInferExecutor(worker, torch.device("cpu"))
        spec = JobSpec(job_id="job-moe", executor=Executor(
            kind="infer", name=INFER_EXECUTOR_NAME,
            infer=InferExecutorConfig(model=model, serve_name="moe", pool_block_size=8)))
        execution = await ex.execute("job-moe", spec, "s")
        try:
            first = [await generate_remote(client, "moe", [p], 6, timeout=120) for p in prompts]
            again = [await generate_remote(client, "moe", [p], 6, timeout=120) for p in prompts]
            served_by_pool = isinstance(ex.batchers["job-moe"], PoolServer)
        finally:
            await execution.cancel()
            await client.stop()
            await worker.stop()
            await gw.stop()
        return first, again, served_by_pool

    first, again, served_by_pool = asyncio.run(main())
    assert first == again and all(len(t[0]) == 6 for t in first)
    assert served_by_pool
    tm = load_model(model, device="cpu")
    assert [generate(tm, [p], 6)[0].tolist() for p in prompts] == [t[0] for t in first]
