"""Port parity: the Llama family. Weights carried across with
``llama_params_from_flat(flatten_tree(jax_variables))``; the training
forward of each family against the JAX model (f32, atol 1e-4), the paged
and paged+ragged decode forwards step by step against the JAX decode
model, one bf16 case, and the flat-name round trip."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import FAMILIES, DecodePair, paged_script, tiny_pair
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu_torch.models import LlamaConfig, build_model
from hypha_tpu_torch.models.convert import llama_params_from_flat, llama_params_to_flat

ATOL = 1e-4
# bf16 logits (|logit| <= ~2) differ by rounding order between XLA and
# PyTorch; measured max 0.018 over seeds 0-3 on the CPU.
BF16_ATOL = 0.05


def _ids(seed, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_training_forward_matches(family):
    jm, variables, tm = tiny_pair(family)
    ids = _ids(1)  # 12 > mistral's window of 5: the windowed path runs
    ref = np.asarray(jm.apply(variables, ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_bf16_training_forward_within_bound():
    jm, variables, tm = tiny_pair("llama", dtype="bfloat16")
    ids = _ids(0, (2, 16))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.float32  # the head einsum runs in f32
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(variables, ids)), atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("family,ragged", [("llama", False), ("llama", True),
                                           ("mistral", True), ("qwen3", True)])
def test_paged_decode_logits_step_by_step(family, ragged):
    jm, variables, tm = tiny_pair(family, seed=2)
    pair = DecodePair(jm, variables, tm, B=3, L=32, blocks=12, bs=4, ragged=ragged)
    for n, (toks, idx, start, table) in enumerate(paged_script(np.random.default_rng(3))):
        ref, got = pair.step(toks, idx, start, table)
        live = slice(0, 2)  # lane 2 is idle: its logits are garbage by design
        np.testing.assert_allclose(got[live], ref[live], atol=ATOL, rtol=0, err_msg=f"step {n}")


def test_flat_names_round_trip():
    jm, variables, tm = tiny_pair("qwen2")
    flat = flatten_tree(variables)
    back = llama_params_to_flat(tm)
    assert set(back) == set(flat)
    for name, arr in flat.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    assert "params/layers_1/self_attn/q_proj/kernel" in back
    assert back["params/layers_0/mlp/gate_proj/kernel"].shape == (64, 128)  # [in, out]


def test_from_flat_rejects_missing_and_unknown_names():
    _, variables, tm = tiny_pair("llama")
    flat = flatten_tree(variables)
    with pytest.raises(KeyError):
        llama_params_from_flat({k: v for k, v in flat.items() if "lm_head" not in k}, tm)
    with pytest.raises(KeyError):
        llama_params_from_flat({**flat, "params/extra": np.zeros(1, np.float32)}, tm)


def test_registry_builds_the_llama_lineage():
    small = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2,
             "num_heads": 4, "num_kv_heads": 2}
    model, cfg = build_model({"family": "qwen3", "config": small}, device="cpu")
    assert cfg.qk_norm and cfg.num_layers == 2 and model.device.type == "cpu"
    _, cfg = build_model({"family": "gemma", "hf_config": {"hidden_size": 64, "num_attention_heads": 4,
                                                          "num_hidden_layers": 1, "head_dim": 32}},
                         device="cpu")
    assert cfg.rms_offset and cfg.tie_word_embeddings and cfg.head_dim == 32
    assert LlamaConfig.llama2_7b().hidden_size == 4096
    with pytest.raises(NotImplementedError, match="model families"):
        build_model({"preset": "tiny"}, device="cpu")
    with pytest.raises(NotImplementedError, match="model families"):
        build_model({}, device="cpu")
    with pytest.raises(NotImplementedError):
        build_model({"family": "gpt2"}, device="cpu")
    model, cfg = build_model({"family": "llama", "preset": "tiny", "config": {"lora_rank": 4}},
                             device="cpu")
    assert cfg.lora_targets == ("q_proj", "v_proj")
    assert model.layers[1].self_attn.v_proj_lora_b.shape == (4, 32)
    with pytest.raises(ValueError, match="lora_targets"):
        build_model({"family": "llama", "preset": "tiny",
                     "config": {"lora_rank": 4, "lora_targets": ("mlp",)}}, device="cpu")


def _grads(remat, dtype, *, checkpoint=None):
    model, _ = build_model({"family": "llama", "preset": "tiny", "seed": 0,
                            "config": {"num_layers": 3, "remat": remat, "dtype": dtype}},
                           device="cpu")
    model.init_weights(0)
    if checkpoint is not None:  # every block under the given rematerialization instead
        for block in model.layers:
            block.forward = (lambda b: lambda x, cos, sin, cache, i, off, _f=b.forward: checkpoint(
                _f, x, cos, sin, cache, i, off, use_reentrant=False))(block)
    ids = torch.from_numpy(_ids(3, (2, 48))).long()
    logits = model(ids)
    loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]).float(),
                                             ids[:, 1:].reshape(-1))
    return [loss.detach(), *torch.autograd.grad(loss, list(model.parameters()))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("other", ["plain backward", "torch.utils.checkpoint"])
def test_remat_gradients_are_the_same_bits(dtype, other):
    """``remat`` (the model's ``_Remat``: the block's inputs kept, the block
    run again in the backward) gives the loss and every parameter's
    gradient of the plain backward and of ``torch.utils.checkpoint``, bit
    for bit."""
    from torch.utils.checkpoint import checkpoint

    got = _grads(True, dtype)
    want = (_grads(False, dtype) if other == "plain backward"
            else _grads(False, dtype, checkpoint=checkpoint))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_remat_step_imports_no_dynamo():
    """A remat training step loads no torch._dynamo (torch.utils.checkpoint
    imports it at its first call: seconds of a trainer's start)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, torch\n"
        "from hypha_tpu_torch.models import build_model\n"
        "m, _ = build_model({'family': 'llama', 'preset': 'tiny', 'seed': 0,\n"
        "                    'config': {'num_layers': 2, 'remat': True}}, device='cpu')\n"
        "m.init_weights(0)\n"
        "loss = m(torch.randint(0, 200, (2, 16))).float().logsumexp(-1).mean()\n"
        "torch.autograd.grad(loss, list(m.parameters()))\n"
        "sys.exit('torch._dynamo imported' if 'torch._dynamo' in sys.modules else 0)\n")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(root)}, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:] or proc.stdout[-2000:]
