"""Port parity: LoRA fine-tuning. A tiny Llama (2 layers, hidden 64, GQA
4/2) with adapters, built by the JAX package with seeded noise on every
parameter (so ``B`` is not zero) and carried into the port through its
flat names: the forward, k adapter-only steps, ``split_lora`` /
``merge_lora`` / ``fold_lora`` and the config's refusal of bad targets,
against the JAX package's."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import tiny_pair
from hypha_tpu import messages as jmsg
from hypha_tpu.executor import lora as JL
from hypha_tpu.executor import train as J
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.models import LlamaConfig as JConfig
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor import lora as TL
from hypha_tpu_torch.executor import train as T
from hypha_tpu_torch.models import Llama
from hypha_tpu_torch.models import LlamaConfig as TConfig
from hypha_tpu_torch.models.convert import llama_params_to_flat, state_to_flat

ALL = ("q_proj", "k_proj", "v_proj", "o_proj")
LORA = dict(lora_rank=4, lora_alpha=8.0)


def _ids(seed: int, shape=(2, 24)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("targets", [("q_proj", "v_proj"), ALL])
def test_lora_forward_matches_jax(dtype, targets):
    """Logits of the same LoRA tree (non-zero ``B``): f32 within 1e-5
    (measured 1.6e-6), bf16 within 3e-2 of logits up to ~1.8 (measured
    1.6e-2: bf16 products rounded at other points)."""
    jm, variables, tm = tiny_pair("llama", dtype=dtype, seed=3, lora_targets=targets, **LORA)
    names = [n for n in flatten_tree(variables) if "_lora_" in n]
    assert len(names) == 2 * 2 * len(targets)
    assert np.abs(flatten_tree(variables)[names[1]]).max() > 0  # B carries noise
    ids = _ids(0)
    want = np.asarray(jm.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_adapters_carry_the_jax_names_layout_and_init():
    """The port's adapters: the JAX package's flat names, shapes and f32
    dtype both ways; a seeded init draws ``A`` (std 0.02) and zeros ``B``,
    so a fresh adapter leaves the base's logits exactly."""
    _, variables, tm = tiny_pair("llama", seed=1, lora_targets=ALL, **LORA)
    flat = flatten_tree(variables)
    back = llama_params_to_flat(tm)
    assert set(back) == set(flat)
    for name, arr in flat.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    assert back["params/layers_0/self_attn/q_proj_lora_a"].shape == (64, 4)
    assert back["params/layers_0/self_attn/k_proj_lora_b"].shape == (4, 32)
    tm.init_weights(5)
    state = tm.state_dict()
    a, b = state["layers.1.self_attn.o_proj_lora_a"], state["layers.1.self_attn.o_proj_lora_b"]
    assert a.dtype == b.dtype == torch.float32
    assert 0.01 < float(a.std()) < 0.03 and not b.any()
    base = dataclasses.replace(tm.config, lora_rank=0)
    plain = Llama(base, device="cpu")
    plain.load_state_dict(TL.split_lora(state)[1])
    ids = torch.from_numpy(_ids(1))
    with torch.no_grad():
        assert torch.equal(tm(ids), plain(ids))


@pytest.mark.parametrize("bad", [(), ("q_proj", "gate_proj"), ("qproj",)])
def test_bad_targets_raise_the_references_error(bad):
    with pytest.raises(ValueError) as jerr:
        JConfig(lora_rank=4, lora_targets=bad)
    with pytest.raises(ValueError) as terr:
        TConfig(lora_rank=4, lora_targets=bad)
    assert str(terr.value) == str(jerr.value)
    TConfig(lora_rank=0, lora_targets=bad)  # off: nothing to check


def test_k_lora_steps_match_jax():
    """4 adapter-only AdamW steps (weight decay, clipping, warmup-cosine)
    on the same batches: losses within 1e-5 and grad norms within 1e-4
    relative (f32, another summation order); the adapters, scaled by
    1/lr, within 1e-3 (Adam's g / (|g| + eps) amplifies rounding where a
    gradient is tiny); the base bit-unchanged in both."""
    jm, variables, tm = tiny_pair("llama", seed=5, lora_targets=ALL, **LORA)
    adam = dict(lr=3e-3, weight_decay=0.01)
    jsched = jmsg.LRScheduler(jmsg.LRSchedulerKind("cosine-with-warmup"), 1, 4, 0.9)
    tsched = tmsg.LRScheduler(tmsg.LRSchedulerKind("cosine-with-warmup"), 1, 4, 0.9)
    adapters, frozen = JL.split_lora(variables)
    jstate = J.TrainState.create(adapters, J.build_optimizer(jmsg.Adam(**adam), jsched))
    jstep = JL.make_lora_train_step(jm.apply, jmsg.Loss.CROSS_ENTROPY, donate=False)
    base0 = {k: v.clone() for k, v in TL.split_lora(tm.state_dict())[1].items()}
    tad = TL.split_lora(dict(tm.named_parameters()))[0]
    opt = T.build_optimizer(list(tad.values()), tmsg.Adam(**adam), tsched)
    tstep = TL.make_lora_train_step(tm, opt, tmsg.Loss.CROSS_ENTROPY)
    assert not any(p.requires_grad for n, p in tm.named_parameters() if "_lora_" not in n)
    rng = np.random.default_rng(6)
    start = rng.integers(0, 256, (4, 2, 1))
    for i in range(4):
        ids = ((start[i] + np.arange(16)) % 256).astype(np.int32)
        jstate, metrics = jstep(jstate, frozen, {"input_ids": jnp.asarray(ids)})
        loss, _total, _aux, norm = tstep({"input_ids": torch.from_numpy(ids)})
        np.testing.assert_allclose(float(loss), float(metrics["loss"]), atol=1e-5, err_msg=str(i))
        np.testing.assert_allclose(float(norm), float(metrics["grad_norm"]), rtol=1e-4)
    ref = flatten_tree(jax.device_get(jstate.params))
    got = {k: v.detach().numpy() for k, v in state_to_flat(tm, tad).items()}
    assert set(got) == set(ref) and len(got) == 16
    for name, arr in ref.items():
        assert np.abs(got[name] - arr).max() / adam["lr"] <= 1e-3, name
    for name, t in TL.split_lora(tm.state_dict())[1].items():
        assert torch.equal(t, base0[name]), name
    jbase = flatten_tree(frozen)
    for name, t in state_to_flat(tm, base0).items():
        np.testing.assert_array_equal(t.detach().numpy(), jbase[name], err_msg=name)


def test_split_merge_fold_match_jax():
    """``split_lora`` and ``merge_lora`` partition and rebuild the same
    names as the reference's; ``fold_lora``'s kernels equal the JAX fold's
    within 1e-6 (f32 products summed in another order); the folded f32
    model's logits within 1e-5 of the adapters' (measured 1.8e-6). In the
    bf16 compute dtype the JAX fold's own gap sets
    ``chip_smoke.LORA_FOLD_TOL`` (max |Δ logits| over max |logits|,
    measured 0.019), which the port's fold stays within too."""
    for dtype in ("float32", "bfloat16"):
        jm, variables, tm = tiny_pair("llama", dtype=dtype, seed=4, lora_targets=ALL, **LORA)
        jad, jbase = JL.split_lora(variables)
        tad, tbase = TL.split_lora(tm.state_dict())
        assert set(state_to_flat(tm, tad)) == set(flatten_tree(jad))
        assert set(state_to_flat(tm, tbase)) == set(flatten_tree(jbase))
        assert set(TL.merge_lora(tad, tbase)) == set(tm.state_dict())
        jfold = JL.fold_lora(variables, LORA["lora_alpha"], LORA["lora_rank"])
        tfold = TL.fold_lora(tm.state_dict(), LORA["lora_alpha"], LORA["lora_rank"])
        assert not any("_lora_" in n for n in tfold)
        jflat = flatten_tree(jfold)
        base_cfg = dataclasses.replace(tm.config, lora_rank=0)
        folded = Llama(base_cfg, device="cpu")
        folded.load_state_dict(tfold)
        for name, t in state_to_flat(folded, folded.state_dict()).items():
            np.testing.assert_allclose(t.detach().numpy(), jflat[name], atol=1e-6, err_msg=name)
        ids = _ids(2)
        want = np.asarray(jm.apply(variables, jnp.asarray(ids)))
        jm0 = jm.clone(config=dataclasses.replace(jm.config, lora_rank=0))
        jgap = np.abs(np.asarray(jm0.apply(jfold, jnp.asarray(ids))) - want).max()
        with torch.no_grad():
            tgap = (folded(torch.from_numpy(ids)) - tm(torch.from_numpy(ids))).abs().max()
        scale = np.abs(want).max()
        if dtype == "float32":
            assert jgap <= 1e-5 and float(tgap) <= 1e-5
        else:
            assert jgap / scale <= chip_smoke.LORA_FOLD_TOL, jgap / scale
            assert float(tgap) / scale <= chip_smoke.LORA_FOLD_TOL, float(tgap) / scale
