"""Port parity: Mixtral. The tiny config in f32, weights carried across from
the JAX package (``llama_params_from_flat(flatten_tree(variables))``, each
parameter with seeded noise): the plain forward's logits, aux loss and
``drop_frac`` under capacity and drop-free routing on a batch where
capacity drops picks; ``remat`` on and off; one AdamW step against
``make_train_step(has_aux=True)``; θ₀ from the seed bit-equal to
``Mixtral.init``; cached decode (``generate`` and the paged pool, the
ragged kernel's plain path on the CPU) equal to the drop-free full
forward; and ``hf_state_dict`` back through ``convert_state_dict``."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypha_tpu import messages as jmsg
from hypha_tpu.executor import train as J
from hypha_tpu.executor.serialization import flatten_tree, unflatten_like
from hypha_tpu.models import convert as JC
from hypha_tpu.models.mixtral import Mixtral as JMixtral
from hypha_tpu.models.mixtral import MixtralConfig as JConfig
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor import train as T
from hypha_tpu_torch.executor.generate import generate
from hypha_tpu_torch.executor.pool import DecodePool
from hypha_tpu_torch.models import Mixtral, MixtralConfig, build_model
from hypha_tpu_torch.models import convert as TC
from hypha_tpu_torch.models.convert import llama_params_from_flat, llama_params_to_flat

ATOL = 1e-4
# capacity_factor 0.5 gives C = 3 of 12 x 2 / 4 = 6 picks an expert: the
# capacity route drops picks on every batch below.
DROPPING = {"capacity_factor": 0.5}


def _ids(seed, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def mixtral_pair(seed: int = 0, **over):
    """(JAX config, JAX variables, port module) with identical weights."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype="float32", **over)
    variables = JMixtral(jcfg).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)
    flat = {k: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_tree(variables).items()}
    tm = Mixtral(dataclasses.replace(MixtralConfig.tiny(), dtype="float32", **over), device="cpu")
    llama_params_from_flat(flat, tm)
    return jcfg, unflatten_like(flat, variables), tm


@pytest.mark.parametrize("routing", ["capacity", "dropless"])
def test_plain_forward_logits_aux_and_drop_frac(routing):
    """Logits and the summed aux loss within 1e-4 of the JAX forward; the
    capacity route's ``drop_frac`` of each layer as the reference sows it
    (and nothing recorded without an ``intermediates`` dict)."""
    jcfg, variables, tm = mixtral_pair(1, **DROPPING)
    ids = _ids(2)
    dropless = routing == "dropless"
    (ref, ref_aux), inter = JMixtral(jcfg, dropless=dropless).apply(
        variables, ids, mutable=["intermediates"])
    rec: dict = {}
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(ids), dropless=dropless, intermediates=rec)
        hidden, hidden_aux = tm(torch.from_numpy(ids), dropless=dropless, with_head=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=ATOL, rtol=0)
    assert got.dtype == torch.float32 and hidden.shape == (2, 12, 64)
    assert torch.equal(hidden_aux, aux)
    want = {f"{layer}/moe/drop_frac": float(v["moe"]["drop_frac"][0])
            for layer, v in inter.get("intermediates", {}).items()}
    assert set(rec) == set(want)
    for name, frac in want.items():
        np.testing.assert_allclose(float(rec[name]), frac, atol=1e-6, err_msg=name)
    if not dropless:
        assert len(want) == 2 and min(want.values()) > 0  # capacity dropped picks
        assert 0 <= float(aux) <= jcfg.router_aux_coef * jcfg.num_experts


def _loss_and_grads(tm, ids):
    logits, aux = tm(torch.from_numpy(ids))
    loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, 256),
                                             torch.from_numpy(ids[:, 1:]).long().reshape(-1))
    return [loss.detach(), aux.detach(), *torch.autograd.grad(loss + aux, list(tm.parameters()))]


def test_remat_gives_the_same_loss_aux_and_gradients():
    """``remat`` carries each block's aux through the rematerialized block:
    loss, aux and every gradient equal the plain backward's bit for bit."""
    _, _, plain = mixtral_pair(2, **DROPPING)
    remat = Mixtral(dataclasses.replace(plain.config, remat=True), device="cpu")
    remat.load_state_dict(plain.state_dict())
    ids = _ids(3, (2, 16))
    got, want = _loss_and_grads(remat, ids), _loss_and_grads(plain, ids)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(got[1]) > 0 and all(g.abs().sum() > 0 for g in got[2:])


def test_adamw_step_matches_the_has_aux_train_step():
    """One step of ``make_train_step(has_aux=True)`` in both packages, with
    remat and capacity drops: loss, aux, total and gradient norm within
    1e-4; the updated parameters, scaled by 1/lr, 99.99% within 1e-3 of
    JAX's and every one within 0.05, ``test_torch_train.py``'s bound
    (Adam's normalised step g / (|g| + eps) carries the two frameworks'
    gradient rounding into the update: measured 1.75e-3 for one element)."""
    jcfg, variables, tm = mixtral_pair(4, remat=True, **DROPPING)
    adam = dict(lr=3e-3, weight_decay=0.01)
    state = J.TrainState.create(variables, J.build_optimizer(jmsg.Adam(**adam)))
    jstep = J.make_train_step(JMixtral(jcfg).apply, jmsg.Loss.CROSS_ENTROPY, has_aux=True)
    tstep = T.make_train_step(tm, T.build_optimizer(list(tm.parameters()), tmsg.Adam(**adam)),
                              tmsg.Loss.CROSS_ENTROPY, has_aux=True)
    ids = _ids(5, (2, 16))
    state, metrics = jstep(state, {"input_ids": jnp.asarray(ids)})
    loss, total, aux, norm = tstep({"input_ids": torch.from_numpy(ids)})
    for got, key in ((loss, "loss"), (total, "total_loss"), (aux, "aux_loss")):
        np.testing.assert_allclose(float(got), float(metrics[key]), atol=ATOL, err_msg=key)
    assert float(aux) > 0 and float(total) == pytest.approx(float(loss) + float(aux), abs=1e-6)
    np.testing.assert_allclose(float(norm), float(metrics["grad_norm"]), rtol=1e-4)
    ref = flatten_tree(jax.device_get(state.params))
    got = llama_params_to_flat(tm)
    assert set(got) == set(ref)
    diffs = np.concatenate([(np.abs(a - ref[n]) / adam["lr"]).ravel() for n, a in got.items()])
    assert np.quantile(diffs, 0.9999) <= 1e-3
    assert diffs.max() <= 0.05


@pytest.mark.parametrize("seed", [0, 11])
def test_seeded_init_is_bit_equal_to_jax(seed):
    """``Mixtral.init_weights(seed)`` draws ``Mixtral.init(jax.random.key(
    seed))``'s bits: every scope and counter, the router transposed, the
    expert stacks in the flax layout."""
    cfg = dataclasses.replace(JConfig.tiny(), dtype="float32", remat=True)
    ref = flatten_tree(JMixtral(cfg).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32)))
    tm = Mixtral(dataclasses.replace(MixtralConfig.tiny(), dtype="float32", remat=True),
                 device="cpu").init_weights(seed)
    got = llama_params_to_flat(tm)
    assert set(got) == set(ref)
    for name, arr in ref.items():
        assert np.array_equal(got[name].view(np.uint32), np.asarray(arr).view(np.uint32)), name
    assert got["params/layers_1/moe/w_down"].shape == (4, 128, 64)
    assert got["params/layers_0/moe/gate/kernel"].shape == (64, 4)


def _dropless_greedy(tm, prompt, n):
    """Greedy tokens of the drop-free full forward, no cache (its logits
    held to the JAX package's by the plain-forward test)."""
    ids = torch.tensor([prompt])
    with torch.no_grad():
        for _ in range(n):
            logits, _aux = tm(ids, dropless=True)
            ids = torch.cat([ids, logits[:, -1].argmax(-1)[:, None]], dim=1)
    return ids[0, len(prompt):].tolist()


def test_cached_decode_equals_the_dropless_forward():
    """``generate`` and the paged pool (ragged attention, blocks of 4,
    prefill chunks of 8, mid-decode admission) give the drop-free full
    forward's greedy tokens, whatever the capacity route would drop."""
    _, _, tm = mixtral_pair(6, **DROPPING)
    prompts = [[3, 1, 4, 1, 5, 9, 2], [2, 7, 1, 8, 2, 8, 1], [(i * 7 + 3) % 50 + 1 for i in range(13)]]
    want = [_dropless_greedy(tm, p, 10) for p in prompts]
    assert generate(tm, prompts[:2], 10).tolist() == want[:2]
    pool = DecodePool(tm, slots=2, max_len=64, steps_per_call=2, block_size=4, num_blocks=16,
                      prefill_chunk=8, ragged=True)
    try:
        futs = [pool.submit([p], 10) for p in prompts]
        got = [f.result(timeout=120)[0] for f in futs]
    finally:
        pool.close()
    assert got == want
    with torch.no_grad():  # the capacity route would have answered otherwise
        capacity, _ = tm(torch.tensor([prompts[2] + want[2]]))
    assert capacity[0, len(prompts[2]) - 1:-1].argmax(-1).tolist() != want[2]


def test_hf_state_dict_round_trips_through_the_converters():
    """``hf_state_dict`` unstacks the experts into HF Mixtral's
    ``experts.{e}.w1|w2|w3``: the port's ``convert_state_dict`` stacks
    them back to every tensor unchanged, and the reference's converter
    gives the same flat parameters."""
    model, cfg = build_model({"family": "mixtral", "preset": "tiny"}, device="cpu")
    assert cfg.num_experts == 4 and isinstance(model, Mixtral)
    model.init_weights(3)
    state = model.state_dict()
    hf = TC.hf_state_dict(state)
    assert "model.layers.0.block_sparse_moe.experts.3.w2.weight" in hf
    assert hf["model.layers.1.block_sparse_moe.experts.0.w1.weight"].shape == (128, 64)
    assert "model.layers.0.block_sparse_moe.gate.weight" in hf
    back = TC.convert_state_dict("mixtral", hf, model)
    assert set(back) == set(state)
    for name, t in state.items():
        assert torch.equal(back[name], t), name
    template = JMixtral(JConfig.tiny()).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    ref = flatten_tree(JC.convert_state_dict("mixtral", {k: v.numpy() for k, v in hf.items()},
                                             template))
    got = llama_params_to_flat(model)
    assert set(got) == set(ref)
    for name, arr in ref.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_registry_builds_mixtral_and_refuses_lora():
    """Presets ``tiny`` and ``8x7b``; an ``hf_config`` builds the default
    config plus the overrides, as the reference's registry does (its
    ``MixtralConfig`` has no ``from_hf``); LoRA fields are refused."""
    model, cfg = build_model({"family": "mixtral", "preset": "8x7b"}, device="meta")
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_experts) == (4096, 14336, 8)
    assert model.layers[0].moe.w_down.shape == (8, 14336, 4096)
    _, cfg = build_model({"family": "mixtral", "hf_config": {"hidden_size": 64},
                          "config": {"num_layers": 1}}, device="meta")
    assert cfg == dataclasses.replace(MixtralConfig(), num_layers=1)
    with pytest.raises(TypeError):
        build_model({"family": "mixtral", "preset": "tiny", "config": {"lora_rank": 4}},
                    device="meta")


def test_smoke_moe_job_and_checks_run_on_the_cpu():
    """The smoke's ``train_moe`` job (``chip_smoke.run_moe_job``: the port's
    nodes, one in-process trainer, int8 Δθ) on a 1-layer tiny Mixtral that
    drops picks: ``moe_train_problems`` finds nothing (the flash counts are
    the card's), every step records its aux loss and ``drop_frac``, both
    merges are θ_t + u; and ``serve_moe``'s checks on a tiny model: the
    pool's routing recorded by (prompt, position) for every token, the
    plain path routed alike giving the pool's tokens, and a paged prefill
    chunk within ``MOE_LOGIT_TOL`` of the plain forward routed alike."""
    import asyncio
    import shutil
    import tempfile
    from pathlib import Path

    import chip_smoke as cs
    from hypha_tpu_torch.ops.kvcache import KVCache
    from hypha_tpu_torch.worker.infer_executor import load_model

    model = {"model_type": "causal-lm", "family": "mixtral", "preset": "tiny", "seed": 0,
             "config": {"num_layers": 1, "remat": True, "capacity_factor": 0.5}}
    theta = cs.ThetaTrack(model, "cpu")
    root = Path(tempfile.mkdtemp(prefix="hmo"))
    try:
        run = asyncio.run(cs.run_moe_job(root, model, device="cpu", rounds=2, steps=4, batch=2,
                                         seq=32, period=200, status_timeout=120,
                                         record_step=lambda fn: (fn(), {"profiled": True})))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    batches = sum(p["kind"] == "status" for p in run["rec"]["progress"])
    assert batches == 8
    assert cs.moe_train_problems(run, rounds=2, theta0=theta.checksum(theta.theta0),
                                 launches={}, batches=batches, layers=1, device="cpu") == []
    moe = run["moe"]
    assert moe["profiled"] == {"profiled": True} and len(moe["merges"]) == 2
    assert all(0 < d["layers_0/moe/drop_frac"] < 1 for d in moe["drop_frac"])
    frames = run["rec"]["deltas"][0]["frame"]
    assert frames["codec"] == "int8" and frames["tensors"]["params/layers_0/moe/w_down"] == (4, 128, 64)

    served = load_model({"family": "mixtral", "preset": "tiny", "seed": 1,
                         "config": {"hidden_size": 256, "max_seq_len": 512}}, device="cpu")
    prompts = cs.make_prompts(3, [17, 40, 70], vocab=256)
    with cs.pool_routing(served, pool := DecodePool(
            served, slots=4, max_len=512, steps_per_call=8, block_size=16, prefill_chunk=64,
            ragged=True)) as routed:
        try:
            again = [f.result(timeout=300)[0] for f in [pool.submit([p], 24) for p in prompts]]
        finally:
            pool.close()
    splits, missing = cs.pinned_splits(served, prompts, again, routed)
    assert missing == [] and splits == []  # the plain path routed as the pool: equal on the CPU
    ids = torch.tensor(cs.make_prompts(97, [64] * 4, vocab=256))
    cache = KVCache.for_model(served, 4, 1024, per_row=True, blocks=32, block_size=16, ragged=True)
    cache.table[:, :4] = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    with torch.inference_mode():
        with cs.router_tape(served) as paged_routes:
            paged = served(ids, cache)[0]
        with cs.router_tape(served) as plain_routes:
            free = served(ids, dropless=True)[0]
        with cs.router_tape(served, paged_routes):
            plain = served(ids, dropless=True)[0]
    assert len(paged_routes) == len(plain_routes) == 2
    assert float((paged - plain).abs().max()) <= cs.MOE_LOGIT_TOL * float(plain.abs().max())
    flips = cs.routing_flips(plain_routes, paged_routes, 2)
    assert all(gap >= 0 for *_, gap in flips)
    if flips:  # a forward that routes elsewhere computes something else
        assert not torch.equal(free, plain)
