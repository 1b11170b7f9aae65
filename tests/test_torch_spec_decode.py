"""Port parity: speculative decoding. The cases of ``tests/test_spec_decode.py``
run through the JAX package's ``DecodePool`` and the port's on the same tiny
f32 Llama (the JAX package's seeded init, carried into the port through
``models/convert.py``): each compares the token streams, the verify
dispatches (``spec_chunks``), the decode chunks and the proposed and
accepted draft counts, and holds both to one-shot greedy ``generate``."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from hypha_tpu.executor.generate import generate
from hypha_tpu.executor.pool import DecodePool as JPool
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.models import Llama as JLlama
from hypha_tpu.models import LlamaConfig as JConfig
from hypha_tpu.telemetry import SERVE_METRICS as J_METRICS
from hypha_tpu_torch.executor.pool import DecodePool, SpeculationState, _PRow
from hypha_tpu_torch.models import Llama
from hypha_tpu_torch.models import LlamaConfig as TConfig
from hypha_tpu_torch.models.convert import llama_params_from_flat, llama_params_to_flat
from hypha_tpu_torch.telemetry import SERVE_METRICS as T_METRICS


def _pair(num_layers: int = 2, seed: int = 0):
    cfg = dataclasses.replace(JConfig.tiny(), dtype="float32", num_layers=num_layers)
    jm = JLlama(cfg)
    params = jm.init(jax.random.key(seed), np.zeros((1, 8), np.int32))
    tm = Llama(dataclasses.replace(TConfig.tiny(), dtype="float32", num_layers=num_layers),
               device="cpu")
    llama_params_from_flat(flatten_tree(params), tm)
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def _ref(jm, params, prompt, n_new):
    return np.asarray(generate(jm, params, np.asarray([prompt], np.int32), n_new))[0].tolist()


def _run(tiny, prompts, n_new, **kw) -> list:
    """Each prompt through a JAX pool and a port pool built alike, one
    request at a time: (tokens, spec_chunks, chunks, proposed, accepted)
    per package."""
    jm, params, tm = tiny
    out = []
    for pkg in ("jax", "torch"):
        metrics = J_METRICS if pkg == "jax" else T_METRICS
        metrics.reset()
        pool = JPool(jm, params, **kw) if pkg == "jax" else DecodePool(tm, **kw)
        try:
            toks = [pool.submit([list(p)], n_new).result(timeout=300)[0] for p in prompts]
            snap = metrics.snapshot()
            out.append((toks, pool.spec_chunks, pool.chunks, snap["spec_proposed"],
                        snap["spec_accepted"]))
        finally:
            pool.close()
    return out


def test_spec_decode_token_identical(tiny):
    jm, params, _ = tiny
    prompts = [[5, 9, 2], [1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2], [7] * 20, [4, 4, 8, 4, 4, 8, 4, 4]]
    j, t = _run(tiny, prompts, 40, slots=4, max_len=256, steps_per_call=4, block_size=8,
                num_blocks=64, prefill_chunk=16, spec_ngram=2)
    assert t == j
    assert t[0] == [_ref(jm, params, p, 40) for p in prompts]


def test_spec_accept_rate_and_dispatch_savings(tiny):
    jm, params, _ = tiny
    p, n_new = [1, 2, 3, 1, 2, 3, 1, 2], 48
    j, t = _run(tiny, [p], n_new, slots=2, max_len=256, steps_per_call=4, block_size=8,
                num_blocks=64, prefill_chunk=16, spec_ngram=2)
    assert t == j
    toks, spec_chunks, chunks, proposed, accepted = t
    assert toks == [_ref(jm, params, p, n_new)]
    assert spec_chunks >= 1 and proposed > 0 and accepted > 0
    assert chunks < n_new / 4


def test_spec_with_prefix_cache_and_eos(tiny):
    jm, params, tm = tiny
    first = _ref(jm, params, [3, 3, 3], 2)[0]
    geo = dict(slots=2, max_len=128, steps_per_call=2, block_size=8, num_blocks=32,
               prefill_chunk=8, eos_token_id=int(first))
    plain = _run(tiny, [[3, 3, 3]], 12, **geo)
    assert plain[1][0] == plain[0][0]
    for kw in (dict(spec_ngram=2, prefix_cache=True), dict(spec_ngram=3)):
        j, t = _run(tiny, [[3, 3, 3]], 12, **geo, **kw)
        assert t == j and t[0] == plain[0][0], kw


def test_spec_backoff_floors_at_plain_decode(tiny):
    jm, params, _ = tiny
    p, n_new = [1, 2, 3, 4, 5, 6, 7, 8] * 2, 64
    j, t = _run(tiny, [p], n_new, slots=2, max_len=256, steps_per_call=4, block_size=8,
                num_blocks=64, prefill_chunk=16, spec_ngram=3)
    assert t == j
    toks, spec_chunks, chunks, _, _ = t
    assert toks == [_ref(jm, params, p, n_new)]
    assert chunks > spec_chunks


def test_spec_requires_paged_and_defaults_off(tiny):
    jm, params, tm = tiny
    for pool_cls, args in ((JPool, (jm, params)), (DecodePool, (tm,))):
        with pytest.raises(ValueError, match="speculative decoding requires"):
            pool_cls(*args, slots=2, max_len=64, spec_ngram=2)
        pool = pool_cls(*args, slots=2, max_len=64, steps_per_call=2, block_size=8,
                        num_blocks=16, prefill_chunk=8)
        try:
            assert pool.spec_ngram == 0 and pool.spec_chunks == 0 and not pool.spec_model
        finally:
            pool.close()


def test_spec_draft_cap_respects_chunk_width(tiny):
    jm, params, _ = tiny
    geo = dict(slots=2, max_len=64, steps_per_call=2, block_size=8, num_blocks=16,
               prefill_chunk=8, spec_ngram=2, spec_draft=100)
    j, t = _run(tiny, [[6, 6, 6, 6]], 10, **geo)
    assert t == j and t[0] == [_ref(jm, params, [6, 6, 6, 6], 10)]
    pool = DecodePool(tiny[2], **geo)
    try:
        assert pool.spec_draft == pool.prefill_chunk - 1
    finally:
        pool.close()


def test_model_draft_token_identical(tiny):
    jm, params, _ = tiny
    prompts = [[5, 9, 2], [17, 3, 200, 45, 91, 8, 120, 7], [1, 2, 3, 1, 2, 3, 1, 2]]
    j, t = _run(tiny, prompts, 24, slots=4, max_len=256, steps_per_call=4, block_size=8,
                num_blocks=64, prefill_chunk=16, spec_layers=1, spec_draft=4)
    assert t == j
    assert t[0] == [_ref(jm, params, p, 24) for p in prompts]
    assert t[1] >= 1


def test_model_draft_validation(tiny):
    jm, params, tm = tiny
    paged = dict(slots=2, max_len=64, block_size=8, num_blocks=16, prefill_chunk=8)
    for pool_cls, args in ((JPool, (jm, params)), (DecodePool, (tm,))):
        with pytest.raises(ValueError, match="requires paged mode"):
            pool_cls(*args, slots=2, max_len=64, spec_layers=1)
        with pytest.raises(ValueError, match="spec_layers 2 must be in"):
            pool_cls(*args, **paged, spec_layers=2)
        with pytest.raises(ValueError, match="draft_model requires"):
            pool_cls(*args, **paged, draft_model=jm if pool_cls is JPool else tm)
        with pytest.raises(ValueError, match="exclusive"):
            pool_cls(*args, **paged, spec_layers=1, draft_model=jm if pool_cls is JPool else tm,
                     draft_params=params)


def test_explicit_draft_model_token_identical(tiny):
    """A separate one-layer draft with its own seeded weights: the JAX pool
    takes its variables, the port's its flat names (``models/convert.py``)."""
    jm, params, tm = tiny
    djm, dparams, _ = _pair(num_layers=1, seed=1)
    dtm = Llama(dataclasses.replace(TConfig.tiny(), dtype="float32", num_layers=1), device="cpu")
    p = [9, 1, 44, 7, 130]
    geo = dict(slots=2, max_len=128, steps_per_call=4, block_size=8, num_blocks=32,
               prefill_chunk=16, spec_draft=3)
    out = []
    for pool in (JPool(jm, params, draft_model=djm, draft_params=dparams, **geo),
                 DecodePool(tm, draft_model=dtm, draft_params=flatten_tree(dparams), **geo)):
        try:
            out.append((pool.submit([p], 16).result(timeout=300), pool.spec_chunks,
                        pool.chunks))
        finally:
            pool.close()
    assert out[1] == out[0]
    assert out[1][0] == [_ref(jm, params, p, 16)]


def test_shared_backoff_state_between_proposers(tiny):
    """One ``SpeculationState`` per lane: the cooldown parks both
    proposers, and with no n-gram match the model draft proposes, the
    same drafts as the JAX pool's."""
    from hypha_tpu.executor.pool import SpeculationState as JState
    from hypha_tpu.executor.pool import _PRow as JRow

    jm, params, tm = tiny
    geo = dict(slots=2, max_len=256, steps_per_call=4, block_size=8, num_blocks=64,
               prefill_chunk=16, spec_ngram=3, spec_layers=1, spec_draft=4)
    drafts = []
    for pool, row, state in ((JPool(jm, params, **geo), JRow, JState),
                             (DecodePool(tm, **geo), _PRow, SpeculationState)):
        try:
            r = row(group=None, lane=0, prompt=[1, 2, 3], budget=64)
            r.emitted = [4]
            r.spec = state(ewma=0.2, cooldown=3, primed=True)
            assert pool._propose(r) is None
            assert r.spec.cooldown == 2
            r.spec.cooldown = 0
            d = pool._propose(r)
            assert d is not None and len(d) >= 1
            drafts.append(d)
        finally:
            pool.close()
    assert drafts[1] == drafts[0]


def test_budget_edge_final_token_ships_as_zero_draft_verify(tiny):
    jm, params, _ = tiny
    p = [11, 3, 7, 150]
    ref = _ref(jm, params, p, 2)
    geo = dict(slots=2, max_len=128, steps_per_call=4, block_size=8, num_blocks=32,
               prefill_chunk=16)
    for kw in (dict(spec_ngram=2), dict(spec_layers=1, spec_draft=4)):
        j, t = _run(tiny, [p], 2, **geo, **kw)
        assert t == j, kw
        toks, spec_chunks, chunks, proposed, accepted = t
        assert toks == [ref] and chunks == 0 and spec_chunks >= 1, kw
        assert proposed == 0 and accepted == 0  # zero-draft verifies count nothing


def test_self_draft_follows_a_live_weight_swap(tiny):
    """The self-draft shares the served model's modules: after a swap its
    proposals are the new weights' (the JAX pool filters the live tree)."""
    jm, params, tm = tiny
    _, _, fresh = _pair(seed=5)
    pool = DecodePool(fresh, slots=2, max_len=256, steps_per_call=4, block_size=8,
                      num_blocks=64, prefill_chunk=16, spec_layers=1, spec_draft=4)
    try:
        r = _PRow(group=None, lane=0, prompt=[5, 9, 2, 7], budget=64)
        r.emitted = [3]
        before = pool._propose(r)
        flat = {k.removeprefix("params/"): np.asarray(v) for k, v in flatten_tree(params).items()}
        have = {k.removeprefix("params/"): v for k, v in llama_params_to_flat(fresh).items()}
        pool.request_swap({k: flat[k] - have[k] for k in flat}, round_num=1)
        pool.submit([[1, 2]], 1).result(timeout=60)  # the serve loop flips first
        r2 = _PRow(group=None, lane=0, prompt=[5, 9, 2, 7], budget=64)
        r2.emitted = [3]
        after = pool._propose(r2)
    finally:
        pool.close()
    jpool = JPool(jm, params, slots=2, max_len=256, steps_per_call=4, block_size=8,
                  num_blocks=64, prefill_chunk=16, spec_layers=1, spec_draft=4)
    try:
        from hypha_tpu.executor.pool import _PRow as JRow

        jr = JRow(group=None, lane=0, prompt=[5, 9, 2, 7], budget=64)
        jr.emitted = [3]
        want = jpool._propose(jr)
    finally:
        jpool.close()
    assert after == want
    assert before is not None


def test_smoke_settled_requests_cut_into_each_short_cycle():
    """``chip_smoke.settled_requests`` (the ``serve_spec`` phase's traffic
    on which every lane proposes): per answer its longest stretch of period
    1-4; those of 16 tokens or more, cut 8 tokens into the stretch with the
    rest of it (at most 24) as the budget, longest first, cycled to the
    lanes; an answer that never settles gives none."""
    import chip_smoke

    wander = list(range(100, 140))
    pair = [7, 8] * 10  # period 2, 20 tokens
    ones = [5] * 40  # period 1, 40 tokens
    contexts = [[1, 2], [3], [4]]
    answers = [[9, 10] + pair + [11], wander, [12] + ones]
    got, n_new, found = chip_smoke.settled_requests(contexts, answers, lanes=3)
    assert found == 2
    assert got == [[4, 12] + [5] * 8, [1, 2, 9, 10] + pair[:8], [4, 12] + [5] * 8]
    assert n_new == [24, 12, 24]
    assert chip_smoke.settled_requests([[1]], [wander], lanes=2) == ([], [], 0)
