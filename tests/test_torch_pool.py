"""Port parity: serving. One-shot ``generate`` and the paged+ragged
``DecodePool`` of hypha_tpu_torch against the JAX package's on a tiny f32
Llama with identical weights: greedy token streams must be equal, through
mid-decode admission, EOS release and preemption under a small pool, and
with int8 KV blocks. Plus backpressure, the unported options, the
``PoolServer`` async path, and traced requests (their prefill and decode
spans, the preemption events)."""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np
import pytest
import torch

from _torch_parity import tiny_pair
from hypha_tpu.executor.generate import generate as j_generate
from hypha_tpu.executor.pool import DecodePool as JPool
from hypha_tpu_torch.executor.generate import generate
from hypha_tpu_torch.executor.pool import DecodePool, PoolBusy
from hypha_tpu_torch.worker.continuous import PoolServer
from hypha_tpu_torch.worker.infer_executor import generate_grouped, load_model

PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1, 8], [9] * 13, [(i * 7 + 3) % 50 + 1 for i in range(21)]]
N_NEW = [24, 24, 10, 16]
POOL = dict(slots=4, max_len=64, steps_per_call=2, block_size=8, num_blocks=7,
            prefill_chunk=8, reserve_blocks=1, ragged=True)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair("llama", seed=4)


def test_generate_greedy_matches_jax(pair):
    jm, variables, tm = pair
    for p in PROMPTS[:2]:
        ref = np.asarray(j_generate(jm, variables, np.asarray([p], np.int32), 12))
        got = generate(tm, [p], 12)
        assert got.dtype == torch.int32
        assert got.tolist() == ref.tolist()


def _burst(pool):
    """Mid-decode admission: the first request is decoding before the
    rest arrive, so the rest admit into a running pool (and, with 7
    blocks, force preemption)."""
    first = pool.submit([PROMPTS[0]], N_NEW[0])
    deadline = time.time() + 120
    while pool.chunks < 1 and not first.done():
        assert time.time() < deadline
        time.sleep(0.002)
    futs = [first] + [pool.submit([p], n) for p, n in zip(PROMPTS[1:], N_NEW[1:])]
    return [f.result(timeout=300)[0] for f in futs]


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_pool_streams_match_jax_pool(pair, kv_quant):
    jm, variables, tm = pair
    # An EOS id that one stream emits mid-way: that row must release
    # early and pad to its budget, in both packages.
    eos = generate(tm, [PROMPTS[1]], 8)[0, 4].item()
    kw = dict(POOL, kv_quant=kv_quant, eos_token_id=eos)
    jpool = JPool(jm, variables, **kw)
    try:
        ref = _burst(jpool)
    finally:
        jpool.close()
    pool = DecodePool(tm, **kw)
    try:
        got = _burst(pool)
    finally:
        pool.close()
    assert got == ref
    assert pool.preemptions >= 1, "a 7-block pool must preempt this burst"
    assert eos in got[1] and got[1][-1] == eos


def test_pool_matches_generate_and_reuses_lanes(pair):
    _, _, tm = pair
    pool = DecodePool(tm, **dict(POOL, num_blocks=16))
    try:
        for _ in range(2):  # the second round runs on released lanes/blocks
            got = pool.submit([PROMPTS[2], PROMPTS[3]], 10).result(timeout=300)
            assert got == [generate(tm, [p], 10)[0].tolist() for p in PROMPTS[2:]]
        assert pool.free_blocks() == 16 and pool.live_rows() == 0
    finally:
        pool.close()


def test_pool_backpressure_and_close(pair):
    _, _, tm = pair
    pool = DecodePool(tm, **dict(POOL, slots=1, max_queue=1))
    futs = []
    for _ in range(4):
        futs.append(pool.submit([PROMPTS[0]], 24))
    busy = [f for f in futs if f.done() and isinstance(f.exception(), PoolBusy)]
    assert len(busy) >= 2 and busy[0].exception().retry_after_s > 0
    pool.close()
    for f in futs:
        assert f.done()
    late = pool.submit([PROMPTS[0]], 4)
    assert isinstance(late.exception(timeout=5), RuntimeError)


def test_pool_rejects_what_it_cannot_serve(pair):
    _, _, tm = pair
    pool = DecodePool(tm, **POOL)
    try:
        assert not pool.fits([PROMPTS[0]], 60)
        with pytest.raises(ValueError):
            pool.submit([PROMPTS[0]], 60).result(timeout=5)
        with pytest.raises(ValueError):
            pool.submit([], 4).result(timeout=5)
    finally:
        pool.close()


@pytest.mark.parametrize("option", [dict(block_size=0),
                                    dict(spec_ngram=3), dict(spec_layers=1),
                                    dict(spec_draft=4), dict(draft_params={"w": 0})])
def test_unported_options_raise(pair, option):
    """The options refused until speculative decoding and the fixed-slot
    pool were ported: each is accepted now, as the JAX pool accepts it,
    and the pool serves with it the tokens of one-shot greedy decoding
    (``draft_params`` without a ``draft_model`` is inert in both)."""
    jm, variables, tm = pair
    kw = {**POOL, **option}
    if kw["block_size"] == 0:
        kw["ragged"] = False  # paged-only, as in the reference
    ref = np.asarray(j_generate(jm, variables, np.asarray([PROMPTS[1]], np.int32), 12))
    jpool = JPool(jm, variables, **kw)
    jpool.close()
    pool = DecodePool(tm, **kw)
    try:
        assert pool.submit([PROMPTS[1]], 12).result(timeout=120) == ref.tolist()
    finally:
        pool.close()


def test_fixed_slot_pool_matches_jax_and_the_paged_pool(pair):
    """Fixed-slot mode (``block_size=0``): a group of three prompts and two
    more requests admitted into the running pool give the JAX fixed-slot
    pool's tokens and the port's paged pool's."""
    jm, variables, tm = pair
    geo = dict(slots=4, max_len=64, steps_per_call=2)
    reqs = [(PROMPTS[:3], 10), ([PROMPTS[3]], 16), ([[5, 6, 7]], 6)]

    def run(pool):
        try:
            futs = [pool.submit(p, n) for p, n in reqs]
            return [f.result(timeout=300) for f in futs], pool
        finally:
            pool.close()

    want, _ = run(JPool(jm, variables, **geo))
    got, fixed = run(DecodePool(tm, **geo))
    paged, _ = run(DecodePool(tm, **geo, block_size=8, prefill_chunk=16, ragged=True))
    assert got == want
    assert got == paged
    assert fixed.chunks >= 1 and fixed.free_blocks() == geo["slots"]
    assert fixed.prefill_chunks == len(reqs)  # one prefill per admitted group


def test_traced_requests_file_prefill_and_decode_spans(pair, tmp_path):
    """A request's context (``traceparent``, refused until tracing was
    ported) parents its group's spans: one ``decode`` span from admission
    to the answer, and a ``prefill`` span for every chunk that served it
    (the reference files one per chunk, under its oldest group). The
    burst's preemptions are flight events in both packages, and tracing
    changes no token."""
    from hypha_tpu.telemetry import trace as jtrace
    from hypha_tpu.telemetry.flight import FLIGHT as JFLIGHT
    from hypha_tpu_torch.telemetry import trace as ttrace
    from hypha_tpu_torch.telemetry.flight import FLIGHT

    jm, variables, tm = pair
    tps = [f"{i + 1:032x}-{i + 17:016x}" for i in range(len(PROMPTS))]

    def burst(pool):
        first = pool.submit([PROMPTS[0]], N_NEW[0], traceparent=tps[0])
        deadline = time.time() + 120
        while pool.chunks < 1 and not first.done():
            assert time.time() < deadline
            time.sleep(0.002)
        futs = [first] + [pool.submit([p], n, traceparent=tp)
                          for p, n, tp in zip(PROMPTS[1:], N_NEW[1:], tps[1:])]
        return [f.result(timeout=300)[0] for f in futs]

    untraced = DecodePool(tm, **POOL)
    try:
        want = _burst(untraced)
    finally:
        untraced.close()
    FLIGHT.clear()
    JFLIGHT.clear()
    jtrace.enable(tmp_path / "jax", node="jax")
    ttrace.enable(tmp_path / "port", node="port")
    try:
        jpool, pool = JPool(jm, variables, **POOL), DecodePool(tm, **POOL)
        try:
            assert burst(jpool) == burst(pool) == want
        finally:
            jpool.close()
            pool.close()
    finally:
        jtrace._reset_for_tests()
        ttrace._reset_for_tests()
    spans = [json.loads(x) for x in (tmp_path / "port" / "spans-port.jsonl").read_text()
             .splitlines()]
    for tp in tps:
        trace_id, parent = tp.split("-")
        mine = [s for s in spans if s["trace_id"] == trace_id]
        assert all(s["parent_id"] == parent for s in mine)
        assert [s["name"] for s in mine].count("decode") == 1
        assert [s["name"] for s in mine].count("prefill") >= 1
    preempts = [e for e in FLIGHT.snapshot() if e["event"] == "serve.preempt"]
    jpreempts = [e for e in JFLIGHT.snapshot() if e["event"] == "serve.preempt"]
    # When a burst preempts depends on when it arrives against the chunks:
    # each package records one event for each of its own preemptions.
    assert len(preempts) == pool.preemptions >= 1 and len(jpreempts) == jpool.preemptions
    assert {tuple(e["attrs"]) for e in preempts + jpreempts} == {("rows", "order", "emitted")}
    FLIGHT.clear()
    JFLIGHT.clear()


def test_prefix_cache_option_runs(pair):
    """``prefix_cache=True`` (refused until the prefix cache was ported)
    serves through ``PoolServer``: a repeat maps the cached blocks and
    answers as one-shot ``generate``."""
    _, _, tm = pair

    async def run():
        server = PoolServer(tm, None, prefix_cache=True, **dict(POOL, num_blocks=16))
        try:
            first = await server.submit([PROMPTS[3]], 6, 0.0, None, 0)
            again = await server.submit([PROMPTS[3]], 6, 0.0, None, 0)
            return server.pool, first, again
        finally:
            server.close()

    pool, first, again = asyncio.run(run())
    assert first == again == [generate(tm, [PROMPTS[3]], 6)[0].tolist()]
    assert pool.prefix_cache and pool.hit_blocks == 2 and pool.miss_blocks == 2


def test_inert_reference_options_are_accepted(pair):
    """The JAX PoolServer always passes digest_k, and callers pass
    draft_params=None and traceparent=None: each is inert here."""
    _, _, tm = pair

    async def run():
        server = PoolServer(tm, None, digest_k=32, draft_params=None, spec_draft=0, **POOL)
        try:
            return await server.submit([PROMPTS[0]], 4, 0.0, None, 0, traceparent=None)
        finally:
            server.close()

    assert asyncio.run(run()) == [generate(tm, [PROMPTS[0]], 4)[0].tolist()]


def test_pool_server_async_path(pair):
    _, _, tm = pair

    def fallback(prompts, n_new, temperature, top_k, seed):
        return generate_grouped(tm, prompts, n_new, temperature, top_k, seed)

    async def run():
        server = PoolServer(tm, fallback, **POOL)
        try:
            greedy = await asyncio.gather(*(server.submit([p], 8, 0.0, None, 0) for p in PROMPTS[:3]))
            oversized = await server.submit([PROMPTS[0]], 60, 0.0, None, 0)
            sampled = [await server.submit([PROMPTS[1]], 6, 0.8, 5, seed) for seed in (1, 1)]
            return server, greedy, oversized, sampled
        finally:
            server.close()

    server, greedy, oversized, sampled = asyncio.run(run())
    assert greedy == [[generate(tm, [p], 8)[0].tolist()] for p in PROMPTS[:3]]
    assert oversized == [generate(tm, [PROMPTS[0]], 60)[0].tolist()]
    assert sampled[0] == sampled[1] and len(sampled[0][0]) == 6  # seeded
    assert server.requests == 6 and server.fallbacks == 3
    assert server.load()["free_blocks"] == POOL["num_blocks"]


def test_load_model_casts_for_serving():
    spec = {"family": "llama", "preset": "tiny", "seed": 1}
    model = load_model(spec, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    f32 = load_model({**spec, "serve_dtype": "float32"}, device="cpu")
    assert all(p.dtype == torch.float32 for p in f32.parameters())
    for a, b in zip(model.parameters(), f32.parameters()):
        assert torch.equal(a, b.to(torch.bfloat16))  # same seed, same draws
    with pytest.raises(ValueError):
        load_model({**spec, "serve_dtype": "float16"}, device="cpu")
