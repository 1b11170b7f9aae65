"""Port parity: the paged pool's automatic prefix cache (the counterparts
of ``tests/test_prefix_cache.py``'s pool cases) and ``copy_blocks``.

Both packages' ``DecodePool`` with ``prefix_cache=True`` serve a tiny
2-layer Llama (hidden 64, weights carried across by ``models/convert.py``)
in blocks of 16, stepped synchronously (``_step_paged``) through the same
scripts: a shared prefix, a divergent append into a shared block
(copy-on-write), an exact repeat of an aligned prompt, LRU eviction under
pressure and a preempted resume that becomes a cache hit. After every step
the block tables are equal; at the end the tokens, the prefill chunks,
the hit and miss blocks and the copy-on-writes are, and the tokens equal
those of the port's pool with the cache off. f32 and int8 KV run against
the JAX pool; bf16 holds the cached pool against the uncached one in each
package (the packages' bf16 rounding differs). ``copy_blocks`` moves the
same bits as the JAX one on random pools with scales.
"""

from __future__ import annotations

from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import tiny_pair
from hypha_tpu.executor.pool import DecodePool as JPool
from hypha_tpu.executor.pool import _Group as JGroup
from hypha_tpu.ops.kvcache import copy_blocks as j_copy_blocks
from hypha_tpu.telemetry import SERVE_METRICS
from hypha_tpu_torch.executor.pool import DecodePool, _Group
from hypha_tpu_torch.ops.kvcache import KVCache, copy_blocks

BS = 16
SHARED = [(i * 7 + 3) % 250 + 1 for i in range(40)]
ALIGNED = [(i * 5 + 1) % 200 + 3 for i in range(32)]  # two full blocks


def _prompt(seed: int, n: int) -> list:
    return [int(t) for t in np.random.default_rng(seed).integers(1, 256, n)]


# name -> (pool options, script). A script is a list of ("park", prompt,
# n_new) and ("step", n) / ("drain",) events.
SCRIPTS = {
    "shared_prefix": (
        dict(num_blocks=40),
        [("park", SHARED + [9, 9, 4], 10), ("drain",),
         ("park", SHARED + _prompt(1, 21), 12), ("drain",),
         ("park", SHARED[:20] + _prompt(2, 5), 6), ("drain",)],
    ),
    "cow_divergent_append": (
        dict(num_blocks=40),
        [("park", ALIGNED, 40), ("step", 3), ("park", ALIGNED, 8),
         ("park", ALIGNED + [7], 8), ("drain",)],
    ),
    "exact_repeat": (
        dict(num_blocks=24, prefill_chunk=16),
        [("park", ALIGNED, 6), ("drain",), ("park", ALIGNED, 6), ("drain",),
         ("park", ALIGNED, 6), ("drain",)],
    ),
    "lru_eviction": (
        dict(num_blocks=8, slots=2),
        [ev for i in range(6) for ev in (("park", _prompt(10 + i, 33), 6), ("drain",))]
        + [("park", _prompt(15, 33), 6), ("drain",)],
    ),
    "preempt_resume": (
        dict(num_blocks=10, reserve_blocks=0),
        [("park", _prompt(20, 25), 60), ("park", _prompt(21, 25), 60), ("drain",)],
    ),
}
POOL = dict(slots=4, max_len=128, steps_per_call=4, block_size=BS, prefill_chunk=32,
            ragged=True)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return request.param, tiny_pair("llama", dtype=request.param, seed=7)


def _park(pool, group_cls, prompt, n_new):
    """Stage a group on the waiting line without waking the serve thread,
    which stays parked on the empty submit queue: the test steps the pool."""
    g = group_cls([list(prompt)], int(n_new), Future())
    with pool._submit_lock:
        pool._backlog += 1
    pool._waiting.append(g)
    return g


def _run(pool, group_cls, script, counters) -> dict:
    groups, tables = [], []

    def step():
        pool._step_paged()
        tables.append(pool._h_table.copy())
        pool._alloc.check_conservation([r.blocks for r in pool._lane_rows.values()])

    with torch.inference_mode():
        for ev in script:
            if ev[0] == "park":
                groups.append(_park(pool, group_cls, ev[1], ev[2]))
            elif ev[0] == "step":
                for _ in range(ev[1]):
                    step()
            else:
                for _ in range(400):
                    if all(g.fut.done() for g in groups):
                        break
                    step()
    pool._alloc.check_conservation([])
    return dict(tokens=[g.fut.result(timeout=1) for g in groups], tables=tables,
                prefill_chunks=pool.prefill_chunks, chunks=pool.chunks,
                preemptions=pool.preemptions, free=pool.free_blocks(),
                cached=pool._alloc.cached_count(), **counters(pool))


def _port(model, opts, script, cache=True) -> dict:
    pool = DecodePool(model, **{**POOL, **opts, "prefix_cache": cache})
    try:
        return _run(pool, _Group, script, lambda p: dict(
            hit=p.hit_blocks, miss=p.miss_blocks, cow=p.cow_copies))
    finally:
        pool.close()


def _jax(model, variables, opts, script, cache=True) -> dict:
    SERVE_METRICS.reset()
    pool = JPool(model, variables, **{**POOL, **opts, "prefix_cache": cache})
    try:
        return _run(pool, JGroup, script, lambda p: {
            k: SERVE_METRICS.snapshot()[m] for k, m in (
                ("hit", "prefix_hit_blocks"), ("miss", "prefix_miss_blocks"),
                ("cow", "cow_copies"))})
    finally:
        pool.close()


def _same(got: dict, ref: dict) -> None:
    assert len(got["tables"]) == len(ref["tables"])
    for i, (a, b) in enumerate(zip(got["tables"], ref["tables"])):
        assert np.array_equal(a, b), f"block tables differ after step {i}"
    for key in ("tokens", "prefill_chunks", "chunks", "preemptions", "free", "cached", "hit",
                "miss", "cow"):
        assert got[key] == ref[key], key


@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_prefix_cache_equals_the_jax_pool(pair, name, kv_quant):
    dtype, (jm, variables, tm) = pair
    opts, script = SCRIPTS[name]
    opts = dict(opts, kv_quant=kv_quant)
    got = _port(tm, opts, script)
    off = _port(tm, opts, script, cache=False)
    # The cache changes which work runs, never the tokens.
    assert got["tokens"] == off["tokens"]
    if dtype == "float32":
        _same(got, _jax(jm, variables, opts, script))
    else:
        ref = _jax(jm, variables, opts, script)
        assert ref["tokens"] == _jax(jm, variables, opts, script, cache=False)["tokens"]
    expect = {
        "shared_prefix": lambda r: r["hit"] >= 2 + 1 and r["prefill_chunks"] < off["prefill_chunks"],
        "cow_divergent_append": lambda r: r["cow"] >= 1 and r["hit"] >= 4,
        "exact_repeat": lambda r: r["hit"] == 4 and r["prefill_chunks"] == 2 + 1 + 1,
        # 14 blocks registered by 7 requests, at most 8 still cached; the
        # last request repeats the one before it and hits both its blocks.
        "lru_eviction": lambda r: r["free"] == 8 and r["cached"] <= 8 and r["hit"] == 2,
        "preempt_resume": lambda r: (r["preemptions"] >= 1 and r["hit"] >= 2
                                     and r["prefill_chunks"] < off["prefill_chunks"]),
    }[name]
    assert expect(got), {k: v for k, v in got.items() if k != "tables"}


def test_prefix_cache_off_keeps_the_uncached_pool(pair):
    """With the cache off nothing registers, hits or copies."""
    _, (_, _, tm) = pair
    opts, script = SCRIPTS["exact_repeat"]
    off = _port(tm, opts, script, cache=False)
    assert off["hit"] == off["miss"] == off["cow"] == off["cached"] == 0
    assert off["prefill_chunks"] == 6


def _pools(seed: int, quant: bool):
    """The same random paged pool as a JAX cache tree and a port KVCache."""
    rng = np.random.default_rng(seed)
    blocks, layers, hkv, d = 9, 2, 2, 16
    rows = (blocks + 1) * BS
    dt = np.int8 if quant else np.float32
    leaves = []
    for _ in range(layers):
        kv = {n: (rng.integers(-127, 128, (rows, hkv, d)) if quant
                  else rng.standard_normal((rows, hkv, d))).astype(dt) for n in ("k", "v")}
        if quant:
            kv.update({n: rng.random((rows, hkv)).astype(np.float32)
                       for n in ("k_scale", "v_scale")})
        leaves.append(kv)
    jtree = {f"layers_{i}": {"attn": {**{n: jnp.asarray(a) for n, a in kv.items()},
                                      "idx": jnp.zeros((3,), jnp.int32),
                                      "table": jnp.full((3, 4), blocks, jnp.int32)}}
             for i, kv in enumerate(leaves)}
    cache = KVCache(num_layers=layers, batch=3, decode_len=4 * BS, num_kv_heads=hkv,
                    head_dim=d, dtype=torch.float32, device="cpu", per_row=True,
                    blocks=blocks, block_size=BS, kv_quant="int8" if quant else "")
    for i, kv in enumerate(leaves):
        for n, a in kv.items():
            getattr(cache, n)[i].copy_(torch.from_numpy(a))
    return jtree, cache


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("src,dst", [([2], [5]), ([0, 3, 7], [8, 1, 4]), ([9], [0])])
def test_copy_blocks_bit_equal_to_jax(quant, src, dst):
    jtree, cache = _pools(len(src) + 10 * quant, quant)
    out = j_copy_blocks(jtree, jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), BS)
    assert copy_blocks(cache, torch.tensor(src), dst, BS) is cache
    names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    for i in range(2):
        for n in names:
            want = np.asarray(out[f"layers_{i}"]["attn"][n])
            got = getattr(cache, n)[i].numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), (i, n)
    assert cache.table.eq(9).all()  # row variables untouched
