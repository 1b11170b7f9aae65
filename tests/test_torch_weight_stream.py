"""Port parity: live weight swap (``hypha_tpu_torch/serving/weight_stream.py``
and the pool's ``request_swap`` / ``pin_round``) against the JAX package
(the cases of ``tests/test_weight_stream.py``).

* the stagers take the same wire sequences (out of order, stale re-sends,
  a generation change, pinned fragment counts) and release the same
  rounds with the same sums and counters;
* both pools, given the same tiny Llama in bf16 and in f32, serve
  bit-equal leaves after the same swaps, a fold, a pin's rollback and the
  roll-forward after it;
* after a swap a pool serves ``generate``'s tokens on the folded weights,
  no admission maps a chain cached before it, and no request fails while
  swaps roll; the block allocators agree and conserve blocks across
  generation bumps;
* stamped messages, and the unset follow, encode to the reference's bytes;
* end to end: a tiny blocking job with the broadcast tree and a torch
  follower hung off the relay, under the port's scheduler and under the
  JAX one (θ₀ from a ``source`` file): after each round the follower's
  tokens equal ``generate`` at θ₀ + Σu, its leaves a host fold.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import random
import shutil
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from _torch_parity import tiny_pair
from hypha_tpu import codec as jcodec
from hypha_tpu import messages as jmsg
from hypha_tpu.executor.block_cache import PrefixBlockCache as JAlloc
from hypha_tpu.executor.pool import DecodePool as JPool
from hypha_tpu.executor.serialization import flat_leaf_map, flatten_tree
from hypha_tpu.serving import WeightStager as JStager
from hypha_tpu.serving import follow_for as j_follow_for
from hypha_tpu.stream import with_serve_leaves as j_with_serve_leaves
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor.block_cache import PrefixBlockCache as TAlloc
from hypha_tpu_torch.executor.block_cache import chain_hashes
from hypha_tpu_torch.executor.generate import generate
from hypha_tpu_torch.executor.pool import DecodePool as TPool
from hypha_tpu_torch.serving import WeightStager as TStager
from hypha_tpu_torch.serving import follow_for as t_follow_for
from hypha_tpu_torch.stream import with_serve_leaves as t_with_serve_leaves

POOL = dict(slots=2, max_len=64, steps_per_call=4, block_size=8, num_blocks=24, prefill_chunk=8)


def _wait_round(pool, round_num, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pool.weight_state()[0] == round_num:
            return
        time.sleep(0.01)
    raise AssertionError(f"pool never reached round {round_num} (at {pool.weight_state()})")


# ---------------------------------------------------------------- stager

# Each case: the stager's options and its wire sequence (round, {name:
# value}, fragment id, fragments, generation).
STAGER = {
    "out of order": ({"start_round": 2}, [
        (4, {"a": 1.0}, 0, 1, None), (3, {"a": 1.0}, 1, 2, None), (3, {"b": 2.0}, 0, 2, None)]),
    "stale and resend": ({"start_round": 0}, [
        (1, {"a": 1.0}, 0, 1, None), (1, {"a": 1.0}, 0, 1, None), (3, {"a": 1.0}, 0, 1, None),
        (3, {"a": 5.0}, 0, 1, None), (2, {"a": 1.0}, 0, 1, None)]),
    "generation": ({"start_round": 0, "ps_generation": 1}, [
        (1, {"a": 1.0}, 0, 1, 1), (2, {"a": 1.0}, 0, 1, 2), (3, {"a": 0.5}, 0, 1, 2)]),
    "pinned fragments": ({"start_round": 0, "fragments": 1}, [
        (1, {"f0": 1.0}, 0, 4, None), (2, {"f1": 3.0}, 1, 4, None)]),
    "whole rounds of two": ({"start_round": -1}, [
        (0, {"f0": 1.0}, 0, 2, None), (1, {"f0": 2.0}, 0, 2, None), (0, {"f1": 0.25}, 1, 2, None),
        (1, {"f1": 0.5}, 1, 2, None), (1, {"f1": 0.75}, 1, 2, None)]),
}


@pytest.mark.parametrize("case", sorted(STAGER))
def test_stager_decisions_equal_the_reference(case):
    opts, wires = STAGER[case]
    stagers = {"jax": JStager(**opts), "port": TStager(**opts)}
    rng = np.random.default_rng(5)
    for r, arrays, fid, total, gen in wires:
        host = {k: (v * rng.standard_normal(3)).astype(np.float32) for k, v in arrays.items()}
        out = {}
        for k, s in stagers.items():
            given = host if k == "jax" else {n: torch.from_numpy(a.copy()) for n, a in host.items()}
            ready = s.offer(r, given, fragment_id=fid, fragments=total, ps_generation=gen)
            out[k] = [(rr, {n: np.asarray(v) for n, v in u.items()}) for rr, u in ready]
        assert [rr for rr, _ in out["port"]] == [rr for rr, _ in out["jax"]]
        for (_, tu), (_, ju) in zip(out["port"], out["jax"]):
            assert sorted(tu) == sorted(ju)
            for n in ju:
                assert tu[n].tobytes() == ju[n].tobytes(), n
        for attr in ("applied_round", "generation", "dropped_stale", "rounds_ready",
                     "generation_changes"):
            assert getattr(stagers["port"], attr) == getattr(stagers["jax"], attr), attr
        assert stagers["port"].held_rounds() == stagers["jax"].held_rounds()


def test_follow_for_and_serve_leaves_equal_the_reference():
    kw = dict(groups=[["w0", "w1", "w2"], ["w3"]], start_round=7, fragments=1,
              keep_previous=True, pin_round=5)
    j, t = j_follow_for("results:job", ["ps1", "ps0"], **kw), \
        t_follow_for("results:job", ["ps1", "ps0"], **kw)
    assert tmsg.encode(t) == jmsg.encode(j)
    assert t.results.ref.peers == ["ps0", "ps1", "w0"] and tmsg.decode(tmsg.encode(t)) == t
    groups = [["w0", "w1"], ["w2", "w3"], ["w4"]]
    for leaves in (["s1", "s0", "w0"], [], ["s9"], ["a", "b", "c", "d"]):
        assert t_with_serve_leaves(groups, leaves) == j_with_serve_leaves(groups, leaves)
    assert groups == [["w0", "w1"], ["w2", "w3"], ["w4"]]


# ------------------------------------------------------------- pool swap


def _pools(dtype: str):
    """A JAX pool and a port pool over the same tiny Llama, leaves in
    ``dtype``."""
    jm, variables, tm = tiny_pair("llama", dtype=dtype, seed=3)
    if dtype == "bfloat16":
        variables = jax.tree.map(lambda x: x.astype(jnp.bfloat16), variables)
        tm = tm.to(torch.bfloat16)
    tm.requires_grad_(False).eval()
    return (JPool(jm, variables, **POOL), TPool(tm, **POOL), variables, tm)


def _deltas(variables, seed: int, scale: float = 0.01) -> dict:
    rng = np.random.default_rng(seed)
    return {f"params/{n}": (rng.standard_normal(np.shape(v)) * scale).astype(np.float32)
            for n, v in flat_leaf_map(variables["params"]).items()}


def _bits(a) -> bytes:
    a = np.ascontiguousarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32).tobytes()


def _port_leaves(pool) -> dict:
    out = {}
    for name in pool._params():
        mod, attr, transposed = pool._leaf(name)
        t = getattr(mod, attr).detach()
        t = (t.T if transposed else t).contiguous()
        out[name] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return out


def _assert_leaves_equal(jpool, tpool):
    jl = flat_leaf_map(jpool._vars["params"])
    tl = _port_leaves(tpool)
    assert sorted(tl) == sorted(jl)
    for n, v in jl.items():
        assert _bits(tl[n]) == _bits(np.asarray(v)), n


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pool_leaves_bit_equal_after_swaps_fold_pin_rollback_and_roll_forward(dtype):
    jpool, tpool, variables, _ = _pools(dtype)
    us = {r: _deltas(variables, 40 + r) for r in range(1, 5)}
    pools = (jpool, tpool)

    def each(fn):
        for p in pools:
            fn(p)

    try:
        each(lambda p: p.request_swap(us[1], round_num=1, generation=2, keep_previous=True))
        each(lambda p: _wait_round(p, 1))
        _assert_leaves_equal(jpool, tpool)
        each(lambda p: p.request_swap(us[2], round_num=2, generation=2, keep_previous=True))
        each(lambda p: _wait_round(p, 2))
        _assert_leaves_equal(jpool, tpool)
        # Pinned at the previous round: the snapshot comes back, and the
        # undone update folds into the pending sum.
        each(lambda p: p.pin_round(1))
        each(lambda p: _wait_round(p, 1))
        _assert_leaves_equal(jpool, tpool)
        # Two rounds defer while pinned and fold (f32) with the undo.
        each(lambda p: p.request_swap(us[3], round_num=3, generation=2))
        each(lambda p: p.request_swap(us[4], round_num=4, generation=2))
        time.sleep(0.2)
        assert [p.weight_state() for p in pools] == [(1, 2), (1, 2)]
        # Lifted: one flip rolls forward through rounds 2, 3 and 4.
        each(lambda p: p.pin_round(None))
        each(lambda p: _wait_round(p, 4))
        _assert_leaves_equal(jpool, tpool)
        for attr in ("swaps_applied", "swaps_deferred", "swaps_rolled_back"):
            assert getattr(tpool, attr) == getattr(jpool, attr), attr
        assert (tpool.swaps_applied, tpool.swaps_deferred, tpool.swaps_rolled_back) == (3, 2, 1)
        assert tpool._alloc.generation == jpool._alloc.generation == 4
        # The serve thread logs a flip after it publishes the round (the
        # digest takes a while under load): wait for the fourth entry.
        deadline = time.monotonic() + 60
        while len(tpool.swap_log) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert [r["what"] for r in tpool.swap_log] == ["applied", "applied", "rolled back to",
                                                       "applied"]
    finally:
        each(lambda p: p.close())


def _folded(tm, *deltas):
    """A copy of ``tm`` with each delta applied as the pool applies it."""
    import copy

    from hypha_tpu_torch.models.convert import flat_names

    model = copy.deepcopy(tm)
    names = flat_names(model)
    for d in deltas:
        for k, u in d.items():
            pname, transposed = names[k.removeprefix("params/")]
            mod, _, attr = pname.rpartition(".")
            leaf = getattr(model.get_submodule(mod) if mod else model, attr)
            u = torch.from_numpy(u)
            leaf.data = (leaf.float() + (u.T if transposed else u).float()).to(leaf.dtype)
    return model


def test_swap_serves_the_folded_model_and_maps_no_pre_swap_chain():
    """After a flip the pool's tokens are ``generate``'s on θ₀ + u (also for
    a prompt cached before the flip, which misses: its chain is of the old
    weights), and the response stamps follow."""
    _, variables, tm = tiny_pair("llama", dtype="float32", seed=3)
    tm.requires_grad_(False).eval()
    prompt, n_new = [5, 9, 2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9, 0, 4], 6
    u1 = _deltas(variables, 61, scale=0.3)  # large enough to move greedy tokens
    # The references first: the pool swaps its model's leaves in place.
    want0 = generate(_folded(tm), [prompt], n_new).tolist()
    want1 = generate(_folded(tm, u1), [prompt], n_new).tolist()
    pool = TPool(tm, prefix_cache=True, **POOL)
    try:
        before = pool.submit([prompt], n_new).result(timeout=120)
        hits0 = pool.hit_blocks
        pool.request_swap(u1, round_num=1, generation=0)
        _wait_round(pool, 1)
        after = pool.submit([prompt], n_new).result(timeout=120)
        assert pool.hit_blocks == hits0  # the cached chain is of θ₀
        again = pool.submit([prompt], n_new).result(timeout=120)
        assert pool.hit_blocks > hits0  # the new generation's chain hits
    finally:
        pool.close()
    assert before == want0 and after == again == want1 and want1 != want0
    assert pool._alloc.stale_drops >= 1


def test_swaps_under_traffic_fail_no_request():
    """Requests keep completing while swaps roll, each the full length."""
    _, variables, tm = tiny_pair("llama", dtype="float32", seed=3)
    tm.requires_grad_(False).eval()
    pool = TPool(tm, **{**POOL, "slots": 4, "steps_per_call": 2, "num_blocks": 32})
    futures = []
    try:
        for i in range(12):
            futures.append(pool.submit([[1 + (i % 7), 2, 3]], 6))
            if i % 3 == 2:
                pool.request_swap(_deltas(variables, 100 + i), round_num=i // 3 + 1)
        results = [f.result(timeout=120) for f in futures]
        _wait_round(pool, 4)
    finally:
        pool.close()
    assert all(len(r[0]) == 6 for r in results)


# --------------------------------------------- prefix-cache generations


def test_post_swap_admission_never_maps_pre_swap_chain():
    """Identical prompt bytes hash identically, but blocks written under
    the old weights miss after a bump, in both allocators alike."""
    out = {}
    for k, Alloc in (("jax", JAlloc), ("port", TAlloc)):
        alloc = Alloc(8, 2, caching=True)
        hashes = chain_hashes([1, 2, 3, 4], 2)
        table = [alloc.alloc() for _ in hashes]
        for b, h in zip(table, hashes):
            alloc.register(b, h)
        for b in table:
            alloc.release(b)
        seen = [alloc.peek(hashes)]
        alloc.bump_generation()
        seen += [alloc.peek(hashes), alloc.lookup(hashes), alloc.stale_drops]
        alloc.check_conservation([])
        table2 = [alloc.alloc() for _ in hashes]
        for b, h in zip(table2, hashes):
            alloc.register(b, h)
        seen += [alloc.lookup(hashes) == table2, table2]
        for b in table2:
            alloc.release(b)
            alloc.release(b)
        alloc.check_conservation([])
        # A lane holding a block across a bump frees it at release.
        b = alloc.alloc()
        alloc.register(b, chain_hashes([5, 6], 2)[0])
        alloc.bump_generation()
        alloc.release(b)
        seen += [alloc.is_registered(b), alloc.stale_drops, alloc.free_count(), alloc.generation]
        out[k] = seen
    assert out["port"] == out["jax"]
    assert out["port"][1] == (0, 0) and out["port"][2] == []


def test_block_conservation_holds_across_generation_bumps():
    """Random admit / grow / release / copy-on-write / bump sequences keep
    every block in exactly one place, and both allocators in step."""
    for round_ in range(8):
        rng = random.Random(0x5A9B + round_)
        nblocks, bs = rng.randint(4, 24), rng.choice([2, 4])
        allocs = {"jax": JAlloc(nblocks, bs, caching=True), "port": TAlloc(nblocks, bs, caching=True)}
        lanes: dict = {"jax": [], "port": []}
        corpus = [[rng.randint(1, 9) for _ in range(rng.randint(1, 6 * bs))] for _ in range(5)]
        for _ in range(200):
            op, pick, toks = rng.random(), rng.random(), rng.choice(corpus)
            for k, alloc in allocs.items():
                ls = lanes[k]
                if op < 0.08:
                    alloc.bump_generation()
                elif op < 0.5:
                    hashes = chain_hashes(toks, bs)
                    want = -(-len(toks) // bs)
                    table = alloc.lookup(hashes)
                    while len(table) < want:
                        b = alloc.alloc()
                        if b is None:
                            break
                        table.append(b)
                    if len(table) == want:
                        for j, h in enumerate(hashes):
                            alloc.register(table[j], h)
                        ls.append(table)
                    else:
                        for b in table:
                            alloc.release(b)
                elif op < 0.68 and ls:
                    b = alloc.alloc()
                    if b is not None:
                        ls[int(pick * len(ls))].append(b)
                elif op < 0.9 and ls:
                    for b in ls.pop(int(pick * len(ls))):
                        alloc.release(b)
                else:
                    shared = [(li, bi) for li, t in enumerate(ls) for bi, b in enumerate(t)
                              if alloc.is_shared(b)]
                    if shared:
                        li, bi = shared[int(pick * len(shared))]
                        nb = alloc.alloc()
                        if nb is not None:
                            alloc.release(ls[li][bi])
                            ls[li][bi] = nb
                alloc.check_conservation(ls)
            assert lanes["port"] == lanes["jax"]
            assert [(a.free_count(), a.cached_count(), a.stale_drops, a.generation)
                    for a in allocs.values()] == [(allocs["jax"].free_count(),
                                                   allocs["jax"].cached_count(),
                                                   allocs["jax"].stale_drops,
                                                   allocs["jax"].generation)] * 2
        for k, alloc in allocs.items():
            for table in lanes[k]:
                for b in table:
                    alloc.release(b)
            alloc.check_conservation([])
            assert alloc.free_count() == nblocks, f"round {round_} leaked"


# ----------------------------------------------------------------- wire


def test_stamped_messages_and_unset_follow_encode_as_the_reference():
    golden = jcodec.dumps({"_t": "GenerateResponse", "tokens": [[1, 2, 3]], "ok": True,
                           "retry_after_ms": 0.0})
    assert tmsg.encode(tmsg.GenerateResponse(tokens=[[1, 2, 3]])) == golden
    load = dict(job_id="j1", serve_name="svc", queue_depth=2, free_blocks=9, live_requests=1,
                requests=5)
    assert tmsg.encode(tmsg.ServeLoad(**load)) == jmsg.encode(jmsg.ServeLoad(**load))
    assert b"weight_round" not in tmsg.encode(tmsg.ServeLoad(**load))
    cfg = {m: m.InferExecutorConfig(model={"m": 1}, serve_name="svc") for m in (jmsg, tmsg)}
    assert tmsg.encode(cfg[tmsg]) == jmsg.encode(cfg[jmsg])
    assert b"serve_follow_rounds" not in tmsg.encode(cfg[tmsg])
    on = dataclasses.replace(cfg[tmsg], serve_follow_rounds=t_follow_for("results:x", ["ps0"]))
    assert tmsg.encode(on) == jmsg.encode(dataclasses.replace(
        cfg[jmsg], serve_follow_rounds=j_follow_for("results:x", ["ps0"])))
    assert tmsg.decode(tmsg.encode(on)) == on
    stamped = [
        (lambda m: m.GenerateResponse(tokens=[[1]], weight_round=4, weight_generation=2)),
        (lambda m: m.ServeLoad(job_id="j", weight_round=4, weight_generation=2)),
        (lambda m: m.BlockPull(serve_name="s", chain_hashes=[1, 2], weight_round=4,
                               weight_generation=2)),
        (lambda m: m.BlockChain(ok=False, error="stale-generation", weight_round=4,
                                weight_generation=2)),
        (lambda m: m.MigrateRequest(serve_name="s", prompt=[1], weight_round=4,
                                    weight_generation=2)),
    ]
    for make in stamped:
        assert tmsg.encode(make(tmsg)) == jmsg.encode(make(jmsg))
        assert tmsg.decode(jmsg.encode(make(jmsg))) == make(tmsg)


# ------------------------------------------------------------ end to end


@pytest.mark.parametrize("scheduler", ["port", "jax"])
def test_follower_serves_each_round_of_a_tree_job(tmp_path, scheduler):
    """A blocking job of two torch workers in a group of 2 (``w0`` reduces
    and relays) with ``broadcast_tree`` and a torch follower ``sv`` in
    ``serve_peers``, under either package's scheduler, with a torch
    parameter server. ``sv`` gets every round through the relay, and after
    each round its probe's tokens equal ``generate`` at θ₀ + Σu (each u
    applied as the pool applies it), its leaves that fold bit for bit."""
    import chip_smoke
    from test_torch_worker_node import _dataset, _mixed_job

    from hypha_tpu.data_node import DataNode as JDataNode
    from hypha_tpu.gateway import Gateway as JGateway
    from hypha_tpu.network import Node as JNode
    from hypha_tpu.network import TcpTransport as JTcp
    from hypha_tpu.scheduler.orchestrator import Orchestrator as JOrchestrator
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.executor.pool import DecodePool
    from hypha_tpu_torch.executor.training import theta_checksum
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.messages import Executor, InferExecutorConfig, JobSpec
    from hypha_tpu_torch.models.convert import state_to_flat
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator as TOrchestrator
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.infer_executor import InProcessInferExecutor
    from hypha_tpu_torch.worker.runtime import WorkerNode

    _, variables, tm = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data_dir = _dataset(tmp_path)
    rounds = 3
    job = _mixed_job(weights, rounds=rounds, reduce_group_size=2, broadcast_tree=True,
                     serve_peers=["sv"])
    Orch = JOrchestrator if scheduler == "jax" else TOrchestrator
    if scheduler == "port":
        job = tmsg.decode(jmsg.encode(job))
    root = Path(tempfile.mkdtemp(prefix="ws"))  # bridge sockets: paths under 108 bytes
    probe, n_new = [3, 1, 4, 1, 5, 9, 2, 6], 6
    staged, probes, plans, swaps = [], [], [], []
    real_swap, real_plan = DecodePool.request_swap, Orch._plan_streams

    def noted_swap(pool, updates, **kw):
        staged.append((kw["round_num"], {k: np.asarray(v, np.float32).copy()
                                         for k, v in updates.items()}))
        return real_swap(pool, updates, **kw)

    def noted_plan(self, ctx, *a, **kw):
        real_plan(self, ctx, *a, **kw)
        plans.append((ctx.results_tag, list(ctx.shard_map.shards),
                      [list(g) for g in ctx.shard_map.groups]))

    async def follower(ex, node):
        while not plans:
            await asyncio.sleep(0.01)
        tag, shards, groups = plans[0]
        follow = t_follow_for(tag, shards, groups=groups, start_round=-1)
        spec = JobSpec(job_id="svjob", executor=Executor(
            kind="infer", name="generate", infer=InferExecutorConfig(
                model={"family": "llama", "preset": "tiny", "config": {"dtype": "float32"},
                       "weights": str(weights), "serve_dtype": "float32"},
                serve_name="sv", max_batch=2, max_new_tokens=n_new, pool_block_size=8,
                pool_max_len=64, pool_prefill_chunk=8, pool_prefix_cache=True,
                load_report_s=0.0, serve_follow_rounds=follow)))
        execution = await ex.execute("svjob", spec, "sched")
        seen = None
        try:
            while True:
                server = ex.batchers.get("svjob")
                state = server.weight_state() if server is not None else None
                if state is not None and state[0] is not None and state != seen:
                    toks = await server.submit([probe], n_new, 0.0, None, 0)
                    if server.weight_state() == state:
                        probes.append((state[0], toks[0]))
                    seen = state
                    swaps[:] = list(server.pool.swap_log)
                await asyncio.sleep(0.02)
        finally:
            await execution.cancel()

    async def main():
        J = scheduler == "jax"
        gw = (JGateway(JTcp(), peer_id="gw") if J else Gateway(TcpTransport(), peer_id="gw"))
        await gw.start(["127.0.0.1:0"])
        boot = [gw.node.listen_addrs[0]]
        data = (JDataNode(JTcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot) if J
                else DataNode(TcpTransport(), {"counting": data_dir}, peer_id="data",
                              bootstrap=boot))
        workers = [WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                              device="cpu", peer_id=w, offer=OfferConfig(strategy="whole"),
                              train_runtime="in-process", bootstrap=boot, work_root=root / w)
                   for w in ("w0", "w1")]
        psw = WorkerNode(TcpTransport(), resources=Resources(cpu=2, memory=200), device="cpu",
                         peer_id="psw", bootstrap=boot, work_root=root / "p")
        sv = Node(TcpTransport(), peer_id="sv", bootstrap=boot)
        sched = (JNode(JTcp(), peer_id="sched", bootstrap=boot) if J
                 else Node(TcpTransport(), peer_id="sched", bootstrap=boot))
        started = []
        follow = None
        try:
            for part in (data, *workers, psw, sv, sched):
                await part.start(["127.0.0.1:0"])
                started.append(part)
            await sched.wait_for_bootstrap()
            await sv.wait_for_bootstrap()
            follow = asyncio.create_task(follower(
                InProcessInferExecutor(sv, torch.device("cpu"), root / "sv"), sv))
            result = await Orch(sched).run(job, auction_timeout=1.5)
            for _ in range(300):
                if len(probes) >= rounds or follow.done():
                    break
                await asyncio.sleep(0.05)
            return result
        finally:
            if follow is not None:
                follow.cancel()
                await asyncio.gather(follow, return_exceptions=True)
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    DecodePool.request_swap, Orch._plan_streams = noted_swap, noted_plan
    try:
        with chip_smoke.node_probes("cpu") as rec:
            result = asyncio.run(asyncio.wait_for(main(), 240))
    finally:
        DecodePool.request_swap, Orch._plan_streams = real_swap, real_plan
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == rounds
    # The server pushed each round once, to the relay w0.
    assert [b["round"] for b in rec["broadcast"]] == list(range(rounds))
    assert [r for r, _ in staged] == list(range(rounds))
    assert [p[0] for p in probes] == list(range(rounds)), probes
    # Each flip's logged digest is the host fold's; each probe's tokens are
    # generate's on it.
    assert [(s["what"], s["round"]) for s in swaps] == [("applied", r) for r in range(rounds)]
    model0 = tm.requires_grad_(False).eval()
    for r, toks in probes:
        model = _folded(model0, *[u for _, u in staged[: r + 1]])
        assert toks == generate(model, [probe], n_new).tolist()[0], r
        assert swaps[r]["digest"] == theta_checksum({
            k.removeprefix("params/"): v
            for k, v in state_to_flat(model, dict(model.named_parameters())).items()}), r


def test_train_swap_phase_on_the_cpu(monkeypatch):
    """The smoke's ``train_swap`` (``chip_smoke.run_swap_job``) at a tiny
    size on the CPU, held to its gates but the card's launch counts: the
    server pushes through the relay ``w0`` until it is killed after round
    ``SWAP_KILL_AFTER`` (1), then to the leaves; every wire byte-equal; every flip's digest and
    probe the host fold's; the traffic whole and monotonically stamped."""
    import chip_smoke as cs

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = {"num_layers": 1, "dtype": "float32", "max_seq_len": 512}
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny", "seed": 0,
             "config": cfg}
    serve_model = {"family": "llama", "preset": "tiny", "seed": 0,
                   "config": {"num_layers": 1, "max_seq_len": 512}}
    pool = dict(slots=4, max_len=256, steps_per_call=4, block_size=16, ragged=True,
                prefix_cache=True)
    root = Path(tempfile.mkdtemp(prefix="rsw"))  # bridge sockets: paths under 108 bytes
    try:
        run = asyncio.run(cs.run_swap_job(
            root, model, serve_model, device="cpu", rounds=5, steps=24, batch=2, seq=16,
            period=200, train_runtime="process", prompt_lengths=(17, 40, 90), probe_len=30,
            pool=pool, vocab=256, status_timeout=120))
        rep = cs.swap_report(run)
        check = cs.swap_check(run, serve_model, "cpu", pool=pool)
        problems = cs.swap_problems(run, rep, check, rounds=5, layers=1, device="cpu")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert not problems, problems
    assert rep["broadcast"][0]["targets"] == "['w0']" and rep["kill_to_departure_s"] < 5
    line = json.loads(json.dumps(cs.swap_summary(run, rep, check)))  # as emit prints it
    assert line["rounds"] == list(range(5)) and line["probe_tokens_differ_between_rounds"]
