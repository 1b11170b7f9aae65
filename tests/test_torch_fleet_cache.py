"""Port parity: the fleet prefix cache and KV migration (the counterparts of
``tests/test_fleet_cache.py``), each case run through the JAX package and
the port on a tiny f32 or int8 Llama whose weights the converter carries
across (``tiny_pair``).

* The ``/hypha-blocks`` vocabulary and the heartbeat digest: the same
  bytes in both packages, and nothing new on the wire with the subsystem
  off.
* Block transfer between a JAX pool and a port pool, both ways: a chain
  one pool serves goes through the JAX wire helpers, the CBOR message and
  the port's (or the reverse), lands bit for bit (int8 payloads with their
  scale rows) and admits as a one-tail-chunk prefix hit whose tokens equal
  the JAX ``generate``.
* Stale stamps, a miss after eviction and closing with ops pending end
  alike in both pools.
* Migration: a preempted group's ticket, handed from a pool stepped by
  hand to a pool of the other package through ``MigrateRequest``,
  resolves with the uncontended run's tokens, and both packages cut the
  same tickets; a failed send requeues; a policy that says recompute keeps
  recompute-resume; the transfer-against-recompute math.
* The router's directory, owner and pull stamping, decision by decision
  against the JAX router on one ``ServeLoad`` sequence (both in one
  process: the rendezvous fallback hashes strings, salted per process).
* A chain past the fabric's frame cap (lowered with ``monkeypatch``) ends
  as a counted miss for a pull and a requeue with the right answer for a
  migration, in both packages' executors.
"""

from __future__ import annotations

import asyncio
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from _torch_parity import tiny_pair
from hypha_tpu import codec as jcodec
from hypha_tpu import messages as jmsg
from hypha_tpu.executor import block_cache as jblock
from hypha_tpu.executor.generate import generate as jgenerate
from hypha_tpu.executor.pool import DecodePool as JPool
from hypha_tpu.executor.pool import StaleBlockGeneration as JStale
from hypha_tpu.executor.pool import _Group as JGroup
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.ft.adaptive import LinkTable as JLinkTable
from hypha_tpu.network import MemoryTransport as JMemory
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.network import fabric as jfabric
from hypha_tpu.ops import kvcache as jkv
from hypha_tpu.scheduler import serving as jserving
from hypha_tpu.telemetry import SERVE_METRICS
from hypha_tpu.worker.infer_executor import InProcessInferExecutor as JInfer
from hypha_tpu_torch import codec as tcodec
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor import block_cache as tblock
from hypha_tpu_torch.executor.pool import FLEET_STATS, DecodePool, StaleBlockGeneration, _Group
from hypha_tpu_torch.ft.adaptive import LinkTable
from hypha_tpu_torch.network import MemoryTransport, Node, TcpTransport
from hypha_tpu_torch.network import fabric as tfabric
from hypha_tpu_torch.ops import kvcache as tkv
from hypha_tpu_torch.scheduler import serving as tserving
from hypha_tpu_torch.worker.infer_executor import InProcessInferExecutor

BASE = dict(slots=4, max_len=128, steps_per_call=4, block_size=8, num_blocks=48,
            prefill_chunk=8, prefix_cache=True, fleet_cache=True)
# The migration cases' pools: two lanes, 15 blocks of 4, no reserve, so the
# second group's growth preempts the first.
TIGHT = dict(slots=2, max_len=64, steps_per_call=4, block_size=4, num_blocks=15,
             prefill_chunk=4, reserve_blocks=0, prefix_cache=True, fleet_cache=True,
             kv_migration=True)
ROOMY = dict(slots=4, max_len=64, steps_per_call=4, block_size=4, num_blocks=64,
             prefill_chunk=4, prefix_cache=True, fleet_cache=True)
P1 = [(i * 7 + 5) % 50 + 1 for i in range(9)]
P2 = [(i * 11 + 2) % 50 + 1 for i in range(9)]
N_MIGRATE = 24


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=240))


@pytest.fixture(scope="module")
def pair():
    return tiny_pair("llama", dtype="float32", seed=7)


def _ref(pair, prompt, n_new) -> list:
    jm, jv, _ = pair
    return np.asarray(jgenerate(jm, jv, np.asarray([prompt], np.int32), n_new))[0].tolist()


class Pools:
    """One package's pool constructor, its chain-serving result as numpy,
    and its wire helpers, so a case reads the same in both packages."""

    def __init__(self, name: str, pair) -> None:
        self.name = name
        jm, jv, tm = pair
        self.make = ((lambda **kw: JPool(jm, jv, **kw)) if name == "jax"
                     else (lambda **kw: DecodePool(tm, **kw)))
        self.kv = jkv if name == "jax" else tkv
        self.m = jmsg if name == "jax" else tmsg
        self.stale = JStale if name == "jax" else StaleBlockGeneration

    def numpy(self, leaves: dict) -> dict:
        if self.name == "jax":
            return {k: np.asarray(v) for k, v in leaves.items()}
        return {k: v.view(torch.uint8).numpy() if v.dtype == torch.bfloat16 else v.numpy()
                for k, v in leaves.items()}

    def ship(self, hashes, leaves, to: "Pools") -> dict:
        """This package's ``BlockChain`` of ``leaves``, encoded, decoded by
        ``to``'s codec, and its leaves decoded by ``to``'s wire helper."""
        msg = self.m.BlockChain(ok=True, chain_hash=hashes[-1], hashes=list(hashes),
                                block_size=8, leaves=self.kv.leaves_to_wire(leaves))
        got = to.m.decode(self.m.encode(msg))
        assert got.hashes == list(hashes) and got.block_size == 8
        return to.kv.leaves_from_wire(got.leaves)


def _both(pair):
    return {name: Pools(name, pair) for name in ("jax", "torch")}


# ------------------------------------------------------------------- wire


@pytest.mark.parametrize("m", [jmsg, tmsg], ids=["jax", "port"])
def test_defaults_off_wire_bytes_golden(m):
    """With the subsystem off every new field stays off the wire: the
    heartbeat, its ack, the request and the executor config are the
    hand-built CBOR plains in both packages."""
    codec = jcodec if m is jmsg else tcodec
    assert m.encode(m.ServeLoadAck()) == codec.dumps({"_t": "ServeLoadAck", "ok": True})
    load = m.ServeLoad(job_id="j1", serve_name="s", queue_depth=2, free_blocks=5,
                       live_requests=1, requests=3)
    assert m.encode(load) == codec.dumps({
        "_t": "ServeLoad", "job_id": "j1", "serve_name": "s", "queue_depth": 2,
        "free_blocks": 5, "live_requests": 1, "requests": 3, "rejections": 0})
    req = m.GenerateRequest(serve_name="s", prompts=[[1, 2]], seed=7)
    assert m.encode(req) == codec.dumps({"_t": "GenerateRequest", "serve_name": "s",
                                         "prompts": [[1, 2]], "max_new_tokens": 64, "seed": 7})
    blob = (m.encode(m.InferExecutorConfig(model={}, serve_name="s")) + m.encode(load)
            + m.encode(req) + m.encode(m.ServeLoadAck()))
    for name in ("cache_digest", "pull_peer", "migrate_peer", "pool_fleet_cache"):
        assert name.encode() not in blob, name


def _block_messages(m):
    leaves = {"['k']": [b"\x00\x01", "float32", [2]],
              "['layers_0']['self_attn']['k_scale']": [b"\x07" * 8, "float32", [1, 2]]}
    return [
        m.BlockPull(serve_name="s", chain_hashes=[1, -2, 2**63 - 1], weight_round=3,
                    weight_generation=1),
        m.BlockChain(ok=True, chain_hash=1, hashes=[1], block_size=8, leaves=leaves,
                     weight_round=3, weight_generation=1),
        m.BlockChain(ok=False, error="not-cached"),
        m.MigrateRequest(serve_name="s", prompt=[1, 2], emitted=[3], budget=4,
                         chain_hashes=[5], block_size=8, leaves=leaves),
        m.MigrateAck(ok=True, tokens=[4, 5, 6]),
        m.MigrateAck(ok=False, error="busy", retry_after_ms=50.0),
        m.ServeLoadAck(ok=True, migrate_peer="w2", migrate_serve="fc@2"),
        m.GenerateRequest(serve_name="fc@1", prompts=[[1, 2]], pull_peer="w0",
                          pull_serve="fc@0"),
    ]


def test_fleet_wire_roundtrip_with_payload():
    """Every ``/hypha-blocks`` message (bytes payloads, the weight stamps,
    64-bit hashes) and the fleet fields of the serving messages: the same
    bytes in both packages, and each decodes the other's."""
    for j, t in zip(_block_messages(jmsg), _block_messages(tmsg)):
        assert tmsg.encode(t) == jmsg.encode(j), type(t).__name__
        assert tmsg.decode(jmsg.encode(j)) == t
        assert jmsg.decode(tmsg.encode(t)) == j
    assert tmsg.PROTOCOL_BLOCKS == jmsg.PROTOCOL_BLOCKS


# ----------------------------------------------------------------- digest


@pytest.mark.parametrize("mod", [jblock, tblock], ids=["jax", "port"])
def test_hot_chains_bounded_and_hit_ordered(mod):
    """The digest is top-K by hits, advertises 0-hit chains, and prunes
    evicted content; the port's allocator answers as the JAX one."""
    def script(mod):
        alloc = mod.PrefixBlockCache(8, 2, caching=True)
        hashes = mod.chain_hashes([1, 2, 3, 4, 5, 6], 2)
        blocks = [alloc.alloc() for _ in range(3)]
        for b, h in zip(blocks, hashes):
            alloc.register(b, h)
        for b in blocks:
            alloc.release(b)
        for _ in range(2):
            for b in alloc.lookup(hashes[:2]):
                alloc.release(b)
        out = [alloc.hot_chains(2), alloc.hot_chains(10), alloc.hot_chains(0)]
        for _ in range(8):
            alloc.alloc()
        return hashes, out + [alloc.hot_chains(10)]

    hashes, (top2, all10, none, evicted) = script(mod)
    assert {h for h, _ in top2} == set(hashes[:2]) and all(c == 2 for _, c in top2)
    assert {h for h, _ in all10} == set(hashes) and none == [] and evicted == []
    assert script(mod) == script(jblock)


def test_digest_heartbeat_encoded_size_budget():
    """A full K=32 digest of 64-bit hashes stays under the heartbeat
    budget, and the port's ``ServeLoad`` carrying it is the JAX bytes."""
    digests = []
    for mod in (jblock, tblock):
        alloc = mod.PrefixBlockCache(64, 2, caching=True)
        for i in range(50):
            b = alloc.alloc()
            alloc.register(b, hash(("fleet-digest-entry", i, 0x9E3779B97F4A7C15)))
            alloc.release(b)
        digests.append(alloc.hot_chains(32))
    assert digests[0] == digests[1] and len(digests[0]) == 32
    blobs = [m.encode(m.ServeLoad(job_id="j", serve_name="s", cache_digest=digests[0]))
             for m in (jmsg, tmsg)]
    assert blobs[0] == blobs[1]
    bare = len(tmsg.encode(tmsg.ServeLoad(job_id="j", serve_name="s")))
    assert len(blobs[1]) - bare <= 32 * (9 + 9 + 2) + 32 and len(blobs[1]) <= 1024


# --------------------------------------------------- cross-pool transfer


def _submit(pool, prompt, n):
    with torch.inference_mode():
        return pool.submit([list(prompt)], n).result(timeout=300)


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_cross_pool_transfer_bit_parity_f32(pair, src, dst):
    """A chain one package's pool serves lands in the other package's pool
    bit for bit, the other pool serves it back with the same bits, admits
    the prefix as a hit with one tail chunk and answers as the JAX
    ``generate``; landing it again is a no-op."""
    pk = _both(pair)
    prompt = [(i * 7 + 3) % 50 + 1 for i in range(24)]  # 3 full blocks
    a, b = pk[src].make(**BASE), pk[dst].make(**BASE)
    try:
        assert _submit(a, prompt, 6) == [_ref(pair, prompt, 6)]
        hashes = jblock.chain_hashes(prompt, 8)
        assert tblock.chain_hashes(prompt, 8) == hashes
        served = a.serve_chain(hashes).result(timeout=60)
        assert served is not None and served["hashes"] == hashes
        sent = pk[src].numpy(served["leaves"])
        assert list(sent) == [f"['layers_{i}']['self_attn']['{k}']"
                              for i in range(2) for k in ("k", "v")]
        landed = pk[src].ship(hashes, served["leaves"], pk[dst])
        for key, arr in pk[dst].numpy(landed).items():
            assert arr.dtype == sent[key].dtype and np.array_equal(arr, sent[key]), key
        assert pk[dst].kv.leaves_nbytes(landed) == pk[src].kv.leaves_nbytes(served["leaves"])
        assert b.inject_chain(hashes, landed, None, None).result(timeout=60) == len(hashes)
        again = pk[dst].numpy(b.serve_chain(hashes).result(timeout=60)["leaves"])
        for key, arr in sent.items():
            assert np.array_equal(again[key], arr), key
        warm = prompt + [9, 9]
        before = b.prefill_chunks
        assert _submit(b, warm, 6) == [_ref(pair, warm, 6)]
        assert b.prefill_chunks - before == 1, "the landed chain did not admit as a hit"
        assert b.inject_chain(hashes, landed, None, None).result(timeout=60) == 0
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_cross_pool_transfer_int8_ships_scale_rows(pair, src, dst):
    """int8 pools ship their payload and scale rows verbatim across the
    packages; the landed blocks serve back bit for bit and the warm decode
    of the receiving pool equals the sending pool's."""
    pk = _both(pair)
    prompt = [(i * 5 + 2) % 50 + 1 for i in range(16)]  # 2 full blocks
    a, b = pk[src].make(**BASE, kv_quant="int8"), pk[dst].make(**BASE, kv_quant="int8")
    try:
        _submit(a, prompt, 6)
        hashes = jblock.chain_hashes(prompt, 8)
        served = a.serve_chain(hashes).result(timeout=60)
        sent = pk[src].numpy(served["leaves"])
        assert sorted(sent) == sorted(f"['layers_{i}']['self_attn']['{k}']" for i in range(2)
                                      for k in ("k", "v", "k_scale", "v_scale"))
        assert {str(v.dtype) for v in sent.values()} == {"int8", "float32"}
        landed = pk[src].ship(hashes, served["leaves"], pk[dst])
        assert b.inject_chain(hashes, landed, None, None).result(timeout=60) == len(hashes)
        again = pk[dst].numpy(b.serve_chain(hashes).result(timeout=60)["leaves"])
        for key, arr in sent.items():
            assert again[key].dtype == arr.dtype and np.array_equal(again[key], arr), key
        warm = prompt + [3, 1]
        got_a = _submit(a, warm, 6)
        before = b.prefill_chunks
        assert _submit(b, warm, 6) == got_a, "shipped int8 blocks decoded differently"
        assert b.prefill_chunks - before == 1
    finally:
        a.close()
        b.close()


def test_bf16_wire_round_trip_without_numpy_bf16():
    """bf16 rows cross as their raw bytes under the JAX dtype name and
    come back bit for bit through torch (numpy has no bf16)."""
    rows = torch.randn(16, 2, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    wire = tkv.leaves_to_wire({"['layers_0']['self_attn']['k']": rows})
    raw, dtype, shape = wire["['layers_0']['self_attn']['k']"]
    assert dtype == "bfloat16" and shape == [16, 2, 8] and len(raw) == rows.numel() * 2
    back = tkv.leaves_from_wire(wire)["['layers_0']['self_attn']['k']"]
    assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16),
                                                       rows.view(torch.int16))
    jax_rows = jkv.leaves_from_wire(wire)["['layers_0']['self_attn']['k']"]
    assert str(jax_rows.dtype) == "bfloat16"
    assert jax_rows.view(np.uint16).tobytes() == raw
    assert tkv.leaves_to_wire(tkv.leaves_from_wire(jkv.leaves_to_wire(
        {"x": jax_rows})))["x"] == jkv.leaves_to_wire({"x": jax_rows})["x"]
    assert tkv.leaves_nbytes(tkv.leaves_from_wire(wire)) == len(raw)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stale_generation_injection_rejected(pair, pkg):
    """Blocks stamped with other weights than the pool serves are refused;
    the stamp of a pool that never swapped, ``(None, None)``, passes."""
    p = Pools(pkg, pair)
    b = p.make(**BASE)
    try:
        assert b.weight_state() == (None, None)
        with pytest.raises(p.stale):
            b.inject_chain([123], {}, 5, 1).result(timeout=60)
        assert b.inject_chain([], {}, None, None).result(timeout=60) == 0
    finally:
        b.close()


def test_serve_chain_miss_after_eviction_recompute_fallback(pair):
    """The holder evicted the chain: ``serve_chain`` resolves None, and a
    plain submit still answers as ``generate``; both pools alike."""
    out = {}
    for pkg in ("jax", "torch"):
        a = Pools(pkg, pair).make(**dict(BASE, slots=2, max_len=64, block_size=4,
                                         num_blocks=8, prefill_chunk=4))
        try:
            prompt = [(i * 7 + 1) % 50 + 1 for i in range(8)]
            _submit(a, prompt, 4)
            hashes = jblock.chain_hashes(prompt, 4)
            first = a.serve_chain(hashes).result(timeout=60) is not None
            for i in range(6):
                _submit(a, [(i * 13 + j) % 50 + 2 for j in range(8)], 4)
            out[pkg] = (first, a.serve_chain(hashes).result(timeout=60), _submit(a, prompt, 4))
        finally:
            a.close()
    assert out["torch"] == out["jax"] == (True, None, [_ref(pair, prompt, 4)])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pool_close_fails_pending_ops(pair, pkg):
    a = Pools(pkg, pair).make(**BASE)
    a.close()
    with pytest.raises(RuntimeError):
        a.serve_chain([1]).result(timeout=10)


# -------------------------------------------------------------- migration


def _park(pool, group_cls, prompt, n_new):
    g = group_cls([list(prompt)], int(n_new), Future())
    with pool._submit_lock:
        pool._backlog += 1
    pool._waiting.append(g)
    return g


def _migrate_script(pk: dict, src: str, dst: str) -> tuple:
    """Pool A of package ``src`` (two tight lanes) stepped by hand over P1
    and P2; each ticket its preemption cuts goes through the ``src``
    package's ``MigrateRequest`` to the ``dst`` package's codec, lands in
    pool B of package ``dst``, which decodes the rest; A resolves the
    group with the continuation. Returns the answers, the tickets'
    metadata and A's migrations out."""
    a, b = pk[src].make(**TIGHT), pk[dst].make(**ROOMY)
    tickets, meta = [], []
    a.set_migrate_hooks(lambda est, toks: "peer-b", tickets.append)
    try:
        g1 = _park(a, JGroup if src == "jax" else _Group, P1, N_MIGRATE)
        g2 = _park(a, JGroup if src == "jax" else _Group, P2, N_MIGRATE)
        deadline = time.time() + 300
        while not (g1.fut.done() and g2.fut.done()):
            assert time.time() < deadline
            with torch.inference_mode():
                a._step_paged()
            while tickets:
                t = tickets.pop(0)
                assert t["target"] == "peer-b" and t["budget"] > 0
                msg = pk[src].m.MigrateRequest(
                    serve_name="b", prompt=t["prompt"], emitted=t["emitted"],
                    budget=t["budget"], chain_hashes=t["hashes"], block_size=t["block_size"],
                    leaves=pk[src].kv.leaves_to_wire(t["leaves"]),
                    weight_round=t["weight_round"], weight_generation=t["weight_generation"])
                got = pk[dst].m.decode(pk[src].m.encode(msg))
                meta.append((got.prompt, got.emitted, got.budget, got.chain_hashes,
                             sorted(got.leaves)))
                b.inject_chain(got.chain_hashes, pk[dst].kv.leaves_from_wire(got.leaves),
                               got.weight_round, got.weight_generation).result(timeout=60)
                cont = _submit(b, got.prompt + got.emitted, got.budget)
                a.complete_migrated(t["group"], cont[0])
        a._alloc.check_conservation([r.blocks for r in a._lane_rows.values()])
        return [g1.fut.result(timeout=1), g2.fut.result(timeout=1)], meta, a.migrated_out
    finally:
        a.close()
        b.close()


def test_migration_token_identity_vs_uncontended(pair):
    """A preempted request's blocks, cursor and emitted tokens move to a
    pool of the other package, which decodes the rest: both answers equal
    the uncontended run's, and the JAX and the port pool cut the same
    tickets (prompt, emitted, budget, chain hashes, leaves)."""
    pk = _both(pair)
    want = [[_ref(pair, P1, N_MIGRATE)], [_ref(pair, P2, N_MIGRATE)]]
    runs = {(s, d): _migrate_script(pk, s, d) for s, d in (("jax", "torch"), ("torch", "jax"))}
    for (answers, meta, migrated) in runs.values():
        assert answers == want and migrated >= 1 and len(meta) == migrated
    assert runs[("torch", "jax")][1] == runs[("jax", "torch")][1]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_migration_send_failure_requeues_recompute(pair, pkg):
    """A sender that fails hands the group back: recompute-resume answers
    as the uncontended run."""
    a = Pools(pkg, pair).make(**TIGHT)

    def bad_send(ticket):
        raise RuntimeError("link down")

    a.set_migrate_hooks(lambda est, toks: "peer-b", bad_send)
    try:
        f1, f2 = a.submit([list(P1)], N_MIGRATE), a.submit([list(P2)], N_MIGRATE)
        assert f1.result(timeout=300) == [_ref(pair, P1, N_MIGRATE)]
        assert f2.result(timeout=300) == [_ref(pair, P2, N_MIGRATE)]
        assert a.migrated_out >= 1
        if pkg == "torch":
            assert a.requeued == a.migrated_out
    finally:
        a.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_policy_none_keeps_recompute_resume(pair, pkg):
    a = Pools(pkg, pair).make(**TIGHT)
    a.set_migrate_hooks(lambda est, toks: None, lambda t: None)
    try:
        f1, f2 = a.submit([list(P1)], N_MIGRATE), a.submit([list(P2)], N_MIGRATE)
        assert f1.result(timeout=300) == [_ref(pair, P1, N_MIGRATE)]
        assert f2.result(timeout=300) == [_ref(pair, P2, N_MIGRATE)]
        assert a.migrated_out == 0 and a.preemptions >= 1
    finally:
        a.close()


def test_transfer_vs_recompute_policy_math(pair):
    """The policy's two sides: the pools' bytes per block agree, the
    prefill cost is None until a prefill was timed, and both packages'
    ``LinkTable`` estimates are equal: a fat link ships, a capped one
    recomputes, an unmeasured one ships."""
    pk = _both(pair)
    pools = {name: p.make(**BASE) for name, p in pk.items()}
    try:
        assert pools["torch"]._block_nbytes() == pools["jax"]._block_nbytes() == 4096
        for pool in pools.values():
            assert pool.prefill_cost_s(100) is None
            _submit(pool, [(i * 3 + 1) % 50 + 1 for i in range(16)], 4)
            cost = pool.prefill_cost_s(1000)
            assert cost is not None and cost > 0
        est = 2 * pools["torch"]._block_nbytes()
        tables = [(JLinkTable(), JLinkTable()), (LinkTable(), LinkTable())]
        values = []
        for fat, capped in tables:
            assert fat.bandwidth_bps("peer") is None
            values.append((fat.observe("peer", est, 1e-6), capped.observe("peer", est, 3600.0),
                           fat.observe("peer", est, 0.5), fat.bandwidth_bps("peer")))
        assert values[0] == values[1]
        cost = pools["torch"].prefill_cost_s(1000)
        assert est * 8.0 / values[1][0] < cost <= est * 8.0 / values[1][1]
        with pytest.raises(NotImplementedError, match="sharded PS/FT/rejoin"):
            LinkTable().codec_for("peer")
    finally:
        for pool in pools.values():
            pool.close()


def test_fleet_counts_carry_the_reference_metric_names(pair):
    """The port keeps the reference's fleet metrics as plain counters in
    the pool's ``stats``, under the names of the JAX serving metrics."""
    SERVE_METRICS.reset()
    assert set(FLEET_STATS) <= set(SERVE_METRICS.snapshot())
    pool = DecodePool(pair[2], **BASE)
    try:
        assert all(pool.stats[k] == 0 for k in FLEET_STATS)
        pool.count("blocks_shipped", 5)
        pool.count("remote_prefix_hits")
        assert (pool.stats["blocks_shipped"], pool.stats["remote_prefix_hits"]) == (5, 1)
    finally:
        pool.close()
    with pytest.raises(ValueError, match="prefix_cache"):
        DecodePool(pair[2], **dict(BASE, prefix_cache=False))


# ----------------------------------------------------------------- router


def _fake_dep(pkg, slot, depth, serve="fc"):
    async def _release():
        return None

    p = PKG[pkg]
    return p.serving._Deployment(
        slot=slot,
        handle=types.SimpleNamespace(peer_id=f"w{slot}", failed=None, lease_id=f"l{slot}",
                                     release=_release),
        task=types.SimpleNamespace(close=lambda: None), job_id=f"j{slot}",
        backend_name=f"{serve}@{slot}",
        load=p.m.ServeLoad(job_id=f"j{slot}", serve_name=f"{serve}@{slot}", queue_depth=depth),
        load_at=time.monotonic(),
    )


PKG = {
    "jax": types.SimpleNamespace(m=jmsg, serving=jserving,
                                 node=lambda: JNode(JMemory().shared(), peer_id="sched")),
    "port": types.SimpleNamespace(m=tmsg, serving=tserving,
                                  node=lambda: Node(MemoryTransport().shared(), peer_id="sched")),
}
MODEL = {"family": "llama", "preset": "tiny", "seed": 3}


async def _router(pkg, name, **kw):
    p = PKG[pkg]
    node = p.node()
    await node.start()
    sup = p.serving.ServingSupervisor(node, MODEL, name, num_workers=3, pool_block_size=4,
                                      pool_prefix_cache=True, **kw)
    calls: list = []

    async def fake_request(peer, proto, msg, timeout=None):
        calls.append((peer, msg))
        return p.m.GenerateResponse(tokens=[[0]])

    node.request = fake_request
    return node, sup, calls


def _counts(pkg, sup) -> dict:
    if pkg == "jax":
        snap = SERVE_METRICS.snapshot()
        return {"affinity_routed": snap["affinity_routed"],
                "directory_entries": snap["directory_chains"]}
    c = sup.counters()
    return {k: c[k] for k in ("affinity_routed", "directory_entries")}


def test_router_directory_holder_routing_and_pull_stamping():
    """The same heartbeats and requests through both routers: the digest
    folds into the same directory, each ack names the same migration
    target, each request goes to the same backend with the same pull
    stamp (the holder; past the skew guard, the least loaded with the
    holder to pull from; an unknown prompt, the rendezvous owner, unstamped),
    the counts agree, and a torn-down backend leaves the directory."""
    prompt = [7, 7, 7, 7, 1, 2, 3, 4, 9, 9]
    hashes = jblock.chain_hashes(prompt, 4)

    async def drive(pkg):
        SERVE_METRICS.reset()
        p = PKG[pkg]
        node, sup, calls = await _router(pkg, "fc", fleet_cache=True, kv_migration=True,
                                         prefix_affinity=True)
        try:
            cfg = sup._config
            log = [(cfg.pool_fleet_cache, cfg.pool_kv_migration, cfg.fleet_digest_k,
                    p.m.encode(cfg))]
            sup._deployments = [_fake_dep(pkg, s, 0) for s in range(3)]
            sup._deployments[0].load = p.m.ServeLoad(job_id="j0", queue_depth=3)
            ack = await sup._on_load("w1", p.m.ServeLoad(
                job_id="j1", serve_name="fc@1", cache_digest=[[hashes[1], 3], [hashes[0], 1]]))
            log.append(p.m.encode(ack))
            log.append((dict(sup._digests), _counts(pkg, sup)))
            sup._deployments[0].load = p.m.ServeLoad(job_id="j0", queue_depth=0)
            log.append(p.m.encode(await sup._on_load("wx", p.m.ServeLoad(job_id="zz"))))
            req = p.m.GenerateRequest(serve_name="fc", prompts=[list(prompt)])
            for _ in range(3):
                assert (await sup._route_request("c", req)).ok
            sup._deployments[1].load = p.m.ServeLoad(job_id="j1", queue_depth=50)
            assert (await sup._route_request("c", req)).ok
            other = p.m.GenerateRequest(serve_name="fc", prompts=[[9, 1, 4, 4]])
            for _ in range(3):
                await sup._route_request("c", other)
            log.append([(peer, p.m.encode(msg)) for peer, msg in calls])
            log.append(_counts(pkg, sup))
            await sup._teardown(sup._deployments[1])
            log.append(sorted(sup._digests))
            sup._router.close()
            return log, calls
        finally:
            await node.stop()

    jlog, jcalls = run(drive("jax"))
    tlog, tcalls = run(drive("port"))
    assert tlog == jlog
    assert tlog[0][:3] == (True, True, 32)
    assert tmsg.decode(tlog[1]) == tmsg.ServeLoadAck(ok=True, migrate_peer="w2",
                                                     migrate_serve="fc@2")
    assert tlog[2][0] == {"fc@1": {hashes[1]: 3, hashes[0]: 1}}
    assert [(m.serve_name, m.pull_peer, m.pull_serve) for _, m in tcalls[:4]] == (
        [("fc@1", None, None)] * 3 + [(tcalls[3][1].serve_name, "w1", "fc@1")])
    assert tcalls[3][1].serve_name != "fc@1"
    assert len({m.serve_name for _, m in tcalls[4:7]}) == 1
    assert all(m.pull_peer is None for _, m in tcalls[4:7])
    assert isinstance(tcalls[7][1], tmsg.CancelJob)  # the teardown
    assert tlog[-2]["affinity_routed"] >= 3 and tlog[-1] == []


def test_router_defaults_off_no_directory_paths():
    """Off: no directory, no pull stamp, the config's fleet fields None
    (the dispatched bytes unchanged) and a bare ack, in both routers."""
    async def drive(pkg):
        p = PKG[pkg]
        node, sup, calls = await _router(pkg, "off")
        try:
            sup._deployments = [_fake_dep(pkg, s, 0, serve="off") for s in range(2)]
            ack = await sup._on_load("w0", p.m.ServeLoad(
                job_id="j0", serve_name="off@0", cache_digest=None))
            await sup._route_request("c", p.m.GenerateRequest(serve_name="off",
                                                               prompts=[[1, 2, 3, 4]]))
            sup._router.close()
            cfg = sup._config
            return (cfg.pool_fleet_cache, cfg.pool_kv_migration, cfg.fleet_digest_k,
                    p.m.encode(cfg), p.m.encode(ack), dict(sup._digests),
                    [p.m.encode(m) for _, m in calls])
        finally:
            await node.stop()

    got = {pkg: run(drive(pkg)) for pkg in PKG}
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (None, None, None) and got["port"][5] == {}
    assert tmsg.decode(got["port"][4]) == tmsg.ServeLoadAck(ok=True)
    assert b"pull_peer" not in got["port"][6][0]


# -------------------------------------------------------------- frame cap


SPEC_POOL = dict(max_batch=2, max_new_tokens=16, pool_block_size=8, pool_blocks=24,
                 pool_prefill_chunk=8, pool_prefix_cache=True, pool_fleet_cache=True,
                 pool_kv_migration=True, load_report_s=0.0)
CAP_PROMPT = [(i * 7 + 3) % 50 + 1 for i in range(27)]  # 3 full blocks: 12288 bytes


@pytest.fixture(scope="module")
def flat_weights(tmp_path_factory, pair):
    """The pair's weights as one flat f32 SafeTensors file, and its spec."""
    _, variables, _ = pair
    path = tmp_path_factory.mktemp("fw") / "tiny.safetensors"
    save_file(flatten_tree(variables), str(path))
    return {"family": "llama", "preset": "tiny", "config": {"dtype": "float32"},
            "weights": str(path), "serve_dtype": "float32"}


async def _executor_pair(pkg, spec):
    """Holder and puller executors of one package on two TCP nodes that know
    each other's address, each serving the spec's pool under its name."""
    m = jmsg if pkg == "jax" else tmsg
    nodes, exes, pools = [], [], []
    for name in ("h", "p"):
        node = (JNode(JTcp(), peer_id=name) if pkg == "jax"
                else Node(TcpTransport(), peer_id=name))
        await node.start(["127.0.0.1:0"])
        nodes.append(node)
        ex = JInfer(node) if pkg == "jax" else InProcessInferExecutor(node, torch.device("cpu"))
        job = m.JobSpec(job_id=f"j{name}", executor=m.Executor(
            kind="infer", name=m.INFER_EXECUTOR_NAME,
            infer=m.InferExecutorConfig(model=dict(spec), serve_name=f"cap@{name}", **SPEC_POOL)))
        await ex.execute(f"j{name}", job, "")
        exes.append(ex)
    nodes[0].add_peer_addr("p", nodes[1].listen_addrs[0])
    nodes[1].add_peer_addr("h", nodes[0].listen_addrs[0])
    for ex, name in zip(exes, ("h", "p")):
        for _ in range(2400):
            if f"j{name}" in ex.batchers:
                break
            await asyncio.sleep(0.05)
        pools.append(ex.batchers[f"j{name}"].pool)
    await asyncio.sleep(0.2)  # the handlers register right after the pool
    return m, nodes, exes, pools


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_chain_past_the_frame_cap_ends_alike(pair, flat_weights, pkg, monkeypatch):
    """A chain whose frame passes ``MAX_FRAME`` (lowered to 8 KiB, under
    the 3 blocks' 12 KiB): the pull fails on the holder's send, the puller
    counts a miss and re-prefills to the right answer; a migration of it
    fails on the sender's send and the requeued group answers right."""
    monkeypatch.setattr(jfabric, "MAX_FRAME", 8192)
    monkeypatch.setattr(tfabric, "MAX_FRAME", 8192)
    want = _ref(pair, CAP_PROMPT, 8)

    async def main():
        if pkg == "jax":
            SERVE_METRICS.reset()
        m, nodes, exes, (hold, pull) = await _executor_pair(pkg, flat_weights)
        try:
            first = await nodes[1].request("h", m.PROTOCOL_GENERATE, m.GenerateRequest(
                serve_name="cap@h", prompts=[CAP_PROMPT], max_new_tokens=8), timeout=120)
            hashes = jblock.chain_hashes(CAP_PROMPT, 8)
            served = await asyncio.wrap_future(hold.serve_chain(hashes))
            pulled = await nodes[0].request("p", m.PROTOCOL_GENERATE, m.GenerateRequest(
                serve_name="cap@p", prompts=[CAP_PROMPT], max_new_tokens=8, pull_peer="h",
                pull_serve="cap@h"), timeout=120)
            group = (JGroup if pkg == "jax" else _Group)([list(CAP_PROMPT)], 8, Future())
            ticket = {"group": group, "prompt": list(CAP_PROMPT), "emitted": [], "budget": 8,
                      "hashes": served["hashes"], "block_size": 8, "leaves": served["leaves"],
                      "weight_round": None, "weight_generation": None,
                      "target": ("p", "cap@p")}
            if pkg == "jax":
                await exes[0]._migrate_out(ticket, hold, None)
                stats = SERVE_METRICS.snapshot()
                counts = {k: stats[k] for k in ("remote_prefix_hits", "remote_prefix_misses",
                                                "migrations")}
            else:
                await exes[0]._migrate_out(ticket, hold)
                counts = {k: hold.stats[k] + pull.stats[k] for k in (
                    "remote_prefix_hits", "remote_prefix_misses", "migrations")}
            migrated = await asyncio.wrap_future(group.fut)
            return first.tokens, pulled.tokens, migrated, counts, pull.prefill_chunks
        finally:
            for node in nodes:
                await node.stop()
            for ex in exes:
                for b in list(ex.batchers.values()):
                    b.close()

    first, pulled, migrated, counts, chunks = run(main())
    assert first == pulled == migrated == [want]
    assert counts == {"remote_prefix_hits": 0, "remote_prefix_misses": 1, "migrations": 0}
    assert chunks == 4  # the puller re-prefilled all 27 tokens, 8 a chunk
