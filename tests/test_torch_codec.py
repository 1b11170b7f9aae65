"""Port parity: the CBOR codec, the wire messages and the frames.

Every message class the port's fabric sends, built in both packages from
the same seeded field values, encodes to identical bytes, and each
package decodes the other's bytes to equal values. The frames
(``write_frame`` / ``read_frame``: an 8-byte little-endian length and a
CBOR body) are byte-identical, and so is the raw codec on seeded nested
values; both codecs refuse the same malformed input with
``CBORDecodeError``.
"""

from __future__ import annotations

import asyncio
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from hypha_tpu import codec as jcodec
from hypha_tpu import messages as jmsg
# Registers the metrics plane's messages in the reference's codec, as the
# port's worker modules register them in the port's on import.
from hypha_tpu.telemetry import metrics_plane as _jmetrics_plane  # noqa: F401
from hypha_tpu.network import fabric as jfabric
from hypha_tpu.resources import Resources as JResources
from hypha_tpu_torch import codec as tcodec
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.network import fabric as tfabric
from hypha_tpu_torch.resources import Resources as TResources

PKG = {"jax": SimpleNamespace(m=jmsg, R=JResources), "port": SimpleNamespace(m=tmsg, R=TResources)}


def _draws(seed: int) -> SimpleNamespace:
    """Field values drawn once and handed to both packages' constructors."""
    rng = np.random.default_rng(seed)
    return SimpleNamespace(
        s=[f"{w}-{rng.integers(1 << 40):x}" for w in ("peer", "lease", "job", "req", "data", "tag")],
        i=[int(v) for v in rng.integers(0, 1 << 20, 6)],
        f=[float(v) for v in np.abs(rng.standard_normal(6))],
    )


def _train(p, v, **extra):
    m = p.m
    return m.JobSpec(job_id=v.s[2], executor=m.Executor(
        kind="train", name=m.TRAIN_EXECUTOR_NAME, train=m.TrainExecutorConfig(
            model={"model_type": m.ModelType.CAUSAL_LM, "family": "llama", "preset": "tiny",
                   "seed": v.i[0], "config": {"num_layers": 2, "remat": True}},
            data=m.Fetch(m.Reference.from_scheduler(v.s[0], v.s[4])),
            updates=m.Send(m.Reference.from_peers([v.s[0]], v.s[5])),
            results=m.Receive(m.Reference.from_peers([v.s[0], v.s[3]], "results")),
            optimizer=m.Adam(lr=v.f[0], weight_decay=v.f[1]), batch_size=v.i[1],
            scheduler=m.LRScheduler(kind=m.LRSchedulerKind.COSINE_WITH_WARMUP, warmup_steps=v.i[2]),
            loss=m.Loss.CROSS_ENTROPY, **extra)))


def _shard_map(p, v, **extra):
    """A placement over two shards with one reduce group."""
    return p.m.ShardMap(round=0, shards=[v.s[3], v.s[4]], tags=[f"{v.s[5]}.s0", f"{v.s[5]}.s1"],
                        fragments=v.i[0] % 7 + 2, groups=[[v.s[0], v.s[1], v.s[2]]], **extra)


def _aggregate(p, v, **extra):
    m = p.m
    return m.JobSpec(job_id=v.s[2], executor=m.Executor(
        kind="aggregate", name=m.AGGREGATE_EXECUTOR_NAME, aggregate=m.AggregateExecutorConfig(
            updates=m.Receive(m.Reference.from_peers([v.s[0], v.s[3]], v.s[5])),
            results=m.Send(m.Reference.from_peers([v.s[0], v.s[3]], "results",
                                                  m.TransferStrategy.ANY)),
            optimizer=m.Nesterov(lr=v.f[2], momentum=v.f[3]), num_workers=v.i[3], **extra)))


def _infer(p, v, **additive):
    m = p.m
    return m.InferExecutorConfig(
        model={"model_type": m.ModelType.CAUSAL_LM, "family": "llama", "preset": "llama2-7b",
               "seed": v.i[0]},
        serve_name=v.s[5], max_new_tokens=v.i[1], max_batch=8, pool_block_size=16,
        pool_ragged=True, eos_token_id=v.i[2], load_report_s=0.0, **additive)


def _resources(p, v):
    return p.R(gpu=v.f[0], cpu=v.f[1], memory=v.f[2], storage=v.f[3])


def _spec(p, v, kind):
    return p.m.WorkerSpec(resources=_resources(p, v),
                          executor=[p.m.ExecutorDescriptor(executor_class=kind, name=v.s[5])])


MESSAGES = {
    "RequestWorker": lambda p, v: p.m.RequestWorker(
        id=v.s[3], spec=_spec(p, v, "train"), timeout=v.f[4], bid=v.f[5], reply_to=v.s[0]),
    "WorkerOffer": lambda p, v: p.m.WorkerOffer(
        request_id=v.s[3], lease_id=v.s[1], peer_id=v.s[0], resources=_resources(p, v),
        price=v.f[4], expires_in=v.f[5],
        executors=[p.m.ExecutorDescriptor("train", p.m.TRAIN_EXECUTOR_NAME),
                   p.m.ExecutorDescriptor("aggregate", p.m.AGGREGATE_EXECUTOR_NAME)]),
    "RenewLease": lambda p, v: p.m.RenewLease(lease_id=v.s[1]),
    "RenewLeaseResponse": lambda p, v: p.m.RenewLeaseResponse(lease_id=v.s[1], timeout=v.f[0]),
    "DispatchJob/train": lambda p, v: p.m.DispatchJob(lease_id=v.s[1], spec=_train(p, v)),
    "DispatchJob/aggregate": lambda p, v: p.m.DispatchJob(lease_id=v.s[1], spec=_aggregate(p, v)),
    # The sharded service and the tree reduce: the placement, a member's
    # and a reducer's train spec, a shard's aggregate spec, UPDATED with
    # its shard.
    "ShardMap": lambda p, v: _shard_map(p, v),
    "ShardMap/tree": lambda p, v: _shard_map(p, v, tree_depth=2),
    "DispatchJob/train/member": lambda p, v: p.m.DispatchJob(lease_id=v.s[1], spec=_train(
        p, v, ps_shards=_shard_map(p, v), reduce_via=v.s[0], sync_mode="stream", fragments=4)),
    "DispatchJob/train/reducer": lambda p, v: p.m.DispatchJob(lease_id=v.s[1], spec=_train(
        p, v, ps_shards=_shard_map(p, v), reduce_members=[v.s[1], v.s[2]], delta_codec="int8")),
    "DispatchJob/aggregate/shard": lambda p, v: p.m.DispatchJob(lease_id=v.s[1], spec=_aggregate(
        p, v, shard_index=1, num_ps_shards=2, sync_mode="stream", fragments=4)),
    "DispatchJob/infer": lambda p, v: p.m.DispatchJob(lease_id=v.s[1], spec=p.m.JobSpec(
        job_id=v.s[2], executor=p.m.Executor(kind="infer", name=p.m.INFER_EXECUTOR_NAME,
                                             infer=_infer(p, v)))),
    "InferExecutorConfig/additive": lambda p, v: _infer(
        p, v, report_metrics_s=v.f[0], metrics_peer=v.s[0], pool_fleet_cache=True,
        pool_kv_migration=False, fleet_digest_k=v.i[3], top_k=v.i[4], scheduling="window"),
    "GenerateRequest": lambda p, v: p.m.GenerateRequest(
        serve_name=v.s[5], prompts=[v.i[:3], v.i[3:]], max_new_tokens=v.i[4]),
    "GenerateRequest/additive": lambda p, v: p.m.GenerateRequest(
        serve_name=v.s[5], prompts=[v.i], max_new_tokens=v.i[4], temperature=v.f[0],
        top_k=v.i[5], seed=v.i[1], traceparent=v.s[3], pull_peer=v.s[0], pull_serve=v.s[5]),
    "GenerateResponse": lambda p, v: p.m.GenerateResponse(tokens=[v.i[:3], v.i[3:]]),
    "GenerateResponse/busy": lambda p, v: p.m.GenerateResponse(
        tokens=[], ok=False, retry_after_ms=v.f[1]),
    "GenerateResponse/additive": lambda p, v: p.m.GenerateResponse(
        tokens=[v.i], weight_round=v.i[0], weight_generation=v.i[1]),
    "DispatchJobResponse": lambda p, v: p.m.DispatchJobResponse(accepted=False, message=v.s[2]),
    "CancelJob": lambda p, v: p.m.CancelJob(lease_id=v.s[1], job_id=v.s[2]),
    "JobStatus": lambda p, v: p.m.JobStatus(job_id=v.s[2], state="failed", message=v.s[4]),
    "Ack": lambda p, v: p.m.Ack(ok=False, message=v.s[3]),
    "DataRequest": lambda p, v: p.m.DataRequest(dataset=v.s[4], peer_id=v.s[0]),
    "DataResponse": lambda p, v: p.m.DataResponse(data_provider=v.s[4], index=v.i[4]),
    "DataRecord": lambda p, v: p.m.DataRecord(num_slices=v.i[5]),
    "DataSlice": lambda p, v: p.m.DataSlice(dataset=v.s[4], index=v.i[4]),
    "HealthRequest": lambda p, v: p.m.HealthRequest(),
    "HealthResponse": lambda p, v: p.m.HealthResponse(healthy=True),
    "SchedulerHello": lambda p, v: p.m.SchedulerHello(generation=v.i[0], job_id=v.s[2],
                                                      round=v.i[1]),
    "AdoptAck": lambda p, v: p.m.AdoptAck(job_id=v.s[2], round=v.i[1], epoch=v.i[2],
                                          state="stale", generation=v.i[0], ok=False),
    "PriceRange": lambda p, v: p.m.PriceRange(bid=v.f[0], max=v.f[1]),
    "Progress/metrics": lambda p, v: p.m.Progress(
        kind=p.m.ProgressKind.METRICS, job_id=v.s[2], round=v.i[1],
        metrics={"loss": v.f[0], "samples": v.f[1]}),
    "Progress/updated": lambda p, v: p.m.Progress(kind=p.m.ProgressKind.UPDATED, job_id=v.s[2],
                                                  round=v.i[1]),
    "Progress/updated/shard": lambda p, v: p.m.Progress(
        kind=p.m.ProgressKind.UPDATED, job_id=v.s[2], round=v.i[1], shard=v.i[2] % 4 + 1),
    "ProgressResponse": lambda p, v: p.m.ProgressResponse(
        kind=p.m.ProgressResponseKind.SCHEDULE_UPDATE, counter=v.i[2]),
    # The router's heartbeat as a port backend sends it (weight_* and
    # cache_digest None, so off the wire), one with every field set, and
    # the acks.
    "ServeLoad": lambda p, v: p.m.ServeLoad(
        job_id=v.s[2], serve_name=f"{v.s[5]}@1", queue_depth=v.i[0] % 9, free_blocks=v.i[1],
        live_requests=v.i[2] % 8, requests=v.i[3], rejections=v.i[4] % 5),
    "ServeLoad/additive": lambda p, v: p.m.ServeLoad(
        job_id=v.s[2], serve_name=v.s[5], queue_depth=v.i[0], weight_round=v.i[1],
        weight_generation=v.i[2], cache_digest=[[v.i[3], 2], [v.i[4], 1]]),
    "ServeLoadAck": lambda p, v: p.m.ServeLoadAck(ok=bool(v.i[0] % 2)),
    "ServeLoadAck/additive": lambda p, v: p.m.ServeLoadAck(migrate_peer=v.s[0],
                                                           migrate_serve=v.s[5]),
    # The fleet block plane (/hypha-blocks): 64-bit chain hashes of either
    # sign, leaves keyed by the JAX cache's tree paths with raw bytes.
    "BlockPull": lambda p, v: p.m.BlockPull(
        serve_name=f"{v.s[5]}@0", chain_hashes=[v.i[0] << 40, -(v.i[1] << 43), v.i[2]],
        weight_round=v.i[3], weight_generation=v.i[4]),
    "BlockChain": lambda p, v: p.m.BlockChain(
        ok=True, chain_hash=v.i[2], hashes=[v.i[0] << 40, v.i[2]], block_size=16,
        leaves=_block_leaves(v), weight_round=v.i[3]),
    "BlockChain/refused": lambda p, v: p.m.BlockChain(ok=False, error="stale-generation",
                                                      weight_round=v.i[3],
                                                      weight_generation=v.i[4]),
    "MigrateRequest": lambda p, v: p.m.MigrateRequest(
        serve_name=f"{v.s[5]}@1", prompt=[v.i[0] % 32000, 1, 2], emitted=[v.i[1] % 32000],
        budget=v.i[5] % 64, chain_hashes=[-(v.i[2] << 30)], block_size=16,
        leaves=_block_leaves(v)),
    "MigrateAck": lambda p, v: p.m.MigrateAck(ok=True, tokens=[v.i[3] % 32000, v.i[4] % 32000]),
    "MigrateAck/busy": lambda p, v: p.m.MigrateAck(ok=False, error="busy",
                                                   retry_after_ms=v.f[2] * 1e3),
}


def _block_leaves(v) -> dict:
    rng = np.random.default_rng(v.i[0])
    return {f"['layers_{i}']['self_attn']['{k}']": [
        rng.integers(0, 256, 64, dtype=np.uint8).tobytes(), dtype, [2, 2, 8]]
        for i in (0, 1, 10) for k, dtype in (("k", "bfloat16"), ("v", "int8"))}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_messages_encode_alike_and_cross_decode(name, seed):
    v = _draws(seed)
    jax_msg, port_msg = (MESSAGES[name](PKG[k], v) for k in ("jax", "port"))
    jb, tb = jmsg.encode(jax_msg), tmsg.encode(port_msg)
    assert tb == jb
    assert jmsg.decode(tb) == jax_msg
    assert tmsg.decode(jb) == port_msg
    assert tmsg.encode(tmsg.decode(jb)) == jb


def test_every_port_message_class_is_registered_as_in_the_jax_package():
    assert set(tmsg._REGISTRY) <= set(jmsg._REGISTRY)
    sent = {name.split("/")[0] for name in MESSAGES}
    assert sent <= set(tmsg._REGISTRY)
    for name in sent:
        fields = lambda cls: [f.name for f in cls.__dataclass_fields__.values()]  # noqa: E731
        assert fields(tmsg._REGISTRY[name]) == fields(jmsg._REGISTRY[name]), name
    for const in ("PROTOCOL_API", "PROTOCOL_HEALTH", "PROTOCOL_PROGRESS", "PROTOCOL_GENERATE",
                  "PROTOCOL_SERVE", "TOPIC_WORKER",
                  "TRAIN_EXECUTOR_NAME", "AGGREGATE_EXECUTOR_NAME", "INFER_EXECUTOR_NAME"):
        assert getattr(tmsg, const) == getattr(jmsg, const), const


def _values(seed: int):
    """Seeded nested values covering every CBOR head width and type."""
    rng = np.random.default_rng(seed)
    ints = [0, 23, 24, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -24, -25,
            -(2**64)] + [int(x) for x in rng.integers(-(2**62), 2**62, 8)]
    floats = [0.0, -0.0, 1.5, float("inf"), -float("inf")] + [float(x) for x in rng.standard_normal(4)]
    strs = ["", "a", "δθ", "x" * 300, "☃" * 40]
    blobs = [b"", bytes(rng.integers(0, 256, 31, dtype=np.uint8)), b"\x00" * 70000]
    return [ints, floats, strs, blobs, None, True, False,
            {"k": ints[:3], "nested": {"l": [floats[:2], {"z": None}]}, "b": blobs[1]},
            [[[[[1]]]]], {str(i): i for i in range(30)}]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_bytes_match(seed):
    for value in _values(seed):
        assert tcodec.dumps(value) == jcodec.dumps(value), value
        assert tcodec.loads(jcodec.dumps(value)) == jcodec.loads(tcodec.dumps(value))


@pytest.mark.parametrize("data", [
    b"\xf9\x3c\x00",  # f16 1.0
    b"\xfa\x3f\xc0\x00\x00",  # f32 1.5
    b"\x5f\x42ab\x41c\xff",  # indefinite byte string
    b"\x9f\x01\x02\xff",  # indefinite array
    b"\xbf\x61a\x01\xff",  # indefinite map
    b"\xc1\x1a\x00\x01\x00\x00",  # a tag, discarded
])
def test_codec_reads_the_accepted_forms_alike(data):
    assert tcodec.loads(data) == jcodec.loads(data)


@pytest.mark.parametrize("data", [
    b"", b"\x1a\x00\x01", b"\x62a", b"\x82\x01", b"\xa1\x01", b"\x01\x02", b"\xff",
    b"\xbf\x61a\xff", b"\x81" * 200 + b"\x01", b"\x62\xff\xfe",
])
def test_codecs_refuse_the_same_malformed_input(data):
    with pytest.raises(jcodec.CBORDecodeError):
        jcodec.loads(data)
    with pytest.raises(tcodec.CBORDecodeError):
        tcodec.loads(data)


class _Buffer:
    """A stream that records writes and serves reads from given bytes."""

    def __init__(self, data: bytes = b"") -> None:
        self.written = b""
        self._data = data

    async def write(self, data: bytes) -> None:
        self.written += bytes(data)

    async def read(self, n: int = 65536) -> bytes:
        out, self._data = self._data[:n], self._data[n:]
        return out

    async def read_exactly(self, n: int) -> bytes:
        out = await self.read(n)
        if len(out) != n:
            raise jfabric.FrameError("EOF")
        return out


@pytest.mark.parametrize("name", ["RequestWorker", "DispatchJob/train", "Progress/metrics"])
def test_frames_are_byte_identical(name):
    v = _draws(5)
    frames = {}
    for k, fab in (("jax", jfabric), ("port", tfabric)):
        msg = MESSAGES[name](PKG[k], v)
        out = _Buffer()
        obj = {"ok": True, "body": PKG[k].m.encode(msg)}
        size = asyncio.run(fab.write_frame(out, obj))
        assert size == len(out.written)
        frames[k] = out.written
    assert frames["port"] == frames["jax"]
    (n,) = struct.unpack("<Q", frames["jax"][:8])
    assert n == len(frames["jax"]) - 8
    read = asyncio.run(tfabric.read_frame(_Buffer(frames["jax"])))
    assert tmsg.decode(read["body"]) == MESSAGES[name](PKG["port"], v)
    assert asyncio.run(jfabric.read_frame(_Buffer(frames["port"]))) == read
    assert tfabric.MAX_FRAME == jfabric.MAX_FRAME


def test_oversized_frames_are_refused_alike():
    header = struct.pack("<Q", 1 << 30)
    with pytest.raises(jfabric.FrameError):
        asyncio.run(jfabric.read_frame(_Buffer(header), max_size=1 << 20))
    with pytest.raises(tfabric.FrameError):
        asyncio.run(tfabric.read_frame(_Buffer(header), max_size=1 << 20))


def test_unported_wire_tags_do_not_decode():
    """A live-weight follow decodes (ported since; its bytes are held in
    ``tests/test_torch_weight_stream.py``); the router's heartbeat does,
    with its unset fields off the wire, and so does the fleet block plane
    (ported since; its messages are held byte for byte in
    ``tests/test_torch_fleet_cache.py``); an unknown tag does not; an
    infer executor needs its config, as in the JAX package."""
    serve = jmsg.encode(jmsg.ServeLoad(job_id="j", queue_depth=3))
    assert tmsg.decode(serve) == tmsg.ServeLoad(job_id="j", queue_depth=3)
    assert b"weight_round" not in serve and b"cache_digest" not in serve
    assert tmsg.encode(tmsg.ServeLoadAck()) == jmsg.encode(jmsg.ServeLoadAck())
    assert b"migrate" not in tmsg.encode(tmsg.ServeLoadAck())
    pull = jmsg.BlockPull(serve_name="s", chain_hashes=[1])
    assert tmsg.encode(tmsg.decode(jmsg.encode(pull))) == jmsg.encode(pull)
    follow = jmsg.encode(jmsg.InferExecutorConfig(
        model={}, serve_name="s", serve_follow_rounds=jmsg.WeightFollow()))
    assert tmsg.encode(tmsg.decode(follow)) == follow
    assert isinstance(tmsg.decode(follow).serve_follow_rounds, tmsg.WeightFollow)
    with pytest.raises(ValueError, match="NoSuchMessag"):
        tmsg.decode(follow.replace(b"WeightFollow", b"NoSuchMessag"))
    for m in (jmsg, tmsg):
        with pytest.raises(ValueError, match="infer config"):
            m.Executor(kind="infer", name="generate")
