"""Port parity: the training input pipeline (``hypha_tpu_torch/executor/
dataset.py``, ``worker/slice_cache.py``, ``scheduler/data_scheduler.py``,
the connector's pipelined fetch and the trainer's deferred loss reads)
against ``hypha_tpu`` (``tests/test_data_pipeline.py``'s cases), on inputs
seeded with numpy and SafeTensors slices written once:

  * whole-slice and per-sample batches, sync and pipelined streams: the JAX
    package's values, dtypes and order exactly;
  * the prefetcher's order, bound, backoff, retry and surfaced failure;
  * the held-slice window, its epoch wrap and ``remove_worker``: the JAX
    ``DataScheduler``'s assignments; the epoch on the wire only for
    prefetch requests, both ways between the packages over loopback TCP;
  * the slice cache: each entry's bytes and sidecar equal to the JAX
    cache's after the same operations (round trip, promotion, LRU,
    corruption);
  * ``run_training``: pipelined losses equal to the synchronous ones, float
    for float, blocking and stream; within 1e-4 of the JAX trainer's;
  * the bridge client: a ``send_status`` answers while another thread's
    ``fetch`` is held open.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import queue
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
from safetensors.numpy import save_file

from _torch_parity import tiny_pair
from hypha_tpu import messages as jmsg
from hypha_tpu.data_node import DataNode as JDataNode
from hypha_tpu.executor import dataset as J
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.gateway import Gateway as JGateway
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.scheduler.data_scheduler import DataScheduler as JDataScheduler
from hypha_tpu.telemetry.ft_metrics import DATA_METRICS as JMETRICS
from hypha_tpu.worker.connectors import Connector as JConnector
from hypha_tpu.worker.slice_cache import SliceCache as JSliceCache
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.data_node import DataNode as TDataNode
from hypha_tpu_torch.executor import dataset as T
from hypha_tpu_torch.executor.bridge_client import Session as TSession
from hypha_tpu_torch.gateway import Gateway as TGateway
from hypha_tpu_torch.network import Node as TNode
from hypha_tpu_torch.network import TcpTransport as TTcp
from hypha_tpu_torch.scheduler.data_scheduler import DataScheduler as TDataScheduler
from hypha_tpu_torch.telemetry.ft_metrics import DATA_METRICS as TMETRICS
from hypha_tpu_torch.worker.bridge import Bridge as TBridge
from hypha_tpu_torch.worker.connectors import Connector as TConnector
from hypha_tpu_torch.worker.slice_cache import SliceCache as TSliceCache

SIZES = (5, 3, 7, 2, 6, 1, 4)


def _make_slices(root: Path, sizes=SIZES, seed=0, keys=("input_ids", "labels")) -> list:
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, n in enumerate(sizes):
        tensors = {}
        if "input_ids" in keys:
            tensors["input_ids"] = rng.integers(0, 100, (n, 4)).astype(np.int32)
        if "labels" in keys:
            tensors["labels"] = rng.integers(0, 9, (n,)).astype(np.int64)
        p = root / f"s{i}.safetensors"
        save_file(tensors, str(p))
        paths.append(str(p))
    return paths


def _same(jb: dict, tb: dict) -> None:
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert tb[k].numpy().dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k].numpy(), jb[k])


# ------------------------------------------------------------ assembly


@pytest.mark.parametrize("batch_size", [1, 3, 4, 7])
def test_slice_batches_equal_the_references_per_sample_and_whole_slice(tmp_path, batch_size):
    paths = _make_slices(tmp_path)

    def samples(pkg):
        for p in paths:
            yield from pkg.slice_samples(p)

    legacy = list(J.batches(samples(J), batch_size))
    jwhole = list(J.slice_batches((J.load_slice(p) for p in paths), batch_size))
    twhole = list(T.slice_batches((T.load_slice(p) for p in paths), batch_size))
    tlegacy = list(T.batches(samples(T), batch_size))
    assert len(legacy) == len(jwhole) == len(twhole) == len(tlegacy) > 0
    for a, b, c, d in zip(legacy, jwhole, twhole, tlegacy):
        _same(a, c)
        _same(b, c)
        _same(a, d)


def test_carry_spans_several_small_slices(tmp_path):
    paths = _make_slices(tmp_path, [2, 1, 2, 3, 1])
    jb = list(J.slice_batches((J.load_slice(p) for p in paths), 4))
    tb = list(T.slice_batches((T.load_slice(p) for p in paths), 4))
    assert len(jb) == len(tb) == 2  # 9 samples: two batches, the tail carried
    for a, b in zip(jb, tb):
        _same(a, b)


def test_full_batches_inside_a_slice_are_views(tmp_path):
    (path,) = _make_slices(tmp_path, [8])
    tensors = T.load_slice(path)
    got = list(T.slice_batches(iter([tensors]), 4))
    assert len(got) == 2
    for b in got:
        for k, v in b.items():
            assert v.untyped_storage().data_ptr() == tensors[k].untyped_storage().data_ptr()


def test_mid_stream_key_change_is_refused_alike(tmp_path):
    a = _make_slices(tmp_path / "a", [4])[0]
    b = _make_slices(tmp_path / "b", [4], keys=("input_ids",))[0]
    for pkg in (J, T):
        with pytest.raises(ValueError, match="key mismatch"):
            list(pkg.slice_batches((pkg.load_slice(p) for p in [a, b]), 2))


@pytest.mark.parametrize("case", ["empty", "no tensors"])
def test_bad_slices_raise_with_their_path_in_both_assemblies(tmp_path, case):
    p = tmp_path / f"{case.replace(' ', '_')}.safetensors"
    save_file({} if case == "no tensors" else {"input_ids": np.zeros((0, 4), np.int32)}, str(p))
    for pkg in (J, T):
        with pytest.raises(ValueError, match=p.name):
            list(pkg.slice_samples(p))
        with pytest.raises(ValueError, match=p.name):
            pkg.load_slice(p)


def test_ragged_counts_clamp_alike(tmp_path):
    p = tmp_path / "ragged.safetensors"
    save_file({"input_ids": np.arange(20, dtype=np.int32).reshape(5, 4),
               "labels": np.arange(3, dtype=np.int32)}, str(p))
    assert len(list(T.slice_samples(p))) == len(list(J.slice_samples(p))) == 3
    _same(J.load_slice(p), T.load_slice(p))


def test_load_slice_reads_only_input_names(tmp_path):
    (path,) = _make_slices(tmp_path, [4])
    _same(J.load_slice(path, ["input_ids"]), T.load_slice(path, ["input_ids"]))
    assert list(T.load_slice(path, ["input_ids"])) == ["input_ids"]
    for pkg in (J, T):
        with pytest.raises(KeyError, match="missing input tensors"):
            pkg.load_slice(path, input_names=["nope"])


def test_preprocessor_runs_before_the_input_filter(tmp_path):
    """Every tensor is read, the preprocessor runs, then the filter: a key
    the preprocessor makes from one the filter drops is kept."""
    (path,) = _make_slices(tmp_path, [6])

    def derive(tensors):  # both packages
        return {**tensors, "shifted": tensors["labels"] + 1}

    for sync in (True, False):
        got = {}
        for name, pkg in (("jax", J), ("port", T)):
            stream = pkg.stream_batches(lambda: path, 3, ["input_ids", "shifted"], derive,
                                        **({} if sync else {"pipeline": True, "prefetch": 1}))
            got[name] = [next(stream) for _ in range(4)]
            stream.close()
        for a, b in zip(got["jax"], got["port"]):
            _same(a, b)
            assert sorted(b) == ["input_ids", "shifted"]


# ------------------------------------------------------------ the prefetcher


def test_prefetcher_keeps_order_and_bounds_its_depth(tmp_path):
    paths = _make_slices(tmp_path, [2, 2, 2, 2])
    fetched: list = []
    it = itertools.cycle(paths)

    def fetch():
        p = next(it)
        fetched.append(p)
        return p

    pf = T.SlicePrefetcher(fetch, depth=2)
    try:
        assert [pf.take() for _ in range(6)] == (paths * 2)[:6]
        time.sleep(0.3)
        # The queue bound throttles the producer: at most ``depth`` ready
        # and one more fetched beyond what was taken.
        assert len(fetched) <= 6 + 2 + 1
        assert TMETRICS.snapshot()["peak_prefetch_queue_depth"] <= 2
    finally:
        pf.close()


def test_prefetcher_retries_transient_failures():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("data node mid-restart")
        return "ok-path"

    before = TMETRICS.prefetch_errors.value()
    pf = T.SlicePrefetcher(flaky, depth=1, retry_base_s=0.01)
    try:
        assert pf.take() == "ok-path"
        assert TMETRICS.prefetch_errors.value() - before == 2
    finally:
        pf.close()


def test_prefetcher_backs_off_exponentially_up_to_five_seconds(monkeypatch):
    """The waits between attempts: 0.25 s doubling, capped at 5 s (the
    stop event's wait is recorded instead of slept)."""
    waits: list = []

    class Recorded(threading.Event):
        def wait(self, timeout=None):
            if timeout is not None:
                waits.append(timeout)
                return self.is_set()
            return super().wait(timeout)

    monkeypatch.setattr(T.threading, "Event", Recorded)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 8:
            raise OSError("down")
        return "up"

    pf = T.SlicePrefetcher(flaky, depth=1)
    try:
        assert pf.take() == "up"
    finally:
        pf.close()
    assert waits == [0.25, 0.5, 1.0, 2.0, 4.0, 5.0, 5.0, 5.0]


def test_prefetcher_surfaces_a_persistent_failure():
    def dead():
        raise OSError("gone")

    pf = T.SlicePrefetcher(dead, depth=1, retry_deadline_s=0.05, retry_base_s=0.01)
    try:
        with pytest.raises(RuntimeError, match="slice prefetch failed: gone"):
            pf.take()
    finally:
        pf.close()


def test_close_unblocks_a_producer_parked_on_the_full_queue():
    pf = T.SlicePrefetcher(lambda: "p", depth=1)
    deadline = time.monotonic() + 5
    while pf._q.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)  # the producer is now parked in put()
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 1.0 and not pf._thread.is_alive()


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_streams_give_the_references_batches(tmp_path, pipeline):
    """Both packages' streams over the same fetch sequence, each in its
    sync and pipelined forms, against the JAX sync stream; pipelined with
    ``unlink_consumed``, each slice file is gone once read."""
    src = _make_slices(tmp_path / "src", [5, 3, 7, 2])
    cycles = {name: itertools.count() for name in ("ref", "jax", "port")}

    def fetcher(name):
        def fetch():
            i = next(cycles[name])
            dest = tmp_path / name / f"f{i}.safetensors"
            dest.parent.mkdir(exist_ok=True)
            dest.write_bytes(Path(src[i % len(src)]).read_bytes())
            return str(dest)
        return fetch

    kw = {"pipeline": True, "prefetch": 2, "unlink_consumed": True} if pipeline else {}
    ref = J.stream_batches(fetcher("ref"), 4)
    jax = J.stream_batches(fetcher("jax"), 4, **kw)
    port = T.stream_batches(fetcher("port"), 4, **kw)
    try:
        for _ in range(25):
            a, b = next(ref), next(jax)
            _same(a, next(port))
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])
    finally:
        jax.close()
        port.close()
    if pipeline:
        # Read slices were deleted; only the prefetched ones may remain.
        assert len(list((tmp_path / "port").iterdir())) <= 2 + 2


def test_stream_counts_boundary_and_fetch_waits(tmp_path):
    paths = _make_slices(tmp_path, [4, 4])
    for pipeline in (False, True):
        TMETRICS.reset()
        it = itertools.cycle(paths)
        stream = T.stream_batches(lambda: next(it), 2, pipeline=pipeline, prefetch=2)
        for _ in range(8):
            next(stream)
        stream.close()
        snap = TMETRICS.snapshot()
        assert snap["boundary_waits"] >= 4, (pipeline, snap)
        assert snap["boundary_wait_seconds"] >= 0.0
        assert set(snap) == set(JMETRICS.snapshot())
    TMETRICS.reset()


# --------------------------------------------------- the held-slice window


def _ds(cls, n: int):
    return cls(None, "data", "d", n)


def _window_scenarios(cls) -> dict:
    """The reference test's scenarios, their observations in order."""
    out = {}
    ds = _ds(cls, 4)  # a full window retires the oldest
    seen = [ds.assign("w0", prefetch=2), ds.assign("w0", prefetch=2),
            sorted(ds.tracker._processed), ds.held_of("w0"), ds.assign("w0", prefetch=2),
            sorted(ds.tracker._processed), ds.held_of("w0")]
    out["defers"] = seen
    ds = _ds(cls, 3)  # no window: the previous slice retires at once
    out["legacy"] = [ds.assign("w0"), ds.assign("w0"), sorted(ds.tracker._processed)]
    ds = _ds(cls, 4)  # remove_worker reclaims every held slice
    for _ in range(3):
        ds.assign("w0", prefetch=3)
    held = ds.held_of("w0")
    ds.remove_worker("w0")
    out["remove"] = [held, "w0" in ds._last, sorted(ds.assign("w1", prefetch=1)
                                                   for _ in range(4))]
    ds = _ds(cls, 2)  # an epoch wrap leaves the old epoch's holds unretired
    seen = [ds.assign("a", prefetch=2), ds.assign("a", prefetch=2), ds.assign("b", prefetch=1),
            ds.assign("b", prefetch=1), ds.assign("b", prefetch=1), ds.tracker.epoch,
            sorted(ds.tracker._processed), ds.assign("a", prefetch=2),
            sorted(ds.tracker._processed)]
    out["wrap"] = seen
    return out


def test_held_window_assigns_as_the_reference():
    port, ref = _window_scenarios(TDataScheduler), _window_scenarios(JDataScheduler)
    assert port == ref
    assert port["defers"][:2] == [0, 1] and port["defers"][2] == []
    assert port["defers"][5] == [0] and port["defers"][6] == [1, 2]
    assert port["legacy"] == [0, 1, [0]]
    assert port["remove"] == [[0, 1, 2], False, [0, 1, 2, 3]]
    assert port["wrap"] == [0, 1, 0, 1, 0, 1, [], 1, []]


@pytest.mark.parametrize("seed", range(3))
def test_seeded_windows_assign_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    j, t = _ds(JDataScheduler, n), _ds(TDataScheduler, n)
    windows = {f"w{i}": int(rng.integers(1, 4)) for i in range(3)}
    for _ in range(80):
        peer = f"w{int(rng.integers(0, 3))}"
        if rng.random() < 0.05:
            j.remove_worker(peer)
            t.remove_worker(peer)
            continue
        window = windows[peer] if rng.random() < 0.9 else None
        assert t.assign(peer, prefetch=window) == j.assign(peer, prefetch=window)
        assert t.held_of(peer) == j.held_of(peer)
        assert len(t.held_of(peer)) <= (window or 1)
        assert (t.tracker.epoch, t.tracker._assigned, t.tracker._processed) == \
            (j.tracker.epoch, j.tracker._assigned, j.tracker._processed)


@pytest.mark.parametrize("prefetch", [None, 2], ids=["legacy", "prefetch"])
def test_data_messages_encode_as_the_reference(prefetch):
    """With each new field None nothing is stamped; set, the bytes match."""
    for m in (jmsg, tmsg):
        ref = m.Reference.from_scheduler("s", "d", prefetch=prefetch)
        assert ("prefetch" in m.to_json_dict(ref)) is (prefetch is not None)
    pairs = [(m.DataRequest(dataset="d", peer_id="w", prefetch=prefetch),
              m.DataResponse(data_provider="p", index=3,
                             epoch=None if prefetch is None else 1),
              m.Reference.from_scheduler("s", "d", prefetch=prefetch),
              m.TrainExecutorConfig(
                  model={}, data=m.Fetch(m.Reference.from_scheduler("s", "d", prefetch=prefetch)),
                  updates=m.Send(m.Reference.from_peers(["ps"], "u")),
                  results=m.Receive(m.Reference.from_peers(["ps"], "r")),
                  optimizer=m.Adam(lr=1e-3), batch_size=2,
                  input_pipeline=None if prefetch is None else True, prefetch_slices=prefetch))
             for m in (jmsg, tmsg)]
    for j, t in zip(*pairs):
        assert tmsg.encode(t) == jmsg.encode(j)
        assert tmsg.decode(jmsg.encode(j)) == t
    assert set(tmsg.to_json_dict(pairs[1][0])) == (
        {"_t", "dataset", "peer_id"} | ({"prefetch"} if prefetch else set()))
    assert set(tmsg.to_json_dict(pairs[1][1])) == (
        {"_t", "data_provider", "index"} | ({"epoch"} if prefetch else set()))


PKGS = {"jax": dict(m=jmsg, Node=JNode, Tcp=JTcp, Gateway=JGateway, DataNode=JDataNode,
                    DS=JDataScheduler, Connector=JConnector, Cache=JSliceCache, metrics=JMETRICS),
        "port": dict(m=tmsg, Node=TNode, Tcp=TTcp, Gateway=TGateway, DataNode=TDataNode,
                     DS=TDataScheduler, Connector=TConnector, Cache=TSliceCache,
                     metrics=TMETRICS)}


async def _pull_through(root: Path, sched_pkg: str, worker_pkg: str, data_dir: Path, n: int):
    """A ``worker_pkg`` connector with a slice cache fetches ``n`` slices
    of a 3-slice dataset with a prefetch window of 2 from a ``sched_pkg``
    scheduler and data node (a legacy fetch first), over loopback TCP."""
    S, W = PKGS[sched_pkg], PKGS[worker_pkg]
    listen = ["127.0.0.1:0"]
    gw = S["Gateway"](S["Tcp"](), peer_id="gw")
    await gw.start(listen)
    boot = [gw.node.listen_addrs[0]]
    sched = S["Node"](S["Tcp"](), peer_id="sched", bootstrap=boot)
    data = S["DataNode"](S["Tcp"](), {"toy": data_dir}, peer_id="data", bootstrap=boot)
    worker = W["Node"](W["Tcp"](), peer_id="w0", bootstrap=boot)
    started = []
    try:
        for part in (sched, data, worker):
            await part.start(listen)
            started.append(part)
        await worker.wait_for_bootstrap(10)
        await sched.wait_for_bootstrap(10)
        ds = S["DS"](sched, "data", "toy", 3)
        ds.start()
        m = W["m"]
        cache = W["Cache"](root / f"cache-{worker_pkg}", max_bytes=1 << 20)
        conn = W["Connector"](worker, "sched", slice_cache=cache)
        before = W["metrics"].snapshot()
        legacy = await conn.fetch(m.Fetch(m.Reference.from_scheduler("sched", "toy")),
                                  root / "legacy")
        ref = m.Fetch(m.Reference.from_scheduler("sched", "toy", prefetch=2))
        got = [(await conn.fetch(ref, root / "jobdir"))[0] for _ in range(n)]
        after = W["metrics"].snapshot()
        held = ds.held_of("w0")
        ds.stop()
        return legacy[0], got, held, {k: after[k] - before[k] for k in
                                      ("cache_hits", "cache_misses", "bytes_pulled")}, cache
    finally:
        for part in reversed(started):
            await part.stop()
        await gw.stop()


@pytest.mark.parametrize("sched_pkg,worker_pkg", [("jax", "port"), ("port", "jax")],
                         ids=["port-worker-jax-scheduler", "jax-worker-port-scheduler"])
def test_pipelined_pulls_cross_the_packages(tmp_path, sched_pkg, worker_pkg):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    blobs = [bytes([i]) * (3000 + 1000 * i) for i in range(3)]
    for i, b in enumerate(blobs):
        (data_dir / f"slice_{i}.bin").write_bytes(b)
    legacy, got, held, counts, cache = asyncio.run(asyncio.wait_for(
        _pull_through(tmp_path, sched_pkg, worker_pkg, data_dir, 7), 60))
    # The legacy answer has no epoch: its file carries none in its name.
    assert "-e" not in legacy.name and legacy.read_bytes() == blobs[0]
    # The window holds 2: the legacy slice 0 retires with the first
    # windowed request (hold-one), then 1, 2 are served, the epoch wraps.
    names = [p.name.split("-", 1)[1] for p in got]
    assert names == ["e0-000001", "e0-000002", "e1-000000", "e1-000001", "e1-000002",
                     "e2-000000", "e2-000001"]
    assert [p.read_bytes() for p in got] == [blobs[int(n[-1])] for n in names]
    assert held == [0, 1]
    # Epoch 0's slices 1 and 2 are pulled and cached; the wraps hit the
    # cache (promoted entries) except slice 0 in epoch 1, which the legacy
    # fetch pulled without caching: slice 0 crosses the wire twice.
    assert counts == {"cache_hits": 4, "cache_misses": 3,
                      "bytes_pulled": sum(len(b) for b in blobs) + len(blobs[0])}
    assert cache.entries() == 3 and cache.bytes_used() == sum(len(b) for b in blobs)


# ------------------------------------------------------------- slice cache


def _cache_files(root: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())} if root.exists() else {}


def _cache_scenario(tmp_path: Path, name: str, cls) -> list:
    """The reference test's four cache cases on one package's cache: what
    each call answered and the cache directory's files after it."""
    root = tmp_path / name
    src = tmp_path / "src.bin"
    out = []
    hits, misses, corrupt = (TMETRICS if cls is TSliceCache else JMETRICS).cache_hits, \
        (TMETRICS if cls is TSliceCache else JMETRICS).cache_misses, \
        (TMETRICS if cls is TSliceCache else JMETRICS).cache_corrupt
    h0, m0, c0 = hits.value(), misses.value(), corrupt.value()
    cache = cls(root / "rt", max_bytes=1 << 20)  # round trip
    src.write_bytes(b"slice-bytes" * 100)
    dest = root / "out.bin"
    out.append(cache.get("toy", 0, 1, dest))
    cache.put("toy", 0, 1, src)
    out += [cache.get("toy", 0, 1, dest), dest.read_bytes() == src.read_bytes(),
            _cache_files(root / "rt")]
    out.append(cache.get("toy", 1, 1, dest))  # an epoch wrap promotes the entry
    out += [cache.entries(), _cache_files(root / "rt"), cache.get("toy", 1, 2, dest)]
    lru = cls(root / "lru", max_bytes=2500)  # LRU eviction
    for i in range(4):
        (tmp_path / f"s{i}.bin").write_bytes(bytes([i]) * 1000)
        lru.put("toy", 0, i, tmp_path / f"s{i}.bin")
        time.sleep(0.02)
    out += [lru.entries(), _cache_files(root / "lru"), lru.get("toy", 0, 0, dest),
            lru.get("toy", 0, 3, dest)]
    bad = cls(root / "bad", max_bytes=1 << 20)  # a corrupt entry is a miss
    src.write_bytes(b"good-bytes" * 50)
    bad.put("toy", 0, 7, src)
    entry = next((root / "bad").glob("*.slice"))
    data = bytearray(entry.read_bytes())
    data[3] ^= 0xFF
    entry.write_bytes(bytes(data))
    dest.unlink(missing_ok=True)
    out += [bad.get("toy", 0, 7, dest), dest.exists(), bad.entries()]
    out.append((hits.value() - h0, misses.value() - m0, corrupt.value() - c0))
    return out


def test_slice_cache_entries_equal_the_references(tmp_path):
    port = _cache_scenario(tmp_path, "port", TSliceCache)
    ref = _cache_scenario(tmp_path, "jax", JSliceCache)
    assert port == ref
    (miss, hit, same, files, promoted, entries, files2, other, n_lru, _, evicted, kept,
     corrupt_hit, dest_left, bad_entries, counts) = port
    assert (miss, hit, same, promoted, entries, other) == (False, True, True, True, 1, False)
    assert sorted(Path(n).suffix for n in files) == [".sha256", ".slice"]
    assert all("-e1-" in n for n in files2)
    assert (n_lru, evicted, kept) == (2, False, True)
    assert (corrupt_hit, dest_left, bad_entries) == (False, False, 0)
    assert counts == (3, 4, 1)


# ------------------------------------------------------ the trainer's loop

SEQ, VOCAB, LR = 16, 256, 3e-3
TRAIN_SIZES = (5, 3, 7, 2)


class _Session:
    """A scheduler and a parameter server behind the bridge-client API,
    answering in ``msgs``' types; each fetch writes the next slice anew
    (the pipeline deletes the slices it read). Updates are 0.7 x Δθ."""

    def __init__(self, work_dir: Path, msgs, weights: "Path | None", rounds=3, per_round=3):
        self.dir, self.m, self.weights = Path(work_dir), msgs, weights
        self.rounds, self.per_round = rounds, per_round
        self.done = self.batches = self.fetches = 0
        self.scheduled = False
        self.events: "queue.Queue[dict]" = queue.Queue()
        self.lock = threading.Lock()
        rng = np.random.default_rng(42)
        self.slices = [((rng.integers(0, VOCAB, (n, 1)) + np.arange(SEQ)) % VOCAB)
                       .astype(np.int32) for n in TRAIN_SIZES]
        (self.dir / "artifacts").mkdir(parents=True, exist_ok=True)
        (self.dir / "incoming").mkdir(exist_ok=True)

    def fetch(self, ref):
        if self.weights is not None and ref.ref.uri == "file:///weights":
            return [str(self.weights.relative_to(self.dir))]
        with self.lock:
            i = self.fetches
            self.fetches += 1
        path = self.dir / "artifacts" / f"slice{i}.safetensors"
        save_file({"input_ids": self.slices[i % len(self.slices)]}, str(path))
        return [f"artifacts/{path.name}"]

    def send_status(self, progress):
        K, R, RK = self.m.ProgressKind, self.m.ProgressResponse, self.m.ProgressResponseKind
        with self.lock:
            if progress.kind == K.STATUS:
                if self.done >= self.rounds:
                    return R(kind=RK.DONE)
                self.batches += 1
                if not self.scheduled and self.batches >= self.per_round:
                    self.scheduled = True
                    return R(kind=RK.SCHEDULE_UPDATE, counter=0)
                return R(kind=RK.CONTINUE)
            if progress.kind == K.UPDATE_RECEIVED:
                self.done += 1
                self.batches, self.scheduled = 0, False
                return R(kind=RK.DONE if self.done >= self.rounds else RK.CONTINUE)
            return R(kind=RK.OK)

    def send_resource(self, send, path, resource="updates", meta=None):
        from hypha_tpu import compress as jcomp

        meta = dict(meta or {})
        delta = jcomp.read_delta(self.dir / path)
        update = {k: (np.float32(0.7) * np.asarray(v, np.float32)) for k, v in delta.items()}
        with self.lock:
            out = self.dir / "incoming" / f"update-{meta.get('round')}.safetensors"
            save_file(update, str(out))
            self.events.put({"path": f"incoming/{out.name}",
                             "meta": {k: meta[k] for k in ("round", "fragment_id", "fragments")
                                      if k in meta}})

    @contextmanager
    def receive(self, ref):
        def gen():
            while True:
                try:
                    yield self.events.get(timeout=30)
                except queue.Empty:
                    return

        yield gen()


def _spec(m, weights: bool, **overrides):
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny", "seed": 3,
             "config": {"dtype": "float32", "num_layers": 2}}
    if weights:
        model["source"] = m.to_json_dict(m.Fetch(m.Reference.from_uri("file:///weights")))
    cfg = m.TrainExecutorConfig(
        model=model, data=m.Fetch(m.Reference.from_uri("file:///slices")),
        updates=m.Send(m.Reference.from_peers(["ps"], "updates")),
        results=m.Receive(m.Reference.from_peers(["ps"], "results")),
        optimizer=m.Adam(lr=LR, weight_decay=0.01), batch_size=2, **overrides)
    return m.JobSpec(job_id="job", executor=m.Executor("train", "diloco-transformer", train=cfg))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    _, variables, _ = tiny_pair("llama", seed=7, num_layers=2)
    path = tmp_path_factory.mktemp("theta0") / "theta0.safetensors"
    save_file(flatten_tree(variables), str(path))
    return path


def _train(pkg: str, work: Path, weights: "Path | None", **over):
    work.mkdir()
    wpath = None
    if weights is not None:
        wpath = work / weights.name
        wpath.write_bytes(weights.read_bytes())
    msgs = jmsg if pkg == "jax" else tmsg
    session = _Session(work, msgs, wpath)
    spec = _spec(msgs, weights is not None, **over)
    if pkg == "jax":
        from hypha_tpu.executor.training import run_training

        result = run_training(session, work, spec, max_batches=64)
    else:
        from hypha_tpu_torch.executor.training import run_training

        result = run_training(session, work, spec, max_batches=64, device="cpu")
    assert not list((work / "incoming").iterdir()), "every broadcast was merged and removed"
    return result, session


@pytest.mark.parametrize("mode", ["blocking", "stream"])
def test_pipelined_losses_equal_the_synchronous_ones(tmp_path, monkeypatch, mode):
    """Pipeline on (prefetch, whole-slice batches, deferred loss reads):
    the synchronous loop's loss sequence, float for float, and its rounds;
    stream mode with the flights' zero-drift wait, so each flight's steps
    keep the synchronous read."""
    over = {"sync_mode": "stream", "fragments": 2} if mode == "stream" else {}
    if mode == "stream":
        monkeypatch.setenv("HYPHA_STREAM_POLL_WAIT", "60")
    base, bs = _train("port", tmp_path / "sync", None, **over)
    TMETRICS.reset()
    piped, ps = _train("port", tmp_path / "pipe", None, input_pipeline=True,
                       prefetch_slices=2, **over)
    snap = TMETRICS.snapshot()
    assert (piped.rounds, piped.batches) == (base.rounds, base.batches) == (3, 9)
    assert piped.losses == base.losses
    assert snap["slices_fetched"] >= 2 and snap["input_waits"] > 0 and snap["boundary_waits"] > 0
    # Each slice file read by the pipeline was deleted.
    left = list((tmp_path / "pipe" / "artifacts").iterdir())
    assert len(left) <= ps.fetches - snap["boundary_waits"] + 1


def test_pipelined_trainer_matches_the_jax_trainer(tmp_path, weights):
    """Both packages' trainers with the pipeline on, from the same θ₀: the
    same batches, so losses within 1e-4, the same rounds and fetches."""
    jres, js = _train("jax", tmp_path / "jax", weights, input_pipeline=True, prefetch_slices=2)
    pres, ps = _train("port", tmp_path / "port", weights, input_pipeline=True, prefetch_slices=2)
    assert (pres.rounds, pres.batches) == (jres.rounds, jres.batches) == (3, 9)
    np.testing.assert_allclose(pres.losses, jres.losses, atol=1e-4, rtol=0)


def test_trainer_logs_its_data_metrics(tmp_path, caplog):
    TMETRICS.reset()
    with caplog.at_level(logging.INFO, logger="hypha.torch.executor.training"):
        _train("port", tmp_path / "log", None, input_pipeline=True)
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("data metrics: ")]
    assert len(lines) == 1
    snap = json.loads(lines[0][len("data metrics: "):])
    assert snap == TMETRICS.snapshot() and snap["input_waits"] > 0


# ------------------------------------------------------ the bridge client


class _StatusNode:
    def __init__(self) -> None:
        self.calls = 0

    async def request(self, peer, protocol, msg, timeout=30.0):
        self.calls += 1
        return tmsg.ProgressResponse(kind=tmsg.ProgressResponseKind.CONTINUE)


class _HeldConnector:
    """A fetch that blocks until the test releases it."""

    def __init__(self, path: Path) -> None:
        self.path = path
        self.entered = threading.Event()
        self.release = threading.Event()

    async def fetch(self, fetch, dest):
        self.entered.set()
        await asyncio.to_thread(self.release.wait, 30)
        return [self.path]


def test_status_answers_while_another_threads_fetch_is_held_open(tmp_path):
    loop = asyncio.new_event_loop()
    runner = threading.Thread(target=loop.run_forever, daemon=True)
    runner.start()
    (tmp_path / "artifacts").mkdir()
    held = tmp_path / "artifacts" / "slice.bin"
    held.write_bytes(b"s")
    node, conn = _StatusNode(), _HeldConnector(held)
    bridge = TBridge(node, tmp_path, "job", "sched", conn)
    sock = asyncio.run_coroutine_threadsafe(bridge.start(), loop).result(10)
    try:
        with TSession(str(sock)) as session:
            got: dict = {}
            fetcher = threading.Thread(target=lambda: got.setdefault("paths", session.fetch(
                tmsg.Fetch(tmsg.Reference.from_scheduler("sched", "d", prefetch=2)))))
            fetcher.start()
            assert conn.entered.wait(10)
            t0 = time.monotonic()
            for _ in range(3):
                resp = session.send_status(tmsg.Progress(kind=tmsg.ProgressKind.STATUS,
                                                         job_id="job", batch_size=2))
                assert resp.kind == tmsg.ProgressResponseKind.CONTINUE
            assert time.monotonic() - t0 < 5.0 and fetcher.is_alive()
            conn.release.set()
            fetcher.join(10)
            assert got["paths"] == ["artifacts/slice.bin"] and node.calls == 3
    finally:
        conn.release.set()
        asyncio.run_coroutine_threadsafe(bridge.stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        runner.join(10)
        loop.close()


# -------------------------------------------- the smoke's phase, rehearsed


def test_smoke_train_data_rehearsal_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ``train_data`` at a tiny size on the CPU: (a)
    the pipeline off and on through ``run_training`` (``data_local_runs``)
    and (b) the port's nodes with two trainer processes, the pipeline and
    the slice caches on, the data node killed at a slice assignment after
    round 1's first delta and restarted under its port (``run_data_job``),
    both held to the phase's own gates."""
    import tempfile

    import chip_smoke

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # two trainer processes on a shared CPU
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny", "seed": 0,
             "config": {"num_layers": 1, "remat": True}}
    runs = chip_smoke.data_local_runs(model, device="cpu", rounds=2, steps=3, batch=2, seq=16,
                                      period=64)
    assert chip_smoke.data_local_problems(runs, rounds=2, steps=3, layers=1, device="cpu") == []
    assert runs["pipelined"]["data_metrics"]["boundary_waits"] >= 3
    root = Path(tempfile.mkdtemp(prefix="hda"))  # short: the bridge sockets live below it
    try:
        run = asyncio.run(asyncio.wait_for(chip_smoke.run_data_job(
            root, model, device="cpu", rounds=3, steps=4, batch=2, seq=16, period=64), 300))
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    rep = chip_smoke.data_report(run)
    assert chip_smoke.data_problems(run, rep, rounds=3, layers=1, device="cpu") == [], rep
    assert rep["node_data_metrics"]["bytes_pulled"] > 0
    assert sum(c["entries"] for c in rep["caches"].values()) > 0
