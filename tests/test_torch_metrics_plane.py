"""Port parity: the live metrics plane (``hypha_tpu_torch/telemetry/``
``series.py``, ``slo.py``, ``metrics_plane.py``, ``top.py``,
``ft_metrics.py`` and ``telemetry.metrics_snapshot``) against
``hypha_tpu/telemetry``, mirroring ``tests/test_metrics_plane.py`` case by
case.

1. ``summarize``, ``merge_summaries``, the store's rollups and outlier,
   ``prometheus_text`` and ``to_otlp_metrics`` give the reference's output,
   equal (pure Python both ways), on seeded numpy corpora.
2. SLO parsing (errors included) and the watchdog's advisories and flight
   events over a seeded feed with an injected clock are equal.
3. The sampler's ``(counters, gauges, summaries)`` are equal after the same
   record calls on both packages' bundles.
4. ``MetricsReport`` / ``MetricsAck`` / ``MetricsQuery`` / ``MetricsPage``
   and ``SLOAdvisory`` encode to equal CBOR bytes and cross-decode; off,
   the executor configs and ``Progress`` keep their bytes.
5. ``top.render`` frames and ``--once --json`` output are equal from one
   journal; the reporter, collector, journal and ``top`` behave as the
   reference's on the port's fabric.
6. A port node reports into a JAX collector and a JAX node into the port's
   over loopback TCP; each journal holds the other's peer.
7. The trainer's quality keys on ``Progress`` match the JAX
   ``run_training``'s on a tiny Llama (``delta_norm`` and ``loss_ewma``
   within 1e-3 relative, the counts equal).
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import math
import time
import types

import numpy as np
import pytest

from hypha_tpu import codec as jcodec
from hypha_tpu import messages as jmsg
from hypha_tpu import telemetry as jtel
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.telemetry import flight as jflight
from hypha_tpu.telemetry import ft_metrics as jftm
from hypha_tpu.telemetry import metrics_plane as jplane
from hypha_tpu.telemetry import series as jseries
from hypha_tpu.telemetry import slo as jslo
from hypha_tpu.telemetry import top as jtop
from hypha_tpu_torch import codec as tcodec
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch import telemetry as ttel
from hypha_tpu_torch.network import MemoryTransport, Node, RequestError, TcpTransport
from hypha_tpu_torch.telemetry import flight as tflight
from hypha_tpu_torch.telemetry import ft_metrics as tftm
from hypha_tpu_torch.telemetry import metrics_plane as tplane
from hypha_tpu_torch.telemetry import series as tseries
from hypha_tpu_torch.telemetry import slo as tslo
from hypha_tpu_torch.telemetry import top as ttop

PKG = {
    "jax": types.SimpleNamespace(series=jseries, slo=jslo, plane=jplane, top=jtop, ftm=jftm,
                                 flight=jflight, msg=jmsg, tel=jtel),
    "port": types.SimpleNamespace(series=tseries, slo=tslo, plane=tplane, top=ttop, ftm=tftm,
                                  flight=tflight, msg=tmsg, tel=ttel),
}
BUNDLES = ("FT_METRICS", "STREAM_METRICS", "SHARD_METRICS", "SERVE_METRICS", "HET_METRICS",
           "SCALE_METRICS", "DATA_METRICS")


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


@pytest.fixture(autouse=True)
def _fresh_bundles():
    """The samplers read the process-global bundles: fresh ones per test,
    in both packages."""
    for pkg in PKG.values():
        for name in BUNDLES:
            getattr(pkg.ftm, name).reset()
    yield
    for pkg in PKG.values():
        for name in BUNDLES:
            getattr(pkg.ftm, name).reset()


# -- series: summaries, the quantile merge, the store, the exporters ----------


def _corpus(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [
        [float(x) for x in rng.lognormal(0.0, 1.0, 2000)],
        [float(x) for x in rng.uniform(5.0, 10.0, 1500)],
        [float(x) for x in rng.normal(20.0, 1.0, 500).clip(min=0.1)],
        [float(x) for x in rng.integers(1, 50, 7)],
        [3.0],
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summarize_equals_the_reference(seed):
    for values in _corpus(seed) + [[]]:
        assert tseries.summarize(values) == jseries.summarize(values)
    s = tseries.summarize([5.0, 1.0, 3.0, 2.0, 4.0])
    assert (s["count"], s["sum"], s["min"], s["max"], s["p50"]) == (5, 15.0, 1.0, 5.0, 3.0)


@pytest.mark.parametrize("case", ["single", "identical", "mixed", "empty", "with-empty"])
def test_merge_summaries_equals_the_reference(case):
    rng = np.random.default_rng(7)
    corpus = _corpus(11)
    peers = {
        "single": [corpus[0]],
        "identical": [[float(x) for x in rng.lognormal(0.0, 1.0, 2000)] for _ in range(4)],
        "mixed": corpus[:3],
        "empty": [],
        "with-empty": [[1.0, 2.0, 3.0], []],
    }[case]
    summaries = [tseries.summarize(p) for p in peers]
    if case == "with-empty":
        summaries[-1] = {"count": 0}
    merged = tseries.merge_summaries(summaries)
    assert merged == jseries.merge_summaries(summaries)
    if case == "identical":
        # The documented bound: <= 5% at p50/p95, <= 10% at p99.
        pooled = np.concatenate([np.asarray(p) for p in peers])
        for q, bound in ((50, 0.05), (95, 0.05), (99, 0.10)):
            true = float(np.percentile(pooled, q))
            assert abs(merged[f"p{q}"] - true) / true < bound
    if case == "single":
        for k in ("p50", "p95", "p99", "min", "max"):
            assert merged[k] == pytest.approx(summaries[0][k], rel=1e-9)


def _feed_store(store, seed: int) -> None:
    """A seeded mix of every record call, on fixed wall times."""
    rng = np.random.default_rng(seed)
    peers = ["w0", "w1", "w2", "psw"]
    for i in range(60):
        t = 1000.0 + i * 0.5
        p = peers[int(rng.integers(0, len(peers)))]
        kind = int(rng.integers(0, 5))
        if kind == 0:
            store.record_gauge(p, "node.bandwidth_out_mbps", float(rng.lognormal(2, 1)), t)
        elif kind == 1:
            store.record_delta(p, "hypha.ft.rejoins", float(rng.integers(0, 3)),
                               float(rng.uniform(0.5, 2.0)), t)
        elif kind == 2:
            store.record_summary(p, "hypha.serve.request_latency_ms",
                                 tseries.summarize(rng.lognormal(3, 1, 40).tolist()), t)
        elif kind == 3:
            store.record_quality(p, "loss", i // 10, float(rng.uniform(2, 4)))
        else:
            store.note_round(i // 10, t)
            store.note_peer(p, t)


def _rollups(store) -> dict:
    metrics = ("node.bandwidth_out_mbps", "hypha.ft.rejoins")
    return {
        "snapshot": store.snapshot(), "peers": store.peers(), "metrics": store.metrics(),
        "metrics_w0": store.metrics("w0"),
        "fleet": {m: (store.fleet_last(m), store.fleet_sum(m), store.fleet_max(m),
                      store.fleet_cumulative(m), store.fleet_average_rate(m),
                      store.fleet_peak(m), store.outlier(m), store.outlier(m, min_ratio=1.5))
                  for m in metrics},
        "per_peer": {p: (store.latest(p, "hypha.ft.rejoins"),
                         store.cumulative(p, "hypha.ft.rejoins"),
                         store.series(p, "node.bandwidth_out_mbps"),
                         store.average_rate(p, "hypha.ft.rejoins"),
                         store.last_seen(p), store.silent_for(p, now=1100.0))
                     for p in ("w0", "w1", "w2", "psw", "ghost")},
        "quantiles": store.fleet_quantiles("hypha.serve.request_latency_ms"),
        "quality": (store.quality_series("loss"), store.quality_rounds("loss")),
        "walls": store.round_walls(), "age": store.open_round_age(now=1100.0),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_rollups_and_outlier_equal_the_reference(seed):
    stores = {name: pkg.series.TimeSeriesStore(capacity=16) for name, pkg in PKG.items()}
    for store in stores.values():
        _feed_store(store, seed)
    assert _rollups(stores["port"]) == _rollups(stores["jax"])


def test_store_mirrors_the_reference_cases():
    """``tests/test_metrics_plane.py``'s store cases on the port's store."""
    store = tseries.TimeSeriesStore(capacity=8)
    for i in range(100):
        store.record_gauge("w0", "g", float(i), t=float(i))
    assert len(store.series("w0", "g")) == 8 and store.series("w0", "g")[-1][1] == 99.0
    store = tseries.TimeSeriesStore()
    for peer, v in (("w0", 100.0), ("w1", 2.0), ("w2", 110.0)):
        store.record_gauge(peer, "bw", v)
    assert store.fleet_sum("bw") == pytest.approx(212.0) and store.fleet_max("bw") == 110.0
    assert store.outlier("bw") == ("w1", 2.0)
    store = tseries.TimeSeriesStore()
    store.record_delta("w0", "bytes", 1000.0, interval_s=2.0, t=0.0)
    store.record_delta("w0", "bytes", 3000.0, interval_s=2.0, t=2.0)
    assert store.cumulative("w0", "bytes") == 4000.0 and store.latest("w0", "bytes") == 1500.0
    assert store.average_rate("w0", "bytes") == pytest.approx(2000.0)
    store.note_peer("w0", t=100.0)
    assert store.silent_for("w0", now=115.0) == pytest.approx(15.0)
    assert math.isinf(store.silent_for("ghost", now=115.0))


@pytest.mark.parametrize("seed", [0, 1])
def test_exporters_equal_the_reference(seed, monkeypatch):
    stores = {name: pkg.series.TimeSeriesStore() for name, pkg in PKG.items()}
    for store in stores.values():
        _feed_store(store, seed)
        store.record_gauge("w0", "hypha.serve.queue_depth", 3.0, 1.0)
    assert tseries.prometheus_text(stores["port"]) == jseries.prometheus_text(stores["jax"])
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_000)
    res = {"service.name": "hypha-scheduler", "round": 3}
    port = tseries.to_otlp_metrics(stores["port"], res)
    assert port == jseries.to_otlp_metrics(stores["jax"], res)
    json.dumps(port)
    text = tseries.prometheus_text(stores["port"])
    assert "# TYPE hypha_serve_queue_depth gauge" in text and 'quantile="0.5"' in text


# -- SLO rules and the watchdog ------------------------------------------------

RULES = ["hypha.serve.request_latency_ms.p99 <= 250", "round_wall_s <= 30",
         "hypha.het.quorum_drops == 0", "silent_s <= 15", "node.bandwidth_out_mbps >= 0.5 @peer",
         "queue.max < 4 @fleet", "x.sum > 2", "  lat.p50 >= 1e3 @peer  ", "no operator here",
         "metric <= notanumber", "<= 3", ".p99 <= 3", "a == 1.5"]


@pytest.mark.parametrize("text", RULES)
def test_parse_slo_rule_equals_the_reference(text):
    got = {}
    for name, pkg in PKG.items():
        try:
            rule = pkg.slo.parse_slo_rule(text)
            got[name] = ("rule", rule.name, rule.metric, rule.op, rule.threshold, rule.agg,
                         rule.scope, rule.text())
        except ValueError as e:
            got[name] = ("error", str(e))
    assert got["port"] == got["jax"]
    assert len(tslo.parse_slo_rules(["a <= 1", "  "])) == 1 and tslo.parse_slo_rules(None) == []


def _watchdog_run(pkg, seed: int) -> tuple:
    """A seeded feed into one package's store, each step followed by a
    check at an injected clock; returns the advisories (tagged wire form),
    the slo flight events and the final state."""
    rng = np.random.default_rng(seed)
    store = pkg.series.TimeSeriesStore()
    got = []
    dog = pkg.slo.SLOWatchdog(
        pkg.slo.parse_slo_rules(["queue <= 5 @peer", "silent_s <= 10", "round_wall_s <= 20",
                                 "hypha.het.quorum_drops == 0",
                                 "hypha.serve.request_latency_ms.p99 <= 300", "bw >= 1 @peer"]),
        store, job_id="j", on_advisory=got.append, round_fn=lambda: len(got))
    pkg.flight.FLIGHT.clear()
    advisories = []
    for i in range(80):
        t = 100.0 + i * 1.5
        p = f"w{int(rng.integers(0, 3))}"
        kind = int(rng.integers(0, 6))
        if kind == 0:
            store.record_gauge(p, "queue", float(rng.integers(0, 9)), t)
        elif kind == 1:
            store.record_delta(p, "hypha.het.quorum_drops", float(rng.integers(0, 2) * (i > 40)),
                               1.0, t)
        elif kind == 2:
            store.record_summary(p, "hypha.serve.request_latency_ms",
                                 pkg.series.summarize(rng.lognormal(5, 0.6, 30).tolist()), t)
        elif kind == 3:
            store.note_round(i // 9, t)
        elif kind == 4:
            store.record_gauge(p, "bw", float(rng.uniform(0, 3)), t)
        else:
            store.note_peer(p, t)
        advisories += [pkg.msg.to_json_dict(a) for a in dog.check(now=t + float(rng.uniform(0, 20)))]
    events = [(e["event"], e["attrs"]) for e in pkg.flight.FLIGHT.snapshot()
              if e["event"].startswith("slo.")]
    pkg.flight.FLIGHT.clear()
    assert [pkg.msg.to_json_dict(a) for a in got] == advisories
    return advisories, events, dog.state(), dog.breaches


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watchdog_feed_equals_the_reference(seed):
    port, jax = _watchdog_run(PKG["port"], seed), _watchdog_run(PKG["jax"], seed)
    assert port == jax
    assert port[3] > 0 and any(not a["breached"] for a in port[0])  # breaches and recoveries


def test_watchdog_mirrors_the_reference_cases():
    """Edge-triggered with recovery, silence with its flight event, counter
    equality on the cumulative total, and a hung round's age."""
    store = tseries.TimeSeriesStore()
    seen = []
    dog = tslo.SLOWatchdog(tslo.parse_slo_rules(["queue <= 5 @peer"]), store, job_id="j",
                           on_advisory=seen.append)
    store.record_gauge("w0", "queue", 3.0)
    assert dog.check() == []
    store.record_gauge("w0", "queue", 9.0)
    first = dog.check()
    assert len(first) == 1 and first[0].breached and first[0].peer == "w0"
    assert dog.check() == []
    store.record_gauge("w0", "queue", 2.0)
    assert [a.breached for a in dog.check()] == [False] and dog.breaches == 1
    assert [a.breached for a in seen] == [True, False]
    tflight.FLIGHT.clear()
    store = tseries.TimeSeriesStore()
    store.note_peer("w0", t=0.0)
    dog = tslo.SLOWatchdog(tslo.parse_slo_rules(["silent_s <= 10"]), store, job_id="j")
    assert dog.check(now=5.0) == [] and dog.check(now=50.0)[0].peer == "w0"
    events = [e for e in tflight.FLIGHT.snapshot() if e["event"] == "slo.breach"]
    assert events and events[-1]["attrs"]["peer"] == "w0"
    tflight.FLIGHT.clear()
    store = tseries.TimeSeriesStore()
    dog = tslo.SLOWatchdog(tslo.parse_slo_rules(["hypha.het.quorum_drops == 0"]), store)
    store.record_delta("sched", "hypha.het.quorum_drops", 0.0, 1.0)
    assert dog.check() == []
    store.record_delta("sched", "hypha.het.quorum_drops", 2.0, 1.0)
    assert len(dog.check()) == 1
    store.record_delta("sched", "hypha.het.quorum_drops", 0.0, 1.0)
    assert dog.check() == []
    store = tseries.TimeSeriesStore()
    dog = tslo.SLOWatchdog(tslo.parse_slo_rules(["round_wall_s <= 10"]), store)
    store.note_round(0, t=0.0)
    store.note_round(1, t=2.0)
    assert dog.check(now=5.0) == [] and dog.check(now=60.0)[0].breached
    store.note_round(2, t=61.0)
    assert dog.check(now=62.0) == []
    store.note_round(3, t=63.0)
    assert [a.breached for a in dog.check(now=64.0)] == [False]


# -- the sampler ---------------------------------------------------------------


def _record_everything(ftm) -> None:
    """The same record calls on one package's bundles."""
    ftm.FT_METRICS.rejoins.add(3)
    ftm.FT_METRICS.retry_attempts.add(np.float32(1.5))
    ftm.FT_METRICS.rejoin_latency_ms.record(120.0)
    ftm.STREAM_METRICS.flight_started(4096)
    ftm.STREAM_METRICS.flight_finished(2.0, 1.5)
    ftm.STREAM_METRICS.fragment_closed(np.int64(1))
    ftm.STREAM_METRICS.fragment_closed(0)
    ftm.SHARD_METRICS.prefold_partials.add(2)
    ftm.SERVE_METRICS.pool_state(free_blocks=7, queue_depth=2)
    for v in (10.0, 20.0, 30.0, 45.5):
        ftm.SERVE_METRICS.request_finished(v)
    ftm.SERVE_METRICS.admissions.add(4)
    ftm.HET_METRICS.note_codec("w0", "int8")
    ftm.HET_METRICS.note_codec("w1", "int4")
    ftm.HET_METRICS.note_bandwidth("w0", 1e6)
    ftm.HET_METRICS.note_assigned("w1", 4)
    ftm.HET_METRICS.note_quorum_drop(2, ["w2"])


def test_sampler_equals_the_reference():
    got = {}
    for name, pkg in PKG.items():
        _record_everything(pkg.ftm)
        node = types.SimpleNamespace(bytes_in=100, bytes_out=5000)
        sampler = pkg.plane.RegistrySampler(node)
        first = sampler.sample()
        node.bytes_out = 9000
        pkg.ftm.FT_METRICS.rejoins.add(2)
        pkg.ftm.SERVE_METRICS.request_finished(500.0)
        second = sampler.sample()
        third = sampler.sample()
        got[name] = (first, second, third)
    assert got["port"] == got["jax"]
    first, second, third = got["port"]
    assert first[0]["hypha.ft.rejoins"] == 3.0 and second[0]["hypha.ft.rejoins"] == 2.0
    assert "hypha.ft.rejoins" not in third[0] and third[0]["node.bytes_out"] == 0.0
    assert first[1]["hypha.het.bandwidth_bps.w0"] == 1e6 and first[1]["hypha.serve.free_blocks"] == 7
    assert first[2]["hypha.serve.request_latency_ms"]["count"] == 4 and not third[2]


def test_sampler_reships_summary_after_reservoir_trims():
    sampler = tplane.RegistrySampler()
    for v in (10.0, 20.0, 30.0):
        tftm.SERVE_METRICS.request_finished(v)
    assert sampler.sample()[2]
    tftm.SERVE_METRICS.request_finished(500.0)
    tftm.SERVE_METRICS.request_finished(600.0)
    with tftm.SERVE_METRICS._lock:
        del tftm.SERVE_METRICS._latencies[:2]
    assert sampler.sample()[2]["hypha.serve.request_latency_ms"]["max"] == 600.0


def test_metrics_snapshot_is_json_safe_and_shaped_as_the_reference():
    """After numpy scalars in every instrument of both packages' bundles,
    ``metrics_snapshot`` serializes, its leaves are plain scalars, and its
    bundles' keys are the reference's."""
    from hypha_tpu_torch.telemetry import Counter, Histogram

    def feed(bundle):
        for value in vars(bundle).values():
            if isinstance(value, Counter):
                value.add(np.float32(1.5))
                value.add(np.int64(2))
            elif isinstance(value, Histogram):
                value.record(np.float32(12.5))
            elif isinstance(value, dict):
                for v in value.values():
                    if isinstance(v, Counter):
                        v.add(np.float32(1))

    for name in BUNDLES:
        feed(getattr(tftm, name))
    tftm.STREAM_METRICS.flight_started(np.float32(1024.0))
    tftm.STREAM_METRICS.flight_landed(np.float32(512.0))
    tftm.STREAM_METRICS.flight_finished(np.float64(1.5), np.float32(1.0))
    tftm.STREAM_METRICS.fragment_closed(np.int64(0))
    tftm.HET_METRICS.note_bandwidth("w0", np.float32(1e6))
    tftm.HET_METRICS.note_assigned("w0", np.int64(16))
    tftm.HET_METRICS.note_quorum_drop(np.int64(3), ["w1"])
    tftm.SERVE_METRICS.pool_state(np.int64(10), np.float32(2))
    tftm.SERVE_METRICS.cache_state(np.float32(5), np.int32(1))
    tftm.SERVE_METRICS.request_finished(np.float32(25.0))
    tftm.DATA_METRICS.note_queue_depth(np.int64(2))
    snap = ttel.metrics_snapshot()
    json.dumps(snap)

    def leaves(obj):
        if isinstance(obj, dict):
            for v in obj.values():
                yield from leaves(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                yield from leaves(v)
        else:
            yield obj

    assert all(x is None or type(x) in (int, float, str, bool) for x in leaves(snap))
    ref = jtel.metrics_snapshot()
    assert sorted(snap) == sorted(ref)
    for key in ("ft", "stream", "shard", "serve", "het", "scale", "data"):
        assert sorted(snap[key]) == sorted(ref[key]), key


# -- wire ------------------------------------------------------------------------


def _plane_messages(pkg) -> list:
    p, s = pkg.plane, pkg.slo
    return [
        p.MetricsReport(job_id="j-w0", peer="w0", round=2, seq=5, interval_s=0.5,
                        counters={"a": 1.0, "node.bytes_out": 0.0}, gauges={"b": 2.0},
                        summaries={"c": {"count": 1.0, "p50": 3.0}}),
        p.MetricsReport(job_id="j", peer="psw", generation=3),
        p.MetricsAck(), p.MetricsAck(ok=False), p.MetricsQuery(), p.MetricsQuery(job_id="j"),
        p.MetricsPage(job_id="j", round=4, snapshot={"gauges": {"w0": {"x": 1.0}},
                                                     "slo": {"breaches": 1}}),
        s.SLOAdvisory(job_id="j", rule="silent_s <= 3", metric="silent_s", peer="w1",
                      value=4.5, threshold=3.0, round=2, breached=True),
    ]


def test_plane_messages_are_the_reference_bytes():
    for tm, jm in zip(_plane_messages(PKG["port"]), _plane_messages(PKG["jax"])):
        tb, jb = tmsg.encode(tm), jmsg.encode(jm)
        assert tb == jb, type(tm).__name__
        assert tmsg.decode(jb) == tm and jmsg.decode(tb) == jm
    assert "generation" not in tmsg.to_json_dict(_plane_messages(PKG["port"])[0])
    assert tplane.PROTOCOL_METRICS == jplane.PROTOCOL_METRICS
    assert tmsg.PROTOCOL_MESSAGES[tplane.PROTOCOL_METRICS] == \
        jmsg.PROTOCOL_MESSAGES[jplane.PROTOCOL_METRICS]
    assert "SLOAdvisory" in tmsg.VALUE_VOCABULARY


def test_executor_configs_off_omit_report_fields():
    m = tmsg
    train = m.TrainExecutorConfig(
        model={"x": 1}, data=m.Fetch(m.Reference.from_uri("file:///d")),
        updates=m.Send(m.Reference.from_peers(["ps"], "updates")),
        results=m.Receive(m.Reference.from_peers(["ps"], "results")),
        optimizer=m.Adam(), batch_size=4)
    agg = m.AggregateExecutorConfig(
        updates=m.Receive(m.Reference.from_peers(["w0"], "updates")),
        results=m.Send(m.Reference.from_peers(["w0"], "results")), optimizer=m.Nesterov())
    infer = m.InferExecutorConfig(model={"x": 1}, serve_name="svc")
    for cfg in (train, agg, infer):
        plain = m.to_json_dict(cfg)
        assert "report_metrics_s" not in plain and "metrics_peer" not in plain
        assert m.decode(m.encode(cfg)) == cfg


@pytest.mark.parametrize("kind", ["progress", "response"])
def test_off_wire_bytes_unchanged_by_the_metrics_plane(kind):
    """The reference's off goldens (``Progress`` with no quality key,
    ``ProgressResponse``) hold for the port's messages."""
    if kind == "progress":
        msg = tmsg.Progress(kind=tmsg.ProgressKind.UPDATED, job_id="job-1", round=3)
        golden = tcodec.dumps({"_t": "Progress", "kind": {"_e": "ProgressKind", "v": "updated"},
                               "job_id": "job-1", "batch_size": 0, "round": 3, "metrics": {},
                               "shard": 0})
    else:
        msg = tmsg.ProgressResponse(kind=tmsg.ProgressResponseKind.CONTINUE)
        golden = tcodec.dumps({"_t": "ProgressResponse",
                               "kind": {"_e": "ProgressResponseKind", "v": "continue"},
                               "counter": 0, "message": ""})
    assert tmsg.encode(msg) == golden == jcodec.dumps(tcodec.loads(golden))


# -- reporter, collector, journal and top on the port's fabric -------------------


async def _two_nodes():
    hub = MemoryTransport()
    sched = Node(hub.shared(), peer_id="sched")
    worker = Node(hub.shared(), peer_id="w0")
    await sched.start()
    await worker.start()
    assert await worker.dial(sched.listen_addrs[0]) == "sched"
    sched.add_peer_addr("w0", worker.listen_addrs[0])
    return sched, worker


def _journal(d) -> list:
    return [json.loads(line) for j in sorted(d.glob("metrics-*.jsonl"))
            for line in j.read_text().splitlines()]


def test_reporter_collector_end_to_end(tmp_path):
    async def main():
        sched, worker = await _two_nodes()
        collector = tplane.MetricsCollector(sched, "job-1", journal_dir=tmp_path,
                                            slo_rules=["hypha.ft.rejoins == 0"]).start()
        reporter = tplane.MetricsReporter(worker, "sched", "job-1-w0", interval_s=0.05,
                                          round_fn=lambda: 2).start()
        tftm.FT_METRICS.rejoins.add(1)
        for _ in range(100):
            if collector.reports >= 2:
                break
            await asyncio.sleep(0.05)
        assert collector.reports >= 2
        await reporter.stop()
        collector.ingest_quality("w0", 2, {"loss": 3.25, "bogus": "skip"})
        store = collector.store
        assert "w0" in store.peers() and store.cumulative("w0", "hypha.ft.rejoins") >= 1.0
        assert store.quality_rounds("loss")[2]["w0"] == pytest.approx(3.25)
        assert collector.watchdog.breaches >= 1
        page = await worker.request("sched", tplane.PROTOCOL_METRICS,
                                    tplane.MetricsQuery(job_id="job-1"))
        assert isinstance(page, tplane.MetricsPage) and "w0" in page.snapshot["last_seen"]
        await collector.close()
        await sched.stop()
        await worker.stop()

    run(main())
    kinds = {r["type"] for r in _journal(tmp_path)}
    assert {"report", "quality", "slo"} <= kinds


def test_collector_derives_bandwidth_and_refuses_a_foreign_job():
    async def main():
        sched, worker = await _two_nodes()
        collector = tplane.MetricsCollector(sched, "base").start()
        ack = await worker.request("sched", tplane.PROTOCOL_METRICS, tplane.MetricsReport(
            job_id="base-w7", peer="w7", round=1, interval_s=2.0,
            counters={"node.bytes_out": 2_000_000.0}))
        assert ack.ok
        assert collector.store.latest("w7", "node.bandwidth_out_mbps") == pytest.approx(8.0)
        with pytest.raises(RequestError):
            await worker.request("sched", tplane.PROTOCOL_METRICS,
                                 tplane.MetricsReport(job_id="otherjob-w0", peer="x"))
        await collector.close()
        await sched.stop()
        await worker.stop()

    run(main())


def test_reporter_survives_a_dead_collector():
    async def main():
        worker = Node(MemoryTransport().shared(), peer_id="w0")
        await worker.start()
        reporter = tplane.MetricsReporter(worker, "nowhere", "job", interval_s=0.02).start()
        await asyncio.sleep(0.2)
        await reporter.stop(flush=False)
        assert reporter.dropped >= 1 and reporter.sent == 0
        await worker.stop()

    run(main())


def test_sweep_and_quality_edges_reach_the_journal(tmp_path):
    """A silence breach whose edge lands on the sweep, and a breach whose
    edge lands on a quality ingest, both reach the journal."""
    async def main():
        sched, worker = await _two_nodes()
        collector = tplane.MetricsCollector(
            sched, "job-1", journal_dir=tmp_path,
            slo_rules=["silent_s <= 0.5", "loss_breaches_nothing == 0"]).start()
        await worker.request("sched", tplane.PROTOCOL_METRICS,
                             tplane.MetricsReport(job_id="job-1-w0", peer="w0", interval_s=0.1))
        collector.store.record_delta("w0", "loss_breaches_nothing", 2.0, 1.0)
        collector.ingest_quality("w0", 1, {"loss": 3.0})
        for _ in range(60):
            if collector.watchdog.breaches >= 2:
                break
            await asyncio.sleep(0.1)
        await asyncio.sleep(0.1)
        await collector.close()
        await sched.stop()
        await worker.stop()

    run(main())
    rules = sorted(r["rule"] for r in _journal(tmp_path) if r["type"] == "slo" and r["breached"])
    assert rules == ["loss_breaches_nothing == 0", "silent_s <= 0.5 @peer"]


def _write_journal(tmp_path) -> None:
    async def main():
        sched, worker = await _two_nodes()
        collector = tplane.MetricsCollector(sched, "job-1", journal_dir=tmp_path,
                                            slo_rules=["hypha.serve.queue_depth <= 3"]).start()
        for i, (q, out) in enumerate(((4.0, 1_000_000.0), (2.0, 2_000_000.0))):
            await worker.request("sched", tplane.PROTOCOL_METRICS, tplane.MetricsReport(
                job_id="job-1-w0", peer="w0", round=1 + i, seq=i, interval_s=2.0,
                counters={"node.bytes_out": out, "hypha.ft.rejoins": 1.0},
                gauges={"hypha.serve.queue_depth": q, "hypha.serve.weight_round": -1.0},
                summaries={"hypha.serve.request_latency_ms": tseries.summarize(
                    [10.0, 20.0, 800.0 * (i + 1)])}))
        await worker.request("sched", tplane.PROTOCOL_METRICS, tplane.MetricsReport(
            job_id="job-1-psw", peer="psw", round=2, interval_s=1.0,
            gauges={"hypha.serve.free_blocks": 11.0}))
        collector.ingest_quality("w0", 1, {"loss": 3.5, "tokens_per_s": 120.0,
                                           "inner_steps": 4.0})
        collector.ingest_quality("psw", 1, {"delta_norm": 0.25})
        await asyncio.sleep(0.1)
        await collector.close()
        await sched.stop()
        await worker.stop()

    run(main())


def test_top_frames_equal_the_reference_from_one_journal(tmp_path):
    _write_journal(tmp_path)
    tsnap, jsnap = ttop.snapshot_from_dir(tmp_path), jtop.snapshot_from_dir(tmp_path)
    assert tsnap == jsnap
    now = max(tsnap["last_seen"].values()) + 2.0
    frame = ttop.render(tsnap, now=now)
    assert frame == jtop.render(jsnap, now=now)
    assert "w0" in frame and "psw" in frame and "3.5" in frame and "SLO: " in frame
    assert tsnap["gauges"]["w0"]["node.bandwidth_out_mbps"] == pytest.approx(8.0)
    assert ttop.render({}, now=now) == jtop.render({}, now=now) and "0 peers" in ttop.render({})
    outs = []
    for mod in (ttop, jtop):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main([str(tmp_path), "--once", "--json"]) == 0
        outs.append(json.loads(buf.getvalue()))
    assert outs[0] == outs[1]


def test_top_render_merges_fleet_latency():
    snap = {"gauges": {}, "quality": {}, "last_seen": {"a": 0.0, "b": 0.0},
            "summaries": {"a": {"hypha.serve.request_latency_ms": tseries.summarize([800.0] * 50)},
                          "b": {"hypha.serve.request_latency_ms": tseries.summarize([40.0] * 50)}}}
    frame = ttop.render(snap, now=1.0)
    assert frame == jtop.render(snap, now=1.0)
    assert "serve latency ms" in frame and "800" in frame


def test_top_reads_a_live_collector_over_tcp(tmp_path):
    """``telemetry.top <addr>``: a ``MetricsQuery`` over the port's fabric
    to a live port collector (and, by the same bytes, a JAX one)."""
    async def main():
        sched = Node(TcpTransport(), peer_id="sched")
        await sched.start(["127.0.0.1:0"])
        collector = tplane.MetricsCollector(sched, "job-1").start()
        collector.ingest_quality("w0", 1, {"loss": 2.5})
        collector.store.record_gauge("w1", "hypha.serve.queue_depth", 2.0)
        snap = await ttop.snapshot_from_addr(sched.listen_addrs[0])
        await collector.close()
        await sched.stop()
        return snap

    snap = run(main())
    assert sorted(snap["last_seen"]) == ["w0", "w1"] and snap["slo"]["breaches"] == 0
    assert "w0" in ttop.render(snap)


# -- mixed packages: each reports into the other's collector -------------------


def test_each_package_reports_into_the_others_collector(tmp_path):
    """A port node's reporter into a JAX collector, a JAX node's into the
    port's, over loopback TCP; each journal holds the other package's peer,
    its counters and a quality point, and the query answers across."""
    async def main():
        jnode, tnode = JNode(JTcp(), peer_id="jsched"), Node(TcpTransport(), peer_id="tsched")
        await jnode.start(["127.0.0.1:0"])
        await tnode.start(["127.0.0.1:0"])
        await tnode.dial(jnode.listen_addrs[0])
        await jnode.dial(tnode.listen_addrs[0])
        (tmp_path / "j").mkdir()
        (tmp_path / "t").mkdir()
        jcol = jplane.MetricsCollector(jnode, "job", journal_dir=tmp_path / "j").start()
        tcol = tplane.MetricsCollector(tnode, "job", journal_dir=tmp_path / "t").start()
        tftm.FT_METRICS.rejoins.add(2)
        jftm.FT_METRICS.rejoins.add(5)
        trep = tplane.MetricsReporter(tnode, "jsched", "job-w0", peer="wtorch",
                                      interval_s=0.05, round_fn=lambda: 1).start()
        jrep = jplane.MetricsReporter(jnode, "tsched", "job-w1", peer="wjax",
                                      interval_s=0.05, round_fn=lambda: 1).start()
        for _ in range(100):
            if jcol.reports >= 2 and tcol.reports >= 2:
                break
            await asyncio.sleep(0.05)
        await trep.stop()
        await jrep.stop()
        jcol.ingest_quality("wtorch", 1, {"loss": 1.5})
        tcol.ingest_quality("wjax", 1, {"loss": 2.5})
        jpage = await tnode.request("jsched", tplane.PROTOCOL_METRICS, tplane.MetricsQuery())
        tpage = await jnode.request("tsched", jplane.PROTOCOL_METRICS, jplane.MetricsQuery())
        cum = (jcol.store.cumulative("wtorch", "hypha.ft.rejoins"),
               tcol.store.cumulative("wjax", "hypha.ft.rejoins"))
        await jcol.close()
        await tcol.close()
        await jnode.stop()
        await tnode.stop()
        return jpage, tpage, cum

    jpage, tpage, cum = run(main())
    assert cum == (2.0, 5.0)
    assert "wtorch" in jpage.snapshot["last_seen"] and "wjax" in tpage.snapshot["last_seen"]
    for d, peer in (("j", "wtorch"), ("t", "wjax")):
        recs = _journal(tmp_path / d)
        assert {r["peer"] for r in recs if r["type"] == "report"} == {peer}
        assert [r["loss"] for r in recs if r["type"] == "quality"] == [1.5 if d == "j" else 2.5]


# -- the trainer's quality keys -------------------------------------------------


@pytest.fixture
def weights(tmp_path):
    from _torch_parity import tiny_pair
    from hypha_tpu.executor.serialization import flatten_tree
    from safetensors.numpy import save_file

    _, variables, _ = tiny_pair("llama", seed=7)
    path = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(path))
    return path


def test_trainer_quality_keys_match_the_reference(tmp_path, weights):
    """``report_metrics_s``: each round's METRICS carries the reference's
    quality keys. ``inner_steps`` and ``samples`` equal the JAX trainer's;
    ``loss``, ``loss_ewma`` and ``delta_norm`` within 1e-3 relative (f32 on
    the host both ways, summed in another order); ``tokens_per_s`` is a
    positive rate. Off, METRICS carries loss and samples only."""
    from test_torch_training import _port_spec, _Session, _spec

    from hypha_tpu.executor.training import run_training as jax_run
    from hypha_tpu_torch.executor.training import run_training as port_run

    class Recording(_Session):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.metrics = []

        def send_status(self, progress):
            if progress.kind == self.m.ProgressKind.METRICS:
                self.metrics.append((progress.round, dict(progress.metrics)))
            return super().send_status(progress)

    got = {}
    for on in (True, False):
        spec = _spec(report_metrics_s=0.5) if on else _spec()
        js = Recording(tmp_path, jmsg, weights)
        jax_run(js, tmp_path, spec)
        ps = Recording(tmp_path, tmsg, weights)
        port_run(ps, tmp_path, _port_spec(spec), device="cpu")
        got[on] = (js.metrics, ps.metrics)
    jm, pm = got[True]
    assert [r for r, _ in pm] == [r for r, _ in jm] == [0, 1]
    for (_, j), (_, p) in zip(jm, pm):
        assert sorted(p) == sorted(j) == ["delta_norm", "inner_steps", "loss", "loss_ewma",
                                          "samples", "tokens_per_s"]
        assert (p["inner_steps"], p["samples"]) == (j["inner_steps"], j["samples"]) == (3.0, 6.0)
        for key in ("loss", "loss_ewma", "delta_norm"):
            assert p[key] == pytest.approx(j[key], rel=1e-3), key
        assert p["tokens_per_s"] > 0
    # The EWMA carries round 0 into round 1 as the reference's (beta 0.7).
    assert pm[1][1]["loss_ewma"] == pytest.approx(0.7 * pm[0][1]["loss"] + 0.3 * pm[1][1]["loss"])
    joff, poff = got[False]
    assert [sorted(m) for _, m in poff] == [sorted(m) for _, m in joff] == [["loss", "samples"]] * 2


# -- a mixed job with the plane on ----------------------------------------------


@pytest.mark.parametrize("scheduler", ["jax", "port"])
def test_mixed_job_reports_every_peer_into_either_collector(tmp_path, scheduler):
    """A JAX and a torch worker in one metrics-plane job: under the JAX
    scheduler (a torch server), the torch worker and server report into the
    JAX collector; under the port's (a JAX server), the JAX worker and
    server report into the port's. Each journal holds every peer's reports,
    each worker's round quality (equal to its METRICS) and the server's."""
    import shutil
    import tempfile
    from pathlib import Path

    from safetensors.numpy import save_file
    from test_torch_worker_node import LISTEN, ROUNDS, _dataset, _mixed_job

    from _torch_parity import tiny_pair
    from hypha_tpu.data_node import DataNode as JDataNode
    from hypha_tpu.executor.serialization import flatten_tree
    from hypha_tpu.gateway import Gateway as JGateway
    from hypha_tpu.resources import Resources as JResources
    from hypha_tpu.scheduler.orchestrator import Orchestrator as JOrchestrator
    from hypha_tpu.worker.arbiter import OfferConfig as JOfferConfig
    from hypha_tpu.worker.runtime import WorkerNode as JWorkerNode
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.runtime import WorkerNode

    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data_dir = _dataset(tmp_path)
    journal = tmp_path / "journal"
    jjob = _mixed_job(weights, metrics_plane=True, metrics_interval_s=0.25,
                      metrics_dir=str(journal), slo_rules=["hypha.het.quorum_drops == 0"])
    port = scheduler == "port"
    root = Path(tempfile.mkdtemp(prefix="wm"))  # bridge sockets: paths under 108 bytes

    async def main():
        Tcp, GW, DN, Sched = (TcpTransport, Gateway, DataNode, Node) if port else \
            (JTcp, JGateway, JDataNode, JNode)
        gw = GW(Tcp(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        ps = (JWorkerNode(JTcp(), resources=JResources(cpu=2, memory=200), peer_id="psw",
                          bootstrap=boot, work_root=root / "p") if port else
              WorkerNode(TcpTransport(), resources=Resources(cpu=2, memory=200), device="cpu",
                         peer_id="psw", bootstrap=boot, work_root=root / "p"))
        parts = [DN(Tcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot),
                 JWorkerNode(JTcp(), resources=JResources(gpu=2, cpu=8, memory=1000),
                             peer_id="wjax", offer=JOfferConfig(strategy="whole"),
                             bootstrap=boot, work_root=root / "j"),
                 WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root / "t"),
                 ps]
        sched = Sched(Tcp(), peer_id="sched", bootstrap=boot)
        started = []
        try:
            for part in (*parts, sched):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            if port:
                orch = Orchestrator(sched)
                result = await orch.run(tmsg.decode(jmsg.encode(jjob)), auction_timeout=1.5)
            else:
                orch = JOrchestrator(sched)
                result = await orch.run(jjob, auction_timeout=1.5)
            # The servers' and workers' last reports land after the job.
            await asyncio.sleep(0.5)
            return result, orch.metrics
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    try:
        result, collector = asyncio.run(asyncio.wait_for(main(), 150))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == ROUNDS
    assert type(collector).__module__.startswith("hypha_tpu_torch" if port else "hypha_tpu.")
    recs = _journal(journal)
    reported = {r["peer"] for r in recs if r["type"] == "report"}
    assert reported == {"wjax", "wtorch", "psw"}, reported
    quality = {(r["peer"], r["round"]): r for r in recs if r["type"] == "quality"}
    for peer, rnd, metrics in result.metrics:
        rec = quality[(peer, rnd)]
        assert {k: rec[k] for k in metrics} == {k: float(v) for k, v in metrics.items()}
    assert {(p, r) for p, r, _ in result.metrics} == \
        {(w, r) for w in ("wjax", "wtorch") for r in range(ROUNDS)}
    ps_quality = [quality[("psw", r)] for r in range(ROUNDS)]
    assert all(q["accepted"] == 2.0 and q["delta_norm"] > 0 and q["update_norm"] > 0
               for q in ps_quality), ps_quality
    assert not [r for r in recs if r["type"] == "slo"]


# -- the parameter server's round quality on UPDATED ----------------------------


@pytest.mark.parametrize("report", [True, False], ids=["reporting", "off"])
def test_server_quality_on_updated_matches_the_reference(tmp_path, monkeypatch, report):
    """Both servers fed the same deltas (``test_torch_ps_executor._serve``):
    with ``report_metrics_s`` each UPDATED carries ``metrics["quality"]``
    with the reference's keys, ``accepted`` equal and the norms of ḡ and of
    the update within 1e-5 relative (f64 sums on the port's device, numpy's
    f32 ``vdot`` in the reference's); off, no UPDATED carries the key."""
    from test_torch_ps_executor import PKG as PS_PKG
    from test_torch_ps_executor import ROUNDS as PS_ROUNDS
    from test_torch_ps_executor import _deltas, _serve

    from hypha_tpu import native

    monkeypatch.setattr(native, "_load", lambda: None)
    files = _deltas(tmp_path)
    seen = {}
    for pkg in PS_PKG:
        (tmp_path / pkg).mkdir()
        seen[pkg] = {}
        opts = {"report_metrics_s": 30.0} if report else {}
        _, _, status = asyncio.run(asyncio.wait_for(
            _serve(pkg, tmp_path / pkg, files, False, seen=seen[pkg], **opts), 60))
        assert status.state == "completed"
    for r in range(PS_ROUNDS):
        jq, tq = seen["jax"][r].get("quality"), seen["port"][r].get("quality")
        if not report:
            assert jq is None and tq is None and seen["port"][r] == seen["jax"][r] == {}
            continue
        assert sorted(tq) == sorted(jq) == ["accepted", "delta_norm", "update_norm"]
        assert tq["accepted"] == jq["accepted"] == 2.0
        for key in ("delta_norm", "update_norm"):
            assert tq[key] == pytest.approx(jq[key], rel=1e-5), key
