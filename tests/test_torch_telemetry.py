"""Port parity: the telemetry providers and the OTLP exporter
(``hypha_tpu_torch/telemetry/__init__.py``, ``otlp.py``,
``attributes.py``) against ``hypha_tpu/telemetry``, mirroring
``tests/test_telemetry.py``.

1. Spans, parent-based sampling, counters and histograms, the bandwidth
   gauges and the log bridge behave as the reference's.
2. ``parse_attributes`` and ``init_telemetry``'s ``OTEL_*`` overrides give
   the reference's results.
3. For the same spans (fixed ids and times), instruments, gauges and log
   records, both exporters post equal JSON to ``/v1/traces``,
   ``/v1/metrics`` and ``/v1/logs``; a loopback collector (an
   ``http.server`` in the test) receives them; a dead collector costs a
   warning, never an exception.
4. A gateway and a data node started by the port's CLI runners with
   ``telemetry.endpoint`` export their bandwidth gauges to the collector.
"""

from __future__ import annotations

import asyncio
import json
import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import hypha_tpu.telemetry as jtel
import hypha_tpu_torch.telemetry as ttel
from hypha_tpu.telemetry import otlp as jotlp
from hypha_tpu_torch.telemetry import otlp as totlp


class RecordingExporter:
    def __init__(self) -> None:
        self.spans: list = []
        self.metrics: list = []

    def export_spans(self, spans) -> None:
        self.spans.extend(spans)

    def export_metrics(self, instruments, gauges) -> None:
        self.metrics.append((dict(instruments), dict(gauges)))


def _make(mod, ratio=1.0):
    exporter = RecordingExporter()
    return mod.Telemetry(service_name="t", sample_ratio=ratio, exporter=exporter,
                         export_interval=3600), exporter


class Collector:
    """A loopback OTLP/HTTP collector: stores every POST's path and JSON."""

    def __init__(self) -> None:
        posts = self.posts = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("content-length", 0)))
                posts.append((self.path, json.loads(body)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def collector():
    c = Collector()
    yield c
    c.close()


# ------------------------------------------------------ the providers


@pytest.mark.parametrize("mod", [jtel, ttel], ids=["jax", "port"])
def test_span_nesting_and_error_status(mod):
    t, exporter = _make(mod)
    tracer = t.tracer("scope")
    with tracer.span("outer", {"k": 1}) as outer:
        with tracer.span("inner") as inner:
            assert inner.trace_id == outer.trace_id and inner.parent_id == outer.span_id
    with pytest.raises(ValueError):
        with tracer.span("boom"):
            raise ValueError("nope")
    t.flush()
    spans = {s.name: s for _scope, s in exporter.spans}
    assert spans["inner"].end_ns is not None
    assert spans["boom"].status_ok is False
    assert spans["boom"].attributes == {"error.type": "ValueError", "error.message": "nope"}
    assert spans["outer"].attributes == {"k": 1}
    t.shutdown()


def test_sampling_ratio_zero_drops_roots_and_children_follow():
    t, exporter = _make(ttel, ratio=0.0)
    tracer = t.tracer("s")
    with tracer.span("root"):
        with tracer.span("child"):
            pass
    t.flush()
    assert exporter.spans == []
    t.shutdown()


def test_counter_and_histogram_equal_the_reference():
    snaps = []
    for mod in (jtel, ttel):
        t, _ = _make(mod)
        meter = t.meter("m")
        c = meter.counter("reqs")
        c.add(2)
        c.add(3)
        with pytest.raises(ValueError):
            c.add(-1)
        assert meter.counter("reqs") is c
        h = meter.histogram("lat_ms", bounds=(10, 100))
        for v in (5, 50, 500, 10, 100.5):
            h.record(v)
        snaps.append((c.value(), h.snapshot(), mod.Histogram("x").bounds))
        t.shutdown()
    assert snaps[0] == snaps[1]
    h = ttel.Histogram("x")
    h.record(999999)
    assert h.snapshot()["bucket_counts"][-1] == 1


def test_instrument_node_bandwidth_gauges():
    class FakeNode:
        bytes_in = 123
        bytes_out = 456

    t, exporter = _make(ttel)
    meter = t.meter("hypha.node")
    ttel.instrument_node(meter, FakeNode())
    t.flush()
    _insts, gauges = exporter.metrics[-1]
    assert gauges[("hypha.node", "hypha.bandwidth.inbound.bytes")] == (123.0, "By")
    assert gauges[("hypha.node", "hypha.bandwidth.outbound.bytes")] == (456.0, "By")
    meter.remove_gauges()
    assert t._gauges == {}
    t.shutdown()


def test_a_raising_gauge_does_not_stop_the_export(caplog):
    t, exporter = _make(ttel)
    t.meter("m").observable_gauge("bad", lambda: 1 / 0)
    t.meter("m").observable_gauge("good", lambda: 2.0)
    with caplog.at_level(logging.WARNING, "hypha.telemetry"):
        t.flush()
    assert exporter.metrics[-1][1] == {("m", "good"): (2.0, "")}
    assert "observable gauge" in caplog.text
    t.shutdown()


def test_the_global_provider_is_one_recording_bundle():
    g = ttel.global_telemetry()
    assert g is ttel.global_telemetry() and g.exporter is None


def test_rand_id_is_not_seeded_by_the_global_rng():
    import random

    random.seed(42)
    first = ttel._rand_id(16)
    random.seed(42)
    assert ttel._rand_id(16) != first and len(first) == 32
    int(first, 16)


# --------------------------------------------------------------- config


@pytest.mark.parametrize("raw", ["service.name=x, env=prod", "", None, "a=1,,b = 2 ",
                                 "k=v=w", "novalue", "=v", "a=1,bad"])
def test_parse_attributes_equals_the_reference(raw):
    def run(fn):
        try:
            return fn(raw)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(ttel.parse_attributes) == run(jtel.parse_attributes)


OTEL_CASES = {
    "none": {},
    "all": {"OTEL_SERVICE_NAME": "from-env", "OTEL_TRACES_SAMPLER_ARG": "0.25",
            "OTEL_RESOURCE_ATTRIBUTES": "zone=us,rack=7"},
    "endpoint": {"OTEL_EXPORTER_OTLP_ENDPOINT": "http://127.0.0.1:9"},
    "bad ratio": {"OTEL_TRACES_SAMPLER_ARG": "lots"},
    "attributes merge": {"OTEL_RESOURCE_ATTRIBUTES": "deployment=prod"},
}


@pytest.mark.parametrize("case", sorted(OTEL_CASES))
def test_otel_environment_overrides_equal_the_reference(case, monkeypatch):
    for k in ("OTEL_SERVICE_NAME", "OTEL_TRACES_SAMPLER_ARG", "OTEL_RESOURCE_ATTRIBUTES",
              "OTEL_EXPORTER_OTLP_ENDPOINT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in OTEL_CASES[case].items():
        monkeypatch.setenv(k, v)
    got = []
    for mod in (jtel, ttel):
        t = mod.init_telemetry(service_name="from-config", sample_ratio=0.5,
                               attributes="deployment=dev,team=x")
        exporter = t.exporter
        got.append((t.service_name, t.sample_ratio, t.resource,
                    None if exporter is None else (exporter.base, exporter.headers)))
        t.shutdown()
    assert got[0] == got[1]


# ----------------------------------------------------------------- OTLP


def _feed(mod, t):
    """The same spans (fixed ids and times), instruments, gauges and log
    records into ``t``."""
    span = mod.Span(name="op", trace_id="ab" * 16, span_id="cd" * 8, parent_id=None,
                    start_ns=100, attributes={"n": 2, "f": 0.5, "b": True, "s": "x"},
                    end_ns=250)
    child = mod.Span(name="child", trace_id="ab" * 16, span_id="ef" * 8, parent_id="cd" * 8,
                     start_ns=120, end_ns=None, status_ok=False)
    t._record_span("sc", span)
    t._record_span("sc2", child)
    meter = t.meter("m")
    meter.counter("c", unit="1").add(4)
    meter.histogram("h").record(3)
    meter.observable_gauge("g", lambda: 7.0, unit="By")
    t._record_log(mod.LogRecord(scope="hypha.x", time_ns=5, severity_number=13,
                                severity_text="WARN", body="hello", attributes={"a": 1},
                                trace_id="ab" * 16, span_id="cd" * 8))
    t._record_log(mod.LogRecord(scope="hypha.x", time_ns=6, severity_number=17,
                                severity_text="ERROR", body="bye"))


def test_otlp_payloads_are_equal_json(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_000)
    posts = {}
    for name, mod, otlp_mod in (("jax", jtel, jotlp), ("port", ttel, totlp)):
        sink: list = []

        class Capturing(otlp_mod.OtlpJsonExporter):
            def _post(self, path, payload, sink=sink):
                sink.append((path, payload))

        t = mod.Telemetry(service_name="t", attributes={"zone": "us"},
                          exporter=Capturing("127.0.0.1:9999", {"service.name": "t"}),
                          export_interval=3600)
        _feed(mod, t)
        t.flush()
        t.shutdown()
        posts[name] = sink
    # The flush, then the shutdown's flush (the instruments again).
    assert [p for p, _ in posts["port"]] == ["/v1/traces", "/v1/metrics", "/v1/logs",
                                            "/v1/metrics"]
    assert json.dumps(posts["port"]) == json.dumps(posts["jax"])
    assert totlp._attr_list({"a": 1, "b": 1.5, "c": False, "d": None}) == \
        jotlp._attr_list({"a": 1, "b": 1.5, "c": False, "d": None})


def test_a_loopback_collector_receives_the_payloads(collector):
    t = ttel.Telemetry(service_name="t",
                       exporter=totlp.OtlpJsonExporter(collector.endpoint, {"service.name": "t"}),
                       export_interval=3600)
    _feed(ttel, t)
    t.flush()
    t.shutdown()
    got = dict(collector.posts)
    spans = got["/v1/traces"]["resourceSpans"][0]["scopeSpans"]
    assert [s["spans"][0]["name"] for s in spans] == ["op", "child"]
    names = {m["name"] for m in got["/v1/metrics"]["resourceMetrics"][0]["scopeMetrics"][0][
        "metrics"]}
    assert names == {"c", "h", "g"}
    logs = got["/v1/logs"]["resourceLogs"][0]["scopeLogs"][0]["logRecords"]
    assert [r["body"]["stringValue"] for r in logs] == ["hello", "bye"]


def test_an_unreachable_collector_warns_once_and_never_raises(caplog):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # closed again: nothing listens there
    exporter = totlp.OtlpJsonExporter(f"127.0.0.1:{port}", {"service.name": "t"})
    t = ttel.Telemetry(service_name="t", exporter=exporter, export_interval=3600)
    with caplog.at_level(logging.DEBUG, "hypha.telemetry.otlp"):
        for _ in range(2):
            _feed(ttel, t)
            t.flush()
    t.shutdown()
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "otlp export to" in warnings[0].getMessage()


def test_the_log_bridge_correlates_records_with_the_current_span(collector):
    t = ttel.Telemetry(service_name="t",
                       exporter=totlp.OtlpJsonExporter(collector.endpoint, {"service.name": "t"}),
                       export_interval=3600)
    handler = t.attach_logging(logger="hypha.test.torch.logs", level=logging.INFO)
    lg = logging.getLogger("hypha.test.torch.logs")
    lg.setLevel(logging.DEBUG)
    with t.tracer("sc").span("op") as span:
        lg.warning("inside span %d", 7)
    try:
        raise ValueError("boom")
    except ValueError:
        lg.exception("after span")
    lg.debug("below the handler's level")
    t.flush()
    t.shutdown()
    assert handler not in lg.handlers
    recs = dict(collector.posts)["/v1/logs"]["resourceLogs"][0]["scopeLogs"][0]["logRecords"]
    assert [r["body"]["stringValue"] for r in recs] == ["inside span 7", "after span"]
    inside, after = recs
    assert inside["severityText"] == "WARN" and inside["severityNumber"] == 13
    assert inside["traceId"] == span.trace_id and inside["spanId"] == span.span_id
    assert after["severityText"] == "ERROR" and "traceId" not in after
    attrs = {a["key"]: a["value"] for a in after["attributes"]}
    assert attrs["exception.type"] == {"stringValue": "ValueError"}


def test_the_export_thread_posts_every_interval(collector):
    t = ttel.Telemetry(service_name="t",
                       exporter=totlp.OtlpJsonExporter(collector.endpoint, {"service.name": "t"}),
                       export_interval=0.05)
    t.meter("m").observable_gauge("g", lambda: 1.0)
    deadline = time.monotonic() + 10
    while sum(p == "/v1/metrics" for p in (x for x, _ in collector.posts)) < 2:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    t.shutdown()
    assert not t._thread.is_alive()


# ------------------------------------------------------------ node CLI


def test_nodes_with_a_telemetry_endpoint_export_to_the_collector(collector):
    """``telemetry.endpoint`` (refused until tracing was ported): a gateway
    and a data node started by the CLI runners export their bandwidth
    gauges to the collector every second and flush at stop."""
    from hypha_tpu_torch import cli
    from hypha_tpu_torch import config as tcfg
    from hypha_tpu_torch.node_config import DataNodeConfig, GatewayConfig

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        gw = f"127.0.0.1:{s.getsockname()[1]}"
    tele = {"telemetry.endpoint": collector.endpoint}
    gconf = tcfg.builder(GatewayConfig).with_overrides(
        {"network.listen": [gw], **tele}).build().validate().value
    dconf = tcfg.builder(DataNodeConfig).with_overrides(
        {"datasets": {"d": "/tmp"}, "network.gateways": [gw], **tele}).build().validate().value

    async def main():
        stops = [asyncio.Event(), asyncio.Event()]
        g = asyncio.create_task(cli._run_gateway(gconf, stop=stops[0]))
        await asyncio.sleep(0.2)
        d = asyncio.create_task(cli._run_data(dconf, stop=stops[1]))
        await asyncio.sleep(1.5)
        for stop, task in zip(reversed(stops), (d, g)):
            stop.set()
            await asyncio.wait_for(task, 30)

    asyncio.run(main())
    gauges: dict = {}
    for path, payload in collector.posts:
        if path != "/v1/metrics":
            continue
        for rm in payload["resourceMetrics"]:
            attrs = {a["key"]: a["value"]["stringValue"] for a in rm["resource"]["attributes"]}
            for m in rm["scopeMetrics"][0]["metrics"]:
                gauges.setdefault(attrs["service.name"], {})[m["name"]] = \
                    m["gauge"]["dataPoints"][0]["asDouble"]
    # The fabric counts push and pull payloads, as the reference's does:
    # these nodes moved control frames only.
    assert gauges == {s: {"hypha.bandwidth.inbound.bytes": 0.0,
                          "hypha.bandwidth.outbound.bytes": 0.0}
                      for s in ("hypha-gateway", "hypha-data")}
    assert not [h for h in logging.getLogger().handlers if isinstance(h, ttel.LogBridge)]
