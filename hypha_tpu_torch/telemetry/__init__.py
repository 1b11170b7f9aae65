"""Telemetry: tracing spans, metrics and OTLP export (port of
``hypha_tpu/telemetry/__init__.py``), standard library only.

  * every node wires its providers at start from its config's
    ``telemetry`` section, with the standard ``OTEL_*`` environment
    variables taking precedence (:func:`init_telemetry`);
  * traces use a parent-based ratio sampler;
  * metrics export on a 1-second interval;
  * transport bandwidth is instrumented per node
    (``hypha.bandwidth.inbound.bytes``/``outbound.bytes``).

Spans and instruments record in-process and export over OTLP/HTTP+JSON
(``/v1/traces``, ``/v1/metrics``, ``/v1/logs``) when an endpoint is
configured; otherwise recording still works and export is a no-op. The
round-trace plane is :mod:`.trace`, the flight recorder :mod:`.flight`, the
offline merger :mod:`.timeline`; the shared metric bundles are
:mod:`.ft_metrics`, and :func:`metrics_snapshot` reads them all at once. The
live metrics plane (:mod:`.metrics_plane`, :mod:`.series`, :mod:`.slo`,
``python -m hypha_tpu_torch.telemetry.top``) ships them to the scheduler.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging as _pylog
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from .attributes import parse_attributes
from .otlp import OtlpJsonExporter

__all__ = [
    "Telemetry",
    "Tracer",
    "Span",
    "Meter",
    "Counter",
    "Histogram",
    "LogRecord",
    "LogBridge",
    "init_telemetry",
    "instrument_node",
    "global_telemetry",
    "metrics_snapshot",
    "parse_attributes",
    "OtlpJsonExporter",
]

log = _pylog.getLogger("hypha.telemetry")

# Reference binaries export metrics every second
# (crates/scheduler/src/bin/hypha-scheduler.rs metric reader interval).
METRIC_EXPORT_INTERVAL_S = 1.0

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "hypha_current_span", default=None
)


def _rand_id(nbytes: int) -> str:
    # os.urandom, NOT the global random module: deterministic chaos runs
    # (ft/chaos.py) seed the global RNG, which would make trace/span ids
    # deterministic — and collide across nodes in one merged timeline.
    return os.urandom(nbytes).hex()


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start_ns: int
    attributes: dict[str, Any] = field(default_factory=dict)
    end_ns: int | None = None
    status_ok: bool = True
    sampled: bool = True

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def record_error(self, err: BaseException) -> None:
        self.status_ok = False
        self.attributes["error.type"] = type(err).__name__
        self.attributes["error.message"] = str(err)


@dataclass
class LogRecord:
    """One exported log record (OTLP LogRecord shape)."""

    scope: str
    time_ns: int
    severity_number: int
    severity_text: str
    body: str
    attributes: dict[str, Any] = field(default_factory=dict)
    trace_id: str | None = None
    span_id: str | None = None


# Python logging levels -> OTLP severity numbers (spec table).
_SEVERITY = {
    _pylog.DEBUG: (5, "DEBUG"),
    _pylog.INFO: (9, "INFO"),
    _pylog.WARNING: (13, "WARN"),
    _pylog.ERROR: (17, "ERROR"),
    _pylog.CRITICAL: (21, "FATAL"),
}


def _severity_for(levelno: int) -> tuple[int, str]:
    for lvl in sorted(_SEVERITY, reverse=True):
        if levelno >= lvl:
            return _SEVERITY[lvl]
    return 1, "TRACE"


class LogBridge(_pylog.Handler):
    """Bridges Python ``logging`` records into the OTLP log export, the way
    the reference's tracing layer forwards events to its OTLP log provider
    (crates/telemetry/src/logging.rs). Records are correlated with the
    context's current span (traceId/spanId) when one is active."""

    def __init__(self, telemetry: "Telemetry", level: int = _pylog.INFO) -> None:
        super().__init__(level)
        self._telemetry = telemetry

    def emit(self, record: _pylog.LogRecord) -> None:
        try:
            num, text = _severity_for(record.levelno)
            span = _current_span.get()
            attrs: dict[str, Any] = {
                "code.function": record.funcName,
                "code.filepath": record.pathname,
                "code.lineno": record.lineno,
            }
            if record.exc_info and record.exc_info[0] is not None:
                attrs["exception.type"] = record.exc_info[0].__name__
                attrs["exception.message"] = str(record.exc_info[1])
            self._telemetry._record_log(
                LogRecord(
                    scope=record.name,
                    time_ns=int(record.created * 1e9),
                    severity_number=num,
                    severity_text=text,
                    body=record.getMessage(),
                    attributes=attrs,
                    trace_id=span.trace_id if span is not None else None,
                    span_id=span.span_id if span is not None else None,
                )
            )
        except Exception:  # a logging handler must never raise
            self.handleError(record)


class Tracer:
    def __init__(self, scope: str, telemetry: "Telemetry") -> None:
        self.scope = scope
        self._telemetry = telemetry

    @contextlib.contextmanager
    def span(self, name: str, attributes: dict | None = None):
        """Start a span as a child of the context's current span.

        Sampling is parent-based with a configured ratio for roots
        (docs/worker.md:195-199 ``parentbased_traceidratio``)."""
        parent = _current_span.get()
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
            sampled = parent.sampled
        else:
            trace_id = _rand_id(16)
            parent_id = None
            sampled = random.random() < self._telemetry.sample_ratio
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=_rand_id(8),
            parent_id=parent_id,
            start_ns=time.time_ns(),
            attributes=dict(attributes or {}),
            sampled=sampled,
        )
        token = _current_span.set(span)
        try:
            yield span
        except BaseException as e:
            span.record_error(e)
            raise
        finally:
            span.end_ns = time.time_ns()
            _current_span.reset(token)
            if span.sampled:
                self._telemetry._record_span(self.scope, span)


class Counter:
    """Monotonic sum instrument."""

    def __init__(self, name: str, unit: str = "") -> None:
        self.name = name
        self.unit = unit
        self._value = 0.0
        self._lock = threading.Lock()

    def add(self, amount: float, **_attrs) -> None:
        if amount < 0:
            raise ValueError("counter increments must be non-negative")
        with self._lock:
            # float() here, not at read time: a numpy or torch scalar increment
            # would otherwise promote the accumulator to np.float32 and
            # leak a non-JSON-serializable scalar into every snapshot
            # (every snapshot must stay JSON-safe).
            self._value += float(amount)

    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-boundary histogram instrument."""

    DEFAULT_BOUNDS = (1, 5, 10, 50, 100, 500, 1000, 5000, 10000)

    def __init__(self, name: str, unit: str = "", bounds: tuple = DEFAULT_BOUNDS):
        self.name = name
        self.unit = unit
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def record(self, value: float, **_attrs) -> None:
        value = float(value)  # numpy or torch scalars must not taint the sum
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "sum": self._sum,
                "count": self._count,
                "bucket_counts": list(self._counts),
                "bounds": list(self.bounds),
            }


class Meter:
    def __init__(self, scope: str, telemetry: "Telemetry") -> None:
        self.scope = scope
        self._telemetry = telemetry

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._telemetry._instrument(self.scope, name, lambda: Counter(name, unit))

    def histogram(self, name: str, unit: str = "", bounds=Histogram.DEFAULT_BOUNDS) -> Histogram:
        return self._telemetry._instrument(
            self.scope, name, lambda: Histogram(name, unit, bounds)
        )

    def observable_gauge(self, name: str, callback: Callable[[], float], unit: str = "") -> None:
        self._telemetry._gauges[(self.scope, name)] = (callback, unit)

    def remove_gauges(self) -> None:
        """Drop every observable gauge under this meter's scope — called at
        node teardown so the registry (and its callback closures over the
        node) does not outlive the fabric it instruments."""
        for key in [k for k in self._telemetry._gauges if k[0] == self.scope]:
            del self._telemetry._gauges[key]


class Telemetry:
    """Provider bundle: tracers, meters, the export loop, shutdown.

    The reference initializes three OTLP providers per binary
    (hypha-scheduler.rs:55-94); here one object owns all three concerns.
    """

    def __init__(
        self,
        service_name: str = "hypha",
        endpoint: str = "",
        sample_ratio: float = 1.0,
        attributes: dict | None = None,
        exporter=None,
        export_interval: float = METRIC_EXPORT_INTERVAL_S,
    ) -> None:
        self.service_name = service_name
        self.sample_ratio = sample_ratio
        self.resource = {"service.name": service_name, **(attributes or {})}
        self.exporter = exporter or (
            OtlpJsonExporter(endpoint, self.resource) if endpoint else None
        )
        self._instruments: dict[tuple[str, str], Any] = {}
        self._gauges: dict[tuple[str, str], tuple[Callable[[], float], str]] = {}
        self._spans: list[tuple[str, Span]] = []
        self._logs: list[LogRecord] = []
        self._log_handlers: list[LogBridge] = []
        self._lock = threading.Lock()
        self._export_interval = export_interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if self.exporter is not None:
            self._thread = threading.Thread(
                target=self._export_loop, name="hypha-telemetry", daemon=True
            )
            self._thread.start()

    # -- factories ----------------------------------------------------------
    def tracer(self, scope: str) -> Tracer:
        return Tracer(scope, self)

    def meter(self, scope: str) -> Meter:
        return Meter(scope, self)

    # -- recording ----------------------------------------------------------
    def _instrument(self, scope: str, name: str, factory):
        key = (scope, name)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = factory()
                self._instruments[key] = inst
            return inst

    def _record_span(self, scope: str, span: Span) -> None:
        with self._lock:
            self._spans.append((scope, span))
            # Bound memory if no exporter drains the buffer.
            if len(self._spans) > 4096:
                del self._spans[: len(self._spans) - 4096]

    def _record_log(self, record: LogRecord) -> None:
        with self._lock:
            self._logs.append(record)
            if len(self._logs) > 4096:
                del self._logs[: len(self._logs) - 4096]

    def attach_logging(
        self, logger: str = "", level: int = _pylog.INFO
    ) -> LogBridge:
        """Install the OTLP log bridge on ``logger`` (default: root), so
        ordinary ``logging`` calls flow to the collector alongside spans and
        metrics — the reference's logging provider role
        (crates/telemetry/src/logging.rs)."""
        handler = LogBridge(self, level)
        _pylog.getLogger(logger).addHandler(handler)
        self._log_handlers.append(handler)
        return handler

    # -- export -------------------------------------------------------------
    def _drain(self) -> tuple[list, dict, dict, list]:
        with self._lock:
            spans = self._spans
            self._spans = []
            logs = self._logs
            self._logs = []
            instruments = dict(self._instruments)
        gauges = {}
        for key, (cb, unit) in list(self._gauges.items()):
            try:
                gauges[key] = (cb(), unit)
            except Exception as e:
                # A raising gauge callback (e.g. reading state mid-teardown)
                # must not kill the export thread or mask shutdown errors.
                log.warning("observable gauge %s raised: %s", key, e)
        return spans, instruments, gauges, logs

    def flush(self) -> None:
        if self.exporter is None:
            return
        spans, instruments, gauges, logs = self._drain()
        try:
            if spans:
                self.exporter.export_spans(spans)
            self.exporter.export_metrics(instruments, gauges)
            if logs and hasattr(self.exporter, "export_logs"):
                self.exporter.export_logs(logs)
        except Exception as e:  # export must never break the node
            log.warning("telemetry export failed: %s", e)

    def _export_loop(self) -> None:
        while not self._stop.wait(self._export_interval):
            self.flush()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._log_handlers:
            loggers = [
                lg
                for lg in list(_pylog.Logger.manager.loggerDict.values())
                if isinstance(lg, _pylog.Logger)
            ] + [_pylog.getLogger()]
            for handler in self._log_handlers:
                for lg in loggers:
                    if handler in lg.handlers:
                        lg.removeHandler(handler)
            self._log_handlers.clear()
        self.flush()

    # -- test/introspection --------------------------------------------------
    def finished_spans(self) -> list[tuple[str, Span]]:
        with self._lock:
            return list(self._spans)


def init_telemetry(
    service_name: str = "hypha",
    endpoint: str = "",
    sample_ratio: float = 1.0,
    attributes: str | dict | None = None,
    exporter=None,
) -> Telemetry:
    """Build the provider bundle; standard ``OTEL_*`` env vars win over the
    passed config (reference: ``Env::prefixed("OTEL_")`` layered last)."""
    endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT", endpoint)
    service_name = os.environ.get("OTEL_SERVICE_NAME", service_name)
    ratio_env = os.environ.get("OTEL_TRACES_SAMPLER_ARG")
    if ratio_env:
        try:
            sample_ratio = float(ratio_env)
        except ValueError:
            log.warning("bad OTEL_TRACES_SAMPLER_ARG %r ignored", ratio_env)
    attrs = parse_attributes(attributes) if isinstance(attributes, str) else dict(attributes or {})
    env_attrs = os.environ.get("OTEL_RESOURCE_ATTRIBUTES")
    if env_attrs:
        attrs.update(parse_attributes(env_attrs))
    telemetry = Telemetry(
        service_name=service_name,
        endpoint=endpoint,
        sample_ratio=sample_ratio,
        attributes=attrs,
        exporter=exporter,
    )
    if telemetry.exporter is not None:
        # Logs flow to the same collector as spans/metrics — the reference
        # installs its log provider globally at binary startup
        # (crates/telemetry/src/logging.rs).
        telemetry.attach_logging()
    return telemetry


def instrument_node(meter: Meter, node) -> None:
    """Bandwidth instrumentation: observable counters over the node's
    transport byte counters (the reference wraps the muxer —
    crates/telemetry/src/bandwidth.rs:30-62; our fabric counts in
    _CountingStream and the frame layer)."""
    meter.observable_gauge(
        "hypha.bandwidth.inbound.bytes", lambda: float(node.bytes_in), unit="By"
    )
    meter.observable_gauge(
        "hypha.bandwidth.outbound.bytes", lambda: float(node.bytes_out), unit="By"
    )


# Process-global provider: components that create fabrics WITHOUT going
# through a cli.py entrypoint (worker runtimes hosting PS shards, serving
# workers, harnesses) register their bandwidth gauges here, so one
# snapshot sees every fabric in the process. No exporter: recording only —
# init_telemetry stays the export-wired path for real deployments.
_GLOBAL: "Telemetry | None" = None
_GLOBAL_LOCK = threading.Lock()


def global_telemetry() -> Telemetry:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Telemetry(service_name="hypha", exporter=None)
        return _GLOBAL


def metrics_snapshot() -> dict:
    """One JSON-safe snapshot of every process metrics surface: the FT /
    stream / shard / serve / heterogeneity / scale / data bundles plus the
    global registry's observable gauges (per-node bandwidth among them)."""
    gauges: dict[str, float] = {}
    telemetry = global_telemetry()
    for (scope, name), (cb, _unit) in sorted(telemetry._gauges.items()):
        try:
            gauges[f"{scope}/{name}"] = float(cb())
        except Exception:  # a torn-down node's gauge must not kill the dump
            continue
    return {
        "ft": FT_METRICS.snapshot(),
        "stream": STREAM_METRICS.snapshot(),
        "shard": SHARD_METRICS.snapshot(),
        "serve": SERVE_METRICS.snapshot(),
        "het": HET_METRICS.snapshot(),
        "scale": SCALE_METRICS.snapshot(),
        "data": DATA_METRICS.snapshot(),
        "gauges": gauges,
        "aio_task_failures": _aio_task_failures(),
    }


def _aio_task_failures() -> float:
    from ..aio import TASK_FAILURES  # lazy: aio imports this package

    return TASK_FAILURES.value()


# The shared bundles (imported at the bottom: ft_metrics uses the
# Counter/Histogram classes defined above).
from .ft_metrics import (  # noqa: E402
    DATA_METRICS,
    FT_METRICS,
    HET_METRICS,
    SCALE_METRICS,
    SERVE_METRICS,
    SHARD_METRICS,
    STREAM_METRICS,
    FTMetrics,
    ServeMetrics,
)

__all__ += [
    "FT_METRICS",
    "FTMetrics",
    "SCALE_METRICS",
    "SERVE_METRICS",
    "ServeMetrics",
]
