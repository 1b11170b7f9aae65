"""OTLP/HTTP+JSON export (port of ``hypha_tpu/telemetry/otlp.py``).

Speaks the standard OTLP HTTP endpoints (``/v1/traces``, ``/v1/metrics``,
``/v1/logs``) in their JSON encoding, so any OTEL collector can ingest it.
Posts run on the telemetry thread; failures are logged and dropped — export
must never stall or crash a node.
"""

from __future__ import annotations

import json
import logging
import urllib.request

log = logging.getLogger("hypha.telemetry.otlp")


def _attr_list(attrs: dict) -> list:
    out = []
    for k, v in attrs.items():
        if isinstance(v, bool):
            value = {"boolValue": v}
        elif isinstance(v, int):
            value = {"intValue": str(v)}
        elif isinstance(v, float):
            value = {"doubleValue": v}
        else:
            value = {"stringValue": str(v)}
        out.append({"key": str(k), "value": value})
    return out


class OtlpJsonExporter:
    def __init__(self, endpoint: str, resource: dict, headers: dict | None = None):
        base = endpoint if "://" in endpoint else f"http://{endpoint}"
        self.base = base.rstrip("/")
        self.resource = resource
        self.headers = {"content-type": "application/json", **(headers or {})}
        self._warned = False

    def _post(self, path: str, payload: dict) -> None:
        req = urllib.request.Request(
            self.base + path,
            data=json.dumps(payload).encode(),
            headers=self.headers,
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5):  # noqa: S310
                pass
        except Exception as e:
            # First failure at warning so a dead/mis-addressed collector is
            # visible; the steady-state repeats stay at debug.
            if not self._warned:
                self._warned = True
                log.warning("otlp export to %s failing: %s", self.base + path, e)
            else:
                log.debug("otlp post %s failed: %s", path, e)

    # ------------------------------------------------------------- traces
    def export_spans(self, spans: list) -> None:
        by_scope: dict[str, list] = {}
        for scope, span in spans:
            by_scope.setdefault(scope, []).append(span)
        payload = {
            "resourceSpans": [
                {
                    "resource": {"attributes": _attr_list(self.resource)},
                    "scopeSpans": [
                        {
                            "scope": {"name": scope},
                            "spans": [
                                {
                                    "traceId": s.trace_id,
                                    "spanId": s.span_id,
                                    **(
                                        {"parentSpanId": s.parent_id}
                                        if s.parent_id
                                        else {}
                                    ),
                                    "name": s.name,
                                    "kind": 1,
                                    "startTimeUnixNano": str(s.start_ns),
                                    "endTimeUnixNano": str(s.end_ns or s.start_ns),
                                    "attributes": _attr_list(s.attributes),
                                    "status": {"code": 1 if s.status_ok else 2},
                                }
                                for s in scope_spans
                            ],
                        }
                        for scope, scope_spans in by_scope.items()
                    ],
                }
            ]
        }
        self._post("/v1/traces", payload)

    # ------------------------------------------------------------ metrics
    def export_metrics(self, instruments: dict, gauges: dict) -> None:
        import time

        now = str(time.time_ns())
        metrics = []
        for (scope, name), inst in instruments.items():
            if hasattr(inst, "value"):  # Counter
                metrics.append(
                    {
                        "name": name,
                        "unit": inst.unit,
                        "sum": {
                            "aggregationTemporality": 2,  # cumulative
                            "isMonotonic": True,
                            "dataPoints": [
                                {"asDouble": inst.value(), "timeUnixNano": now}
                            ],
                        },
                    }
                )
            elif hasattr(inst, "snapshot"):  # Histogram
                snap = inst.snapshot()
                metrics.append(
                    {
                        "name": name,
                        "unit": inst.unit,
                        "histogram": {
                            "aggregationTemporality": 2,
                            "dataPoints": [
                                {
                                    "timeUnixNano": now,
                                    "count": str(snap["count"]),
                                    "sum": snap["sum"],
                                    "bucketCounts": [
                                        str(c) for c in snap["bucket_counts"]
                                    ],
                                    "explicitBounds": snap["bounds"],
                                }
                            ],
                        },
                    }
                )
        for (_scope, name), (value, unit) in gauges.items():
            metrics.append(
                {
                    "name": name,
                    "unit": unit,
                    "gauge": {"dataPoints": [{"asDouble": value, "timeUnixNano": now}]},
                }
            )
        if not metrics:
            return
        payload = {
            "resourceMetrics": [
                {
                    "resource": {"attributes": _attr_list(self.resource)},
                    "scopeMetrics": [{"scope": {"name": "hypha"}, "metrics": metrics}],
                }
            ]
        }
        self._post("/v1/metrics", payload)

    # --------------------------------------------------------------- logs
    def export_logs(self, records: list) -> None:
        """Standard OTLP ``/v1/logs`` export — parity with the reference's
        log pipeline (log records exported
        alongside spans and metrics)."""
        by_scope: dict[str, list] = {}
        for rec in records:
            by_scope.setdefault(rec.scope, []).append(
                {
                    "timeUnixNano": str(rec.time_ns),
                    "severityNumber": rec.severity_number,
                    "severityText": rec.severity_text,
                    "body": {"stringValue": rec.body},
                    "attributes": _attr_list(rec.attributes),
                    **({"traceId": rec.trace_id} if rec.trace_id else {}),
                    **({"spanId": rec.span_id} if rec.span_id else {}),
                }
            )
        if not by_scope:
            return
        payload = {
            "resourceLogs": [
                {
                    "resource": {"attributes": _attr_list(self.resource)},
                    "scopeLogs": [
                        {"scope": {"name": scope}, "logRecords": recs}
                        for scope, recs in by_scope.items()
                    ],
                }
            ]
        }
        self._post("/v1/logs", payload)
