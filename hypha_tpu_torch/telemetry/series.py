"""Time-series primitives for the live metrics plane (port of
``hypha_tpu/telemetry/series.py``, standard library only).

Three concerns, all pure data (no fabric, no asyncio):

  * **Reservoir summaries** — a node never ships raw latency reservoirs;
    it ships the compact ``{count, sum, min, max, p50, p95, p99}`` shape
    (:func:`summarize`), and the scheduler re-pools per-peer summaries
    into a fleet quantile estimate (:func:`merge_summaries`).

  * **The bounded store** — :class:`TimeSeriesStore` keeps one ring of
    ``(t, value)`` points per ``(peer, metric)`` plus round-indexed
    *quality* series (loss curves and friends), with fleet rollups
    (sum / max / last-per-peer / merged quantiles) and an outlier probe
    used by the SLO watchdog and ``telemetry.top``.

  * **Exporters** — :func:`prometheus_text` renders the store in the
    Prometheus exposition format; :func:`to_otlp_metrics` emits OTLP/JSON
    ``resourceMetrics`` reusing the attribute encoding in
    :mod:`hypha_tpu_torch.telemetry.otlp`.

Quantile-merge error bounds (tested in tests/test_torch_metrics_plane.py):
each input summary pins its CDF at five knots (min, p50, p95, p99, max)
and is piecewise-linear between them, so the merged estimate's error
versus the exact pooled quantile is bounded by the value gap between the
ADJACENT knots that bracket the pooled rank in each contributing peer:

  * a single summary reads back its own knot values exactly;
  * identical per-peer distributions merge near-exactly — <= 5% relative
    at p50/p95, <= 10% at p99 (only sampling error and the sparse
    p99–max segment remain) on the pinned log-normal corpus;
  * tail quantiles (p95/p99) stay tight (<= 15%, measured ~1–3%) even
    for adversarially disjoint mixtures, because knots are dense there;
  * mid-rank quantiles under disjoint mixtures can drift up to a peer's
    p50–p95 knot gap — the merged p50 is only guaranteed to lie inside
    the bracketing-knot envelope (the test asserts exactly that), so
    alert on fleet p95/p99, not fleet medians, when peers are wildly
    heterogeneous.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Iterable

__all__ = [
    "QUANTILES",
    "summarize",
    "merge_summaries",
    "TimeSeriesStore",
    "prometheus_text",
    "to_otlp_metrics",
]

QUANTILES = (0.50, 0.95, 0.99)

# Default ring capacity per (peer, metric) series: at the 1 s default
# report interval this holds ~8.5 minutes of live history per metric —
# the journal, not the ring, is the durable record.
DEFAULT_CAPACITY = 512


def _quantile(sorted_values: list[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted list."""
    if not sorted_values:
        return 0.0
    i = min(int(q * len(sorted_values)), len(sorted_values) - 1)
    return sorted_values[i]


def summarize(values: Iterable[float]) -> dict:
    """Compact reservoir summary — what a :class:`MetricsReport` ships
    instead of the raw reservoir."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {"count": 0.0, "sum": 0.0}
    return {
        "count": float(len(vals)),
        "sum": float(sum(vals)),
        "min": vals[0],
        "max": vals[-1],
        "p50": _quantile(vals, 0.50),
        "p95": _quantile(vals, 0.95),
        "p99": _quantile(vals, 0.99),
    }


_SUMMARY_KNOTS = (
    (0.0, "min"), (0.50, "p50"), (0.95, "p95"), (0.99, "p99"), (1.0, "max")
)


def _knots(summary: dict) -> list[tuple[float, float]]:
    """(rank, value) CDF knots a summary pins: CDF(v_p50) = 0.50 etc."""
    return [
        (r, float(summary[k]))
        for r, k in _SUMMARY_KNOTS
        if summary.get(k) is not None
    ]


def _cdf_at(knots: list[tuple[float, float]], v: float) -> float:
    """Piecewise-linear CDF through a summary's knots, clamped to [0,1]."""
    if not knots:
        return 0.0
    if v <= knots[0][1]:
        return knots[0][0] if v == knots[0][1] else 0.0
    if v >= knots[-1][1]:
        return 1.0
    for (r0, v0), (r1, v1) in zip(knots, knots[1:]):
        if v0 <= v <= v1:
            if v1 <= v0:
                return r1
            return r0 + (r1 - r0) * (v - v0) / (v1 - v0)
    return 1.0


def merge_summaries(summaries: Iterable[dict]) -> dict:
    """Pool per-peer summaries into one fleet summary.

    Each summary's recorded quantiles pin its CDF at five knots; the
    pooled CDF is the count-weighted mixture of the per-peer piecewise-
    linear CDFs, inverted by bisection for each target quantile (see the
    module docstring for the error bound — a single summary or identical
    per-peer distributions read back their own knot values exactly).
    ``count``/``sum`` merge exactly; ``min``/``max`` are exact envelopes.
    """
    summaries = [s for s in summaries if s and float(s.get("count", 0) or 0) > 0]
    if not summaries:
        return {"count": 0.0, "sum": 0.0}
    total = sum(float(s["count"]) for s in summaries)
    merged: dict[str, float] = {
        "count": total,
        "sum": float(sum(float(s.get("sum", 0.0)) for s in summaries)),
        "min": min(float(s.get("min", math.inf)) for s in summaries),
        "max": max(float(s.get("max", -math.inf)) for s in summaries),
    }
    per_peer = [
        (float(s["count"]), _knots(s)) for s in summaries if _knots(s)
    ]
    if not per_peer:
        return merged

    def pooled_cdf(v: float) -> float:
        return (
            sum(c * _cdf_at(k, v) for c, k in per_peer) / total
        )

    lo0 = merged["min"]
    hi0 = merged["max"]
    for q in QUANTILES:
        lo, hi = lo0, hi0
        for _ in range(48):  # bisection to ~2^-48 of the value range
            mid = (lo + hi) / 2.0
            if pooled_cdf(mid) < q:
                lo = mid
            else:
                hi = mid
        merged[f"p{int(q * 100)}"] = hi
    return merged


class _Series:
    __slots__ = ("points", "cumulative")

    def __init__(self, capacity: int) -> None:
        self.points: deque[tuple[float, Any]] = deque(maxlen=capacity)
        self.cumulative = 0.0  # counters: running total of shipped deltas


class TimeSeriesStore:
    """Bounded per-peer / per-metric ring buffers with fleet rollups.

    Thread-safe: the collector ingests from the event loop while
    ``telemetry.top`` / the SLO watchdog snapshot from anywhere.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._capacity = max(int(capacity), 2)
        self._lock = threading.Lock()
        # (peer, metric) -> ring of (t_wall, value)
        self._gauges: dict[tuple[str, str], _Series] = {}
        # (peer, metric) -> ring of (t_wall, summary dict)
        self._summaries: dict[tuple[str, str], _Series] = {}
        # metric -> peer -> {round: value} (training-quality curves)
        self._quality: dict[str, dict[str, dict[int, float]]] = {}
        self._last_seen: dict[str, float] = {}
        self._round_seen: dict[int, float] = {}  # round -> first report t

    # ------------------------------------------------------------- ingest
    def note_peer(self, peer: str, t: float | None = None) -> None:
        with self._lock:
            self._last_seen[str(peer)] = time.time() if t is None else t

    def note_round(self, round_num: int, t: float | None = None) -> None:
        """First sighting of a round (feeds the round-wall SLO series)."""
        t = time.time() if t is None else t
        with self._lock:
            self._round_seen.setdefault(int(round_num), t)

    def record_gauge(
        self, peer: str, metric: str, value: float, t: float | None = None
    ) -> None:
        t = time.time() if t is None else t
        key = (str(peer), str(metric))
        with self._lock:
            series = self._gauges.get(key)
            if series is None:
                series = self._gauges[key] = _Series(self._capacity)
            series.points.append((t, float(value)))
            self._last_seen[key[0]] = max(self._last_seen.get(key[0], 0.0), t)

    def record_delta(
        self,
        peer: str,
        metric: str,
        delta: float,
        interval_s: float,
        t: float | None = None,
    ) -> None:
        """One counter delta: stores the per-interval RATE as the gauge
        point and keeps the cumulative total queryable."""
        t = time.time() if t is None else t
        key = (str(peer), str(metric))
        rate = float(delta) / interval_s if interval_s > 0 else float(delta)
        with self._lock:
            series = self._gauges.get(key)
            if series is None:
                series = self._gauges[key] = _Series(self._capacity)
            series.cumulative += float(delta)
            series.points.append((t, rate))
            self._last_seen[key[0]] = max(self._last_seen.get(key[0], 0.0), t)

    def record_summary(
        self, peer: str, metric: str, summary: dict, t: float | None = None
    ) -> None:
        t = time.time() if t is None else t
        key = (str(peer), str(metric))
        with self._lock:
            series = self._summaries.get(key)
            if series is None:
                series = self._summaries[key] = _Series(self._capacity)
            series.points.append((t, dict(summary)))

    def record_quality(
        self, peer: str, metric: str, round_num: int, value: float
    ) -> None:
        with self._lock:
            self._quality.setdefault(str(metric), {}).setdefault(
                str(peer), {}
            )[int(round_num)] = float(value)

    # -------------------------------------------------------------- reads
    def peers(self) -> list[str]:
        with self._lock:
            return sorted(self._last_seen)

    def metrics(self, peer: str | None = None) -> list[str]:
        with self._lock:
            names = {
                m
                for (p, m) in (*self._gauges, *self._summaries)
                if peer is None or p == peer
            }
        return sorted(names)

    def latest(self, peer: str, metric: str) -> float | None:
        with self._lock:
            series = self._gauges.get((str(peer), str(metric)))
            if series is None or not series.points:
                return None
            return float(series.points[-1][1])

    def cumulative(self, peer: str, metric: str) -> float:
        with self._lock:
            series = self._gauges.get((str(peer), str(metric)))
            return series.cumulative if series is not None else 0.0

    def series(self, peer: str, metric: str) -> list[tuple[float, float]]:
        with self._lock:
            series = self._gauges.get((str(peer), str(metric)))
            return list(series.points) if series is not None else []

    def last_seen(self, peer: str) -> float | None:
        with self._lock:
            return self._last_seen.get(str(peer))

    def silent_for(self, peer: str, now: float | None = None) -> float:
        """Seconds since the peer's last report (inf = never reported)."""
        now = time.time() if now is None else now
        seen = self.last_seen(peer)
        return math.inf if seen is None else max(now - seen, 0.0)

    # ------------------------------------------------------------ rollups
    def fleet_last(self, metric: str) -> dict[str, float]:
        """peer -> latest value of ``metric`` (the per-peer rollup base)."""
        out: dict[str, float] = {}
        with self._lock:
            for (p, m), series in self._gauges.items():
                if m == metric and series.points:
                    out[p] = float(series.points[-1][1])
        return out

    def fleet_sum(self, metric: str) -> float:
        return float(sum(self.fleet_last(metric).values()))

    def fleet_max(self, metric: str) -> float:
        vals = self.fleet_last(metric)
        return float(max(vals.values())) if vals else 0.0

    def fleet_cumulative(self, metric: str) -> float:
        with self._lock:
            return float(
                sum(
                    s.cumulative
                    for (p, m), s in self._gauges.items()
                    if m == metric
                )
            )

    def average_rate(self, peer: str, metric: str) -> float | None:
        """Cumulative shipped deltas / observed wall — the steady-state
        rate of a counter series, immune to one quiet final interval."""
        with self._lock:
            series = self._gauges.get((str(peer), str(metric)))
            if series is None or len(series.points) < 2:
                return None
            span = series.points[-1][0] - series.points[0][0]
            if span <= 0:
                return None
            return series.cumulative / span

    def fleet_average_rate(self, metric: str) -> dict[str, float]:
        out: dict[str, float] = {}
        for peer in self.peers():
            rate = self.average_rate(peer, metric)
            if rate is not None:
                out[peer] = rate
        return out

    def fleet_peak(self, metric: str) -> dict[str, float]:
        """peer -> max recorded point of ``metric``.

        The rollup that separates a bandwidth-capped link from its idle
        siblings: a blocking round drags every peer's AVERAGE down to the
        straggler's pace (everyone waits), but only the capped peer's
        burst rate never exceeds its cap.
        """
        out: dict[str, float] = {}
        with self._lock:
            for (p, m), series in self._gauges.items():
                if m == metric and series.points:
                    out[p] = float(max(v for _t, v in series.points))
        return out

    def fleet_quantiles(self, metric: str) -> dict:
        """Quantile-merge the newest per-peer summaries of ``metric``."""
        with self._lock:
            latest = [
                series.points[-1][1]
                for (p, m), series in self._summaries.items()
                if m == metric and series.points
            ]
        return merge_summaries(latest)

    def outlier(
        self,
        metric: str,
        min_ratio: float = 3.0,
        values: dict[str, float] | None = None,
    ) -> tuple[str, float] | None:
        """The peer whose latest ``metric`` deviates most from the fleet
        median — ``None`` unless it deviates by at least ``min_ratio``
        (multiplicatively for all-positive gauges like bandwidth, where a
        bw-capped link sits orders of magnitude under its siblings).
        ``values`` substitutes another per-peer rollup (e.g.
        :meth:`fleet_average_rate`) for the latest-value one.
        """
        vals = dict(values) if values is not None else self.fleet_last(metric)
        if len(vals) < 2:
            return None
        ordered = sorted(vals.values())
        median = ordered[len(ordered) // 2]
        best: tuple[str, float] | None = None
        best_score = 0.0
        for peer, v in vals.items():
            if median > 0 and v > 0:
                score = max(v / median, median / v)
            else:
                spread = (ordered[-1] - ordered[0]) or 1.0
                score = 1.0 + abs(v - median) / spread * min_ratio
            if score > best_score:
                best_score = score
                best = (peer, v)
        if best is None or best_score < min_ratio:
            return None
        return best

    # ------------------------------------------------------ quality curves
    def quality_series(self, metric: str) -> dict[str, dict[int, float]]:
        """peer -> {round: value} for one training-quality metric."""
        with self._lock:
            return {
                p: dict(rounds)
                for p, rounds in self._quality.get(str(metric), {}).items()
            }

    def quality_rounds(self, metric: str) -> dict[int, dict[str, float]]:
        """round -> {peer: value} (the loss-curve orientation)."""
        out: dict[int, dict[str, float]] = {}
        for peer, rounds in self.quality_series(metric).items():
            for r, v in rounds.items():
                out.setdefault(r, {})[peer] = v
        return dict(sorted(out.items()))

    def round_walls(self) -> dict[int, float]:
        """round -> wall seconds between its first report and the next
        round's (the SLO watchdog's ``round_wall_s`` source)."""
        with self._lock:
            seen = sorted(self._round_seen.items())
        return {
            r0: t1 - t0 for (r0, t0), (_r1, t1) in zip(seen, seen[1:])
        }

    def open_round_age(self, now: float | None = None) -> float:
        """Seconds since the NEWEST round was first sighted — the age of
        the round currently open (0 before any round). A hung round shows
        up here, never in :meth:`round_walls`."""
        now = time.time() if now is None else now
        with self._lock:
            if not self._round_seen:
                return 0.0
            return max(now - max(self._round_seen.values()), 0.0)

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """One JSON-safe view (``telemetry.top`` and MetricsQuery)."""
        with self._lock:
            gauges: dict[str, dict[str, float]] = {}
            for (p, m), series in self._gauges.items():
                if series.points:
                    gauges.setdefault(p, {})[m] = float(series.points[-1][1])
            summaries: dict[str, dict[str, dict]] = {}
            for (p, m), series in self._summaries.items():
                if series.points:
                    summaries.setdefault(p, {})[m] = dict(series.points[-1][1])
            quality = {
                m: {
                    p: {str(r): v for r, v in sorted(rounds.items())}
                    for p, rounds in peers.items()
                }
                for m, peers in self._quality.items()
            }
            last_seen = dict(self._last_seen)
            rounds_seen = {str(r): t for r, t in sorted(self._round_seen.items())}
        return {
            "gauges": gauges,
            "summaries": summaries,
            "quality": quality,
            "last_seen": last_seen,
            "rounds_seen": rounds_seen,
        }


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def _prom_name(metric: str) -> str:
    out = []
    for ch in metric:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    name = "".join(out)
    return name if not name[:1].isdigit() else f"_{name}"


def prometheus_text(store: TimeSeriesStore) -> str:
    """Prometheus exposition-format dump of the store's latest values.

    Gauges render with a ``peer`` label; reservoir summaries render as
    ``<name>{peer=...,quantile=...}`` plus ``_count``/``_sum`` (the
    classic summary type); quality curves render their latest round.
    """
    lines: list[str] = []
    snap = store.snapshot()
    by_metric: dict[str, dict[str, float]] = {}
    for peer, metrics in snap["gauges"].items():
        for m, v in metrics.items():
            by_metric.setdefault(m, {})[peer] = v
    for metric in sorted(by_metric):
        name = _prom_name(metric)
        lines.append(f"# TYPE {name} gauge")
        for peer, v in sorted(by_metric[metric].items()):
            lines.append(f'{name}{{peer="{peer}"}} {v:g}')
    sum_by_metric: dict[str, dict[str, dict]] = {}
    for peer, metrics in snap["summaries"].items():
        for m, s in metrics.items():
            sum_by_metric.setdefault(m, {})[peer] = s
    for metric in sorted(sum_by_metric):
        name = _prom_name(metric)
        lines.append(f"# TYPE {name} summary")
        for peer, s in sorted(sum_by_metric[metric].items()):
            for q in QUANTILES:
                key = f"p{int(q * 100)}"
                if key in s:
                    lines.append(
                        f'{name}{{peer="{peer}",quantile="{q:g}"}} {s[key]:g}'
                    )
            lines.append(f'{name}_count{{peer="{peer}"}} {s.get("count", 0):g}')
            lines.append(f'{name}_sum{{peer="{peer}"}} {s.get("sum", 0):g}')
    for metric, peers in sorted(snap["quality"].items()):
        name = _prom_name(f"quality.{metric}")
        lines.append(f"# TYPE {name} gauge")
        for peer, rounds in sorted(peers.items()):
            if not rounds:
                continue
            last_round = max(rounds, key=int)
            lines.append(
                f'{name}{{peer="{peer}",round="{last_round}"}} '
                f"{rounds[last_round]:g}"
            )
    return "\n".join(lines) + "\n" if lines else ""


def to_otlp_metrics(store: TimeSeriesStore, resource: dict | None = None) -> dict:
    """OTLP/JSON ``resourceMetrics`` for the store's latest values —
    the same shape :class:`~hypha_tpu_torch.telemetry.otlp.OtlpJsonExporter`
    posts, ingestible by any OTEL collector."""
    from .otlp import _attr_list

    now = str(time.time_ns())
    snap = store.snapshot()
    metrics: list[dict] = []
    by_metric: dict[str, dict[str, float]] = {}
    for peer, peer_metrics in snap["gauges"].items():
        for m, v in peer_metrics.items():
            by_metric.setdefault(m, {})[peer] = v
    for metric, peers in sorted(by_metric.items()):
        metrics.append(
            {
                "name": metric,
                "gauge": {
                    "dataPoints": [
                        {
                            "asDouble": v,
                            "timeUnixNano": now,
                            "attributes": _attr_list({"peer": peer}),
                        }
                        for peer, v in sorted(peers.items())
                    ]
                },
            }
        )
    for metric, peers in sorted(snap["quality"].items()):
        metrics.append(
            {
                "name": f"hypha.quality.{metric}",
                "gauge": {
                    "dataPoints": [
                        {
                            "asDouble": v,
                            "timeUnixNano": now,
                            "attributes": _attr_list(
                                {"peer": peer, "round": int(r)}
                            ),
                        }
                        for peer, rounds in sorted(peers.items())
                        for r, v in sorted(rounds.items(), key=lambda kv: int(kv[0]))
                    ]
                },
            }
        )
    return {
        "resourceMetrics": [
            {
                "resource": {
                    "attributes": _attr_list(
                        resource or {"service.name": "hypha"}
                    )
                },
                "scopeMetrics": [
                    {"scope": {"name": "hypha.metrics_plane"}, "metrics": metrics}
                ],
            }
        ]
    }
