"""The live metrics plane: ``/hypha-metrics/0.0.1`` (port of
``hypha_tpu/telemetry/metrics_plane.py``, standard library only).

Every node periodically samples its process metric registry (the FT /
stream / shard / serve / het bundles plus its fabric byte counters) into a
compact :class:`MetricsReport` delta — counters as deltas since the last
report, gauges as last-value, reservoirs as ``{p50, p95, p99, max}``
summaries — and pushes it to the scheduler's :class:`MetricsCollector`,
which:

  * folds reports into a bounded per-peer/per-metric ring store
    (:class:`~hypha_tpu_torch.telemetry.series.TimeSeriesStore`) with fleet
    rollups (sum / max / quantile-merge / outlier);
  * persists a round-stamped ``metrics-<job>.jsonl`` journal next to the
    trace spans;
  * evaluates declarative SLO rules (:mod:`hypha_tpu_torch.telemetry.slo`),
    firing flight-recorder events and
    :class:`~hypha_tpu_torch.telemetry.slo.SLOAdvisory` notices the
    orchestrator logs;
  * answers :class:`MetricsQuery` RPCs with a rollup snapshot — the feed
    for ``python -m hypha_tpu_torch.telemetry.top <addr>``.

Training-quality series (inner loss EWMA, pseudo-gradient norms,
tokens/s) do NOT ride this protocol: workers already send round-tagged
METRICS progress and the PS round-tagged UPDATED notifies, so quality
points piggy-back those existing channels (gated by the same
``report_metrics_s`` config) and the orchestrator forwards them into the
collector via :meth:`MetricsCollector.ingest_quality`.

Reporting defaults OFF. Off ships byte-identical wire: the executor
configs' ``report_metrics_s``/``metrics_peer`` fields are None-default
(omitted from the wire), no node speaks ``/hypha-metrics`` and no
existing message or push header gains a key. The messages' tags and
fields are the reference's, so a node of either package reports into the
other's collector.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from .. import aio
from ..messages import _register, declare_protocol
from . import Counter
from .flight import _SAFE_NODE
from .series import TimeSeriesStore, summarize
from .slo import SLOWatchdog, parse_slo_rules

__all__ = [
    "PROTOCOL_METRICS",
    "MetricsReport",
    "MetricsAck",
    "MetricsQuery",
    "MetricsPage",
    "RegistrySampler",
    "MetricsReporter",
    "MetricsCollector",
    "DEFAULT_INTERVAL_S",
]

log = logging.getLogger("hypha.telemetry.metrics_plane")

PROTOCOL_METRICS = "/hypha-metrics/0.0.1"

DEFAULT_INTERVAL_S = 1.0


@_register
@dataclass(slots=True)
class MetricsReport:
    """One node's periodic registry delta.

    Piggy-backs the peer/round/generation tags every other channel
    carries: ``round`` is the sender's current outer round (0 before the
    first), ``generation`` the scheduler generation it last adopted
    (None — the only value a never-restarted job ships — is omitted from
    the wire, the durable-control-plane discipline). ``seq`` is a
    per-reporter monotone so the collector can spot dropped reports.
    """

    job_id: str = ""
    peer: str = ""
    round: int = 0
    seq: int = 0
    interval_s: float = 0.0
    counters: dict = field(default_factory=dict)  # name -> delta
    gauges: dict = field(default_factory=dict)  # name -> last value
    summaries: dict = field(default_factory=dict)  # name -> summary dict
    generation: int | None = None


@_register
@dataclass(slots=True)
class MetricsAck:
    ok: bool = True


@_register
@dataclass(slots=True)
class MetricsQuery:
    """``telemetry.top`` → collector: hand me the rollup snapshot."""

    job_id: str = ""  # "" = whatever job the collector serves


@_register
@dataclass(slots=True)
class MetricsPage:
    job_id: str = ""
    round: int = 0
    snapshot: dict = field(default_factory=dict)


declare_protocol(
    PROTOCOL_METRICS,
    "MetricsReport",
    "MetricsAck",
    "MetricsQuery",
    "MetricsPage",
)


# ---------------------------------------------------------------------------
# Sampling: process registry -> one report's worth of deltas
# ---------------------------------------------------------------------------


def _walk_counters(obj: Any, out: dict[str, Counter]) -> None:
    if isinstance(obj, Counter):
        out[obj.name] = obj
        return
    if isinstance(obj, dict):
        # list(): the lazy per-fragment/per-codec dicts are inserted into
        # by data-plane threads while the reporter samples — iterating
        # the live view would raise "dict changed size during iteration".
        for v in list(obj.values()):
            _walk_counters(v, out)


class RegistrySampler:
    """Samples the process metric surfaces into report-shaped deltas.

    * counters — every :class:`~hypha_tpu_torch.telemetry.Counter` in the five
      shared bundles (including the lazily-created per-fragment/per-codec
      dicts), shipped as the delta since this sampler's last call;
    * gauges — the bundles' last-value state (queue depth, free blocks,
      bytes in flight, per-peer bandwidth/steps) plus this NODE's fabric
      byte counters (as deltas: the collector derives Mbit/s from them);
    * summaries — the serve latency reservoir compressed to
      ``{count, sum, min, max, p50, p95, p99}`` via
      :func:`~hypha_tpu_torch.telemetry.series.summarize`.

    One process hosting several in-process nodes (a test harness)
    shares one registry, so process-bundle values repeat across its
    reporters — per-NODE truth lives in the fabric byte counters, which
    is what the fleet bandwidth rollups read. Real deployments run one
    node per process and see no aliasing.
    """

    def __init__(self, node=None) -> None:
        self.node = node
        self._last: dict[str, float] = {}
        self._last_reservoir = 0

    def _delta(self, name: str, value: float) -> float:
        prev = self._last.get(name, 0.0)
        self._last[name] = value
        return max(value - prev, 0.0)

    def sample(self) -> tuple[dict, dict, dict]:
        from .ft_metrics import (
            FT_METRICS,
            HET_METRICS,
            SERVE_METRICS,
            SHARD_METRICS,
            STREAM_METRICS,
        )

        counters: dict[str, float] = {}
        found: dict[str, Counter] = {}
        for bundle in (
            FT_METRICS, STREAM_METRICS, SHARD_METRICS, SERVE_METRICS,
            HET_METRICS,
        ):
            _walk_counters(vars(bundle), found)
        for name, counter in found.items():
            delta = self._delta(name, float(counter.value()))
            if delta:
                counters[name] = delta
        if self.node is not None:
            for name, value in (
                ("node.bytes_in", float(self.node.bytes_in)),
                ("node.bytes_out", float(self.node.bytes_out)),
            ):
                # ALWAYS shipped, zero included: the collector derives
                # bandwidth gauges from these, and an omitted quiet
                # interval would freeze an idle peer's gauge at its last
                # burst rate forever.
                counters[name] = self._delta(name, value)
        gauges: dict[str, float] = {
            "hypha.serve.free_blocks": SERVE_METRICS.free_blocks(),
            "hypha.serve.queue_depth": SERVE_METRICS.queue_depth(),
            "hypha.stream.bytes_in_flight": STREAM_METRICS.bytes_in_flight(),
            "hypha.stream.overlap_fraction": STREAM_METRICS.overlap_fraction(),
        }
        het = HET_METRICS.snapshot()
        for peer, bps in het["bandwidth_bps"].items():
            gauges[f"hypha.het.bandwidth_bps.{peer}"] = float(bps)
        for peer, steps in het["assigned_steps"].items():
            gauges[f"hypha.het.assigned_steps.{peer}"] = float(steps)
        summaries: dict[str, dict] = {}
        with SERVE_METRICS._lock:
            latencies = list(SERVE_METRICS._latencies)
        # Re-ship when new requests FINISHED — judged by the histogram's
        # monotone count, never by the reservoir's length (the reservoir
        # is trimmed to a bounded window, so its length saturates while
        # traffic keeps flowing and quantiles keep moving).
        finished = self.request_count()
        if latencies and finished > self._last_reservoir:
            self._last_reservoir = finished
            summaries["hypha.serve.request_latency_ms"] = summarize(latencies)
        return counters, gauges, summaries

    @staticmethod
    def request_count() -> float:
        from .ft_metrics import SERVE_METRICS

        return float(SERVE_METRICS.request_latency_ms.snapshot()["count"])


# ---------------------------------------------------------------------------
# Reporter: one per node, pushes deltas to the collector
# ---------------------------------------------------------------------------


class MetricsReporter:
    """Periodic :class:`MetricsReport` push loop for one node.

    Failures are logged-and-dropped: the metrics plane must never stall
    or fail the data plane. ``round_fn``/``generation_fn`` late-bind the
    sender's current round / adopted scheduler generation (executors pass
    closures over their live execution state).
    """

    def __init__(
        self,
        node,
        collector_peer: str,
        job_id: str,
        peer: str | None = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        sampler: RegistrySampler | None = None,
        round_fn: Callable[[], int] | None = None,
        generation_fn: Callable[[], int | None] | None = None,
    ) -> None:
        self.node = node
        self.collector_peer = collector_peer
        self.job_id = job_id
        self.peer = peer or getattr(node, "peer_id", "node")
        self.interval_s = max(float(interval_s), 0.05)
        self.sampler = sampler or RegistrySampler(node)
        self._round_fn = round_fn or (lambda: 0)
        self._generation_fn = generation_fn or (lambda: None)
        self._seq = 0
        self._last_t: float | None = None
        self._task: asyncio.Task | None = None
        self.sent = 0
        self.dropped = 0

    def start(self) -> "MetricsReporter":
        if self._task is None:
            self._task = aio.spawn(
                self._loop(), what=f"metrics reporter {self.peer}", logger=log
            )
        return self

    async def stop(self, flush: bool = True) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            await aio.reap(task)
        if flush:
            # Final sample so a short job's tail (the last round's counters)
            # reaches the collector before the node tears down.
            await self._send_once()

    async def _loop(self) -> None:
        # First report immediately: a short job must appear in the store
        # before its first interval elapses.
        while True:
            try:
                await self._send_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # One bad sample (a racing registry mutation, a hostile
                # gauge) must not kill the loop for the rest of the job —
                # a dead reporter reads as a silent node.
                log.exception("metrics sample from %s failed", self.peer)
            await asyncio.sleep(self.interval_s)

    async def _send_once(self) -> None:
        counters, gauges, summaries = self.sampler.sample()
        gen = self._generation_fn()
        # Stamp the MEASURED window, not the nominal cadence: a busy event
        # loop (kernel builds, big transfers) delays sends, and a delta
        # divided by the nominal interval would read as a burst that never
        # happened (rates, not deltas, are what the rollups compare).
        now = time.monotonic()
        elapsed = (
            self.interval_s
            if self._last_t is None
            else max(now - self._last_t, 1e-3)
        )
        self._last_t = now
        report = MetricsReport(
            job_id=self.job_id,
            peer=self.peer,
            round=int(self._round_fn() or 0),
            seq=self._seq,
            interval_s=elapsed,
            counters=counters,
            gauges=gauges,
            summaries=summaries,
            # Stamped only once a scheduler restart actually happened
            # (generation >= 2), the durable-control-plane discipline.
            generation=gen if gen is not None and gen >= 2 else None,
        )
        self._seq += 1
        try:
            await self.node.request(
                self.collector_peer, PROTOCOL_METRICS, report, timeout=10.0
            )
            self.sent += 1
        except asyncio.CancelledError:
            raise
        except Exception as e:  # metrics must never break the data plane
            self.dropped += 1
            log.debug("metrics report from %s dropped: %s", self.peer, e)


# ---------------------------------------------------------------------------
# Collector: scheduler-side aggregation + journal + SLO evaluation
# ---------------------------------------------------------------------------

# Slow tick for silence-flavored SLO rules: wall-clock must advance the
# watchdog even when no report arrives (that absence IS the signal).
_SWEEP_INTERVAL_S = 1.0


class MetricsCollector:
    """Aggregates the fleet's reports for one job.

    ``journal_dir`` — where ``metrics-<job>.jsonl`` lands (the trace
    directory when tracing is on; None disables the journal). One JSON
    object per line: report records (round-stamped per-peer deltas),
    quality records (the loss-curve feed), and SLO breach records.
    """

    def __init__(
        self,
        node,
        job_id: str,
        store: TimeSeriesStore | None = None,
        slo_rules=None,
        journal_dir: str | Path | None = None,
        on_advisory=None,
        round_fn: Callable[[], int] | None = None,
    ) -> None:
        self.node = node
        self.job_id = job_id
        self.store = store or TimeSeriesStore()
        self._round_fn = round_fn or (lambda: 0)
        self.watchdog = SLOWatchdog(
            parse_slo_rules(slo_rules),
            self.store,
            job_id=job_id,
            on_advisory=on_advisory,
            round_fn=self._round_fn,
        )
        self.journal_path: Path | None = None
        if journal_dir is not None:
            safe = _SAFE_NODE.sub("-", str(job_id)[:8]) or "job"
            self.journal_path = Path(journal_dir) / f"metrics-{safe}.jsonl"
        self._reg = None
        self._sweep_task: asyncio.Task | None = None
        self._journal_lock = None  # created lazily on the running loop
        self._journal_tasks: set[asyncio.Task] = set()
        self.reports = 0

    # ------------------------------------------------------------- wiring
    def start(self) -> "MetricsCollector":
        # Prefix match: executors report under their per-role job ids
        # (<base>-w0, <base>-ps2 …), all children of the collector's base
        # job id. An empty collector id accepts everything (tests).
        self._reg = (
            self.node.on(PROTOCOL_METRICS, MetricsReport)
            .match(
                lambda m: not self.job_id
                or not m.job_id
                or m.job_id.startswith(self.job_id)
            )
            .respond_with(self._on_report)
        )
        self._query_reg = (
            self.node.on(PROTOCOL_METRICS, MetricsQuery)
            .match(
                lambda m: not self.job_id
                or not m.job_id
                or m.job_id.startswith(self.job_id)
            )
            .respond_with(self._on_query)
        )
        self._sweep_task = aio.spawn(
            self._sweep(), what="metrics SLO sweep", logger=log
        )
        return self

    async def close(self) -> None:
        if self._reg is not None:
            self._reg.close()
            self._reg = None
        if getattr(self, "_query_reg", None) is not None:
            self._query_reg.close()
            self._query_reg = None
        task, self._sweep_task = self._sweep_task, None
        if task is not None:
            task.cancel()
            await aio.reap(task)
        if self._journal_tasks:
            # Spawned quality-journal appends must land before the caller
            # reads the file (never cancelled: a lost record is a gap in
            # the loss curve).
            await asyncio.gather(
                *list(self._journal_tasks), return_exceptions=True
            )

    async def _sweep(self) -> None:
        while True:
            await asyncio.sleep(_SWEEP_INTERVAL_S)
            # Edge-triggered advisories fire exactly once: a breach whose
            # edge lands on the sweep (silence rules' primary path — all
            # reporters dead) must reach the journal here or nowhere.
            now = time.time()
            for rec in self._slo_records(self.watchdog.check(now), now):
                await self._journal(rec)

    # ------------------------------------------------------------- ingest
    async def _on_report(self, peer: str, report: MetricsReport) -> MetricsAck:
        t = time.time()
        label = report.peer or peer
        store = self.store
        store.note_peer(label, t)
        if report.round:
            store.note_round(report.round, t)
        interval = float(report.interval_s or 0.0)
        for name, delta in report.counters.items():
            try:
                store.record_delta(label, str(name), float(delta), interval, t)
            except (TypeError, ValueError):
                continue
        # Derived link-rate gauges from the fabric byte deltas — what the
        # fleet bandwidth rollup (and the bw-cap outlier probe) reads.
        for raw, derived in (
            ("node.bytes_out", "node.bandwidth_out_mbps"),
            ("node.bytes_in", "node.bandwidth_in_mbps"),
        ):
            delta = report.counters.get(raw)
            if delta is not None and interval > 0:
                try:
                    store.record_gauge(
                        label, derived, float(delta) * 8.0 / 1e6 / interval, t
                    )
                except (TypeError, ValueError):
                    pass
        for name, value in report.gauges.items():
            try:
                store.record_gauge(label, str(name), float(value), t)
            except (TypeError, ValueError):
                continue
        for name, summary in report.summaries.items():
            if isinstance(summary, dict):
                store.record_summary(label, str(name), summary, t)
        # Deliberately unfenced: MetricsReport.generation is an
        # observability tag, and gap-free curves across kill/rejoin are
        # the product — dropping a stale generation's report would punch
        # holes in exactly the window an operator is staring at.
        self.reports += 1
        await self._journal(
            {
                "type": "report",
                "t": t,
                "peer": label,
                "round": report.round,
                "seq": report.seq,
                # The measured window rides along so offline readers
                # (telemetry.top dir mode) reconstruct the same rates
                # and derived bandwidth gauges as the live store.
                "interval_s": interval,
                "counters": dict(report.counters),
                "gauges": dict(report.gauges),
                "summaries": dict(report.summaries),
            }
        )
        for rec in self._slo_records(self.watchdog.check(t), t):
            await self._journal(rec)
        return MetricsAck(ok=True)

    @staticmethod
    def _slo_records(advisories, t: float) -> list[dict]:
        return [
            {
                "type": "slo",
                "t": t,
                "rule": adv.rule,
                "peer": adv.peer,
                "value": adv.value,
                "threshold": adv.threshold,
                "round": adv.round,
                "breached": adv.breached,
            }
            for adv in advisories
        ]

    def ingest_quality(
        self, peer: str, round_num: int, metrics: dict
    ) -> None:
        """Round-tagged training-quality point from the progress channel
        (worker METRICS / PS UPDATED) — the loss-curve feed. Synchronous:
        called from the orchestrator's progress handler; the journal write
        is spawned off-loop."""
        t = time.time()
        self.store.note_peer(peer, t)
        self.store.note_round(round_num, t)
        clean: dict[str, float] = {}
        for name, value in (metrics or {}).items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            clean[str(name)] = v
            self.store.record_quality(peer, str(name), round_num, v)
        records: list[dict] = []
        if clean and self.journal_path is not None:
            records.append(
                {
                    "type": "quality",
                    "t": t,
                    "peer": peer,
                    "round": int(round_num),
                    **clean,
                }
            )
        # Advisories whose EDGE happens on a quality ingest (a round-wall
        # rule tripping between reports) must reach the journal too, or
        # the offline SLO state diverges from what the live watchdog saw.
        records.extend(self._slo_records(self.watchdog.check(t), t))
        for rec in records:
            if self.journal_path is None:
                break
            try:
                aio.spawn(
                    self._journal(rec),
                    tasks=self._journal_tasks,
                    what="metrics quality journal",
                    logger=log,
                )
            except RuntimeError:  # no loop (sync tests)
                self._journal_sync(rec)

    def ingest_serve_load(
        self, backend: str, queue_depth: float, free_blocks: float
    ) -> None:
        """ServeLoad heartbeat relay from a ServingSupervisor sharing this
        scheduler node — serve queue depths join the same plane."""
        t = time.time()
        self.store.record_gauge(backend, "hypha.serve.queue_depth", queue_depth, t)
        self.store.record_gauge(backend, "hypha.serve.free_blocks", free_blocks, t)

    # ------------------------------------------------------------ queries
    async def _on_query(self, peer: str, query: MetricsQuery) -> MetricsPage:
        return MetricsPage(
            job_id=self.job_id,
            round=int(self._round_fn() or 0),
            snapshot={**self.store.snapshot(), "slo": self.watchdog.state()},
        )

    # ------------------------------------------------------------ journal
    def _journal_sync(self, record: dict) -> None:
        if self.journal_path is None:
            return
        try:
            self.journal_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.journal_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record, default=str) + "\n")
        except OSError as e:
            log.warning("metrics journal write failed: %s", e)

    async def _journal(self, record: dict) -> None:
        if self.journal_path is None:
            return
        if self._journal_lock is None:
            self._journal_lock = asyncio.Lock()
        async with self._journal_lock:
            await asyncio.to_thread(self._journal_sync, record)
