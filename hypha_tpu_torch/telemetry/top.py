"""``python -m hypha_tpu_torch.telemetry.top <addr|dir>`` — live fleet view
(port of ``hypha_tpu/telemetry/top.py``, standard library only).

A terminal ``top`` for a running job: per-peer round progress, loss,
tokens/s, link bandwidth, serve queue depth / free blocks, and the SLO
state, refreshed in place.

Two sources:

  * ``<dir>``  — a directory holding the collector's
    ``metrics-<job>.jsonl`` journal (next to the trace spans). The tool
    re-reads the journal each refresh and rebuilds the same
    :class:`~hypha_tpu_torch.telemetry.series.TimeSeriesStore` view offline —
    works on a finished run or over a shared filesystem.
  * ``<addr>`` — a live scheduler's listen address. The tool dials it,
    learns the peer id, and polls
    :class:`~hypha_tpu_torch.telemetry.metrics_plane.MetricsQuery` for the
    collector's rollup snapshot (over the port's fabric; a scheduler of
    either package answers it).

``--once`` prints a single frame and exits (tests, scripting, piping);
``--json`` dumps the raw snapshot instead of the table.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import sys
import time
from pathlib import Path
from typing import Any

from .series import TimeSeriesStore

__all__ = ["snapshot_from_dir", "snapshot_from_addr", "render", "main"]


# ------------------------------------------------------------------ sources


def snapshot_from_dir(path: Path) -> dict:
    """Rebuild a store snapshot from ``metrics-*.jsonl`` journals.

    Torn tails read as clean EOF (the durable-journal rule); SLO breach
    records reconstruct the breached set as of the journal's end.
    """
    from .timeline import load_jsonl

    store = TimeSeriesStore()
    breached: dict[str, bool] = {}
    breaches = 0
    for journal in sorted(Path(path).glob("metrics-*.jsonl")):
        for rec in load_jsonl(journal):
            kind = rec.get("type")
            t = float(rec.get("t", 0) or 0)
            peer = str(rec.get("peer", "") or "")
            if kind == "report":
                store.note_peer(peer, t)
                if rec.get("round"):
                    store.note_round(int(rec["round"]), t)
                try:
                    interval = float(rec.get("interval_s", 1.0) or 1.0)
                except (TypeError, ValueError):
                    interval = 1.0
                for name, delta in (rec.get("counters") or {}).items():
                    try:
                        store.record_delta(peer, name, float(delta), interval, t)
                    except (TypeError, ValueError):
                        continue
                # Same derived link-rate gauges as the live collector, so
                # the offline table's Mb/s columns match the live view.
                for raw, derived in (
                    ("node.bytes_out", "node.bandwidth_out_mbps"),
                    ("node.bytes_in", "node.bandwidth_in_mbps"),
                ):
                    delta = (rec.get("counters") or {}).get(raw)
                    if delta is not None and interval > 0:
                        try:
                            store.record_gauge(
                                peer, derived,
                                float(delta) * 8.0 / 1e6 / interval, t,
                            )
                        except (TypeError, ValueError):
                            pass
                for name, value in (rec.get("gauges") or {}).items():
                    try:
                        store.record_gauge(peer, name, float(value), t)
                    except (TypeError, ValueError):
                        continue
                for name, summary in (rec.get("summaries") or {}).items():
                    if isinstance(summary, dict):
                        store.record_summary(peer, name, summary, t)
            elif kind == "quality":
                store.note_round(int(rec.get("round", 0) or 0), t)
                for name, value in rec.items():
                    if name in ("type", "t", "peer", "round"):
                        continue
                    try:
                        store.record_quality(
                            peer, name, int(rec.get("round", 0) or 0),
                            float(value),
                        )
                    except (TypeError, ValueError):
                        continue
            elif kind == "slo":
                key = f"{rec.get('rule')}" + (f" [{peer}]" if peer else "")
                if rec.get("breached"):
                    breached[key] = True
                    breaches += 1
                else:
                    breached.pop(key, None)
    snap = store.snapshot()
    snap["slo"] = {
        "rules": [],
        "breached": sorted(k for k, v in breached.items() if v),
        "breaches": breaches,
    }
    return snap


async def snapshot_from_addr(addr: str, timeout: float = 10.0) -> dict:
    """Dial a live scheduler and fetch the collector's snapshot."""
    from ..network import Node, TcpTransport
    from .metrics_plane import PROTOCOL_METRICS, MetricsPage, MetricsQuery

    node = Node(TcpTransport(), peer_id=f"top-{int(time.time() * 1e3) & 0xFFFF}")
    await node.start(["127.0.0.1:0"])
    try:
        peer = await node.dial(addr)
        page = await node.request(
            peer, PROTOCOL_METRICS, MetricsQuery(), timeout=timeout
        )
        if not isinstance(page, MetricsPage):
            raise RuntimeError(f"unexpected reply {type(page).__name__}")
        return dict(page.snapshot)
    finally:
        await node.stop()


# ---------------------------------------------------------------- rendering


def _fmt(v: Any, digits: int = 3) -> str:
    if v is None:
        return "-"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if math.isnan(f):
        return "-"
    if f and (abs(f) >= 10000 or abs(f) < 0.001):
        return f"{f:.2e}"
    return f"{f:.{digits}g}"


def _peer_round(snap: dict, peer: str) -> int | None:
    rounds = [
        max((int(r) for r in series), default=None)
        for metric, peers in (snap.get("quality") or {}).items()
        for p, series in peers.items()
        if p == peer and series
    ]
    rounds = [r for r in rounds if r is not None]
    return max(rounds) if rounds else None


def _weight_round(gauges: dict, peer: str):
    """Live weight streaming: the round this peer is SERVING (the
    ``hypha.serve.weight_round`` gauge). Negative = never swapped —
    dispatched params, or a peer that isn't serving at all — rendered
    blank rather than as a misleading -1."""
    v = (gauges.get(peer) or {}).get("hypha.serve.weight_round")
    return None if v is None or v < 0 else v


def render(snap: dict, now: float | None = None) -> str:
    """One frame: the per-peer table + fleet line + SLO state."""
    now = time.time() if now is None else now
    gauges: dict[str, dict[str, float]] = snap.get("gauges") or {}
    quality: dict = snap.get("quality") or {}
    last_seen: dict = snap.get("last_seen") or {}
    peers = sorted(set(gauges) | set(last_seen))
    cols = (
        ("round", lambda p: _peer_round(snap, p)),
        ("loss", lambda p: _latest_quality(quality, "loss", p)),
        ("tok/s", lambda p: _latest_quality(quality, "tokens_per_s", p)),
        ("steps", lambda p: _latest_quality(quality, "inner_steps", p)),
        ("up Mb/s", lambda p: (gauges.get(p) or {}).get("node.bandwidth_out_mbps")),
        ("down Mb/s", lambda p: (gauges.get(p) or {}).get("node.bandwidth_in_mbps")),
        ("queue", lambda p: (gauges.get(p) or {}).get("hypha.serve.queue_depth")),
        ("blocks", lambda p: (gauges.get(p) or {}).get("hypha.serve.free_blocks")),
        ("w.round", lambda p: _weight_round(gauges, p)),
        ("silent s", lambda p: (now - last_seen[p]) if p in last_seen else None),
    )
    lines: list[str] = []
    rounds = sorted(int(r) for r in (snap.get("rounds_seen") or {}))
    head = f"hypha top — {len(peers)} peers"
    if rounds:
        head += f", round {rounds[-1]}"
    lines.append(head)
    lines.append(
        f"{'peer':>10} " + " ".join(f"{name:>10}" for name, _fn in cols)
    )
    for peer in peers:
        row = [f"{peer:>10}"]
        for _name, fn in cols:
            row.append(f"{_fmt(fn(peer)):>10}")
        lines.append(" ".join(row))
    slo = snap.get("slo") or {}
    breached = slo.get("breached") or []
    if slo.get("rules"):
        lines.append(f"SLO rules: {len(slo['rules'])}")
    lines.append(
        "SLO: "
        + (
            "OK"
            if not breached
            else f"{len(breached)} BREACHED — " + "; ".join(breached)
        )
    )
    # FLEET latency quantiles: pool every peer's summary (one slow
    # backend must not be hidden behind whichever peer iterates last).
    from .series import merge_summaries

    per_peer = [
        s
        for peer_summaries in (snap.get("summaries") or {}).values()
        for s in (peer_summaries.get("hypha.serve.request_latency_ms"),)
        if s
    ]
    latency = merge_summaries(per_peer) if per_peer else None
    if latency and latency.get("count"):
        lines.append(
            "serve latency ms: "
            f"p50 {_fmt(latency.get('p50'))} "
            f"p95 {_fmt(latency.get('p95'))} "
            f"p99 {_fmt(latency.get('p99'))} "
            f"max {_fmt(latency.get('max'))}"
        )
    return "\n".join(lines)


def _latest_quality(quality: dict, metric: str, peer: str):
    series = (quality.get(metric) or {}).get(peer)
    if not series:
        return None
    return series[max(series, key=int)]


# --------------------------------------------------------------------- main


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hypha_tpu_torch.telemetry.top",
        description="Live per-peer metrics view for a running hypha job",
    )
    parser.add_argument(
        "target", help="scheduler listen address, or a metrics-journal dir"
    )
    parser.add_argument(
        "--interval", type=float, default=2.0, help="refresh seconds"
    )
    parser.add_argument(
        "--once", action="store_true", help="print one frame and exit"
    )
    parser.add_argument(
        "--json", action="store_true", help="dump the raw snapshot as JSON"
    )
    args = parser.parse_args(argv)
    target = Path(args.target)
    is_dir = target.is_dir()

    def one_frame() -> dict:
        if is_dir:
            return snapshot_from_dir(target)
        return asyncio.run(snapshot_from_addr(args.target))

    try:
        while True:
            snap = one_frame()
            if args.json:
                out = json.dumps(snap, indent=2, default=str)
            else:
                out = render(snap)
            if not args.once:
                # In-place refresh: clear + home, like top(1).
                sys.stdout.write("\x1b[2J\x1b[H")
            print(out, flush=True)
            if args.once:
                return 0
            time.sleep(max(args.interval, 0.2))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
