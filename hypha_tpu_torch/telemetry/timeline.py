"""Round timeline: merge per-node span/event files into a critical path
(port of ``hypha_tpu/telemetry/timeline.py``).

``python -m hypha_tpu_torch.telemetry.timeline <dir>`` reads every
``spans-<node>.jsonl`` (hypha_tpu_torch.telemetry.trace) and
``events-<node>.jsonl`` (hypha_tpu_torch.telemetry.flight) under ``dir``, aligns
per-node wall clocks on round-boundary anchors, and prints a per-round
critical-path breakdown — compute / encode / upload / quorum-wait / outer /
broadcast / merge, with the straggler peer named — as text, plus a machine
JSON (``--json <path>``, or ``timeline.json`` in the directory). The same
merge can be exported as OTLP JSON (:func:`to_otlp`) for any OTEL-native
viewer.

Clock alignment: per-node offsets cannot come from the wall stamps alone
(nodes skew by seconds in the deployments this repo targets), but round
boundaries are causal anchors — no node's round-``r`` span can START before
the scheduler's round-``r`` root span opened. For each non-reference node
the offset is the minimum over shared rounds of (node's earliest round-r
span start − scheduler's round-r start): the tightest round pins the skew
(up to that round's genuine scheduling lag, milliseconds on the links that
matter), and the min keeps every other round causally consistent. Offsets
shift only cross-node ordering and stall attribution; phase DURATIONS come
from each node's own clock and never change under alignment.

Torn tails: a crashed node's last line may be half-written. Like the
durable journal's recovery rule, a record that fails to decode ends that
file's read as clean EOF — everything before it is used.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Any

__all__ = [
    "load_jsonl",
    "load_dir",
    "align_offsets",
    "build_timeline",
    "to_otlp",
    "render_text",
    "main",
]

# Span name -> headline phase in the per-round breakdown. ``fold`` folds
# into the aggregate row but is reported separately (it overlaps
# quorum_wait by construction).
PHASES = (
    "compute",
    "input_wait",
    "encode",
    "upload",
    "quorum_wait",
    "outer",
    "broadcast",
    "merge",
)
_SPAN_PHASE = {
    "inner_steps": "compute",
    # Input-pipeline stall (executor.dataset): the training thread blocked
    # on a slice acquisition mid-round. Peer-attributed, so a data-starved
    # worker is named on the round's critical path like a slow uploader.
    "input_wait": "input_wait",
    "encode": "encode",
    "upload": "upload",
    "quorum_wait": "quorum_wait",
    "outer_step": "outer",
    "broadcast": "broadcast",
    "merge": "merge",
}


def load_jsonl(path: str | Path) -> list[dict]:
    """Read one JSONL file, treating the first undecodable record as EOF
    (torn tail after a crash — same rule as the durable journal)."""
    out: list[dict] = []
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break  # torn tail: everything before it stands
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return []
    return out


def _is_span(rec: dict) -> bool:
    """Span-shaped: a name plus a numeric start. Anything else in a
    spans file (a metrics journal dropped under the wrong name, a foreign
    build's records) is skipped with a warning instead of crashing the
    merge downstream."""
    return isinstance(rec.get("name"), str) and isinstance(
        rec.get("start_ns"), (int, float)
    )


def load_dir(trace_dir: str | Path) -> tuple[list[dict], list[dict]]:
    """(spans, events) merged from every per-node file under the dir.

    Resilient by design: the trace directory is shared with the flight
    recorder's ``events-*.jsonl`` AND the metrics plane's
    ``metrics-*.jsonl`` journal — only span/event files are read, and a
    non-span record inside a spans file is skipped with a warning. A peer
    that has events but no spans file (it crashed before its first span
    flushed, or ran untraced) merges fine: its events still appear in the
    tail, it just contributes no phases.
    """
    trace_dir = Path(trace_dir)
    spans: list[dict] = []
    events: list[dict] = []
    for path in sorted(trace_dir.glob("spans-*.jsonl")):
        recs = load_jsonl(path)
        good = [r for r in recs if _is_span(r)]
        if len(good) != len(recs):
            print(
                f"[timeline] {path.name}: skipped {len(recs) - len(good)} "
                "non-span records",
                file=sys.stderr,
            )
        spans.extend(good)
    for path in sorted(trace_dir.glob("events-*.jsonl")):
        events.extend(load_jsonl(path))
    span_nodes = {s.get("node") or "node" for s in spans}
    event_nodes = {e.get("node") or "node" for e in events}
    missing = sorted(event_nodes - span_nodes)
    if spans and missing:
        print(
            f"[timeline] no spans for peer(s) {', '.join(missing)} "
            "(crashed before flushing, or untraced) — events merged, "
            "phases skipped",
            file=sys.stderr,
        )
    return spans, events


def _round_of(rec: dict) -> int | None:
    attrs = rec.get("attrs") or {}
    try:
        return int(attrs["round"]) if "round" in attrs else None
    except (TypeError, ValueError):
        return None


def _dur_s(rec: dict) -> float:
    """Span duration from the node's OWN clock (monotonic when present)."""
    m0, m1 = rec.get("mono_start_ns"), rec.get("mono_end_ns")
    if isinstance(m0, (int, float)) and isinstance(m1, (int, float)) and m1 >= m0:
        return (m1 - m0) / 1e9
    try:
        return max(
            (int(rec.get("end_ns", 0)) - int(rec.get("start_ns", 0))) / 1e9, 0.0
        )
    except (TypeError, ValueError):
        return 0.0


def reference_node(spans: list[dict]) -> str | None:
    """The node owning the per-round root spans (the scheduler), falling
    back to the node with the most spans."""
    roots = [s for s in spans if s.get("name") == "round"]
    if roots:
        return roots[0].get("node")
    counts: dict[str, int] = defaultdict(int)
    for s in spans:
        counts[s.get("node") or "node"] += 1
    return max(counts, key=counts.get) if counts else None


def align_offsets(
    spans: list[dict], ref: str | None = None
) -> dict[str, float]:
    """Per-node wall-clock offsets (seconds to ADD to a node's wall stamps).

    Anchored on round boundaries (module docstring); the reference node's
    offset is 0. Nodes sharing no round with the reference stay at 0.
    """
    ref = ref or reference_node(spans)
    offsets: dict[str, float] = {}
    if ref is None:
        return offsets
    ref_round_start: dict[int, int] = {}
    for s in spans:
        if s.get("node") == ref and s.get("name") == "round":
            r = _round_of(s)
            if r is not None:
                start = int(s.get("start_ns", 0))
                prev = ref_round_start.get(r)
                ref_round_start[r] = start if prev is None else min(prev, start)
    first_start: dict[str, dict[int, int]] = defaultdict(dict)
    for s in spans:
        node = s.get("node") or "node"
        if node == ref:
            continue
        r = _round_of(s)
        if r is None or r not in ref_round_start:
            continue
        start = int(s.get("start_ns", 0))
        prev = first_start[node].get(r)
        first_start[node][r] = start if prev is None else min(prev, start)
    offsets[ref] = 0.0
    for node, per_round in first_start.items():
        deltas = [
            (start - ref_round_start[r]) / 1e9 for r, start in per_round.items()
        ]
        # min: the tightest round pins the skew while keeping every round
        # causally consistent (no span realigned before its round opened).
        offsets[node] = -min(deltas) if deltas else 0.0
    return offsets


def build_timeline(trace_dir: str | Path) -> dict:
    """Merge a trace directory into the per-round critical-path breakdown."""
    spans, events = load_dir(trace_dir)
    ref = reference_node(spans)
    offsets = align_offsets(spans, ref)

    by_round: dict[int, list[dict]] = defaultdict(list)
    for s in spans:
        r = _round_of(s)
        if r is not None:
            by_round[r].append(s)

    rounds: list[dict] = []
    for r in sorted(by_round):
        recs = by_round[r]
        phases: dict[str, float] = {p: 0.0 for p in PHASES}
        phase_holder: dict[str, str | None] = {p: None for p in PHASES}
        uploads: list[tuple[float, str | None]] = []
        # The stall: the longest PEER-ATTRIBUTED span of the round — the
        # single "who was slow, doing what" answer. Container spans
        # (quorum_wait spans the collect window, broadcast spans the whole
        # fan-out) name no peer and are excluded; upload / fold / compute /
        # encode / merge spans each name one.
        stall: tuple[float, str | None, str | None] = (0.0, None, None)
        fold_s = 0.0
        wall = None
        for s in recs:
            name = s.get("name")
            dur = _dur_s(s)
            attrs = s.get("attrs") or {}
            peer = attrs.get("peer") or s.get("node")
            if name == "round":
                wall = dur if wall is None else max(wall, dur)
                continue
            if name == "fold":
                fold_s += dur
                if dur > stall[0]:
                    stall = (dur, name, peer)
                continue
            phase = _SPAN_PHASE.get(name or "")
            if phase is None:
                continue
            if phase == "upload":
                uploads.append((dur, peer))
            if phase not in ("quorum_wait", "broadcast", "outer") and dur > stall[0]:
                stall = (dur, name, peer)
            if dur > phases[phase]:
                phases[phase] = dur
                phase_holder[phase] = peer
        if wall is None:
            # No root span for the round (scheduler untraced): bound it by
            # the aligned extent of the round's spans.
            lo, hi = None, None
            for s in recs:
                off = offsets.get(s.get("node") or "node", 0.0)
                s0 = int(s.get("start_ns", 0)) / 1e9 + off
                end = s.get("end_ns")
                if not isinstance(end, (int, float)):  # foreign/torn record
                    end = s.get("start_ns", 0)
                s1 = int(end) / 1e9 + off
                lo = s0 if lo is None else min(lo, s0)
                hi = s1 if hi is None else max(hi, s1)
            wall = (hi - lo) if lo is not None and hi is not None else 0.0
        uploads.sort(reverse=True, key=lambda t: t[0])
        straggler = uploads[0][1] if uploads else None
        dominant = max(PHASES, key=lambda p: phases[p])
        rounds.append(
            {
                "round": r,
                "wall_s": round(wall, 6),
                "phases_s": {p: round(v, 6) for p, v in phases.items()},
                "phase_peers": phase_holder,
                "fold_s": round(fold_s, 6),
                "dominant": dominant,
                "dominant_peer": phase_holder[dominant],
                "stall_s": round(stall[0], 6),
                "stall_span": stall[1],
                "stall_peer": stall[2],
                "straggler": straggler,
                "upload_s_max": round(uploads[0][0], 6) if uploads else 0.0,
                "upload_s_second": (
                    round(uploads[1][0], 6) if len(uploads) > 1 else 0.0
                ),
                "spans": len(recs),
            }
        )
    # The tail is what explains the last stall — but events arrive as one
    # FILE per node, so chronological order needs a sort (aligned wall
    # time), not file concatenation order.
    events_by_time = sorted(
        events,
        key=lambda e: (
            int(e.get("t_wall_ns", 0)) / 1e9
            + offsets.get(e.get("node") or "node", 0.0)
        ),
    )
    return {
        "reference_node": ref,
        "clock_offsets_s": {n: round(o, 6) for n, o in offsets.items()},
        "rounds": rounds,
        "num_spans": len(spans),
        "num_events": len(events),
        "events": events_by_time[-64:],
    }


def to_otlp(spans: list[dict], resource: dict | None = None) -> dict:
    """Merged span records → OTLP/JSON ``resourceSpans`` (one scope per
    node), ingestible by any OTEL collector/viewer."""
    from .otlp import _attr_list

    by_node: dict[str, list[dict]] = defaultdict(list)
    for s in spans:
        by_node[s.get("node") or "node"].append(s)
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": _attr_list(
                        resource or {"service.name": "hypha"}
                    )
                },
                "scopeSpans": [
                    {
                        "scope": {"name": f"hypha.node.{node}"},
                        "spans": [
                            {
                                "traceId": s.get("trace_id", ""),
                                "spanId": s.get("span_id", ""),
                                **(
                                    {"parentSpanId": s["parent_id"]}
                                    if s.get("parent_id")
                                    else {}
                                ),
                                "name": s.get("name", ""),
                                "kind": 1,
                                "startTimeUnixNano": str(s.get("start_ns", 0)),
                                "endTimeUnixNano": str(
                                    s.get("end_ns", s.get("start_ns", 0))
                                ),
                                "attributes": _attr_list(s.get("attrs") or {}),
                                "status": {
                                    "code": 1 if s.get("ok", True) else 2
                                },
                            }
                            for s in node_spans
                        ],
                    }
                    for node, node_spans in sorted(by_node.items())
                ],
            }
        ]
    }


def render_text(timeline: dict) -> str:
    """The human critical-path table."""
    lines: list[str] = []
    offs = timeline.get("clock_offsets_s", {})
    lines.append(
        f"timeline: {timeline.get('num_spans', 0)} spans, "
        f"{timeline.get('num_events', 0)} events, "
        f"reference node {timeline.get('reference_node')!r}"
    )
    skewed = {n: o for n, o in offs.items() if abs(o) > 0.001}
    if skewed:
        lines.append(
            "clock offsets applied: "
            + ", ".join(f"{n}{o:+.3f}s" for n, o in sorted(skewed.items()))
        )
    header = (
        f"{'round':>5} {'wall':>8} "
        + " ".join(f"{p:>11}" for p in PHASES)
        + "  dominant (peer)"
    )
    lines.append(header)
    for row in timeline.get("rounds", []):
        phases = row["phases_s"]
        peer = row.get("dominant_peer") or row.get("straggler") or "-"
        lines.append(
            f"{row['round']:>5} {row['wall_s']:>7.3f}s "
            + " ".join(f"{phases[p]:>10.3f}s" for p in PHASES)
            + f"  {row['dominant']} ({peer})"
        )
        if row.get("stall_span"):
            lines.append(
                f"{'':>5} stall: {row['stall_span']} by {row['stall_peer']} "
                f"({row['stall_s']:.3f}s); slowest upload "
                f"{row['upload_s_max']:.3f}s by {row.get('straggler')} "
                f"(next {row['upload_s_second']:.3f}s)"
            )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hypha_tpu_torch.telemetry.timeline",
        description="Merge per-node trace files into a round critical path",
    )
    parser.add_argument("trace_dir", help="directory of spans-*/events-*.jsonl")
    parser.add_argument(
        "--json",
        default=None,
        help="write the machine timeline here (default <dir>/timeline.json; "
        "'-' for stdout)",
    )
    parser.add_argument(
        "--otlp",
        default=None,
        help="also write the merged spans as OTLP JSON to this path",
    )
    args = parser.parse_args(argv)
    trace_dir = Path(args.trace_dir)
    if not trace_dir.is_dir():
        print(f"not a directory: {trace_dir}", file=sys.stderr)
        return 2
    timeline = build_timeline(trace_dir)
    print(render_text(timeline))
    out = args.json or str(trace_dir / "timeline.json")
    if out == "-":
        print(json.dumps(timeline, indent=2))
    else:
        Path(out).write_text(json.dumps(timeline, indent=2) + "\n")
        print(f"wrote {out}", file=sys.stderr)
    if args.otlp:
        spans, _events = load_dir(trace_dir)
        Path(args.otlp).write_text(json.dumps(to_otlp(spans)) + "\n")
        print(f"wrote {args.otlp}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
