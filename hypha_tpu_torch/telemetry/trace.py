"""Cross-peer round tracing: the Dapper-style span plane for outer rounds
(port of ``hypha_tpu/telemetry/trace.py``).

A DiLoCo outer round is a distributed request — scheduler opens the round,
workers run ``inner_steps`` → ``encode`` → ``upload``, the parameter server
runs ``fold`` / ``quorum_wait`` / ``outer_step`` / ``broadcast``, workers
``merge`` — and this module is the propagation fabric that lets every node
file its spans under ONE trace per round:

  * the scheduler's per-round root span context travels as a
    ``<trace_id>-<parent_span_id>`` string (:data:`~hypha_tpu_torch.messages.
    TRACEPARENT_KEY`) inside SCHEDULE_UPDATE responses, fabric push
    headers, and the round-tagged protocol messages — all None/absent by
    default, so tracing OFF ships today's exact wire bytes;
  * every node appends finished spans to ``spans-<node>.jsonl`` under the
    shared trace directory (one JSON object per line, wall + monotonic
    timestamps, the round/fragment/shard/peer/codec attribute vocabulary);
  * ``python -m hypha_tpu_torch.telemetry.timeline <dir>`` merges the files,
    realigns per-node clocks on round anchors, and prints the per-round
    critical path.

The recorder is deliberately NOT the OTLP tracer in ``telemetry/__init__``:
that one is contextvar-scoped to ``with`` blocks on one thread, while round
spans here begin on one call path and finish on another (a collect loop, a
flight thread) and must serialize to per-node files for offline merge.
Records are file-backed so a crashed node's spans survive for forensics —
the complement of the flight recorder's in-memory ring.

Process-global switch: :func:`enable` (harnesses, tests) or the
``HYPHA_TRACE_DIR`` / ``HYPHA_TRACE_NODE`` environment (executor
subprocesses inherit tracing through their environment). Disabled, every
helper is a cheap no-op returning ``None`` — instrumentation sites never
branch on config themselves.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, IO

from ..messages import TRACEPARENT_KEY
from . import _rand_id
from .flight import _SAFE_NODE

__all__ = [
    "TRACEPARENT_KEY",
    "TraceSpan",
    "NodeTracing",
    "parse_traceparent",
    "enable",
    "disable",
    "active",
    "begin",
    "finish",
    "span",
    "inject",
    "traceparent_of",
    "reparent",
]

# Span names the round trace vocabulary uses (the reference's list):
# scheduler root; worker compute/ship/merge; PS aggregate/step/fan-out;
# serving route/prefill/decode. Kept here so the timeline tool and the
# docs share one list.
ROUND_SPANS = (
    "round",
    "inner_steps",
    "encode",
    "upload",
    "fold",
    "quorum_wait",
    "outer_step",
    "broadcast",
    "merge",
)
SERVE_SPANS = ("route", "prefill", "decode")

# One id generator for the whole telemetry package: os.urandom, NOT the
# global random module — deterministic chaos runs seed the global RNG,
# and seeded ids would collide across nodes in one merged timeline.
_rand_hex = _rand_id


def parse_traceparent(value: Any) -> tuple[str, str] | None:
    """``"<32-hex trace id>-<16-hex span id>"`` → the pair, else None.

    Malformed values (wrong length, non-hex, non-string — e.g. a peer
    running a different build) are treated as absent, never an error: a
    bad trace context must not break the data plane.
    """
    if not isinstance(value, str):
        return None
    trace_id, sep, span_id = value.partition("-")
    if not sep or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id


@dataclass(slots=True)
class TraceSpan:
    """One round-trace span; finished spans serialize to the node file."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    node: str
    start_ns: int  # wall clock (time.time_ns)
    start_mono_ns: int  # monotonic (per-node skew-free durations)
    attributes: dict[str, Any] = field(default_factory=dict)
    end_ns: int | None = None
    end_mono_ns: int | None = None
    status_ok: bool = True

    @property
    def traceparent(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def to_record(self) -> dict:
        return {
            "node": self.node,
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns if self.end_ns is not None else self.start_ns,
            "mono_start_ns": self.start_mono_ns,
            "mono_end_ns": (
                self.end_mono_ns
                if self.end_mono_ns is not None
                else self.start_mono_ns
            ),
            "ok": self.status_ok,
            "attrs": self.attributes,
        }


class NodeTracing:
    """Span recorder for one trace directory.

    Thread-safe: spans begin/finish from the event loop, training threads
    and stream flight threads alike. Each span is written as one line at
    finish time with an immediate flush, so a crash loses at most the
    spans still open — and a torn final line, which the timeline merger
    tolerates as clean EOF (the durable journal's torn-tail rule).

    ``node`` is the default identity stamped on spans; per-span overrides
    exist because an in-process harness runs every role in one
    process and each component labels its own spans (scheduler / psw / w0…).
    """

    def __init__(self, trace_dir: str | Path, node: str = "node") -> None:
        self.trace_dir = Path(trace_dir)
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        self.node = str(node)
        self._lock = threading.Lock()
        self._files: dict[str, IO[str]] = {}
        self._closed = False

    # ------------------------------------------------------------- spans
    def begin(
        self,
        name: str,
        parent: "TraceSpan | str | None" = None,
        attrs: dict | None = None,
        node: str | None = None,
    ) -> TraceSpan:
        """Open a span. ``parent`` is a local span, a wire traceparent
        string, or None (starts a fresh trace)."""
        if isinstance(parent, TraceSpan):
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            parsed = parse_traceparent(parent)
            if parsed is not None:
                trace_id, parent_id = parsed
            else:
                trace_id, parent_id = _rand_hex(16), None
        return TraceSpan(
            name=name,
            trace_id=trace_id,
            span_id=_rand_hex(8),
            parent_id=parent_id,
            node=str(node) if node else self.node,
            start_ns=time.time_ns(),
            start_mono_ns=time.monotonic_ns(),
            attributes=dict(attrs or {}),
        )

    def finish(self, span: TraceSpan, ok: bool = True) -> TraceSpan:
        span.end_ns = time.time_ns()
        span.end_mono_ns = time.monotonic_ns()
        span.status_ok = span.status_ok and ok
        self._write(span)
        return span

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        parent: "TraceSpan | str | None" = None,
        attrs: dict | None = None,
        node: str | None = None,
    ):
        s = self.begin(name, parent=parent, attrs=attrs, node=node)
        try:
            yield s
        except BaseException:
            s.status_ok = False
            raise
        finally:
            self.finish(s)

    # --------------------------------------------------------------- io
    def _write(self, span: TraceSpan) -> None:
        line = json.dumps(span.to_record(), default=str) + "\n"
        with self._lock:
            if self._closed:
                return
            f = self._files.get(span.node)
            if f is None:
                safe = _SAFE_NODE.sub("-", span.node) or "node"
                path = self.trace_dir / f"spans-{safe}.jsonl"
                f = open(path, "a", encoding="utf-8")
                self._files[span.node] = f
            f.write(line)
            f.flush()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for f in self._files.values():
                try:
                    f.close()
                except OSError:
                    pass
            self._files.clear()


# ---------------------------------------------------------------------------
# Process-global switch
# ---------------------------------------------------------------------------

_ACTIVE: NodeTracing | None = None
_ENV_CHECKED = False
_STATE_LOCK = threading.Lock()


def enable(trace_dir: str | Path, node: str = "node") -> NodeTracing:
    """Turn tracing on for this process, writing under ``trace_dir``."""
    global _ACTIVE, _ENV_CHECKED
    with _STATE_LOCK:
        if _ACTIVE is not None:
            _ACTIVE.close()
        _ACTIVE = NodeTracing(trace_dir, node)
        _ENV_CHECKED = True
        return _ACTIVE


def disable() -> None:
    global _ACTIVE, _ENV_CHECKED
    with _STATE_LOCK:
        if _ACTIVE is not None:
            _ACTIVE.close()
        _ACTIVE = None
        _ENV_CHECKED = True  # an explicit disable wins over the env


def _reset_for_tests() -> None:
    """Forget the cached env decision so monkeypatched env is re-read."""
    global _ACTIVE, _ENV_CHECKED
    with _STATE_LOCK:
        if _ACTIVE is not None:
            _ACTIVE.close()
        _ACTIVE = None
        _ENV_CHECKED = False


def active() -> NodeTracing | None:
    """The process recorder, or None when tracing is off (the default).

    The environment is consulted once: ``HYPHA_TRACE_DIR`` turns tracing
    on (``HYPHA_TRACE_NODE`` names this process's spans), which is how the
    process train executor's trainers inherit tracing.
    """
    global _ACTIVE, _ENV_CHECKED
    if _ENV_CHECKED:
        return _ACTIVE
    with _STATE_LOCK:
        if not _ENV_CHECKED:
            trace_dir = os.environ.get("HYPHA_TRACE_DIR")
            if trace_dir:
                _ACTIVE = NodeTracing(
                    trace_dir,
                    os.environ.get("HYPHA_TRACE_NODE", f"pid{os.getpid()}"),
                )
            _ENV_CHECKED = True
    return _ACTIVE


# ------------------------------------------------------------ no-op helpers


def begin(
    name: str,
    parent: "TraceSpan | str | None" = None,
    attrs: dict | None = None,
    node: str | None = None,
) -> TraceSpan | None:
    """Open a span iff tracing is on; None otherwise (pass to finish)."""
    t = active()
    if t is None:
        return None
    return t.begin(name, parent=parent, attrs=attrs, node=node)


def finish(span: "TraceSpan | None", ok: bool = True) -> None:
    if span is None:
        return
    t = active()
    if t is not None:
        t.finish(span, ok=ok)


@contextlib.contextmanager
def span(
    name: str,
    parent: "TraceSpan | str | None" = None,
    attrs: dict | None = None,
    node: str | None = None,
):
    """Context-managed span; yields None (and records nothing) when off."""
    t = active()
    if t is None:
        yield None
        return
    with t.span(name, parent=parent, attrs=attrs, node=node) as s:
        yield s


def inject(header: dict, context: "TraceSpan | str | None") -> dict:
    """Stamp a trace context into a push/broadcast header, in place.

    ``context`` None (tracing off, or no round context yet) leaves the
    header untouched — no new key, today's exact wire bytes.
    """
    if context is None:
        return header
    header[TRACEPARENT_KEY] = (
        context.traceparent if isinstance(context, TraceSpan) else str(context)
    )
    return header


def traceparent_of(span: "TraceSpan | None") -> str | None:
    return span.traceparent if span is not None else None


def reparent(span: "TraceSpan | None", context: "TraceSpan | str | None") -> None:
    """Late-bind an UNFINISHED, still-parentless span into a trace.

    The parameter server's quorum_wait span opens before any push of the
    round has arrived; the first delta's header then names the round's
    trace. Spans serialize at finish, so rewriting the ids before that is
    safe. A span that already has a parent keeps it.
    """
    if span is None or span.parent_id is not None:
        return
    parsed = parse_traceparent(
        context.traceparent if isinstance(context, TraceSpan) else context
    )
    if parsed is not None:
        span.trace_id, span.parent_id = parsed
