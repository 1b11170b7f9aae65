"""Flight recorder: a per-node bounded ring of structured events (port of
``hypha_tpu/telemetry/flight.py``).

Crash forensics for the control plane. The durable journal
(``ft/durable.py``) records *what* folded; the flight recorder records
*when* and *why late*: chaos actions, quorum drops, fabric retries,
serving preemptions, PS generation bumps — every discrete event that
explains a stalled round after the fact. Events carry BOTH a monotonic
timestamp (skew-free per-node ordering and durations) and a wall anchor
(cross-node merge by the timeline tool), plus the same attribute
vocabulary the round spans use (round / peer / fragment / shard / codec).

Recording is always on: appending a dict to a bounded deque costs
nanoseconds, so instrumentation sites never branch on config. Spilling is
what gets configured — :meth:`FlightRecorder.configure` names the node and
an optional spill directory, and the ring is written to
``events-<node>.jsonl`` there on process exit (``atexit``, which also runs
on an unhandled-exception death) and on demand via :meth:`spill`.
``python -m hypha_tpu_torch.telemetry.timeline`` merges these files with the
span files into one critical-path timeline.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import signal as _signal
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any

__all__ = ["FlightRecorder", "FLIGHT", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 4096

_SAFE_NODE = re.compile(r"[^A-Za-z0-9._-]")


def _clean(value: Any) -> Any:
    """JSON-safe attribute values; containers shallow, everything else str."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, (list, tuple, set, frozenset)):
        return [_clean(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _clean(v) for k, v in value.items()}
    return str(value)


class FlightRecorder:
    """Bounded in-memory event ring with per-node JSONL spill."""

    def __init__(
        self, capacity: int = DEFAULT_CAPACITY, node: str = "node"
    ) -> None:
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(int(capacity), 1))
        self.node = str(node)
        self.spill_dir: Path | None = None
        self._atexit_registered = False

    # ------------------------------------------------------------ config
    def configure(
        self, node: str | None = None, spill_dir: str | Path | None = None
    ) -> None:
        """Name this process's events and/or arm the exit spill."""
        with self._lock:
            if node:
                self.node = str(node)
            if spill_dir is not None:
                self.spill_dir = Path(spill_dir)
                if not self._atexit_registered:
                    self._atexit_registered = True
                    atexit.register(self._spill_quiet)

    def disarm(self) -> None:
        """Forget the spill directory: later (untraced) work in the same
        process must not have its exit events appended into an earlier
        run's trace directory. The atexit hook stays registered but
        no-ops while disarmed."""
        with self._lock:
            self.spill_dir = None

    # --------------------------------------------------------- recording
    def record(self, event: str, node: str | None = None, **attrs: Any) -> None:
        """Append one event. ``node`` overrides the process default —
        an in-process harness labels each component's events."""
        rec: dict[str, Any] = {
            "t_mono_ns": time.monotonic_ns(),
            "t_wall_ns": time.time_ns(),
            "event": str(event),
            "node": str(node) if node else self.node,
        }
        if attrs:
            rec["attrs"] = {str(k): _clean(v) for k, v in attrs.items()}
        with self._lock:
            self._ring.append(rec)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # ------------------------------------------------------------- spill
    def spill(self, spill_dir: str | Path | None = None) -> list[Path]:
        """DRAIN the ring to ``events-<node>.jsonl`` files (one per node
        label seen), appending; returns the paths written. Draining makes
        spill idempotent across the on-demand + atexit pair — the exit
        hook writes only what arrived since the last explicit spill,
        never a duplicate of it."""
        target = Path(spill_dir) if spill_dir is not None else self.spill_dir
        if target is None:
            return []
        with self._lock:
            events = list(self._ring)
            self._ring.clear()
        if not events:
            return []
        target.mkdir(parents=True, exist_ok=True)
        by_node: dict[str, list[dict]] = {}
        for rec in events:
            by_node.setdefault(rec.get("node") or "node", []).append(rec)
        written: list[Path] = []
        for node, recs in sorted(by_node.items()):
            safe = _SAFE_NODE.sub("-", node) or "node"
            path = target / f"events-{safe}.jsonl"
            with open(path, "a", encoding="utf-8") as f:
                for rec in recs:
                    f.write(json.dumps(rec, default=str) + "\n")
            written.append(path)
        return written

    def _snapshot_lockfree(self) -> list[dict]:
        """Ring copy that NEVER blocks on the recorder lock.

        The SIGUSR2 handler runs in the main thread between bytecodes —
        if the interrupted frame holds ``self._lock`` (``record`` on a
        hot path, ``spill``), acquiring it from the handler would
        deadlock the process the tool exists to diagnose. ``deque``
        appends are themselves thread-safe; a concurrent mutation during
        the copy raises RuntimeError, which the retry absorbs.
        """
        for _ in range(8):
            try:
                return list(self._ring)
            except RuntimeError:
                continue
        return []

    def dump(self, path: str | Path | None = None) -> Path | None:
        """Live capture WITHOUT draining: write the ring's current
        contents to one file and leave the ring intact.

        The wedged-node tool: unlike :meth:`spill` (which drains, so the
        exit hook stays idempotent), ``dump`` is a read-only snapshot —
        an operator can take several while the node stays stuck and each
        shows the full recent history. Default target:
        ``events-<node>-dump.jsonl`` under the spill dir (or the CWD when
        no spill dir is armed). Deliberately LOCK-FREE end to end: it is
        the signal handler's body, and the interrupted frame may hold the
        recorder lock (attribute reads are atomic under the GIL).
        """
        events = self._snapshot_lockfree()
        base = self.spill_dir
        node = self.node
        if path is None:
            safe = _SAFE_NODE.sub("-", node) or "node"
            path = (base or Path(".")) / f"events-{safe}-dump.jsonl"
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for rec in events:
                f.write(json.dumps(rec, default=str) + "\n")
        return path

    def arm_signal(self, signum: int | None = None) -> bool:
        """Install a ``SIGUSR2`` handler that :meth:`dump`\\ s the ring.

        ``kill -USR2 <pid>`` then captures a wedged node's recent events
        live — no RPC, no cooperation from the (possibly stuck) event
        loop: the handler only snapshots a deque and writes one file.
        Returns False when signals cannot be installed here (non-main
        thread, platforms without SIGUSR2) — callers treat that as a
        soft no.
        """
        if signum is None:
            signum = getattr(_signal, "SIGUSR2", None)
            if signum is None:  # platform without SIGUSR2
                return False

        def _on_signal(_signum, _frame) -> None:
            try:
                path = self.dump()
                # A signal handler can't log safely through arbitrary
                # handlers; a direct low-level write is async-signal-ish
                # enough for a diagnostics path.
                os.write(
                    2,
                    f"[flight] dumped ring to {path}\n".encode(
                        "utf-8", "replace"
                    ),
                )
            except Exception:
                pass

        try:
            _signal.signal(signum, _on_signal)
            return True
        except (ValueError, OSError):  # not the main thread
            return False

    def _spill_quiet(self) -> None:
        try:
            self.spill()
        except Exception:  # an exit hook must never mask the real exit
            pass


# The process ring every subsystem records into (chaos, retries, quorum
# drops, preemptions, generation bumps).
FLIGHT = FlightRecorder()
