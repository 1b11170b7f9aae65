"""Declarative SLO rules over the live metrics plane (port of
``hypha_tpu/telemetry/slo.py``).

A rule is one line of text — the shape node_config's ``slo_rules`` list
and the docs teach:

    serve.request_latency_ms.p99 <= 250
    round_wall_s <= 30
    hypha.het.quorum_drops == 0
    silent_s <= 15
    node.bandwidth_out_mbps >= 0.5 @peer

Grammar: ``<metric>[.<agg>] <op> <threshold> [@peer|@fleet]``.

  * ``metric`` — a gauge/counter family in the
    :class:`~hypha_tpu_torch.telemetry.series.TimeSeriesStore` (counters are
    evaluated on their CUMULATIVE total), one of the derived series
    (``round_wall_s``, ``silent_s``), or a summary family with a
    quantile ``agg`` (``p50``/``p95``/``p99``/``max``).
  * ``op`` — ``<= < >= > ==``; the rule HOLDS while the comparison is
    true and BREACHES when it is not.
  * scope — ``@fleet`` (default) evaluates one rolled-up value
    (sum for counters, quantile-merge for summaries, max for gauges);
    ``@peer`` evaluates every reporting peer separately and names the
    offender. ``silent_s`` is always per-peer.

Breaches are edge-triggered: :class:`SLOWatchdog` fires once per
``(rule, peer)`` on entry, records a ``slo.breach`` flight event, and
re-arms when the rule holds again (``slo.recovered``). Enforcement is
deliberately out of scope — the watchdog emits
:class:`SLOAdvisory` values for the orchestrator to log, the same
advisory-not-actuator posture as ``RoundMembership`` snapshots.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field

from ..messages import _register, declare_values
from .flight import FLIGHT
from .series import TimeSeriesStore

__all__ = [
    "SLORule",
    "SLOAdvisory",
    "SLOWatchdog",
    "parse_slo_rule",
    "parse_slo_rules",
]

log = logging.getLogger("hypha.telemetry.slo")

_OPS = {
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "==": lambda a, b: a == b,
}
_AGGS = ("p50", "p95", "p99", "max", "sum", "last")
_DERIVED = ("round_wall_s", "silent_s")


@dataclass(slots=True)
class SLORule:
    """One parsed objective (see module docstring for the text grammar)."""

    name: str
    metric: str
    op: str
    threshold: float
    agg: str = ""  # "" = default per metric kind
    scope: str = "fleet"  # "fleet" | "peer"

    def holds(self, value: float) -> bool:
        if value is None or (isinstance(value, float) and math.isnan(value)):
            return True  # no data is not a breach; silence has its own rule
        return _OPS[self.op](float(value), self.threshold)

    def text(self) -> str:
        agg = f".{self.agg}" if self.agg else ""
        scope = " @peer" if self.scope == "peer" else ""
        return f"{self.metric}{agg} {self.op} {self.threshold:g}{scope}"


@_register
@dataclass(slots=True)
class SLOAdvisory:
    """The watchdog's breach notice — logged by the orchestrator, never
    enforced (the RoundMembership posture: an agreed observation, with
    actuation left to a future PR). ``round`` is the scheduler round the
    breach was observed at, so advisories order against the run."""

    job_id: str = ""
    rule: str = ""
    metric: str = ""
    peer: str = ""  # "" = fleet scope
    value: float = 0.0
    threshold: float = 0.0
    round: int = 0
    breached: bool = True  # False = recovery notice


declare_values("SLOAdvisory")


def parse_slo_rule(text: str) -> SLORule:
    """Parse one ``<metric>[.<agg>] <op> <value> [@scope]`` line."""
    raw = text.strip()
    scope = "fleet"
    if raw.endswith("@peer"):
        scope, raw = "peer", raw[: -len("@peer")].strip()
    elif raw.endswith("@fleet"):
        raw = raw[: -len("@fleet")].strip()
    op = None
    for candidate in ("<=", ">=", "==", "<", ">"):
        if candidate in raw:
            op = candidate
            break
    if op is None:
        raise ValueError(f"SLO rule {text!r}: no comparison operator")
    lhs, _, rhs = raw.partition(op)
    lhs = lhs.strip()
    try:
        threshold = float(rhs.strip())
    except ValueError:
        raise ValueError(f"SLO rule {text!r}: bad threshold {rhs.strip()!r}") from None
    agg = ""
    metric = lhs
    head, dot, tail = lhs.rpartition(".")
    if dot and tail in _AGGS:
        metric, agg = head, tail
    if not metric:
        raise ValueError(f"SLO rule {text!r}: empty metric")
    if metric == "silent_s":
        scope = "peer"
    return SLORule(
        name=raw, metric=metric, op=op, threshold=threshold, agg=agg,
        scope=scope,
    )


def parse_slo_rules(texts) -> list[SLORule]:
    return [parse_slo_rule(t) for t in (texts or []) if str(t).strip()]


class SLOWatchdog:
    """Evaluates rules against a :class:`TimeSeriesStore`; edge-triggered.

    ``check()`` is cheap (dict reads over latest values) and is run by the
    collector after every ingested report plus on a slow periodic tick
    (silence rules need wall-clock to advance even when nothing reports).
    """

    def __init__(
        self,
        rules: list[SLORule],
        store: TimeSeriesStore,
        job_id: str = "",
        on_advisory=None,
        round_fn=None,
    ) -> None:
        self.rules = list(rules)
        self.store = store
        self.job_id = job_id
        self.on_advisory = on_advisory
        self._round_fn = round_fn or (lambda: 0)
        self._breached: set[tuple[str, str]] = set()
        self.breaches = 0  # total breach edges (observability/tests)

    # ------------------------------------------------------------ values
    def _values(self, rule: SLORule, now: float) -> dict[str, float]:
        """scope key ("" = fleet) -> value to compare."""
        store = self.store
        if rule.metric == "silent_s":
            return {
                p: store.silent_for(p, now)
                for p in store.peers()
                if store.last_seen(p) is not None
            }
        if rule.metric == "round_wall_s":
            walls = store.round_walls()
            # The OPEN round's age counts too: a hung round (quorum wedge,
            # dead PS) never produces its completed-gap sample, and the
            # watchdog exists precisely for that case — compare the larger
            # of the last completed wall and the current round's age.
            open_age = store.open_round_age(now)
            last_wall = walls[max(walls)] if walls else 0.0
            if not walls and open_age <= 0.0:
                return {}
            return {"": max(last_wall, open_age)}
        if rule.agg in ("p50", "p95", "p99", "max"):
            if rule.scope == "peer":
                summaries = store.snapshot()["summaries"]
                return {
                    peer: float(s[rule.agg])
                    for peer, metrics in summaries.items()
                    for s in (metrics.get(rule.metric),)
                    if s and s.get(rule.agg) is not None
                }
            merged = store.fleet_quantiles(rule.metric)
            if merged.get("count", 0) > 0 and merged.get(rule.agg) is not None:
                return {"": float(merged[rule.agg])}
            if rule.agg == "max":
                # No summary family under this name: fall through to the
                # gauge rollups (a "<gauge>.max <= X" rule stays usable).
                pass
            else:
                return {}
        per_peer = store.fleet_last(rule.metric)
        if not per_peer:
            return {}
        if rule.scope == "peer":
            return dict(per_peer)
        if rule.agg == "sum":
            return {"": float(sum(per_peer.values()))}
        cumulative = store.fleet_cumulative(rule.metric)
        if cumulative and rule.agg in ("", "last") and rule.op == "==":
            # Counter-flavored equality rules (quorum_drops == 0) read the
            # cumulative total, not the latest per-interval rate.
            return {"": cumulative}
        return {"": float(max(per_peer.values()))}

    # ------------------------------------------------------------- check
    def check(self, now: float | None = None) -> list[SLOAdvisory]:
        now = time.time() if now is None else now
        advisories: list[SLOAdvisory] = []
        for rule in self.rules:
            for peer, value in self._values(rule, now).items():
                key = (rule.name, peer)
                ok = rule.holds(value)
                if not ok and key not in self._breached:
                    self._breached.add(key)
                    self.breaches += 1
                    adv = self._advise(rule, peer, value, breached=True)
                    advisories.append(adv)
                elif ok and key in self._breached:
                    self._breached.discard(key)
                    advisories.append(
                        self._advise(rule, peer, value, breached=False)
                    )
        return advisories

    def _advise(
        self, rule: SLORule, peer: str, value: float, breached: bool
    ) -> SLOAdvisory:
        adv = SLOAdvisory(
            job_id=self.job_id,
            rule=rule.text(),
            metric=rule.metric,
            peer=peer,
            value=float(value) if math.isfinite(value) else -1.0,
            threshold=rule.threshold,
            round=int(self._round_fn() or 0),
            breached=breached,
        )
        FLIGHT.record(
            "slo.breach" if breached else "slo.recovered",
            rule=adv.rule, metric=adv.metric, peer=adv.peer,
            value=adv.value, threshold=adv.threshold, round=adv.round,
            job=adv.job_id,
        )
        (log.warning if breached else log.info)(
            "SLO %s: %s %s (value %.6g vs %s %g)%s",
            "breach" if breached else "recovered",
            adv.rule, f"peer={peer}" if peer else "fleet",
            adv.value, rule.op, rule.threshold,
            " — advisory only, enforcement is future work" if breached else "",
        )
        if self.on_advisory is not None:
            try:
                self.on_advisory(adv)
            except Exception:  # advisories must never break ingest
                log.exception("SLO advisory callback failed")
        return adv

    def state(self) -> dict:
        """JSON-safe view for ``telemetry.top`` / MetricsQuery."""
        return {
            "rules": [r.text() for r in self.rules],
            "breached": sorted(
                f"{name}{f' [{peer}]' if peer else ''}"
                for name, peer in self._breached
            ),
            "breaches": self.breaches,
        }
