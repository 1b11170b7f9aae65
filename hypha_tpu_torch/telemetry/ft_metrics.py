"""Fault-tolerance, streaming, sharding, serving, heterogeneity, scale and
input-pipeline instruments: the process-global shared bundles (port of
``hypha_tpu/telemetry/ft_metrics.py``, standard library only).

Every component records into its bundle (:data:`FT_METRICS`,
:data:`STREAM_METRICS`, :data:`SHARD_METRICS`, :data:`SERVE_METRICS`,
:data:`HET_METRICS`, :data:`SCALE_METRICS`, :data:`DATA_METRICS`) under the
reference's metric names, so one snapshot reads a process whichever
component did the work. The live metrics plane
(:mod:`hypha_tpu_torch.telemetry.metrics_plane`) samples them into its
reports, and ``register_on`` exposes them as observable gauges on a
:class:`~hypha_tpu_torch.telemetry.Meter` for OTLP export.
"""

from __future__ import annotations

import threading

from . import Counter, Histogram, Meter

__all__ = [
    "FTMetrics",
    "FT_METRICS",
    "StreamMetrics",
    "STREAM_METRICS",
    "ShardMetrics",
    "SHARD_METRICS",
    "ServeMetrics",
    "SERVE_METRICS",
    "HetMetrics",
    "HET_METRICS",
    "ScaleMetrics",
    "SCALE_METRICS",
    "DataMetrics",
    "DATA_METRICS",
    "register_on",
]


class FTMetrics:
    def __init__(self) -> None:
        self.suspected_peers = Counter("hypha.ft.suspected_peers")
        self.degraded_rounds = Counter("hypha.ft.degraded_rounds")
        self.stale_deltas_dropped = Counter("hypha.ft.stale_deltas_dropped")
        self.rejoins = Counter("hypha.ft.rejoins")
        # Durable-PS instruments (``ft/durable.py``): re-attempted fabric
        # operations (aio.retry), write-ahead journal bytes appended, and
        # completed parameter-server crash recoveries.
        self.retry_attempts = Counter("hypha.ft.retry_attempts")
        self.ps_journal_bytes = Counter("hypha.ps.journal_bytes")
        self.ps_recoveries = Counter("hypha.ps.recoveries")
        # Durable control plane (ft.durable DurableScheduler): completed
        # scheduler crash recoveries, executions re-adopted in place by the
        # SchedulerHello/AdoptAck handshake, and stale-generation control
        # messages dropped (the zombie-scheduler guard firing).
        self.scheduler_recoveries = Counter("hypha.scheduler.recoveries")
        self.adopted_executions = Counter("hypha.scheduler.adopted_executions")
        self.stale_generation_dropped = Counter(
            "hypha.scheduler.stale_generation_dropped"
        )
        self.rejoin_latency_ms = Histogram(
            "hypha.ft.rejoin_latency", unit="ms",
            bounds=(50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000),
        )

    def snapshot(self) -> dict:
        hist = self.rejoin_latency_ms.snapshot()
        return {
            "suspected_peers": self.suspected_peers.value(),
            "degraded_rounds": self.degraded_rounds.value(),
            "stale_deltas_dropped": self.stale_deltas_dropped.value(),
            "rejoins": self.rejoins.value(),
            "retry_attempts": self.retry_attempts.value(),
            "ps_journal_bytes": self.ps_journal_bytes.value(),
            "ps_recoveries": self.ps_recoveries.value(),
            "scheduler_recoveries": self.scheduler_recoveries.value(),
            "adopted_executions": self.adopted_executions.value(),
            "stale_generation_dropped": self.stale_generation_dropped.value(),
            "rejoin_latency_ms_sum": hist["sum"],
            "rejoin_latency_ms_count": hist["count"],
        }

    def reset(self) -> None:
        """Fresh instruments (tests isolate runs this way)."""
        self.__init__()


FT_METRICS = FTMetrics()


class StreamMetrics:
    """Streaming outer-sync instruments (``stream/``).

    * ``bytes_in_flight``      — encoded delta bytes currently uploading /
      awaiting their broadcast on this worker (gauge semantics: flights
      add on launch, subtract on merge); ``peak_bytes_in_flight`` keeps
      the high-water mark — the number stream mode's F-way staggering is
      built to shrink.
    * ``overlap_fraction``     — of the wall-clock the sync spent in
      flight, the fraction the worker was computing inner steps instead
      of idling (0 in blocking mode, →1 when flight fully hides behind
      compute).
    * ``fragment_closes``      — per-fragment round-close counters on the
      parameter server (a stuck fragment shows up as one counter falling
      behind its siblings).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()  # flight thread + loop both record
        self._in_flight = 0.0
        self.peak_bytes_in_flight = 0.0
        self.flight_seconds = 0.0
        self.overlapped_seconds = 0.0
        self.synced_fragments = Counter("hypha.stream.synced_fragments")
        self.fragment_closes: dict[int, Counter] = {}
        # Meters registered via register_on: fragment ids only become known
        # as rounds close, so their counters attach to every registered
        # meter lazily at creation time.
        self._meters: list[Meter] = []

    def flight_started(self, nbytes: float) -> None:
        with self._lock:
            # float(): a numpy byte count must not promote the gauge to a
            # non-JSON-serializable scalar (metrics_snapshot JSON-safety).
            self._in_flight += float(nbytes)
            self.peak_bytes_in_flight = max(
                self.peak_bytes_in_flight, self._in_flight
            )

    def flight_landed(self, nbytes: float) -> None:
        """The flight thread is done with the wire — broadcast received OR
        the flight died (send error / severed bridge). Always paired with
        :meth:`flight_started` from the thread's exit path, so a failed
        job can never read as mid-upload for the process lifetime."""
        with self._lock:
            self._in_flight = max(0.0, self._in_flight - float(nbytes))

    def flight_finished(self, flight_s: float, overlapped_s: float) -> None:
        """One sync completed end to end (merge applied)."""
        flight_s, overlapped_s = float(flight_s), float(overlapped_s)
        with self._lock:
            self.flight_seconds += flight_s
            # Compute can't overlap more than the flight lasted (timer skew).
            self.overlapped_seconds += min(max(overlapped_s, 0.0), flight_s)
        self.synced_fragments.add(1)

    def bytes_in_flight(self) -> float:
        with self._lock:
            return self._in_flight

    def overlap_fraction(self) -> float:
        with self._lock:
            if self.flight_seconds <= 0.0:
                return 0.0
            return self.overlapped_seconds / self.flight_seconds

    def fragment_closed(self, fragment_id: int) -> None:
        """One (round, fragment) closed on the parameter server."""
        fragment_id = int(fragment_id)  # np.int64 keys break json.dumps
        with self._lock:
            counter = self.fragment_closes.get(fragment_id)
            created = counter is None
            if created:
                counter = Counter(
                    f"hypha.stream.fragment_closes.{fragment_id}"
                )
                self.fragment_closes[fragment_id] = counter
            meters = list(self._meters) if created else []
        for meter in meters:
            meter.observable_gauge(counter.name, counter.value)
        counter.add(1)

    def attach_meter(self, meter: Meter) -> None:
        """Export per-fragment close counters on ``meter``, including any
        fragment that only closes after this call (OTLP surface for 'one
        fragment falling behind its siblings')."""
        with self._lock:
            self._meters.append(meter)
            existing = list(self.fragment_closes.values())
        for counter in existing:
            meter.observable_gauge(counter.name, counter.value)

    def snapshot(self) -> dict:
        with self._lock:
            closes = {
                fid: c.value() for fid, c in sorted(self.fragment_closes.items())
            }
            flight_s = self.flight_seconds
            overlapped_s = self.overlapped_seconds
            in_flight = self._in_flight
            peak = self.peak_bytes_in_flight
        return {
            "bytes_in_flight": in_flight,
            "peak_bytes_in_flight": peak,
            "flight_seconds": flight_s,
            "overlapped_seconds": overlapped_s,
            "overlap_fraction": (
                overlapped_s / flight_s if flight_s > 0 else 0.0
            ),
            "synced_fragments": self.synced_fragments.value(),
            "fragment_closes": closes,
        }

    def reset(self) -> None:
        """Fresh instruments (tests isolate runs this way)."""
        self.__init__()


STREAM_METRICS = StreamMetrics()


class ShardMetrics:
    """Sharded parameter-service instruments (``stream/`` placement).

    * ``shard_rounds_closed``  — rounds this process closed as a PS shard
      (each shard closes only its owned rounds; on a worker node running
      several shard executors in tests the counter is their sum).
    * ``prefold_partials``     — tree-reduce partial sums accepted by the
      shard collectors (``PREFOLD_KEY`` pushes).
    * ``misrouted_pushes``     — deltas that arrived at a shard which does
      not own their round's fragment (a worker with a stale/mismatched
      placement map); dropped, never folded.
    * ``reduced_deltas``       — member deltas folded by group reducers on
      this node before anything reached a shard (the ingress the
      tree-reduce layer saved).
    """

    def __init__(self) -> None:
        self.shard_rounds_closed = Counter("hypha.shard.rounds_closed")
        self.prefold_partials = Counter("hypha.shard.prefold_partials")
        self.misrouted_pushes = Counter("hypha.shard.misrouted_pushes")
        self.reduced_deltas = Counter("hypha.shard.reduced_deltas")

    def snapshot(self) -> dict:
        return {
            "shard_rounds_closed": self.shard_rounds_closed.value(),
            "prefold_partials": self.prefold_partials.value(),
            "misrouted_pushes": self.misrouted_pushes.value(),
            "reduced_deltas": self.reduced_deltas.value(),
        }

    def reset(self) -> None:
        """Fresh instruments (tests isolate runs this way)."""
        self.__init__()


SHARD_METRICS = ShardMetrics()


class ServeMetrics:
    """Serving-plane instruments (executor.pool paged mode + the request
    router in scheduler.serving).

    * ``free_blocks`` / ``queue_depth`` — gauges snapshotted by the live
      :class:`~hypha_tpu_torch.executor.pool.DecodePool` at every serve-loop
      iteration (last-writer-wins across pools in one process; tests run
      one pool at a time).
    * ``admissions`` / ``preemptions`` / ``rejections`` — admitted groups,
      preempted-to-queue groups (recompute resume), and backpressure
      rejections (pool queue limit + router retry-after).
    * ``request latency`` — submit→resolve wall time per request, kept
      both as an OTLP histogram and as a bounded reservoir so
      :meth:`snapshot` can report p50/p95 directly.
    * ``prefix cache`` — blocks hit/missed at admission, copy-on-write
      copies, LRU evictions, plus ``cached_blocks``/``shared_blocks``
      gauges (snapshotted per serve-loop iteration); the snapshot
      derives ``prefix_hit_rate`` from the hit/miss counters.
    * ``speculation`` — drafted vs accepted tokens per verify dispatch
      and the derived ``spec_accept_rate`` gauge.
    * ``attention occupancy`` — per-decode-dispatch gauges from the pool:
      ``attended_blocks`` (KV blocks the attention visited),
      ``occupied_fraction`` (allocated / dense-gather capacity) and the
      derived ``attended_ratio`` (attended / allocated — 1.0 under
      ragged paged attention, the dense overhead multiplier otherwise).
    * ``weight streaming`` — the serving (round, generation) gauges
      stamped at each hot swap, applied/deferred/rolled-back swap
      counters, and a stage→flip swap-latency reservoir (same
      quantile treatment as request latency).
    * ``fleet cache`` — cross-worker prefix reuse: ``remote_prefix_hits``
      / ``remote_prefix_misses`` count KV blocks pulled from a peer vs
      pulls that fell back to recompute; ``blocks_shipped`` /
      ``block_bytes_shipped`` meter the holder side of every transfer
      (pulls and migrations); ``migrations`` counts preempted requests
      resumed on another worker; ``transfer_chosen`` /
      ``recompute_chosen`` record each side of the bandwidth-aware
      transfer-vs-recompute policy; ``directory_chains`` gauges the
      router's block-hash directory size (sum of backend digests).
    """

    _RESERVOIR = 2048

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free_blocks = 0.0
        self._queue_depth = 0.0
        self._cached_blocks = 0.0
        self._shared_blocks = 0.0
        self._attended_blocks = 0.0
        self._allocated_blocks = 0.0
        self._occupied_fraction = 0.0
        self._weight_round = -1.0  # -1 = never swapped (dispatched params)
        self._weight_generation = -1.0
        self.admissions = Counter("hypha.serve.admissions")
        self.preemptions = Counter("hypha.serve.preemptions")
        self.rejections = Counter("hypha.serve.rejections")
        self.routed_requests = Counter("hypha.serve.routed_requests")
        self.ejections = Counter("hypha.serve.ejections")
        self.prefix_hit_blocks = Counter("hypha.serve.prefix_hit_blocks")
        self.prefix_miss_blocks = Counter("hypha.serve.prefix_miss_blocks")
        self.cow_copies = Counter("hypha.serve.cow_copies")
        self.cache_evictions = Counter("hypha.serve.cache_evictions")
        self.spec_proposed = Counter("hypha.serve.spec_proposed")
        self.spec_accepted = Counter("hypha.serve.spec_accepted")
        self.affinity_routed = Counter("hypha.serve.affinity_routed")
        self.remote_prefix_hits = Counter("hypha.serve.remote_prefix_hits")
        self.remote_prefix_misses = Counter(
            "hypha.serve.remote_prefix_misses"
        )
        self.blocks_shipped = Counter("hypha.serve.blocks_shipped")
        self.block_bytes_shipped = Counter(
            "hypha.serve.block_bytes_shipped"
        )
        self.migrations = Counter("hypha.serve.migrations")
        self.transfer_chosen = Counter("hypha.serve.transfer_chosen")
        self.recompute_chosen = Counter("hypha.serve.recompute_chosen")
        self._directory_chains = 0.0
        self.swap_applied = Counter("hypha.serve.swap_applied")
        self.swap_deferred = Counter("hypha.serve.swap_deferred")
        self.swap_rolled_back = Counter("hypha.serve.swap_rolled_back")
        self.request_latency_ms = Histogram(
            "hypha.serve.request_latency", unit="ms",
            bounds=(5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
        )
        self._latencies: list[float] = []
        self.swap_latency_ms = Histogram(
            "hypha.serve.swap_latency", unit="ms",
            bounds=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500),
        )
        self._swap_latencies: list[float] = []

    def weight_state(self, round_num: float, generation: float) -> None:
        """The (round, generation) the pool is serving after a swap —
        last-writer gauges, like pool_state."""
        with self._lock:
            self._weight_round = float(round_num)
            self._weight_generation = float(generation)

    def weight_round(self) -> float:
        with self._lock:
            return self._weight_round

    def weight_generation(self) -> float:
        with self._lock:
            return self._weight_generation

    def swap_finished(self, latency_ms: float) -> None:
        """Stage→flip wall time of one applied swap (request_swap to the
        chunk-boundary application on the serve thread)."""
        self.swap_latency_ms.record(latency_ms)
        with self._lock:
            self._swap_latencies.append(float(latency_ms))
            if len(self._swap_latencies) > self._RESERVOIR:
                del self._swap_latencies[
                    : len(self._swap_latencies) - self._RESERVOIR
                ]

    def pool_state(self, free_blocks: float, queue_depth: float) -> None:
        with self._lock:
            self._free_blocks = float(free_blocks)
            self._queue_depth = float(queue_depth)

    def attention_state(
        self,
        attended_blocks: float,
        allocated_blocks: float,
        capacity_blocks: float,
    ) -> None:
        """Occupancy of the LAST decode dispatch (last-writer gauges,
        like pool_state): KV blocks the attention actually visited,
        blocks the live lanes hold, and the dense-gather worst case
        (live lanes × max_blocks). Ragged attention makes attended ==
        allocated; dense gather pays attended == capacity regardless of
        occupancy — ``attended_ratio`` (attended / allocated) is the
        per-step multiplier the kernel spends over the useful work."""
        with self._lock:
            self._attended_blocks = float(attended_blocks)
            self._allocated_blocks = float(allocated_blocks)
            self._occupied_fraction = (
                float(allocated_blocks) / float(capacity_blocks)
                if capacity_blocks
                else 0.0
            )

    def attended_blocks(self) -> float:
        with self._lock:
            return self._attended_blocks

    def occupied_fraction(self) -> float:
        with self._lock:
            return self._occupied_fraction

    def attended_ratio(self) -> float:
        """Attended vs allocated blocks in the last decode dispatch:
        1.0 = the kernel visited exactly the occupied blocks (ragged);
        > 1.0 = dense gather overhead at partial occupancy."""
        with self._lock:
            if not self._allocated_blocks:
                return 0.0
            return self._attended_blocks / self._allocated_blocks

    def cache_state(self, cached_blocks: float, shared_blocks: float) -> None:
        with self._lock:
            self._cached_blocks = float(cached_blocks)
            self._shared_blocks = float(shared_blocks)

    def cached_blocks(self) -> float:
        with self._lock:
            return self._cached_blocks

    def shared_blocks(self) -> float:
        with self._lock:
            return self._shared_blocks

    def prefix_hit_rate(self) -> float:
        hit = self.prefix_hit_blocks.value()
        total = hit + self.prefix_miss_blocks.value()
        return hit / total if total else 0.0

    def directory_state(self, chains: float) -> None:
        """Size of the router's fleet-cache directory (total chain hashes
        across all backend digests) — last-writer gauge, like pool_state."""
        with self._lock:
            self._directory_chains = float(chains)

    def directory_chains(self) -> float:
        with self._lock:
            return self._directory_chains

    def remote_prefix_hit_rate(self) -> float:
        hit = self.remote_prefix_hits.value()
        total = hit + self.remote_prefix_misses.value()
        return hit / total if total else 0.0

    def spec_accept_rate(self) -> float:
        proposed = self.spec_proposed.value()
        return self.spec_accepted.value() / proposed if proposed else 0.0

    def request_finished(self, latency_ms: float) -> None:
        self.request_latency_ms.record(latency_ms)
        with self._lock:
            self._latencies.append(float(latency_ms))
            if len(self._latencies) > self._RESERVOIR:
                del self._latencies[: len(self._latencies) - self._RESERVOIR]

    def free_blocks(self) -> float:
        with self._lock:
            return self._free_blocks

    def queue_depth(self) -> float:
        with self._lock:
            return self._queue_depth

    def _quantile(self, q: float, which: str = "_latencies") -> float:
        with self._lock:
            lat = sorted(getattr(self, which))
        if not lat:
            return 0.0
        i = min(int(q * len(lat)), len(lat) - 1)
        return lat[i]

    def snapshot(self) -> dict:
        hist = self.request_latency_ms.snapshot()
        return {
            "free_blocks": self.free_blocks(),
            "queue_depth": self.queue_depth(),
            "admissions": self.admissions.value(),
            "preemptions": self.preemptions.value(),
            "rejections": self.rejections.value(),
            "routed_requests": self.routed_requests.value(),
            "ejections": self.ejections.value(),
            "prefix_hit_blocks": self.prefix_hit_blocks.value(),
            "prefix_miss_blocks": self.prefix_miss_blocks.value(),
            "prefix_hit_rate": self.prefix_hit_rate(),
            "cached_blocks": self.cached_blocks(),
            "shared_blocks": self.shared_blocks(),
            "attended_blocks": self.attended_blocks(),
            "occupied_fraction": self.occupied_fraction(),
            "attended_ratio": self.attended_ratio(),
            "cow_copies": self.cow_copies.value(),
            "cache_evictions": self.cache_evictions.value(),
            "spec_proposed": self.spec_proposed.value(),
            "spec_accepted": self.spec_accepted.value(),
            "spec_accept_rate": self.spec_accept_rate(),
            "affinity_routed": self.affinity_routed.value(),
            "remote_prefix_hits": self.remote_prefix_hits.value(),
            "remote_prefix_misses": self.remote_prefix_misses.value(),
            "remote_prefix_hit_rate": self.remote_prefix_hit_rate(),
            "blocks_shipped": self.blocks_shipped.value(),
            "block_bytes_shipped": self.block_bytes_shipped.value(),
            "migrations": self.migrations.value(),
            "transfer_chosen": self.transfer_chosen.value(),
            "recompute_chosen": self.recompute_chosen.value(),
            "directory_chains": self.directory_chains(),
            "request_latency_ms_count": hist["count"],
            "request_latency_ms_sum": hist["sum"],
            "request_latency_ms_p50": self._quantile(0.50),
            "request_latency_ms_p95": self._quantile(0.95),
            "weight_round": self.weight_round(),
            "weight_generation": self.weight_generation(),
            "swap_applied": self.swap_applied.value(),
            "swap_deferred": self.swap_deferred.value(),
            "swap_rolled_back": self.swap_rolled_back.value(),
            "swap_latency_ms_count": self.swap_latency_ms.snapshot()["count"],
            "swap_latency_ms_p50": self._quantile(0.50, "_swap_latencies"),
            "swap_latency_ms_p95": self._quantile(0.95, "_swap_latencies"),
        }

    def reset(self) -> None:
        """Fresh instruments (tests isolate runs this way)."""
        self.__init__()


SERVE_METRICS = ServeMetrics()


class HetMetrics:
    """WAN-heterogeneity instruments (``ft/adaptive.py``).

    * ``bandwidth_bps``       — per-peer measured upload bandwidth EWMA
      (the parameter server's LinkTable, timed around each delta save);
      exported as one lazy observable gauge per peer, like the stream
      bundle's per-fragment close counters.
    * ``assigned_steps``      — per-peer inner-step assignment for the
      current round (the StragglerController's output; on the PS side the
      adopted ``RoundMembership.inner_steps`` records here too).
    * ``codec counters``      — per-link codec selections: one counter per
      codec name plus the current per-peer choice, and a ``codec_switches``
      counter on the worker side (upload codec changed by a broadcast
      hint).
    * ``quorum_drops``        — workers whose delta missed an elastic
      round's close (expected − covered at deadline), total and by round:
      the number the straggler-adaptive controller exists to drive to 0.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bandwidth: dict[str, float] = {}
        self._assigned: dict[str, int] = {}
        self._peer_codecs: dict[str, str] = {}
        self.codec_counts: dict[str, Counter] = {}
        self.codec_switches = Counter("hypha.het.codec_switches")
        self.quorum_drops = Counter("hypha.het.quorum_drops")
        self._drops_by_round: dict[int, int] = {}
        # Meters registered via register_on: peers and codecs only become
        # known as rounds run, so their gauges attach lazily.
        self._meters: list[Meter] = []

    # ------------------------------------------------------------ recording
    def note_bandwidth(self, peer: str, bps: float) -> None:
        with self._lock:
            created = peer not in self._bandwidth
            self._bandwidth[peer] = float(bps)
            meters = list(self._meters) if created else []
        for meter in meters:
            meter.observable_gauge(
                f"hypha.het.bandwidth_bps.{peer}",
                lambda p=peer: self._bandwidth.get(p, 0.0),
            )

    def note_assigned(self, peer: str, steps: int) -> None:
        with self._lock:
            created = peer not in self._assigned
            self._assigned[peer] = int(steps)
            meters = list(self._meters) if created else []
        for meter in meters:
            meter.observable_gauge(
                f"hypha.het.assigned_steps.{peer}",
                lambda p=peer: self._assigned.get(p, 0),
            )

    def note_codec(self, peer: str, codec: str) -> None:
        with self._lock:
            self._peer_codecs[peer] = codec
            counter = self.codec_counts.get(codec)
            created = counter is None
            if created:
                counter = Counter(f"hypha.het.codec.{codec}")
                self.codec_counts[codec] = counter
            meters = list(self._meters) if created else []
        for meter in meters:
            meter.observable_gauge(counter.name, counter.value)
        counter.add(1)

    def note_quorum_drop(self, round_num: int, peers) -> None:
        dropped = list(peers)
        if not dropped:
            return
        self.quorum_drops.add(len(dropped))
        # Flight-recorder breadcrumb: the drop is the symptom a stalled
        # round's forensics start from — which peers, which round, when.
        from .flight import FLIGHT

        FLIGHT.record(
            "ft.quorum_drop", round=int(round_num), peers=dropped,
        )
        with self._lock:
            self._drops_by_round[int(round_num)] = self._drops_by_round.get(
                int(round_num), 0
            ) + len(dropped)

    # ------------------------------------------------------------- querying
    def attach_meter(self, meter: Meter) -> None:
        """Export the per-peer/per-codec instruments on ``meter``, including
        peers first seen after this call."""
        with self._lock:
            self._meters.append(meter)
            bw_peers = list(self._bandwidth)
            step_peers = list(self._assigned)
            counters = list(self.codec_counts.values())
        for peer in bw_peers:
            meter.observable_gauge(
                f"hypha.het.bandwidth_bps.{peer}",
                lambda p=peer: self._bandwidth.get(p, 0.0),
            )
        for peer in step_peers:
            meter.observable_gauge(
                f"hypha.het.assigned_steps.{peer}",
                lambda p=peer: self._assigned.get(p, 0),
            )
        for counter in counters:
            meter.observable_gauge(counter.name, counter.value)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "bandwidth_bps": dict(self._bandwidth),
                "assigned_steps": dict(self._assigned),
                "peer_codecs": dict(self._peer_codecs),
                "codec_counts": {
                    c: k.value() for c, k in sorted(self.codec_counts.items())
                },
                "codec_switches": self.codec_switches.value(),
                "quorum_drops": self.quorum_drops.value(),
                "quorum_drops_by_round": dict(sorted(self._drops_by_round.items())),
            }

    def reset(self) -> None:
        """Fresh instruments (tests isolate runs this way)."""
        self.__init__()


HET_METRICS = HetMetrics()


class ScaleMetrics:
    """Control-plane scale instruments.

    * ``control_bytes``   — per-protocol control-plane wire bytes (request
      + response frames through ``Node``): membership updates
      (``/hypha-ft``), Status/ScheduleUpdate heartbeats
      (``/hypha-progress``), lease traffic (``/hypha-api``), which should
      grow sublinearly with the fleet. Tensor payloads
      (push/pull) deliberately do NOT record here; they are data plane.
    * ``tree folds/forwards`` — per-level reduce-tree activity: how many
      child contributions each level folded and how many cumulative
      partials it shipped up (``stream/reduce.py`` ``GroupReducer``).
    * ``relay counters``  — broadcast-tree pushes delivered per hop and
      dead-relay failover expansions (``tree_broadcast``).
    * ``sched_progress_ms`` — the scheduler's per-message control-loop
      time (``BatchScheduler.on_progress``): the scheduler's CPU per
      round.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._control: dict[str, Counter] = {}
        self.tree_folds: dict[int, Counter] = {}
        self.tree_forwards: dict[int, Counter] = {}
        self.relay_pushes = Counter("hypha.scale.relay_pushes")
        self.relay_failovers = Counter("hypha.scale.relay_failovers")
        self.sched_progress_ms = Histogram(
            "hypha.scale.sched_progress", unit="ms",
            bounds=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100),
        )
        # Meters registered via register_on: protocols and tree levels
        # only become known as traffic flows, so their gauges attach
        # lazily (the het bundle's discipline).
        self._meters: list[Meter] = []

    # ------------------------------------------------------------ recording
    @staticmethod
    def _proto_key(protocol: str) -> str:
        # "/hypha-progress/0.0.1" -> "hypha-progress"
        return protocol.strip("/").split("/", 1)[0] or "unknown"

    def note_control(self, protocol: str, nbytes: int) -> None:
        key = self._proto_key(protocol)
        with self._lock:
            counter = self._control.get(key)
            created = counter is None
            if created:
                counter = Counter(f"hypha.scale.control_bytes.{key}")
                self._control[key] = counter
            meters = list(self._meters) if created else []
        for meter in meters:
            meter.observable_gauge(counter.name, counter.value)
        counter.add(int(nbytes))

    def _level_counter(
        self, table: dict[int, Counter], level: int, stem: str
    ) -> Counter:
        level = int(level)
        with self._lock:
            counter = table.get(level)
            created = counter is None
            if created:
                counter = Counter(f"hypha.scale.{stem}.l{level}")
                table[level] = counter
            meters = list(self._meters) if created else []
        for meter in meters:
            meter.observable_gauge(counter.name, counter.value)
        return counter

    def note_tree_fold(self, level: int) -> None:
        self._level_counter(self.tree_folds, level, "tree_folds").add(1)

    def note_tree_forward(self, level: int) -> None:
        self._level_counter(self.tree_forwards, level, "tree_forwards").add(1)

    def note_sched_progress(self, ms: float) -> None:
        self.sched_progress_ms.record(float(ms))

    # ------------------------------------------------------------- querying
    def control_bytes(self) -> dict[str, int]:
        with self._lock:
            return {k: int(c.value()) for k, c in sorted(self._control.items())}

    def attach_meter(self, meter: Meter) -> None:
        """Export the lazy per-protocol/per-level instruments, including
        ones first seen after this call."""
        with self._lock:
            self._meters.append(meter)
            counters = (
                list(self._control.values())
                + list(self.tree_folds.values())
                + list(self.tree_forwards.values())
            )
        for counter in counters:
            meter.observable_gauge(counter.name, counter.value)

    def snapshot(self) -> dict:
        hist = self.sched_progress_ms.snapshot()
        with self._lock:
            folds = {
                f"l{lv}": int(c.value())
                for lv, c in sorted(self.tree_folds.items())
            }
            forwards = {
                f"l{lv}": int(c.value())
                for lv, c in sorted(self.tree_forwards.items())
            }
        return {
            "control_bytes": self.control_bytes(),
            "tree_folds": folds,
            "tree_forwards": forwards,
            "relay_pushes": self.relay_pushes.value(),
            "relay_failovers": self.relay_failovers.value(),
            "sched_progress_ms_sum": hist["sum"],
            "sched_progress_ms_count": hist["count"],
        }

    def reset(self) -> None:
        """Fresh instruments (tests isolate runs this way)."""
        self.__init__()


SCALE_METRICS = ScaleMetrics()


class DataMetrics:
    """Input-pipeline instruments (``executor/dataset.py``).

    * ``input_wait_seconds``    — wall-clock the TRAINING thread spent
      blocked waiting for the next batch (the number the async pipeline
      exists to drive to ~0); ``input_waits`` counts the waits.
    * ``boundary_wait_seconds`` — the subset of input waits spent
      acquiring a SLICE (slice-boundary stall: scheduler round-trip +
      data-node pull + disk write on the sync path, queue wait on the
      prefetch path); ``boundary_waits`` counts them.
    * ``slice_fetch_seconds``   — time actually pulling slices, wherever
      it ran (training thread or the background prefetcher), plus
      ``slices_fetched`` / ``bytes_pulled``.
    * ``prefetch_queue_depth``  — ready-and-unconsumed prefetched slices
      (gauge: last sample; ``peak`` kept separately) and
      ``prefetch_errors`` (fetch attempts the prefetcher retried).
    * ``cache hits/misses``     — on-disk slice-LRU outcomes
      (worker.slice_cache), plus evictions and corrupt-entry refetches.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.input_wait_seconds = 0.0
        self.input_waits = 0
        self.boundary_wait_seconds = 0.0
        self.boundary_waits = 0
        self.slice_fetch_seconds = 0.0
        self._queue_depth = 0.0
        self.peak_queue_depth = 0.0
        self.slices_fetched = Counter("hypha.data.slices_fetched")
        self.bytes_pulled = Counter("hypha.data.bytes_pulled")
        self.prefetch_errors = Counter("hypha.data.prefetch_errors")
        self.cache_hits = Counter("hypha.data.cache_hits")
        self.cache_misses = Counter("hypha.data.cache_misses")
        self.cache_evictions = Counter("hypha.data.cache_evictions")
        self.cache_corrupt = Counter("hypha.data.cache_corrupt")

    def note_input_wait(self, seconds: float) -> None:
        """The training LOOP waited this long for its next batch (recorded
        per ``next(stream)`` by the executor; includes host assembly and
        any slice acquisition that ran inline)."""
        with self._lock:
            self.input_wait_seconds += max(float(seconds), 0.0)
            self.input_waits += 1

    def note_boundary_wait(self, seconds: float) -> None:
        """A slice acquisition blocked the stream this long (a SUBSET of
        the input waits above — kept separately so the slice-boundary
        stall is assertable on its own)."""
        with self._lock:
            self.boundary_wait_seconds += max(float(seconds), 0.0)
            self.boundary_waits += 1

    def note_fetch(self, seconds: float) -> None:
        """One slice materialized (training thread or prefetcher); wire
        bytes are credited separately by the pulling connector —
        cache-hit fetches move no bytes."""
        with self._lock:
            self.slice_fetch_seconds += max(float(seconds), 0.0)
        self.slices_fetched.add(1)

    def note_queue_depth(self, depth: float) -> None:
        with self._lock:
            self._queue_depth = float(depth)
            self.peak_queue_depth = max(self.peak_queue_depth, float(depth))

    def queue_depth(self) -> float:
        with self._lock:
            return self._queue_depth

    def input_wait_s(self) -> float:
        with self._lock:
            return self.input_wait_seconds

    def mean_boundary_wait_s(self) -> float:
        with self._lock:
            if not self.boundary_waits:
                return 0.0
            return self.boundary_wait_seconds / self.boundary_waits

    def snapshot(self) -> dict:
        with self._lock:
            wait_s = self.input_wait_seconds
            waits = self.input_waits
            boundary_s = self.boundary_wait_seconds
            boundaries = self.boundary_waits
            fetch_s = self.slice_fetch_seconds
            depth = self._queue_depth
            peak = self.peak_queue_depth
        return {
            "input_wait_seconds": wait_s,
            "input_waits": waits,
            "boundary_wait_seconds": boundary_s,
            "boundary_waits": boundaries,
            "mean_boundary_wait_s": boundary_s / boundaries if boundaries else 0.0,
            "slice_fetch_seconds": fetch_s,
            "slices_fetched": self.slices_fetched.value(),
            "bytes_pulled": self.bytes_pulled.value(),
            "prefetch_queue_depth": depth,
            "peak_prefetch_queue_depth": peak,
            "prefetch_errors": self.prefetch_errors.value(),
            "cache_hits": self.cache_hits.value(),
            "cache_misses": self.cache_misses.value(),
            "cache_evictions": self.cache_evictions.value(),
            "cache_corrupt": self.cache_corrupt.value(),
        }

    def reset(self) -> None:
        """Fresh instruments (tests isolate runs this way)."""
        self.__init__()


DATA_METRICS = DataMetrics()


def register_on(
    meter: Meter,
    metrics: FTMetrics = FT_METRICS,
    stream: StreamMetrics = STREAM_METRICS,
    shard: ShardMetrics = SHARD_METRICS,
    serve: "ServeMetrics" = None,
    het: "HetMetrics" = None,
) -> None:
    """Export the bundles through a Meter as observable gauges."""
    meter.observable_gauge(
        "hypha.ft.suspected_peers", metrics.suspected_peers.value
    )
    meter.observable_gauge(
        "hypha.ft.degraded_rounds", metrics.degraded_rounds.value
    )
    meter.observable_gauge(
        "hypha.ft.stale_deltas_dropped", metrics.stale_deltas_dropped.value
    )
    meter.observable_gauge("hypha.ft.rejoins", metrics.rejoins.value)
    meter.observable_gauge(
        "hypha.ft.retry_attempts", metrics.retry_attempts.value
    )
    meter.observable_gauge(
        "hypha.ps.journal_bytes", metrics.ps_journal_bytes.value
    )
    meter.observable_gauge("hypha.ps.recoveries", metrics.ps_recoveries.value)
    meter.observable_gauge(
        "hypha.stream.bytes_in_flight", stream.bytes_in_flight
    )
    meter.observable_gauge(
        "hypha.stream.peak_bytes_in_flight",
        lambda: stream.peak_bytes_in_flight,
    )
    meter.observable_gauge(
        "hypha.stream.overlap_fraction", stream.overlap_fraction
    )
    meter.observable_gauge(
        "hypha.stream.synced_fragments", stream.synced_fragments.value
    )
    meter.observable_gauge(
        "hypha.shard.rounds_closed", shard.shard_rounds_closed.value
    )
    meter.observable_gauge(
        "hypha.shard.prefold_partials", shard.prefold_partials.value
    )
    meter.observable_gauge(
        "hypha.shard.misrouted_pushes", shard.misrouted_pushes.value
    )
    meter.observable_gauge(
        "hypha.shard.reduced_deltas", shard.reduced_deltas.value
    )
    serve = serve if serve is not None else SERVE_METRICS
    meter.observable_gauge("hypha.serve.free_blocks", serve.free_blocks)
    meter.observable_gauge("hypha.serve.queue_depth", serve.queue_depth)
    meter.observable_gauge("hypha.serve.admissions", serve.admissions.value)
    meter.observable_gauge("hypha.serve.preemptions", serve.preemptions.value)
    meter.observable_gauge("hypha.serve.rejections", serve.rejections.value)
    meter.observable_gauge(
        "hypha.serve.routed_requests", serve.routed_requests.value
    )
    meter.observable_gauge("hypha.serve.ejections", serve.ejections.value)
    meter.observable_gauge(
        "hypha.serve.prefix_hit_blocks", serve.prefix_hit_blocks.value
    )
    meter.observable_gauge(
        "hypha.serve.prefix_miss_blocks", serve.prefix_miss_blocks.value
    )
    meter.observable_gauge(
        "hypha.serve.prefix_hit_rate", serve.prefix_hit_rate
    )
    meter.observable_gauge(
        "hypha.serve.cached_blocks", serve.cached_blocks
    )
    meter.observable_gauge(
        "hypha.serve.shared_blocks", serve.shared_blocks
    )
    meter.observable_gauge(
        "hypha.serve.attended_blocks", serve.attended_blocks
    )
    meter.observable_gauge(
        "hypha.serve.occupied_fraction", serve.occupied_fraction
    )
    meter.observable_gauge("hypha.serve.cow_copies", serve.cow_copies.value)
    meter.observable_gauge(
        "hypha.serve.cache_evictions", serve.cache_evictions.value
    )
    meter.observable_gauge(
        "hypha.serve.spec_accept_rate", serve.spec_accept_rate
    )
    meter.observable_gauge(
        "hypha.serve.affinity_routed", serve.affinity_routed.value
    )
    meter.observable_gauge(
        "hypha.serve.remote_prefix_hits", serve.remote_prefix_hits.value
    )
    meter.observable_gauge(
        "hypha.serve.remote_prefix_misses", serve.remote_prefix_misses.value
    )
    meter.observable_gauge(
        "hypha.serve.blocks_shipped", serve.blocks_shipped.value
    )
    meter.observable_gauge(
        "hypha.serve.block_bytes_shipped", serve.block_bytes_shipped.value
    )
    meter.observable_gauge("hypha.serve.migrations", serve.migrations.value)
    meter.observable_gauge(
        "hypha.serve.transfer_chosen", serve.transfer_chosen.value
    )
    meter.observable_gauge(
        "hypha.serve.recompute_chosen", serve.recompute_chosen.value
    )
    meter.observable_gauge(
        "hypha.serve.directory_chains", serve.directory_chains
    )
    meter.observable_gauge("hypha.serve.weight_round", serve.weight_round)
    meter.observable_gauge(
        "hypha.serve.weight_generation", serve.weight_generation
    )
    meter.observable_gauge(
        "hypha.serve.swap_applied", serve.swap_applied.value
    )
    meter.observable_gauge(
        "hypha.serve.swap_deferred", serve.swap_deferred.value
    )
    meter.observable_gauge(
        "hypha.serve.swap_rolled_back", serve.swap_rolled_back.value
    )
    data = DATA_METRICS
    meter.observable_gauge("hypha.data.input_wait_seconds", data.input_wait_s)
    meter.observable_gauge(
        "hypha.data.prefetch_queue_depth", data.queue_depth
    )
    meter.observable_gauge(
        "hypha.data.slices_fetched", data.slices_fetched.value
    )
    meter.observable_gauge("hypha.data.bytes_pulled", data.bytes_pulled.value)
    meter.observable_gauge("hypha.data.cache_hits", data.cache_hits.value)
    meter.observable_gauge("hypha.data.cache_misses", data.cache_misses.value)
    het = het if het is not None else HET_METRICS
    meter.observable_gauge("hypha.het.quorum_drops", het.quorum_drops.value)
    meter.observable_gauge(
        "hypha.het.codec_switches", het.codec_switches.value
    )
    meter.observable_gauge(
        "hypha.scale.relay_pushes", SCALE_METRICS.relay_pushes.value
    )
    meter.observable_gauge(
        "hypha.scale.relay_failovers", SCALE_METRICS.relay_failovers.value
    )
    # Per-fragment close counters (and the heterogeneity bundle's per-peer
    # bandwidth / assigned-step gauges + per-codec counters, and the scale
    # bundle's per-protocol control bytes + per-level tree counters)
    # attach lazily — fragment ids, peers and protocols only exist once
    # traffic flows.
    stream.attach_meter(meter)
    het.attach_meter(meter)
    SCALE_METRICS.attach_meter(meter)
