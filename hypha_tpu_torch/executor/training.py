"""The training executor: the DiLoCo inner loop (counterpart of the
unsharded, single-process path of ``hypha_tpu/executor/training.py``).

Per round: AdamW inner steps on scheduler-assigned slices, a ``STATUS``
heartbeat after each batch, and on ``SCHEDULE_UPDATE{counter}`` that many
more batches; then ``UPDATE``, the pseudo-gradient Δθ = θ_t − θ₀ written as
a SafeTensors file and shipped (tagged with the round's sample count and
round number), the round's ``METRICS``, the parameter server's broadcast
update received and merged (θ ← θ + update, the new anchor θ₀), and
``UPDATE_RECEIVED`` -> Continue | Done.

Δθ files and broadcast updates use the JAX worker's flat names, layouts
and f32 dtype (``models/convert.py``), so a JAX parameter server folds a
delta from this trainer unchanged, and the other way.

Attention runs through the flash kernels on CUDA and the plain attention on
the CPU, as the JAX package picks the Pallas kernel on the accelerator.

``session`` has the bridge client's four methods: ``fetch(ref) -> [paths
relative to work_dir]``, ``send_resource(send, path, resource=, meta=)``,
``send_status(progress) -> ProgressResponse`` and ``receive(ref)``, a
context manager yielding ``{"path", "meta"}`` events. ``main`` is the
executor process a worker node spawns (the reference's CLI,
``hypha_tpu/executor/training.py:1824-1855``): it talks to the node's Job
Bridge through :class:`~hypha_tpu_torch.executor.bridge_client.Session`::

    python -m hypha_tpu_torch.executor.training --socket SOCK \
        --work-dir DIR --job '{...}' | @job.json [--max-batches N] [--device cpu]

The wire codec is the job's (``delta_codec``, or the legacy
``delta_dtype = "bfloat16"``): f32 or bf16 SafeTensors, or int8/int4 HQD1
frames quantized on the device with an error-feedback residual
(``hypha_tpu_torch/compress``); in blocking rounds an adaptive parameter
server's per-link codec hint in a broadcast header (``CODEC_KEY``,
``codec_hint``) switches the next upload to that codec (``adaptive_codec``
runs blocking and unsharded only, and the other paths ignore the key, as
the reference's do). ``sync_mode`` overlap and stream replace
the blocking update with :class:`_WorkerStream` (the reference's
``hypha_tpu/executor/training.py:213-584``): the due fragment's Δθ is
encoded and shipped by a flight thread while the inner steps go on, and
the landed update is merged with the delayed-update correction between
two steps.

The sharded parameter service and the tree reduce (the reference's
``:266-270``, ``:399-403``, ``:439``, ``:1081-1088``, ``:1445-1590``): with
a ``ps_shards`` placement every part's delta goes to its owning shard under
that shard's updates tag (``worker.connectors.shard_route``), behind the
group's reducer (``reduce_via``) with ANY failover, stamped with the
shard's index when there are several. Blocking rounds split Δθ into the
placement's parts (``partition_names`` over the wire's names and sizes,
one error-feedback residual each), push every part, wait until every
part's update has landed and merge them together; stream rounds route each
fragment to its owner. Parameter-server generations are tracked per shard
(``SHARD_KEY`` of the broadcast), so a restart re-sends only that shard's
parts.

Fault tolerance in every sync mode and placement (the reference's
``:804-826``, ``:1123-1205``, ``:1327-1350``, ``:1411-1431``,
``:1612-1620``, ``:1676-1683``): a ``checkpoint`` dict (``{"dir",
"every_rounds"}``) restores params and optimizer state from the
directory's latest checkpoint and saves one every ``every_rounds``
completed rounds, after the merge of a blocking, sharded or stream round
(``executor/checkpoint.py``; the manifest counts rounds across resumes);
``rejoin`` waits for the parameter server's catch-up Σ (``ft/rejoin.py``;
one per shard under a placement, their disjoint Σ applied as one union)
and enters the loop at its round; a broadcast whose
``ps_generation`` moved on (or a resync) makes the trainer re-send its
un-acknowledged delta. Each merged round logs a checksum of the new anchor
θ (per-tensor sums of the bit patterns), and a rejoin logs the one it
caught up to, so two trainers' θ can be compared from their logs.

LoRA (``lora``: rank, alpha, targets; the reference's ``:627-636``,
``:789-799``, ``:888-894``): the model gains adapters, the base from the
``source`` (native flat or HF names) is frozen, and the optimizer, Δθ,
merges, checkpoints and the anchor checksum cover the adapters alone.

The input side (the reference's ``:749-781``, ``:1205-1216`` and
``:1705-1803``): a ``preprocessor`` spec builds an HF processor hook
(``executor/preprocess.py``) that runs over every slice; with
``input_pipeline`` the stream prefetches ``prefetch_slices`` slices in a
background thread, batches whole slices and deletes each slice file once
read (``executor/dataset.py``), each batch goes to the card from pinned
host memory without blocking, and each step's loss is read only after the
next step was dispatched (never while a stream flight is up, whose step
accounting needs the synchronous read): the same losses in the same order,
read one step later. The loop times each wait for a batch and each slice
fetch into ``telemetry.ft_metrics.DATA_METRICS`` and logs ``data metrics:
{...}`` when it ends.

With ``report_metrics_s`` (the live metrics plane) each round's METRICS
progress also carries the reference's training-quality keys (its
``quality_metrics``): ``loss_ewma``, ``tokens_per_s``, ``inner_steps`` and,
on the blocking paths, ``delta_norm`` (the L2 norm of the round's Δθ, before
its codec). Off, the METRICS dict keeps its bytes. A stream flight records
into ``STREAM_METRICS``, a codec switch into ``HET_METRICS``, a dropped
stale-generation answer into ``FT_METRICS``.

Every other option of ``TrainExecutorConfig`` is not ported; each raises
NotImplementedError naming its ROADMAP.md item rather than being ignored.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import math
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

from .. import compress, messages
from ..ft.durable import GENERATION_KEY, RESYNC_KEY, restart_signal, stale_scheduler_response
from ..ft.rejoin import CATCHUP_KEY, await_catchup
from ..hw import default_device
from ..messages import (
    CODEC_KEY,
    SHARD_KEY,
    TRACEPARENT_KEY,
    FragmentTag,
    JobSpec,
    Loss,
    ModelType,
    Progress,
    ProgressKind,
    ProgressResponse,
    ProgressResponseKind,
    TrainExecutorConfig,
    from_json_dict,
)
from ..models.convert import (base_names, convert_state_dict, flat_to_state,
                              llama_params_from_flat, load_checkpoint_files, load_state,
                              state_to_flat)
from ..models.mixtral import Mixtral
from ..models.registry import build_model
from ..ops.attention import dot_product_attention
from ..ops.flash_attention import flash_attention
from ..stream import effective_fragments, fragment_due, merge_corrected, partition_names
from ..stream.partition import shard_of
from ..telemetry import trace
from ..telemetry.ft_metrics import DATA_METRICS, FT_METRICS, HET_METRICS, STREAM_METRICS
from ..worker.connectors import shard_route
from .bridge_client import Session
from .checkpoint import (load_train_checkpoint, restore_train_state, save_train_checkpoint,
                         train_state)
from .dataset import stream_batches
from .diloco import apply_updates, extract_delta, merge_update
from .lora import make_lora_train_step, split_lora
from .train import build_optimizer, make_train_step

__all__ = ["TrainResult", "adopt_schedule", "build_parser", "main", "run_training",
           "theta_checksum", "GENERATION_KEY", "RESYNC_KEY", "CATCHUP_KEY"]

log = logging.getLogger("hypha.torch.executor.training")

# How long the loop waits on an in-flight sync before each batch (seconds;
# the reference's variable). 0 (the default) never waits: pure overlap.
# A large value merges every landed update before the next step, the
# zero-flight limit in which overlap equals blocking bit for bit.
_STREAM_POLL_WAIT_ENV = "HYPHA_STREAM_POLL_WAIT"


class _RoundTrace:
    """The trainer's round-trace bookkeeping (``hypha_tpu/executor/
    training.py`` ``_RoundTrace``); every method is a no-op when tracing is
    off, so call sites never branch on config.

    The scheduler's round context arrives on SCHEDULE_UPDATE and Continue
    answers (``ProgressResponse.traceparent``). The trainer parents its
    ``inner_steps`` / ``encode`` / ``upload`` / ``merge`` spans under it,
    stamps it into its delta push headers so the server's spans join the
    same trace, and attaches it to its round-tagged Progress messages."""

    def __init__(self, node: "str | None") -> None:
        self.node = node
        self.tp: "str | None" = None  # the round context last handed down
        self.tp_round = -1
        self.inner: "trace.TraceSpan | None" = None
        self.inner_round = -1

    def adopt(self, resp, round_num: int) -> None:
        """Record the context a scheduler answer handed down. The round's
        ``inner_steps`` span, open and parentless since the round's first
        batch (round 0 has no context before its SCHEDULE_UPDATE), joins
        it; the reference leaves that span in a trace of its own."""
        tp = getattr(resp, "traceparent", None)
        if tp:
            self.tp, self.tp_round = tp, round_num
            if self.inner_round == round_num:
                trace.reparent(self.inner, tp)

    def ctx(self, round_num: int) -> "str | None":
        """The context of ``round_num`` (None when off or not yet seen)."""
        return self.tp if self.tp_round == round_num else None

    def stamp(self, meta: dict, round_num: int) -> dict:
        """Inject the round context into a push header (a no-op when off)."""
        return trace.inject(meta, self.ctx(round_num))

    def batch(self, round_num: int) -> None:
        """A round's first batch opens its ``inner_steps`` span."""
        if trace.active() is None:
            return
        if self.inner is None or self.inner_round != round_num:
            self.close_inner()
            self.inner = trace.begin("inner_steps", parent=self.ctx(round_num),
                                     attrs={"round": round_num}, node=self.node)
            self.inner_round = round_num

    def close_inner(self) -> None:
        if self.inner is not None:
            trace.finish(self.inner)
            self.inner = None


class TrainResult:
    """What the loop did: rounds merged, batches trained, every loss."""

    def __init__(self) -> None:
        self.rounds = 0
        self.batches = 0
        self.losses: list[float] = []

    @property
    def last_loss(self) -> float:
        return self.losses[-1] if self.losses else math.nan


# The quality loss EWMA's weight on the previous value (the reference's).
_EWMA_BETA = 0.7


def delta_norm_of(flat: dict) -> float:
    """L2 norm of a round's Δθ (squares summed in f64), the quality report's
    ``delta_norm`` on every path that ships a whole delta."""
    return math.sqrt(sum(float(torch.sum(torch.square(v.double()))) for v in flat.values()))


def adopt_schedule(resp: ProgressResponse, countdown: "int | None") -> "int | None":
    """Take a SCHEDULE_UPDATE's counter only when no countdown runs (a
    re-adopting scheduler's repeated schedule must not re-run or skip inner
    steps the round already counted)."""
    if resp.kind != ProgressResponseKind.SCHEDULE_UPDATE:
        return countdown
    return resp.counter if countdown is None else countdown


def _unsupported(cfg: TrainExecutorConfig) -> None:
    """Raise on every option this path does not run."""
    sharding = cfg.sharding or {}
    placed = bool(cfg.ps_shards and cfg.ps_shards.shards)
    mesh = math.prod(int(sharding.get(a, 1)) for a in ("dp", "fsdp", "tp", "sp", "ep"))
    checks = [
        (mesh > 1, "sharding", "intra-replica sharding"),
    ]
    for bad, option, item in checks:
        if bad:
            raise NotImplementedError(
                f"{option}={getattr(cfg, option)!r} is not ported to the PyTorch trainer "
                f"(ROADMAP.md, Queue 1: {item})"
            )
    if placed and cfg.sync_mode == "overlap":
        # Overlap's one whole-tree flight has no per-part schedule to route by.
        raise ValueError("ps_shards requires sync_mode blocking or stream")
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process replicas are not ported (ROADMAP.md, Queue 1: intra-replica sharding)"
        )


def _read_update(path: Path, device) -> dict:
    """A broadcast update in any wire format, in ``state_dict`` names: an
    HQD1 frame dequantized on ``device``, SafeTensors on the host (the merge
    moves them one tensor at a time)."""
    return flat_to_state(compress.read_delta(path, device))


def _fit(u: torch.Tensor, p: torch.Tensor, name: str) -> torch.Tensor:
    """``u`` in ``p``'s shape (a scalar travels as (1,))."""
    if tuple(u.shape) != tuple(p.shape):
        if u.numel() != 1 or p.numel() != 1:
            raise ValueError(f"update {name!r}: shape {tuple(u.shape)} != {tuple(p.shape)}")
        u = u.reshape(p.shape)
    return u


@torch.no_grad()
def theta_checksum(params: dict) -> str:
    """A digest of ``params``' exact bits (the trainer passes its flat wire
    names): each tensor's bit patterns summed as int64 on its device (one
    host read for all), hashed in name order. Equal θ give equal digests
    on any device and in either orientation; a flipped bit changes its
    tensor's sum."""
    sums = []
    for name in sorted(params):
        t = params[name].detach()
        bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        sums.append(t.contiguous().view(bits).to(torch.int64).sum())
    values = torch.stack(sums).tolist()
    return hashlib.sha256(repr(list(zip(sorted(params), values))).encode()).hexdigest()[:16]


def codec_hint(meta: dict, current: str) -> "str | None":
    """The upload codec an adaptive parameter server picked for this
    worker's link (``CODEC_KEY`` in the broadcast header; the reference's
    ``apply_codec_hint``), or None to keep ``current``: no hint, an unknown
    codec, or the same one. The caller keeps its error-feedback residual
    across the switch (plain f32 error, codec-independent) and starts one
    only when a quantized codec finds none."""
    hint = meta.get(CODEC_KEY) if isinstance(meta, dict) else None
    if not isinstance(hint, str) or hint not in compress.CODECS or hint == current:
        return None
    log.info("per-link codec hint: switching upload codec %s -> %s", current, hint)
    HET_METRICS.codec_switches.add(1)
    return hint


class _WorkerStream:
    """The trainer's streaming outer sync, at most one fragment in flight
    (counterpart of ``hypha_tpu/executor/training.py:213-584``).

    ``begin`` snapshots the due fragment θ_s on the training stream (the
    next step cannot touch the copy), takes Δ = θ_s − anchor and hands
    encode -> upload -> await-broadcast to a thread while the loop keeps
    stepping; ``poll`` / ``finish`` (the loop's thread, between two steps)
    merge the landed update with the delayed-update correction (θ ← θ_l +
    u, anchor ← θ_s + u). An update for a fragment not in flight is
    absorbed into both params and anchor, leaving its Δ unchanged. Error
    feedback is per fragment: ``absorb`` replaces a whole residual tree.

    ``params`` and ``anchor`` are ``model``'s ``state_dict``s that the loop
    trains and re-anchors in place."""

    def __init__(self, session, cfg, work_dir: Path, sync_mode: str, wire_codec: str,
                 model, params: dict, anchor: dict, device,
                 rtrace: "_RoundTrace | None" = None) -> None:
        self.session, self.cfg, self.work_dir = session, cfg, Path(work_dir)
        self.rtrace = rtrace
        self.codec, self.device = wire_codec, device
        self.model, self.params, self.anchor = model, params, anchor
        self.F = effective_fragments(sync_mode, int(cfg.fragments or 0))
        # Deterministic from the wire's (name, size) alone: the parameter
        # server needs no manifest to agree.
        to_state = dict(zip(state_to_flat(model, params), params))
        parts = partition_names({f: params[t].numel() for f, t in to_state.items()}, self.F)
        self.fragments = [tuple(to_state[f] for f in names) for names in parts]
        self.efs = [compress.ErrorFeedback() if wire_codec in compress.QUANT_CODECS else None
                    for _ in range(self.F)]
        self.flight: "dict | None" = None
        self.poll_wait_s = float(os.environ.get(_STREAM_POLL_WAIT_ENV, "0") or 0.0)
        # The last parameter-server generation seen per shard (flight-thread
        # confined); the unsharded server is shard 0.
        self._gens: dict = {}
        # The placement each fragment's push is routed by (None: one server).
        self.shard_map = cfg.ps_shards if cfg.ps_shards and cfg.ps_shards.shards else None

    @property
    def in_flight(self) -> bool:
        return self.flight is not None

    def begin(self, round_num: int, num_samples: float) -> None:
        """Snapshot and extract the due fragment; start the flight thread."""
        if self.flight is not None:
            raise RuntimeError("stream sync scheduled while a fragment is still in flight")
        frag = fragment_due(round_num, self.F)
        names = self.fragments[frag]
        with torch.no_grad():
            snap = {t: self.params[t].detach().clone() for t in names}
            delta = extract_delta(snap, {t: self.anchor[t] for t in names})
        wire = state_to_flat(self.model, delta)
        owner = shard_of(frag, len(self.shard_map.shards)) if self.shard_map is not None else 0
        flight = {
            "round": round_num, "frag": frag, "owner": owner, "names": names, "snap": snap,
            "path": self.work_dir / f"delta-{round_num}-f{frag}.safetensors",
            "box": {"absorbed": []}, "t0": time.perf_counter(), "steps": 0, "compute_s": 0.0,
            "bytes": 0,
            "samples": float(num_samples),
            # The round context at launch, for the flight thread's spans
            # and push headers.
            "tp": self.rtrace.ctx(round_num) if self.rtrace is not None else None,
        }
        tag = FragmentTag(round=round_num, fragment_id=frag, fragments=self.F)
        thread = threading.Thread(target=self._flight_main, args=(flight, wire, tag),
                                  daemon=True, name=f"stream-sync-r{round_num}")
        flight["thread"] = thread
        self.flight = flight
        thread.start()

    def _flight_main(self, flight: dict, wire: dict, tag: FragmentTag) -> None:
        box = flight["box"]
        tnode = self.rtrace.node if self.rtrace is not None else None
        try:
            t0 = time.perf_counter()
            with trace.span("encode", parent=flight["tp"], node=tnode,
                            attrs={"round": flight["round"], "fragment": flight["frag"],
                                   "codec": self.codec}):
                compress.write_delta(flight["path"], wire, self.codec,
                                     ef=self.efs[flight["frag"]], tag=tag.header())
            del wire
            nbytes = flight["path"].stat().st_size
            flight["bytes"] = nbytes
            STREAM_METRICS.flight_started(nbytes)
            log.info("round %d fragment %d: delta encoded in %.3f s (%d bytes)",
                     flight["round"], flight["frag"], time.perf_counter() - t0, nbytes)
            with trace.span("upload", parent=flight["tp"], node=tnode,
                            attrs={"round": flight["round"], "fragment": flight["frag"],
                                   "bytes": nbytes}):
                self._send(flight, tag)
            box["completion"] = self._await_broadcast(flight)
            log.info("round %d fragment %d: broadcast landed %.3f s after the snapshot",
                     flight["round"], flight["frag"], time.perf_counter() - flight["t0"])
        except BaseException as e:  # hypha-lint: disable=swallowed-cancel
            box["error"] = e  # thread-bridge: re-raised at finish()
        finally:
            # Done with the wire, landed or failed: a dead flight must not
            # read as mid-upload for the rest of the process.
            STREAM_METRICS.flight_landed(flight["bytes"])

    def _send(self, flight: dict, tag: FragmentTag) -> None:
        """Ship the flight's file: to the one server, or to the fragment's
        owning shard (behind the group's reducer, with ANY failover)."""
        meta = {"num_samples": flight["samples"], **tag.header()}
        trace.inject(meta, flight.get("tp"))
        if self.shard_map is None:
            self.session.send_resource(
                self.cfg.updates, flight["path"].name,
                resource=self.cfg.updates.ref.resource or "updates", meta=meta)
            return
        send, owner, res_tag = shard_route(self.shard_map, flight["frag"], self.cfg.reduce_via)
        if len(self.shard_map.shards) > 1:
            meta[SHARD_KEY] = owner
        self.session.send_resource(send, flight["path"].name, resource=res_tag, meta=meta)

    def _drop(self, event: dict) -> None:
        (self.work_dir / event["path"]).unlink(missing_ok=True)

    def _await_broadcast(self, flight: dict) -> dict:
        """Consume results events until this fragment's update lands. Other
        fragments' later updates are kept for ``finish`` to absorb; older
        rounds are applied state and dropped; a later round of this fragment
        completes the flight (this round's broadcast was lost). A parameter
        server restart re-sends the delta (only the owning shard's)."""
        with self.session.receive(self.cfg.results) as events:
            for event in events:
                meta = event.get("meta") or {}
                try:
                    shard_id = int(meta.get(SHARD_KEY, 0))
                except (TypeError, ValueError):
                    shard_id = 0
                self._gens[shard_id], resend = restart_signal(meta, self._gens.get(shard_id))
                if resend and shard_id == flight["owner"] and flight["path"].is_file():
                    log.warning("stream sync: parameter server restarted; re-sending round %d "
                                "fragment %d", flight["round"], flight["frag"])
                    self._send(flight, FragmentTag(flight["round"], flight["frag"], self.F))
                if meta.get(RESYNC_KEY) or meta.get(CATCHUP_KEY):
                    self._drop(event)
                    continue
                etag = FragmentTag.from_header(meta)
                try:
                    eround = int(meta.get("round", flight["round"]))
                except (TypeError, ValueError):
                    eround = flight["round"]
                if eround < flight["round"]:
                    self._drop(event)
                    continue
                if etag is not None and etag.fragment_id != flight["frag"]:
                    flight["box"]["absorbed"].append(event)
                    continue
                if eround > flight["round"]:
                    log.warning("stream sync: round %d broadcast lost; completing with round "
                                "%d's", flight["round"], eround)
                return event
        raise RuntimeError("results stream ended before the fragment's update broadcast")

    def poll(self) -> bool:
        """True when the in-flight sync is ready to finish."""
        flight = self.flight
        if flight is None:
            return False
        if self.poll_wait_s > 0:
            flight["thread"].join(self.poll_wait_s)
        return not flight["thread"].is_alive()

    def note_step(self, seconds: float = 0.0) -> None:
        """One inner step taken with the flight up (its compute seconds:
        the overlap ``STREAM_METRICS`` reports)."""
        if self.flight is not None:
            self.flight["steps"] += 1
            self.flight["compute_s"] += seconds

    @torch.no_grad()
    def finish(self) -> None:
        """Merge the landed broadcast into params and anchor, in place."""
        flight, self.flight = self.flight, None
        t_wait = time.perf_counter()
        flight["thread"].join()
        waited = time.perf_counter() - t_wait
        box = flight["box"]
        if "error" in box:
            flight["path"].unlink(missing_ok=True)
            raise box["error"]
        t0 = time.perf_counter()
        for event in box["absorbed"]:
            self._absorb(event)
        event = box["completion"]
        merge_span = trace.begin(
            "merge", parent=(event.get("meta") or {}).get(TRACEPARENT_KEY) or flight.get("tp"),
            attrs={"round": flight["round"], "fragment": flight["frag"]},
            node=self.rtrace.node if self.rtrace is not None else None)
        update_file = self.work_dir / event["path"]
        update = _read_update(update_file, self.device)
        names = flight["names"]
        if set(update) != set(names):
            raise ValueError(f"fragment {flight['frag']} partition mismatch: the update carries "
                             f"{len(update)} tensors, the worker expects {len(names)}")
        snap = flight.pop("snap")
        for t in names:  # merge_corrected one tensor at a time: no second fragment copy
            p = self.params[t]
            live, anchor = merge_corrected({t: p}, {t: snap.pop(t)}, {t: _fit(update[t], p, t)})
            p.copy_(live[t])
            self.anchor[t].copy_(anchor[t])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        trace.finish(merge_span)
        log.info("round %d fragment %d: update merged in %.3f s; waited %.3f s for the flight; "
                 "%d steps in flight", flight["round"], flight["frag"], time.perf_counter() - t0,
                 waited, flight["steps"])
        update_file.unlink(missing_ok=True)
        flight["path"].unlink(missing_ok=True)
        STREAM_METRICS.flight_finished(time.perf_counter() - flight["t0"], flight["compute_s"])

    def _absorb(self, event: dict) -> None:
        """θ ← θ + u and anchor ← anchor + u for a fragment not in flight."""
        update_file = self.work_dir / event["path"]
        update = _read_update(update_file, self.device)
        unknown = set(update) - set(self.params)
        if unknown:
            raise ValueError(f"broadcast update names unknown tensors: {sorted(unknown)}")
        for t, u in update.items():
            for tree in (self.params, self.anchor):
                tree[t].copy_(merge_update({t: tree[t]}, {t: _fit(u, tree[t], t)})[t])
        update_file.unlink(missing_ok=True)

    def abort(self) -> None:
        """The loop ends with a sync still out: a bounded join, then the
        daemon thread is abandoned (the bridge's teardown ends its stream)."""
        flight, self.flight = self.flight, None
        if flight is None:
            return
        flight["thread"].join(5.0)
        if flight["thread"].is_alive():
            log.warning("stream sync round %d abandoned (broadcast never landed)",
                        flight["round"])
            return
        flight["path"].unlink(missing_ok=True)


def _init_model(cfg: TrainExecutorConfig, session, work_dir: Path, device: torch.device):
    """The model with its initial weights: the port's seeded init, then a
    ``source``'s weights in native flat names or, failing those, in the
    family's HF names (``models/convert.py``). A LoRA job (``cfg.lora``)
    adds adapters to the model's config with the reference's defaults
    (rank 8, α 16, q_proj and v_proj); a checkpoint carries the base only,
    and the adapters keep their seeded init (``B`` = 0: the base's exact
    outputs at step 0). A Mixtral has no LoRA fields, so its config refuses
    them (``TypeError``), as the reference's does. Flash attention on CUDA."""
    spec = dict(cfg.model)
    model_type = spec.get("model_type", ModelType.CAUSAL_LM)
    if not isinstance(model_type, ModelType):
        model_type = ModelType(model_type)
    if model_type is not ModelType.CAUSAL_LM:
        raise NotImplementedError(
            f"model_type {model_type.value!r} is not ported (ROADMAP.md, Queue 1: model families)"
        )
    if cfg.lora:
        spec["config"] = dict(
            spec.get("config") or {},
            lora_rank=int(cfg.lora.get("rank", 8)),
            lora_alpha=float(cfg.lora.get("alpha", 16.0)),
            lora_targets=tuple(cfg.lora.get("targets", ("q_proj", "v_proj"))),
        )
    attn_impl = flash_attention if device.type == "cuda" else None
    log.info("attention path: %s", "flash kernels" if attn_impl else "plain (host)")
    model, _ = build_model(spec, device=device, attn_impl=attn_impl)
    model.init_weights(int(spec.get("seed", 0)))
    source = spec.get("source")
    if source is None:
        return model
    fetch = from_json_dict(source) if isinstance(source, dict) else source
    t_fetch = time.perf_counter()
    rels = session.fetch(fetch)
    files = [work_dir / r for r in rels if r.endswith((".safetensors", ".bin", ".pt", ".pth"))]
    if not files:  # a source without weights keeps the seeded init, as in the JAX trainer
        return model
    t_load = time.perf_counter()
    state = load_checkpoint_files(files)
    try:
        llama_params_from_flat(state, model, base_only=bool(cfg.lora))
        names = "native flat"
    except KeyError:
        family = spec.get("family", "llama")
        load_state(model, convert_state_dict(family, state, model))
        names = f"HF ({family})"
    del state
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.info("loaded %d initial tensors from %s (%s names): fetched in %.3f s, loaded in %.3f s",
             len(base_names(model)), [f.name for f in files], names, t_load - t_fetch,
             time.perf_counter() - t_load)
    return model


def _rejoin(session, cfg: TrainExecutorConfig, work_dir: Path, model, params: dict,
            anchor: dict, dev) -> int:
    """Dispatched mid-job: θ₀ (already built) is every worker's start, and
    each parameter server owes one catch-up push, Σ of its updates so far
    and its next round. With several shards the rejoiner waits for one
    catch-up per shard; their Σ cover disjoint tensors and are applied as
    one union (see below for the round it enters). Round broadcasts
    racing in first are dropped: their content is inside Σ. Merges
    θ ← θ₀ + Σ and the anchor in place; returns the round."""
    shard_map = cfg.ps_shards if cfg.ps_shards and cfg.ps_shards.shards else None
    want = len(shard_map.shards) if shard_map is not None else 1
    log.info("rejoin: waiting for the parameter server's catch-up%s",
             f" ({want} shards)" if want > 1 else "")

    def drop(event: dict) -> None:
        (work_dir / event["path"]).unlink(missing_ok=True)

    t_wait = time.perf_counter()
    got: dict = {}
    with session.receive(cfg.results) as events:
        while len(got) < want:
            catchup = await_catchup(events, on_skip=drop)
            meta = catchup.get("meta") or {}
            try:
                sid = int(meta.get(SHARD_KEY, 0)) if want > 1 else 0
            except (TypeError, ValueError):
                sid = 0
            if sid in got:
                drop(catchup)
                continue
            got[sid] = catchup
    t_merge = time.perf_counter()
    update: dict = {}
    rounds, epoch, size = [], "?", 0
    for sid, catchup in sorted(got.items()):
        meta = catchup.get("meta") or {}
        catchup_file = work_dir / catchup["path"]
        nbytes = catchup_file.stat().st_size
        size += nbytes
        update.update(flat_to_state(compress.read_delta(catchup_file, dev)))
        catchup_file.unlink(missing_ok=True)
        rounds.append(int(meta.get("round", 0)))
        epoch = meta.get("epoch", epoch)
        if want > 1:
            log.info("rejoin: shard %d catch-up to round %s: %d bytes", sid,
                     meta.get("round", "?"), nbytes)
    unknown = set(update) - set(params)
    if unknown:
        raise KeyError(f"catchup tensors not in params: {sorted(unknown)}")
    with torch.no_grad():
        for name, p in params.items():
            if name in update:
                u = _fit(update.pop(name), p, name)
                p.copy_(apply_updates({name: p}, [{name: u}])[name])
            anchor[name].copy_(p)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # Each shard's catch-up names its own next round. In stream mode the
    # union of their Σ covers exactly the rounds below the least of them
    # (rounds close in order, one shard each), so the rejoiner enters
    # there and takes part in the round the fleet is in; the reference
    # takes the greatest, which skips that round's update and leaves its
    # shard waiting for the rejoiner until the deadline. Blocking shards
    # close every round together and name the same round.
    streaming = (cfg.sync_mode or "blocking") == "stream"
    round_num = min(rounds) if streaming else max(rounds)
    log.info("rejoin: caught up to round %d (membership epoch %s): %d bytes, waited %.3f s, "
             "merged in %.3f s", round_num, epoch, size, t_merge - t_wait,
             time.perf_counter() - t_merge)
    log.info("round %d: anchor checksum %s", round_num,
             theta_checksum(state_to_flat(model, params)))
    return round_num


def run_training(
    session,
    work_dir: "Path | str",
    spec: JobSpec,
    *,
    max_batches: "int | None" = None,
    should_stop: "Callable[[], bool] | None" = None,
    device=None,
    trace_node: "str | None" = None,
) -> TrainResult:
    """Run the DiLoCo inner loop to completion over ``session``, on
    ``device`` (CUDA unless the caller asks for the CPU). ``max_batches``
    is a safety valve for tests; ``should_stop`` is polled between
    batches. ``trace_node`` labels this worker's round-trace spans (the
    in-process executor passes its peer id; a trainer process labels its
    spans through ``HYPHA_TRACE_NODE``); ignored while tracing is off."""
    work_dir = Path(work_dir)
    cfg = spec.executor.train
    if cfg is None:
        raise ValueError(f"job {spec.job_id} is not a train job")
    _unsupported(cfg)
    dev = default_device(device)

    def fetch_slice() -> str:
        t_fetch = time.monotonic()
        path = str(work_dir / session.fetch(cfg.data)[0])
        DATA_METRICS.note_fetch(time.monotonic() - t_fetch)
        return path

    preprocessor = None
    if cfg.preprocessor:
        from .preprocess import build_preprocessor

        preprocessor = build_preprocessor(cfg.preprocessor, session, work_dir)
    # Round tracing (telemetry.trace), all no-ops when off. Made before
    # the stream so input_wait spans join the round's trace: the context
    # last handed down attributes a mid-round input stall to its round.
    rtrace = _RoundTrace(trace_node)
    pipeline_on = bool(cfg.input_pipeline)
    stream = stream_batches(fetch_slice, cfg.batch_size, dict(cfg.model).get("input_names"),
                            preprocessor, pipeline=pipeline_on, prefetch=cfg.prefetch_slices,
                            unlink_consumed=pipeline_on,
                            span_ctx=lambda: (rtrace.tp, rtrace.node))
    first_batch = next(stream)
    model = _init_model(cfg, session, work_dir, dev)
    # The tensors a round trains, ships and merges (aliases of the
    # parameters, updated in place): all of them, or a LoRA job's adapters,
    # the frozen base riding along in the model.
    params = model.state_dict()
    if cfg.lora:
        params, frozen = split_lora(params)
        if not params:
            raise ValueError(f"job {spec.job_id}: lora={cfg.lora!r} produced no adapters "
                             f"(family {dict(cfg.model).get('family')!r})")
        log.info("LoRA: %d adapter tensors (%d values) over a frozen base of %d tensors; "
                 "base checksum %s", len(params), sum(p.numel() for p in params.values()),
                 len(frozen), theta_checksum(state_to_flat(model, frozen)))
    trained = dict(model.named_parameters())
    optimizer = build_optimizer([trained[n] for n in params], cfg.optimizer, cfg.scheduler)
    make_step = make_lora_train_step if cfg.lora else make_train_step
    # A Mixtral returns (logits, router aux loss); the aux joins the loss.
    step = make_step(model, optimizer, cfg.loss or Loss.CROSS_ENTROPY,
                     has_aux=isinstance(model, Mixtral))

    # Resume: a re-dispatched executor picks up the last completed round's
    # params and optimizer state instead of θ₀.
    ckpt_dir: "Path | None" = None
    ckpt_every = 1
    round_offset = 0  # completed rounds restored from a checkpoint
    if cfg.checkpoint and cfg.checkpoint.get("dir"):
        ckpt_every = int(cfg.checkpoint.get("every_rounds", 1))
        if ckpt_every > 0:  # <= 0 disables checkpointing
            ckpt_dir = Path(cfg.checkpoint["dir"])
            restored = load_train_checkpoint(ckpt_dir, *train_state(model, optimizer))
            if restored is not None:
                r_params, r_opt, r_step, r_round, _extra = restored
                restore_train_state(model, optimizer, r_params, r_opt)
                round_offset = r_round
                log.info("resumed from %s: step %d, %d completed rounds", ckpt_dir, r_step,
                         r_round)
    anchor = {k: v.detach().clone() for k, v in params.items()}

    # The outer round's wire codec: delta_codec, or the legacy
    # delta_dtype="bfloat16" as bf16. The quantized codecs keep an
    # error-feedback residual across rounds.
    wire_codec = compress.effective_codec(cfg.delta_codec, cfg.delta_dtype)
    delta_ef = compress.ErrorFeedback() if wire_codec in compress.QUANT_CODECS else None
    sync_mode = cfg.sync_mode or "blocking"
    stream_state: "_WorkerStream | None" = None
    if sync_mode != "blocking":
        stream_state = _WorkerStream(session, cfg, work_dir, sync_mode, wire_codec, model,
                                     params, anchor, dev, rtrace)
        log.info("streaming outer sync: mode=%s fragments=%d codec=%s", sync_mode,
                 stream_state.F, wire_codec)

    result = TrainResult()
    countdown: "int | None" = None
    round_num = 0
    if cfg.rejoin:
        round_num = _rejoin(session, cfg, work_dir, model, params, anchor, dev)
    round_samples = 0
    round_losses: list[float] = []
    gens: dict = {"ps": None, "sched": None}
    # The live metrics plane: a reporting job's round METRICS carry the
    # training-quality keys (loss EWMA, tokens/s, inner steps, delta norm);
    # off, the METRICS dict, and the wire, stay as they are.
    report_quality = bool(cfg.report_metrics_s)
    qstate: dict = {"ewma": None, "t0": time.monotonic(), "tokens": 0.0, "batches": 0}

    def quality_metrics(mean_loss: float) -> dict:
        """One round's quality keys; resets the per-round accumulators."""
        now = time.monotonic()
        dur = max(now - qstate["t0"], 1e-9)
        ewma = qstate["ewma"]
        if not math.isnan(mean_loss):
            ewma = mean_loss if ewma is None else \
                _EWMA_BETA * ewma + (1.0 - _EWMA_BETA) * mean_loss
            qstate["ewma"] = ewma
        out = {
            "loss_ewma": float(ewma) if ewma is not None else mean_loss,
            "tokens_per_s": float(qstate["tokens"]) / dur,
            "inner_steps": float(qstate["batches"]),
        }
        qstate.update(t0=now, tokens=0.0, batches=0)
        return out

    def note_quality_batch(batch: dict) -> None:
        qstate["batches"] += 1
        ids = batch.get("input_ids") if isinstance(batch, dict) else None
        qstate["tokens"] += float(ids.numel()) if ids is not None else float(cfg.batch_size)

    def round_metrics(samples: float, delta_norm: "float | None" = None) -> dict:
        """The round's METRICS: mean loss and samples, and the quality keys
        on a reporting job (``delta_norm``: the round's Δθ's, where the path
        ships a whole one)."""
        mean_loss = sum(round_losses) / len(round_losses) if round_losses else math.nan
        metrics = {"loss": mean_loss, "samples": samples}
        if report_quality:
            metrics.update(quality_metrics(mean_loss))
            if delta_norm is not None:
                metrics["delta_norm"] = delta_norm
        return metrics

    def send_status(progress: Progress) -> ProgressResponse:
        """session.send_status, dropping a stale scheduler generation's answers."""
        for _ in range(64):
            if gens["sched"] is not None and int(gens["sched"]) >= 2:
                progress.scheduler_generation = int(gens["sched"])
            resp = session.send_status(progress)
            gens["sched"], stale = stale_scheduler_response(resp, gens["sched"])
            if not stale:
                return resp
            FT_METRICS.stale_generation_dropped.add(1)
            log.warning("dropping a %s response from a stale scheduler generation",
                        progress.kind.value)
            time.sleep(0.2)
        raise RuntimeError("scheduler kept answering from a stale generation")

    def maybe_checkpoint() -> None:
        """After round ``round_num`` merged, every ``every_rounds`` rounds:
        the manifest counts completed rounds across resumes (blocking,
        sharded and stream). It runs before the round's UPDATE_RECEIVED:
        the reference saves after it, and on the job's last round the
        scheduler's DONE then releases the worker, which cancels the
        trainer mid-save, so the final checkpoint is lost."""
        done = round_num + 1
        if ckpt_dir is None or done % ckpt_every != 0:
            return
        t_save = time.perf_counter()
        saved = save_train_checkpoint(ckpt_dir, *train_state(model, optimizer),
                                      optimizer.count, round_offset + done)
        log.info("round %d: checkpoint %s saved in %.3f s (%d bytes)", round_num,
                 saved.name, time.perf_counter() - t_save,
                 sum(f.stat().st_size for f in saved.iterdir()))

    def push_delta(delta_path: Path) -> None:
        # Traced jobs stamp the round's context: the server's spans join
        # the round's trace.
        session.send_resource(
            cfg.updates, delta_path.name, resource=cfg.updates.ref.resource or "updates",
            meta=rtrace.stamp({"num_samples": float(round_samples), "round": round_num},
                              round_num),
        )

    def do_update() -> bool:
        """Ship Δθ, wait for the broadcast, merge. True = next round."""
        nonlocal round_num, round_samples, wire_codec, delta_ef
        rtrace.close_inner()
        round_tp = rtrace.ctx(round_num)
        send_status(Progress(kind=ProgressKind.UPDATE, job_id=spec.job_id, traceparent=round_tp))
        enc_span = trace.begin("encode", parent=round_tp, node=rtrace.node,
                               attrs={"round": round_num, "codec": wire_codec})
        delta_path = work_dir / f"delta-{round_num}.safetensors"
        t_write = time.perf_counter()
        with torch.no_grad():
            flat = state_to_flat(model, extract_delta(params, anchor))
            compress.write_delta(delta_path, flat, wire_codec, ef=delta_ef)
            delta_norm = delta_norm_of(flat) if report_quality else None
            del flat
        if dev.type == "cuda":
            # The delta's transients go back to the card while the round's
            # broadcast is awaited: a parameter server may share it.
            torch.cuda.empty_cache()
        trace.finish(enc_span)
        log.info("round %d: delta written in %.3f s", round_num, time.perf_counter() - t_write)
        with trace.span("upload", parent=round_tp, node=rtrace.node,
                        attrs={"round": round_num, "codec": wire_codec,
                               "bytes": delta_path.stat().st_size}):
            push_delta(delta_path)
        send_status(Progress(kind=ProgressKind.METRICS, job_id=spec.job_id, round=round_num,
                             metrics=round_metrics(float(round_samples), delta_norm),
                             traceparent=round_tp))
        with session.receive(cfg.results) as events:
            while True:
                event = next(events, None)
                if event is None:
                    raise RuntimeError("results stream ended before the round's update broadcast")
                meta = event.get("meta") or {}
                gens["ps"], resend = restart_signal(meta, gens["ps"])
                if resend and delta_path.is_file():
                    log.warning("parameter server restarted; re-sending round %d delta", round_num)
                    push_delta(delta_path)
                try:
                    eround = int(meta.get("round", round_num))
                except (TypeError, ValueError):
                    eround = round_num
                if meta.get(RESYNC_KEY) or meta.get(CATCHUP_KEY) or eround < round_num:
                    # No payload, a rejoiner's catch-up, or a round already merged.
                    (work_dir / event["path"]).unlink(missing_ok=True)
                    continue
                hint = codec_hint(meta, wire_codec)
                if hint is not None:
                    wire_codec = hint
                    if hint in compress.QUANT_CODECS and delta_ef is None:
                        delta_ef = compress.ErrorFeedback()
                break
        # Under the broadcast's context when the server stamped one (the
        # same round trace), else the scheduler's round.
        merge_span = trace.begin("merge", parent=meta.get(TRACEPARENT_KEY) or round_tp,
                                 attrs={"round": round_num}, node=rtrace.node)
        update_file = work_dir / event["path"]
        t_merge = time.perf_counter()
        update = _read_update(update_file, dev)
        with torch.no_grad():
            for name, p in params.items():
                if name not in update:
                    raise KeyError(f"update misses tensor {name!r} ({len(update)} tensors)")
                p.copy_(merge_update({name: p}, {name: _fit(update.pop(name), p, name)})[name])
                anchor[name].copy_(p)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        trace.finish(merge_span)
        log.info("round %d: update merged in %.3f s (membership epoch %s)", round_num,
                 time.perf_counter() - t_merge, meta.get("epoch", "-"))
        log.info("round %d: anchor checksum %s", round_num + 1,
                 theta_checksum(state_to_flat(model, params)))
        delta_path.unlink(missing_ok=True)
        update_file.unlink(missing_ok=True)
        maybe_checkpoint()
        resp = send_status(Progress(kind=ProgressKind.UPDATE_RECEIVED, job_id=spec.job_id,
                                    traceparent=round_tp))
        round_num += 1
        rtrace.adopt(resp, round_num)
        result.rounds = round_num
        round_samples = 0
        round_losses.clear()
        return resp.kind == ProgressResponseKind.CONTINUE

    shard_map = cfg.ps_shards if cfg.ps_shards and cfg.ps_shards.shards else None
    # Blocking rounds against a placement: the parts' wire names (a pure
    # function of the wire's names and sizes, as every shard and reducer
    # derives them), one residual per part, the last generation per shard.
    shard_ctx: dict = {"parts": None, "efs": None, "gens": {}}

    def push_part(p: int, path: Path, samples: float) -> None:
        tag = FragmentTag(round=round_num, fragment_id=p, fragments=len(shard_ctx["parts"]))
        send, owner, res_tag = shard_route(shard_map, p, cfg.reduce_via)
        meta = {"num_samples": samples, "round": round_num, **tag.header()}
        if len(shard_map.shards) > 1:
            meta[SHARD_KEY] = owner
        session.send_resource(send, path.name, resource=res_tag,
                              meta=rtrace.stamp(meta, round_num))

    def do_update_sharded() -> bool:
        """Blocking sync against a placement: split Δθ into its parts, push
        each to its owning shard (through the group's reducer when the job
        reduces in a tree), wait for every part's update, merge them all,
        re-anchor. True = next round."""
        nonlocal round_num, round_samples
        rtrace.close_inner()
        round_tp = rtrace.ctx(round_num)
        send_status(Progress(kind=ProgressKind.UPDATE, job_id=spec.job_id, traceparent=round_tp))
        enc_span = trace.begin("encode", parent=round_tp, node=rtrace.node,
                               attrs={"round": round_num, "codec": wire_codec})
        t_write = time.perf_counter()
        with torch.no_grad():
            wire_flat = state_to_flat(model, extract_delta(params, anchor))
        P = int(shard_map.fragments) or len(shard_map.shards)
        if shard_ctx["parts"] is None:
            shard_ctx["parts"] = partition_names({n: v.numel() for n, v in wire_flat.items()}, P)
            shard_ctx["efs"] = [compress.ErrorFeedback() if wire_codec in compress.QUANT_CODECS
                                else None for _ in range(P)]
        parts = shard_ctx["parts"]
        samples = float(round_samples)
        paths: dict = {}
        for p, names in enumerate(parts):
            tag = FragmentTag(round=round_num, fragment_id=p, fragments=P)
            path = work_dir / f"delta-{round_num}-p{p}.safetensors"
            with torch.no_grad():
                compress.write_delta(path, {n: wire_flat[n] for n in names}, wire_codec,
                                     ef=shard_ctx["efs"][p], tag=tag.header())
            paths[p] = path
        delta_norm = delta_norm_of(wire_flat) if report_quality else None
        del wire_flat
        trace.finish(enc_span)
        log.info("round %d: delta written in %.3f s (%d parts: %s bytes)", round_num,
                 time.perf_counter() - t_write, P, [paths[p].stat().st_size for p in paths])
        with trace.span("upload", parent=round_tp, node=rtrace.node,
                        attrs={"round": round_num, "codec": wire_codec, "parts": len(parts)}):
            for p, path in paths.items():
                push_part(p, path, samples)
        send_status(Progress(kind=ProgressKind.METRICS, job_id=spec.job_id, round=round_num,
                             metrics=round_metrics(samples, delta_norm), traceparent=round_tp))
        gens = shard_ctx["gens"]
        got: dict = {}
        with session.receive(cfg.results) as events:
            while len(got) < P:
                event = next(events, None)
                if event is None:
                    raise RuntimeError("results stream ended before every part's update "
                                       "broadcast")
                meta = event.get("meta") or {}
                try:
                    sid = int(meta.get(SHARD_KEY, 0))
                except (TypeError, ValueError):
                    sid = 0
                gens[sid], resend = restart_signal(meta, gens.get(sid))
                if resend:
                    # That shard restarted: re-send its parts not yet answered.
                    for p, path in paths.items():
                        if p in got or not path.is_file() \
                                or shard_of(p, len(shard_map.shards)) != sid:
                            continue
                        log.warning("ps shard %d restart detected; re-sending round %d part %d",
                                    sid, round_num, p)
                        push_part(p, path, samples)
                try:
                    eround = int(meta.get("round", round_num))
                except (TypeError, ValueError):
                    eround = round_num
                if meta.get(RESYNC_KEY) or meta.get(CATCHUP_KEY) or eround < round_num:
                    (work_dir / event["path"]).unlink(missing_ok=True)
                    continue
                etag = FragmentTag.from_header(meta)
                p = int(etag.fragment_id) if etag is not None else sid
                if p in got or p not in paths:
                    (work_dir / event["path"]).unlink(missing_ok=True)
                    continue
                got[p] = work_dir / event["path"]
                log.info("round %d: part %d update landed (shard %d)", round_num, p, sid)
        # Every part lands before any merges: disjoint tensors, one pass,
        # then one re-anchor (blocking: no drift correction).
        merge_span = trace.begin("merge", parent=round_tp, attrs={"round": round_num},
                                 node=rtrace.node)
        t_merge = time.perf_counter()
        merged = 0
        with torch.no_grad():
            for p in sorted(got):
                update = compress.read_delta(got[p], dev)
                if set(update) != set(parts[p]):
                    raise ValueError(f"part {p} placement mismatch: the update carries "
                                     f"{len(update)} tensors, the worker expects {len(parts[p])}")
                for name, u in flat_to_state(update).items():
                    prm = params[name]
                    prm.copy_(merge_update({name: prm}, {name: _fit(u, prm, name)})[name])
                    anchor[name].copy_(prm)
                    merged += 1
                del update
                got[p].unlink(missing_ok=True)
        if merged != len(params):
            raise KeyError(f"the parts' updates carry {merged} of {len(params)} tensors")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        trace.finish(merge_span)
        log.info("round %d: update merged in %.3f s (%d parts)", round_num,
                 time.perf_counter() - t_merge, P)
        log.info("round %d: anchor checksum %s", round_num + 1,
                 theta_checksum(state_to_flat(model, params)))
        for path in paths.values():
            path.unlink(missing_ok=True)
        maybe_checkpoint()
        resp = send_status(Progress(kind=ProgressKind.UPDATE_RECEIVED, job_id=spec.job_id,
                                    traceparent=round_tp))
        round_num += 1
        rtrace.adopt(resp, round_num)
        result.rounds = round_num
        round_samples = 0
        round_losses.clear()
        return resp.kind == ProgressResponseKind.CONTINUE

    def begin_stream_sync() -> None:
        """Ship the due fragment's Δθ in the background and keep stepping.
        The round's samples and losses reset here: the steps taken while
        the sync is in flight belong to the next delta."""
        nonlocal round_samples
        rtrace.close_inner()
        round_tp = rtrace.ctx(round_num)
        send_status(Progress(kind=ProgressKind.UPDATE, job_id=spec.job_id, traceparent=round_tp))
        stream_state.begin(round_num, round_samples)
        # No delta norm: the due fragment's delta belongs to the flight.
        send_status(Progress(kind=ProgressKind.METRICS, job_id=spec.job_id, round=round_num,
                             metrics=round_metrics(float(round_samples)), traceparent=round_tp))
        round_samples = 0
        round_losses.clear()

    def finish_stream_sync() -> bool:
        """The broadcast landed: merge with the correction. True = go on."""
        nonlocal round_num
        stream_state.finish()
        maybe_checkpoint()
        resp = send_status(Progress(kind=ProgressKind.UPDATE_RECEIVED, job_id=spec.job_id,
                                    traceparent=rtrace.ctx(round_num)))
        round_num += 1
        rtrace.adopt(resp, round_num)
        result.rounds = round_num
        return resp.kind == ProgressResponseKind.CONTINUE

    def batches() -> Iterator[dict]:
        yield first_batch
        while True:
            t_wait = time.monotonic()
            batch = next(stream, None)
            # The whole wait: host assembly and any slice fetch run inline.
            DATA_METRICS.note_input_wait(time.monotonic() - t_wait)
            if batch is None:
                return
            yield batch

    pin = pipeline_on and dev.type == "cuda"

    def place(batch: dict) -> tuple:
        """(the host tensors the copies read, the batch on the device). With
        the pipeline each batch is pinned afresh and copied without
        blocking, so the host goes on to the next batch; the pinned tensors
        stay referenced until the step's loss is read, after which no copy
        reads them."""
        if not pin:
            return None, {k: v.to(dev) for k, v in batch.items()}
        pinned = {k: v.pin_memory() for k, v in batch.items()}
        return pinned, {k: v.to(dev, non_blocking=True) for k, v in pinned.items()}

    # Deferred loss reads (the pipeline only): (loss, pinned batch) of the
    # steps dispatched but not yet read, flushed before every round-boundary
    # action that reports or resets ``round_losses`` and after the loop.
    pending: list = []

    def flush_pending_loss() -> None:
        while pending:
            value = float(pending.pop(0)[0])
            round_losses.append(value)
            result.losses.append(value)

    step_s: dict = {"flight": [], "no_flight": []}
    t0 = time.monotonic()
    model.train()
    try:
        for batch in batches():
            if should_stop is not None and should_stop():
                log.info("cooperative stop requested; ending training loop")
                break
            # Merge a landed broadcast before the next step: a sync that
            # completed with no step in between equals blocking's merge.
            if stream_state is not None and stream_state.poll():
                if not finish_stream_sync():
                    break
            rtrace.batch(round_num)
            overlapping = stream_state is not None and stream_state.in_flight
            if pipeline_on and not overlapping:
                # Dispatch step n, then read step n-1's loss (done on the
                # card by now), never this step's.
                pinned, placed = place(batch)
                loss, _total, _aux, _norm = step(placed)
                flush_pending_loss()
                pending.append((loss, pinned))
            else:
                t_step = time.perf_counter()
                loss, _total, _aux, _norm = step(place(batch)[1])
                value = float(loss)
                step_s["flight" if overlapping else "no_flight"].append(
                    time.perf_counter() - t_step)
                if overlapping:
                    stream_state.note_step(step_s["flight"][-1])
                flush_pending_loss()  # older deferred losses first
                round_losses.append(value)
                result.losses.append(value)
            result.batches += 1
            round_samples += cfg.batch_size
            if report_quality:
                note_quality_batch(batch)
            resp = send_status(Progress(kind=ProgressKind.STATUS, job_id=spec.job_id,
                                        batch_size=cfg.batch_size))
            if resp.kind == ProgressResponseKind.DONE:
                break
            adopted = adopt_schedule(resp, countdown)
            if adopted is not countdown:
                countdown = adopted
                rtrace.adopt(resp, round_num)
            if countdown is not None:
                if countdown <= 0:
                    countdown = None
                    # The round's last loss may still be deferred: it goes
                    # into round_losses before the sync reports them.
                    flush_pending_loss()
                    if stream_state is not None:
                        begin_stream_sync()
                    elif not (do_update_sharded() if shard_map is not None else do_update()):
                        break
                else:
                    countdown -= 1
            if max_batches is not None and result.batches >= max_batches:
                log.warning("max_batches=%d reached; stopping", max_batches)
                break
        flush_pending_loss()
    finally:
        rtrace.close_inner()
        # Stops the prefetch thread now, before the bridge goes away.
        stream.close()
        if stream_state is not None:
            stream_state.abort()
    log.info("training done: %d rounds, %d batches, %.1fs, last loss %.4f",
             result.rounds, result.batches, time.monotonic() - t0, result.last_loss)
    log.info("data metrics: %s", json.dumps(DATA_METRICS.snapshot()))
    if stream_state is not None:
        # Inner-step seconds (the loss read included) with a sync in
        # flight and without: what the overlap costs the steps.
        log.info("step seconds: %s", json.dumps(step_s))
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hypha-training-executor",
        description="hypha-tpu DiLoCo training executor (PyTorch)",
    )
    parser.add_argument("--socket", required=True, help="bridge unix socket path")
    parser.add_argument("--work-dir", required=True)
    parser.add_argument("--job", required=True, help="job spec JSON (inline or @file)")
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; without a CUDA device the "
                             "executor refuses to start unless this says cpu)")
    return parser


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    device = default_device(args.device)  # before anything else: no quiet host run

    raw = args.job
    if raw.startswith("@"):
        raw = Path(raw[1:]).read_text()
    spec = messages.from_json_dict(json.loads(raw))
    if not isinstance(spec, JobSpec):
        raise SystemExit(f"--job does not decode to a JobSpec: {type(spec)}")

    try:
        with Session(args.socket) as session:
            run_training(session, args.work_dir, spec, max_batches=args.max_batches,
                         device=device)
    finally:
        # What the attention path launched in this process, for the node's log.
        log.info("attention launches: %s", json.dumps({
            "fwd": flash_attention.fwd_launches, "dq": flash_attention.dq_launches,
            "dkv": flash_attention.dkv_launches, "flash_plain": flash_attention.plain_calls,
            "dense": dot_product_attention.calls,
        }))
        if device.type == "cuda":
            log.info("peak device memory: %.3f GiB", torch.cuda.max_memory_allocated(device) / 2**30)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
