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
(``hypha_tpu_torch/compress``). ``sync_mode`` overlap and stream replace
the blocking update with :class:`_WorkerStream` (the reference's
``hypha_tpu/executor/training.py:213-584``): the due fragment's Δθ is
encoded and shipped by a flight thread while the inner steps go on, and
the landed update is merged with the delayed-update correction between
two steps.

Every other option of ``TrainExecutorConfig`` is not ported; each raises
NotImplementedError naming its ROADMAP.md item rather than being ignored.
"""

from __future__ import annotations

import argparse
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
from ..hw import default_device
from ..messages import (
    CODEC_KEY,
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
from ..models.convert import flat_to_state, llama_params_from_flat, state_to_flat
from ..models.registry import build_model
from ..ops.attention import dot_product_attention
from ..ops.flash_attention import flash_attention
from ..stream import effective_fragments, fragment_due, merge_corrected, partition_names
from .bridge_client import Session
from .dataset import stream_batches
from .diloco import extract_delta, merge_update
from .serialization import load_file
from .train import build_optimizer, make_train_step

__all__ = ["TrainResult", "adopt_schedule", "build_parser", "main", "run_training"]

log = logging.getLogger("hypha.torch.executor.training")

# Results-stream header keys of the fault-tolerant parameter server
# (hypha_tpu/ft/durable.py, hypha_tpu/ft/rejoin.py).
GENERATION_KEY = "ps_generation"
RESYNC_KEY = "ps_resync"
CATCHUP_KEY = "catchup"

# How long the loop waits on an in-flight sync before each batch (seconds;
# the reference's variable). 0 (the default) never waits: pure overlap.
# A large value merges every landed update before the next step, the
# zero-flight limit in which overlap equals blocking bit for bit.
_STREAM_POLL_WAIT_ENV = "HYPHA_STREAM_POLL_WAIT"

_FT = "sharded PS/FT/rejoin"


class TrainResult:
    """What the loop did: rounds merged, batches trained, every loss."""

    def __init__(self) -> None:
        self.rounds = 0
        self.batches = 0
        self.losses: list[float] = []

    @property
    def last_loss(self) -> float:
        return self.losses[-1] if self.losses else math.nan


def adopt_schedule(resp: ProgressResponse, countdown: "int | None") -> "int | None":
    """Take a SCHEDULE_UPDATE's counter only when no countdown runs (a
    re-adopting scheduler's repeated schedule must not re-run or skip inner
    steps the round already counted)."""
    if resp.kind != ProgressResponseKind.SCHEDULE_UPDATE:
        return countdown
    return resp.counter if countdown is None else countdown


def _restart_signal(meta: dict, last_gen: Any) -> tuple:
    """``(generation to remember, re-send the delta?)`` from one results
    event: a parameter-server generation bump or a resync announcement."""
    gen = meta.get(GENERATION_KEY)
    resync = bool(meta.get(RESYNC_KEY))
    if gen is None:
        return last_gen, resync
    return gen, resync or (last_gen is not None and gen != last_gen)


def _stale_response(resp: Any, last_gen: "int | None") -> tuple:
    """``(generation to remember, stale?)``: a response stamped with an
    older scheduler generation than one adopted is dropped."""
    gen = getattr(resp, "generation", None)
    if gen is None:
        return last_gen, False
    if last_gen is not None and gen < last_gen:
        return last_gen, True
    return gen, False


def _unsupported(cfg: TrainExecutorConfig) -> None:
    """Raise on every option this path does not run."""
    sharding = cfg.sharding or {}
    mesh = math.prod(int(sharding.get(a, 1)) for a in ("dp", "fsdp", "tp", "sp", "ep"))
    checks = [
        (mesh > 1, "sharding", "intra-replica sharding"),
        (bool(cfg.lora), "lora", "LoRA"),
        (bool(cfg.checkpoint and cfg.checkpoint.get("dir")), "checkpoint", "checkpoint resume"),
        (bool(cfg.rejoin), "rejoin", _FT),
        (bool(cfg.ps_shards and cfg.ps_shards.shards), "ps_shards", _FT),
        (bool(cfg.reduce_via), "reduce_via", _FT),
        (bool(cfg.reduce_members), "reduce_members", _FT),
        (bool(cfg.relay_results), "relay_results", _FT),
        (bool(cfg.input_pipeline), "input_pipeline", "input_pipeline"),
        (bool(cfg.preprocessor), "preprocessor", "preprocessor"),
        (bool(cfg.report_metrics_s), "report_metrics_s", "telemetry"),
    ]
    for bad, option, item in checks:
        if bad:
            raise NotImplementedError(
                f"{option}={getattr(cfg, option)!r} is not ported to the PyTorch trainer "
                f"(ROADMAP.md, Queue 1: {item})"
            )
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


def _refuse_codec_hint(meta: dict) -> None:
    if CODEC_KEY in meta:
        raise NotImplementedError(
            f"the broadcast carries a per-link codec hint ({meta[CODEC_KEY]!r}); adaptive "
            f"codecs are not ported to PyTorch yet (ROADMAP.md, Queue 1: {_FT})"
        )


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
                 model, params: dict, anchor: dict, device) -> None:
        self.session, self.cfg, self.work_dir = session, cfg, Path(work_dir)
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
        self._ps_gen: Any = None  # flight-thread confined

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
        flight = {
            "round": round_num, "frag": frag, "names": names, "snap": snap,
            "path": self.work_dir / f"delta-{round_num}-f{frag}.safetensors",
            "box": {"absorbed": []}, "t0": time.perf_counter(), "steps": 0,
            "samples": float(num_samples),
        }
        tag = FragmentTag(round=round_num, fragment_id=frag, fragments=self.F)
        thread = threading.Thread(target=self._flight_main, args=(flight, wire, tag),
                                  daemon=True, name=f"stream-sync-r{round_num}")
        flight["thread"] = thread
        self.flight = flight
        thread.start()

    def _flight_main(self, flight: dict, wire: dict, tag: FragmentTag) -> None:
        box = flight["box"]
        try:
            t0 = time.perf_counter()
            compress.write_delta(flight["path"], wire, self.codec, ef=self.efs[flight["frag"]],
                                 tag=tag.header())
            del wire
            log.info("round %d fragment %d: delta encoded in %.3f s (%d bytes)",
                     flight["round"], flight["frag"], time.perf_counter() - t0,
                     flight["path"].stat().st_size)
            self._send(flight, tag)
            box["completion"] = self._await_broadcast(flight)
            log.info("round %d fragment %d: broadcast landed %.3f s after the snapshot",
                     flight["round"], flight["frag"], time.perf_counter() - flight["t0"])
        except BaseException as e:  # hypha-lint: disable=swallowed-cancel
            box["error"] = e  # thread-bridge: re-raised at finish()

    def _send(self, flight: dict, tag: FragmentTag) -> None:
        self.session.send_resource(
            self.cfg.updates, flight["path"].name,
            resource=self.cfg.updates.ref.resource or "updates",
            meta={"num_samples": flight["samples"], **tag.header()})

    def _drop(self, event: dict) -> None:
        (self.work_dir / event["path"]).unlink(missing_ok=True)

    def _await_broadcast(self, flight: dict) -> dict:
        """Consume results events until this fragment's update lands. Other
        fragments' later updates are kept for ``finish`` to absorb; older
        rounds are applied state and dropped; a later round of this fragment
        completes the flight (this round's broadcast was lost). A parameter
        server restart re-sends the delta."""
        with self.session.receive(self.cfg.results) as events:
            for event in events:
                meta = event.get("meta") or {}
                self._ps_gen, resend = _restart_signal(meta, self._ps_gen)
                if resend and flight["path"].is_file():
                    log.warning("stream sync: parameter server restarted; re-sending round %d "
                                "fragment %d", flight["round"], flight["frag"])
                    self._send(flight, FragmentTag(flight["round"], flight["frag"], self.F))
                if meta.get(RESYNC_KEY) or meta.get(CATCHUP_KEY):
                    self._drop(event)
                    continue
                _refuse_codec_hint(meta)
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

    def note_step(self) -> None:
        if self.flight is not None:
            self.flight["steps"] += 1

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
        update_file = self.work_dir / box["completion"]["path"]
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
        log.info("round %d fragment %d: update merged in %.3f s; waited %.3f s for the flight; "
                 "%d steps in flight", flight["round"], flight["frag"], time.perf_counter() - t0,
                 waited, flight["steps"])
        update_file.unlink(missing_ok=True)
        flight["path"].unlink(missing_ok=True)

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
    """The model with its initial weights: a ``source`` file in native flat
    names, or the port's seeded init. Flash attention on CUDA."""
    spec = dict(cfg.model)
    model_type = spec.get("model_type", ModelType.CAUSAL_LM)
    if not isinstance(model_type, ModelType):
        model_type = ModelType(model_type)
    if model_type is not ModelType.CAUSAL_LM:
        raise NotImplementedError(
            f"model_type {model_type.value!r} is not ported (ROADMAP.md, Queue 1: model families)"
        )
    attn_impl = flash_attention if device.type == "cuda" else None
    log.info("attention path: %s", "flash kernels" if attn_impl else "plain (host)")
    model, _ = build_model(spec, device=device, attn_impl=attn_impl)
    model.init_weights(int(spec.get("seed", 0)))
    source = spec.get("source")
    if source is None:
        return model
    fetch = from_json_dict(source) if isinstance(source, dict) else source
    rels = session.fetch(fetch)
    files = [r for r in rels if r.endswith((".safetensors", ".bin", ".pt", ".pth"))]
    if any(not r.endswith(".safetensors") for r in files):
        raise NotImplementedError(
            f"initial weights {files}: only SafeTensors files in native flat names are "
            "ported (ROADMAP.md, Queue 1: HF checkpoints)"
        )
    if not files:  # a source without weights keeps the seeded init, as in the JAX trainer
        return model
    state: dict = {}
    for r in files:
        state.update(load_file(work_dir / r))
    try:
        llama_params_from_flat(state, model)
    except KeyError as e:
        raise NotImplementedError(
            f"initial weights are not in native flat names ({e}); HF-format state dicts "
            "are not ported (ROADMAP.md, Queue 1: HF checkpoints)"
        ) from e
    log.info("loaded %d initial tensors from %s", len(state), files)
    return model


def run_training(
    session,
    work_dir: "Path | str",
    spec: JobSpec,
    *,
    max_batches: "int | None" = None,
    should_stop: "Callable[[], bool] | None" = None,
    device=None,
) -> TrainResult:
    """Run the DiLoCo inner loop to completion over ``session``, on
    ``device`` (CUDA unless the caller asks for the CPU). ``max_batches``
    is a safety valve for tests; ``should_stop`` is polled between
    batches."""
    work_dir = Path(work_dir)
    cfg = spec.executor.train
    if cfg is None:
        raise ValueError(f"job {spec.job_id} is not a train job")
    _unsupported(cfg)
    dev = default_device(device)

    def fetch_slice() -> str:
        return str(work_dir / session.fetch(cfg.data)[0])

    stream = stream_batches(fetch_slice, cfg.batch_size, dict(cfg.model).get("input_names"))
    first_batch = next(stream)
    model = _init_model(cfg, session, work_dir, dev)
    optimizer = build_optimizer(list(model.parameters()), cfg.optimizer, cfg.scheduler)
    step = make_train_step(model, optimizer, cfg.loss or Loss.CROSS_ENTROPY)
    params = model.state_dict()  # aliases of the parameters, updated in place
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
                                     params, anchor, dev)
        log.info("streaming outer sync: mode=%s fragments=%d codec=%s", sync_mode,
                 stream_state.F, wire_codec)

    result = TrainResult()
    countdown: "int | None" = None
    round_num = 0
    round_samples = 0
    round_losses: list[float] = []
    gens: dict = {"ps": None, "sched": None}

    def send_status(progress: Progress) -> ProgressResponse:
        """session.send_status, dropping a stale scheduler generation's answers."""
        for _ in range(64):
            if gens["sched"] is not None and int(gens["sched"]) >= 2:
                progress.scheduler_generation = int(gens["sched"])
            resp = session.send_status(progress)
            gens["sched"], stale = _stale_response(resp, gens["sched"])
            if not stale:
                return resp
            log.warning("dropping a %s response from a stale scheduler generation",
                        progress.kind.value)
            time.sleep(0.2)
        raise RuntimeError("scheduler kept answering from a stale generation")

    def push_delta(delta_path: Path) -> None:
        session.send_resource(
            cfg.updates, delta_path.name, resource=cfg.updates.ref.resource or "updates",
            meta={"num_samples": float(round_samples), "round": round_num},
        )

    def do_update() -> bool:
        """Ship Δθ, wait for the broadcast, merge. True = next round."""
        nonlocal round_num, round_samples
        send_status(Progress(kind=ProgressKind.UPDATE, job_id=spec.job_id))
        delta_path = work_dir / f"delta-{round_num}.safetensors"
        t_write = time.perf_counter()
        with torch.no_grad():
            compress.write_delta(delta_path, state_to_flat(model, extract_delta(params, anchor)),
                                 wire_codec, ef=delta_ef)
        log.info("round %d: delta written in %.3f s", round_num, time.perf_counter() - t_write)
        push_delta(delta_path)
        mean_loss = sum(round_losses) / len(round_losses) if round_losses else math.nan
        send_status(Progress(kind=ProgressKind.METRICS, job_id=spec.job_id, round=round_num,
                             metrics={"loss": mean_loss, "samples": float(round_samples)}))
        with session.receive(cfg.results) as events:
            while True:
                event = next(events, None)
                if event is None:
                    raise RuntimeError("results stream ended before the round's update broadcast")
                meta = event.get("meta") or {}
                gens["ps"], resend = _restart_signal(meta, gens["ps"])
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
                _refuse_codec_hint(meta)
                break
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
        log.info("round %d: update merged in %.3f s", round_num, time.perf_counter() - t_merge)
        delta_path.unlink(missing_ok=True)
        update_file.unlink(missing_ok=True)
        resp = send_status(Progress(kind=ProgressKind.UPDATE_RECEIVED, job_id=spec.job_id))
        round_num += 1
        result.rounds = round_num
        round_samples = 0
        round_losses.clear()
        return resp.kind == ProgressResponseKind.CONTINUE

    def begin_stream_sync() -> None:
        """Ship the due fragment's Δθ in the background and keep stepping.
        The round's samples and losses reset here: the steps taken while
        the sync is in flight belong to the next delta."""
        nonlocal round_samples
        send_status(Progress(kind=ProgressKind.UPDATE, job_id=spec.job_id))
        stream_state.begin(round_num, round_samples)
        mean_loss = sum(round_losses) / len(round_losses) if round_losses else math.nan
        send_status(Progress(kind=ProgressKind.METRICS, job_id=spec.job_id, round=round_num,
                             metrics={"loss": mean_loss, "samples": float(round_samples)}))
        round_samples = 0
        round_losses.clear()

    def finish_stream_sync() -> bool:
        """The broadcast landed: merge with the correction. True = go on."""
        nonlocal round_num
        stream_state.finish()
        resp = send_status(Progress(kind=ProgressKind.UPDATE_RECEIVED, job_id=spec.job_id))
        round_num += 1
        result.rounds = round_num
        return resp.kind == ProgressResponseKind.CONTINUE

    def batches() -> Iterator[dict]:
        yield first_batch
        while True:
            batch = next(stream, None)
            if batch is None:
                return
            yield batch

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
            overlapping = stream_state is not None and stream_state.in_flight
            t_step = time.perf_counter()
            loss, _total, _aux, _norm = step({k: v.to(dev) for k, v in batch.items()})
            value = float(loss)
            step_s["flight" if overlapping else "no_flight"].append(time.perf_counter() - t_step)
            if overlapping:
                stream_state.note_step()
            round_losses.append(value)
            result.losses.append(value)
            result.batches += 1
            round_samples += cfg.batch_size
            resp = send_status(Progress(kind=ProgressKind.STATUS, job_id=spec.job_id,
                                        batch_size=cfg.batch_size))
            if resp.kind == ProgressResponseKind.DONE:
                break
            countdown = adopt_schedule(resp, countdown)
            if countdown is not None:
                if countdown <= 0:
                    countdown = None
                    if stream_state is not None:
                        begin_stream_sync()
                    elif not do_update():
                        break
                else:
                    countdown -= 1
            if max_batches is not None and result.batches >= max_batches:
                log.warning("max_batches=%d reached; stopping", max_batches)
                break
    finally:
        stream.close()
        if stream_state is not None:
            stream_state.abort()
    log.info("training done: %d rounds, %d batches, %.1fs, last loss %.4f",
             result.rounds, result.batches, time.monotonic() - t0, result.last_loss)
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
