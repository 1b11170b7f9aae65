"""The training executor: the DiLoCo inner loop (counterpart of the
blocking, unsharded, single-process path of
``hypha_tpu/executor/training.py``).

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
context manager yielding ``{"path", "meta"}`` events. The HTTP bridge
client, the CLI and every option of ``TrainExecutorConfig`` beyond this
path are not ported; each raises NotImplementedError naming its ROADMAP.md
item rather than being ignored.
"""

from __future__ import annotations

import logging
import math
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

from ..hw import default_device
from ..messages import (
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
from ..ops.flash_attention import flash_attention
from .dataset import stream_batches
from .diloco import extract_delta, merge_update
from .serialization import load_file, save_file
from .train import build_optimizer, make_train_step

__all__ = ["TrainResult", "adopt_schedule", "run_training"]

log = logging.getLogger("hypha.torch.executor.training")

# Results-stream header keys of the fault-tolerant parameter server
# (hypha_tpu/ft/durable.py, hypha_tpu/ft/rejoin.py).
GENERATION_KEY = "ps_generation"
RESYNC_KEY = "ps_resync"
CATCHUP_KEY = "catchup"


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
        (bool(cfg.rejoin), "rejoin", "codecs/streaming/sharded PS/FT/rejoin"),
        ((cfg.sync_mode or "blocking") != "blocking", "sync_mode",
         "codecs/streaming/sharded PS/FT/rejoin"),
        (bool(cfg.ps_shards and cfg.ps_shards.shards), "ps_shards",
         "codecs/streaming/sharded PS/FT/rejoin"),
        (bool(cfg.reduce_via or cfg.reduce_members or cfg.relay_results), "reduce_via",
         "codecs/streaming/sharded PS/FT/rejoin"),
        (cfg.delta_codec != "none", "delta_codec", "codecs/streaming/sharded PS/FT/rejoin"),
        (cfg.delta_dtype != "float32", "delta_dtype", "codecs/streaming/sharded PS/FT/rejoin"),
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
        with torch.no_grad():
            save_file(state_to_flat(model, extract_delta(params, anchor)), delta_path)
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
                break
        update_file = work_dir / event["path"]
        update = flat_to_state(load_file(update_file))
        with torch.no_grad():
            for name, p in params.items():
                if name not in update:
                    raise KeyError(f"update misses tensor {name!r} ({len(update)} tensors)")
                u = update[name]
                if tuple(u.shape) != tuple(p.shape):
                    if u.numel() != 1 or p.numel() != 1:
                        raise ValueError(f"update {name!r}: shape {tuple(u.shape)} != {tuple(p.shape)}")
                    u = u.reshape(p.shape)
                p.copy_(merge_update({name: p}, {name: u})[name])
                anchor[name].copy_(p)
        delta_path.unlink(missing_ok=True)
        update_file.unlink(missing_ok=True)
        resp = send_status(Progress(kind=ProgressKind.UPDATE_RECEIVED, job_id=spec.job_id))
        round_num += 1
        result.rounds = round_num
        round_samples = 0
        round_losses.clear()
        return resp.kind == ProgressResponseKind.CONTINUE

    def batches() -> Iterator[dict]:
        yield first_batch
        while True:
            batch = next(stream, None)
            if batch is None:
                return
            yield batch

    t0 = time.monotonic()
    model.train()
    try:
        for batch in batches():
            if should_stop is not None and should_stop():
                log.info("cooperative stop requested; ending training loop")
                break
            loss, _total, _aux, _norm = step({k: v.to(dev) for k, v in batch.items()})
            value = float(loss)
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
                    if not do_update():
                        break
                else:
                    countdown -= 1
            if max_batches is not None and result.batches >= max_batches:
                log.warning("max_batches=%d reached; stopping", max_batches)
                break
    finally:
        stream.close()
    log.info("training done: %d rounds, %d batches, %.1fs, last loss %.4f",
             result.rounds, result.batches, time.monotonic() - t0, result.last_loss)
    return result
