"""In-process inference executor: load a model, serve GenerateRequest RPCs
(counterpart of ``hypha_tpu/worker/infer_executor.py``).

The scheduler dispatches an ``Executor(kind="infer")`` job, the worker
loads the model on its device, announces ``serve:<name>`` in the registry,
and answers ``/hypha-generate/0.0.1`` RPCs until the job is cancelled or
its lease expires. Greedy requests go through the paged, ragged
``DecodePool`` (``scheduling`` "continuous"), the window batcher
(``"window"``), or, with a negative window, independent one-shot decodes.

Behind a request router (``load_report_s > 0``) the backend heartbeats
``ServeLoad`` (queue depth, free KV blocks) to the scheduler peer that
dispatched it, once its handler is registered: the first heartbeat tells
the router it is ready. It serves under the router's backend name
(``<name>@<slot>``) and announces that name, not the public one.

**Fleet prefix cache and KV migration** (``pool_fleet_cache`` /
``pool_kv_migration``), as in the reference, on ``/hypha-blocks``: the
heartbeat carries the pool's digest of hot chains; a request the router
stamps with ``pull_peer`` first pulls its prompt's chain from that holder
(``BlockPull`` -> ``BlockChain``) into the local prefix cache, unless the
job's ``LinkTable`` says the link is slower than local prefill; any
failure is a miss and admission re-prefills. The backend answers pulls
for chains it holds (``handle_pull``) and, with migration on, takes
preempted requests from other backends (``MigrateRequest``: inject the
blocks, decode the rest, answer ``MigrateAck``); its own preempted
single-prompt groups ship to the router-named target from the last
heartbeat ack when the link beats recompute (``migrate_policy``), and come
back for recompute-resume on any failure. One block plane frame carries a
whole chain, so a chain past the fabric's ``MAX_FRAME`` fails to send and
ends as such a miss or requeue, as in the reference. Each pull and
migration, and each failure with its seconds, is logged.

**Live weight swap** (``serve_follow_rounds``, a ``WeightFollow``): a
continuous-mode job starts a ``serving.WeightSubscriber`` on the training
job's update broadcast, its files under ``<work root>/<job id>`` (removed
with the job); it stages each whole round and the pool flips at a serve
iteration's start. Any other mode fails the job with the reference's
``ValueError``. A following backend stamps every ``GenerateResponse``
with the ``(weight_round, weight_generation)`` it serves when the tokens
come back, and its heartbeats and block-plane messages carry the same
stamps, so fleet pulls and migrations between backends on different
rounds are refused and recomputed.

Each time the backend goes idle, and when the job ends, the executor
logs ``serve launches: {...}``: the ragged kernel's launches by route
since the job started, the plain attention calls, the pool's one-shot
fallbacks and its requests; then ``serve cache: {...}``: the pool's
prefill and decode chunks, preemptions, prefix-cache hit and missed
blocks, copy-on-writes, the blocks cached and shared at that moment,
backpressure rejections, and with the fleet cache or migration on the
fleet counts (``FLEET_STATS``), migrations out and requeues; and on CUDA
the peak device memory while serving (the load's peak and seconds are
logged when the model is ready). The last of each line holds the job's
totals. ``chip_smoke.py`` reads them from the worker's output.

A traced request (``GenerateRequest.traceparent``, the router's ``route``
span) gets a ``serve`` span on this worker, under which the pool files its
``prefill`` and ``decode`` spans.

Clients: :func:`generate_remote` — find providers of ``serve:<name>``
through the gateway registry, RPC the first reachable one.

With ``report_metrics_s`` (the live metrics plane) the backend runs a
:class:`~hypha_tpu_torch.telemetry.metrics_plane.MetricsReporter` under
``<peer>:<serve_name>``: the pool's gauges, request-latency summaries,
fleet counts and fabric bytes go to the scheduler's collector
(``metrics_peer``) until the job ends. Pool options the port lacks raise in
``DecodePool`` and fail the job.
"""

from __future__ import annotations

import asyncio
import json
import logging
import shutil
import tempfile
import time
from pathlib import Path

import torch

from .. import aio
from ..executor.block_cache import chain_hashes
from ..executor.generate import generate
from ..executor.pool import FLEET_STATS, PoolBusy, StaleBlockGeneration
from ..executor.serialization import load_file
from ..ft.adaptive import LinkTable
from ..hw import default_device
from ..messages import (
    PROTOCOL_BLOCKS, PROTOCOL_GENERATE, PROTOCOL_SERVE, BlockChain, BlockPull, GenerateRequest,
    GenerateResponse, JobSpec, MigrateAck, MigrateRequest, ServeLoad,
)
from ..models.convert import (convert_checkpoint, convert_state_dict, llama_params_from_flat,
                              load_checkpoint_files, load_state)
from ..models.registry import build_model
from ..network.node import Node, RequestError
from ..ops.kvcache import leaves_from_wire, leaves_nbytes, leaves_to_wire
from ..ops.paged_attention import paged_attention, ragged_paged_attention
from ..telemetry import trace
from ..telemetry.metrics_plane import MetricsReporter
from .batcher import RequestBatcher
from .job_manager import Execution, JobExecutor

__all__ = [
    "InProcessInferExecutor", "generate_remote", "serve_key", "load_model", "generate_grouped",
]

log = logging.getLogger("hypha.torch.worker.infer_executor")


def serve_key(name: str) -> str:
    return f"serve:{name}"


def load_model(model_spec: dict, device=None):
    """Build the spec's model on ``device`` (CUDA by default) in the serving
    dtype (``serve_dtype``: ``"bfloat16"`` by default, ``"float32"`` opts
    out) and fill it with a seeded init (``seed``, default 0; each
    parameter drawn in f32 and rounded, so the bits are an f32 init's cast)
    or the checkpoint at ``weights``: an HF repo directory or
    ``.index.json`` streams tensor by tensor into the parameters in the
    serving dtype (``convert_checkpoint``); a single file loads in native
    flat names (as the JAX package's ``flatten_tree`` gives them) or, failing
    those, in the family's HF names. Built on the meta device and allocated
    in the serving dtype, a bf16 model never holds an f32 copy."""
    dev = default_device(device)
    serve_dtype = model_spec.get("serve_dtype", "bfloat16")
    if serve_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"serve_dtype must be 'bfloat16' or 'float32', got {serve_dtype!r}")
    model, _cfg = build_model(model_spec, device="meta")
    model = _empty_in(model, dev, getattr(torch, serve_dtype))
    path = model_spec.get("weights")
    family = model_spec.get("family", "llama")
    if path and (Path(path).is_dir() or str(path).endswith(".index.json")):
        convert_checkpoint(family, path, model)
    elif path:
        torch_file = str(path).endswith((".bin", ".pt", ".pth"))
        state = load_checkpoint_files([path]) if torch_file else load_file(path)
        try:
            llama_params_from_flat(state, model)
        except KeyError:
            load_state(model, convert_state_dict(family, state, model, dtype=model.embed_tokens.dtype))
    else:
        model.init_weights(int(model_spec.get("seed", 0)))
    model.requires_grad_(False)
    return model.eval()


def _empty_in(model, device, dtype):
    """``model`` (on the meta device) with every parameter allocated, empty,
    on ``device`` in ``dtype``."""
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, torch.nn.Parameter(
                torch.empty(p.shape, dtype=dtype, device=device), requires_grad=False))
    return model


def generate_grouped(model, prompts, n_new, temperature, top_k, seed) -> list:
    """Blocking one-shot generation (the pool's fallback and the
    negative-window mode): prompts of equal length batch together; order
    is preserved."""
    by_len: dict = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    out: list = [None] * len(prompts)
    for idxs in by_len.values():
        gen = torch.Generator(device=model.device).manual_seed(int(seed))
        toks = generate(
            model, [prompts[i] for i in idxs], n_new, temperature=temperature,
            top_k=top_k, generator=gen,
        ).cpu()
        for row, i in enumerate(idxs):
            out[i] = toks[row].tolist()
    return out


def _attention_counts() -> dict:
    r = ragged_paged_attention
    return {"mma": r.mma_launches, "decode": r.decode_launches, "simt": r.simt_launches,
            "plain": paged_attention.plain_calls}


class InProcessInferExecutor(JobExecutor):
    """Serves infer jobs on ``device``. ``batchers`` holds the live
    request server of each job (tests read it)."""

    def __init__(self, node: Node, device: torch.device,
                 work_root: "Path | str | None" = None) -> None:
        self.node = node
        self.work_root = Path(work_root or tempfile.gettempdir())
        if device.type == "cuda" and device.index is None:
            # The serving threads set their device explicitly: name it.
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.batchers: dict = {}

    def _on_device(self, fn, *args):
        """Run ``fn`` in a worker thread on the executor's device: the
        current CUDA device is thread-local."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        return fn(*args)

    async def execute(self, job_id: str, spec: JobSpec, scheduler_peer: str) -> Execution:
        cfg = spec.executor.infer
        if cfg is None:
            raise ValueError(f"job {job_id} is not an infer job")
        if cfg.scheduling not in ("auto", "continuous", "window"):
            raise ValueError(
                f"scheduling must be auto|continuous|window, got {cfg.scheduling!r}"
            )

        # Return the Execution at once: a 7B load takes seconds to minutes,
        # and the dispatch RPC (and lease-expiry cancellation) must not
        # wait for it. The model loads in a thread; the handler registers
        # once it is ready.
        execution = Execution(job_id)
        loaded: dict = {}
        cancelled = asyncio.Event()
        counts0 = _attention_counts()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

        busy = {"requests": 0}

        async def logged(work):
            """Await ``work`` (a request or a migrated one), logging the
            counts so far each time the backend goes idle, before the
            answer leaves: a worker that is killed later still leaves them
            in its log."""
            busy["requests"] += 1
            try:
                return await work
            finally:
                busy["requests"] -= 1
                if not busy["requests"]:
                    self._log_launches(job_id, counts0, loaded.get("batcher"))

        async def handle(peer: str, req: GenerateRequest) -> GenerateResponse:
            return await logged(answer(req))

        async def answer(req: GenerateRequest) -> GenerateResponse:
            if len(req.prompts) > cfg.max_batch:
                raise ValueError(f"{len(req.prompts)} prompts exceed max_batch {cfg.max_batch}")
            if not req.prompts or any(not p for p in req.prompts):
                raise ValueError("prompts must be non-empty token id lists")
            n_new = min(int(req.max_new_tokens), cfg.max_new_tokens)
            temperature = cfg.temperature if req.temperature is None else req.temperature
            top_k = cfg.top_k if req.top_k is None else req.top_k
            # Serve-path tracing: a child of the router's ``route`` span (a
            # no-op when the request carries no context or tracing is off).
            with trace.span("serve", parent=req.traceparent, node=self.node.peer_id,
                            attrs={"serve_name": req.serve_name,
                                   "prompts": len(req.prompts)}) as serve_span:
                return await serve_request(req, n_new, temperature, top_k, serve_span)

        async def serve_request(req: GenerateRequest, n_new: int, temperature, top_k,
                                serve_span) -> GenerateResponse:
            batcher = loaded.get("batcher")
            if batcher is None:  # batch_window_ms < 0: independent decodes
                tokens = await asyncio.to_thread(
                    self._on_device, generate_grouped, loaded["model"],
                    req.prompts, n_new, temperature, top_k, req.seed,
                )
                return GenerateResponse(tokens=tokens)
            pool = getattr(batcher, "pool", None)
            if (req.pull_peer and loaded.get("link") is not None and pool.fleet_cache
                    and len(req.prompts) == 1 and temperature == 0.0):
                # The router says this prompt's longest cached prefix lives
                # elsewhere: pull the chain before admission, so the local
                # prefix hit skips its prefill. A failure is a miss.
                await self._fleet_pull(req, pool, loaded["link"])
            try:
                tokens = await batcher.submit(req.prompts, n_new, temperature, top_k, req.seed,
                                              traceparent=trace.traceparent_of(serve_span))
            except PoolBusy as busy:
                # Backpressure is a response, not an error: the client
                # retries after the hint.
                return GenerateResponse(tokens=[], ok=False,
                                        retry_after_ms=busy.retry_after_s * 1e3)
            # A follower stamps the (round, generation) it serves; one that
            # follows nothing leaves both off the wire.
            wr = wg = None
            if cfg.serve_follow_rounds is not None and hasattr(batcher, "weight_state"):
                wr, wg = batcher.weight_state()
            return GenerateResponse(tokens=tokens, weight_round=wr, weight_generation=wg)

        async def bring_up() -> None:
            t0 = time.perf_counter()
            try:
                model = await asyncio.to_thread(
                    self._on_device, load_model, dict(cfg.model), self.device)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.exception("infer job %s model load failed", job_id)
                execution.finish("failed", str(e))
                return
            if cancelled.is_set():
                return
            if self.device.type == "cuda":
                # The load's peak (an f32 build cast to the serving dtype)
                # is logged apart from the serving peak the job ends with.
                log.info("job %s model loaded in %.3f s, peak device memory %.3f GiB",
                         job_id, time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated(self.device) / 2**30)
                torch.cuda.reset_peak_memory_stats(self.device)
            else:
                log.info("job %s model loaded in %.3f s", job_id, time.perf_counter() - t0)
            try:
                serve(model)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # A bad pool geometry or an unported pool option must report
                # "failed" like a bad model spec, not leave the job wedged
                # with no handler and no terminal status.
                log.exception("infer job %s bring-up failed", job_id)
                execution.finish("failed", str(e))
                return
            try:
                await self.node.provide(serve_key(cfg.serve_name))
            except RequestError as e:
                log.warning("serve announce for %s failed: %s", cfg.serve_name, e)
            log.info("job %s serving %s", job_id, cfg.serve_name)

        def serve(model) -> None:
            loaded["model"] = model

            def fallback(prompts, n_new, temperature, top_k, seed):
                return self._on_device(generate_grouped, model, prompts, n_new, temperature,
                                       top_k, seed)

            # "auto": the JAX executor asks its ``supports_pool`` whether
            # the family has a per-row decode path. The port has no such
            # test because every model its registry builds (the Llama
            # lineage and Mixtral) has one: auto is continuous unless a
            # negative window opts into independent decodes.
            mode = cfg.scheduling
            if mode == "auto":
                mode = "window" if cfg.batch_window_ms < 0 else "continuous"
            if mode == "continuous":
                from .continuous import PoolServer

                limit = getattr(model.config, "max_seq_len", None) or 1024
                loaded["batcher"] = self.batchers[job_id] = PoolServer(
                    model, fallback,
                    slots=cfg.pool_slots or cfg.max_batch,
                    max_len=cfg.pool_max_len or min(int(limit), 1024),
                    steps_per_call=cfg.pool_chunk,
                    eos_token_id=cfg.eos_token_id,
                    block_size=cfg.pool_block_size,
                    num_blocks=cfg.pool_blocks,
                    prefill_chunk=cfg.pool_prefill_chunk,
                    max_queue=cfg.queue_limit,
                    prefix_cache=cfg.pool_prefix_cache,
                    spec_ngram=cfg.pool_spec_ngram,
                    spec_draft=cfg.pool_spec_draft,
                    ragged=cfg.pool_ragged,
                    kv_quant=cfg.pool_kv_quant,
                    spec_layers=cfg.pool_spec_layers,
                    fleet_cache=bool(cfg.pool_fleet_cache),
                    kv_migration=bool(cfg.pool_kv_migration),
                    digest_k=cfg.fleet_digest_k or 32,
                )
            elif cfg.batch_window_ms >= 0:
                loaded["batcher"] = self.batchers[job_id] = RequestBatcher(
                    fallback, max_batch=cfg.max_batch, window_s=cfg.batch_window_ms / 1e3,
                )
            if cfg.serve_follow_rounds is not None:
                # Only the continuous pool can swap its weights.
                if mode != "continuous":
                    raise ValueError("serve_follow_rounds requires continuous scheduling "
                                     f"(resolved mode is {mode!r})")
                from ..serving.weight_stream import WeightSubscriber

                loaded["weights"] = sub = WeightSubscriber(
                    self.node, cfg.serve_follow_rounds, loaded["batcher"].pool,
                    work_dir=self.work_root / job_id / "weight-stream", device=self.device)
                sub.start()
                log.info("job %s follows %s from round %d", job_id,
                         cfg.serve_follow_rounds.results.ref.resource,
                         cfg.serve_follow_rounds.round)
            pool = getattr(loaded.get("batcher"), "pool", None)
            if pool is not None and (pool.fleet_cache or pool.kv_migration):
                self._serve_blocks(cfg, pool, loaded, logged)
            loaded["reg"] = (
                self.node.on(PROTOCOL_GENERATE, GenerateRequest)
                .match(lambda m: m.serve_name == cfg.serve_name)
                .concurrency(64 if "batcher" in loaded else 4)
                .respond_with(handle)
            )
            if cfg.load_report_s > 0 and scheduler_peer:
                # Every scheduling mode heartbeats: the router takes the
                # first ServeLoad as "ready", and the handler is in place.
                loaded["reporter"] = aio.spawn(
                    self._report_load(job_id, cfg, loaded.get("batcher"), scheduler_peer,
                                      loaded.get("hints")),
                    what="serve load reporter", logger=log,
                )
            if cfg.report_metrics_s:
                # The live metrics plane: the pool's gauges, latency
                # summaries and fabric bytes to the scheduler's collector.
                loaded["metrics"] = MetricsReporter(
                    self.node, cfg.metrics_peer or scheduler_peer, job_id,
                    peer=f"{self.node.peer_id}:{cfg.serve_name}",
                    interval_s=float(cfg.report_metrics_s)).start()

        loader = asyncio.create_task(bring_up())

        # A serving job runs until cancelled (or its lease expires).
        async def cancel() -> None:
            cancelled.set()
            for reg in ("reg", "blocks", "migrate"):
                if loaded.get(reg) is not None:
                    loaded[reg].close()
            await aio.reap(loaded.get("reporter"))
            if loaded.get("metrics") is not None:
                await loaded["metrics"].stop()
            if loaded.get("weights") is not None:
                await loaded["weights"].stop()
                log.info("job %s weight stream: %s", job_id,
                         json.dumps(loaded["weights"].stats()))
            batcher = self.batchers.pop(job_id, None)
            if batcher is not None:
                batcher.close()
                pool = getattr(batcher, "pool", None)
                if pool is not None:
                    # Wait for the serve thread to exit, so the pool's KV
                    # blocks and its hold on the weights go with the job.
                    await asyncio.to_thread(pool.close)
            self._log_launches(job_id, counts0, batcher)
            loaded.clear()
            # Withdraw discovery: stop re-announcing and delete the
            # registry entry, so clients do not find a dead server.
            await self.node.unprovide(serve_key(cfg.serve_name))
            if not loader.done():
                loader.cancel()
            await asyncio.to_thread(shutil.rmtree, self.work_root / job_id, ignore_errors=True)
            execution.finish("cancelled")

        execution.cancel = cancel  # type: ignore[method-assign]
        return execution

    def _serve_blocks(self, cfg, pool, loaded: dict, logged) -> None:
        """The job's block plane: one ``LinkTable`` (fleet pulls feed it;
        the pull pre-check and the migration policy read it), the
        ``BlockPull`` handler, and with migration on the ``MigrateRequest``
        handler (its work counted as a request's by ``logged``) and the
        pool's migration hooks."""
        loaded["link"] = link = LinkTable()

        async def handle_pull(peer: str, m: BlockPull) -> BlockChain:
            wr, wg = pool.weight_state()
            if (m.weight_round, m.weight_generation) != (wr, wg):
                # KV computed under other weights must not be reused.
                return BlockChain(ok=False, error="stale-generation",
                                  weight_round=wr, weight_generation=wg)
            try:
                res = await asyncio.wrap_future(pool.serve_chain(m.chain_hashes or []))
            except Exception as e:  # noqa: BLE001 — RPC boundary
                return BlockChain(ok=False, error=str(e), weight_round=wr, weight_generation=wg)
            if not res:
                return BlockChain(ok=False, error="not-cached",
                                  weight_round=wr, weight_generation=wg)
            # Counted here, before the reply is framed, as the reference
            # counts it: a reply past MAX_FRAME still counts as shipped.
            pool.count("blocks_shipped", len(res["hashes"]))
            pool.count("block_bytes_shipped", leaves_nbytes(res["leaves"]))
            return BlockChain(
                ok=True, chain_hash=res["hashes"][-1], hashes=res["hashes"],
                block_size=pool.block_size, leaves=leaves_to_wire(res["leaves"]),
                weight_round=wr, weight_generation=wg,
            )

        loaded["blocks"] = (
            self.node.on(PROTOCOL_BLOCKS, BlockPull)
            .match(lambda m: m.serve_name == cfg.serve_name)
            .concurrency(8)
            .respond_with(handle_pull)
        )
        if not pool.kv_migration:
            return
        loaded["hints"] = hints = {}
        loop = asyncio.get_running_loop()

        async def handle_migrate(peer: str, m: MigrateRequest) -> MigrateAck:
            return await logged(take_migrated(m))

        async def take_migrated(m: MigrateRequest) -> MigrateAck:
            if m.block_size != pool.block_size:
                return MigrateAck(ok=False, error="geometry-mismatch")
            try:
                await asyncio.wrap_future(pool.inject_chain(
                    m.chain_hashes or [], leaves_from_wire(m.leaves or {}),
                    m.weight_round, m.weight_generation))
            except StaleBlockGeneration:
                return MigrateAck(ok=False, error="stale-generation")
            except Exception as e:  # noqa: BLE001 — RPC boundary
                return MigrateAck(ok=False, error=str(e))
            resume = list(m.prompt or []) + list(m.emitted or [])
            try:
                toks = await asyncio.wrap_future(pool.submit([resume], int(m.budget or 0)))
            except PoolBusy as busy:
                return MigrateAck(ok=False, error="busy",
                                  retry_after_ms=busy.retry_after_s * 1e3)
            except Exception as e:  # noqa: BLE001 — RPC boundary
                return MigrateAck(ok=False, error=str(e))
            return MigrateAck(ok=True, tokens=toks[0])

        loaded["migrate"] = (
            self.node.on(PROTOCOL_BLOCKS, MigrateRequest)
            .match(lambda m: m.serve_name == cfg.serve_name)
            .concurrency(4)
            .respond_with(handle_migrate)
        )

        def migrate_policy(est_bytes: int, resume_tokens: int):
            # On the serve thread: ship when the measured link moves the
            # bytes faster than local prefill recomputes the tokens; an
            # unmeasured link ships.
            target = hints.get("peer")
            if not target:
                return None
            bw = link.bandwidth_bps(target)
            cost = pool.prefill_cost_s(resume_tokens)
            if bw is not None and cost is not None and est_bytes * 8.0 / bw >= cost:
                pool.count("recompute_chosen")
                return None
            pool.count("transfer_chosen")
            return (target, hints.get("serve"))

        def migrate_send(ticket: dict) -> None:
            # Serve thread -> event loop: the sender owns the group now.
            loop.call_soon_threadsafe(lambda: aio.spawn(
                self._migrate_out(ticket, pool), what="kv migration", logger=log))

        pool.set_migrate_hooks(migrate_policy, migrate_send)

    async def _fleet_pull(self, req: GenerateRequest, pool, link) -> None:
        """Pull the prompt's chain from the router-named holder into the
        local prefix cache before admission. Every failure (the policy
        picks recompute, the holder evicted the chain, a stale stamp, a
        link error or an oversized frame) counts as a miss and admission
        re-prefills."""
        prompt = list(req.prompts[0])
        hashes = chain_hashes(prompt, pool.block_size)
        if not hashes:
            return
        # Transfer against recompute on the measured link; an unmeasured
        # link pulls (the RPC seeds the estimate).
        bw = link.bandwidth_bps(req.pull_peer)
        cost = pool.prefill_cost_s(len(prompt))
        est = len(hashes) * pool._block_nbytes()
        if bw is not None and cost is not None and est * 8.0 / bw >= cost:
            pool.count("recompute_chosen")
            pool.count("remote_prefix_misses")
            return
        pool.count("transfer_chosen")
        wr, wg = pool.weight_state()
        t0 = time.perf_counter()
        try:
            resp = await self.node.request(
                req.pull_peer, PROTOCOL_BLOCKS,
                BlockPull(serve_name=req.pull_serve or "", chain_hashes=hashes,
                          weight_round=wr, weight_generation=wg),
                timeout=10.0,
            )
        except (RequestError, asyncio.TimeoutError, OSError) as e:
            log.info("fleet pull from %s failed after %.3f s (%d blocks asked): %s",
                     req.pull_peer, time.perf_counter() - t0, len(hashes), e)
            pool.count("remote_prefix_misses")
            return
        rpc_s = time.perf_counter() - t0
        if not getattr(resp, "ok", False) or not resp.hashes or resp.block_size != pool.block_size:
            log.info("fleet pull from %s refused: %s", req.pull_peer, getattr(resp, "error", None))
            pool.count("remote_prefix_misses")
            return
        leaves = leaves_from_wire(resp.leaves or {})
        nbytes = leaves_nbytes(leaves)
        bw = link.observe(req.pull_peer, nbytes, max(rpc_s, 1e-6))
        try:
            injected = await asyncio.wrap_future(pool.inject_chain(
                resp.hashes, leaves, resp.weight_round, resp.weight_generation))
        except Exception as e:  # noqa: BLE001 — a pull is best-effort
            log.info("fleet inject from %s failed: %s", req.pull_peer, e)
            pool.count("remote_prefix_misses")
            return
        log.info("fleet pull from %s: %d blocks, %d bytes in %.6f s; %d injected; "
                 "link estimate %.1f bit/s", req.pull_peer, len(resp.hashes), nbytes, rpc_s,
                 injected, bw)
        if injected > 0:
            pool.count("remote_prefix_hits", injected)
        else:
            pool.count("remote_prefix_misses")

    async def _migrate_out(self, ticket: dict, pool) -> None:
        """Ship one preempted request to the router-named target and
        resolve its future with the target's continuation, or hand it back
        to the pool for recompute-resume. This backend stays the client's
        endpoint."""
        group = ticket["group"]
        peer, serve = ticket["target"]
        nbytes = leaves_nbytes(ticket["leaves"])
        t0 = time.perf_counter()
        try:
            msg = MigrateRequest(
                serve_name=serve or "", prompt=ticket["prompt"], emitted=ticket["emitted"],
                budget=ticket["budget"], chain_hashes=ticket["hashes"],
                block_size=ticket["block_size"], leaves=leaves_to_wire(ticket["leaves"]),
                weight_round=ticket["weight_round"],
                weight_generation=ticket["weight_generation"],
            )
            ack = await self.node.request(peer, PROTOCOL_BLOCKS, msg, timeout=120.0)
        except (RequestError, asyncio.TimeoutError, OSError) as e:
            log.info("migration to %s failed after %.3f s (%d blocks, %d bytes): %s",
                     peer, time.perf_counter() - t0, len(ticket["hashes"]), nbytes, e)
            pool.requeue_migrated(group)
            return
        if not getattr(ack, "ok", False) or ack.tokens is None:
            log.info("migration refused by %s: %s", peer, getattr(ack, "error", None))
            pool.requeue_migrated(group)
            return
        log.info("migration to %s: %d blocks, %d bytes, acked in %.6f s with %d tokens",
                 peer, len(ticket["hashes"]), nbytes, time.perf_counter() - t0, len(ack.tokens))
        pool.count("migrations")
        pool.count("blocks_shipped", len(ticket["hashes"]))
        pool.count("block_bytes_shipped", nbytes)
        pool.complete_migrated(group, ack.tokens)

    async def _report_load(self, job_id: str, cfg, batcher, scheduler_peer: str,
                           hints: "dict | None" = None) -> None:
        """Heartbeat the pool's admission headroom to the router: queue
        depth and free blocks ride the liveness signal its φ-accrual
        ejector reads, with the fleet cache's digest when it is on.
        Best-effort: a refused or lost heartbeat is logged and serving goes
        on. With migration on, each ack's ``migrate_*`` names the target
        the migration policy reads."""
        while True:
            await asyncio.sleep(cfg.load_report_s)
            if batcher is not None and hasattr(batcher, "load"):
                stats = batcher.load()
            else:
                # Window batching and independent decodes have no pool
                # headroom to report; the heartbeat still says "alive".
                stats = {"queue_depth": 0, "free_blocks": 0, "live_requests": 0,
                         "requests": getattr(batcher, "requests", 0), "rejections": 0}
            try:
                ack = await self.node.request(
                    scheduler_peer, PROTOCOL_SERVE,
                    ServeLoad(
                        job_id=job_id, serve_name=cfg.serve_name,
                        queue_depth=int(stats["queue_depth"]),
                        free_blocks=int(stats["free_blocks"]),
                        live_requests=int(stats["live_requests"]),
                        requests=int(stats["requests"]),
                        rejections=int(stats["rejections"]),
                        # None before a first swap, and with the fleet
                        # cache off or empty: left off the wire.
                        weight_round=stats.get("weight_round"),
                        weight_generation=stats.get("weight_generation"),
                        cache_digest=stats.get("cache_digest"),
                    ),
                    timeout=max(cfg.load_report_s, 2.0),
                )
                if hints is not None and getattr(ack, "migrate_peer", None):
                    hints["peer"] = ack.migrate_peer
                    hints["serve"] = ack.migrate_serve
            except (RequestError, asyncio.TimeoutError, OSError) as e:
                log.debug("serve load report for %s failed: %s", job_id, e)

    def _log_launches(self, job_id: str, counts0: dict, batcher) -> None:
        counts = {k: v - counts0[k] for k, v in _attention_counts().items()}
        counts["fallbacks"] = getattr(batcher, "fallbacks", 0)
        counts["requests"] = getattr(batcher, "requests", 0)
        log.info("job %s serve launches: %s", job_id, json.dumps(counts))
        pool = getattr(batcher, "pool", None)
        if pool is not None:
            cache = {k: getattr(pool, k) for k in (
                "prefill_chunks", "chunks", "preemptions", "hit_blocks", "miss_blocks",
                "cow_copies")}
            cache.update(cached_blocks=pool.cached_count(), shared_blocks=pool.shared_count(),
                         rejections=batcher.rejections)
            if pool.fleet_cache or pool.kv_migration:
                cache.update({k: pool.stats[k] for k in FLEET_STATS},
                             migrated_out=pool.migrated_out, requeued=pool.requeued)
            if pool.swap_log:
                cache.update(swaps_applied=pool.swaps_applied,
                             swaps_deferred=pool.swaps_deferred,
                             swaps_rolled_back=pool.swaps_rolled_back,
                             weight_round=pool.weight_round)
            log.info("job %s serve cache: %s", job_id, json.dumps(cache))
        if self.device.type == "cuda":
            log.info("job %s peak device memory: %.3f GiB", job_id,
                     torch.cuda.max_memory_allocated(self.device) / 2**30)


async def generate_remote(
    node: Node,
    serve_name: str,
    prompts: list,
    max_new_tokens: int = 64,
    *,
    temperature: "float | None" = None,
    top_k: "int | None" = None,
    seed: int = 0,
    timeout: float = 120.0,
) -> list:
    """Client side: discover a server of ``serve_name`` via the registry and
    RPC it. Returns one token-id list per prompt. Discovery polls briefly —
    a freshly dispatched serve job announces only once its model is loaded.
    A backpressure rejection (``ok=False``) is retried after the server's
    ``retry_after_ms`` hint until ``timeout`` is exhausted."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + min(timeout, 30.0)
    while True:
        providers = await node.find_providers(serve_key(serve_name))
        if providers:
            break
        if loop.time() >= deadline:
            raise RequestError(f"no provider serving {serve_name!r}")
        await asyncio.sleep(0.2)
    req = GenerateRequest(
        serve_name=serve_name,
        prompts=[list(map(int, p)) for p in prompts],
        max_new_tokens=max_new_tokens,
        temperature=temperature,
        top_k=top_k,
        seed=seed,
    )
    busy_deadline = loop.time() + timeout
    last: "Exception | None" = None
    while True:
        busy_hint = 0.0
        for peer in providers:
            try:
                resp = await node.request(peer, PROTOCOL_GENERATE, req, timeout=timeout)
            except RequestError as e:
                last = e
                continue
            if getattr(resp, "ok", True):
                return resp.tokens
            busy_hint = max(busy_hint, resp.retry_after_ms / 1e3)
        if busy_hint <= 0.0:
            raise RequestError(f"all providers of {serve_name!r} failed: {last}")
        if loop.time() + busy_hint >= busy_deadline:
            raise RequestError(
                f"{serve_name!r} is overloaded (retry-after exhausted the {timeout}s budget)"
            )
        await asyncio.sleep(busy_hint)
