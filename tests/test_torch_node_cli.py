"""Port parity: the node CLI's runners and serving over the network.

1. The four roles' runners (``cli._run_gateway``, ``_run_data``,
   ``_run_worker``, ``_run_scheduler``) in one event loop on the CPU run a
   2-round DiLoCo job of a tiny f32 Llama from configs built as the CLI
   builds them; the scheduler's runner returns the ``JobResult`` and the
   nodes stop in order when their ``stop`` events are set (the signal
   path's shutdown).
2. The port's ``ServingSupervisor`` auctions a port ``WorkerNode`` and puts
   it behind ``serve:<name>``; the greedy answers of ``generate_remote``
   equal the JAX package's ``DecodePool`` answers for the same flat
   SafeTensors weights at f32, token for token. The same through the
   scheduler runner's serve kind (bf16, seeded weights) against the port's
   in-process pool, and the supervisor redeploys after the job dies.
3. Wire interop: the JAX ``ServingSupervisor`` dispatches to a torch
   worker, and the JAX ``generate_remote`` gets the same tokens as (2).
4. The quickstart as OS processes (``chip_smoke.run_serve_node``, the
   smoke's ``serve_node`` phase on the CPU with ``worker run --device
   cpu``), held to the smoke's gates; a secured stream job as processes
   (``chip_smoke.run_secure_job``, the smoke's ``train_secure`` phase:
   mTLS, mux, ``executor.cmd``, a revoked worker); ``worker run`` without
   ``--device`` exits with the CUDA error; ``worker probe`` reports a
   running worker.
5. The infer executor's and the supervisor's unported options raise with
   their labels; backpressure becomes ``ok=False``; the window and
   independent-decode modes answer as the pool does.
6. The router: a mixed fleet (one JAX and one torch backend, prefix cache
   on) behind the JAX router and behind the port's answers as the JAX
   pool; a backend heartbeats ``ServeLoad``; the router's options build;
   ``chip_smoke.run_serve_router`` (the smoke's ``serve_router`` phase: two
   workers as processes, ``w1`` killed) on the CPU, held to its gates.
"""

from __future__ import annotations

import asyncio
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import chip_smoke
from _torch_parity import tiny_pair
from hypha_tpu.executor.pool import DecodePool as JPool
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.gateway import Gateway as JGateway
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.resources import Resources as JResources
from hypha_tpu.scheduler.serving import ServingSupervisor as JSupervisor
from hypha_tpu.worker import Arbiter as JArbiter
from hypha_tpu.worker import JobManager as JJobManager
from hypha_tpu.worker import LeaseManager as JLeaseManager
from hypha_tpu.worker import OfferConfig as JOfferConfig
from hypha_tpu.worker import StaticResourceManager as JStaticResources
from hypha_tpu.worker.infer_executor import InProcessInferExecutor as JInfer
from hypha_tpu.worker.infer_executor import generate_remote as j_generate_remote
from hypha_tpu_torch import cli
from hypha_tpu_torch import config as tcfg
from hypha_tpu_torch.executor.pool import DecodePool
from hypha_tpu_torch.gateway import Gateway
from hypha_tpu_torch.messages import (
    INFER_EXECUTOR_NAME, PROTOCOL_SERVE, Executor, GenerateRequest, InferExecutorConfig, JobSpec,
    ServeLoad, ServeLoadAck,
)
from hypha_tpu_torch.network import Node, TcpTransport
from hypha_tpu_torch.node_config import DataNodeConfig, GatewayConfig, SchedulerConfig, WorkerConfig
from hypha_tpu_torch.resources import Resources
from hypha_tpu_torch.scheduler.serving import ServingSupervisor
from hypha_tpu_torch.worker.arbiter import OfferConfig
from hypha_tpu_torch.worker.infer_executor import (
    InProcessInferExecutor, generate_remote, load_model,
)
from hypha_tpu_torch.worker.runtime import WorkerNode

LISTEN = ["127.0.0.1:0"]
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1, 8], [9] * 13, [(i * 7 + 3) % 50 + 1 for i in range(21)]]
N_NEW = [12, 16, 10, 14]
# The executor's pool for a tiny Llama (max_seq_len 128): slots = max_batch,
# max_len min(128, 1024), decode chunk 8, blocks of 8 (64 derived), prefill
# chunk 32, the ragged path.
POOL = dict(slots=4, max_len=128, steps_per_call=8, block_size=8, ragged=True)
SERVE = dict(max_batch=4, max_new_tokens=32, pool_block_size=8, pool_ragged=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _conf(cls, **over):
    return tcfg.builder(cls).with_overrides(over).build().validate().value


@pytest.fixture
def root():
    # A unix socket path must stay under 108 bytes: a short work root.
    path = Path(tempfile.mkdtemp(prefix="nc"))
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A flat f32 SafeTensors file of a tiny Llama (seeded noise on every
    parameter), its f32 serving spec, and the JAX pool's greedy answers."""
    _, variables, _ = tiny_pair("llama", seed=11)
    path = tmp_path_factory.mktemp("w") / "tiny.safetensors"
    save_file(flatten_tree(variables), str(path))
    spec = {"family": "llama", "preset": "tiny", "config": {"dtype": "float32"},
            "weights": str(path), "serve_dtype": "float32"}
    jm, params = JInfer._load_model(None, dict(spec))
    pool = JPool(jm, params, **POOL)
    try:
        futs = [pool.submit([p], n) for p, n in zip(PROMPTS, N_NEW)]
        want = [f.result(timeout=300) for f in futs]
    finally:
        pool.close()
    return spec, want


async def _client(boot: list):
    node = Node(TcpTransport(), peer_id="client", bootstrap=boot)
    await node.start(LISTEN)
    await node.wait_for_bootstrap()
    return node


async def _ask(client, name, remote=generate_remote):
    return list(await asyncio.gather(*(
        remote(client, name, [p], n, timeout=120) for p, n in zip(PROMPTS, N_NEW))))


def test_runners_run_a_tiny_llama_diloco_job(tmp_path, root):
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        ids = ((rng.integers(0, 256, (8, 1)) + np.arange(16)) % 256).astype(np.int32)
        save_file({"input_ids": ids}, str(data / f"slice_{i:04d}.safetensors"))
    gw = f"127.0.0.1:{_free_port()}"
    ports = {"w0": _free_port(), "psw": _free_port()}
    net = {"network.gateways": [gw]}
    confs = {
        "gateway": _conf(GatewayConfig, **{"network.listen": [gw]}),
        "data": _conf(DataNodeConfig, datasets={"counting": str(data)}, **net),
        "w0": _conf(WorkerConfig, name="w0", work_root=str(root / "w0"),
                    **{"resources.gpu": 1, "resources.cpu": 8, "resources.memory": 1000,
                       "offer.strategy": "whole", "network.listen": [f"127.0.0.1:{ports['w0']}"]},
                    **net),
        "psw": _conf(WorkerConfig, name="psw", work_root=str(root / "ps"),
                     **{"resources.cpu": 2, "resources.memory": 200,
                        "network.listen": [f"127.0.0.1:{ports['psw']}"]}, **net),
        "scheduler": _conf(SchedulerConfig, **net, **{
            "job.model_family": "llama", "job.model_preset": "tiny",
            "job.model_type": "causal-lm", "job.model_config": {"dtype": "float32"},
            "job.dataset": "counting", "job.update_rounds": 2,
            "job.avg_samples_between_updates": 8, "job.max_batch_size": 2,
            "job.num_workers": 1, "job.worker_gpu": 0.5, "job.inner_lr": 3e-3,
            "job.worker_memory": 10, "job.ps_memory": 10}),
    }
    from hypha_tpu_torch.health import probe

    async def main():
        stops = {k: asyncio.Event() for k in ("gateway", "data", "w0", "psw")}
        tasks = {"gateway": asyncio.create_task(cli._run_gateway(confs["gateway"],
                                                                 stop=stops["gateway"]))}
        client = None
        try:
            await asyncio.sleep(0.2)
            tasks["data"] = asyncio.create_task(cli._run_data(confs["data"], stop=stops["data"]))
            for w in ("w0", "psw"):
                tasks[w] = asyncio.create_task(
                    cli._run_worker(confs[w], device="cpu", stop=stops[w]))
            client = await _client([gw])
            for w, port in ports.items():  # each worker healthy before the auction
                for _ in range(300):
                    try:
                        if await probe(client, f"127.0.0.1:{port}", timeout=2):
                            break
                    except Exception:
                        pass
                    await asyncio.sleep(0.1)
            result = await asyncio.wait_for(cli._run_scheduler(confs["scheduler"]), 240)
        finally:
            if client is not None:
                await client.stop()
            for name in ("psw", "w0", "data", "gateway"):
                if name in tasks:
                    stops[name].set()
                    await asyncio.wait_for(tasks[name], 30)
        return result

    result = asyncio.run(main())
    assert result.rounds == 2
    losses = [m["loss"] for _peer, _round, m in result.metrics if "loss" in m]
    assert losses and all(np.isfinite(losses))
    assert not [p for p in root.rglob("*") if p.is_file()]


def test_scheduler_runner_stopped_mid_job_is_adopted_on_restart(tmp_path, root, monkeypatch):
    """``_run_scheduler`` of an elastic, checkpointed job with scheduler
    recovery, stopped by its ``stop`` event mid-job (as a killed process)
    and started again with the same config: the new scheduler finds the
    journal and adopts the live torch worker and the server, nothing is
    auctioned or dispatched again, and the job completes."""
    import dataclasses
    import logging

    from hypha_tpu_torch.ft.durable import RoundJournal
    from hypha_tpu_torch.health import probe
    from hypha_tpu_torch.node_config import JobSection
    from hypha_tpu_torch.scheduler.task import Task

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        ids = ((rng.integers(0, 256, (8, 1)) + np.arange(16)) % 256).astype(np.int32)
        save_file({"input_ids": ids}, str(data / f"slice_{i:04d}.safetensors"))
    gw = f"127.0.0.1:{_free_port()}"
    ports = {"w0": _free_port(), "psw": _free_port()}
    net = {"network.gateways": [gw]}
    ckpt = tmp_path / "ckpt"
    confs = {
        "gateway": _conf(GatewayConfig, **{"network.listen": [gw]}),
        "data": _conf(DataNodeConfig, datasets={"counting": str(data)}, **net),
        "w0": _conf(WorkerConfig, name="w0", work_root=str(root / "w0"),
                    **{"resources.gpu": 1, "resources.cpu": 8, "resources.memory": 1000,
                       "offer.strategy": "whole", "network.listen": [f"127.0.0.1:{ports['w0']}"]},
                    **net),
        "psw": _conf(WorkerConfig, name="psw", work_root=str(root / "ps"),
                     **{"resources.cpu": 2, "resources.memory": 200,
                        "network.listen": [f"127.0.0.1:{ports['psw']}"]}, **net),
        "scheduler": _conf(SchedulerConfig, **net, **{
            "job.model_family": "llama", "job.model_preset": "tiny",
            "job.model_type": "causal-lm", "job.model_config": {"dtype": "float32"},
            "job.dataset": "counting", "job.update_rounds": 4,
            "job.avg_samples_between_updates": 4, "job.max_batch_size": 2,
            "job.num_workers": 1, "job.worker_gpu": 0.5, "job.inner_lr": 3e-3,
            "job.worker_memory": 10, "job.ps_memory": 10, "job.quorum_fraction": 0.5,
            "job.checkpoint_dir": str(ckpt)}),
    }
    # The TOML schema has no key for it (nor has the reference's): the job
    # the config builds turns recovery on.
    to_job = JobSection.to_job
    monkeypatch.setattr(JobSection, "to_job", lambda self: dataclasses.replace(
        to_job(self), scheduler_recovery=True))
    dispatched: list = []
    dispatch = Task.dispatch.__func__

    async def counted(cls, node, router, spec, workers):
        dispatched.append(spec.job_id)
        return await dispatch(cls, node, router, spec, workers)

    monkeypatch.setattr(Task, "dispatch", classmethod(counted))
    lines: list = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    logger = logging.getLogger("hypha.torch.scheduler.orchestrator")
    logger.addHandler(handler)
    journal = ckpt / "scheduler" / "sched-journal.cbor"

    async def main():
        stops = {k: asyncio.Event() for k in ("gateway", "data", "w0", "psw", "scheduler")}
        tasks = {"gateway": asyncio.create_task(cli._run_gateway(confs["gateway"],
                                                                 stop=stops["gateway"]))}
        client = None
        try:
            await asyncio.sleep(0.2)
            tasks["data"] = asyncio.create_task(cli._run_data(confs["data"], stop=stops["data"]))
            for w in ("w0", "psw"):
                tasks[w] = asyncio.create_task(
                    cli._run_worker(confs[w], device="cpu", stop=stops[w]))
            client = await _client([gw])
            for w, port in ports.items():
                for _ in range(300):
                    try:
                        if await probe(client, f"127.0.0.1:{port}", timeout=2):
                            break
                    except Exception:
                        pass
                    await asyncio.sleep(0.1)
            first = asyncio.create_task(cli._run_scheduler(confs["scheduler"],
                                                           stop=stops["scheduler"]))
            for _ in range(1200):  # stop once round 1 is journaled
                if journal.exists() and any(r.get("t") == "round" and r["round"] >= 1
                                            for r in RoundJournal.read_all(journal)):
                    break
                await asyncio.sleep(0.05)
            stops["scheduler"].set()
            stopped = await asyncio.wait_for(first, 30)
            before = len(dispatched)
            await asyncio.sleep(1.0)  # the gateway drops the dead node's registrations
            result = await asyncio.wait_for(cli._run_scheduler(confs["scheduler"]), 240)
            return stopped, before, result
        finally:
            if client is not None:
                await client.stop()
            for name in ("psw", "w0", "data", "gateway"):
                if name in tasks:
                    stops[name].set()
                    await asyncio.wait_for(tasks[name], 30)

    try:
        stopped, before, result = asyncio.run(main())
    finally:
        logger.removeHandler(handler)
    assert stopped is None and before == 2 and len(dispatched) == before
    assert result.rounds == 4 and result.attempt == 0
    assert any("scheduler recovery: adopted 2/2 executions" in line for line in lines), lines
    assert not journal.exists()
    assert not [p for p in root.rglob("*") if p.is_file()]


def test_serving_supervisor_answers_equal_the_jax_pool(weights, root):
    spec, want = weights

    async def main():
        gw = Gateway(TcpTransport(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        worker = WorkerNode(TcpTransport(), resources=Resources(gpu=1, cpu=8, memory=1000),
                            device="cpu", peer_id="w0", offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root)
        sched = Node(TcpTransport(), peer_id="sched", bootstrap=boot)
        started = []
        try:
            for part in (worker, sched):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            sup = ServingSupervisor(sched, spec, "tiny", **SERVE)
            runner = asyncio.create_task(sup.run())
            client = await _client(boot)
            try:
                got = await _ask(client, "tiny")
                again = await _ask(client, "tiny")
                (job_id,) = worker.job_manager._active
                # The job dies on the worker: the supervisor re-auctions and
                # serves again from a new job.
                await worker.job_manager.cancel_job(job_id)
                for _ in range(600):
                    if sup.redeployments and worker.job_manager._active.keys() - {job_id}:
                        break
                    await asyncio.sleep(0.05)
                after = await _ask(client, "tiny")
            finally:
                await client.stop()
                await sup.stop()
                await asyncio.wait_for(runner, 30)
            return got, again, after, sup.redeployments, len(worker.job_manager)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    got, again, after, redeployments, live = asyncio.run(main())
    assert got == want
    assert again == want and after == want
    assert redeployments == 1 and live == 0


def test_jax_supervisor_dispatches_to_a_torch_worker(weights, root):
    spec, want = weights

    async def main():
        gw = JGateway(JTcp(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        worker = WorkerNode(TcpTransport(), resources=Resources(gpu=1, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root)
        sched = JNode(JTcp(), peer_id="sched", bootstrap=boot)
        client = JNode(JTcp(), peer_id="client", bootstrap=boot)
        started = []
        try:
            for part in (worker, sched, client):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            await client.wait_for_bootstrap()
            sup = JSupervisor(sched, spec, "tiny", resources=JResources(gpu=1.0, memory=100.0),
                              **SERVE)
            runner = asyncio.create_task(sup.run())
            try:
                got = await _ask(client, "tiny", remote=j_generate_remote)
                served = [b.pool.requests for b in
                          worker.job_manager.executors[("infer", INFER_EXECUTOR_NAME)]
                          .batchers.values()]
            finally:
                await sup.stop()
                await asyncio.wait_for(runner, 30)
            return got, served
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    got, served = asyncio.run(main())
    assert got == want
    assert served == [len(PROMPTS)]


def _pool_answers(spec: dict, prompts, n_new, pool: dict) -> list:
    model = load_model(spec, device="cpu")
    p = DecodePool(model, **pool)
    try:
        futs = [p.submit([q], n) for q, n in zip(prompts, n_new)]
        return [f.result(timeout=300) for f in futs]
    finally:
        p.close()


def test_scheduler_runner_serves_until_stopped(root):
    """The serve kind through the runners, bf16 and seeded as the CLI
    builds it, against the port's in-process pool on the same spec."""
    gw = f"127.0.0.1:{_free_port()}"
    net = {"network.gateways": [gw]}
    job = {"job.kind": "serve", "job.serve_name": "tiny", "job.model_family": "llama",
           "job.model_preset": "tiny", "job.model_type": "causal-lm", "job.model_seed": 5,
           "job.serve_max_batch": 4, "job.serve_block_size": 8, "job.serve_ragged": True,
           "job.serve_max_new_tokens": 32}
    confs = (_conf(GatewayConfig, **{"network.listen": [gw]}),
             _conf(WorkerConfig, name="w0", work_root=str(root),
                   **{"resources.gpu": 1, "offer.strategy": "whole"}, **net),
             _conf(SchedulerConfig, **job, **net))
    want = _pool_answers({"family": "llama", "preset": "tiny", "seed": 5}, PROMPTS, N_NEW, POOL)

    async def main():
        stops = [asyncio.Event() for _ in confs]
        tasks = [asyncio.create_task(cli._run_gateway(confs[0], stop=stops[0]))]
        await asyncio.sleep(0.2)
        tasks.append(asyncio.create_task(cli._run_worker(confs[1], device="cpu", stop=stops[1])))
        tasks.append(asyncio.create_task(cli._run_scheduler(confs[2], stop=stops[2])))
        client = await _client([gw])
        try:
            return await asyncio.wait_for(_ask(client, "tiny"), 120)
        finally:
            await client.stop()
            for stop, task in zip(reversed(stops), reversed(tasks)):
                stop.set()
                await asyncio.wait_for(task, 30)

    assert asyncio.run(main()) == want
    assert not list(root.iterdir())


def test_quickstart_as_processes(tmp_path, root):
    """``chip_smoke.run_serve_node`` on the CPU: gateway, worker (``--device
    cpu``) and scheduler as processes from ``init``'s TOMLs."""
    env_py = [sys.executable, "-m", "hypha_tpu_torch"]
    repo = str(Path(chip_smoke.__file__).resolve().parent)
    subprocess.run([*env_py, "worker", "init", "-o", str(tmp_path / "w.toml")], check=True,
                   cwd=repo, timeout=60)
    if not torch.cuda.is_available():
        bad = subprocess.run([*env_py, "worker", "run", "-c", str(tmp_path / "w.toml")],
                             cwd=repo, capture_output=True, text=True, timeout=60)
        assert bad.returncode == 1 and "device='cpu'" in bad.stderr
    job = {"job.kind": "serve", "job.serve_name": "tiny", "job.model_family": "llama",
           "job.model_preset": "tiny", "job.model_type": "causal-lm", "job.model_seed": 2,
           "job.serve_max_batch": 4, "job.serve_block_size": 8, "job.serve_ragged": True,
           "job.serve_max_new_tokens": 32}
    want = _pool_answers({"family": "llama", "preset": "tiny", "seed": 2}, PROMPTS, N_NEW, POOL)
    run = asyncio.run(chip_smoke.run_serve_node(root, job, PROMPTS, N_NEW, device="cpu"))
    problems = chip_smoke.serve_node_problems(run, want=want, n_new=N_NEW, layers=2,
                                              device="cpu")
    assert not problems, (problems, {r: Path(p).read_text()[-3000:]
                                     for r, p in run["logs"].items()})
    assert run["launches"]["requests"] == len(PROMPTS) + 2
    assert run["bring_up_s"] > 0 and run["dispatch_to_first_answer_s"] > 0
    assert run["load_s"] > 0 and run["load_peak_mem_gib"] is None  # no device peak on the CPU


def test_secured_stream_job_as_processes(root, monkeypatch):
    """``chip_smoke.run_secure_job`` on the CPU (the smoke's ``train_secure``
    phase): gateway, data node, ``psw``, ``w0`` and the scheduler as
    processes under mTLS with the port's certutil PKI, mux on, ``w0``'s
    trainer spawned through ``executor.cmd`` / ``executor.args``, and a
    worker ``wx`` whose certificate the CRL revokes; a tiny Llama's int8
    stream job over 2 rounds, held to ``secure_problems``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # six processes on a few cores
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"dtype": "float32"}, "seed": 0}
    options = {**chip_smoke.STREAM_OPTIONS, "num_fragments": 2}
    run = asyncio.run(asyncio.wait_for(chip_smoke.run_secure_job(
        root, model, device="cpu", rounds=2, steps=3, batch=2, seq=64, period=64, lr=3e-3,
        options=options), 400))
    rep = chip_smoke.secure_report(run)
    problems = chip_smoke.secure_problems(run, rep, rounds=2, fragments=2)
    assert not problems, (problems, {n: log[-2500:] for n, log in run["logs"].items()})
    trainer = rep["trainer"]
    assert "attention path: plain (host)" in run["logs"]["w0"]
    assert trainer["launches"] == {"fwd": 0, "dq": 0, "dkv": 0, "flash_plain": 0,
                                   "dense": 2 * trainer["batches"]}
    assert sorted(trainer["flights"]) == [0, 1]
    assert len(rep["pushes"]) == len(rep["broadcasts"]) == 2
    assert all(p["bytes"] > 0 and p["s"] > 0 for p in rep["pushes"] + rep["broadcasts"])
    assert rep["auction_to_dispatch_s"] > 0
    assert 0 < rep["progress_gap_max_s"] < rep["watchdog_min_s"]
    # One muxed connection a peer: many more logical streams than handshakes.
    w0 = rep["fabric"]["w0"]
    assert w0["streams_dialed"] > w0["dialed"] >= 1
    assert rep["fabric"]["gateway"]["refused"] >= 2  # wx (revoked) and the plain dial
    assert run["plain_error"]


def test_worker_probe_reports_a_running_worker(tmp_path):
    repo = str(Path(chip_smoke.__file__).resolve().parent)
    port = _free_port()
    worker = subprocess.Popen(
        [sys.executable, "-m", "hypha_tpu_torch", "worker", "run", "--device", "cpu",
         "--set", f'network.listen=["127.0.0.1:{port}"]', "--set", f'work_root="{tmp_path}"'],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        for _ in range(120):
            out = subprocess.run(
                [sys.executable, "-m", "hypha_tpu_torch", "worker", "probe",
                 f"127.0.0.1:{port}", "--timeout", "2"],
                cwd=repo, capture_output=True, text=True, timeout=60)
            if out.returncode == 0:
                break
            assert worker.poll() is None
        assert out.stdout.strip() == "healthy"
    finally:
        worker.terminate()
        assert worker.wait(timeout=30) == 0


def _infer_spec(**cfg) -> JobSpec:
    base = dict(model={"family": "llama", "preset": "tiny", "seed": 1,
                       "serve_dtype": "float32"},
                serve_name="t", max_batch=4, max_new_tokens=16, pool_block_size=8,
                pool_ragged=True, load_report_s=0.0)
    return JobSpec(job_id="j", executor=Executor(
        kind="infer", name=INFER_EXECUTOR_NAME, infer=InferExecutorConfig(**{**base, **cfg})))


@pytest.mark.parametrize("option,label", [
    (dict(report_metrics_s=1.0), "telemetry"),
])
def test_infer_executor_refuses_unported_options(option, label):
    """``report_metrics_s`` (refused under ``label`` until the metrics plane
    was ported; the label is retired): the job is taken and serves, and a
    cancel ends it."""
    async def main():
        node = Node(TcpTransport(), peer_id="w")
        ex = InProcessInferExecutor(node, torch.device("cpu"))
        execution = await ex.execute("j", _infer_spec(**option), "sched")
        deadline = asyncio.get_running_loop().time() + 60
        while "j" not in ex.batchers and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.05)
        assert "j" in ex.batchers  # the model loaded and the backend serves
        await execution.cancel()
        assert (await execution.wait()).state == "cancelled"

    asyncio.run(main())


@pytest.mark.parametrize("scheduling", ["continuous", "window"])
def test_infer_executor_follows_in_continuous_mode(tmp_path, scheduling):
    """``serve_follow_rounds`` (refused until live weight swap was ported)
    starts a weight subscriber on the continuous pool, its work dir under
    the job's and removed with it; any other mode fails the job with the
    reference's ``ValueError``."""
    from hypha_tpu_torch.serving import follow_for

    async def main():
        node = Node(TcpTransport(), peer_id="w")
        ex = InProcessInferExecutor(node, torch.device("cpu"), tmp_path)
        follow = follow_for("results:job", ["ps"], start_round=2)
        execution = await ex.execute("j", _infer_spec(serve_follow_rounds=follow,
                                                      scheduling=scheduling), "sched")
        if scheduling == "window":
            status = await asyncio.wait_for(execution.wait(), 60)
            return status, None, None
        for _ in range(600):
            if "j" in ex.batchers:
                break
            await asyncio.sleep(0.1)
        await asyncio.sleep(0.2)
        subscribed = (tmp_path / "j" / "weight-stream").is_dir()
        state = ex.batchers["j"].weight_state()
        await execution.cancel()
        return (await execution.wait()), subscribed, state

    status, subscribed, state = asyncio.run(main())
    if scheduling == "window":
        assert status.state == "failed" and "requires continuous scheduling" in status.message
    else:
        assert status.state == "cancelled" and subscribed and state == (None, None)
        assert not (tmp_path / "j").exists()


def test_serving_supervisor_dispatches_the_follow():
    """A supervisor given ``serve_follow_rounds`` (refused until live weight
    swap was ported) ships it in its deployments' config."""
    from hypha_tpu_torch.serving import follow_for

    follow = follow_for("results:job", ["ps"], groups=[["w0", "w1"]])

    async def main():
        return ServingSupervisor(Node(TcpTransport(), peer_id="s"), {}, "t",
                                 serve_follow_rounds=follow)

    sup = asyncio.run(main())
    assert sup._config.serve_follow_rounds is follow
    assert sorted(follow.results.ref.peers) == ["ps", "w0"]


def test_infer_executor_heartbeats_serve_load():
    """``load_report_s > 0`` (refused until the router was ported): once its
    handler is registered, the backend heartbeats ``ServeLoad`` under its
    backend name to the peer that dispatched it; cancelling stops them."""
    beats = []

    async def main():
        gw = Gateway(TcpTransport(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        sched = Node(TcpTransport(), peer_id="sched", bootstrap=boot)
        await sched.start(LISTEN)
        node = Node(TcpTransport(), peer_id="w", bootstrap=boot)
        await node.start(LISTEN)
        await sched.wait_for_bootstrap()
        await node.wait_for_bootstrap()

        async def on_load(peer, load):
            beats.append((peer, load, time.monotonic()))
            return ServeLoadAck(ok=True)

        sched.on(PROTOCOL_SERVE, ServeLoad).respond_with(on_load)
        ex = InProcessInferExecutor(node, torch.device("cpu"))
        try:
            execution = await ex.execute(
                "j", _infer_spec(serve_name="t@1", load_report_s=0.2, pool_prefix_cache=True),
                "sched")
            for _ in range(600):
                if len(beats) >= 3:
                    break
                await asyncio.sleep(0.05)
            batcher = ex.batchers["j"]
            await execution.cancel()
            n = len(beats)
            await asyncio.sleep(0.5)
            return batcher, n
        finally:
            await node.stop()
            await sched.stop()
            await gw.stop()

    batcher, n = asyncio.run(main())
    assert n >= 3 and len(beats) == n  # no heartbeat after the cancel
    peer, load, _ = beats[0]
    assert peer == "w" and load.job_id == "j" and load.serve_name == "t@1"
    assert load.free_blocks == batcher.pool.num_blocks and load.queue_depth == 0
    assert load.weight_round is None and load.cache_digest is None
    assert batcher.pool.prefix_cache


@pytest.mark.parametrize("option", [dict(num_workers=2), dict(route=True), dict(queue_limit=4),
                                    dict(prefix_affinity=True)])
def test_serving_supervisor_takes_the_router_options(option):
    """The router's options (refused until it was ported) build a router:
    backend names ``<name>@<slot>`` and heartbeats once routing is on."""
    async def main():
        return ServingSupervisor(Node(TcpTransport(), peer_id="s"), {}, "t", **option)

    sup = asyncio.run(main())
    routed = "num_workers" in option or "route" in option
    assert sup.route is routed
    assert sup._backend_name(1) == ("t@1" if routed else "t")
    assert sup._config.load_report_s == (1.0 if routed else 0.0)
    assert sup.queue_limit == option.get("queue_limit", 0)
    assert sup._config.queue_limit == option.get("queue_limit", 0)
    assert sup.prefix_affinity is option.get("prefix_affinity", False)


@pytest.mark.parametrize("option,label", [
    (dict(report_metrics_s=1.0), "telemetry"), (dict(metrics=object()), "telemetry"),
])
def test_serving_supervisor_refuses_unported_options(option, label):
    """The metrics plane's supervisor options (refused under ``label``
    until the plane was ported; the label is retired) build the reference
    supervisor's config bytes."""
    async def main():
        tsup = ServingSupervisor(Node(TcpTransport(), peer_id="s"), {}, "t", **option)
        jsup = JSupervisor(JNode(JTcp(), peer_id="s"), {}, "t", **option)
        from hypha_tpu import messages as jm
        from hypha_tpu_torch import messages as tm

        assert tsup.metrics is option.get("metrics")
        assert tm.encode(tsup._config) == jm.encode(jsup._config)

    asyncio.run(main())


async def _jax_infer_worker(boot: list, name: str):
    """A JAX serving worker assembled as the JAX package's router tests do
    (its ``WorkerNode`` has no infer executor), selling gpu."""
    node = JNode(JTcp(), peer_id=name, bootstrap=boot)
    await node.start(LISTEN)
    await node.wait_for_bootstrap()
    lm = JLeaseManager(JStaticResources(JResources(gpu=2, cpu=8, memory=1000)))
    ex = JInfer(node)
    jm = JJobManager(node, {("infer", INFER_EXECUTOR_NAME): ex})
    arb = JArbiter(node, lm, jm, offer=JOfferConfig(price=1.0, floor=0.0))
    await arb.start()
    return node, arb, ex


FLEET_PROMPTS = [p + t for p in ([5, 9, 2, 7] * 5, [8, 1, 3] * 6) for t in ([4], [6, 2, 2], [7] * 9)]
FLEET_NEW = [8, 12, 6, 10, 9, 7]


def test_mixed_fleet_behind_either_router(weights, root):
    """One JAX and one torch backend (prefix cache on, f32 weights from one
    flat SafeTensors file) behind the JAX router with ``num_workers=2``,
    and behind the port's router at the same time: each router places one
    backend on each worker, both backends serve, and every answer equals
    the JAX pool's."""
    spec, _ = weights
    jm, params = JInfer._load_model(None, dict(spec))
    pool = JPool(jm, params, **POOL)
    try:
        want = [pool.submit([p], n).result(timeout=300)
                for p, n in zip(FLEET_PROMPTS * 2, FLEET_NEW * 2)]
    finally:
        pool.close()
    serve = dict(SERVE, num_workers=2, pool_prefix_cache=True, queue_limit=3,
                 prefix_affinity=True)

    async def main():
        gw = Gateway(TcpTransport(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        jnode, jarb, jex = await _jax_infer_worker(boot, "wjax")
        worker = WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", bootstrap=boot, work_root=root)
        jsched = JNode(JTcp(), peer_id="jsched", bootstrap=boot)
        tsched = Node(TcpTransport(), peer_id="tsched", bootstrap=boot)
        started, runners, sups = [], [], []
        try:
            for part in (worker, jsched, tsched):
                await part.start(LISTEN)
                started.append(part)
            await jsched.wait_for_bootstrap()
            await tsched.wait_for_bootstrap()
            sups = [JSupervisor(jsched, spec, "jmix", resources=JResources(gpu=1.0, memory=100.0),
                                **serve),
                    ServingSupervisor(tsched, spec, "tmix", **serve)]
            runners = [asyncio.create_task(sup.run()) for sup in sups]
            client = await _client(boot)
            got = {}
            try:
                for sup, name in zip(sups, ("jmix", "tmix")):
                    for _ in range(1200):  # both backends of this router heartbeated
                        deps = [d for d in sup._deployments if d is not None]
                        if len(deps) == 2 and all(d.load is not None for d in deps):
                            break
                        await asyncio.sleep(0.05)
                    got[name] = list(await asyncio.gather(*(
                        generate_remote(client, name, [p], n, timeout=120)
                        for p, n in zip(FLEET_PROMPTS * 2, FLEET_NEW * 2))))
                placed = {name: sorted(d.handle.peer_id for d in sup._deployments)
                          for sup, name in zip(sups, ("jmix", "tmix"))}
                served = {"wjax": sorted(b.pool.requests for b in jex.batchers.values()),
                          "wtorch": sorted(
                              b.pool.requests for b in worker.job_manager.executors[
                                  ("infer", INFER_EXECUTOR_NAME)].batchers.values())}
                counters = sups[1].counters()
            finally:
                await client.stop()
                for sup in sups:
                    await sup.stop()
                for r in runners:
                    await asyncio.wait_for(r, 30)
            return got, placed, served, counters
        finally:
            for part in reversed(started):
                await part.stop()
            await jarb.stop()
            await jnode.stop()
            await gw.stop()

    got, placed, served, counters = asyncio.run(main())
    assert got["jmix"] == want and got["tmix"] == want
    assert placed == {"jmix": ["wjax", "wtorch"], "tmix": ["wjax", "wtorch"]}
    assert all(len(v) == 2 and min(v) > 0 for v in served.values()), served
    assert counters["routed"] == len(want) and counters["affinity_routed"] > 0


FAMILIES = {"a": [(i * 5 + 2) % 50 + 1 for i in range(24)],
            "b": [(i * 3 + 7) % 50 + 1 for i in range(24)]}


@pytest.mark.parametrize("router", ["jax", "port"])
def test_mixed_fleet_pulls_across_packages(weights, root, router):
    """One JAX and one torch backend with the fleet cache and migration on,
    behind the JAX router or the port's: a family's first prompt warms its
    chain on one backend (the other held busy in the router's books), the
    heartbeats put it in the router's directory, and with the holder held
    busy the family's next prompt goes to the other backend stamped with
    the holder as ``pull_peer``; it pulls the chain across the packages
    and admits it as a prefix hit. Family ``a`` pulls one way, ``b`` the
    other; every answer equals the JAX pool's."""
    from hypha_tpu.executor.block_cache import chain_hashes as j_chain_hashes
    from hypha_tpu.telemetry import SERVE_METRICS

    spec, _ = weights
    prompts = {f: [fam + [9, 4], fam + [6, 6, 1]] for f, fam in FAMILIES.items()}
    jm, params = JInfer._load_model(None, dict(spec))
    pool = JPool(jm, params, **POOL)
    try:
        want = {f: [pool.submit([p], 10).result(timeout=300) for p in ps]
                for f, ps in prompts.items()}
    finally:
        pool.close()
    serve = dict(SERVE, num_workers=2, pool_prefix_cache=True, fleet_cache=True,
                 kv_migration=True)

    async def main():
        SERVE_METRICS.reset()
        gw = Gateway(TcpTransport(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        jnode, jarb, jex = await _jax_infer_worker(boot, "wjax")
        worker = WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", bootstrap=boot, work_root=root)
        sched = (JNode(JTcp(), peer_id="sched", bootstrap=boot) if router == "jax"
                 else Node(TcpTransport(), peer_id="sched", bootstrap=boot))
        started, runner = [], None
        try:
            for part in (worker, sched):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            sup = (JSupervisor(sched, spec, "fleet", resources=JResources(gpu=1.0, memory=100.0),
                               **serve) if router == "jax"
                   else ServingSupervisor(sched, spec, "fleet", **serve))
            runner = asyncio.create_task(sup.run())
            client = await _client(boot)
            got, pulled_by = {}, {}
            try:
                for _ in range(1200):
                    deps = [d for d in sup._deployments if d is not None]
                    if len(deps) == 2 and all(d.load is not None for d in deps):
                        break
                    await asyncio.sleep(0.05)
                by_peer = {d.handle.peer_id: d for d in sup._deployments}
                holder = {"a": by_peer["wjax"], "b": by_peer["wtorch"]}
                for fam, ps in prompts.items():
                    other = next(d for d in by_peer.values() if d is not holder[fam])
                    other.inflight += 10  # the warm-up goes to the holder
                    first = await generate_remote(client, "fleet", [ps[0]], 10, timeout=120)
                    other.inflight -= 10
                    hashes = j_chain_hashes(ps[1], 8)
                    for _ in range(600):  # the holder's digest reached the router
                        if hashes[-1] in sup._digests.get(holder[fam].backend_name, {}):
                            break
                        await asyncio.sleep(0.05)
                    holder[fam].inflight += 10  # the next one lands on the other
                    second = await generate_remote(client, "fleet", [ps[1]], 10, timeout=120)
                    holder[fam].inflight -= 10
                    got[fam] = [first, second]
                    pulled_by[fam] = other.handle.peer_id
                tex = worker.job_manager.executors[("infer", INFER_EXECUTOR_NAME)]
                tstats = [b.pool.stats for b in tex.batchers.values()]
                jstats = SERVE_METRICS.snapshot()
            finally:
                await client.stop()
                await sup.stop()
                await asyncio.wait_for(runner, 30)
            return got, pulled_by, tstats, jstats
        finally:
            for part in reversed(started):
                await part.stop()
            await jarb.stop()
            await jnode.stop()
            await gw.stop()

    got, pulled_by, tstats, jstats = asyncio.run(main())
    assert got == want
    assert pulled_by == {"a": "wtorch", "b": "wjax"}
    # The torch backend pulled a's 3 blocks from the JAX one, the JAX
    # backend b's 3 blocks from the torch one.
    assert len(tstats) == 1 and tstats[0]["remote_prefix_hits"] == 3
    assert tstats[0]["blocks_shipped"] == 3 and tstats[0]["remote_prefix_misses"] == 0
    assert jstats["remote_prefix_hits"] == 3 and jstats["blocks_shipped"] == 3


ROUTER_PROMPTS = [fam + tail for fam in ([(i * 7 + 3) % 200 + 1 for i in range(32)],
                                         [(i * 5 + 11) % 200 + 1 for i in range(32)])
                  for tail in ([4, 4], [9] * 16, [3, 1, 4, 1, 5], [8] * 11)]
ROUTER_NEW = [12, 10, 8, 14, 9, 12, 10, 8]


def test_serve_router_as_processes(tmp_path, root):
    """``chip_smoke.run_serve_router`` on the CPU: a gateway, two workers
    (``--device cpu``) and a scheduler whose serve job routes (two workers,
    prefix cache and affinity, queue limit 4), held to the smoke's gates;
    ``w1`` is killed and its slot fails."""
    job = {"job.kind": "serve", "job.serve_name": "tiny", "job.model_family": "llama",
           "job.model_preset": "tiny", "job.model_type": "causal-lm", "job.model_seed": 2,
           "job.model_config": {"max_seq_len": 512}, "job.serve_max_batch": 4,
           "job.serve_block_size": 16, "job.serve_ragged": True,
           "job.serve_max_new_tokens": 32, "job.serve_workers": 2,
           "job.serve_prefix_cache": True, "job.serve_prefix_affinity": True,
           "job.serve_queue_limit": 4}
    model = {"family": "llama", "preset": "tiny", "seed": 2, "config": {"max_seq_len": 512}}
    want = [a[0] for a in _pool_answers(model, ROUTER_PROMPTS, ROUTER_NEW,
                                        dict(slots=4, max_len=512, block_size=16, ragged=True,
                                             prefix_cache=True))]
    run = asyncio.run(chip_smoke.run_serve_router(root, job, ROUTER_PROMPTS, ROUTER_NEW,
                                                  device="cpu"))
    problems = chip_smoke.serve_router_problems(run, want=want, n_new=ROUTER_NEW, layers=2,
                                                device="cpu")
    assert not problems, (problems, {r: Path(p).read_text()[-3000:]
                                     for r, p in run["logs"].items()})
    assert run["slot_failed_by"] in ("lease", "phi-accrual ejection")
    assert 0 < run["slot_failed_s"] < 60 and run["bring_up_s"] > 0
    assert run["router"]["routed"] >= len(ROUTER_PROMPTS) + 8
    assert run["exits"]["w1"] == -9 and run["bring_up_device_mem_mib"] is None


def test_serve_fleet_as_processes(root, monkeypatch):
    """``chip_smoke.run_serve_fleet`` on the CPU: a gateway, two workers
    (``--device cpu``) and a scheduler whose serve job routes with the
    fleet cache and KV migration on, at the smoke's pool geometry (8 slots,
    blocks of 16, chunks of 32, 40 blocks) over a tiny bf16 Llama; held to
    the smoke's gates (``serve_fleet_problems``): every answer the
    in-process reference's (the dry-pool requests through
    ``migration_reference``, whose tickets match the worker's), a pull
    landed with fewer prefill forwards than cold, a migration acked, no
    fallback, clean exits. Tiny blocks all fit a frame, so nothing fails at
    the cap here. Each process gets one CPU thread: four processes of the
    default thread count oversubscribe the cores and run ~9x slower."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    config = {"max_seq_len": 1024}
    job = {**chip_smoke.FLEET_JOB, "job.serve_name": "tiny", "job.model_preset": "tiny",
           "job.model_seed": 3, "job.model_config": config}
    spec = {"family": "llama", "preset": "tiny", "seed": 3, "config": config}
    traffic = chip_smoke.fleet_traffic(vocab=256)
    prefix_prompts, prefix_new = chip_smoke.prefix_requests()
    prefix_prompts = [[t % 256 for t in p] for p in prefix_prompts]
    model = load_model(spec, device="cpu")
    want = chip_smoke.fleet_reference(model, traffic)
    # serve_prefix's pool (512 blocks, chunks of 64), as the smoke's reference.
    want_prefix = chip_smoke._pool_run(model, prefix_prompts, prefix_new,
                                       prefix_cache=True)["answers"]
    run = asyncio.run(chip_smoke.run_serve_fleet(root, job, traffic, prefix_prompts, prefix_new,
                                                 device="cpu"))
    summary = chip_smoke.fleet_summary(run, 2 * 2 * 16 * 2 * 16 * 2)
    problems = chip_smoke.serve_fleet_problems(run, summary, want=want, want_prefix=want_prefix,
                                               layers=2, device="cpu")
    assert not problems, (problems, summary, {r: Path(p).read_text()[-3000:]
                                              for r, p in run["logs"].items()})
    # The worker cut the in-process pool's tickets: the short request (3
    # blocks) first, then the long one (9), both shipped at these sizes.
    assert [(e["request"], e["blocks"]) for e in want["migrate_events"]] == [(6, 3), (5, 9)]
    shipped = [m["blocks"] for b in summary["migrations"].values() for m in b]
    assert shipped == [3, 9]
    assert summary["pulls"][summary["puller"]][0]["blocks"] == 2
    assert summary["frame_cap"]["pull_failures"] == summary["frame_cap"]["migrate_failures"] == 0
    assert run["router"]["directory_entries"] > 0 and run["bring_up_s"] > 0


@pytest.mark.parametrize("mode", [dict(scheduling="window"), dict(batch_window_ms=-1.0),
                                  dict(scheduling="continuous", queue_limit=1)])
def test_infer_executor_modes_answer_as_the_pool(mode):
    """Window batching and independent decodes give the pool's greedy
    tokens; with a queue limit of 1 a burst meets backpressure as an
    ``ok=False`` response with a retry hint."""
    spec = _infer_spec(**mode)
    model = {"family": "llama", "preset": "tiny", "seed": 1, "serve_dtype": "float32"}
    want = _pool_answers(model, PROMPTS, N_NEW, POOL)

    async def main():
        node = Node(TcpTransport(), peer_id="w")
        await node.start(LISTEN)
        ex = InProcessInferExecutor(node, torch.device("cpu"))
        handler = {}
        orig_on = node.on

        def on(protocol, cls):  # capture the registered handler
            builder = orig_on(protocol, cls)
            orig_respond = builder.respond_with

            def respond_with(fn):
                handler["fn"] = fn
                return orig_respond(fn)

            builder.respond_with = respond_with
            return builder

        node.on = on
        execution = await ex.execute("j", spec, "")
        for _ in range(600):
            if "fn" in handler:
                break
            await asyncio.sleep(0.05)
        try:
            resps = await asyncio.gather(*(
                handler["fn"]("c", GenerateRequest(serve_name="t", prompts=[p], max_new_tokens=n))
                for p, n in zip(PROMPTS, N_NEW)))
        finally:
            await execution.cancel()
            await node.stop()
        return resps, (await execution.wait()).state

    resps, state = asyncio.run(main())
    assert state == "cancelled"
    if mode.get("queue_limit"):
        busy = [r for r in resps if not r.ok]
        assert busy and all(r.retry_after_ms > 0 and r.tokens == [] for r in busy)
        assert all(r.tokens == w for r, w in zip(resps, want) if r.ok)
    else:
        assert [r.tokens for r in resps] == want
