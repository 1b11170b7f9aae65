"""Port parity: the torch worker runtime on a hypha network.

1. The JAX scheduler (``Orchestrator``), a JAX ``Gateway`` and a JAX
   ``DataNode`` on the JAX ``TcpTransport`` auction and dispatch a 2-round
   DiLoCo job of the tiny f32 Llama (θ₀ from a ``source`` file) onto one
   JAX ``WorkerNode`` and one port ``WorkerNode`` (in-process torch trainer
   on the CPU), both training, and a port ``WorkerNode`` hosting the
   parameter server. Both rounds close, both workers report finite losses
   for rounds 0 and 1, and the two workers' Δθ files carry the same names,
   shapes and dtype.
2. The same job the other way round: the port's scheduler
   (``Orchestrator`` on a port ``Node``), the port's gateway and data node
   on the port's ``TcpTransport`` run it on a JAX ``WorkerNode`` and a port
   ``WorkerNode``, with a port ``WorkerNode`` hosting the parameter server.
   The job is the JAX ``DiLoCoJob`` decoded by the port's codec. Both
   rounds close with finite losses from both workers.
3. The port alone (gateway, data node, worker nodes and scheduler on the
   port's ``TcpTransport``), with the trainer CLI as a process of its own
   and with two in-process trainers: the smoke's ``train_node`` phase on
   the CPU, held to the same gates (``chip_smoke.node_problems``).
4. A ``WorkerNode`` built with no CUDA and no ``device`` raises.
5. A JAX ``WorkerNode`` and a port ``WorkerNode`` share an int8, stream
   (F = 2) job: once under the port's scheduler with the port's parameter
   server, once under the JAX scheduler with the JAX parameter server.
   Every round closes with finite losses from both workers.
"""

from __future__ import annotations

import asyncio
import re
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import chip_smoke
from _torch_parity import tiny_pair
from hypha_tpu.data_node import DataNode as JDataNode
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.gateway import Gateway as JGateway
from hypha_tpu import messages as jmsg
from hypha_tpu.messages import Adam, Fetch, Nesterov, PriceRange, Reference, to_json_dict
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.resources import Resources as JResources
from hypha_tpu.scheduler.job_config import DiLoCoJob, DiLoCoRounds, JobResources
from hypha_tpu.scheduler.metrics_bridge import CallbackConnector
from hypha_tpu.scheduler.orchestrator import Orchestrator
from hypha_tpu.worker.arbiter import OfferConfig as JOfferConfig
from hypha_tpu.worker.runtime import WorkerNode as JWorkerNode
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.data_node import DataNode
from hypha_tpu_torch.gateway import Gateway
from hypha_tpu_torch.network import Node, TcpTransport
from hypha_tpu_torch.scheduler.metrics_bridge import CallbackConnector as TCallbackConnector
from hypha_tpu_torch.scheduler.orchestrator import Orchestrator as TOrchestrator
from hypha_tpu_torch.resources import Resources
from hypha_tpu_torch.worker.arbiter import OfferConfig
from hypha_tpu_torch.worker.runtime import WorkerNode

SEQ, VOCAB, ROUNDS = 16, 256, 2
LISTEN = ["127.0.0.1:0"]


def _dataset(root: Path) -> Path:
    """Four slices of counting sequences (learnable from the current token)."""
    d = root / "data"
    d.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        starts = rng.integers(0, VOCAB, (8, 1))
        ids = ((starts + np.arange(SEQ)) % VOCAB).astype(np.int32)
        save_file({"input_ids": ids}, str(d / f"slice_{i:04d}.safetensors"))
    return d


def _mixed_job(weights: Path, rounds: int = ROUNDS, **over) -> DiLoCoJob:
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"dtype": "float32"},
             "source": to_json_dict(Fetch(Reference.from_uri(weights.as_uri())))}
    return DiLoCoJob(
        model=model, dataset="counting",
        rounds=DiLoCoRounds(update_rounds=rounds, avg_samples_between_updates=8, max_batch_size=2),
        inner_optimizer=Adam(lr=3e-3), outer_optimizer=Nesterov(lr=0.7, momentum=0.9),
        resources=JobResources(
            num_workers=2, worker=JResources(gpu=1.0, cpu=1.0, memory=10),
            parameter_server=JResources(cpu=1.0, memory=10),
            worker_price=PriceRange(bid=1.0, max=10.0),
            parameter_server_price=PriceRange(bid=1.0, max=10.0)),
        **over,
    )


def test_jax_scheduler_runs_a_job_on_jax_and_torch_workers(tmp_path):
    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data_dir = _dataset(tmp_path)
    # Each job's bridge socket lives under its work root, and a unix
    # socket's path must stay under 108 bytes: a short root.
    root = Path(tempfile.mkdtemp(prefix="wn"))
    tracked: list = []

    async def main():
        gw = JGateway(JTcp(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        parts = [JDataNode(JTcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot),
                 JWorkerNode(JTcp(), resources=JResources(gpu=2, cpu=8, memory=1000),
                             peer_id="wjax", offer=JOfferConfig(strategy="whole"),
                             bootstrap=boot, work_root=root / "j"),
                 WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root / "t"),
                 WorkerNode(TcpTransport(), resources=Resources(cpu=2, memory=200), device="cpu",
                            peer_id="psw", bootstrap=boot, work_root=root / "p")]
        sched = JNode(JTcp(), peer_id="sched", bootstrap=boot)
        started = []
        try:
            for part in (*parts, sched):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            orch = Orchestrator(sched, metrics_connector=CallbackConnector(
                lambda w, r, n, v: tracked.append((w, r, n, v))))
            return await orch.run(_mixed_job(weights), auction_timeout=1.5)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    try:
        with chip_smoke.node_probes("cpu") as rec:
            result = asyncio.run(asyncio.wait_for(main(), 150))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == ROUNDS
    losses = {(w, r): v for w, r, n, v in tracked if n == "loss"}
    assert set(losses) == {(w, r) for w in ("wjax", "wtorch") for r in range(ROUNDS)}, losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    # The torch parameter server received a Δθ from each worker each round,
    # in the same flat names, shapes and dtype.
    got = {(d["from"], d["round"]): d["tensors"] for d in rec["deltas"]}
    assert set(got) == {(w, r) for w in ("wjax", "wtorch") for r in range(ROUNDS)}, sorted(got)
    want = got[("wjax", 0)]
    assert want and all(dtype == "F32" for dtype, _ in want.values())
    assert all(spec == want for spec in got.values())
    assert len(rec["fold_s"]) == 2 * ROUNDS and len(rec["outer_step_s"]) == ROUNDS


def test_port_scheduler_runs_a_job_on_jax_and_torch_workers(tmp_path):
    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data_dir = _dataset(tmp_path)
    # The JAX job, as the port decodes it off the wire.
    job = tmsg.decode(jmsg.encode(_mixed_job(weights)))
    assert type(job).__module__ == "hypha_tpu_torch.scheduler.job_config"
    root = Path(tempfile.mkdtemp(prefix="wp"))  # bridge sockets: paths under 108 bytes
    tracked: list = []

    async def main():
        gw = Gateway(TcpTransport(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        parts = [DataNode(TcpTransport(), {"counting": data_dir}, peer_id="data", bootstrap=boot),
                 JWorkerNode(JTcp(), resources=JResources(gpu=2, cpu=8, memory=1000),
                             peer_id="wjax", offer=JOfferConfig(strategy="whole"),
                             bootstrap=boot, work_root=root / "j"),
                 WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root / "t"),
                 WorkerNode(TcpTransport(), resources=Resources(cpu=2, memory=200), device="cpu",
                            peer_id="psw", bootstrap=boot, work_root=root / "p")]
        sched = Node(TcpTransport(), peer_id="sched", bootstrap=boot)
        started = []
        try:
            for part in (*parts, sched):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            orch = TOrchestrator(sched, metrics_connector=TCallbackConnector(
                lambda w, r, n, v: tracked.append((w, r, n, v))))
            return await orch.run(job, auction_timeout=1.5)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    try:
        with chip_smoke.node_probes("cpu") as rec:
            result = asyncio.run(asyncio.wait_for(main(), 150))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == ROUNDS and result.attempt == 0
    losses = {(w, r): v for w, r, n, v in tracked if n == "loss"}
    assert set(losses) == {(w, r) for w in ("wjax", "wtorch") for r in range(ROUNDS)}, losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    assert {(w, r) for w, r, m in result.metrics} == set(losses)
    # Both workers sized by the reference's rule (gpu 2 offered whole, 1
    # asked: floor 2, clamped to max_batch_size 2), the server on psw.
    assert sorted((d["kind"], d["peer"], d["batch_size"]) for d in rec["dispatch"]) == [
        ("aggregate", "psw", None), ("train", "wjax", 2), ("train", "wtorch", 2)]
    assert [p["round"] for p in rec["progress"] if p["kind"] == "updated"] == [0, 1]
    got = {(d["from"], d["round"]) for d in rec["deltas"]}
    assert got == {(w, r) for w in ("wjax", "wtorch") for r in range(ROUNDS)}, sorted(got)
    assert not rec["renew_failures"]


@pytest.mark.parametrize("workers,runtime", [(1, "process"), (2, "in-process")])
def test_port_fabric_runs_the_smoke_job_on_the_cpu(workers, runtime):
    """``chip_smoke.py``'s ``train_node`` phase, rehearsed on the CPU (one
    trainer process), and the card test's two in-process trainers, under
    the port's scheduler."""
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"dtype": "float32"}, "seed": 0}
    root = Path(tempfile.mkdtemp(prefix="tn"))
    try:
        run = asyncio.run(asyncio.wait_for(chip_smoke.run_node_job(
            root, model, device="cpu", rounds=ROUNDS, steps=3, batch=2, seq=SEQ, period=64,
            lr=3e-3, limit_s=90, workers=workers, train_runtime=runtime), 120))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log = "\n".join(run["rec"]["log"])
    assert chip_smoke.node_problems(run, rounds=ROUNDS,
                                    expect=chip_smoke.flat_f32_spec(model)) == [], log[-3000:]
    peers = [f"w{i}" for i in range(workers)]
    assert (sorted(run["workers"]), run["ps"]) == (peers, "psw")
    assert set(run["jobs"]) == {*peers, "aggregate"}
    if runtime == "process":  # the trainer's output reaches the worker's log
        assert "attention path: plain (host)" in log and "attention launches: " in log
        for what in ("delta written", "update merged"):
            assert [int(r) for r in re.findall(rf"round (\d+): {what} in [\d.]+ s", log)] \
                == list(range(ROUNDS)), what
    rec = run["rec"]
    assert len(rec["slices"]) >= 2 * workers  # two slices of three batches of two each
    assert sorted(p["round"] for p in rec["push"]) == sorted(list(range(ROUNDS)) * workers)
    assert [b["round"] for b in rec["broadcast"]] == [0, 1]
    assert all(b["bytes"] == rec["deltas"][0]["bytes"] for b in rec["broadcast"])
    assert run["auction_to_dispatch_s"] > 0 and run["first_beat_s"] > 0
    timing = chip_smoke.progress_timing(run)
    assert timing["step_ms"] > 0 and timing["handling_ms_max"] > 0
    assert len(timing["round_boundary_s"]) == ROUNDS * workers
    assert timing["progress_messages"] == len(rec["progress"])
    if workers == 1:  # one worker's countdown: exactly ``steps`` batches a round
        beats = [p["round"] for p in rec["progress"] if p["kind"] == "status"]
        assert beats == [r for r in range(ROUNDS) for _ in range(3)]


def test_port_fabric_runs_the_stream_job_on_the_cpu():
    """``chip_smoke.py``'s ``train_stream`` phase rehearsed on the CPU: the
    smoke's job options (int8, stream, 4 fragments, 4 rounds) on a tiny
    Llama, one trainer process, held to ``stream_problems``; the trainer's
    log gives every flight and its step seconds."""
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"dtype": "float32"}, "seed": 0}
    opts = chip_smoke.STREAM_OPTIONS
    rounds = opts["num_fragments"]
    root = Path(tempfile.mkdtemp(prefix="ts"))
    try:
        run = asyncio.run(asyncio.wait_for(chip_smoke.run_node_job(
            root, model, device="cpu", rounds=rounds, steps=3, batch=2, seq=SEQ, period=64,
            lr=3e-3, limit_s=90, job_options=opts), 150))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log = "\n".join(run["rec"]["log"])
    assert chip_smoke.stream_problems(
        run, rounds=rounds, fragments=opts["num_fragments"],
        expect=chip_smoke.flat_f32_spec(model), codec=opts["delta_codec"]) == [], log[-3000:]
    trainer = chip_smoke.trainer_log(log)
    assert sorted(trainer["flights"]) == list(range(rounds))
    for r, flight in trainer["flights"].items():
        assert flight["fragment"] == r % rounds and flight["bytes"] > 0
        assert flight["flight_s"] > 0 and flight["finish_wait_s"] >= 0
        assert flight["steps_in_flight"] >= 0
    assert len(trainer["step_s"]["flight"]) + len(trainer["step_s"]["no_flight"]) == \
        trainer["batches"] >= rounds * 3
    # The host's plain attention, once per layer (tiny: 2) per batch.
    assert trainer["launches"] == {"fwd": 0, "dq": 0, "dkv": 0, "flash_plain": 0,
                                   "dense": 2 * trainer["batches"]}
    rec = run["rec"]
    assert len(rec["encode_s"]) == len(rec["outer_step_s"]) == rounds
    assert [d["frame"]["codec"] for d in rec["deltas"]] == ["int8"] * rounds


def test_worker_node_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WorkerNode(TcpTransport(), resources=Resources(gpu=1))
    with pytest.raises(ValueError, match="train_runtime"):
        WorkerNode(TcpTransport(), resources=Resources(gpu=1), device="cpu", train_runtime="ray")
    node = WorkerNode(TcpTransport(), resources=Resources(gpu=1), device="cpu",
                      train_runtime="process")
    assert node.device == torch.device("cpu")
    assert sorted(node.job_manager.supported()) == [("aggregate", "parameter-server"),
                                                   ("infer", "generate"),
                                                   ("train", "diloco-transformer")]
    train = node.job_manager.executors[("train", "diloco-transformer")]
    assert train.cmd == sys.executable
    assert train.args[:2] == ["-m", "hypha_tpu_torch.executor.training"]
    assert train.args[-2:] == ["--device", "{DEVICE}"] and str(train.device) == "cpu"


@pytest.mark.parametrize("scheduler", ["port", "jax"])
def test_mixed_workers_run_an_int8_stream_job(tmp_path, scheduler):
    """int8 + stream (F = 2) over 3 rounds on a JAX and a torch worker:
    under the port's scheduler and parameter server, and under the JAX
    scheduler and parameter server (``native._load`` stays as it is: the
    JAX server's own path)."""
    rounds = 3
    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data_dir = _dataset(tmp_path)
    jjob = _mixed_job(weights, rounds, delta_codec="int8", sync_mode="stream", num_fragments=2)
    root = Path(tempfile.mkdtemp(prefix="ws"))  # bridge sockets: paths under 108 bytes
    tracked: list = []
    port = scheduler == "port"

    async def main():
        Tcp, GW, DN, Sched = (TcpTransport, Gateway, DataNode, Node) if port else \
            (JTcp, JGateway, JDataNode, JNode)
        gw = GW(Tcp(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        ps = (WorkerNode(TcpTransport(), resources=Resources(cpu=2, memory=200), device="cpu",
                         peer_id="psw", bootstrap=boot, work_root=root / "p") if port else
              JWorkerNode(JTcp(), resources=JResources(cpu=2, memory=200), peer_id="psw",
                          bootstrap=boot, work_root=root / "p"))
        parts = [DN(Tcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot),
                 JWorkerNode(JTcp(), resources=JResources(gpu=2, cpu=8, memory=1000),
                             peer_id="wjax", offer=JOfferConfig(strategy="whole"),
                             bootstrap=boot, work_root=root / "j"),
                 WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root / "t"),
                 ps]
        sched = Sched(Tcp(), peer_id="sched", bootstrap=boot)
        started = []
        try:
            for part in (*parts, sched):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            if port:
                orch = TOrchestrator(sched, metrics_connector=TCallbackConnector(
                    lambda w, r, n, v: tracked.append((w, r, n, v))))
                return await orch.run(tmsg.decode(jmsg.encode(jjob)), auction_timeout=1.5)
            orch = Orchestrator(sched, metrics_connector=CallbackConnector(
                lambda w, r, n, v: tracked.append((w, r, n, v))))
            return await orch.run(jjob, auction_timeout=1.5)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    try:
        with chip_smoke.node_probes("cpu") as rec:
            result = asyncio.run(asyncio.wait_for(main(), 200))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == rounds
    losses = {(w, r): v for w, r, n, v in tracked if n == "loss"}
    assert set(losses) == {(w, r) for w in ("wjax", "wtorch") for r in range(rounds)}, losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    if port:
        # The port's server took one HQD1 frame per worker and round, tagged
        # with the round's due fragment, and broadcast a frame per round.
        frames = {(d["from"], d["round"]): d["frame"] for d in rec["deltas"]}
        assert set(frames) == {(w, r) for w in ("wjax", "wtorch") for r in range(rounds)}
        for (w, r), frame in frames.items():
            assert frame["codec"] == "int8", (w, r)
            assert frame["tag"] == {"round": r, "fragment_id": r % 2, "fragments": 2}, (w, r)
        assert frames[("wjax", 0)]["tensors"] == frames[("wtorch", 0)]["tensors"]
        assert frames[("wjax", 1)]["tensors"] == frames[("wtorch", 1)]["tensors"]
        assert set(frames[("wjax", 0)]["tensors"]).isdisjoint(frames[("wjax", 1)]["tensors"])
        assert sorted(b["round"] for b in rec["broadcast"]) == list(range(rounds))
        assert [p["round"] for p in rec["progress"] if p["kind"] == "updated"] == [0, 1, 2]
        assert not rec["renew_failures"]
