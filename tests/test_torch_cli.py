"""Port parity: the trainer as an executor process.

A mixed job: the JAX worker runtime's ``ProcessExecutor`` spawns ``python
-m hypha_tpu_torch.executor.training ... --device cpu`` behind the JAX Job
Bridge, and a real JAX ``ParameterServerExecutor`` (one worker, Nesterov
0.7/0.9) and a scheduler stand-in run over ``MemoryTransport``, for 2
rounds of the tiny f32 Llama from a θ₀ ``source`` file. The same harness
then runs the JAX CLI (``-m hypha_tpu.executor.training``). Both jobs
complete, the parameter server's broadcast updates agree per round within
0.07 x LR (tests/test_torch_training.py's 0.05 x LR on Δθ times the outer
step's lr·(1+μ) = 1.33), and the port's process imports no JAX (its
``-X importtime`` lines, piped through the worker's log, name none).

Then the CLI in-process (``main([... "--device", "cpu"])``, the job
inline) and as a process reading ``--job @file``, behind the port's own
Job Bridge with stand-ins for the scheduler (``LocalNode``, on
``chip_smoke.Scheduler``) and for the parameter server (``LocalConnector``,
on ``chip_smoke.ps_round``, holding three tensors of the fold, the update
and the momentum against the CPU's bit for bit) on the CPU; and without
CUDA and with no ``--device`` the CLI refuses to start."""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import chip_smoke
from _torch_parity import tiny_pair
from hypha_tpu import messages as jmsg
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.network import MemoryTransport, Node
from hypha_tpu.worker.process_executor import ProcessExecutor
from hypha_tpu.worker.ps_executor import ParameterServerExecutor
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor import training

ROOT = Path(__file__).resolve().parents[1]
SEQ, VOCAB, LR, ROUNDS, PER_ROUND = 16, 256, 3e-3, 2, 3
FORBIDDEN = re.compile(r"\|\s+(jax|jaxlib|flax|optax|hypha_tpu|safetensors|httpx)(\.|$)")


@pytest.fixture
def inputs(tmp_path):
    """θ₀ in native flat names and one slice of counting sequences."""
    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    starts = np.random.default_rng(42).integers(0, VOCAB, (PER_ROUND * 2, 1))
    data = tmp_path / "slice.safetensors"
    save_file({"input_ids": ((starts + np.arange(SEQ)) % VOCAB).astype(np.int32)}, str(data))
    return weights, data


def _job(weights: Path, data: Path) -> jmsg.JobSpec:
    cfg = jmsg.TrainExecutorConfig(
        model={"model_type": "causal-lm", "family": "llama", "preset": "tiny",
               "config": {"dtype": "float32"},
               "source": jmsg.to_json_dict(jmsg.Fetch(jmsg.Reference.from_uri(weights.as_uri())))},
        data=jmsg.Fetch(jmsg.Reference.from_uri(data.as_uri())),
        updates=jmsg.Send(jmsg.Reference.from_peers(["ps"], "updates")),
        results=jmsg.Receive(jmsg.Reference.from_peers(["ps"], "results")),
        optimizer=jmsg.Adam(lr=LR, weight_decay=0.01),
        batch_size=2,
    )
    return jmsg.JobSpec(job_id="mixed", executor=jmsg.Executor("train", "diloco-transformer", train=cfg))


class _Scheduler:
    """PER_ROUND inner steps a round for ROUNDS rounds; the parameter
    server's UPDATED closes its job after the last round."""

    def __init__(self) -> None:
        self.done = self.batches = 0
        self.scheduled = False
        self.kinds: list = []
        self.updated: list = []

    async def on_progress(self, peer, p):
        K, R, RK = jmsg.ProgressKind, jmsg.ProgressResponse, jmsg.ProgressResponseKind
        self.kinds.append((peer, p.kind.value))
        if p.kind == K.UPDATED:
            self.updated.append(p.round)
            return R(kind=RK.DONE if p.round >= ROUNDS - 1 else RK.OK)
        if p.kind == K.STATUS:
            if self.done >= ROUNDS:
                return R(kind=RK.DONE)
            self.batches += 1
            if not self.scheduled and self.batches >= PER_ROUND:
                self.scheduled = True
                return R(kind=RK.SCHEDULE_UPDATE, counter=0)
            return R(kind=RK.CONTINUE)
        if p.kind == K.UPDATE_RECEIVED:
            self.done += 1
            self.batches, self.scheduled = 0, False
            return R(kind=RK.DONE if self.done >= ROUNDS else RK.CONTINUE)
        return R(kind=RK.OK)


def _mixed_job(tmp_path: Path, module: str, job: jmsg.JobSpec):
    sched_state = _Scheduler()

    async def main():
        hub = MemoryTransport()
        nodes = {p: Node(hub.shared(), peer_id=p) for p in ("w", "ps", "sched")}
        for n in nodes.values():
            await n.start()
        for x in nodes.values():
            for y in nodes.values():
                if x is not y:
                    x.add_peer_addr(y.peer_id, y.listen_addrs[0])
        nodes["sched"].on(jmsg.PROTOCOL_PROGRESS, jmsg.Progress).respond_with(
            sched_state.on_progress)
        agg = jmsg.JobSpec(job_id="agg", executor=jmsg.Executor(
            kind="aggregate", name="parameter-server", aggregate=jmsg.AggregateExecutorConfig(
                updates=jmsg.Receive(jmsg.Reference.from_peers(["w"], "updates")),
                results=jmsg.Send(jmsg.Reference.from_peers(["w"], "results")),
                optimizer=jmsg.Nesterov(lr=0.7, momentum=0.9), num_workers=1)))
        ps_exec = await ParameterServerExecutor(nodes["ps"], tmp_path / "ps").execute(
            "agg", agg, "sched")
        executor = ProcessExecutor(
            node=nodes["w"], cmd=sys.executable,
            args=["-X", "importtime", "-m", module, "--socket", "{SOCKET_PATH}",
                  "--work-dir", "{WORK_DIR}", "--job", "{JOB_JSON}"]
            + (["--device", "cpu"] if module.startswith("hypha_tpu_torch") else []),
            work_root=work_root)
        train = await executor.execute("mixed", job, "sched")
        status = await asyncio.wait_for(train.wait(), 240)
        ps_status = await asyncio.wait_for(ps_exec.wait(), 60)
        for n in nodes.values():
            await n.stop()
        return status, ps_status

    (tmp_path / "ps").mkdir(parents=True)
    # The job's bridge socket lives in its work dir, and a unix socket's
    # path must stay under 108 bytes: a short root, not pytest's tmp_path.
    work_root = Path(tempfile.mkdtemp(prefix="hm"))
    try:
        status, ps_status = asyncio.run(asyncio.wait_for(main(), 300))
    finally:
        shutil.rmtree(work_root, ignore_errors=True)
    return status, ps_status, sched_state


def test_mixed_job_torch_trainer_on_a_jax_worker(tmp_path, inputs, monkeypatch, caplog):
    """The port's CLI as a JAX worker's process executor, beside the JAX CLI."""
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    caplog.set_level(logging.INFO, logger="hypha.worker.process")
    updates: dict = {}
    outer = ParameterServerExecutor._outer_step

    def capture(self, *args, **kwargs):
        out = outer(self, *args, **kwargs)
        dest = tmp_path / "updates" / updates["who"] / out.name
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(out, dest)
        return out

    monkeypatch.setattr(ParameterServerExecutor, "_outer_step", capture)
    job = _job(*inputs)
    logs, results = {}, {}
    for who, module in (("port", "hypha_tpu_torch.executor.training"),
                        ("jax", "hypha_tpu.executor.training")):
        updates["who"] = who
        caplog.clear()
        results[who] = _mixed_job(tmp_path / who, module, job)
        logs[who] = [r.getMessage() for r in caplog.records]

    for who, (status, ps_status, sched) in results.items():
        tail = "\n".join(logs[who][-30:])
        assert status.state == "completed", f"{who}: {status} {tail}"
        assert ps_status.state == "completed", f"{who}: {ps_status}"
        assert (sched.done, sched.updated) == (ROUNDS, list(range(ROUNDS))), who
        assert sched.kinds.count(("w", "status")) == ROUNDS * PER_ROUND, who
    # The port's process imported no JAX; the JAX one did (the check sees it).
    bad = [m for m in logs["port"] if FORBIDDEN.search(m)]
    assert not bad, bad[:5]
    assert any(FORBIDDEN.search(m) for m in logs["jax"])
    assert any("attention path: plain (host)" in m for m in logs["port"])
    for r in range(ROUNDS):
        name = f"update-{r}.safetensors"
        ref = load_file(str(tmp_path / "updates" / "jax" / name))
        got = load_file(str(tmp_path / "updates" / "port" / name))
        assert list(got) and set(got) == set(ref)
        for k, want in ref.items():
            assert got[k].dtype == want.dtype == np.float32 and got[k].shape == want.shape, k
            assert np.abs(got[k] - want).max() <= 0.07 * LR, (r, k)


# Tensors whose fold and outer step are held against the CPU's, bit for bit.
CHECK_NAMES = ("params/embed_tokens", "params/layers_0/self_attn/q_proj/kernel",
               "params/norm/weight")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype == torch.float32 and torch.equal(a.view(torch.int32), b.view(torch.int32))


class LocalNode(chip_smoke.Scheduler):
    """The scheduler behind the Job Bridge's ``/status/send``: the one node
    method the bridge calls, answering as ``TrainSession`` does."""

    async def request(self, peer, protocol, msg, timeout=30.0):
        return self.answer(msg)


class LocalConnector:
    """The parameter server behind the Job Bridge, with the data slices.

    ``fetch`` serves the slices in turn (and any other URI) through the
    port's ``fetch_uri``; ``send`` runs ``ps_round`` over the pushed Δθ on
    ``device``, holds three tensors of the sum, the update and the momentum
    against the same on the CPU, bit for bit, and queues the update in the
    trainer's ``incoming/``; ``receive`` yields the queued updates."""

    def __init__(self, work_dir, server_dir, slices, *, outer, device):
        self.work_dir, self.server_dir = Path(work_dir), Path(server_dir)
        self.slices = list(slices)
        self.outer, self.device = outer, device
        self.fetches = 0
        self.momentum = self.server_dir / "momentum.safetensors"
        self.landed: asyncio.Queue = asyncio.Queue()
        self.delta_specs: list = []  # {name: (dtype, shape)} of each Δθ file
        self.times: list = []  # ps_round's seconds, a dict a round
        self.serve_s: list = []
        self.stats: list = []
        self.cpu_mismatch: list = []

    async def fetch(self, fetch, dest):
        from hypha_tpu_torch.worker.connectors import fetch_uri

        uri = fetch.ref.uri
        if uri == "file:///slices":
            uri = self.slices[self.fetches % len(self.slices)].as_uri()
            self.fetches += 1
        return [await asyncio.to_thread(fetch_uri, uri, dest)]

    async def send(self, send, path, resource, meta=None):
        await self.landed.put(await asyncio.to_thread(self.serve_round, Path(path), dict(meta or {})))

    async def receive(self, receive, dest):
        while True:
            yield await self.landed.get()

    def serve_round(self, path: Path, meta: dict):
        from hypha_tpu_torch.executor.serialization import load_file, read_header, save_file
        from hypha_tpu_torch.stream.accum import RoundAccum
        from hypha_tpu_torch.worker.connectors import ReceivedFile
        from hypha_tpu_torch.worker.ps_executor import outer_step

        t_start = time.perf_counter()
        r, samples = int(meta["round"]), float(meta["num_samples"])
        self.delta_specs.append({k: (v["dtype"], tuple(v["shape"]))
                                 for k, v in read_header(path)[0].items()})
        check = self.server_dir / "cpu-check"
        check.mkdir(parents=True, exist_ok=True)
        if self.momentum.is_file():  # this round's momentum, for the CPU's step
            save_file(load_file(self.momentum, CHECK_NAMES), check / "momentum.safetensors")
        out, accum, stats, times = chip_smoke.ps_round(path, samples, r, self.momentum, self.server_dir,
                                            self.outer, self.device)
        self.times.append(times)
        self.stats.append(stats)
        card_sum = {k: accum.partial()[k].cpu() for k in CHECK_NAMES}
        del accum
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()  # the trainer process shares the card
        cpu = RoundAccum(device="cpu")
        cpu.fold_tree(load_file(path, CHECK_NAMES), samples)
        cpu_out = outer_step({"worker": (path, samples)}, check / "momentum.safetensors",
                             self.outer.lr, self.outer.momentum, check, r, accum=cpu, device="cpu")
        pairs = [("sum", card_sum, cpu.partial()),
                 ("update", load_file(out, CHECK_NAMES), load_file(cpu_out)),
                 ("momentum", load_file(self.momentum, CHECK_NAMES),
                  load_file(check / "momentum.safetensors"))]
        self.cpu_mismatch.append([f"{what} {k}" for what, card, host in pairs for k in CHECK_NAMES
                                  if not _bits_equal(card[k], host[k])])
        dest = self.work_dir / "incoming" / out.name
        dest.parent.mkdir(parents=True, exist_ok=True)
        os.replace(out, dest)
        self.serve_s.append(time.perf_counter() - t_start)
        return ReceivedFile(dest, dest.stat().st_size, "ps", "results",
                            {"resource": "results", "name": dest.name, "round": r})


@contextmanager
def serve_bridge(node, connector, work_dir, job_id):
    """The port's Job Bridge on an asyncio loop in a thread of its own,
    timing each ``/status/send`` it serves (``bridge.status_ms``)."""
    from hypha_tpu_torch.worker.bridge import Bridge

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="bridge", daemon=True)
    thread.start()
    bridge = Bridge(node, Path(work_dir), job_id, "sched", connector)
    bridge.status_ms = []
    serve_status = bridge._status

    async def timed_status(body, writer):
        t0 = time.perf_counter()
        try:
            await serve_status(body, writer)
        finally:  # also when stop() cancels the handler after its answer went out
            bridge.status_ms.append((time.perf_counter() - t0) * 1e3)

    bridge._status = timed_status
    try:
        asyncio.run_coroutine_threadsafe(bridge.start(), loop).result(30)
        yield bridge
    finally:
        try:
            asyncio.run_coroutine_threadsafe(bridge.stop(), loop).result(120)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(30)
            loop.close()




def run_train_cli(spec, slices, root: Path, *, device, rounds, steps, child_args=(),
                  limit_s=chip_smoke.CLI_LIMIT_S) -> dict:
    """Start ``python -m hypha_tpu_torch.executor.training`` as a process
    of its own behind the port's Job Bridge, with ``LocalNode`` and
    ``LocalConnector`` standing in for the scheduler, the parameter server
    and the network, and collect what they saw."""
    from hypha_tpu_torch.messages import Nesterov, to_json_dict

    work, server = root / "work", root / "ps"
    server.mkdir(parents=True, exist_ok=True)
    expect = chip_smoke.flat_f32_spec(spec.executor.train.model)
    node = LocalNode(rounds=rounds, steps=steps)
    conn = LocalConnector(work, server, slices, outer=Nesterov(), device=device)
    job = root / "job.json"
    job.write_text(json.dumps(to_json_dict(spec)))
    log_path = root / "trainer.log"
    repo = str(ROOT)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")]))}
    with serve_bridge(node, conn, work, spec.job_id) as bridge, open(log_path, "wb") as log:
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-m", "hypha_tpu_torch.executor.training", "--socket",
             str(bridge.socket_path), "--work-dir", str(work), "--job", f"@{job}", *child_args],
            stdout=log, stderr=subprocess.STDOUT, cwd=work, env=env,
        )
        try:
            rc = child.wait(timeout=limit_s)
        except subprocess.TimeoutExpired:
            rc = None  # cut at the limit
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        wall = time.perf_counter() - t0
    incoming = work / "incoming"
    return dict(rc=rc, wall_s=wall, node=node, conn=conn, status_ms=bridge.status_ms, expect=expect,
                log=log_path.read_text(errors="replace"),
                first_beat_s=(node.marks[0][1] - t0) if node.marks else None,
                leftover=sorted(p.name for p in incoming.iterdir()) if incoming.is_dir() else [])


def _stand_ins(tmp_path, data: Path):
    work, server = tmp_path / "work", tmp_path / "ps"
    server.mkdir(parents=True)
    node = LocalNode(rounds=ROUNDS, steps=PER_ROUND)
    conn = LocalConnector(work, server, [data], outer=tmsg.Nesterov(), device="cpu")
    return work, node, conn


def _check_rounds(node, conn):
    assert node.done == ROUNDS and len(node.marks) == ROUNDS * PER_ROUND
    losses = [m["loss"] for _, m in node.metrics]
    assert len(losses) == ROUNDS and all(np.isfinite(losses))
    assert len(conn.delta_specs) == ROUNDS and conn.cpu_mismatch == [[]] * ROUNDS
    # outer_step's parts were timed (on the CPU every copy counts as one to
    # the host); round 1 also reads the momentum back.
    parts = [set(t) for t in conn.times]
    assert parts[0] == {"fold_s", "outer_step_s", "write_s", "to_host_s", "norms_s"}
    assert parts[1] == parts[0] | {"read_s"}


def test_main_in_process_on_the_cpu(tmp_path, inputs):
    weights, data = inputs
    work, node, conn = _stand_ins(tmp_path, data)
    spec = tmsg.from_json_dict(jmsg.to_json_dict(_job(weights, data)))
    spec.executor.train.data = tmsg.Fetch(tmsg.Reference.from_uri("file:///slices"))
    with serve_bridge(node, conn, work, spec.job_id) as bridge:
        rc = training.main(["--socket", str(bridge.socket_path), "--work-dir", str(work),
                            "--job", json.dumps(tmsg.to_json_dict(spec)), "--device", "cpu"])
    # Counted once the bridge has stopped: the last answer reaches the
    # trainer before its handler records the time.
    assert rc == 0 and len(bridge.status_ms) == ROUNDS * (PER_ROUND + 3)
    _check_rounds(node, conn)
    assert conn.fetches >= 2  # two slices of three batches
    assert not list((work / "incoming").iterdir())


def test_cli_process_reads_the_job_from_a_file(tmp_path, inputs):
    """``run_train_cli`` on the CPU: ``--job @job.json``."""
    weights, data = inputs
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"dtype": "float32"},
             "source": tmsg.to_json_dict(tmsg.Fetch(tmsg.Reference.from_uri(weights.as_uri())))}
    spec = chip_smoke.train_spec("cli-file", model, batch=2, lr=LR)
    run = run_train_cli(spec, [data], tmp_path, device="cpu", rounds=ROUNDS,
                                   steps=PER_ROUND, child_args=["--device", "cpu"], limit_s=120)
    assert run["rc"] == 0, run["log"][-3000:]
    _check_rounds(run["node"], run["conn"])
    assert all(got == run["expect"] for got in run["conn"].delta_specs)
    assert run["leftover"] == [] and run["first_beat_s"] > 0
    assert "attention launches: " in run["log"]


def test_cli_without_cuda_refuses_to_start(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.main(["--socket", str(tmp_path / "none.sock"), "--work-dir", str(tmp_path),
                       "--job", "{}"])
    args = training.build_parser().parse_args(["--socket", "s", "--work-dir", "w", "--job", "@j"])
    assert (args.device, args.max_batches) == (None, None)
