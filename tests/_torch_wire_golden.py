"""The port's untraced wire, recorded for a golden comparison.

``record()`` runs a tiny-Llama blocking DiLoCo job (2 rounds) under the
port's scheduler, with the port's parameter server, a JAX and a torch
trainer, and then one serving request through the port's router to a torch
worker, all untraced and over loopback TCP. It returns every object the
port's nodes encode (control messages and push headers), grouped by type
(and kind) as the distinct encodings, hex, after ``mask``.

``mask`` replaces, at equal length, what differs between two runs of the
same code: random ids (UUIDs and a serving job's suffix) and the
trainer's index in its job id (the auction decides which trainer is
``w0``). Every other byte stays. A round is one batch on each trainer, so
no count depends on timing. Types whose bytes depend on the auction's
order, on the temporary directory or on when a node stops or reports
(``DispatchJob``, ``JobStatus``, the ``ServeLoad`` heartbeat) are left
out.

The committed golden list (``torch_untraced_wire.json`` beside this file)
was written by this module on the tree before tracing was ported::

    PYTHONPATH=<that tree>:<that tree>/tests python tests/_torch_wire_golden.py OUT.json

It imports nothing that tree lacks.
"""

from __future__ import annotations

import asyncio
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
from safetensors.numpy import save_file

GOLDEN = Path(__file__).with_name("torch_untraced_wire.json")
LISTEN = ["127.0.0.1:0"]
ROUNDS = 2
UNSTABLE = {"DispatchJob", "JobStatus", "ServeLoad"}

_UUID = re.compile(rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}(-w[0-9])?")
_SERVE_ID = re.compile(rb"(serve-[a-z]+-[0-9]+-)[0-9a-f]{8}")


def mask(wire: bytes) -> bytes:
    """``wire`` with its run-specific bytes replaced at equal length."""
    wire = _UUID.sub(lambda m: b"0" * 8 + b"-0000" * 3 + b"-" + b"0" * 12
                     + (b"-w0" if m.group(1) else b""), wire)
    return _SERVE_ID.sub(lambda m: m.group(1) + b"0" * 8, wire)


def training_data(root: Path) -> tuple[Path, Path]:
    """The tiny Llama's weights and four token slices under ``root``."""
    from _torch_parity import tiny_pair

    from hypha_tpu.executor.serialization import flatten_tree

    _, variables, _ = tiny_pair("llama", seed=7)
    weights = root / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        ids = ((rng.integers(0, 256, (8, 1)) + np.arange(16)) % 256).astype(np.int32)
        save_file({"input_ids": ids}, str(data / f"slice_{i:04d}.safetensors"))
    return weights, data


def job(weights: Path):
    """The 2-round job on two trainers, one batch each a round, as the JAX
    package builds it."""
    from hypha_tpu.messages import Adam, Fetch, Nesterov, PriceRange, Reference, to_json_dict
    from hypha_tpu.resources import Resources as JResources
    from hypha_tpu.scheduler.job_config import DiLoCoJob, DiLoCoRounds, JobResources

    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"dtype": "float32"},
             "source": to_json_dict(Fetch(Reference.from_uri(weights.as_uri())))}
    return DiLoCoJob(
        model=model, dataset="counting",
        rounds=DiLoCoRounds(update_rounds=ROUNDS, avg_samples_between_updates=2,
                            max_batch_size=2),
        inner_optimizer=Adam(lr=3e-3), outer_optimizer=Nesterov(lr=0.7, momentum=0.9),
        resources=JobResources(
            num_workers=2, worker=JResources(gpu=1.0, cpu=1.0, memory=10),
            parameter_server=JResources(cpu=1.0, memory=10),
            worker_price=PriceRange(bid=1.0, max=10.0),
            parameter_server_price=PriceRange(bid=1.0, max=10.0)))


def run_job(scheduler: str, ps: str, weights: Path, data: Path):
    """The mixed job under ``scheduler``'s gateway, data node and
    orchestrator, the server on ``ps``'s worker node, the JAX and the torch
    trainer beside it."""
    from hypha_tpu import messages as jmsg
    from hypha_tpu.data_node import DataNode as JDataNode
    from hypha_tpu.gateway import Gateway as JGateway
    from hypha_tpu.network import Node as JNode
    from hypha_tpu.network import TcpTransport as JTcp
    from hypha_tpu.resources import Resources as JResources
    from hypha_tpu.scheduler.orchestrator import Orchestrator as JOrchestrator
    from hypha_tpu.worker.arbiter import OfferConfig as JWOffer
    from hypha_tpu.worker.runtime import WorkerNode as JWorkerNode
    from hypha_tpu_torch import messages as tmsg
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.runtime import WorkerNode

    port_sched = scheduler == "port"
    GW, DN, N, Tcp = ((Gateway, DataNode, Node, TcpTransport) if port_sched
                      else (JGateway, JDataNode, JNode, JTcp))
    spec = tmsg.decode(jmsg.encode(job(weights))) if port_sched else job(weights)
    root = Path(tempfile.mkdtemp(prefix="te"))  # bridge sockets: paths under 108 bytes

    async def main():
        gw = GW(Tcp(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        psw = (WorkerNode(TcpTransport(), resources=Resources(cpu=2, memory=200), device="cpu",
                          peer_id="psw", bootstrap=boot, work_root=root / "p") if ps == "port"
               else JWorkerNode(JTcp(), resources=JResources(cpu=2, memory=200), peer_id="psw",
                                bootstrap=boot, work_root=root / "p"))
        parts = [DN(Tcp(), {"counting": data}, peer_id="data", bootstrap=boot),
                 JWorkerNode(JTcp(), resources=JResources(gpu=2, cpu=8, memory=1000),
                             peer_id="wjax", offer=JWOffer(strategy="whole"), bootstrap=boot,
                             work_root=root / "j"),
                 WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root / "t"),
                 psw]
        sched = N(Tcp(), peer_id="sched", bootstrap=boot)
        started = []
        try:
            for part in (*parts, sched):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            orch = (Orchestrator if port_sched else JOrchestrator)(sched)
            return await orch.run(spec, auction_timeout=1.5)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    try:
        return asyncio.run(asyncio.wait_for(main(), 150))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def serve_once(weights: Path, prompt: list) -> list:
    """One request, 6 new tokens, through the port's router to a torch
    worker; returns the tokens."""
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.serving import ServingSupervisor
    from hypha_tpu_torch.worker.infer_executor import generate_remote
    from hypha_tpu_torch.worker.runtime import WorkerNode

    spec = {"family": "llama", "preset": "tiny", "config": {"dtype": "float32"},
            "weights": str(weights), "serve_dtype": "float32"}
    root = Path(tempfile.mkdtemp(prefix="ts"))

    async def main():
        gw = Gateway(TcpTransport(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        worker = WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", bootstrap=boot, work_root=root)
        sched = Node(TcpTransport(), peer_id="tsched", bootstrap=boot)
        client = Node(TcpTransport(), peer_id="client", bootstrap=boot)
        started = []
        try:
            for part in (worker, sched, client):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            sup = ServingSupervisor(sched, spec, "mix", max_batch=4, max_new_tokens=16,
                                    pool_block_size=8, pool_ragged=True, route=True)
            runner = asyncio.create_task(sup.run())
            try:
                await client.wait_for_bootstrap()
                for _ in range(1200):
                    deps = [d for d in sup._deployments if d is not None]
                    if deps and all(d.load is not None for d in deps):
                        break
                    await asyncio.sleep(0.05)
                return (await generate_remote(client, "mix", [prompt], 6, timeout=120))[0]
            finally:
                await sup.stop()
                await asyncio.wait_for(runner, 30)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    try:
        return asyncio.run(asyncio.wait_for(main(), 240))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def record() -> dict:
    """Type (``Type`` or ``Type:kind``; ``header`` for a push header) ->
    the sorted distinct masked encodings, hex, of the untraced job and
    request; and every (object, encoding) under ``"sent"``."""
    from hypha_tpu_torch import messages as tmsg

    sent: list = []
    encode = tmsg.encode

    def recording(obj):
        out = encode(obj)
        sent.append((obj, out))
        return out

    root = Path(tempfile.mkdtemp(prefix="tw"))
    tmsg.encode = recording
    try:
        weights, data = training_data(root)
        result = run_job("port", "port", weights, data)
        assert result.rounds == ROUNDS, result
        tokens = serve_once(weights, [3, 1, 4, 1, 5])
        assert len(tokens) == 6, tokens
    finally:
        tmsg.encode = encode
        shutil.rmtree(root, ignore_errors=True)
    groups: dict = {}
    for obj, wire in sent:
        name = "header" if isinstance(obj, dict) else type(obj).__name__
        if name in UNSTABLE:
            continue
        kind = getattr(getattr(obj, "kind", None), "value", None)
        key = f"{name}:{kind}" if kind is not None else name
        groups.setdefault(key, set()).add(mask(wire).hex())
    return {"wire": {k: sorted(v) for k, v in sorted(groups.items())}, "sent": sent}


if __name__ == "__main__":
    out = record()["wire"]
    Path(sys.argv[1]).write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print({k: len(v) for k, v in out.items()})
