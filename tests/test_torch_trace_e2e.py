"""Traced jobs and requests across the two packages, on the CPU.

1. A tiny-Llama blocking DiLoCo job (2 rounds) on one JAX and one torch
   worker, under each package's scheduler in turn (the JAX scheduler with
   the torch parameter server, the port's with the JAX one), with both
   packages' tracing on one directory. Both packages' ``build_timeline``
   over that directory give the same rounds, and every round span sits in
   its round's trace (but the JAX trainer's round-0 ``inner_steps``: the
   reference opens it before the round's context arrives).
2. The same job untraced, under the port's scheduler with the port's
   server, and an untraced request through the port's router: every
   control message and push header the port's nodes encode carries no
   trace context, has the JAX package's bytes and the bytes of the tree
   before tracing was ported (a committed golden list).
3. One traced serving request through a JAX router to a torch worker
   (refused before tracing was ported), and through the port's router to a
   JAX worker: the router's ``route`` span, the worker's ``serve`` span and
   the pool's ``prefill`` and ``decode`` spans share one trace.

The JAX and the torch nodes meet over loopback TCP (the two packages'
``MemoryTransport`` hubs are separate objects).
"""

from __future__ import annotations

import asyncio
import json
import shutil
import tempfile
from pathlib import Path

import pytest
from safetensors.numpy import save_file

from _torch_parity import tiny_pair
from _torch_wire_golden import GOLDEN, ROUNDS, record, run_job, training_data
from hypha_tpu import messages as jmsg
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.resources import Resources as JResources
from hypha_tpu.scheduler.serving import ServingSupervisor as JSupervisor
from hypha_tpu.telemetry import timeline as jtl
from hypha_tpu.telemetry import trace as jtrace
from hypha_tpu.worker import Arbiter as JArbiter
from hypha_tpu.worker import JobManager as JJobManager
from hypha_tpu.worker import LeaseManager as JLeaseManager
from hypha_tpu.worker import OfferConfig as JOfferConfig
from hypha_tpu.worker import StaticResourceManager as JStaticResources
from hypha_tpu.worker.infer_executor import InProcessInferExecutor as JInfer
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.gateway import Gateway
from hypha_tpu_torch.messages import INFER_EXECUTOR_NAME
from hypha_tpu_torch.network import Node, TcpTransport
from hypha_tpu_torch.resources import Resources
from hypha_tpu_torch.scheduler.serving import ServingSupervisor
from hypha_tpu_torch.telemetry import timeline as ttl
from hypha_tpu_torch.telemetry import trace as ttrace
from hypha_tpu_torch.worker.infer_executor import generate_remote
from hypha_tpu_torch.worker.runtime import WorkerNode

LISTEN = ["127.0.0.1:0"]
# Spans a round's trace holds (the scheduler's root aside).
ROUND_NAMES = {"inner_steps", "encode", "upload", "merge", "quorum_wait", "fold", "outer_step",
               "broadcast"}


@pytest.fixture
def weights(tmp_path):
    return training_data(tmp_path)


@pytest.fixture
def traced(tmp_path):
    d = tmp_path / "trace"
    jtrace._reset_for_tests()
    ttrace._reset_for_tests()
    jtrace.enable(d, node="jaxproc")
    ttrace.enable(d, node="torchproc")
    yield d
    jtrace._reset_for_tests()
    ttrace._reset_for_tests()


@pytest.mark.parametrize("scheduler,ps", [("jax", "port"), ("port", "jax")],
                         ids=["jax-scheduler", "port-scheduler"])
def test_a_traced_mixed_job_merges_alike_in_both_packages(weights, traced, scheduler, ps):
    result = run_job(scheduler, ps, *weights)
    assert result.rounds == ROUNDS
    jtrace.disable()
    ttrace.disable()
    tl = ttl.build_timeline(traced)
    assert tl == jtl.build_timeline(traced)
    assert ttl.render_text(tl) == jtl.render_text(tl)
    assert [r["round"] for r in tl["rounds"]] == list(range(ROUNDS))
    assert tl["reference_node"] == "scheduler"
    spans, _ = ttl.load_dir(traced)
    roots = {s["attrs"]["round"]: s for s in spans if s["name"] == "round"}
    assert sorted(roots) == list(range(ROUNDS))
    by = {}
    for s in spans:
        rnd = (s.get("attrs") or {}).get("round")
        if s["name"] in ROUND_NAMES and rnd is not None:
            by.setdefault((rnd, s["node"], s["name"]), []).append(s)
            if not (s["node"] == "wjax" and s["name"] == "inner_steps" and rnd == 0):
                assert s["trace_id"] == roots[rnd]["trace_id"], s
    for r in range(ROUNDS):
        for w in ("wjax", "wtorch"):
            for name in ("inner_steps", "encode", "upload", "merge"):
                assert len(by.get((r, w, name), [])) == 1, (r, w, name)
        for name, n in (("quorum_wait", 1), ("outer_step", 1), ("broadcast", 1), ("fold", 2),
                        ("upload", 2)):
            assert len(by.get((r, "psw", name), [])) == n, (r, name)
        peers = sorted(s["attrs"]["peer"] for s in by[(r, "psw", "upload")])
        assert peers == ["wjax", "wtorch"]
    # The input waits of the torch trainer join the trace the scheduler
    # last handed down; the first slice is fetched before any.
    waits = [s for s in spans if s["name"] == "input_wait" and s["node"] == "wtorch"]
    assert waits and all(s["parent_id"] is None or s["trace_id"] in
                         {r["trace_id"] for r in roots.values()} for s in waits)


def test_an_untraced_job_ships_the_reference_wire():
    """Tracing off: every message and push header the port's nodes encode
    in the job and in a serving request carries no trace context and is,
    masked at equal length, one of the tree's before tracing was ported
    (the golden list of ``_torch_wire_golden``); each push header and each
    message with a trace field has the JAX package's bytes."""
    jtrace._reset_for_tests()
    ttrace._reset_for_tests()
    rec = record()
    golden = json.loads(GOLDEN.read_text())
    assert set(rec["wire"]) == set(golden)
    for key, wires in golden.items():
        assert rec["wire"][key] == wires, key
    assert {"header", "GenerateRequest", "GenerateResponse", "Progress:updated",
            "ProgressResponse:done"} <= set(golden)
    traced_kinds = set()
    for obj, wire in rec["sent"]:
        if isinstance(obj, dict):  # a push header
            assert tmsg.TRACEPARENT_KEY not in obj
            assert jmsg.encode(obj) == wire
            continue
        assert getattr(obj, "traceparent", None) is None
        if hasattr(obj, "traceparent"):
            traced_kinds.add(type(obj).__name__)
            assert jmsg.encode(jmsg.decode(wire)) == wire, type(obj).__name__
    assert traced_kinds == {"Progress", "ProgressResponse", "GenerateRequest"}
    assert ttrace.active() is None


# --------------------------------------------------------------- serving

SPEC_POOL = dict(max_batch=4, max_new_tokens=16, pool_block_size=8, pool_ragged=True, route=True)


@pytest.mark.parametrize("router", ["jax", "port"], ids=["jax-router", "port-router"])
def test_a_traced_request_crosses_the_packages(tmp_path, traced, router):
    """The router's ``route`` span, the worker's ``serve`` span and its
    pool's ``prefill`` and ``decode`` spans share one trace per request:
    a JAX router in front of a torch worker, and the port's router in
    front of a JAX worker."""
    _, variables, _ = tiny_pair("llama", seed=11)
    wpath = tmp_path / "tiny.safetensors"
    save_file(flatten_tree(variables), str(wpath))
    spec = {"family": "llama", "preset": "tiny", "config": {"dtype": "float32"},
            "weights": str(wpath), "serve_dtype": "float32"}
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8]]
    root = Path(tempfile.mkdtemp(prefix="ts"))

    async def main():
        gw = Gateway(TcpTransport(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        started, stops = [], []
        if router == "jax":
            worker = WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                                device="cpu", peer_id="wtorch", bootstrap=boot, work_root=root)
            await worker.start(LISTEN)
            started.append(worker)
            sched = JNode(JTcp(), peer_id="jsched", bootstrap=boot)
            await sched.start(LISTEN)
            started.append(sched)
            await sched.wait_for_bootstrap()
            sup = JSupervisor(sched, spec, "mix", resources=JResources(gpu=1.0, memory=100.0),
                              **SPEC_POOL)
        else:
            jnode = JNode(JTcp(), peer_id="wjax", bootstrap=boot)
            await jnode.start(LISTEN)
            await jnode.wait_for_bootstrap()
            lm = JLeaseManager(JStaticResources(JResources(gpu=2, cpu=8, memory=1000)))
            jm = JJobManager(jnode, {("infer", INFER_EXECUTOR_NAME): JInfer(jnode)})
            arb = JArbiter(jnode, lm, jm, offer=JOfferConfig(price=1.0, floor=0.0))
            await arb.start()
            stops += [arb, jnode]
            sched = Node(TcpTransport(), peer_id="tsched", bootstrap=boot)
            await sched.start(LISTEN)
            started.append(sched)
            await sched.wait_for_bootstrap()
            sup = ServingSupervisor(sched, spec, "mix", **SPEC_POOL)
        runner = asyncio.create_task(sup.run())
        client = Node(TcpTransport(), peer_id="client", bootstrap=boot)
        await client.start(LISTEN)
        await client.wait_for_bootstrap()
        try:
            for _ in range(1200):
                deps = [d for d in sup._deployments if d is not None]
                if deps and all(d.load is not None for d in deps):
                    break
                await asyncio.sleep(0.05)
            return [await generate_remote(client, "mix", [p], 6, timeout=120) for p in prompts]
        finally:
            await client.stop()
            await sup.stop()
            await asyncio.wait_for(runner, 30)
            for part in reversed(started):
                await part.stop()
            for part in stops:
                await part.stop()
            await gw.stop()

    try:
        answers = asyncio.run(asyncio.wait_for(main(), 240))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert [len(a[0]) for a in answers] == [6, 6]
    jtrace.disable()
    ttrace.disable()
    spans, _ = ttl.load_dir(traced)
    routes = [s for s in spans if s["name"] == "route"]
    assert len(routes) == len(prompts)
    worker = "wtorch" if router == "jax" else "wjax"
    for route in routes:
        mine = [s for s in spans if s["trace_id"] == route["trace_id"]]
        (serve,) = [s for s in mine if s["name"] == "serve"]
        assert serve["node"] == worker and serve["parent_id"] == route["span_id"]
        assert route["attrs"]["backend"] == worker
        names = [s["name"] for s in mine if s["parent_id"] == serve["span_id"]]
        assert names.count("decode") == 1 and names.count("prefill") >= 1, names
