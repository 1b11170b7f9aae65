"""Port parity: a LoRA DiLoCo job over the fabric, from an HF-named
``source``. Two port ``WorkerNode``s train a tiny f32 Llama's adapters in
process on the CPU (``chip_smoke.run_lora_job`` and its ``lora_probes``),
once under the port's scheduler and parameter server (``train_lora``'s
gates, ``chip_smoke.lora_problems``, with trainer checkpoints), once under
the JAX package's. Each Δθ pushed carries the names of a JAX LoRA tree's
adapters (``flatten_tree``), every merge is θ_t + u bit for bit over the
adapters, and each trainer's base stays the checkpoint's."""

from __future__ import annotations

import asyncio
import dataclasses
import shutil
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hypha_tpu import messages as jmsg
from hypha_tpu.data_node import DataNode as JDataNode
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.gateway import Gateway as JGateway
from hypha_tpu.models import Llama as JLlama
from hypha_tpu.models import LlamaConfig as JConfig
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.resources import Resources as JResources
from hypha_tpu.scheduler.job_config import DiLoCoJob, DiLoCoRounds, JobResources
from hypha_tpu.scheduler.orchestrator import Orchestrator
from hypha_tpu.worker.runtime import WorkerNode as JWorkerNode
from hypha_tpu_torch.executor.serialization import load_file
from hypha_tpu_torch.models.convert import state_to_flat
from hypha_tpu_torch.network import TcpTransport
from hypha_tpu_torch.resources import Resources
from hypha_tpu_torch.worker.arbiter import OfferConfig
from hypha_tpu_torch.worker.runtime import WorkerNode

SEQ, ROUNDS, STEPS = 16, 2, 3
LORA = {"rank": 4, "alpha": 8.0, "targets": ["q_proj", "k_proj", "v_proj", "o_proj"]}
MODEL = {"model_type": "causal-lm", "family": "llama", "preset": "tiny", "seed": 0,
         "config": {"dtype": "float32"}}
LISTEN = ["127.0.0.1:0"]


def _jax_adapter_names() -> list:
    """A JAX LoRA tree's adapter names, as its trainer ships them."""
    cfg = dataclasses.replace(JConfig.tiny(), dtype="float32", lora_rank=LORA["rank"],
                              lora_alpha=LORA["alpha"], lora_targets=tuple(LORA["targets"]))
    shapes = jax.eval_shape(lambda: JLlama(cfg).init(jax.random.key(0),
                                                     jnp.zeros((1, 8), jnp.int32)))
    return sorted(n for n in flatten_tree(shapes) if "_lora_" in n)


@pytest.fixture
def source(tmp_path):
    path = tmp_path / "model.safetensors"
    chip_smoke.seeded_hf_source(path, MODEL, "cpu")
    return path


def test_port_fabric_runs_the_lora_job_on_the_cpu(tmp_path, source):
    """``train_lora`` rehearsed on the CPU under the port's scheduler and
    server: gates (a)-(e), (b) against the checkpoint, (f) the fold served
    in bf16 within ``LORA_FOLD_TOL`` (measured 0.0084), and each trainer's
    checkpoint (``checkpoint_dir``) holding exactly its final adapters and
    their moments' names under the wire's names."""
    root = Path(tempfile.mkdtemp(prefix="lo"))  # bridge sockets: paths under 108 bytes
    ckpt = tmp_path / "ckpt"
    try:
        run = asyncio.run(asyncio.wait_for(chip_smoke.run_lora_job(
            root, MODEL, source, device="cpu", rounds=ROUNDS, steps=STEPS, batch=2, seq=SEQ,
            period=64, lr=3e-3, lora=LORA,
            job_options={"checkpoint_dir": str(ckpt), "checkpoint_every": 1}), 180))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    expect = chip_smoke.lora_wire_spec(MODEL, LORA)
    assert sorted(expect) == _jax_adapter_names()
    lrec = run["lora"]
    problems = chip_smoke.lora_problems(run, rounds=ROUNDS, steps=STEPS, layers=2, lora=LORA,
                                        expect=expect, device="cpu")
    assert problems == [], problems
    assert chip_smoke.base_matches_checkpoint(lrec["models"], source) == []
    pushed = lrec["pushed"]
    assert len(pushed) == ROUNDS * 2 and all(p["names"] == sorted(expect) for p in pushed)
    assert {m["peer"] for m in lrec["merges"]} == {"w0", "w1"}
    for peer, model in lrec["models"].items():
        adapters = {n: p for n, p in model.state_dict().items() if "_lora_" in n}
        version = ckpt / peer / (ckpt / peer / "LATEST").read_text().strip()
        saved = load_file(version / "params.safetensors")
        want = state_to_flat(model, adapters)
        assert set(saved) == set(want)
        for name, t in want.items():
            assert torch.equal(saved[name], t.contiguous()), (peer, name)
        opt = load_file(version / "opt_state.safetensors")
        assert set(opt) == {"count"} | {f"{k}/{n}" for k in ("mu", "nu") for n in want}
    fold = chip_smoke.lora_fold_check(lrec["models"]["w0"], MODEL, tmp_path, "cpu")
    assert fold["fold_gap"] <= chip_smoke.LORA_FOLD_TOL, fold
    assert [len(t) for t in fold["tokens"]] == chip_smoke.LORA_NEW


def test_jax_scheduler_and_server_run_the_lora_job(tmp_path, source):
    """The same job as the JAX package's ``DiLoCoJob`` under its
    scheduler, gateway, data node and parameter server, on the two port
    trainers: every round closes with finite losses, every push carries
    exactly the JAX LoRA tree's adapter names, every update the JAX server
    broadcast names the adapters and merges as θ_t + u bit for bit, and
    the bases stay the checkpoint's."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    chip_smoke.write_slices(data_dir, n_slices=2, per_slice=ROUNDS * STEPS * 2, seq=SEQ,
                            period=64, seed=5)
    model = {**MODEL, "source": jmsg.to_json_dict(jmsg.Fetch(jmsg.Reference.from_uri(
        source.as_uri())))}
    job = DiLoCoJob(
        model=model, dataset="counting",
        rounds=DiLoCoRounds(update_rounds=ROUNDS, avg_samples_between_updates=2 * STEPS * 2,
                            max_batch_size=2),
        inner_optimizer=jmsg.Adam(lr=3e-3), outer_optimizer=jmsg.Nesterov(lr=0.7, momentum=0.9),
        resources=JobResources(
            num_workers=2, worker=JResources(gpu=1.0, cpu=1.0, memory=10),
            parameter_server=JResources(cpu=1.0, memory=10),
            worker_price=jmsg.PriceRange(bid=1.0, max=10.0),
            parameter_server_price=jmsg.PriceRange(bid=1.0, max=10.0)),
        lora=dict(LORA))
    root = Path(tempfile.mkdtemp(prefix="lj"))

    async def main():
        gw = JGateway(JTcp(), peer_id="gw")
        await gw.start(LISTEN)
        boot = [gw.node.listen_addrs[0]]
        parts = [JDataNode(JTcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot),
                 *[WorkerNode(TcpTransport(), resources=Resources(gpu=1, cpu=8, memory=1000),
                              device="cpu", peer_id=f"w{i}", train_runtime="in-process",
                              offer=OfferConfig(strategy="whole"), bootstrap=boot,
                              work_root=root / f"w{i}") for i in range(2)],
                 JWorkerNode(JTcp(), resources=JResources(cpu=2, memory=200), peer_id="psw",
                             bootstrap=boot, work_root=root / "psw")]
        sched = JNode(JTcp(), peer_id="sched", bootstrap=boot)
        started = []
        try:
            for part in (*parts, sched):
                await part.start(LISTEN)
                started.append(part)
            await sched.wait_for_bootstrap()
            return await Orchestrator(sched).run(job, auction_timeout=1.5)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    try:
        with chip_smoke.lora_probes(root) as lrec:
            result = asyncio.run(asyncio.wait_for(main(), 180))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == ROUNDS
    losses = {(w, r): m.get("loss") for w, r, m in result.metrics}
    assert set(losses) == {(w, r) for w in ("w0", "w1") for r in range(ROUNDS)}, losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    names = _jax_adapter_names()
    assert len(lrec["pushed"]) == 2 * ROUNDS
    assert all(p["names"] == names for p in lrec["pushed"])
    adapters = {chip_smoke._torch_name(n) for n in names}
    merges = lrec["merges"]
    assert sorted(m["peer"] for m in merges) == ["w0"] * ROUNDS + ["w1"] * ROUNDS
    assert all(set(m["names"]) == adapters and not m["bad"] for m in merges), merges
    assert chip_smoke.base_matches_checkpoint(lrec["models"], source) == []
