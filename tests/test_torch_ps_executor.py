"""Port parity: the parameter-server executor over the fabric.

The same Δθ files, pushed by two workers over real push streams (each
package's ``Node`` on its own ``TcpTransport``), reach a JAX
``ParameterServerExecutor`` (its numpy outer step: ``native._load``
patched to None, as ``tests/test_torch_ps.py`` does) and the port's
(``device="cpu"``). Over two rounds, the broadcast updates the workers
receive are bit-equal, and so are the ``UPDATED`` notifications the
scheduler gets — also when a worker re-sends its delta mid-round (the
earlier one is un-folded). The options the port does not run raise
``NotImplementedError`` naming their ROADMAP.md labels, a tree-reduce
partial fails the job under its label, and the executors refuse to start
without CUDA unless given ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from hypha_tpu import compress as jcompress
from hypha_tpu import messages as jmsg
from hypha_tpu import native
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.worker.ps_executor import ParameterServerExecutor as JPS
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.network import Node as TNode
from hypha_tpu_torch.network import TcpTransport as TTcp
from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as TPS
from hypha_tpu_torch.worker.train_executor import InProcessTrainExecutor

PKG = {"jax": (jmsg, JNode, JTcp, JPS), "port": (tmsg, TNode, TTcp, TPS)}
SHAPES = {"params/embed_tokens": (96, 16), "params/layers_0/self_attn/q_proj/kernel": (16, 16),
          "params/norm/weight": (16,), "params/layers_0/mlp/down_proj/kernel": (3, 5, 7)}
ROUNDS, WORKERS = 2, ("w0", "w1")
SAMPLES = {"w0": 6.0, "w1": 10.0}


def _deltas(root: Path, codec: str = "none") -> dict:
    """(worker, round) -> Δθ file; w1's round-1 delta in bf16, and an extra
    first delta of w0 in round 0 that its re-send replaces. With an int8 or
    int4 ``codec`` the others are the JAX trainer's HQD1 frames."""
    rng = np.random.default_rng(4)
    files = {}
    for key in [(w, r) for r in range(ROUNDS) for w in WORKERS] + [("w0", "stale")]:
        tree = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-4, 0)).astype(np.float32)
                for k, s in SHAPES.items()}
        path = root / f"delta-{key[0]}-{key[1]}.safetensors"
        if key == ("w1", 1):
            save_file({k: v.astype(ml_dtypes.bfloat16) for k, v in tree.items()}, str(path))
        elif codec in ("int8", "int4"):
            jcompress.write_delta(path, tree, codec)
        else:
            save_file(tree, str(path))
        files[key] = path
    return files


def _aggregate(m, **over):
    return m.JobSpec(job_id="agg", executor=m.Executor(
        kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
            updates=m.Receive(m.Reference.from_peers(list(WORKERS), "updates")),
            results=m.Send(m.Reference.from_peers(list(WORKERS), "results")),
            optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=len(WORKERS), **over)))


async def _serve(pkg: str, root: Path, files: dict, resend: bool, codec: str = "none") -> tuple:
    """One package's parameter server fed by two workers; returns the
    broadcasts each worker saved and the scheduler's UPDATED rounds."""
    m, Node, Tcp, PS = PKG[pkg]
    nodes = {p: Node(Tcp(), peer_id=p) for p in ("ps", "sched", *WORKERS)}
    for n in nodes.values():
        await n.start(["127.0.0.1:0"])
    for x in nodes.values():
        for y in nodes.values():
            if x is not y:
                x.add_peer_addr(y.peer_id, y.listen_addrs[0])
    updated: list = []

    async def on_progress(peer, p):
        updated.append((peer, p.kind.value, p.round, p.job_id))
        last = p.round >= ROUNDS - 1
        return m.ProgressResponse(kind=m.ProgressResponseKind.DONE if last else m.ProgressResponseKind.OK)

    nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
    ps = PS(nodes["ps"], root / "ps", **({"device": "cpu"} if pkg == "port" else {}))
    execution = await ps.execute("agg", _aggregate(m, delta_codec=codec), "sched")
    consumers = {w: nodes[w].consume_pushes(lambda push: push.resource.get("resource") == "results")
                 for w in WORKERS}
    got: dict = {}
    for r in range(ROUNDS):
        sends = [(w, files[(w, r)]) for w in WORKERS]
        if resend and r == 0:
            sends.insert(0, ("w0", files[("w0", "stale")]))
        for w, path in sends:
            header = {"num_samples": SAMPLES[w], "round": r, "resource": "updates", "name": path.name}
            await nodes[w].push("ps", header, path)
        for w in WORKERS:
            push = await consumers[w].next(timeout=30)
            assert push.peer == "ps" and push.resource["round"] == r
            dest = root / f"{pkg}-{w}-{r}.safetensors"
            await push.save_to(dest)
            got[(w, r)] = (jcompress.read_delta(dest), dest.read_bytes())
    status = await asyncio.wait_for(execution.wait(), 30)
    for n in nodes.values():
        await n.stop()
    return got, updated, status


@pytest.mark.parametrize("resend,codec", [
    (False, "none"), (True, "none"), (False, "int8"), (True, "int4"), (False, "bf16"),
], ids=["plain", "resend", "int8", "resend-int4", "bf16"])
def test_broadcast_updates_are_bit_equal(tmp_path, monkeypatch, resend, codec):
    monkeypatch.setattr(native, "_load", lambda: None)
    files = _deltas(tmp_path, codec)
    out = {}
    for pkg in PKG:
        (tmp_path / pkg).mkdir()
        out[pkg] = asyncio.run(asyncio.wait_for(
            _serve(pkg, tmp_path / pkg, files, resend, codec), 60))
    (jax_got, jax_updated, jax_status), (port_got, port_updated, port_status) = out["jax"], out["port"]
    assert jax_status.state == port_status.state == "completed"
    assert port_updated == jax_updated == [("ps", "updated", r, "agg") for r in range(ROUNDS)]
    assert set(port_got) == set(jax_got) == {(w, r) for w in WORKERS for r in range(ROUNDS)}
    wire_dtype = ml_dtypes.bfloat16 if codec == "bf16" else np.float32
    for key, (want, want_bytes) in jax_got.items():
        got, got_bytes = port_got[key]
        assert set(got) == set(want) == set(SHAPES)
        for name in SHAPES:
            assert got[name].dtype == want[name].dtype == wire_dtype, (key, name)
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{key} {name}")
        if codec in ("int8", "int4"):  # the same HQD1 frame, residual included
            assert got_bytes == want_bytes, key
    # Both workers got the same update, and it moved between the rounds.
    port_got = {k: v[0] for k, v in port_got.items()}
    assert all(np.array_equal(port_got[("w0", r)][n], port_got[("w1", r)][n])
               for r in range(ROUNDS) for n in SHAPES)
    assert not np.array_equal(port_got[("w0", 0)]["params/norm/weight"],
                              port_got[("w0", 1)]["params/norm/weight"])


@pytest.mark.parametrize("option,value,label", [
    ("checkpoint_dir", "/ckpt", "checkpoint resume"),
    ("quorum_fraction", 0.5, "sharded PS/FT/rejoin"),
    ("num_ps_shards", 2, "sharded PS/FT/rejoin"),
    ("adaptive_steps", True, "sharded PS/FT/rejoin"),
    ("adaptive_codec", True, "sharded PS/FT/rejoin"),
    ("broadcast_tree", tmsg.ShardMap(shards=["ps"]), "sharded PS/FT/rejoin"),
    ("adopt_grace_s", 5.0, "sharded PS/FT/rejoin"),
    ("report_metrics_s", 1.0, "telemetry"),
    ("serve_peers", ["server"], "live weight swap"),
])
def test_unported_options_raise_with_their_labels(tmp_path, option, value, label):
    ps = TPS(None, tmp_path, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{option}.*ROADMAP.md, Queue 1: {label}"):
        asyncio.run(ps.execute("agg", _aggregate(tmsg, **{option: value}), "sched"))
    assert not list(tmp_path.iterdir())  # refused before anything was made


def test_a_tree_reduce_partial_fails_the_job(tmp_path):
    async def main():
        nodes = {p: TNode(TTcp(), peer_id=p) for p in ("ps", "w0")}
        for n in nodes.values():
            await n.start(["127.0.0.1:0"])
        nodes["w0"].add_peer_addr("ps", nodes["ps"].listen_addrs[0])
        execution = await TPS(nodes["ps"], tmp_path, device="cpu").execute(
            "agg", _aggregate(tmsg), "sched")
        header = {"resource": "updates", "name": "p", "round": 0, "prefold": True, "covers": ["w1"]}
        await nodes["w0"].push("ps", header, b"partial")
        status = await asyncio.wait_for(execution.wait(), 10)
        for n in nodes.values():
            await n.stop()
        return status

    status = asyncio.run(main())
    assert status.state == "failed" and "sharded PS/FT/rejoin" in status.message


def test_executors_need_cuda_or_an_explicit_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: TPS(None, tmp_path, **kw),
                 lambda **kw: InProcessTrainExecutor(None, tmp_path, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert make(device="cpu").device == torch.device("cpu")
