"""Port parity: the parameter-server executor over the fabric.

The same Δθ files, pushed by two workers over real push streams (each
package's ``Node`` on its own ``TcpTransport``), reach a JAX
``ParameterServerExecutor`` (its numpy outer step: ``native._load``
patched to None, as ``tests/test_torch_ps.py`` does) and the port's
(``device="cpu"``). Over two rounds, the broadcast updates the workers
receive are bit-equal, and so are the ``UPDATED`` notifications the
scheduler gets — also when a worker re-sends its delta mid-round (the
earlier one is un-folded), and so they are for a stream, an elastic and a
sharded durable server, and for an elastic durable round closed by a
tree-reduce partial; and with the adaptive options (arrival lags in
``UPDATED``, per-link codecs and residuals). The options the port does not run raise
``NotImplementedError`` naming their ROADMAP.md labels, and the executors
refuse to start without CUDA unless given ``device="cpu"``.
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
from hypha_tpu_torch.compress import frame_header
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


async def _serve(pkg: str, root: Path, files: dict, resend: bool, codec: str = "none",
                 seen: "dict | None" = None, **options) -> tuple:
    """One package's parameter server fed by two workers; returns the
    broadcasts each worker saved and the scheduler's UPDATED rounds.
    ``seen`` (when given) takes each broadcast's push header under its
    (worker, round) and each UPDATED's metrics under its round."""
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
        if seen is not None:
            seen[p.round] = dict(p.metrics)
        last = p.round >= ROUNDS - 1
        return m.ProgressResponse(kind=m.ProgressResponseKind.DONE if last else m.ProgressResponseKind.OK)

    nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
    ps = PS(nodes["ps"], root / "ps", **({"device": "cpu"} if pkg == "port" else {}))
    execution = await ps.execute("agg", _aggregate(m, delta_codec=codec, **options), "sched")
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
            if seen is not None:
                seen[(w, r)] = dict(push.resource)
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


# The options the port's server does not run, each with its ROADMAP.md
# label (checkpoint_dir, quorum_fraction, num_ps_shards, broadcast_tree and
# serve_peers run: below).
@pytest.mark.parametrize("option,value,label", [
    ("adopt_grace_s", 5.0, "scheduler recovery"),
    ("report_metrics_s", 1.0, "telemetry"),
])
def test_unported_options_raise_with_their_labels(tmp_path, option, value, label):
    ps = TPS(None, tmp_path, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{option}.*ROADMAP.md, Queue 1: {label}"):
        asyncio.run(ps.execute("agg", _aggregate(tmsg, **{option: value}), "sched"))
    assert not list(tmp_path.iterdir())  # refused before anything was made


# The adaptive options (formerly refused): both packages' servers report
# the same peers' arrival lags with UPDATED (adaptive_steps), and with
# per-link codecs (thresholds above any link, so every measured link
# ships int4 on its own residual) send each worker the same frame bytes
# under the same codec header, over two rounds.
@pytest.mark.parametrize("option", ["adaptive_steps", "adaptive_codec"])
def test_adaptive_options_broadcast_as_the_reference(tmp_path, monkeypatch, option):
    monkeypatch.setattr(native, "_load", lambda: None)
    files = _deltas(tmp_path, "int8")
    over = ({"adaptive_steps": True} if option == "adaptive_steps" else
            {"adaptive_codec": True, "codec_bw_hi_mbps": 1e9, "codec_bw_lo_mbps": 1e9})
    out, seen = {}, {}
    for pkg in PKG:
        (tmp_path / pkg).mkdir()
        seen[pkg] = {}
        out[pkg] = asyncio.run(asyncio.wait_for(
            _serve(pkg, tmp_path / pkg, files, False, "int8", seen=seen[pkg], **over), 60))
    (jax_got, jax_updated, _), (port_got, port_updated, port_status) = out["jax"], out["port"]
    assert port_status.state == "completed" and port_updated == jax_updated
    for r in range(ROUNDS):
        metrics = {pkg: seen[pkg][r] for pkg in PKG}
        if option == "adaptive_steps":
            assert set(metrics["port"]) == set(metrics["jax"]) == {"arrival_s"}
            assert set(metrics["port"]["arrival_s"]) == set(metrics["jax"]["arrival_s"]) \
                == set(WORKERS)
        else:
            assert metrics["port"] == metrics["jax"] == {}
    for key, (want, want_bytes) in jax_got.items():
        got, got_bytes = port_got[key]
        assert got_bytes == want_bytes, key
        header = {pkg: seen[pkg][key] for pkg in PKG}
        assert header["port"] == header["jax"], key
        codec = frame_header(tmp_path / "jax" / f"jax-{key[0]}-{key[1]}.safetensors")
        assert header["port"].get("codec") == ("int4" if option == "adaptive_codec" else None)
        assert codec["codec"] == ("int4" if option == "adaptive_codec" else "int8")


# Options that used to be refused with a streaming sync mode or several
# shards: both packages' servers (a stream job of one fragment, an elastic
# one, shard 0 of 2, each durable but the elastic) broadcast the same
# update bytes over two rounds, a mid-round re-send included.
@pytest.mark.parametrize("option", ["checkpoint_dir", "quorum_fraction", "num_ps_shards"])
def test_lifted_options_broadcast_bit_equal(tmp_path, monkeypatch, option):
    monkeypatch.setattr(native, "_load", lambda: None)
    files = _deltas(tmp_path, "int8")
    out = {}
    for pkg in PKG:
        (tmp_path / pkg).mkdir()
        over = {"checkpoint_dir": str(tmp_path / pkg / "ckpt")}
        if option == "checkpoint_dir":
            over.update(sync_mode="stream", fragments=1)
        elif option == "quorum_fraction":
            over = {"sync_mode": "stream", "fragments": 1, "quorum_fraction": 0.5,
                    "round_deadline_s": 30.0}
        else:
            over.update(num_ps_shards=2, shard_index=0)
        out[pkg] = asyncio.run(asyncio.wait_for(
            _serve(pkg, tmp_path / pkg, files, True, "int8", **over), 60))
    (jax_got, jax_updated, jax_status), (port_got, port_updated, port_status) = out["jax"], out["port"]
    assert jax_status.state == port_status.state == "completed"
    assert port_updated == jax_updated == [("ps", "updated", r, "agg") for r in range(ROUNDS)]
    assert set(port_got) == set(jax_got) == {(w, r) for w in WORKERS for r in range(ROUNDS)}
    for key, (want, want_bytes) in jax_got.items():
        got, got_bytes = port_got[key]
        assert got_bytes == want_bytes, key  # the same frame, residual and tag included


async def _fan_out(pkg: str, root: Path, files: dict, **options) -> list:
    """One package's server for one round, every push it makes recorded
    by its receiver: ``(receiver, tag, round, bytes)`` in receiver order."""
    m, Node, Tcp, PS = PKG[pkg]
    names = ("ps", "sched", *WORKERS, "sv")
    nodes = {p: Node(Tcp(), peer_id=p) for p in names}
    for n in nodes.values():
        await n.start(["127.0.0.1:0"])
    for x in nodes.values():
        for y in nodes.values():
            if x is not y:
                x.add_peer_addr(y.peer_id, y.listen_addrs[0])

    async def on_progress(peer, p):
        return m.ProgressResponse(kind=m.ProgressResponseKind.DONE)

    nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
    ps = PS(nodes["ps"], root / "ps", **({"device": "cpu"} if pkg == "port" else {}))
    execution = await ps.execute("agg", _aggregate(m, **options), "sched")
    consumers = {w: nodes[w].consume_pushes(lambda push: push.resource.get("resource") != "updates")
                 for w in (*WORKERS, "sv")}
    for w in WORKERS:
        path = files[(w, 0)]
        await nodes[w].push("ps", {"num_samples": SAMPLES[w], "round": 0, "resource": "updates",
                                   "name": path.name}, path)
    await asyncio.wait_for(execution.wait(), 30)
    got = []
    for w, consumer in consumers.items():
        while True:
            try:
                push = await consumer.next(timeout=1.0)
            except (asyncio.TimeoutError, TimeoutError):
                break
            dest = root / f"{pkg}-{w}-{len(got)}.bin"
            await push.save_to(dest)
            got.append((w, push.resource["resource"], push.resource["round"], dest.read_bytes()))
    for n in nodes.values():
        await n.stop()
    return got


# Options refused until the broadcast tree and live weight swap were
# ported (the cases of the refusal test above they replace): with a tree
# both packages' servers push the round once, to the group's relay under
# the relay tag; with a serving follower, to every worker and the
# follower. Same receivers, tags and bytes.
@pytest.mark.parametrize("option", ["broadcast_tree", "serve_peers"])
def test_lifted_broadcast_options_push_as_the_reference(tmp_path, monkeypatch, option):
    monkeypatch.setattr(native, "_load", lambda: None)
    files = _deltas(tmp_path)
    out = {}
    for pkg, m in (("jax", jmsg), ("port", tmsg)):
        (tmp_path / pkg).mkdir()
        over = ({"broadcast_tree": m.ShardMap(shards=["ps"], groups=[list(WORKERS)])}
                if option == "broadcast_tree" else {"serve_peers": ["sv"]})
        out[pkg] = asyncio.run(asyncio.wait_for(_fan_out(pkg, tmp_path / pkg, files, **over), 60))
    want = ([("w0", "results.relay", 0)] if option == "broadcast_tree"
            else [("w0", "results", 0), ("w1", "results", 0), ("sv", "results", 0)])
    assert [g[:3] for g in out["port"]] == [g[:3] for g in out["jax"]] == want
    assert [g[3] for g in out["port"]] == [g[3] for g in out["jax"]]


def test_an_elastic_durable_server_folds_a_tree_reduce_partial(tmp_path, monkeypatch):
    # A reducer's partial covering w1 beside its own direct delta closes
    # an elastic, durable round of two workers, and its journal replays
    # the round: both packages broadcast the same update.
    monkeypatch.setattr(native, "_load", lambda: None)
    files = _deltas(tmp_path, "none")

    async def main(pkg):
        m, Node, Tcp, PS = PKG[pkg]
        nodes = {p: Node(Tcp(), peer_id=p) for p in ("ps", "sched", "w0")}
        for n in nodes.values():
            await n.start(["127.0.0.1:0"])
        for x in nodes.values():
            for y in nodes.values():
                if x is not y:
                    x.add_peer_addr(y.peer_id, y.listen_addrs[0])

        async def on_progress(peer, p):
            return m.ProgressResponse(kind=m.ProgressResponseKind.DONE)

        nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
        ps = PS(nodes["ps"], tmp_path / pkg / "ps", **({"device": "cpu"} if pkg == "port" else {}))
        execution = await ps.execute("agg", _aggregate(
            m, quorum_fraction=0.5, checkpoint_dir=str(tmp_path / pkg / "ckpt")), "sched")
        results = nodes["w0"].consume_pushes(lambda push: push.resource.get("resource") == "results")
        partial = {"resource": "updates", "name": "p", "round": 0, "num_samples": 10.0,
                   "prefold": True, "covers": ["w1"]}
        await nodes["w0"].push("ps", partial, files[("w1", 0)])
        direct = {"resource": "updates", "name": "d", "round": 0, "num_samples": 6.0}
        await nodes["w0"].push("ps", direct, files[("w0", 0)])
        push = await results.next(timeout=30)
        dest = tmp_path / pkg / "update.bin"
        await push.save_to(dest)
        status = await asyncio.wait_for(execution.wait(), 30)
        for n in nodes.values():
            await n.stop()
        return status, dest.read_bytes()

    jstatus, jbytes = asyncio.run(main("jax"))
    tstatus, tbytes = asyncio.run(main("port"))
    assert jstatus.state == tstatus.state == "completed"
    assert tbytes == jbytes


def test_executors_need_cuda_or_an_explicit_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: TPS(None, tmp_path, **kw),
                 lambda **kw: InProcessTrainExecutor(None, tmp_path, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert make(device="cpu").device == torch.device("cpu")
