"""Port parity: the broadcast tree (``hypha_tpu_torch/stream/reduce.py``
``relay_tag``, ``tree_broadcast``, ``BroadcastRelay``; the parameter
server's tree branch; the orchestrator's relay roles) against the JAX
package's (the cases of ``tests/test_scale.py:155-300`` and ``:725-840``).

The relay and the server's fan-out run on real push streams: each
package's ``Node`` on its own ``TcpTransport`` at 127.0.0.1 (the two
packages speak one wire), so a JAX server can push through a torch relay
to JAX and torch leaves, and a torch server through a JAX relay. Every
leaf's file is byte-equal to the server's wire, its header the server's
but for the tag. The plans (tree fields on the wire, job validation,
``_plan_streams`` roles and allowlists) are compared as encoded bytes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import types

import numpy as np
import pytest
from safetensors.numpy import save_file

from hypha_tpu import messages as jmsg
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.scheduler import job_config as jjob
from hypha_tpu.scheduler import orchestrator as jorch
from hypha_tpu.stream import reduce as jreduce
from hypha_tpu.stream import top_targets as j_top_targets
from hypha_tpu.worker.ps_executor import ParameterServerExecutor as JPS
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.network import Node as TNode
from hypha_tpu_torch.network import TcpTransport as TTcp
from hypha_tpu_torch.scheduler import job_config as tjob
from hypha_tpu_torch.scheduler import orchestrator as torch_orch
from hypha_tpu_torch.stream import reduce as treduce
from hypha_tpu_torch.stream import top_targets as t_top_targets
from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as TPS

PKG = {
    "jax": types.SimpleNamespace(m=jmsg, Node=JNode, Tcp=JTcp, reduce=jreduce, PS=JPS,
                                 job=jjob, orch=jorch, top=j_top_targets),
    "port": types.SimpleNamespace(m=tmsg, Node=TNode, Tcp=TTcp, reduce=treduce, PS=TPS,
                                  job=tjob, orch=torch_orch, top=t_top_targets),
}


def _run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _mesh(pkgs: dict) -> dict:
    """peer id -> a started node of the named package, every node knowing
    every other's address."""
    nodes = {p: PKG[k].Node(PKG[k].Tcp(), peer_id=p) for p, k in pkgs.items()}
    for n in nodes.values():
        await n.start(["127.0.0.1:0"])
    for a in nodes.values():
        for b in nodes.values():
            if a is not b:
                a.add_peer_addr(b.peer_id, b.listen_addrs[0])
    return nodes


def _wire(path, seed: int = 0):
    rng = np.random.default_rng(seed)
    save_file({"w": rng.standard_normal(4096).astype(np.float32),
               "b": rng.standard_normal((3, 5)).astype(np.float32)}, str(path))
    return path


def _relay_cfg(pkg: str, groups, serve=None):
    m = PKG[pkg].m
    return types.SimpleNamespace(
        ps_shards=m.ShardMap(round=0, shards=["ps0"], tags=["u.s0"], fragments=1,
                             groups=[list(g) for g in groups], serve_leaves=serve),
        results=m.Receive(m.Reference.from_peers(["ps0"], "results")),
        reduce_members=[], reduce_via=None)


async def _drain(nodes: dict, peers, tmp_path, tag: str) -> dict:
    got = {}
    for peer in peers:
        push = await nodes[peer].next_push(timeout=20)
        dest = tmp_path / f"{tag}-got-{peer}"
        await push.save_to(dest)
        got[peer] = (push.peer, dict(push.resource), dest.read_bytes())
    return got


# Who runs which node: the relay r fans out to a and b (and a serve leaf
# s when the placement attaches one), and injects its own copy.
MESHES = {
    "port": {"ps0": "port", "r": "port", "a": "port", "b": "port"},
    "jax": {"ps0": "jax", "r": "jax", "a": "jax", "b": "jax"},
    "jax server, torch relay": {"ps0": "jax", "r": "port", "a": "jax", "b": "port"},
    "torch server, jax relay": {"ps0": "port", "r": "jax", "a": "port", "b": "jax"},
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_relay_fans_out_and_injects_locally(tmp_path, mesh):
    """A relay re-pushes the wire to its children under the plain results
    tag and hands its own node a copy with the original sender, header
    verbatim; every file byte-equal to the wire, in either package."""
    pkgs = MESHES[mesh]

    async def main():
        nodes = await _mesh(pkgs)
        relay = PKG[pkgs["r"]].reduce.BroadcastRelay(
            nodes["r"], _relay_cfg(pkgs["r"], [["r", "a", "b"]]), work_dir=tmp_path / "relay")
        relay.start()
        wire = _wire(tmp_path / "wire.st")
        header = {"resource": treduce.relay_tag("results"), "name": wire.name, "round": 3,
                  "epoch": 7, "ps_generation": 2}
        await nodes["ps0"].push("r", header, wire)
        got = await _drain(nodes, ("a", "b", "r"), tmp_path, "x")
        await relay.stop()
        for n in nodes.values():
            await n.stop()
        return got, relay.relayed, wire.read_bytes()

    got, relayed, wire = _run(main())
    assert relayed == 1
    assert treduce.relay_tag("results") == jreduce.relay_tag("results") == "results.relay"
    for peer, sender in (("a", "r"), ("b", "r"), ("r", "ps0")):
        frm, meta, data = got[peer]
        assert frm == sender and data == wire
        assert meta == {"resource": "results", "name": "wire.st", "round": 3, "epoch": 7,
                        "ps_generation": 2}


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_relay_hangs_serve_leaves_off_its_group(tmp_path, pkg):
    """A placement's serve leaves become the relay's children (round robin
    over sorted heads), never reduce members: the follower gets the wire
    from the relay, tagged as a leaf."""
    pkgs = {"ps0": "jax", "r": pkg, "a": "port", "s": "jax" if pkg == "port" else "port"}

    async def main():
        nodes = await _mesh(pkgs)
        relay = PKG[pkg].reduce.BroadcastRelay(
            nodes["r"], _relay_cfg(pkg, [["r", "a"]], serve=["s"]), work_dir=tmp_path / "relay")
        relay.start()
        wire = _wire(tmp_path / "wire.st", 1)
        await nodes["ps0"].push("r", {"resource": "results.relay", "name": "u", "round": 1}, wire)
        got = await _drain(nodes, ("a", "s", "r"), tmp_path, "y")
        children, groups = list(relay.children), relay.groups
        await relay.stop()
        for n in nodes.values():
            await n.stop()
        return got, children, groups, wire.read_bytes()

    got, children, groups, wire = _run(main())
    assert children == ["a", "s"] and groups == [["r", "a"]]
    assert got["s"][0] == "r" and got["s"][1]["resource"] == "results" and got["s"][2] == wire


def test_tree_broadcast_expands_around_dead_relay(tmp_path):
    """A target relay that cannot be reached is expanded to its children
    in both packages: the subtree still gets the round's wire, the same
    counts and headers."""
    groups = [["r2", "c", "r1"], ["r1", "a", "b"]]
    out = {}
    for pkg in PKG:
        async def main(pkg=pkg):
            # r1 is never started: every dial to it fails.
            nodes = await _mesh({p: pkg for p in ("ps0", "r2", "a", "b", "c")})
            nodes["ps0"].add_peer_addr("r1", "127.0.0.1:9")
            wire = _wire(tmp_path / f"{pkg}.st", 2)
            delivered, lost = await PKG[pkg].reduce.tree_broadcast(
                nodes["ps0"], {"resource": "results", "name": wire.name, "round": 1}, "results",
                groups, ["r1"], wire, attempts=1)
            got = await _drain(nodes, ("a", "b"), tmp_path, pkg)
            for n in nodes.values():
                await n.stop()
            return delivered, lost, {p: (g[0], g[1]["resource"], g[1]["round"], g[2] == wire.read_bytes())
                                     for p, g in got.items()}

        out[pkg] = _run(main())
    assert out["port"] == out["jax"] == (2, 0, {"a": ("ps0", "results", 1, True),
                                               "b": ("ps0", "results", 1, True)})


def test_top_targets_skips_dead_ancestors():
    groups = [["r2", "c", "r1"], ["r1", "a", "b"]]
    for live in (["a", "b", "c", "r1", "r2"], ["a", "b", "c", "r1"], ["a", "b", "c"],
                 ["b", "r2", "s"], []):
        assert t_top_targets(groups, live) == j_top_targets(groups, live)
    assert t_top_targets(groups, ["a", "b", "c", "r1"]) == ["c", "r1"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ps_broadcast_uses_tree_targets(tmp_path, mesh):
    """The server's ``_broadcast`` under ``broadcast_tree`` pushes to the
    top targets only (the relay, under the relay tag); the leaves, a serve
    follower among them, get theirs from the relay, byte-equal."""
    pkgs = {**MESHES[mesh], "s": MESHES[mesh]["a"]}

    async def main():
        nodes = await _mesh(pkgs)
        rp, sp = PKG[pkgs["r"]], PKG[pkgs["ps0"]]
        smap = {k: PKG[k].m.ShardMap(round=0, shards=["ps0"], tags=["u.s0"], fragments=1,
                                     groups=[["r", "a", "b"]], serve_leaves=["s"])
                for k in PKG}
        relay = rp.reduce.BroadcastRelay(
            nodes["r"], types.SimpleNamespace(
                ps_shards=smap[pkgs["r"]],
                results=rp.m.Receive(rp.m.Reference.from_peers(["ps0", "r"], "results"))),
            work_dir=tmp_path / "relay")
        relay.start()
        ps = sp.PS(nodes["ps0"], tmp_path / "ps", **({"device": "cpu"} if pkgs["ps0"] == "port"
                                                     else {}))
        cfg = types.SimpleNamespace(
            results=sp.m.Send(sp.m.Reference.from_peers(["r", "a", "b"], "results")),
            broadcast_tree=smap[pkgs["ps0"]], serve_peers=["s"])
        wire = _wire(tmp_path / "update.st", 3)
        before = nodes["ps0"].bytes_out
        await ps._broadcast(cfg, wire, 5)
        egress = nodes["ps0"].bytes_out - before
        got = await _drain(nodes, ("a", "b", "s", "r"), tmp_path, "z")
        await relay.stop()
        for n in nodes.values():
            await n.stop()
        return egress, got, wire.read_bytes()

    egress, got, wire = _run(main())
    assert egress < 2 * len(wire)  # one wire left the server
    for peer in ("a", "b", "s"):
        assert got[peer][0] == "r" and got[peer][1]["round"] == 5 and got[peer][2] == wire
    assert got["r"][0] == "ps0" and got["r"][1]["resource"] == "results" and got["r"][2] == wire


def test_tree_fields_absent_by_default_on_wire():
    """Unset tree fields ship the pre-tree bytes in both packages, and set
    ones encode alike and round-trip."""
    enc = {}
    for k, p in PKG.items():
        m = p.m
        smap = m.ShardMap(round=0, shards=["ps0"], tags=["u"], fragments=2, groups=[["r", "a"]])
        train = m.TrainExecutorConfig(
            model={"family": "gpt2"}, data=m.Fetch(m.Reference.from_uri("file:///d")),
            updates=m.Send(m.Reference.from_peers(["ps"], "updates")),
            results=m.Receive(m.Reference.from_peers(["ps"], "results")),
            optimizer=m.Adam(), batch_size=4, ps_shards=smap, reduce_members=["a"])
        agg = m.AggregateExecutorConfig(
            updates=m.Receive(m.Reference.from_peers(["w"], "updates")),
            results=m.Send(m.Reference.from_peers(["w"], "results")), optimizer=m.Nesterov())
        plain = [m.encode(smap), m.encode(train), m.encode(agg)]
        for b, name in zip(plain, (b"tree_depth", b"relay_results", b"broadcast_tree")):
            assert name not in b and b"serve_leaves" not in b and b"serve_peers" not in b
        smap2 = dataclasses.replace(smap, tree_depth=2, serve_leaves=["s0"])
        set_ = [m.encode(smap2), m.encode(dataclasses.replace(train, relay_results=True)),
                m.encode(dataclasses.replace(agg, broadcast_tree=smap2, serve_peers=["s0"]))]
        enc[k] = plain + set_
    assert enc["port"] == enc["jax"]
    back = tmsg.decode(enc["jax"][5])
    assert back.broadcast_tree.serve_leaves == ["s0"] and back.serve_peers == ["s0"]
    assert tmsg.decode(enc["jax"][4]).relay_results is True


@pytest.mark.parametrize("kw,error", [
    ({"reduce_group_size": 4, "reduce_tree_depth": 2}, None),
    ({"reduce_group_size": 4, "broadcast_tree": True}, None),
    ({"reduce_group_size": 2, "broadcast_tree": True, "serve_peers": ["s"]}, None),
    ({"reduce_tree_depth": 2}, "reduce_group_size >= 2"),
    ({"broadcast_tree": True}, "reduce_group_size >= 2"),
    ({"reduce_group_size": 4, "reduce_tree_depth": -1}, "reduce_tree_depth"),
    ({"reduce_group_size": 4, "broadcast_tree": True, "adaptive_codec": True}, "adaptive_codec"),
])
def test_job_config_tree_validation(kw, error):
    """The reference's validation, texts included; a valid tree job
    encodes to the reference's bytes."""
    if error is None:
        jobs = {k: p.m.encode(p.job.DiLoCoJob(model={"family": "gpt2"}, dataset="d", **kw))
                for k, p in PKG.items()}
        assert jobs["port"] == jobs["jax"]
        return
    for p in PKG.values():
        with pytest.raises(ValueError, match=error):
            p.job.DiLoCoJob(model={"family": "gpt2"}, dataset="d", **kw)


def _planned(k: str, **over):
    """Both orchestrators' ``_plan_streams`` and ``_train_spec`` for nine
    workers in groups of 3, two levels deep, with the broadcast tree."""
    p = PKG[k]
    from hypha_tpu.messages import PriceRange as JPrice
    from hypha_tpu.resources import Resources as JRes
    from hypha_tpu_torch.messages import PriceRange as TPrice
    from hypha_tpu_torch.resources import Resources as TRes

    Res, Price = (JRes, JPrice) if k == "jax" else (TRes, TPrice)
    job = p.job.DiLoCoJob(
        model={"family": "gpt2"}, dataset="d",
        rounds=p.job.DiLoCoRounds(update_rounds=2, avg_samples_between_updates=8),
        inner_optimizer=p.m.Adam(), outer_optimizer=p.m.Nesterov(),
        resources=p.job.JobResources(
            num_workers=9, worker=Res(cpu=1), parameter_server=Res(cpu=1),
            worker_price=Price(bid=1.0, max=2.0), parameter_server_price=Price(bid=1.0, max=2.0)),
        reduce_group_size=3, reduce_tree_depth=2, broadcast_tree=True, **over)
    orch = p.orch.Orchestrator.__new__(p.orch.Orchestrator)
    orch.node = types.SimpleNamespace(peer_id="sched")
    ctx = p.orch._RunContext()
    ctx.job, ctx.base_id = job, "base"
    ctx.ps_handles = [types.SimpleNamespace(peer_id="ps0")]
    workers = [f"w{i}" for i in range(9)]
    orch._plan_streams(ctx, job, workers, ["ps0"], 1, 1)
    specs = {w: orch._train_spec(ctx, "wX", types.SimpleNamespace(
        peer_id=w, batch_size=2, lease_id="l")) for w in workers}
    return ctx, specs


@pytest.mark.parametrize("serve", [False, True], ids=["train only", "serve peers"])
def test_plan_streams_builds_tree_and_relay_roles(serve):
    """Depth-2 groups in the placement, relay flags on the reducers only,
    each worker's ancestor chain in its results allowlist, the placement
    (with the serve leaves) in the aggregate spec: every spec byte-equal
    to the reference's."""
    over = {"serve_peers": ["sv1", "sv0"]} if serve else {}
    (jctx, jspecs), (tctx, tspecs) = _planned("jax", **over), _planned("port", **over)
    assert tmsg.encode(tctx.ps_specs[0]) == jmsg.encode(jctx.ps_specs[0])
    for w in jspecs:
        assert tmsg.encode(tspecs[w]) == jmsg.encode(jspecs[w]), w
    agg = tctx.ps_specs[0].executor.aggregate
    assert agg.broadcast_tree == tctx.shard_map and tctx.shard_map.tree_depth == 2
    assert agg.serve_peers == (["sv1", "sv0"] if serve else None)
    assert tctx.shard_map.serve_leaves == (["sv1", "sv0"] if serve else None)
    top, mid, leaf = (tspecs[w].executor.train for w in ("w0", "w3", "w5"))
    assert top.relay_results is True and top.reduce_via is None
    assert set(top.reduce_members) == {"w1", "w2", "w3", "w6"}
    assert mid.relay_results is True and mid.reduce_via == "w0"
    assert leaf.relay_results is None and leaf.reduce_via == "w3"
    assert leaf.results.ref.peers == ["ps0", "w3", "w0"] and top.results.ref.peers == ["ps0"]
