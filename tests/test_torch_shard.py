"""Port parity: the sharded parameter service and the group tree reduce.

Every case feeds the same seeded numpy inputs through the JAX package and
the port. The JAX parameter servers run their numpy outer step
(``native._load`` patched to None, as ``tests/test_torch_ps_executor.py``
does); the port's run on the CPU (``device="cpu"``). Tolerance: bit-equal
everywhere (the reference's own tests are bit-exact in the same places).

1. The pure functions (``shard_of``, ``shard_names``, ``placement_parts``,
   ``shard_owns_round``, ``shards_due_at``, ``next_owned_round``, the tree
   plan and its walks, ``shard_route``) equal the JAX package's over an
   enumerated grid.
2. ``GroupReducer``: the same member pushes reach a JAX reducer and the
   port's; the partials the shards receive are the same (headers equal,
   f32 values bit-equal, int8 frames byte-equal with the per-part error
   feedback), also across a duplicate re-send's un-fold; the depth-2
   cumulative re-flush out of order is value-exact against the
   reference's ``RoundAccum`` replay.
3. Two port shards against two JAX shards over 2 blocking rounds:
   broadcasts bit-equal, and per tensor bit-equal to one port server over
   the whole tree; the stream shards' owned-round gating (a misrouted push
   dropped) gives the JAX shards' broadcasts and ``UPDATED`` messages.
4. The five cover-reconciliation cases through both packages'
   ``_collect_round`` (and the stream collector): the same entries, weight
   and mean bits; the port's durable server refuses a partial under its
   label.
5. Both packages' ``BatchScheduler`` with ``shards_due`` on one clock:
   every answer equal. Both orchestrators plan the same ``ShardMap``,
   tags, job ids, groups and dispatched spec bytes for one job and fleet.
6. ``run_training`` with a 2-shard placement against the unsharded run:
   routes every part to its owner and ends with bit-equal parameters.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import queue
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from hypha_tpu import compress as jcompress
from hypha_tpu import messages as jmsg
from hypha_tpu import native
from hypha_tpu import stream as jstream
from hypha_tpu.network import MemoryTransport as JMem
from hypha_tpu.network import Node as JNode
from hypha_tpu.scheduler import batch_scheduler as jbs
from hypha_tpu.scheduler import job_config as jjob
from hypha_tpu.scheduler import orchestrator as jorch
from hypha_tpu.scheduler import trackers as jtr
from hypha_tpu.stream.accum import RoundAccum as JAccum
from hypha_tpu.stream.reduce import GroupReducer as JReducer
from hypha_tpu.worker import connectors as jconn
from hypha_tpu.worker.ps_executor import ParameterServerExecutor as JPS
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch import stream as tstream
from hypha_tpu_torch.network import MemoryTransport as TMem
from hypha_tpu_torch.network import Node as TNode
from hypha_tpu_torch.scheduler import batch_scheduler as tbs
from hypha_tpu_torch.scheduler import job_config as tjob
from hypha_tpu_torch.scheduler import orchestrator as torch_orch
from hypha_tpu_torch.scheduler import trackers as ttr
from hypha_tpu_torch.stream.accum import RoundAccum as TAccum
from hypha_tpu_torch.stream.reduce import GroupReducer as TReducer
from hypha_tpu_torch.worker import connectors as tconn
from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as TPS

PKG = {
    "jax": types.SimpleNamespace(m=jmsg, Node=JNode, Mem=JMem, PS=JPS, Reducer=JReducer,
                                 Accum=JAccum, stream=jstream, conn=jconn, bs=jbs, tr=jtr,
                                 orch=jorch, job=jjob),
    "port": types.SimpleNamespace(m=tmsg, Node=TNode, Mem=TMem, PS=TPS, Reducer=TReducer,
                                  Accum=TAccum, stream=tstream, conn=tconn, bs=tbs, tr=ttr,
                                  orch=torch_orch, job=tjob),
}


def _run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _both(fn):
    """``fn(pkg)`` in each package, the results compared by the caller;
    an exception must be the same type in both."""
    out = {}
    for pkg in PKG:
        try:
            out[pkg] = ("ok", fn(PKG[pkg]))
        except (ValueError, KeyError) as e:
            out[pkg] = ("raise", type(e).__name__)
    return out


# ------------------------------------------------------------ pure functions


SIZES = {f"t{i}": (i * 7) % 13 + 1 for i in range(12)}


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
def test_placement_and_round_ownership_equal_the_reference(num_shards):
    for frags in range(1, 9):
        for f in range(frags):
            assert tstream.shard_of(f, num_shards) == jstream.shard_of(f, num_shards)
        for s in range(num_shards + 1):  # one index out of range
            out = _both(lambda p: p.stream.shard_names(SIZES, frags, num_shards, s))
            assert out["port"] == out["jax"], (frags, s)
        for mode in tstream.SYNC_MODES:
            out = _both(lambda p: p.stream.placement_parts(mode, frags, num_shards))
            assert out["port"] == out["jax"], (mode, frags)
            for r in range(17):
                out = _both(lambda p: p.stream.shards_due_at(mode, r, frags, num_shards))
                assert out["port"] == out["jax"], (mode, frags, r)
                for s in range(num_shards):
                    for fn in ("shard_owns_round", "next_owned_round"):
                        out = _both(lambda p: getattr(p.stream, fn)(mode, r, frags, num_shards, s))
                        assert out["port"] == out["jax"], (fn, mode, frags, r, s)
    for bad in ((0, 0), (-1, num_shards)):
        with pytest.raises(ValueError):
            tstream.shard_of(*bad)
        with pytest.raises(ValueError):
            jstream.shard_of(*bad)


@pytest.mark.parametrize("group_size", [2, 3, 4])
def test_tree_plan_equals_the_reference(group_size):
    rng = np.random.default_rng(group_size)
    for n in range(1, 10):
        peers = [f"w{i}" for i in rng.permutation(n)]
        for depth in (1, 2, 3):
            groups = jstream.build_reduce_groups(peers, group_size, depth)
            assert tstream.build_reduce_groups(peers, group_size, depth) == groups
            for fn in ("children_of", "parent_of", "tree_levels"):
                assert getattr(tstream, fn)(groups) == getattr(jstream, fn)(groups), fn
            for p in peers:
                assert tstream.ancestors_of(groups, p) == jstream.ancestors_of(groups, p)
                assert tstream.subtree_of(groups, p) == jstream.subtree_of(groups, p)
            for live in (peers, peers[1:], peers[::2]):
                assert tstream.top_targets(groups, live) == jstream.top_targets(groups, live)
            leaves = ["s1", "s0", peers[0]]
            assert tstream.with_serve_leaves(groups, leaves) == \
                jstream.with_serve_leaves(groups, leaves)


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_shard_route_equals_the_reference(num_shards):
    for tags in (True, False):
        maps = {k: p.m.ShardMap(round=0, shards=[f"ps{i}" for i in range(num_shards)],
                                tags=[f"u.s{i}" for i in range(num_shards)] if tags else [],
                                fragments=4) for k, p in PKG.items()}
        for part, via in itertools.product(range(6), (None, "red", "ps0")):
            j = jconn.shard_route(maps["jax"], part, via)
            t = tconn.shard_route(maps["port"], part, via)
            assert t[1:] == j[1:]
            assert tmsg.encode(t[0]) == jmsg.encode(j[0]), (part, via)
    for k, p in PKG.items():
        with pytest.raises(ValueError):
            p.conn.shard_route(p.m.ShardMap(shards=[]), 0)


# -------------------------------------------------------------- the reducer


async def _mesh(pkg, peer_ids):
    hub = pkg.Mem()
    nodes = {p: pkg.Node(hub.shared(), peer_id=p) for p in peer_ids}
    for n in nodes.values():
        await n.start()
    for a in nodes.values():
        for b in nodes.values():
            if a is not b:
                a.add_peer_addr(b.peer_id, b.listen_addrs[0])
    return nodes


def _reducer(pkg, node, members, smap, codec="none", sync_mode="stream", via=None, work=None):
    cfg = types.SimpleNamespace(ps_shards=smap, reduce_members=list(members), reduce_via=via,
                                delta_codec=codec, delta_dtype="float32", sync_mode=sync_mode)
    if pkg.Reducer is TReducer:
        return TReducer(node, cfg, work_dir=work, device="cpu")
    return JReducer(node, cfg, work_dir=work)


async def _until(pred, what, timeout=20.0):
    t0 = asyncio.get_running_loop().time()
    while not pred():
        if asyncio.get_running_loop().time() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


def _member_files(root: Path, codec: str) -> dict:
    """(member, round, tag) -> a delta file of that round's fragment (the
    fragment's two tensors), as a JAX trainer writes it."""
    rng = np.random.default_rng(11)
    shapes = {0: {"a": (6, 5), "b": (7,)}, 1: {"c": (9,), "d": (2, 3)}}
    files = {}
    for key in [("w1", 0, "x"), ("w2", 0, "x"), ("w1", 0, "dup"), ("w1", 1, "x"),
                ("w2", 1, "x")]:
        member, rnd, _ = key
        tree = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 0)).astype(np.float32)
                for k, s in shapes[rnd % 2].items()}
        path = root / f"{member}-{rnd}-{key[2]}.st"
        if codec == "none":
            save_file(tree, str(path))
        else:
            tag = jmsg.FragmentTag(round=rnd, fragment_id=rnd % 4, fragments=4).header()
            jcompress.write_delta(path, tree, codec, tag=tag)
        files[key] = path
    return files


async def _drive_reducer(pkg, root: Path, files: dict, codec: str) -> dict:
    """w1 and w2 push rounds 0 and 1 (fragments 0 and 1 of 4, owned by
    shards 0 and 1) to the reducer ``red``; w1 re-sends its round-0 delta
    after the first flush. Returns each shard's received partials."""
    nodes = await _mesh(pkg, ["red", "ps0", "ps1", "w1", "w2"])
    smap = pkg.m.ShardMap(round=0, shards=["ps0", "ps1"], tags=["u.s0", "u.s1"], fragments=4,
                          groups=[["red", "w1", "w2"]])
    red = _reducer(pkg, nodes["red"], ["w1", "w2"], smap, codec, work=root / "red")
    red.start()
    got: dict = {"ps0": [], "ps1": []}
    samples = {"w1": 6.0, "w2": 10.0}

    async def push(member, rnd, which):
        path = files[(member, rnd, which)]
        header = {"resource": f"u.s{rnd % 2}", "name": path.name, "round": rnd,
                  "num_samples": samples[member], "shard": rnd % 2,
                  **pkg.m.FragmentTag(round=rnd, fragment_id=rnd % 4, fragments=4).header()}
        await nodes[member].push("red", header, path)

    async def take(shard):
        p = await nodes[shard].next_push(timeout=20)
        dest = root / f"got-{shard}-{len(got[shard])}"
        await p.save_to(dest)
        got[shard].append((p.peer, dict(p.resource), dest.read_bytes(),
                           {k: np.asarray(v) for k, v in jcompress.read_delta(dest).items()}))

    await push("w1", 0, "x")
    await _until(lambda: red.folds >= 1, "fold 1")
    await push("w2", 0, "x")
    await take("ps0")
    await push("w1", 0, "dup")  # a re-send: un-fold, fold, re-flush
    await take("ps0")
    await push("w2", 1, "x")
    await _until(lambda: red.folds >= 4, "fold 4")
    await push("w1", 1, "x")
    await take("ps1")
    counts = (red.folds, red.unfolds, red.partials)
    await red.stop()
    for n in nodes.values():
        await n.stop()
    return {"got": got, "counts": counts}


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_group_reducer_partials_equal_the_reference(tmp_path, monkeypatch, codec):
    monkeypatch.setattr(native, "_load", lambda: None)
    files = _member_files(tmp_path, codec)
    out = {}
    for name, pkg in PKG.items():
        (tmp_path / name).mkdir()
        out[name] = _run(_drive_reducer(pkg, tmp_path / name, files, codec))
    assert out["port"]["counts"] == out["jax"]["counts"] == (5, 1, 3)
    for shard in ("ps0", "ps1"):
        jgot, tgot = out["jax"]["got"][shard], out["port"]["got"][shard]
        assert len(tgot) == len(jgot) == (2 if shard == "ps0" else 1)
        for (jp, jh, jb, jt), (tp, th, tb, tt) in zip(jgot, tgot):
            assert tp == jp == "red"
            assert th == jh
            assert th["prefold"] is True and th["covers"] == ["w1", "w2"]
            assert th["num_samples"] == 16.0 and th["shard"] == int(shard[-1])
            assert set(tt) == set(jt)
            for k in jt:
                np.testing.assert_array_equal(tt[k], jt[k], err_msg=f"{shard} {k}")
            assert tb == jb  # the same file (an int8 frame with its residual)
    # The f32 partial is Σ samples·Δ in arrival order, the duplicate's
    # un-fold included (the reference's RoundAccum replay).
    if codec == "none":
        load = {k: dict(load_file(str(v))) for k, v in files.items()}
        acc = JAccum()
        acc.fold_tree(load[("w1", 0, "x")], 6.0)
        acc.fold_tree(load[("w2", 0, "x")], 10.0)
        acc.fold_tree(load[("w1", 0, "x")], 6.0, -1.0)
        acc.fold_tree(load[("w1", 0, "dup")], 6.0)
        for k, v in acc.partial().items():
            np.testing.assert_array_equal(out["port"]["got"]["ps0"][1][3][k], v)


async def _drive_two_levels(pkg, root: Path, d: dict) -> tuple:
    """The reference's depth-2 sequence (``tests/test_shard.py:316``):
    leaves a, b -> r1 -> r2 (which also folds c and r1's own delta) ->
    ps0, with r1's deadline flush, its cumulative re-flush and a
    duplicate re-send from a."""
    nodes = await _mesh(pkg, ["ps0", "r1", "r2", "a", "b", "c"])
    groups = [["r2", "c", "r1"], ["r1", "a", "b"]]
    smap = pkg.m.ShardMap(round=0, shards=["ps0"], tags=["u.s0"], fragments=1, groups=groups,
                          tree_depth=2)
    red1 = _reducer(pkg, nodes["r1"], ["a", "b"], smap, sync_mode="blocking", via="r2",
                    work=root / "r1")
    red2 = _reducer(pkg, nodes["r2"], ["c", "r1"], smap, sync_mode="blocking", work=root / "r2")
    assert (red1.parent, red2.parent, red2.expected_cover, red2.level, red1.level) == \
        ("r2", None, {"c", "r1", "a", "b"}, 2, 1)
    red1.start()
    red2.start()

    async def push(src, dst, label):
        f = root / f"{label}.st"
        save_file(d[label], str(f))
        await nodes[src].push(dst, {"resource": "u.s0", "name": f.name, "round": 0,
                                    "num_samples": 4.0}, f)

    await push("a", "r1", "a")
    await _until(lambda: red1.partials >= 1, "r1 deadline flush")
    await _until(lambda: red2.folds >= 1, "r2 folds P1a")
    await push("c", "r2", "c")
    await _until(lambda: red2.folds >= 2, "r2 folds c")
    await push("b", "r1", "b")
    await _until(lambda: red1.partials >= 2, "r1 re-flush")
    await _until(lambda: red2.unfolds >= 1, "r2 prefold un-fold")
    await push("a", "r1", "a2")
    await _until(lambda: red1.unfolds >= 1, "r1 duplicate un-fold")
    await _until(lambda: red2.unfolds >= 2, "r2 second un-fold")
    await push("r1", "r2", "r1")
    top = await nodes["ps0"].next_push(timeout=30)
    dest = root / "top.st"
    await top.save_to(dest)
    await red1.stop()
    await red2.stop()
    for n in nodes.values():
        await n.stop()
    return dict(top.resource), dict(load_file(str(dest)))


def test_depth_two_reflush_out_of_order_equals_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("HYPHA_REDUCE_FLUSH_S", "0.6")
    rng = np.random.default_rng(42)
    d = {p: {"w": rng.standard_normal(8).astype(np.float32)} for p in ("a", "b", "c", "r1", "a2")}
    out = {}
    for name, pkg in PKG.items():
        (tmp_path / name).mkdir()
        out[name] = _run(_drive_two_levels(pkg, tmp_path / name, d))
    (jmeta, jtop), (tmeta, ttop) = out["jax"], out["port"]
    assert tmeta == jmeta
    assert sorted(tmeta["covers"]) == ["a", "b", "c", "r1"] and tmeta["num_samples"] == 16.0
    np.testing.assert_array_equal(ttop["w"], jtop["w"])
    # The reference's replay of the exact fold sequence.
    r1 = JAccum()
    r1.fold_tree(d["a"], 4.0)
    p1a, w1a = {k: v.copy() for k, v in r1.partial().items()}, r1.total_samples
    r1.fold_tree(d["b"], 4.0)
    p1ab, w1ab = {k: v.copy() for k, v in r1.partial().items()}, r1.total_samples
    r1.fold_tree(d["a"], 4.0, -1.0)
    r1.fold_tree(d["a2"], 4.0)
    r2 = JAccum()
    r2.fold_tree(p1a, w1a, prefolded=True)
    r2.fold_tree(d["c"], 4.0)
    r2.fold_tree(p1a, w1a, -1.0, prefolded=True)
    r2.fold_tree(p1ab, w1ab, prefolded=True)
    r2.fold_tree(p1ab, w1ab, -1.0, prefolded=True)
    r2.fold_tree(r1.partial(), r1.total_samples, prefolded=True)
    r2.fold_tree(d["r1"], 4.0)
    np.testing.assert_array_equal(ttop["w"], r2.partial()["w"])


def test_reducer_leaves_non_member_pushes_for_a_colocated_shard(tmp_path):
    async def main():
        nodes = await _mesh(PKG["port"], ["red", "ps0", "w1", "w3"])
        smap = tmsg.ShardMap(round=0, shards=["ps0"], tags=["u.s0"], fragments=1)
        red = _reducer(PKG["port"], nodes["red"], ["w1"], smap, sync_mode="blocking",
                       work=tmp_path / "red")
        red.start()
        f = tmp_path / "w3.st"
        save_file({"w": np.ones(4, np.float32)}, str(f))
        await nodes["w3"].push("red", {"resource": "u.s0", "name": f.name, "round": 0,
                                       "num_samples": 4.0}, f)
        push = await nodes["red"].next_push(timeout=10)
        assert push.peer == "w3"
        await push.read_all()
        await red.stop()
        assert red.folds == 0
        for n in nodes.values():
            await n.stop()

    _run(main())


# ---------------------------------------------------------- sharded servers


def _agg(m, job_id, workers, tag, **kw):
    return m.JobSpec(job_id=job_id, executor=m.Executor(
        kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
            updates=m.Receive(m.Reference.from_peers(list(workers), tag)),
            results=m.Send(m.Reference.from_peers(list(workers), "results")),
            optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=len(workers), **kw)))


def _ps(pkg, node, root):
    return TPS(node, root, device="cpu") if pkg.PS is TPS else JPS(node, root)


async def _serve_shards(pkg, root: Path, pushes: list, shards: int, rounds_done,
                        workers=("w1", "w2"), **kw) -> dict:
    """Run ``shards`` servers (``ps<k>`` under ``u.s<k>``, or one ``ps``
    under ``u``), feed ``pushes`` ((sender, target, header, file), in order;
    "wait" takes the next broadcast) and collect every broadcast the first
    worker receives and every UPDATED. A shard is answered DONE at its last
    round in ``rounds_done(shard)``."""
    names = [f"ps{k}" for k in range(shards)] if shards > 1 else ["ps"]
    w1, w2 = workers
    nodes = await _mesh(pkg, [*names, "sched", w1, w2])
    updated: list = []

    async def on_progress(peer, p):
        updated.append((peer, p.kind.value, p.round, p.shard, p.job_id))
        done = p.round >= rounds_done(int(p.shard or 0))
        return pkg.m.ProgressResponse(kind=pkg.m.ProgressResponseKind.DONE if done
                                      else pkg.m.ProgressResponseKind.OK)

    reg = nodes["sched"].on(pkg.m.PROTOCOL_PROGRESS, pkg.m.Progress).respond_with(on_progress)
    executions = []
    for k, name in enumerate(names):
        extra = dict(kw, shard_index=k, num_ps_shards=shards) if shards > 1 else dict(kw)
        spec = _agg(pkg.m, f"agg-{name}", [w1, w2], f"u.s{k}" if shards > 1 else "u",
                    **extra)
        executions.append(await _ps(pkg, nodes[name], root / name).execute(
            f"agg-{name}", spec, "sched"))
    got: list = []
    drained: list = []

    async def drain_w2():
        while True:
            p = await nodes[w2].next_push()
            await p.read_all()
            drained.append(dict(p.resource))

    drainer = asyncio.create_task(drain_w2())
    expected = {"n": 0}

    async def take(n):
        while len(got) < n:
            p = await nodes[w1].next_push(timeout=30)
            dest = root / f"bcast-{len(got)}"
            await p.save_to(dest)
            got.append((p.peer, dict(p.resource), dest.read_bytes()))

    for item in pushes:
        if item == "wait":
            expected["n"] += 1
            await take(expected["n"])
            continue
        sender, target, header, path = item
        await nodes[sender].push(target, header, path)
    statuses = [await asyncio.wait_for(e.wait(), 30) for e in executions]
    drainer.cancel()
    await asyncio.gather(drainer, return_exceptions=True)
    reg.close()
    for n in nodes.values():
        await n.stop()
    return {"got": got, "updated": updated, "states": [s.state for s in statuses]}


def _blocking_deltas(root: Path, codec: str, rounds: int = 2) -> tuple:
    """Seeded whole-tree deltas per (worker, round), and their 2 parts."""
    rng = np.random.default_rng(8)
    shapes = {"a": (8, 3), "b": (4,), "c": (8,), "d": (2, 2), "e": (5,)}
    parts = jstream.partition_names({k: int(np.prod(s)) for k, s in shapes.items()}, 2)
    full, split = {}, {}
    for w, r in itertools.product(("w1", "w2"), range(rounds)):
        tree = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 0)).astype(np.float32)
                for k, s in shapes.items()}
        path = root / f"full-{w}-{r}.st"
        save_file(tree, str(path))
        full[(w, r)] = path
        for p, names in enumerate(parts):
            path = root / f"part-{w}-{r}-{p}.st"
            sub = {n: tree[n] for n in names}
            if codec == "none":
                save_file(sub, str(path))
            else:
                tag = jmsg.FragmentTag(round=r, fragment_id=p, fragments=2).header()
                jcompress.write_delta(path, sub, codec, tag=tag)
            split[(w, r, p)] = path
    return shapes, parts, full, split


SAMPLES = {"w1": 6.0, "w2": 10.0}


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_two_shards_equal_the_reference_and_one_server(tmp_path, monkeypatch, codec):
    monkeypatch.setattr(native, "_load", lambda: None)
    rounds = 2
    shapes, parts, full, split = _blocking_deltas(tmp_path, codec, rounds)
    sharded_pushes, single_pushes = [], []
    for r in range(rounds):
        for w in ("w1", "w2"):
            for p in range(2):
                header = {"resource": f"u.s{p}", "name": split[(w, r, p)].name, "round": r,
                          "num_samples": SAMPLES[w], "shard": p,
                          "fragment_id": p, "fragments": 2}
                sharded_pushes.append((w, f"ps{p}", header, split[(w, r, p)]))
            single_pushes.append((w, "ps", {"resource": "u", "name": full[(w, r)].name,
                                            "round": r, "num_samples": SAMPLES[w]}, full[(w, r)]))
        sharded_pushes += ["wait", "wait"]
        single_pushes.append("wait")
    out = {}
    for name, pkg in PKG.items():
        (tmp_path / name).mkdir()
        out[name] = _run(_serve_shards(pkg, tmp_path / name, sharded_pushes, 2,
                                       lambda s: rounds - 1, delta_codec=codec))
    (tmp_path / "one").mkdir()
    one = _run(_serve_shards(PKG["port"], tmp_path / "one", single_pushes, 1,
                             lambda s: rounds - 1))
    assert out["port"]["states"] == out["jax"]["states"] == ["completed"] * 2
    # Every round: UPDATED from both shards, each with its index.
    assert sorted(out["port"]["updated"]) == sorted(out["jax"]["updated"]) == sorted(
        (f"ps{k}", "updated", r, k, f"agg-ps{k}") for k in range(2) for r in range(rounds))

    def by_key(got):
        return {(h["round"], h["shard"]): (peer, h, b) for peer, h, b in got}

    jgot, tgot = by_key(out["jax"]["got"]), by_key(out["port"]["got"])
    assert set(tgot) == set(jgot) == {(r, k) for r in range(rounds) for k in range(2)}
    singles = {h["round"]: b for _, h, b in one["got"]}
    for key, (jpeer, jh, jb) in jgot.items():
        tpeer, th, tb = tgot[key]
        assert tpeer == jpeer == f"ps{key[1]}" and th == jh
        assert th["fragment_id"] == key[1] and th["fragments"] == 2
        (tmp_path / "j").write_bytes(jb)
        (tmp_path / "t").write_bytes(tb)
        jt, tt = jcompress.read_delta(tmp_path / "j"), jcompress.read_delta(tmp_path / "t")
        assert set(tt) == set(jt) == set(parts[key[1]])
        for k in jt:
            np.testing.assert_array_equal(np.asarray(tt[k]), np.asarray(jt[k]))
        assert tb == jb
        if codec == "none":
            # Per tensor, one server over the whole tree gives the same bits.
            (tmp_path / "s").write_bytes(singles[key[0]])
            st = load_file(str(tmp_path / "s"))
            for k in jt:
                np.testing.assert_array_equal(np.asarray(tt[k]), st[k], err_msg=f"{key} {k}")


def test_stream_shards_close_only_their_owned_rounds(tmp_path, monkeypatch):
    """Stream mode, F = 4 over 2 shards, 4 rounds: shard k closes rounds
    r with r mod 4 mod 2 == k; a push to the wrong shard is dropped as
    misrouted; the broadcasts and UPDATED messages equal the JAX shards'."""
    monkeypatch.setattr(native, "_load", lambda: None)
    rounds, frags = 4, 4
    rng = np.random.default_rng(9)
    shapes = {"a": (6,), "b": (5,), "c": (4,), "d": (3,)}
    parts = jstream.partition_names({k: int(np.prod(s)) for k, s in shapes.items()}, frags)
    pushes = []
    for r in range(rounds):
        f = r % frags
        owner = jstream.shard_of(f, 2)
        for w in ("w1", "w2"):
            path = tmp_path / f"{w}-{r}.st"
            tag = jmsg.FragmentTag(round=r, fragment_id=f, fragments=frags).header()
            jcompress.write_delta(path, {n: rng.standard_normal(shapes[n]).astype(np.float32)
                                         for n in parts[f]}, "int8", tag=tag)
            header = {"resource": f"u.s{owner}", "name": path.name, "num_samples": SAMPLES[w],
                      "shard": owner, **tag}
            if w == "w1" and r == 1:  # misrouted first: the wrong shard drops it
                pushes.append((w, f"ps{1 - owner}", dict(header, resource=f"u.s{1 - owner}"),
                               path))
            pushes.append((w, f"ps{owner}", header, path))
        pushes.append("wait")
    last = {k: max(r for r in range(rounds) if jstream.shard_of(r % frags, 2) == k)
            for k in range(2)}
    out = {}
    for name, pkg in PKG.items():
        (tmp_path / name).mkdir()
        out[name] = _run(_serve_shards(pkg, tmp_path / name, pushes, 2, lambda s: last[s],
                                       sync_mode="stream", fragments=frags, delta_codec="int8"))
    assert out["port"]["states"] == out["jax"]["states"] == ["completed"] * 2
    assert out["port"]["updated"] == out["jax"]["updated"] == [
        (f"ps{r % 2}", "updated", r, r % 2, f"agg-ps{r % 2}") for r in range(rounds)]
    assert len(out["port"]["got"]) == len(out["jax"]["got"]) == rounds
    for (tp, th, tb), (jp, jh, jb) in zip(out["port"]["got"], out["jax"]["got"]):
        assert (tp, th) == (jp, jh) and tb == jb
        assert th["shard"] == th["fragment_id"] % 2 and tp == f"ps{th['shard']}"


# ----------------------------------------------------- cover reconciliation


class _FakePush:
    def __init__(self, peer, resource, tree):
        self.peer, self.resource, self._tree = peer, resource, tree
        self.drained = False

    async def save_to(self, dest, hasher=None):
        save_file(self._tree, str(dest))
        if hasher is not None:
            hasher.update(Path(dest).read_bytes())
        return 1

    async def read_all(self):
        self.drained = True
        return b""

    def finish(self):
        pass


class _FakeConsumer:
    def __init__(self, pushes):
        self._pushes = list(pushes)

    async def next(self, timeout=None):
        if self._pushes:
            return self._pushes.pop(0)
        await asyncio.sleep(0.01)
        raise asyncio.TimeoutError

    def close(self):
        pass


_D = {k: {"w": np.full(4, v, np.float32)} for k, v in
      (("w1", 1.0), ("w2", 3.0), ("w3", -2.0), ("w4", 5.0))}


def _part(*members):
    total = np.zeros(4, np.float32)
    for m in members:
        total = total + np.float32(4.0) * _D[m]["w"]
    return {"w": total}


# name -> (pushes as (sender, covers or None), workers, the keys that stay)
COVER_CASES = {
    "partial after direct": ([("w1", None), ("red", ("w1", "w2"))], 2, {"prefold:red"}),
    "direct after partial": ([("red", ("w1", "w2")), ("w1", None), ("w3", None)], 3,
                             {"prefold:red", "w3"}),
    "direct, partial, direct": ([("w3", None), ("w1", None), ("red", ("w1", "w2"))], 3,
                                {"prefold:red", "w3"}),
    "proper overlap, tie dropped, superset retires": (
        [("r1", ("w1", "w2")), ("r2", ("w1", "w3")), ("r2", ("w1", "w2", "w3"))], 3,
        {"prefold:r2"}),
    "bigger proper overlap wins": ([("r1", ("w1", "w2")), ("r2", ("w1", "w3", "w4"))], 3,
                                   {"prefold:r2"}),
}


def _cover_pushes(case, stream: bool):
    out = []
    for sender, covers in COVER_CASES[case][0]:
        header = {"resource": "u", "name": f"x-{sender}", "round": 0}
        if stream:
            header.update(fragment_id=0, fragments=1)
        if covers is None:
            out.append(_FakePush(sender, dict(header, num_samples=4.0), _D[sender]))
        else:
            out.append(_FakePush(sender, dict(header, num_samples=4.0 * len(covers),
                                              prefold=True, covers=list(covers)),
                                 _part(*covers)))
    return out


async def _collect(name, pkg, root, case, stream):
    pushes = _cover_pushes(case, stream)
    workers = COVER_CASES[case][1]
    ps = _ps(pkg, None, root)
    if not stream:
        accum = TAccum(device="cpu") if name == "port" else JAccum()
        received = await ps._collect_round(_FakeConsumer(pushes), "job", set(), workers, root, 0,
                                           accum=accum)
    else:
        accums = {0: TAccum(device="cpu") if name == "port" else JAccum()}
        args = ("job", set(), workers, root, 0, 1, accums, {})
        if name == "jax":
            args = ("job", None, None, set(), workers, root, 0, 1, accums, {})
        received = await ps._collect_round_stream(_FakeConsumer(pushes), *args)
        accum = accums[0]
    mean = {k: np.asarray(v) for k, v in accum.mean().items()}
    return sorted(received), accum.total_samples, mean, [p.drained for p in pushes]


@pytest.mark.parametrize("stream", [False, True], ids=["blocking", "stream"])
@pytest.mark.parametrize("case", sorted(COVER_CASES))
def test_cover_reconciliation_equals_the_reference(tmp_path, case, stream):
    out = {}
    for name, pkg in PKG.items():
        (tmp_path / name).mkdir()
        out[name] = _run(_collect(name, pkg, tmp_path / name, case, stream))
    (jkeys, jw, jmean, jdrained), (tkeys, tw, tmean, tdrained) = out["jax"], out["port"]
    assert set(tkeys) == set(jkeys) == COVER_CASES[case][2]
    assert tw == jw and tdrained == jdrained
    np.testing.assert_array_equal(tmean["w"], jmean["w"])


@pytest.mark.parametrize("stream", [False, True], ids=["blocking", "stream"])
def test_a_durable_server_journals_a_partial_and_replays_it(tmp_path, stream):
    # Both packages' durable collectors journal the same cover case (the
    # partial under its ``prefold:`` key, with its covers), and each
    # package's replay of its own journal gives the same ops and a sum
    # bit-equal to the live one.
    from hypha_tpu.ft.durable import DurablePS as JDurable
    from hypha_tpu_torch.ft.durable import DurablePS as TDurable

    out = {}
    for name, pkg in PKG.items():
        root = tmp_path / name
        (root / "w").mkdir(parents=True)
        dur = (TDurable if name == "port" else JDurable).open(root / "dur", "job")
        pushes = _cover_pushes("partial after direct", stream)
        ps = _ps(pkg, None, root / "w")
        accum = TAccum(device="cpu") if name == "port" else JAccum()
        if not stream:
            received = _run(ps._collect_round(_FakeConsumer(pushes), "job", set(), 2, root / "w",
                                              0, accum=accum, dur=dur))
        else:
            accums = {0: accum}
            if name == "port":
                received = _run(ps._collect_round_stream(
                    _FakeConsumer(pushes), "job", set(), 2, root / "w", 0, 1, accums, {},
                    dur=dur))
            else:
                received = _run(ps._collect_round_stream(
                    _FakeConsumer(pushes), "job", None, None, set(), 2, root / "w", 0, 1, accums,
                    {}, dur=dur))
        dur.close()
        reopened = (TDurable if name == "port" else JDurable).open(root / "dur", "job")
        ops = [(f.peer, f.prefold, sorted(f.covers), s) for f, s in reopened.replay_ops(0)]
        replayed = TAccum(device="cpu") if name == "port" else JAccum()
        for fold, sign in reopened.replay_ops(0):
            replayed.fold(reopened.deltas_dir / fold.file, fold.samples, sign, fold.prefold)
        reopened.close()
        live = {k: np.asarray(v) for k, v in accum.mean().items()}
        again = {k: np.asarray(v) for k, v in replayed.mean().items()}
        out[name] = (sorted(received), ops, live, again)
    (jkeys, jops, jlive, _), (tkeys, tops, tlive, tagain) = out["jax"], out["port"]
    assert tkeys == jkeys == ["prefold:red"]
    assert tops == jops == [("w1", False, [], 1.0), ("w1", False, [], -1.0),
                            ("prefold:red", True, ["w1", "w2"], 1.0)]
    np.testing.assert_array_equal(tlive["w"], jlive["w"])
    np.testing.assert_array_equal(tagain["w"], tlive["w"])


# -------------------------------------------------------------- scheduler


# (sync mode, fragments, shards, rounds)
GATES = [("blocking", 0, 2, 3), ("blocking", 0, 3, 2), ("stream", 2, 2, 3),
         ("stream", 4, 2, 5), ("stream", 4, 3, 6), ("blocking", 0, 1, 2)]


@pytest.mark.parametrize("mode,frags,shards,rounds", GATES)
def test_batch_schedulers_gate_on_every_due_shard_alike(mode, frags, shards, rounds):
    rng = np.random.default_rng(shards * 10 + rounds)
    peers = [f"ps{k}" for k in range(shards)]
    sched = {}
    for name, pkg in PKG.items():
        parts = pkg.stream.placement_parts(mode, frags, shards)
        tracker = pkg.tr.ProgressTracker(peers, 10, rounds, clock=lambda: 0.0)
        due = ((lambda r, p=parts, s=pkg.stream: s.shards_due_at(mode, r, p, shards))
               if shards > 1 else None)
        sched[name] = (pkg, tracker, pkg.bs.BatchScheduler(tracker, shards_due=due))
    parts = jstream.placement_parts(mode, frags, shards)
    sends = [("stranger", 0, 0)]
    for r in range(rounds):
        due = list(jstream.shards_due_at(mode, r, parts, shards))
        rng.shuffle(due)
        for k in due:
            sends.append((f"ps{k}", r, k))
            if rng.random() < 0.3:
                sends.append((f"ps{k}", r, k))  # an idempotent re-notify
    sends.append(("ps0", rounds - 1, 0))
    for peer, rnd, shard in sends:
        # Built in the JAX package, decoded by each package's codec.
        raw = jmsg.encode(jmsg.Progress(kind=jmsg.ProgressKind.UPDATED, job_id="j", round=rnd,
                                        shard=shard))
        answers = []
        for name, (pkg, tracker, bs) in sched.items():
            resp = bs.on_progress(peer, pkg.m.decode(raw))
            answers.append((resp.kind.value, resp.message, tracker.round))
        assert answers[0] == answers[1], (peer, rnd, shard)
    assert sched["port"][1].round == rounds


# ---------------------------------------------------------- orchestration


def _job(pkg, **over):
    from hypha_tpu.resources import Resources as JR
    from hypha_tpu_torch.resources import Resources as TR

    m, R = pkg.m, (TR if pkg.m is tmsg else JR)
    return pkg.job.DiLoCoJob(
        model={"preset": "tiny"}, dataset="d",
        rounds=pkg.job.DiLoCoRounds(update_rounds=3, avg_samples_between_updates=8,
                                    max_batch_size=2),
        inner_optimizer=m.Adam(lr=1e-3), outer_optimizer=m.Nesterov(lr=0.7, momentum=0.9),
        resources=pkg.job.JobResources(
            num_workers=3, worker=R(gpu=1.0, cpu=1.0, memory=10),
            parameter_server=R(cpu=1.0, memory=10),
            worker_price=m.PriceRange(bid=1.0, max=10.0),
            parameter_server_price=m.PriceRange(bid=2.0, max=20.0)),
        **over)


PLANS = {
    "stream, 2 shards, a group of 3": {"sync_mode": "stream", "num_fragments": 4,
                                       "num_ps_shards": 2, "reduce_group_size": 3,
                                       "delta_codec": "int8"},
    "blocking, 2 shards": {"num_ps_shards": 2, "delta_codec": "int8"},
    "blocking, 1 server, groups of 2 at depth 2": {"reduce_group_size": 2,
                                                   "reduce_tree_depth": 2},
    "stream, 3 shards": {"sync_mode": "stream", "num_fragments": 6, "num_ps_shards": 3},
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_orchestrators_plan_the_same_placement(plan):
    over = PLANS[plan]
    workers = ["w2", "w0", "w1", "w4", "w3"]
    base = "00000000-0000-4000-8000-00000000abcd"
    sent = {}
    for name, pkg in PKG.items():
        job = _job(pkg, **over)
        shards = job.num_ps_shards
        ps = [f"psw{k}" for k in range(shards)]
        orch = pkg.orch.Orchestrator(types.SimpleNamespace(peer_id="sched"))
        ctx = pkg.orch._RunContext()
        ctx.job, ctx.base_id, ctx.ft = job, base, None
        ctx.ps_handles = [types.SimpleNamespace(peer_id=p) for p in ps]
        orch._plan_streams(ctx, job, workers, ps, shards,
                           pkg.stream.placement_parts(job.sync_mode, job.num_fragments, shards))
        handles = [types.SimpleNamespace(peer_id=p, lease_id=f"l-{p}", batch_size=2)
                   for p in workers]
        msgs = [pkg.m.DispatchJob(lease_id=f"l-{p}", spec=s) for p, s in zip(ps, ctx.ps_specs)]
        msgs += [pkg.m.DispatchJob(lease_id=h.lease_id, spec=orch._train_spec(ctx, f"w{i}", h))
                 for i, h in enumerate(handles)]
        sent[name] = ([pkg.m.encode(x) for x in msgs], ctx)
    (jbytes, jctx), (tbytes, tctx) = sent["jax"], sent["port"]
    assert tbytes == jbytes
    assert (tctx.shard_tags, tctx.ps_job_ids, tctx.reduce_groups) == \
        (jctx.shard_tags, jctx.ps_job_ids, jctx.reduce_groups)
    assert tmsg.encode(tctx.shard_map) == jmsg.encode(jctx.shard_map)
    if over.get("num_ps_shards", 1) > 1:
        assert tctx.ps_job_ids == [f"{base}-ps{k}" for k in range(over["num_ps_shards"])]
        assert tctx.shard_tags == [f"updates:{base}.s{k}" for k in range(over["num_ps_shards"])]


def test_train_spec_routes_results_by_placement_not_live_handles():
    job = _job(PKG["port"], sync_mode="stream", num_fragments=2, num_ps_shards=2)
    ctx = torch_orch._RunContext()
    ctx.job, ctx.base_id, ctx.updates_tag, ctx.results_tag = job, "base", "u", "r"
    ctx.shard_map = tmsg.ShardMap(round=0, shards=["psA", "psB"], tags=["u.s0", "u.s1"],
                                  fragments=2)
    ctx.ps_handles = [types.SimpleNamespace(peer_id="psA"), None]
    orch = torch_orch.Orchestrator(types.SimpleNamespace(peer_id="sched"))
    spec = orch._train_spec(ctx, "r1", types.SimpleNamespace(peer_id="w0", batch_size=4))
    assert list(spec.executor.train.results.ref.peers) == ["psA", "psB"]


# The fault-tolerant shapes of a sharded or grouped job run, and so does
# the broadcast tree (refused under its own label until it was ported).
SHARD_FT_OPTIONS = {
    "shards, checkpoint_dir": {"num_ps_shards": 2, "checkpoint_dir": "/c"},
    "group, checkpoint_dir": {"reduce_group_size": 2, "checkpoint_dir": "/c"},
    "shards, ft": {"num_ps_shards": 2, "ft": "on"},
    "broadcast tree": {"reduce_group_size": 2, "broadcast_tree": True},
}


@pytest.mark.parametrize("case", sorted(SHARD_FT_OPTIONS))
def test_shard_options_with_ft(case):
    over = dict(SHARD_FT_OPTIONS[case])
    jobs = {}
    for name, pkg in PKG.items():
        if "ft" in SHARD_FT_OPTIONS[case]:
            over["ft"] = _ft_config(name)
        jobs[name] = pkg.m.encode(_job(pkg, **over))
    assert jobs["port"] == jobs["jax"]


def _ft_config(name):
    from hypha_tpu.ft.membership import FTConfig as JFT
    from hypha_tpu_torch.ft.membership import FTConfig as TFT

    return (TFT if name == "port" else JFT)(quorum_fraction=0.5)


# ------------------------------------------------------ the trainer's parts


class _ShardedSession:
    """Answers every part push with update = 0.7 · Δpart, echoing its
    (round, fragment, shard), and records where each part was routed."""

    def __init__(self, work_dir: Path, rounds: int, batches: int = 2):
        self.work_dir, self.rounds, self.batches = Path(work_dir), rounds, batches
        self.done = self.this_round = 0
        self.scheduled = False
        self.events: "queue.Queue[dict]" = queue.Queue()
        self.routed: list = []
        self.lock = threading.Lock()

    def fetch(self, fetch):
        d = self.work_dir / "artifacts"
        d.mkdir(parents=True, exist_ok=True)
        path = d / "slice.safetensors"
        if not path.exists():
            ids = np.random.default_rng(42).integers(0, 64, (8, 16)).astype(np.int32)
            save_file({"input_ids": ids}, str(path))
        return ["artifacts/slice.safetensors"]

    def send_status(self, progress):
        K, R = tmsg.ProgressKind, tmsg.ProgressResponseKind
        with self.lock:
            if progress.kind == K.STATUS:
                if self.done >= self.rounds:
                    return tmsg.ProgressResponse(kind=R.DONE)
                self.this_round += 1
                if not self.scheduled and self.this_round >= self.batches:
                    self.scheduled = True
                    return tmsg.ProgressResponse(kind=R.SCHEDULE_UPDATE, counter=0)
                return tmsg.ProgressResponse(kind=R.CONTINUE)
            if progress.kind == K.UPDATE_RECEIVED:
                self.done += 1
                self.this_round, self.scheduled = 0, False
                return tmsg.ProgressResponse(kind=R.DONE if self.done >= self.rounds
                                             else R.CONTINUE)
            return tmsg.ProgressResponse(kind=R.OK)

    def send_resource(self, send, path, resource="updates", meta=None):
        meta = dict(meta or {})
        self.routed.append({"peers": list(send.ref.peers or []), "strategy": send.ref.strategy,
                            "resource": resource, "meta": meta})
        delta = jcompress.read_delta(self.work_dir / path)
        update = {k: 0.7 * np.asarray(v, np.float32) for k, v in delta.items()}
        incoming = self.work_dir / "incoming"
        incoming.mkdir(exist_ok=True)
        rnd, frag = int(meta.get("round", 0)), int(meta.get("fragment_id", 0))
        out = incoming / f"update-{rnd}-p{frag}.safetensors"
        save_file(update, str(out))
        event = {"round": rnd}
        for key in ("fragment_id", "fragments", "shard"):
            if key in meta:
                event[key] = meta[key]
        self.events.put({"path": f"incoming/{out.name}", "meta": event, "size": 0})

    def receive(self, receive):
        @contextlib.contextmanager
        def cm():
            def gen():
                while True:
                    try:
                        yield self.events.get(timeout=30)
                    except queue.Empty:
                        return
            yield gen()
        return cm()


def test_run_training_sharded_blocking_equals_unsharded(tmp_path):
    from hypha_tpu_torch.executor.training import run_training

    def run_one(tag, shard_map, reduce_via=None):
        work = tmp_path / tag
        work.mkdir()
        cfg = tmsg.TrainExecutorConfig(
            model={"model_type": "causal-lm", "family": "llama", "preset": "tiny",
                   "config": {"dtype": "float32", "vocab_size": 64, "num_layers": 1},
                   "seed": 3},
            data=tmsg.Fetch(tmsg.Reference.from_uri("file:///unused")),
            updates=tmsg.Send(tmsg.Reference.from_peers(["ps"], "updates")),
            results=tmsg.Receive(tmsg.Reference.from_peers(["ps"], "results")),
            optimizer=tmsg.Adam(lr=1e-3), batch_size=4, ps_shards=shard_map,
            reduce_via=reduce_via, delta_codec="none")
        spec = tmsg.JobSpec(job_id=f"s-{tag}", executor=tmsg.Executor(
            kind="train", name="diloco-transformer", train=cfg))
        session = _ShardedSession(work, rounds=2)
        captured = {}
        import hypha_tpu_torch.executor.training as tr

        real = tr.theta_checksum

        def grab(params):
            captured["theta"] = {k: v.detach().clone() for k, v in params.items()}
            return real(params)

        tr.theta_checksum = grab
        try:
            result = run_training(session, work, spec, max_batches=64, device="cpu")
        finally:
            tr.theta_checksum = real
        return result, captured["theta"], session

    smap = tmsg.ShardMap(round=0, shards=["psA", "psB"], tags=["u.s0", "u.s1"], fragments=2)
    res_u, theta_u, _ = run_one("unsharded", None)
    res_s, theta_s, session = run_one("sharded", smap, reduce_via="red")
    assert res_u.rounds == res_s.rounds == 2
    assert len(session.routed) == 4  # 2 rounds x 2 parts
    names = set()
    for sent in session.routed:
        p = int(sent["meta"]["fragment_id"])
        owner = tstream.shard_of(p, 2)
        assert sent["peers"] == ["red", smap.shards[owner]]
        assert sent["strategy"] == tmsg.TransferStrategy.ANY
        assert sent["resource"] == smap.tags[owner] and sent["meta"]["shard"] == owner
        assert sent["meta"]["fragments"] == 2 and "round" in sent["meta"]
    assert set(theta_u) == set(theta_s)
    for k in theta_u:
        assert torch.equal(theta_u[k], theta_s[k]), k
        names.add(k)
    assert names


# ------------------------------------------------- chip_smoke's train_shard


@pytest.mark.parametrize("job", ["S", "B"])
def test_port_fabric_runs_the_shard_jobs_on_the_cpu(job, monkeypatch):
    """``chip_smoke.py``'s ``train_shard`` phase rehearsed on the CPU at tiny
    widths: Job S (stream, int8, 2 shards on ``psw0`` / ``psw1``, one group
    of 3 with ``w0`` its reducer) and Job B (blocking, int8, 2 shards), each
    trainer a process of its own, held to ``shard_stream_problems`` /
    ``shard_blocking_problems``."""
    import shutil
    import tempfile

    import chip_smoke

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # five processes share the CPU
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"dtype": "float32"}, "seed": 0}
    if job == "S":
        opts, workers, rounds = chip_smoke.SHARD_S_OPTIONS, chip_smoke.SHARD_S_WORKERS, 4
    else:
        opts, workers, rounds = chip_smoke.SHARD_B_OPTIONS, chip_smoke.SHARD_B_WORKERS, 2
    root = Path(tempfile.mkdtemp(prefix="tsh"))
    try:
        run = asyncio.run(asyncio.wait_for(chip_smoke.run_node_job(
            root, model, device="cpu", rounds=rounds, steps=3, batch=2, seq=16, period=64,
            lr=3e-3, limit_s=90, workers=workers, ps_hosts=2, job_options=opts,
            check_reducer=job == "S"), 240))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep = chip_smoke.shard_report(run)
    log = "\n".join(run["rec"]["log"])
    if job == "S":
        problems = chip_smoke.shard_stream_problems(run, rep, rounds=rounds,
                                                    fragments=opts["num_fragments"])
        assert rep["reducers"][0]["partials"] >= rounds
        assert all(c["equal"] for c in rep["partial_checks"])
    else:
        problems = chip_smoke.shard_blocking_problems(run, rep, rounds=rounds,
                                                      expect=chip_smoke.flat_f32_spec(model))
    assert problems == [], (problems, log[-3000:])
    for peer, t in rep["trainers"].items():  # the host's plain attention on the CPU
        assert t["launches"] == {"fwd": 0, "dq": 0, "dkv": 0, "flash_plain": 0,
                                 "dense": 2 * t["batches"]}, peer
    cells = rep["per_shard_round"]
    assert all(c["fold_s"] > 0 and c["outer_step_s"] > 0 and c["encode_s"] > 0 for c in cells)
    summary = chip_smoke._shard_job_summary(run, rep, 1.0, 0.0)
    assert summary["step_ms"] > 0 and summary["updated"]


# -------------------------------------------------------- mixed packages


def _record_servers(rec: dict, root: Path):
    """Patch both packages' servers to keep a copy of every delta they save
    (its header, its server's work dir) and every broadcast they push."""
    saved = []
    for cls in (JPS, TPS):
        save, bcast = cls._save_delta, cls._broadcast

        async def keep_save(*args, _save=save, **kw):
            path, samples = await _save(*args, **kw)
            push = args[0]
            copy = root / f"delta-{len(rec['deltas'])}"
            copy.write_bytes(Path(path).read_bytes())
            rec["deltas"].append({"peer": push.peer, "header": dict(push.resource),
                                  "dir": str(Path(path).parent), "file": copy})
            return path, samples

        async def keep_bcast(self, cfg, update_path, round_num, *args, _bcast=bcast, **kw):
            header = kw.get("extra_header", args[1] if len(args) > 1 else None) or {}
            rec["broadcasts"].append({"round": round_num, "header": dict(header),
                                      "bytes": Path(update_path).read_bytes()})
            return await _bcast(self, cfg, update_path, round_num, *args, **kw)

        saved.append((cls, save, bcast))
        cls._save_delta = staticmethod(keep_save)
        cls._broadcast = keep_bcast
    return saved


@pytest.mark.parametrize("reducer,scheduler", [("jax", "port"), ("port", "jax")],
                         ids=["jax-reducer-port-scheduler", "port-reducer-jax-scheduler"])
def test_mixed_workers_share_a_sharded_tree_job(tmp_path, monkeypatch, reducer, scheduler):
    """A JAX and a torch worker share a blocking job with 2 parameter-server
    shards and one reduce group (``reduce_group_size`` 2; the first sorted
    peer id reduces): once with the JAX worker as the reducer under the
    port's scheduler and shards, once with the torch worker as the reducer
    under the JAX scheduler and shards. Every round closes on both shards
    with finite losses from both workers; each shard took the reducer's
    delta and its partial covering the other worker; and the same pushes,
    replayed into two JAX shards, give every broadcast byte for byte."""
    import shutil
    import tempfile

    import chip_smoke
    from _torch_parity import tiny_pair
    from hypha_tpu.data_node import DataNode as JDataNode
    from hypha_tpu.executor.serialization import flatten_tree
    from hypha_tpu.gateway import Gateway as JGateway
    from hypha_tpu.network import TcpTransport as JTcp
    from hypha_tpu.resources import Resources as JR
    from hypha_tpu.scheduler.metrics_bridge import CallbackConnector
    from hypha_tpu.worker.arbiter import OfferConfig as JOfferConfig
    from hypha_tpu.worker.runtime import WorkerNode as JWorkerNode
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.network import TcpTransport
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.metrics_bridge import CallbackConnector as TCallback
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.runtime import WorkerNode

    monkeypatch.setattr(native, "_load", lambda: None)
    rounds, seq, vocab = 2, 16, 256
    jw, tw = ("a-jax", "b-torch") if reducer == "jax" else ("b-jax", "a-torch")
    red, member = sorted([jw, tw])
    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        ids = ((rng.integers(0, vocab, (8, 1)) + np.arange(seq)) % vocab).astype(np.int32)
        save_file({"input_ids": ids}, str(data_dir / f"slice_{i:04d}.safetensors"))
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"dtype": "float32"},
             "source": jmsg.to_json_dict(jmsg.Fetch(jmsg.Reference.from_uri(weights.as_uri())))}
    job = jjob.DiLoCoJob(
        model=model, dataset="counting",
        rounds=jjob.DiLoCoRounds(update_rounds=rounds, avg_samples_between_updates=8,
                                 max_batch_size=2),
        inner_optimizer=jmsg.Adam(lr=3e-3), outer_optimizer=jmsg.Nesterov(lr=0.7, momentum=0.9),
        resources=jjob.JobResources(
            num_workers=2, worker=JR(gpu=1.0, cpu=1.0, memory=10),
            parameter_server=JR(cpu=1.0, memory=10),
            worker_price=jmsg.PriceRange(bid=1.0, max=10.0),
            parameter_server_price=jmsg.PriceRange(bid=1.0, max=10.0)),
        num_ps_shards=2, reduce_group_size=2, delta_codec="int8")
    root = Path(tempfile.mkdtemp(prefix="wm"))  # bridge sockets: paths under 108 bytes
    port = scheduler == "port"
    tracked: list = []
    rec: dict = {"deltas": [], "broadcasts": []}
    (tmp_path / "rec").mkdir()

    async def main():
        Tcp, GW, DN, Sched = (TcpTransport, Gateway, DataNode, TNode) if port else \
            (JTcp, JGateway, JDataNode, JNode)
        gw = GW(Tcp(), peer_id="gw")
        await gw.start(["127.0.0.1:0"])
        boot = [gw.node.listen_addrs[0]]
        pss = [WorkerNode(TcpTransport(), resources=Resources(cpu=2, memory=200), device="cpu",
                          peer_id=f"psw{k}", bootstrap=boot, work_root=root / f"p{k}")
               if port else
               JWorkerNode(JTcp(), resources=JR(cpu=2, memory=200), peer_id=f"psw{k}",
                           bootstrap=boot, work_root=root / f"p{k}") for k in range(2)]
        parts = [DN(Tcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot),
                 JWorkerNode(JTcp(), resources=JR(gpu=2, cpu=8, memory=1000), peer_id=jw,
                             offer=JOfferConfig(strategy="whole"), bootstrap=boot,
                             work_root=root / "j"),
                 WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id=tw, offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root / "t"),
                 *pss]
        sched = Sched(Tcp(), peer_id="sched", bootstrap=boot)
        started = []
        try:
            for part in (*parts, sched):
                await part.start(["127.0.0.1:0"])
                started.append(part)
            await sched.wait_for_bootstrap()
            if port:
                orch = torch_orch.Orchestrator(sched, metrics_connector=TCallback(
                    lambda w, r, n, v: tracked.append((w, r, n, v))))
                return await orch.run(tmsg.decode(jmsg.encode(job)), auction_timeout=1.5)
            orch = jorch.Orchestrator(sched, metrics_connector=CallbackConnector(
                lambda w, r, n, v: tracked.append((w, r, n, v))))
            return await orch.run(job, auction_timeout=1.5)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    saved = _record_servers(rec, tmp_path / "rec")
    try:
        result = asyncio.run(asyncio.wait_for(main(), 240))
    finally:
        for cls, save, bcast in saved:
            cls._save_delta, cls._broadcast = staticmethod(save), bcast
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == rounds
    losses = {(w, r): v for w, r, n, v in tracked if n == "loss"}
    assert set(losses) == {(w, r) for w in (jw, tw) for r in range(rounds)}, losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    # Each shard each round: the reducer's own delta and its partial,
    # which covers the other worker; nothing directly from that worker.
    cells: dict = {}
    for d in rec["deltas"]:
        cells.setdefault((int(d["header"]["shard"]), int(d["header"]["round"])), []).append(d)
    assert sorted(cells) == [(k, r) for k in range(2) for r in range(rounds)]
    for key, ds in cells.items():
        direct = [d["peer"] for d in ds if not d["header"].get("prefold")]
        partials = [d for d in ds if d["header"].get("prefold")]
        assert direct == [red] and partials and all(d["peer"] == red for d in partials), key
        assert partials[-1]["header"]["covers"] == [member], key
    # The same pushes, in each shard's order, replayed into two JAX shards.
    pushes = []
    for r in range(rounds):
        for k in range(2):
            for d in cells[(k, r)]:
                pushes.append((d["peer"], f"ps{k}", {**d["header"], "resource": f"u.s{k}"},
                               d["file"]))
        pushes += ["wait", "wait"]
    (tmp_path / "replay").mkdir()
    replay = _run(_serve_shards(PKG["jax"], tmp_path / "replay", pushes, 2,
                                lambda k: rounds - 1, workers=(red, member),
                                delta_codec="int8"), 120)
    want = {(h["round"], h["shard"]): b for _, h, b in replay["got"]}
    got = {(b["round"], b["header"]["shard"]): b["bytes"] for b in rec["broadcasts"]}
    assert set(got) == set(want) == {(r, k) for r in range(rounds) for k in range(2)}
    for key in want:
        assert got[key] == want[key], key


def test_shard_wire_keys_equal_the_reference():
    assert (tmsg.SHARD_KEY, tmsg.PREFOLD_KEY, tmsg.COVERS_KEY, tmsg.PROTOCOL_SHARD) == \
        (jmsg.SHARD_KEY, jmsg.PREFOLD_KEY, "covers", jmsg.PROTOCOL_SHARD)
    with pytest.raises(ValueError):
        tmsg.ShardMap(shards=["a", "b"], tags=["t"])
    with pytest.raises(ValueError):
        jmsg.ShardMap(shards=["a", "b"], tags=["t"])
    assert tmsg.ShardMap(shards=["a", "b"]).num_shards == jmsg.ShardMap(shards=["a", "b"]).num_shards
