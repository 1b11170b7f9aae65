"""Port parity: the durable parameter server (``hypha_tpu_torch/ft/durable.py``
against ``hypha_tpu/ft/durable.py``).

1. A journal written by either package parses in the other, record for
   record, and the same records give the same bytes; a torn tail reads as
   the end; ``replace_with`` compacts; ``$HYPHA_JOURNAL_FSYNC_EVERY``
   batches the fsyncs.
2. The same operations on both packages' ``DurablePS`` (folds with a
   re-send, commits with a checkpoint every 2 rounds carrying momentum,
   the catch-up Σ and a residual, notifies, restarts) leave the same
   journal bytes, the same ``ps-state.json``, the same state tensors, and
   reopen (in either package) to the same generation, resume point,
   dedup index, last-wins table and replay sequence; a foreign job's state
   is wiped; generations stay monotonic across compacting restarts.
3. The port's parameter server killed mid-round and restarted on the same
   durable dir, over the memory fabric: its three rounds' broadcasts are
   bit-equal to an uninterrupted run's and to the JAX server's (numpy
   outer step) on the same deltas; the restarted server announces
   generation 2, the worker's re-sent delta folds once (a dedup hit), and a
   gapped journal fails the job through its execution.
"""

from __future__ import annotations

import asyncio
import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from hypha_tpu import aio as jaio
from hypha_tpu import compress as jcompress
from hypha_tpu import messages as jmsg
from hypha_tpu import native
from hypha_tpu.ft import durable as jdur
from hypha_tpu.ft import rejoin as jrejoin
from hypha_tpu.network import MemoryTransport as JMemory
from hypha_tpu.network import Node as JNode
from hypha_tpu.worker.ps_executor import ParameterServerExecutor as JPS
from hypha_tpu_torch import aio as taio
from hypha_tpu_torch import compress as tcompress
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor.serialization import load_file as tload
from hypha_tpu_torch.ft import durable as tdur
from hypha_tpu_torch.ft import rejoin as trejoin
from hypha_tpu_torch.network import MemoryTransport as TMemory
from hypha_tpu_torch.network import Node as TNode
from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as TPS

MOD = {"jax": jdur, "port": tdur}

RECORDS = [
    {"t": "gen", "generation": 3, "job_id": "job-ps"},
    {"t": "open", "round": 4},
    jdur.FoldRecord(4, 0, "w0", 6.0, "ab" * 32, "delta-4-x.safetensors").record(),
    jdur.FoldRecord(4, 0, "w1", 10.0, "cd" * 32, "delta-4-y.safetensors", True,
                    ["w1", "w2"]).record(),
    {"t": "close", "round": 4, "peers": ["w0", "w1"]},
    {"t": "commit", "round": 4, "fragment": 0, "wire": "wire-4.safetensors", "epoch": 2},
    {"t": "notified", "round": 4, "done": False},
]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_journal_reads_in_both_packages(tmp_path, writer):
    path = tmp_path / "journal.cbor"
    journal = MOD[writer].RoundJournal(path, fsync_every=0)
    for rec in RECORDS:
        journal.append(rec, sync=rec["t"] == "commit")
    journal.close()
    assert tdur.RoundJournal.read_all(path) == jdur.RoundJournal.read_all(path) == RECORDS
    assert journal.bytes_written == path.stat().st_size
    other = tmp_path / "other.cbor"
    j2 = MOD["port" if writer == "jax" else "jax"].RoundJournal(other, fsync_every=0)
    for rec in RECORDS:
        j2.append(rec)
    j2.close()
    assert other.read_bytes() == path.read_bytes()
    # The port's fold record is the reference's, field for field.
    assert tdur.FoldRecord(4, 0, "w1", 10.0, "cd" * 32, "delta-4-y.safetensors", True,
                           ["w1", "w2"]).record() == RECORDS[3]


@pytest.mark.parametrize("cut", [1, 3, 4, 9])
def test_a_torn_tail_reads_as_the_end(tmp_path, cut):
    path = tmp_path / "journal.cbor"
    journal = tdur.RoundJournal(path, fsync_every=0)
    for rec in RECORDS:
        journal.append(rec)
    journal.close()
    data = path.read_bytes()
    path.write_bytes(data[:len(data) - cut])
    want = jdur.RoundJournal.read_all(path)
    assert tdur.RoundJournal.read_all(path) == want == RECORDS[:-1]
    # A length prefix past the record cap is a torn tail too.
    path.write_bytes(struct.pack("<I", 1 << 21) + b"x" * 8)
    assert tdur.RoundJournal.read_all(path) == jdur.RoundJournal.read_all(path) == []
    assert tdur.RoundJournal.read_all(tmp_path / "missing") == []


def test_compaction_and_fsync_batching(tmp_path, monkeypatch):
    path = tmp_path / "journal.cbor"
    journal = tdur.RoundJournal(path, fsync_every=0)
    for rec in RECORDS:
        journal.append(rec)
    journal.replace_with(RECORDS[:2])
    journal.append(RECORDS[2])
    journal.close()
    assert tdur.RoundJournal.read_all(path) == RECORDS[:3]
    synced = []
    monkeypatch.setattr(tdur.os, "fsync", lambda fd: synced.append(fd))
    monkeypatch.setenv(tdur.JOURNAL_FSYNC_ENV, "3")
    batched = tdur.RoundJournal(tmp_path / "b.cbor")
    for rec in RECORDS[:5]:
        batched.append(rec)
    batched.append(RECORDS[5], sync=True)
    batched.close()
    assert len(synced) == 2  # after the third record, and the forced commit
    assert tdur.RoundJournal(tmp_path / "c.cbor").fsync_every == 3


def _tree(value: float) -> dict:
    return {"w": np.full(8, value, np.float32), "b": np.full(3, -value, np.float32)}


def _ops(pkg: str, root: Path, tmp: Path) -> None:
    """Two generations of a durable server's bookkeeping, checkpoint every 2."""
    mod = MOD[pkg]
    rejoin = jrejoin if pkg == "jax" else trejoin
    momentum = tmp / f"m-{pkg}.safetensors"
    catchup = rejoin.CatchupBuffer()
    ef = (jcompress if pkg == "jax" else tcompress).ErrorFeedback()
    for gen in range(2):
        dur = mod.DurablePS.open(root, "job-ps", 2, fsync_every=0)
        start = dur.resume.next_round + len(dur.resume.committed) if dur.resume else 0
        for rnd in range(start, start + 2):
            for peer, sha in (("w0", f"a{rnd}"), ("w1", f"b{rnd}"), ("w0", f"c{rnd}")):
                dur.note_fold(mod.FoldRecord(rnd, 0, peer, 2.0 + rnd, sha, f"d-{rnd}-{sha}.st"))
            save_file(_tree(0.5 + rnd), str(momentum))
            up = tmp / f"u-{pkg}-{rnd}.safetensors"
            save_file(_tree(0.25 * (rnd + 1)), str(up))
            catchup.accumulate(up)
            residual = _tree(0.125 * (rnd + 1))
            ef.restore(residual if pkg == "jax" else {k: torch.from_numpy(v)
                                                      for k, v in residual.items()})
            dur.commit_round(rnd, 0, f"wire-{rnd}.safetensors", epoch=rnd + 1,
                             momentum_file=momentum, catchup=catchup, efs={0: ef},
                             active=["w0", "w1"])
            dur.note_notified(rnd, False)
        dur.note_fold(mod.FoldRecord(start + 2, 0, "w1", 3.0, "z", "d-z.st"))
        dur.close()


def _view(dur) -> dict:
    r = dur.resume
    return {"generation": dur.generation, "next_round": r.next_round, "epoch": r.epoch,
            "active": r.active, "catchup_rounds": r.catchup_rounds,
            "committed": r.committed, "notified": r.notified,
            "pending": dur.pending_rounds(0),
            "folds": [(f.peer, f.sha) for f in dur.folds_for(4)],
            "replay": [(f.peer, f.sha, s) for f, s in dur.replay_ops(4)],
            "dedup": [dur.already_folded(4, 0, "w1", "z"), dur.already_folded(4, 0, "w1", "y")]}


def test_durable_state_matches_the_reference(tmp_path):
    roots = {pkg: tmp_path / pkg for pkg in MOD}
    for pkg, root in roots.items():
        _ops(pkg, root, tmp_path)
    assert (roots["port"] / "journal.cbor").read_bytes() == \
        (roots["jax"] / "journal.cbor").read_bytes()
    jmeta = json.loads((roots["jax"] / "ps-state.json").read_text())
    tmeta = json.loads((roots["port"] / "ps-state.json").read_text())
    assert tmeta == jmeta and tmeta["next_round"] == 4 and tmeta["generation"] == 2
    state = tmeta["state_file"]
    jstate, tstate = load_file(str(roots["jax"] / state)), load_file(str(roots["port"] / state))
    assert sorted(tstate) == sorted(jstate)
    assert all(tstate[k].tobytes() == jstate[k].tobytes() for k in jstate)
    # Each package reopens either directory to the same view.
    views = {}
    for opener in MOD:
        for pkg, root in roots.items():
            copy = tmp_path / f"open-{opener}-{pkg}"  # each open appends its gen record
            shutil.copytree(root, copy)
            dur = MOD[opener].DurablePS.open(copy, "job-ps", 2, fsync_every=0)
            views[(opener, pkg)] = _view(dur)
            if opener == "port" and pkg == "jax":
                cat = trejoin.CatchupBuffer()
                dur.restore_catchup(cat)
                assert cat.rounds == 4 and cat.state()[0]["w"].tobytes() == \
                    np.full(8, 2.5, np.float32).tobytes()
                assert dur.restore_efs()[0]["b"].numpy().tobytes() == \
                    np.full(3, -0.5, np.float32).tobytes()
                momentum = tmp_path / "restored.safetensors"
                dur.restore_momentum(momentum)
                assert tload(momentum)["w"].numpy().tobytes() == \
                    np.full(8, 3.5, np.float32).tobytes()
            dur.close()
    first = views[("jax", "jax")]
    assert all(v == first for v in views.values()), views
    assert first["folds"] == [("w1", "z")] and first["dedup"] == [True, False]


def test_generations_are_monotonic_and_a_foreign_job_is_wiped(tmp_path):
    momentum = tmp_path / "m.st"
    save_file(_tree(1.0), str(momentum))
    for pkg in MOD:
        root = tmp_path / pkg
        seen = []
        for rnd in range(3):
            dur = MOD[pkg].DurablePS.open(root, "job", fsync_every=0)
            seen.append(dur.generation)
            dur.note_fold(MOD[pkg].FoldRecord(rnd, 0, "w1", 1.0, f"s{rnd}", f"f{rnd}.st"))
            dur.commit_round(rnd, 0, f"wire-{rnd}.safetensors", epoch=0, momentum_file=momentum)
            dur.close()
        assert seen == [1, 2, 3]
        fresh = MOD[pkg].DurablePS.open(root, "another-job", fsync_every=0)
        assert fresh.resume is None and fresh.generation == 1
        fresh.close()


def test_restart_signal_matches_the_reference():
    cases = [({}, None), ({}, 1), ({"ps_generation": 1}, None), ({"ps_generation": 2}, 1),
             ({"ps_generation": 1}, 1), ({"ps_resync": True}, None),
             ({"ps_generation": 2, "ps_resync": True}, 2)]
    for meta, last in cases:
        assert tdur.restart_signal(meta, last) == jdur.restart_signal(meta, last), (meta, last)
    assert (tdur.GENERATION_KEY, tdur.RESYNC_KEY) == (jdur.GENERATION_KEY, jdur.RESYNC_KEY)


# --------------------------------------------- the executor, killed mid-round

PKG = {"jax": (jmsg, JNode, JMemory, JPS, jaio), "port": (tmsg, TNode, TMemory, TPS, taio)}


def _agg(m, ckpt: Path):
    return m.JobSpec(job_id="agg-dur", executor=m.Executor(
        kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
            updates=m.Receive(m.Reference.from_peers(["w1", "w2"], "updates")),
            results=m.Send(m.Reference.from_peers(["w1", "w2"], "results")),
            optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=2,
            checkpoint_dir=str(ckpt))))


def _delta(peer: str, rnd: int) -> dict:
    rng = np.random.default_rng(100 * int(peer[1]) + rnd)
    return {"w": rng.standard_normal(16).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


def _executor(pkg, node, work):
    PS = PKG[pkg][3]
    return PS(node, work) if pkg == "jax" else PS(node, work, device="cpu")


async def _drain(node, tmp: Path, rnd: int, resyncs: list) -> tuple:
    """Receive pushes until round ``rnd``'s update lands (skipping resyncs
    and re-broadcasts of merged rounds, as a worker does)."""
    while True:
        push = await node.next_push(timeout=20)
        meta = push.resource if isinstance(push.resource, dict) else {}
        dest = tmp / f"u-{node.peer_id}-{len(list(tmp.iterdir()))}.st"
        await push.save_to(dest)
        if meta.get("ps_resync"):
            resyncs.append(meta.get("ps_generation"))
            continue
        if int(meta.get("round", rnd)) < rnd:
            continue
        return meta, dest


async def _job(pkg: str, tmp: Path, kill: bool) -> dict:
    m, Node, Memory, _, aio = PKG[pkg]
    hub = Memory()
    nodes = {p: Node(hub.shared(), peer_id=p) for p in ("ps", "w1", "w2", "sched")}
    for n in nodes.values():
        await n.start()
    for a in nodes.values():
        for b in nodes.values():
            if a is not b:
                a.add_peer_addr(b.peer_id, b.listen_addrs[0])

    async def on_progress(peer, progress):
        kind = m.ProgressResponseKind.DONE if progress.round >= 2 else m.ProgressResponseKind.OK
        return m.ProgressResponse(kind=kind)

    reg = nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
    ckpt = tmp / "ckpt"
    spec = _agg(m, ckpt)
    (tmp / "work1").mkdir()
    execution = await _executor(pkg, nodes["ps"], tmp / "work1").execute("agg-dur", spec, "sched")
    out: dict = {"updates": [], "resyncs": [], "generations": []}
    (tmp / "recv").mkdir()

    async def push(peer: str, rnd: int) -> Path:
        f = tmp / f"d-{peer}-{rnd}.st"
        save_file(_delta(peer, rnd), str(f))
        await aio.retry(lambda: nodes[peer].push(
            "ps", {"resource": "updates", "name": f.name, "round": rnd,
                   "num_samples": 8.0 if peer == "w1" else 4.0}, f), attempts=3, base_delay=0.05)
        return f

    for rnd in range(3):
        f1 = await push("w1", rnd)
        if kill and rnd == 1:
            await asyncio.sleep(0.3)  # the fold and its journal record land
            await execution.cancel()
            (tmp / "work2").mkdir()
            execution = await _executor(pkg, nodes["ps"], tmp / "work2").execute(
                "agg-dur", spec, "sched")
            await nodes["w1"].push("ps", {"resource": "updates", "name": f1.name, "round": 1,
                                          "num_samples": 8.0}, f1)  # the worker's re-send
        await push("w2", rnd)
        meta, u = await _drain(nodes["w1"], tmp / "recv", rnd, out["resyncs"])
        await _drain(nodes["w2"], tmp / "recv", rnd, [])
        out["updates"].append(load_file(str(u)))
        out["generations"].append(meta.get("ps_generation"))
    status = await asyncio.wait_for(execution.wait(), 15)
    out["state"] = status.state
    out["dedup"] = jdur.RoundJournal.read_all(ckpt / "journal.cbor")
    reg.close()
    for n in nodes.values():
        await n.stop()
    return out


def test_a_killed_server_resumes_bit_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)  # the reference's numpy outer step
    dedup_hits = []
    real = tdur.DurablePS.already_folded

    def counted(self, *args):
        hit = real(self, *args)
        dedup_hits.append(hit)
        return hit

    monkeypatch.setattr(tdur.DurablePS, "already_folded", counted)
    runs = {}
    for pkg, kill in (("jax", False), ("port", False), ("port", True)):
        d = tmp_path / f"{pkg}-{kill}"
        d.mkdir()
        runs[(pkg, kill)] = asyncio.run(asyncio.wait_for(_job(pkg, d, kill), 60))
    want = runs[("jax", False)]["updates"]
    for key in (("port", False), ("port", True)):
        got = runs[key]
        assert got["state"] == "completed", key
        for rnd, (a, b) in enumerate(zip(want, got["updates"])):
            assert sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes() for k in a), \
                (key, rnd)
    killed = runs[("port", True)]
    assert killed["resyncs"] == [2] and killed["generations"] == [1, 2, 2]
    assert runs[("port", False)]["generations"] == [1, 1, 1]
    assert dedup_hits.count(True) == 1  # the re-send folded zero more times


def test_a_gapped_journal_fails_the_job_visibly(tmp_path):
    root = tmp_path / "ckpt"
    root.mkdir()
    journal = tdur.RoundJournal(root / "journal.cbor", fsync_every=0)
    journal.append({"t": "gen", "generation": 1, "job_id": "agg-dur"})
    journal.append({"t": "commit", "round": 3, "fragment": 0, "wire": "w", "epoch": 0})
    journal.close()

    async def main():
        node = TNode(TMemory().shared(), peer_id="ps")
        await node.start()
        (tmp_path / "work").mkdir()
        execution = await TPS(node, tmp_path / "work", device="cpu").execute(
            "agg-dur", _agg(tmsg, root), "sched")
        status = await asyncio.wait_for(execution.wait(), 10)
        await node.stop()
        return status

    status = asyncio.run(main())
    assert status.state == "failed" and "journal gap" in (status.message or "")
