"""Port parity: fault tolerance of streaming and sharded DiLoCo.

The durable shard (``ft/durable.py`` with ``owned``, partials in the
journal), the pipelined loop made elastic and durable
(``worker/ps_executor.py``), per-shard catch-ups and stream checkpoints in
the trainer, and the scheduler's per-shard restart, against the JAX
package wherever both can take the same inputs (the JAX servers with
``native._load`` patched to None, as ``tests/test_torch_ps.py`` does), and
``chip_smoke.py``'s ``train_shard_ft`` phase rehearsed on the CPU.
Journals, wires and θ compare bit for bit.
"""

from __future__ import annotations

import asyncio
import shutil
import tempfile
from pathlib import Path

import pytest

import chip_smoke

TINY = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
        "config": {"dtype": "float32"}, "seed": 0}


def test_orchestrated_kill_member_and_kill_shard_on_the_cpu(monkeypatch):
    """``train_shard_ft`` rehearsed on the CPU at tiny widths: stream F=4
    over two durable shards, a group of 3 reduced by ``w0``; ``w2`` killed
    in round 1 and replaced by ``w3`` through one catch-up per shard;
    ``psw1`` killed after the rejoin and restarted alone while ``psw0``
    closes round 2; held to ``shard_ft_problems``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # six processes share the CPU
    root = Path(tempfile.mkdtemp(prefix="tsf"))
    try:
        run = asyncio.run(asyncio.wait_for(chip_smoke.run_shard_ft_job(
            root, TINY, device="cpu", rounds=6, steps=3, batch=2, seq=16, period=64, lr=3e-3,
            deadline_s=30.0, limit_s=60, auction_timeout=1.0, status_timeout=60.0), 240))
        rep = chip_smoke.shard_ft_report(run)
        problems = chip_smoke.shard_ft_problems(run, rep, rounds=6, layers=2, device="cpu")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert problems == [], (problems, run["logs"]["ps"][-40:])
    assert run["result"].ft["departed"] == ["w2"] and run["result"].ft["rejoins"] == 1
    assert run["result"].ft["ps_restarts"] == 1
    # One catch-up per shard, each at its own next round; w3 entered at
    # the least of them and pushed every round from there.
    assert sorted((c["shard"], c["round"]) for c in rep["catchups"]) == [(0, 2), (1, 3)]
    assert rep["trainers"]["w3"]["rejoin"]["round"] == 2
    w3_rounds = sorted({d["round"] for d in run["rec"]["deltas"] if d["from"] == "w3"})
    assert w3_rounds == [2, 3, 4, 5]
    # Each shard journals under its own root; psw0 never restarted.
    assert set(rep["journal_by_root"]) == {"ps0", "ps1"}
    assert {w["generation"] for w in rep["wires"] if w["root"] == "ps0"} == {1}
    assert rep["shard_kill_to_gen2_broadcast_s"] > 0 and rep["replay"]["s"] >= 0


# ----------------------------------------------------------- the servers

import numpy as np  # noqa: E402
from safetensors.numpy import load_file, save_file  # noqa: E402

from hypha_tpu import native  # noqa: E402
from hypha_tpu.ft import durable as jdur  # noqa: E402
from hypha_tpu_torch.ft import durable as tdur  # noqa: E402
from test_torch_shard import PKG, _agg, _FakeConsumer, _FakePush, _mesh, _ps, _run  # noqa: E402

DUR = {"jax": jdur, "port": tdur}


@pytest.fixture(autouse=True)
def _numpy_outer_step(monkeypatch):
    """The JAX servers' numpy outer step (the port's arithmetic)."""
    monkeypatch.setattr(native, "_load", lambda: None)


def _tree(seed: int, names) -> dict:
    rng = np.random.default_rng(seed)
    sizes = {"a": 8, "b": 4, "c": 8, "d": 4}
    return {n: (rng.standard_normal(sizes[n]) * 0.1).astype(np.float32) for n in names}


async def _next_update(node, root: Path, want: int, seen: dict) -> tuple:
    """The first broadcast of round ``want`` (resyncs and older rounds
    skipped, later ones kept for their turn): (header, file bytes)."""
    while want not in seen:
        push = await node.next_push(timeout=30)
        meta = dict(push.resource)
        dest = root / f"in-{len(seen)}-{meta.get('round')}.bin"
        await push.save_to(dest)
        if meta.get("ps_resync"):
            continue
        seen.setdefault(int(meta.get("round", -1)), (meta, dest.read_bytes()))
    return seen[want]


def _stream_kill_run(pkg, root: Path, kill: bool) -> list:
    """Stream F=2 over two durable shards (shard 0 the even rounds, shard 1
    the odd), one worker; with ``kill`` shard 1 is cancelled after round 1
    and restarted after shard 0 closed round 2."""
    from hypha_tpu.stream import partition_names, shard_of

    frags = partition_names({"a": 8, "b": 4, "c": 8, "d": 4}, 2)

    async def main():
        nodes = await _mesh(pkg, ["ps0", "ps1", "w1", "sched"])

        async def on_progress(peer, p):
            done = p.round >= 2  # each shard's last round: 2 and 3
            return pkg.m.ProgressResponse(kind=pkg.m.ProgressResponseKind.DONE if done
                                          else pkg.m.ProgressResponseKind.OK)

        nodes["sched"].on(pkg.m.PROTOCOL_PROGRESS, pkg.m.Progress).respond_with(on_progress)

        def spec(k):
            return _agg(pkg.m, f"agg-k{k}", ["w1"], f"u.s{k}", sync_mode="stream", fragments=2,
                        shard_index=k, num_ps_shards=2, checkpoint_dir=str(root / f"ck{k}"))

        execs = {k: await _ps(pkg, nodes[f"ps{k}"], root / f"work{k}").execute(
            f"agg-k{k}", spec(k), "sched") for k in (0, 1)}
        seen: dict = {}
        out = []
        for r in range(4):
            f = r % 2
            owner = shard_of(f, 2)
            path = root / f"d{r}.st"
            save_file(_tree(r, frags[f]), str(path))
            if kill and r == 3:
                execs[1] = await _ps(pkg, nodes["ps1"], root / "work1b").execute(
                    "agg-k1", spec(1), "sched")
            await nodes["w1"].push(f"ps{owner}", {
                "resource": f"u.s{owner}", "name": path.name, "round": r, "num_samples": 8.0,
                "shard": owner, "fragment_id": f, "fragments": 2}, path)
            meta, data = await _next_update(nodes["w1"], root, r, seen)
            assert int(meta["shard"]) == owner
            out.append(data)
            if kill and r == 1:
                await execs[1].cancel()  # shard 0 closes round 2 during the outage
        for k in (0, 1):
            status = await asyncio.wait_for(execs[k].wait(), 30)
            assert status.state == "completed", (k, status.message)
        for n in nodes.values():
            await n.stop()
        return out

    return _run(main(), timeout=120)


def test_stream_kill_one_shard_recovers_bit_exact_others_progress(tmp_path):
    """Reference ``tests/test_shard.py:609``: the killed and restarted shard
    resumes from its own journal while the other closes its round; every
    update equals the run without a kill, in both packages, and the
    packages agree."""
    runs = {}
    for name, pkg in PKG.items():
        for kill in (False, True):
            root = tmp_path / f"{name}-{kill}"
            root.mkdir()
            runs[(name, kill)] = _stream_kill_run(pkg, root, kill)
    base = runs[("jax", False)]
    assert len(base) == 4
    for key, updates in runs.items():
        for r, (got, want) in enumerate(zip(updates, base)):
            assert load_file_bytes(got) == load_file_bytes(want), (key, r)


def load_file_bytes(data: bytes) -> dict:
    """A broadcast's tensors as bytes, by name (the headers may differ in a
    generation stamp)."""
    path = Path(tempfile.mkstemp()[1])
    try:
        path.write_bytes(data)
        return {k: v.tobytes() for k, v in load_file(str(path)).items()}
    finally:
        path.unlink()


@pytest.mark.parametrize("name", ["jax", "port"])
def test_per_shard_journals_are_isolated(tmp_path, name):
    """Reference ``tests/test_shard.py:745``: re-opening one shard's root
    bumps only that shard's generation."""
    D = DUR[name]
    d0 = D.DurablePS.open(tmp_path / "ps0", "job", owned=lambda r: r % 2 == 0)
    d1 = D.DurablePS.open(tmp_path / "ps1", "job", owned=lambda r: r % 2 == 1)
    assert d0.generation == d1.generation == 1
    d0.note_fold(D.FoldRecord(0, 0, "w1", 8.0, "sha-a", "fa.st"))
    d1.note_fold(D.FoldRecord(1, 1, "w1", 8.0, "sha-b", "fb.st"))
    d0.close()
    d1.close()
    d1b = D.DurablePS.open(tmp_path / "ps1", "job", owned=lambda r: r % 2 == 1)
    assert d1b.generation == 2
    assert [f.peer for f in d1b.folds_for(1)] == ["w1"] and d1b.folds_for(0) == []
    d1b.close()
    d0b = D.DurablePS.open(tmp_path / "ps0", "job", owned=lambda r: r % 2 == 0)
    assert d0b.generation == 2
    d0b.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "port"), ("port", "jax")])
def test_owned_gating_skips_unowned_rounds(tmp_path, writer, reader):
    """Reference ``tests/test_shard.py:767``: a stream shard's journal
    commits only its owned rounds, and the resume's contiguity check reads
    the gaps as the other shard's (a journal either package wrote, read by
    either); without ``owned`` the gap is journal loss."""
    W, R = DUR[writer], DUR[reader]
    root = tmp_path / "ps1"
    dur = W.DurablePS.open(root, "job", ckpt_every=100, owned=lambda r: r % 2 == 1)
    for rnd in (1, 3):
        wire = root / f"w{rnd}.st"
        save_file({"w": np.ones(2, np.float32)}, str(wire))
        dur.commit_round(rnd, rnd % 2, dur.store_wire(rnd, wire), epoch=0,
                         momentum_file=root / "momentum.st")
    dur.close()
    again = R.DurablePS.open(root, "job", ckpt_every=100, owned=lambda r: r % 2 == 1)
    assert [int(r["round"]) for r in again.resume.committed] == [1, 3]
    again.close()
    with pytest.raises(ValueError, match="journal gap"):
        R.DurablePS.open(root, "job", ckpt_every=100)


def _cover_journal_pushes():
    """A failed-over direct delta of w1, the reducer's partial covering w1
    and w2 (so w1's direct one is un-folded), then w3's delta."""
    w = {p: {"w": np.full(4, v, np.float32)} for p, v in (("w1", 1.0), ("w2", 3.0),
                                                          ("w3", -2.0))}
    part = {"w": np.float32(4.0) * w["w1"]["w"] + np.float32(4.0) * w["w2"]["w"]}

    def head(peer, samples, **extra):
        return {"resource": "u", "name": f"x-{peer}", "round": 0, "num_samples": samples, **extra}

    return [_FakePush("w1", head("w1", 4.0), w["w1"]),
            _FakePush("red", head("red", 8.0, prefold=True, covers=["w1", "w2"]), part),
            _FakePush("w3", head("w3", 4.0), w["w3"])]


def test_reference_journal_replays_to_the_same_update_in_the_port(tmp_path):
    """Reference ``tests/test_shard.py:1238``, across packages: the JAX
    durable server journals a round holding a failed-over direct delta and
    the partial that covers it; the port's ``DurablePS`` reads that journal
    into the same ``replay_ops``, and the port's replayed outer step writes
    the update the JAX replay writes, byte for byte."""
    from hypha_tpu.stream.accum import RoundAccum as JAccum
    from hypha_tpu_torch.stream.accum import RoundAccum as TAccum
    from hypha_tpu_torch.worker.ps_executor import outer_step

    (tmp_path / "w").mkdir()
    jdurable = jdur.DurablePS.open(tmp_path / "dur", "job")
    jdurable.note_open(0)
    accum = JAccum()
    received = _run(_ps(PKG["jax"], None, tmp_path / "w")._collect_round(
        _FakeConsumer(_cover_journal_pushes()), "job", set(), 3, tmp_path / "w", 0,
        accum=accum, dur=jdurable))
    assert sorted(received) == ["prefold:red", "w3"]
    jdurable.close()
    readers = {"jax": jdur.DurablePS.open(tmp_path / "dur", "job"),
               "port": tdur.DurablePS.open(tmp_path / "dur", "job")}
    ops = {k: [(f.peer, f.prefold, sorted(f.covers), f.file, s) for f, s in d.replay_ops(0)]
           for k, d in readers.items()}
    assert ops["port"] == ops["jax"]
    assert [(p, s) for p, _, _, _, s in ops["port"]] == [
        ("w1", 1.0), ("w1", -1.0), ("prefold:red", 1.0), ("w3", 1.0)]
    jacc, tacc = JAccum(), TAccum(device="cpu")
    for fold, sign in readers["jax"].replay_ops(0):
        jacc.fold(readers["jax"].deltas_dir / fold.file, fold.samples, sign, fold.prefold)
        tacc.fold(readers["port"].deltas_dir / fold.file, fold.samples, sign, fold.prefold)
    (tmp_path / "jo").mkdir()
    (tmp_path / "to").mkdir()
    jps = _ps(PKG["jax"], None, tmp_path / "jo")
    jupd = jps._outer_step({}, tmp_path / "jo" / "m.st", 0.7, 0.9, tmp_path / "jo", 0, jacc)
    tupd = outer_step({}, tmp_path / "to" / "m.st", 0.7, 0.9, tmp_path / "to", 0, accum=tacc,
                      device="cpu")
    assert load_file_bytes(Path(tupd).read_bytes()) == load_file_bytes(Path(jupd).read_bytes())
    for d in readers.values():
        d.close()


@pytest.mark.parametrize("name", ["jax", "port"])
def test_notify_membership_fails_joined_while_a_shard_restarts(name):
    """Reference ``tests/test_shard.py:1402``: a JOINED update fails while a
    shard handle is mid-restart (the rejoiner would wait on that shard's
    catch-up forever); the live shard still gets it, and a plain update
    succeeds."""
    import types

    Orch = PKG[name].orch.Orchestrator
    sent = []

    class _Node:
        peer_id = "sched"

        async def request(self, peer, proto, msg, timeout=None):
            sent.append((peer, msg.job_id))

    stub = types.SimpleNamespace(node=_Node())
    ctx = types.SimpleNamespace(
        membership=types.SimpleNamespace(snapshot=lambda: types.SimpleNamespace(epoch=1)),
        ps_handles=[types.SimpleNamespace(peer_id="psA"), None], ps_job_ids=["j-ps0", "j-ps1"])
    assert _run(Orch._notify_membership(stub, ctx, joined=["w9"])) is False
    assert sent == [("psA", "j-ps0")]
    sent.clear()
    assert _run(Orch._notify_membership(stub, ctx, joined=None)) is True


def _stream_crash_run(pkg, root: Path) -> list:
    """Reference ``tests/test_durable.py:510``: stream F=2, one worker; the
    server is killed with round 2's delta journaled and restarted; the
    worker re-sends it (deduplicated). Returns every round's update."""
    F, rounds = 2, 4
    frag = {0: ("a",), 1: ("b",)}

    async def main():
        nodes = await _mesh(pkg, ["ps", "w1", "sched"])

        async def on_progress(peer, p):
            done = p.round >= rounds - 1
            return pkg.m.ProgressResponse(kind=pkg.m.ProgressResponseKind.DONE if done
                                          else pkg.m.ProgressResponseKind.OK)

        nodes["sched"].on(pkg.m.PROTOCOL_PROGRESS, pkg.m.Progress).respond_with(on_progress)
        spec = _agg(pkg.m, "agg-s", ["w1"], "u", sync_mode="stream", fragments=F,
                    checkpoint_dir=str(root / "ck"))
        execution = await _ps(pkg, nodes["ps"], root / "a").execute("agg-s", spec, "sched")
        seen: dict = {}

        async def push(r):
            path = root / f"d{r}.st"
            if not path.exists():
                save_file(_tree(r, frag[r % F]), str(path))
            await nodes["w1"].push("ps", {"resource": "u", "name": path.name, "round": r,
                                          "num_samples": 4.0, "fragment_id": r % F,
                                          "fragments": F}, path)

        out = []
        for r in range(rounds):
            await push(r)
            if r == 2:
                await asyncio.sleep(0.4)
                await execution.cancel()
                execution = await _ps(pkg, nodes["ps"], root / "b").execute("agg-s", spec,
                                                                           "sched")
                await push(2)  # the re-send the resync triggers: a dedup hit
            out.append((await _next_update(nodes["w1"], root, r, seen))[1])
        status = await asyncio.wait_for(execution.wait(), 30)
        assert status.state == "completed", status.message
        for n in nodes.values():
            await n.stop()
        return out

    return _run(main(), timeout=120)


def test_stream_crash_recovery_completes_every_fragment(tmp_path):
    out = {}
    for name, pkg in PKG.items():
        (tmp_path / name).mkdir()
        out[name] = _stream_crash_run(pkg, tmp_path / name)
    assert len(out["port"]) == len(out["jax"]) == 4
    for r, (got, want) in enumerate(zip(out["port"], out["jax"])):
        assert load_file_bytes(got) == load_file_bytes(want), r


def _stale_resend_run(pkg, root: Path) -> bytes:
    """Reference ``tests/test_durable.py:623``: a plain durable server killed
    after round 0's commit; after the restart both workers re-send round
    0's delta (stale: dropped), then round 1's. Returns round 1's update."""
    async def main():
        nodes = await _mesh(pkg, ["ps", "w1", "w2", "sched"])

        async def on_progress(peer, p):
            return pkg.m.ProgressResponse(kind=pkg.m.ProgressResponseKind.DONE if p.round >= 1
                                          else pkg.m.ProgressResponseKind.OK)

        nodes["sched"].on(pkg.m.PROTOCOL_PROGRESS, pkg.m.Progress).respond_with(on_progress)
        spec = _agg(pkg.m, "agg-st", ["w1", "w2"], "u", checkpoint_dir=str(root / "ck"))
        execution = await _ps(pkg, nodes["ps"], root / "a").execute("agg-st", spec, "sched")

        async def push(w, r):
            path = root / f"{w}-{r}.st"
            if not path.exists():
                save_file(_tree(10 * r + int(w[1]), ("a", "b")), str(path))
            await nodes[w].push("ps", {"resource": "u", "name": path.name, "round": r,
                                       "num_samples": 8.0 if w == "w1" else 4.0}, path)

        seen: dict = {}
        await push("w1", 0)
        await push("w2", 0)
        await _next_update(nodes["w1"], root, 0, seen)
        await asyncio.sleep(0.2)
        await execution.cancel()
        execution = await _ps(pkg, nodes["ps"], root / "b").execute("agg-st", spec, "sched")
        for w in ("w1", "w2"):
            await push(w, 0)
        for w in ("w1", "w2"):
            await push(w, 1)
        _, data = await _next_update(nodes["w1"], root, 1, seen)
        status = await asyncio.wait_for(execution.wait(), 30)
        assert status.state == "completed", status.message
        for n in nodes.values():
            await n.stop()
        return data

    return _run(main(), timeout=90)


def test_recovered_server_drops_a_stale_plain_resend(tmp_path):
    out = {}
    for name, pkg in PKG.items():
        (tmp_path / name).mkdir()
        out[name] = _stale_resend_run(pkg, tmp_path / name)
    assert load_file_bytes(out["port"]) == load_file_bytes(out["jax"])


def _elastic_stream_run(pkg, root: Path) -> list:
    """Reference ``tests/test_stream.py:696``: elastic stream F=2, two
    workers; w2 dies after round 0 and rounds 1-2 close at quorum once the
    0.4 s deadline passes."""
    async def main():
        nodes = await _mesh(pkg, ["ps", "w1", "w2", "sched"])

        async def on_progress(peer, p):
            return pkg.m.ProgressResponse(kind=pkg.m.ProgressResponseKind.DONE if p.round >= 2
                                          else pkg.m.ProgressResponseKind.OK)

        nodes["sched"].on(pkg.m.PROTOCOL_PROGRESS, pkg.m.Progress).respond_with(on_progress)
        spec = _agg(pkg.m, "agg-c", ["w1", "w2"], "u", sync_mode="stream", fragments=2,
                    quorum_fraction=0.5, round_deadline_s=0.4)
        execution = await _ps(pkg, nodes["ps"], root / "a").execute("agg-c", spec, "sched")

        async def ship(node, r):
            path = root / f"{node.peer_id}-{r}.st"
            save_file(_tree(r + 7 * int(node.peer_id[1]), ("a",) if r % 2 == 0 else ("b",)),
                      str(path))
            await node.push("ps", {"resource": "u", "name": path.name, "round": r,
                                   "num_samples": 5.0, "fragment_id": r % 2, "fragments": 2},
                            path)

        seen: dict = {}
        await asyncio.gather(ship(nodes["w1"], 0), ship(nodes["w2"], 0))
        out = [(await _next_update(nodes["w1"], root, 0, seen))[1]]
        await nodes["w2"].stop()
        t0 = asyncio.get_running_loop().time()
        for r in (1, 2):
            await ship(nodes["w1"], r)
            out.append((await _next_update(nodes["w1"], root, r, seen))[1])
        waited = asyncio.get_running_loop().time() - t0
        status = await asyncio.wait_for(execution.wait(), 15)
        assert status.state == "completed", status.message
        for name in ("ps", "w1", "sched"):
            await nodes[name].stop()
        return out, waited

    return _run(main(), timeout=60)


def test_elastic_stream_round_closes_at_quorum_past_the_deadline(tmp_path):
    out = {}
    for name, pkg in PKG.items():
        (tmp_path / name).mkdir()
        out[name] = _elastic_stream_run(pkg, tmp_path / name)
    (jupd, _), (tupd, waited) = out["jax"], out["port"]
    assert waited >= 0.4  # round 2 opens after t0 and is held to the 0.4 s deadline
    for r, (got, want) in enumerate(zip(tupd, jupd)):
        assert load_file_bytes(got) == load_file_bytes(want), r


# ----------------------------------------------------------- the trainer

import contextlib  # noqa: E402
import queue  # noqa: E402
import threading  # noqa: E402

from hypha_tpu import compress as jcompress  # noqa: E402
from hypha_tpu import messages as jmsg  # noqa: E402
from hypha_tpu_torch import messages as tmsg  # noqa: E402
from test_torch_training import LR, _port_spec, _spec  # noqa: E402


class _FTSession:
    """A scheduler and parameter server (or shards) behind the bridge API,
    in ``msgs``' types: a round every ``per_round`` batches, every pushed
    delta or part answered with update = 0.7 · Δ echoing its tags, and
    ``catchups`` queued ahead of everything (a rejoiner's)."""

    def __init__(self, work_dir: Path, msgs, weights: Path, rounds: int, per_round: int = 2,
                 catchups=()):
        self.dir, self.m, self.weights = Path(work_dir), msgs, weights
        self.rounds, self.per_round = rounds, per_round
        self.done = self.batches = 0
        self.scheduled = False
        self.events: "queue.Queue[dict]" = queue.Queue()
        self.pushed: list = []
        self.lock = threading.Lock()
        (self.dir / "incoming").mkdir(parents=True, exist_ok=True)
        for event in catchups:
            self.events.put(event)

    def fetch(self, ref):
        if ref.ref.uri == "file:///weights":
            return [str(self.weights.relative_to(self.dir))]
        path = self.dir / "artifacts" / "slice.safetensors"
        if not path.exists():
            path.parent.mkdir(exist_ok=True)
            ids = np.random.default_rng(42).integers(0, 64, (16, 16)).astype(np.int32)
            save_file({"input_ids": ids}, str(path))
        return ["artifacts/slice.safetensors"]

    def send_status(self, progress):
        K, R, RK = self.m.ProgressKind, self.m.ProgressResponse, self.m.ProgressResponseKind
        with self.lock:
            if progress.kind == K.STATUS:
                if self.done >= self.rounds:
                    return R(kind=RK.DONE)
                self.batches += 1
                if not self.scheduled and self.batches >= self.per_round:
                    self.scheduled = True
                    return R(kind=RK.SCHEDULE_UPDATE, counter=0)
                return R(kind=RK.CONTINUE)
            if progress.kind == K.UPDATE_RECEIVED:
                self.done += 1
                self.batches, self.scheduled = 0, False
                return R(kind=RK.DONE if self.done >= self.rounds else RK.CONTINUE)
            return R(kind=RK.OK)

    def send_resource(self, send, path, resource="updates", meta=None):
        meta = dict(meta or {})
        self.pushed.append(meta)
        delta = jcompress.read_delta(self.dir / path)
        update = {k: np.float32(0.7) * np.asarray(v, np.float32) for k, v in delta.items()}
        rnd = int(meta.get("round", self.done))
        out = self.dir / "incoming" / f"u-{rnd}-{meta.get('fragment_id', 'x')}.safetensors"
        save_file(update, str(out))
        event = {k: meta[k] for k in ("fragment_id", "fragments", "shard") if k in meta}
        self.events.put({"path": f"incoming/{out.name}", "meta": {"round": rnd, **event}})

    def receive(self, receive):
        def gen():
            while True:
                try:
                    yield self.events.get(timeout=30)
                except queue.Empty:
                    return

        return contextlib.nullcontext(gen())


@pytest.fixture
def weights(tmp_path):
    from _torch_parity import tiny_pair
    from hypha_tpu.executor.serialization import flatten_tree

    _, variables, _ = tiny_pair("llama", seed=7)
    path = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(path))
    return path


def _catchups(tmp_path: Path, theta0: dict, shards: int, rounds: list) -> tuple:
    """Each shard's catch-up file (Σ over every other name from its own
    offset) and the union of their Σ."""
    rng = np.random.default_rng(11)
    names = sorted(theta0)
    events, union = [], {}
    (tmp_path / "incoming").mkdir(exist_ok=True)
    for k in range(shards):
        cum = {n: (rng.standard_normal(theta0[n].shape) * 1e-2).astype(np.float32)
               for n in names[k::shards]}
        union.update(cum)
        save_file(cum, str(tmp_path / "incoming" / f"catchup-{k}.safetensors"))
        meta = {"catchup": True, "round": rounds[k], "epoch": 3}
        if shards > 1:
            meta["shard"] = k
        events.append({"path": f"incoming/catchup-{k}.safetensors", "meta": meta})
    return events, union


_SHARDS = jmsg.ShardMap(round=0, shards=["ps0", "ps1"], tags=["u.s0", "u.s1"], fragments=2)
# Each trainer option that used to be refused with a streaming sync mode or
# a placement (the cases of tests/test_torch_training.py's refusal test
# they replace), and what it does now.
LIFTED_TRAINER = {
    "stream checkpoint": {"checkpoint": "every 1", "sync_mode": "stream", "fragments": 2},
    "overlap rejoin": {"rejoin": True, "sync_mode": "overlap"},
    "group member rejoin": {"reduce_via": "red", "ps_shards": _SHARDS, "rejoin": True,
                            "sync_mode": "stream", "fragments": 2},
    "sharded checkpoint": {"ps_shards": _SHARDS, "checkpoint": "every 1"},
    "reducer rejoin": {"reduce_members": ["w1"], "ps_shards": _SHARDS, "rejoin": True},
}


@pytest.mark.parametrize("case", sorted(LIFTED_TRAINER))
def test_lifted_trainer_option_runs(tmp_path, weights, case, monkeypatch):
    """A checkpoint under a stream or a placement is the reference's: the
    reference reads the port's manifest and params, and they hold the
    rounds and (within the training parity bound) the values the JAX
    trainer's hold for the same session. A rejoin under overlap or a
    placement merges one catch-up per shard into θ₀: bit-equal to the
    reference's ``merge_catchup_arrays`` over their union, entering at the
    least of the shards' rounds under stream and the greatest otherwise."""
    from hypha_tpu.executor import checkpoint as jckpt
    from hypha_tpu.executor.serialization import load_flat
    from hypha_tpu.executor.training import run_training as jax_run
    from hypha_tpu.ft.rejoin import merge_catchup_arrays
    import hypha_tpu_torch.executor.training as ttr

    over = dict(LIFTED_TRAINER[case])
    theta0 = load_file(str(weights))
    # Each flight merges before the next step in both trainers, so they
    # take the same steps (the zero-flight limit of the stream tests).
    monkeypatch.setenv("HYPHA_STREAM_POLL_WAIT", "30")
    if over.get("checkpoint"):
        out = {}
        for name in ("jax", "port"):
            ckpt = tmp_path / f"ckpt-{name}"
            spec = _spec(**{**over, "checkpoint": {"dir": str(ckpt), "every_rounds": 1}})
            session = _FTSession(tmp_path, jmsg if name == "jax" else tmsg, weights, rounds=2)
            if name == "jax":
                jax_run(session, tmp_path, spec)
            else:
                ttr.run_training(session, tmp_path, _port_spec(spec), device="cpu")
            manifest = jckpt.latest_manifest(ckpt)
            version = ckpt / (ckpt / "LATEST").read_text()
            out[name] = (manifest, load_flat(version / "params.safetensors"), session.pushed)
        (jm, jparams, jpushed), (tm, tparams, tpushed) = out["jax"], out["port"]
        assert tm == jm and tm["round"] == 2
        assert [{k: p.get(k) for k in ("round", "fragment_id", "shard")} for p in tpushed] == \
            [{k: p.get(k) for k in ("round", "fragment_id", "shard")} for p in jpushed]
        assert sorted(tparams) == sorted(jparams) == sorted(theta0)
        for n, want in jparams.items():
            assert tparams[n].shape == want.shape and np.abs(tparams[n] - want).max() <= 0.1 * LR
        return
    shards = 2 if over.get("ps_shards") else 1
    rounds = [4, 3] if shards > 1 and over.get("sync_mode") == "stream" else [3, 3][:shards]
    events, union = _catchups(tmp_path, theta0, shards, rounds)
    session = _FTSession(tmp_path, tmsg, weights, rounds=1, catchups=events)
    grabbed: dict = {}
    real = ttr.theta_checksum

    def grab(params):
        grabbed.setdefault("theta", {k: v.detach().clone() for k, v in params.items()})
        return real(params)

    ttr.theta_checksum = grab
    try:
        result = ttr.run_training(session, tmp_path, _port_spec(_spec(**over)), device="cpu")
    finally:
        ttr.theta_checksum = real
    want = merge_catchup_arrays(theta0, union)
    assert sorted(grabbed["theta"]) == sorted(want)
    for n, value in want.items():
        assert grabbed["theta"][n].numpy().tobytes() == value.tobytes(), n
    entered = min(rounds) if over.get("sync_mode") == "stream" else max(rounds)
    assert result.rounds == entered + 1
    assert {int(p["round"]) for p in session.pushed} == {entered}


# ------------------------------------------------------ a mixed-package job


def test_mixed_workers_survive_a_shard_restart(tmp_path):
    """A JAX worker (the group's reducer) and a torch worker share a
    fault-tolerant blocking job with the port's scheduler and two durable
    port shards; shard 1's host is killed once its round-0 update went out
    and a new node under its peer id takes the re-dispatched job. No full
    restart: every round closes on both shards with finite losses from
    both workers, and shard 1 broadcasts again as generation 2."""
    from _torch_parity import tiny_pair
    from hypha_tpu.executor.serialization import flatten_tree
    from hypha_tpu.resources import Resources as JR
    from hypha_tpu.network import TcpTransport as JTcp
    from hypha_tpu.scheduler import job_config as jjob
    from hypha_tpu.worker.arbiter import OfferConfig as JOfferConfig
    from hypha_tpu.worker.runtime import WorkerNode as JWorkerNode
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.ft.membership import FTConfig
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.network import Node, TcpTransport
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.metrics_bridge import CallbackConnector
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as TPS
    from hypha_tpu_torch.worker.runtime import WorkerNode

    rounds, seq, vocab = 3, 16, 256
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
    root = Path(tempfile.mkdtemp(prefix="wf"))  # bridge sockets: paths under 108 bytes
    job = tmsg.decode(jmsg.encode(jjob.DiLoCoJob(
        model=model, dataset="counting",
        rounds=jjob.DiLoCoRounds(update_rounds=rounds, avg_samples_between_updates=8,
                                 max_batch_size=2),
        inner_optimizer=jmsg.Adam(lr=3e-3), outer_optimizer=jmsg.Nesterov(lr=0.7, momentum=0.9),
        resources=jjob.JobResources(
            num_workers=2, worker=JR(gpu=1.0, cpu=1.0, memory=10),
            parameter_server=JR(cpu=1.0, memory=10),
            worker_price=jmsg.PriceRange(bid=1.0, max=10.0),
            parameter_server_price=jmsg.PriceRange(bid=1.0, max=10.0)),
        num_ps_shards=2, reduce_group_size=2, delta_codec="int8",
        checkpoint_dir=str(root / "ckpt"))))
    job.ft = FTConfig(quorum_fraction=0.5, ps_restart_attempts=1, ps_restart_backoff_s=0.5)
    tracked: list = []
    bcasts: list = []
    real = TPS._broadcast

    async def noted(self, cfg, update_path, round_num, *args, **kw):
        header = kw.get("extra_header") or {}
        bcasts.append((round_num, header.get("shard"), header.get("ps_generation"),
                       bool(header.get("ps_resync")), self.node.peer_id))
        return await real(self, cfg, update_path, round_num, *args, **kw)

    async def main():
        gw = Gateway(TcpTransport(), peer_id="gw")
        await gw.start(["127.0.0.1:0"])
        boot = [gw.node.listen_addrs[0]]

        def shard_host(name, work):
            return WorkerNode(TcpTransport(), resources=Resources(cpu=2, memory=200),
                              device="cpu", peer_id=name, bootstrap=boot, work_root=root / work)

        hosts = {"psw0": shard_host("psw0", "p0"), "psw1": shard_host("psw1", "p1")}
        parts = [DataNode(TcpTransport(), {"counting": data_dir}, peer_id="data", bootstrap=boot),
                 JWorkerNode(JTcp(), resources=JR(gpu=2, cpu=8, memory=1000), peer_id="a-jax",
                             offer=JOfferConfig(strategy="whole"), bootstrap=boot,
                             work_root=root / "j"),
                 WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="b-torch", offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root / "t"),
                 *hosts.values()]
        sched = Node(TcpTransport(), peer_id="sched", bootstrap=boot)
        started = []

        held: list = []
        revived_up = asyncio.Event()

        def shard1_host():  # the auction places the shards
            return next((h for _, s, _, _, h in bcasts if s == 1), None)

        def hold_round1(node):
            """Round-1 pushes to shard 1's host wait until its new node is up,
            so the kill lands between its rounds, never mid-broadcast."""
            push = node.push

            async def gated(peer_id, resource, source):
                r = resource if isinstance(resource, dict) else {}
                if r.get("round") == 1:
                    held.append((node.peer_id, peer_id))
                    if peer_id == shard1_host():
                        await revived_up.wait()
                return await push(peer_id, resource, source)

            node.push = gated

        async def chaos():
            # Both workers merged round 0 (each pushes round 1 after its
            # merge): the reducer holds a push for psw1, the member pushed.
            while not ({"a-jax", "b-torch"} <= {w for w, _ in held}
                       and ("a-jax", shard1_host()) in held):
                await asyncio.sleep(0.05)
            victim = hosts[shard1_host()]
            await victim.node.stop()
            await victim.stop()
            await asyncio.sleep(1.0)
            revived = shard_host(victim.peer_id, "p1b")
            await revived.start(["127.0.0.1:0"])
            started.append(revived)
            revived_up.set()

        try:
            for part in (*parts, sched):
                await part.start(["127.0.0.1:0"])
                started.append(part)
            await sched.wait_for_bootstrap()
            for worker in parts[1:3]:
                hold_round1(worker.node)
            orch = Orchestrator(sched, metrics_connector=CallbackConnector(
                lambda w, r, n, v: tracked.append((w, r, n, v))))
            killer = asyncio.create_task(chaos())
            result = await orch.run(job, auction_timeout=1.5)
            await killer
            return result
        finally:
            for part in reversed(started):
                try:
                    await part.stop()
                except Exception:
                    pass
            await gw.stop()

    TPS._broadcast = noted
    try:
        result = asyncio.run(asyncio.wait_for(main(), 240))
    finally:
        TPS._broadcast = real
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == rounds and result.attempt == 0
    assert result.ft["ps_restarts"] == 1
    losses = {(w, r): v for w, r, n, v in tracked if n == "loss"}
    assert set(losses) == {(w, r) for w in ("a-jax", "b-torch") for r in range(rounds)}, losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    updates = {(r, s, g) for r, s, g, resync, _ in bcasts if not resync}
    assert {(r, s) for r, s, _ in updates} == {(r, s) for r in range(rounds) for s in (0, 1)}
    assert any(s == 1 and g == 2 for _, s, g in updates)
    assert all(g == 1 for _, s, g in updates if s == 0)
