"""Port parity: scheduler crash recovery (``hypha_tpu_torch/ft/durable.py``
``DurableScheduler``, the generation stamping and ``adopt_round`` of
``scheduler/batch_scheduler.py``, the adoption path of
``scheduler/orchestrator.py``, the parked notify of
``worker/ps_executor.py``) against ``hypha_tpu`` (the cases of the
reference's ``tests/test_sched_recovery.py``, each run in both packages).

1. The scheduler journal: the same records give the same bytes in both
   packages and each reads the other's; a rejoin's dispatch supersedes; a
   torn tail reads as the end; garbage resumes nothing; compaction keeps
   the journal bounded; generations rise monotonically and ``complete``
   wipes the journal.
2. Stamped responses: a never-restarted scheduler answers with the
   reference's bytes (no generation, no round); a restarted one stamps
   both, byte-equal to the JAX scheduler; the zombie rules; the worker's
   duplicate-schedule and stale-generation rules; ``adopt_round`` from the
   same acks; the straggler controller's warmup and the link table's
   snapshot after a restart; the off path's wire.
3. The hello: the adoption deadline on a fake clock; both arbiters adopt a
   running execution and re-arm its lease, refuse a stale generation and
   answer ``gone`` for an unknown job; the adoption grace defers the lease
   prune and then cancels.
4. Grace and parking: the parameter server's notify fails twice, the round
   broadcasts first, and the update bytes equal the JAX server's; a stale
   generation's reply is retried; a journal without a plan cannot be
   adopted.
5. End to end: a tiny-Llama job whose scheduler is killed mid-job and
   restarted under its peer id, with a JAX and a torch worker, under the
   port's scheduler (a JAX parameter server) and under the JAX scheduler (a
   torch parameter server): the final server state equals a run without
   the kill, byte for byte, nothing is re-dispatched and every live
   execution is adopted.
"""

from __future__ import annotations

import asyncio
import json
import shutil
import struct
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
from safetensors.numpy import load_file, save_file

from hypha_tpu import messages as jmsg
from hypha_tpu import native
from hypha_tpu.executor import training as jtraining
from hypha_tpu.ft import adaptive as jadaptive
from hypha_tpu.ft import durable as jdur
from hypha_tpu.ft import membership as jm
from hypha_tpu.network.node import RequestError as JRequestError
from hypha_tpu.scheduler import batch_scheduler as jbs
from hypha_tpu.scheduler import orchestrator as jorch
from hypha_tpu.scheduler import trackers as jtrackers
from hypha_tpu.telemetry.ft_metrics import FT_METRICS
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor import training as ttraining
from hypha_tpu_torch.ft import adaptive as tadaptive
from hypha_tpu_torch.ft import durable as tdur
from hypha_tpu_torch.ft import membership as tm
from hypha_tpu_torch.network.node import RequestError as TRequestError
from hypha_tpu_torch.scheduler import batch_scheduler as tbs
from hypha_tpu_torch.scheduler import orchestrator as torch_orch
from hypha_tpu_torch.scheduler import trackers as ttrackers

DUR = {"jax": jdur, "port": tdur}
MSG = {"jax": jmsg, "port": tmsg}
BS = {"jax": (jbs, jtrackers), "port": (tbs, ttrackers)}
ORCH = {"jax": jorch, "port": torch_orch}
REQERR = {"jax": JRequestError, "port": TRequestError}


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# ------------------------------------------------------------ the journal

PLAN = {"base_id": "base-1",
        "workers": {"w0": {"lease_id": "l0", "batch_size": 2},
                    "w1": {"lease_id": "l1", "batch_size": 2}},
        "ps_peers": ["psw"]}


def _seed_journal(pkg: str, root: Path):
    dur = DUR[pkg].DurableScheduler.open(root, fresh=True, fsync_every=0)
    dur.note_plan(PLAN)
    dur.note_dispatch("base-1-w0", "w0", "l0", "train", batch_size=2)
    dur.note_dispatch("base-1-w1", "w1", "l1", "train", batch_size=2)
    dur.note_dispatch("base-1-ps", "psw", "lp", "aggregate", shard=0)
    return dur


def _resume(res) -> "dict | None":
    if res is None:
        return None
    return {k: getattr(res, k) for k in ("base_id", "plan", "round", "member", "ctrl",
                                          "rejoins", "ps_restarts", "dispatches")}


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_sched_journal_roundtrip(tmp_path, reader):
    """The same operations give the same journal bytes in both packages,
    and either package's journal resumes alike in ``reader``."""
    files = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        dur = _seed_journal(pkg, root)
        dur.note_round(2, {"round": 2, "per_step": {"w0": 0.5}})
        dur.note_member({"epoch": 4, "active": ["w0", "w1"], "departed": []}, 1)
        dur.note_ps_restarts(1)
        dur.close()
        files[pkg] = (root / "sched-journal.cbor").read_bytes()
    assert files["port"] == files["jax"]
    resumed = []
    for pkg in ("jax", "port"):
        dur = DUR[reader].DurableScheduler.open(tmp_path / pkg, fsync_every=0)
        assert dur.generation == 2
        resumed.append(_resume(dur.resume))
        dur.close()
    res = resumed[0]
    assert resumed[1] == res
    assert res["base_id"] == "base-1" and res["round"] == 2 and res["rejoins"] == 1
    assert res["ctrl"] == {"round": 2, "per_step": {"w0": 0.5}} and res["ps_restarts"] == 1
    assert set(res["dispatches"]) == {"base-1-w0", "base-1-w1", "base-1-ps"}
    assert res["dispatches"]["base-1-ps"]["shard"] == 0 and res["member"]["epoch"] == 4


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sched_journal_dispatch_superseded_by_rejoin(tmp_path, pkg):
    """A rejoin's dispatch and a shard's re-dispatch supersede: adoption
    says hello to the replacement."""
    dur = _seed_journal(pkg, tmp_path)
    dur.note_dispatch("base-1-r0", "w9", "l9", "train", batch_size=2)
    dur.note_dispatch("base-1-ps", "psw", "lp2", "aggregate", shard=0)
    dur.close()
    got = {}
    for reader in ("jax", "port"):
        dur2 = DUR[reader].DurableScheduler.open(tmp_path, fsync_every=0)
        got[reader] = _resume(dur2.resume)
        dur2.close()
    assert got["port"] == got["jax"]
    assert got["port"]["dispatches"]["base-1-r0"]["peer"] == "w9"
    assert got["port"]["dispatches"]["base-1-ps"]["lease_id"] == "lp2"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sched_journal_torn_tail_parses_as_end(tmp_path, pkg):
    """A record torn mid-append reads as the end of the log: everything
    before it resumes, in either reader."""
    dur = _seed_journal(pkg, tmp_path / "w")
    dur.note_round(3)
    dur.close()
    torn = (tmp_path / "w" / "sched-journal.cbor").read_bytes()[:-3]
    got = {}
    for reader in ("jax", "port"):
        root = tmp_path / reader
        root.mkdir()
        (root / "sched-journal.cbor").write_bytes(torn)
        dur2 = DUR[reader].DurableScheduler.open(root, fsync_every=0)
        got[reader] = _resume(dur2.resume)
        dur2.close()
    assert got["port"] == got["jax"]
    assert got["port"]["base_id"] == "base-1" and got["port"]["round"] == 0
    assert set(got["port"]["dispatches"]) == {"base-1-w0", "base-1-w1", "base-1-ps"}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sched_journal_garbage_resumes_nothing(tmp_path, pkg):
    """An unreadable journal parses as empty: nothing to adopt, generation 1,
    and the orchestrator falls back to a fresh run."""
    (tmp_path / "sched-journal.cbor").write_bytes(struct.pack("<I", 1 << 30) +
                                                   b"\xde\xad\xbe\xef" * 16)
    assert DUR[pkg].DurableScheduler.has_state(tmp_path)
    dur = DUR[pkg].DurableScheduler.open(tmp_path, fsync_every=0)
    assert dur.resume is None and dur.generation == 1
    dur.close()


def test_sched_journal_compaction_stays_bounded(tmp_path):
    """Compaction every 8 round records keeps gen, plan, the dispatches and
    the newest round: the same bytes in both packages, and bounded."""
    files = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        dur = _seed_journal(pkg, root)
        for r in range(1, 100):
            dur.note_round(r)
        path = root / "sched-journal.cbor"
        records = tdur.RoundJournal.read_all(path)
        assert len(records) <= 16 and path.stat().st_size < 4096, records
        dur.close()
        files[pkg] = path.read_bytes()
        dur2 = DUR[pkg].DurableScheduler.open(root, fsync_every=0)
        assert dur2.resume.round == 99
        assert set(dur2.resume.dispatches) == {"base-1-w0", "base-1-w1", "base-1-ps"}
        dur2.close()
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sched_journal_generation_monotonic_and_complete_wipes(tmp_path, pkg):
    mod = DUR[pkg]
    gens = []
    for _ in range(3):
        dur = mod.DurableScheduler.open(tmp_path, fsync_every=0)
        gens.append(dur.generation)
        if dur.resume is None:
            dur.note_plan({"base_id": "b", "workers": {}, "ps_peers": ["p"]})
        dur.close()
    assert gens == [1, 2, 3]
    dur = mod.DurableScheduler.open(tmp_path, fsync_every=0)
    dur.complete()
    assert not mod.DurableScheduler.has_state(tmp_path)
    dur2 = mod.DurableScheduler.open(tmp_path, fsync_every=0)
    assert dur2.generation == 1 and dur2.resume is None
    dur2.close()


# ------------------------------------------------------- stamped responses

def _scheduler(pkg: str, generation=None, epochs=4, target=4):
    bs, trackers = BS[pkg]
    tracker = trackers.ProgressTracker(parameter_server="psw", update_target=target,
                                       update_epochs=epochs)
    tracker.add_worker("w0", 2)
    tracker.add_worker("w1", 2)
    return bs.BatchScheduler(tracker, generation=generation), tracker


def _answers(pkg: str, generation, script) -> list:
    """``script``'s (peer, Progress kwargs) through one package's scheduler:
    each response's wire bytes and the round after it."""
    m = MSG[pkg]
    sched, tracker = _scheduler(pkg, generation=generation)
    out = []
    for peer, kw in script:
        kw = dict(kw)
        kind = m.ProgressKind[kw.pop("kind")]
        resp = sched.on_progress(peer, m.Progress(kind=kind, **kw))
        out.append((m.encode(resp), tracker.round))
    return out


SCRIPT = [("w0", {"kind": "STATUS", "batch_size": 2}), ("w1", {"kind": "STATUS", "batch_size": 2}),
          ("w0", {"kind": "UPDATE"}), ("w1", {"kind": "UPDATE"}),
          ("psw", {"kind": "UPDATED", "round": 0}), ("w0", {"kind": "UPDATE_RECEIVED"}),
          ("psw", {"kind": "UPDATED", "round": 0}), ("w9", {"kind": "STATUS", "batch_size": 2}),
          ("w1", {"kind": "UPDATE_RECEIVED"}), ("w0", {"kind": "METRICS", "round": 0})]


def test_unstamped_responses_are_byte_identical_singletons():
    """A scheduler that never restarted answers with the reference's
    frozen singletons: no generation or round on the wire."""
    sched, _ = _scheduler("port", generation=None, target=100)
    r1 = sched.on_progress("w0", tmsg.Progress(kind=tmsg.ProgressKind.STATUS, batch_size=2))
    r2 = sched.on_progress("w0", tmsg.Progress(kind=tmsg.ProgressKind.STATUS, batch_size=2))
    assert r1 is r2
    for resp in (r1, r2):
        enc = tmsg.encode(resp)
        assert b"generation" not in enc and b"round" not in enc
    assert b"scheduler_generation" not in tmsg.encode(
        tmsg.Progress(kind=tmsg.ProgressKind.STATUS, batch_size=2))
    assert _answers("port", None, SCRIPT) == _answers("jax", None, SCRIPT)


def test_restarted_scheduler_stamps_generation_and_round():
    sched, tracker = _scheduler("port", generation=2)
    resp = sched.on_progress("w0", tmsg.Progress(kind=tmsg.ProgressKind.STATUS, batch_size=2))
    assert resp.generation == 2 and resp.round == tracker.round
    enc = tmsg.encode(resp)
    assert b"generation" in enc and b"round" in enc
    got = _answers("port", 2, SCRIPT)
    assert got == _answers("jax", 2, SCRIPT)
    assert [r for _, r in got][-1] == 1


@pytest.mark.parametrize("generation,sender", [(2, 3), (None, 2)], ids=["gen2", "gen1"])
def test_zombie_scheduler_drops_newer_generation_traffic(generation, sender):
    """A scheduler hearing traffic stamped for a newer generation is the
    zombie and refuses it (an unstamped one is generation 1): the same
    answer in both packages, the round unmoved, the refusal counted."""
    got = {}
    for pkg in ("jax", "port"):
        m = MSG[pkg]
        sched, tracker = _scheduler(pkg, generation=generation)
        before = FT_METRICS.stale_generation_dropped.value()
        resp = sched.on_progress("psw", m.Progress(kind=m.ProgressKind.UPDATED, round=0,
                                                   scheduler_generation=sender))
        assert resp.kind == m.ProgressResponseKind.ERROR and tracker.round == 0
        got[pkg] = m.encode(resp)
        if pkg == "jax":
            assert FT_METRICS.stale_generation_dropped.value() == before + 1
        else:
            assert sched.stale_generation_dropped == 1
    assert got["port"] == got["jax"]


def test_old_generation_updated_still_processed():
    """A parked UPDATED from before the crash (stamped 2 at a generation-3
    scheduler) is real progress: round idempotency absorbs duplicates."""
    for pkg in ("jax", "port"):
        m = MSG[pkg]
        sched, tracker = _scheduler(pkg, generation=3)
        resp = sched.on_progress("psw", m.Progress(kind=m.ProgressKind.UPDATED, round=0,
                                                   scheduler_generation=2))
        assert resp.kind == m.ProgressResponseKind.OK and tracker.round == 1, pkg


def test_duplicate_schedule_update_is_idempotent():
    """A restarted scheduler's repeated ScheduleUpdate leaves a running
    countdown standing, in both trainers' ``adopt_schedule``."""
    for m, adopt in ((jmsg, jtraining.adopt_schedule), (tmsg, ttraining.adopt_schedule)):
        first = m.ProgressResponse(kind=m.ProgressResponseKind.SCHEDULE_UPDATE, counter=5)
        dup = m.ProgressResponse(kind=m.ProgressResponseKind.SCHEDULE_UPDATE, counter=9,
                                 generation=2)
        countdown = adopt(first, None)
        assert countdown == 5
        assert adopt(dup, countdown - 1) == 4
        assert adopt(dup, None) == 9
        assert adopt(m.ProgressResponse(kind=m.ProgressResponseKind.CONTINUE), 3) == 3


def test_stale_generation_continue_dropped():
    """The worker-side gate, one implementation in each package."""
    seq = [2, 1, None, 3, 2]
    for m, gate in ((jmsg, jdur.stale_scheduler_response),
                    (tmsg, tdur.stale_scheduler_response)):
        gen, seen = None, []
        for g in seq:
            gen, stale = gate(m.ProgressResponse(kind=m.ProgressResponseKind.CONTINUE,
                                                 generation=g), gen)
            seen.append((gen, stale))
        assert seen == [(2, False), (2, True), (2, False), (3, False), (3, True)]


@pytest.mark.parametrize("shards", [1, 2])
def test_adopt_round_fast_forwards_from_acks(shards):
    """The fleet's truth wins: the same journal frontier and the same
    AdoptAcks fast-forward both packages' schedulers to the same round,
    never back, and a parked re-notify of a credited round is idempotent."""
    from hypha_tpu.stream import shards_due_at as jdue
    from hypha_tpu_torch.stream import shards_due_at as tdue

    got = {}
    for pkg, due in (("jax", jdue), ("port", tdue)):
        m = MSG[pkg]
        bs, trackers = BS[pkg]
        tracker = trackers.ProgressTracker(parameter_server=["psw0", "psw1"][:shards],
                                           update_target=4, update_epochs=6)
        tracker.add_worker("w0", 2)
        sched = bs.BatchScheduler(
            tracker, generation=2,
            shards_due=(lambda r: due("stream", r, 4, 2)) if shards == 2 else None)
        acks = {0: 3} if shards == 1 else {0: 3, 1: 4}
        seen = [sched.adopt_round(1, acks), sched.adopt_round(1, {0: 2})]
        resp = sched.on_progress("psw0", m.Progress(kind=m.ProgressKind.UPDATED, round=2))
        seen += [m.encode(resp), tracker.round]
        got[pkg] = seen
    assert got["port"] == got["jax"]
    assert got["port"][0] == (3 if shards == 1 else 4) and got["port"][1] == got["port"][0]


def test_adopted_last_round_completes_after_the_parked_notify():
    """A shard that committed the last round reports the round after it,
    so adoption credits it and the workers' parked UPDATE_RECEIVED get
    DONE (no extra round); the job completes once the shard's parked
    UPDATED is answered (DONE ends its loop), not before."""
    done = []
    tracker = ttrackers.ProgressTracker(parameter_server="psw", update_target=4,
                                        update_epochs=3)
    for w in ("w0", "w1"):
        tracker.add_worker(w, 2)
    sched = tbs.BatchScheduler(tracker, generation=2, on_complete=lambda: done.append(True))
    assert sched.adopt_round(2, {0: 3}) == 3
    K = tmsg.ProgressKind
    for w in ("w0", "w1"):
        resp = sched.on_progress(w, tmsg.Progress(kind=K.UPDATE_RECEIVED))
        assert resp.kind == tmsg.ProgressResponseKind.DONE and (resp.generation, resp.round) \
            == (2, 3)
    assert not done and not sched.completed
    resp = sched.on_progress("psw", tmsg.Progress(kind=K.UPDATED, round=2))
    assert resp.kind == tmsg.ProgressResponseKind.DONE and done == [True]
    # A credited round that is not the shard's last owes nothing.
    sched2, _ = _scheduler("port", generation=2, epochs=6)
    sched2.adopt_round(1, {0: 3})
    assert not sched2._owed


def test_controller_reset_mid_job_does_not_punish_healthy_peers():
    """A rebuilt straggler controller resumes from the journaled snapshot
    in warmup (base assignments, no penalty, nothing published) until a
    full measured round: the same steps in both packages."""
    got = {}
    for pkg, mod in (("jax", jadaptive), ("port", tadaptive)):
        clock = {"t": 0.0}
        ctrl = mod.StragglerController(base_steps=8, alpha=1.0, clock=lambda: clock["t"])
        for rnd in range(3):
            ctrl.start_round(rnd, ["w0", "w1"])
            ctrl.note_round_closed(rnd, {"w0": 1.0, "w1": 4.0})
        snap = ctrl.snapshot()
        ctrl2 = mod.StragglerController(base_steps=8, alpha=1.0, clock=lambda: clock["t"])
        ctrl2.resume_warmup(3, snap)
        steps = [(ctrl2.steps_for("w0"), ctrl2.steps_for("w1"), ctrl2.assignments())]
        ctrl2.note_round_closed(3, {"w1": 400.0})
        ctrl2.start_round(4, ["w0", "w1"])
        steps.append(ctrl2.snapshot())
        ctrl2.note_round_closed(4, {"w0": 1.0, "w1": 4.0})
        ctrl2.start_round(5, ["w0", "w1"])
        steps.append((ctrl2.steps_for("w1"), ctrl2.assignments()))
        got[pkg] = (json.dumps(snap, sort_keys=True), steps)
    assert got["port"] == got["jax"]
    steps = got["port"][1]
    assert steps[0] == (8, 8, {}) and steps[2][0] < 8 and steps[2][1]


def test_link_table_snapshot_restore_roundtrip():
    got = {}
    for pkg, mod in (("jax", jadaptive), ("port", tadaptive)):
        lt = mod.LinkTable(base_codec="none", hi_mbps=100.0, lo_mbps=10.0)
        lt.observe("w0", 10_000_000, 1.0)
        lt2 = mod.LinkTable(base_codec="none", hi_mbps=100.0, lo_mbps=10.0)
        lt2.restore(lt.snapshot())
        assert lt2.measured("w0") and lt2.codec_for("w0") == lt.codec_for("w0")
        got[pkg] = (lt2.bandwidth_bps("w0"), lt2.codec_for("w0"))
    assert got["port"] == got["jax"]


def test_generation_off_path_ships_todays_wire():
    """Recovery off, no new field on the wire; on, the dispatched specs
    carry the grace, byte-equal to the JAX orchestrator's."""
    for m, mem in ((jmsg, jm), (tmsg, tm)):
        enc = m.encode(m.TrainExecutorConfig(
            model={}, data=m.Fetch(m.Reference.from_uri("file:///d")),
            updates=m.Send(m.Reference.from_peers(["p"], "u")),
            results=m.Receive(m.Reference.from_peers(["p"], "r")),
            optimizer=m.Adam(), batch_size=2))
        assert b"adopt_grace_s" not in enc
        enc = m.encode(m.AggregateExecutorConfig(
            updates=m.Receive(m.Reference.from_peers(["p"], "u")),
            results=m.Send(m.Reference.from_peers(["p"], "r")), optimizer=m.Nesterov()))
        assert b"adopt_grace_s" not in enc
        assert b"scheduler_adopt" not in m.encode(mem.FTConfig())
        rm = mem.RoundMembership(epoch=1, active=["a"])
        assert m.decode(m.encode(rm)) == rm
    specs = {}
    for pkg in ("jax", "port"):
        specs[pkg] = {rec: _planned_specs(pkg, rec) for rec in (False, True)}
    assert specs["port"] == specs["jax"]
    assert b"adopt_grace_s" not in specs["port"][False][0]
    assert b"adopt_grace_s" in specs["port"][True][0] and b"adopt_grace_s" in \
        specs["port"][True][1]


def _planned_specs(pkg: str, recovery: bool) -> tuple:
    from types import SimpleNamespace

    from hypha_tpu.scheduler import job_config as jjob
    from hypha_tpu_torch.scheduler import job_config as tjob

    m, mem, jobmod, orch = ((jmsg, jm, jjob, jorch) if pkg == "jax"
                            else (tmsg, tm, tjob, torch_orch))
    job = jobmod.DiLoCoJob(model={"preset": "tiny"}, dataset="d", checkpoint_dir="/ckpt",
                           ft=mem.FTConfig(scheduler_adopt_grace_s=45.0 if recovery else None),
                           scheduler_recovery=recovery)
    o = orch.Orchestrator(SimpleNamespace(peer_id="sched"))
    ctx = orch._RunContext()
    ctx.job, ctx.ft, ctx.base_id = job, job.ft, "base"
    ctx.adopt_grace = 45.0 if recovery else None
    ctx.ps_handles = [SimpleNamespace(peer_id="psw")]
    o._plan_streams(ctx, job, ["w0", "w1"], ["psw"], 1, 1)
    handle = SimpleNamespace(peer_id="w0", lease_id="l0", batch_size=2)
    return m.encode(o._train_spec(ctx, "w0", handle)), m.encode(ctx.ps_specs[0])


# ----------------------------------------------------------------- the hello

class _FakeNode:
    """``request`` scripted per peer; never dials anything."""

    def __init__(self, answers, err):
        self.answers, self.err = answers, err
        self.calls: list = []
        self.peer_id = "sched"

    async def request(self, peer, protocol, msg, timeout=None):
        self.calls.append((peer, msg))
        answer = self.answers.get(peer)
        if answer is None:
            raise self.err(f"no route to {peer}")
        return answer(msg)


def _mini_orchestrator(pkg: str, node):
    orch = ORCH[pkg].Orchestrator.__new__(ORCH[pkg].Orchestrator)
    orch.node = node
    orch.counts = {"scheduler_recoveries": 0, "adopted_executions": 0,
                   "stale_generation_dropped": 0}
    return orch


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_adoption_deadline_fake_clock_no_real_waiting(pkg):
    """An execution that never acks falls out at the adoption deadline,
    driven by an injected clock, not wall time."""
    m = MSG[pkg]
    node = _FakeNode({"w0": lambda msg: m.AdoptAck(job_id=msg.job_id, round=2, state="running",
                                                   generation=msg.generation)}, REQERR[pkg])
    orch = _mini_orchestrator(pkg, node)
    ctx = ORCH[pkg]._RunContext()
    ctx.dur = type("D", (), {"generation": 2})()
    clock = {"t": 0.0}

    def fake_clock():
        clock["t"] += 4.0  # each check burns 4 fake seconds
        return clock["t"]

    t0 = time.monotonic()
    acks = run(orch._adopt_executions(ctx, {"j-w0": {"peer": "w0"}, "j-w1": {"peer": "w1"}},
                                      round_hint=1, deadline_s=20.0, clock=fake_clock))
    assert time.monotonic() - t0 < 10.0
    assert set(acks) == {"j-w0"} and acks["j-w0"].round == 2
    hello = next(msg for peer, msg in node.calls if peer == "w0")
    assert isinstance(hello, m.SchedulerHello) and (hello.generation, hello.round) == (2, 1)
    assert [p for p, _ in node.calls].count("w0") == 1
    if pkg == "port":
        assert orch.counts["adopted_executions"] == 1


def _arbiter_env(pkg: str):
    if pkg == "jax":
        from hypha_tpu.resources import Resources
        from hypha_tpu.worker.arbiter import Arbiter
        from hypha_tpu.worker.job_manager import Execution, JobManager, _ActiveJob
        from hypha_tpu.worker.lease_manager import LeaseManager
        from hypha_tpu.worker.resources_mgr import StaticResourceManager
    else:
        from hypha_tpu_torch.resources import Resources
        from hypha_tpu_torch.worker.arbiter import Arbiter
        from hypha_tpu_torch.worker.job_manager import Execution, JobManager, _ActiveJob
        from hypha_tpu_torch.worker.lease_manager import LeaseManager
        from hypha_tpu_torch.worker.resources_mgr import StaticResourceManager
    lm = LeaseManager(StaticResourceManager(Resources(cpu=8, memory=100)))
    jmgr = JobManager(node=None, executors={})
    arb = Arbiter(node=None, lease_manager=lm, job_manager=jmgr)
    lease = lm.request("sched", Resources(cpu=1, memory=1), 10.0)
    execution = Execution("job-1")
    execution.round, execution.epoch, execution.adopt_grace_s = 3, 2, 30.0
    jmgr._active["job-1"] = _ActiveJob(execution=execution, lease_id=lease.id)
    return arb, lm, lease, execution


def _hello(pkg: str, job_id: str, generation: int, last_gen=None, lapse=False) -> tuple:
    async def main():
        arb, lm, lease, execution = _arbiter_env(pkg)
        execution.scheduler_generation = last_gen
        if lapse:
            lease.timeout = time.time() + 0.5  # nearly lapsed during the outage
        ack = await arb._on_hello("sched", MSG[pkg].SchedulerHello(
            generation=generation, job_id=job_id, round=1))
        return MSG[pkg].encode(ack), ack, execution.scheduler_generation, \
            lm.get(lease.id).remaining()

    return run(main())


def test_hello_adopts_running_execution_and_rearms_lease():
    got = {pkg: _hello(pkg, "job-1", 2, lapse=True) for pkg in ("jax", "port")}
    assert got["port"][0] == got["jax"][0]
    _, ack, gen, remaining = got["port"]
    assert ack.ok and ack.state == "running" and (ack.round, ack.epoch) == (3, 2)
    assert gen == 2 and remaining > 5.0  # the hello renewed the lease


def test_hello_from_stale_generation_refused():
    got = {pkg: _hello(pkg, "job-1", 2, last_gen=3) for pkg in ("jax", "port")}
    assert got["port"][0] == got["jax"][0]
    _, ack, gen, _ = got["port"]
    assert not ack.ok and ack.state == "stale" and ack.generation == 3 and gen == 3


def test_hello_for_unknown_job_is_gone():
    got = {pkg: _hello(pkg, "nope", 2) for pkg in ("jax", "port")}
    assert got["port"][0] == got["jax"][0]
    assert not got["port"][1].ok and got["port"][1].state == "gone"


def test_adoption_grace_defers_lease_prune_then_cancels():
    """An adoptable job's lease outlives its expiry by the grace (the
    execution keeps running); past it the expiry cancellation fires."""
    async def main(pkg):
        arb, lm, lease, execution = _arbiter_env(pkg)
        execution.adopt_grace_s = 0.8
        cancelled = []

        async def cancel():
            cancelled.append(True)

        execution.cancel = cancel
        lease.timeout = time.time() + 0.2
        prune = asyncio.create_task(arb._prune_loop())
        try:
            await asyncio.sleep(0.6)
            inside = (bool(cancelled), lm.ledger.try_get(lease.id) is not None)
            await asyncio.sleep(0.8)
            past = (bool(cancelled), lm.ledger.try_get(lease.id) is not None)
        finally:
            prune.cancel()
            await asyncio.gather(prune, return_exceptions=True)
        return inside, past

    for pkg in ("jax", "port"):
        assert run(main(pkg)) == ((False, True), (True, False)), pkg


# ------------------------------------------------------- grace and parking

def _agg(m, ckpt: Path, grace: float):
    return m.JobSpec(job_id="agg-park", executor=m.Executor(
        kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
            updates=m.Receive(m.Reference.from_peers(["w1", "w2"], "updates")),
            results=m.Send(m.Reference.from_peers(["w1", "w2"], "results")),
            optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=2,
            checkpoint_dir=str(ckpt), adopt_grace_s=grace)))


async def _parked_job(pkg: str, tmp: Path) -> dict:
    """Three rounds through one package's durable parameter server on the
    memory fabric; round 1's UPDATED fails twice (the scheduler is down).
    Returns the update bytes, the order of broadcasts and answered
    notifies, and the generation the execution adopted."""
    if pkg == "jax":
        from hypha_tpu import aio
        from hypha_tpu.network import MemoryTransport, Node
        from hypha_tpu.worker.ps_executor import ParameterServerExecutor as PS
    else:
        from hypha_tpu_torch import aio
        from hypha_tpu_torch.network import MemoryTransport, Node
        from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as PS
    m = MSG[pkg]
    hub = MemoryTransport()
    nodes = {p: Node(hub.shared(), peer_id=p) for p in ("ps", "w1", "w2", "sched")}
    for n in nodes.values():
        await n.start()
    for a in nodes.values():
        for b in nodes.values():
            if a is not b:
                a.add_peer_addr(b.peer_id, b.listen_addrs[0])
    events: list = []
    fails = {"left": 2}

    async def on_progress(peer, progress):
        events.append(("notified", progress.round))
        kind = m.ProgressResponseKind.DONE if progress.round >= 2 else m.ProgressResponseKind.OK
        return m.ProgressResponse(kind=kind, generation=2 if progress.round >= 1 else None,
                                  round=progress.round + 1 if progress.round >= 1 else None)

    reg = nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
    request = nodes["ps"].request

    async def outage(peer, protocol, msg, **kw):
        if protocol == m.PROTOCOL_PROGRESS and msg.round == 1 and fails["left"]:
            fails["left"] -= 1
            events.append(("failed", 1))
            raise REQERR[pkg]("scheduler down")
        return await request(peer, protocol, msg, **kw)

    nodes["ps"].request = outage
    executor = PS(nodes["ps"], tmp / "work") if pkg == "jax" else \
        PS(nodes["ps"], tmp / "work", device="cpu")
    broadcast = executor._broadcast

    async def noted_broadcast(cfg, path, round_num, *a, **kw):
        events.append(("broadcast", round_num))
        return await broadcast(cfg, path, round_num, *a, **kw)

    executor._broadcast = noted_broadcast
    (tmp / "work").mkdir()
    (tmp / "recv").mkdir()
    execution = await executor.execute("agg-park", _agg(m, tmp / "ckpt", 30.0), "sched")
    updates = []
    for rnd in range(3):
        for peer, samples in (("w1", 8.0), ("w2", 4.0)):
            f = tmp / f"d-{peer}-{rnd}.st"
            rng = np.random.default_rng(100 * int(peer[1]) + rnd)
            save_file({"w": rng.standard_normal(16).astype(np.float32),
                       "b": rng.standard_normal(5).astype(np.float32)}, str(f))
            await aio.retry(lambda p=peer, f=f, s=samples: nodes[p].push(
                "ps", {"resource": "updates", "name": f.name, "round": rnd, "num_samples": s},
                f), attempts=3, base_delay=0.05)
        for peer in ("w1", "w2"):
            push = await nodes[peer].next_push(timeout=20)
            dest = tmp / "recv" / f"u-{peer}-{rnd}.st"
            await push.save_to(dest)
            if peer == "w1":
                updates.append({k: v.tobytes() for k, v in load_file(str(dest)).items()})
    status = await asyncio.wait_for(execution.wait(), 15)
    reg.close()
    for n in nodes.values():
        await n.stop()
    return {"updates": updates, "events": events, "state": status.state,
            "generation": execution.scheduler_generation}


def test_parked_notify_broadcasts_first_on_outage(tmp_path, monkeypatch):
    """With the scheduler down, the server's UPDATED parks, and the round's
    broadcast goes out on the second failed attempt: the quorate round
    closes without the scheduler. The same order and the same update bytes
    in both packages' servers; the execution adopts the answering
    generation; without the grace a failure is one attempt."""
    monkeypatch.setattr(native, "_load", lambda: None)  # the reference's numpy outer step
    got = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = asyncio.run(asyncio.wait_for(_parked_job(pkg, d), 60))
    assert got["port"] == got["jax"]
    assert got["port"]["state"] == "completed" and got["port"]["generation"] == 2
    assert got["port"]["events"] == [
        ("notified", 0), ("broadcast", 0), ("failed", 1), ("failed", 1), ("broadcast", 1),
        ("notified", 1), ("notified", 2), ("broadcast", 2)]

    class _Node:
        peer_id = "psw"

        def __init__(self):
            self.requests = 0

        async def request(self, peer, protocol, msg, timeout=None):
            self.requests += 1
            raise TRequestError("scheduler down")

    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as TPS

    ps = TPS.__new__(TPS)
    ps.node = _Node()
    fired = []

    async def bcast():
        fired.append(True)

    with pytest.raises(TRequestError):
        run(ps._notify_updated_resilient("sched", "job-1", 1, park_s=0.0,
                                         on_first_failure=bcast))
    assert ps.node.requests == 1 and not fired


def test_stale_generation_updated_reply_is_retried():
    """A zombie's reply to an UPDATED must not drive the round machinery:
    the parked notify drops it and re-sends until the live generation
    answers, in both servers."""
    for pkg in ("jax", "port"):
        m = MSG[pkg]
        if pkg == "jax":
            from hypha_tpu.worker.job_manager import Execution
            from hypha_tpu.worker.ps_executor import ParameterServerExecutor as PS
        else:
            from hypha_tpu_torch.worker.job_manager import Execution
            from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as PS

        class _Node:
            peer_id = "psw"

            def __init__(self):
                self.gens = [1, 1, 3]  # zombie, zombie, the live successor

            async def request(self, peer, protocol, msg, timeout=None):
                return m.ProgressResponse(kind=m.ProgressResponseKind.DONE,
                                          generation=self.gens.pop(0), round=2)

        ps = PS.__new__(PS)
        ps.node = _Node()

        async def parked():
            execution = Execution("job-1")
            execution.scheduler_generation = 2  # adopted through a hello
            resp = await ps._notify_updated_resilient("sched", "job-1", 2,
                                                      execution=execution, park_s=30.0)
            return execution, resp

        execution, resp = run(parked())
        assert resp.generation == 3 and execution.scheduler_generation == 3, pkg


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_resume_without_plan_raises_adoption_failed(tmp_path, pkg):
    from hypha_tpu.scheduler import job_config as jjob
    from hypha_tpu_torch.scheduler import job_config as tjob

    jobmod, mem = (jjob, jm) if pkg == "jax" else (tjob, tm)
    job = jobmod.DiLoCoJob(model={}, dataset="toy", checkpoint_dir=str(tmp_path),
                           ft=mem.FTConfig(), scheduler_recovery=True)
    root = tmp_path / "scheduler"
    root.mkdir()
    (root / "sched-journal.cbor").write_bytes(b"\xff" * 64)
    orch = _mini_orchestrator(pkg, _FakeNode({}, REQERR[pkg]))
    with pytest.raises(ORCH[pkg].AdoptionFailed):
        run(orch._resume_once(job))


# --------------------------------------------------------------- end to end

def _ps_final_state(ckpt: Path) -> dict:
    """The durable server's final outer state as bytes: every checkpoint
    tensor (momentum, catch-up Σ) and each fragment's newest wire."""
    psdir = ckpt / "ps"
    meta = json.loads((psdir / "ps-state.json").read_text())
    out = {f"state/{k}": v.dtype.str.encode() + str(v.shape).encode() + v.tobytes()
           for k, v in load_file(str(psdir / meta["state_file"])).items()}
    for frag, (rnd, name) in (meta.get("last_wires") or {}).items():
        out[f"wire/{frag}/{rnd}"] = (psdir / "wires" / name).read_bytes()
    return out


def _sched_job(pkg: str, weights: Path, ckpt: Path, adopt_deadline_s: float = 15.0):
    from hypha_tpu.resources import Resources as JRes
    from hypha_tpu.scheduler import job_config as jjob
    from hypha_tpu_torch.resources import Resources as TRes
    from hypha_tpu_torch.scheduler import job_config as tjob

    m, job, mem, R = (jmsg, jjob, jm, JRes) if pkg == "jax" else (tmsg, tjob, tm, TRes)
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
             "config": {"dtype": "float32"},
             "source": m.to_json_dict(m.Fetch(m.Reference.from_uri(weights.as_uri())))}
    # One batch a round (the round's samples are one batch): neither the
    # outage nor the timing changes what a worker computes.
    return job.DiLoCoJob(
        model=model, dataset="counting",
        rounds=job.DiLoCoRounds(update_rounds=3, avg_samples_between_updates=2,
                                max_batch_size=2),
        inner_optimizer=m.Adam(lr=3e-3), outer_optimizer=m.Nesterov(lr=0.7, momentum=0.9),
        resources=job.JobResources(
            num_workers=2, worker=R(gpu=1.0, cpu=1.0, memory=10),
            parameter_server=R(cpu=1.0, memory=10),
            worker_price=m.PriceRange(bid=1.0, max=10.0),
            parameter_server_price=m.PriceRange(bid=1.0, max=10.0)),
        ft=mem.FTConfig(quorum_fraction=0.75, round_deadline_s=60.0,
                        scheduler_adopt_grace_s=60.0,
                        scheduler_adopt_deadline_s=adopt_deadline_s),
        checkpoint_dir=str(ckpt), scheduler_recovery=True)


async def _kill_scheduler_run(scheduler: str, ps: str, kill_round: int, close: bool, tmp: Path,
                              weights: Path, data_dir: Path, kill: bool,
                              silent_s: float = 0.0) -> dict:
    """One run of the job under ``scheduler``'s orchestrator, gateway and
    data node, a JAX and a torch worker, the parameter server ``ps``'s.
    With ``kill`` the scheduler's node is stopped and its ``run`` cancelled
    at round ``kill_round``'s first METRICS, and a new node under the same
    peer id runs a new orchestrator on the same job. With ``close`` the
    kill waits for both workers' METRICS and their deltas of the round wait
    for the kill, so the round closes during the outage: the server's
    notify fails twice, the round goes out without the scheduler, and the
    restart waits for that. With ``silent_s`` the torch worker answers no
    adoption hello until ``silent_s`` after the first one reached it, so
    the restarted scheduler adopts the server long before it serves
    progress (the adoption deadline is raised to cover the silence)."""
    import logging

    from hypha_tpu.data_node import DataNode as JDataNode
    from hypha_tpu.gateway import Gateway as JGateway
    from hypha_tpu.network import Node as JNode
    from hypha_tpu.network import TcpTransport as JTcp
    from hypha_tpu.resources import Resources as JResources
    from hypha_tpu.scheduler.metrics_bridge import CallbackConnector as JCallback
    from hypha_tpu.scheduler.task import Task as JTask
    from hypha_tpu.worker.arbiter import OfferConfig as JOffer
    from hypha_tpu.worker.runtime import WorkerNode as JWorkerNode
    from hypha_tpu_torch.data_node import DataNode as TDataNode
    from hypha_tpu_torch.gateway import Gateway as TGateway
    from hypha_tpu_torch.network import Node as TNode
    from hypha_tpu_torch.network import TcpTransport as TTcp
    from hypha_tpu_torch.resources import Resources as TResources
    from hypha_tpu_torch.scheduler.metrics_bridge import CallbackConnector as TCallback
    from hypha_tpu_torch.scheduler.task import Task as TTask
    from hypha_tpu_torch.worker.arbiter import Arbiter as TArbiter
    from hypha_tpu_torch.worker.arbiter import OfferConfig as TOffer
    from hypha_tpu_torch.worker.runtime import WorkerNode as TWorkerNode

    jax_sched = scheduler == "jax"
    Gateway, DataNode, Node, Tcp, Callback, Task = (
        (JGateway, JDataNode, JNode, JTcp, JCallback, JTask) if jax_sched
        else (TGateway, TDataNode, TNode, TTcp, TCallback, TTask))
    ckpt = tmp / "ckpt"
    job = _sched_job(scheduler, weights, ckpt,
                     adopt_deadline_s=silent_s + 15.0 if silent_s else 15.0)
    listen = ["127.0.0.1:0"]
    short = Path(tempfile.mkdtemp(prefix="tsr"))  # a bridge socket path under 108 bytes
    dispatches: list = []
    dispatch = Task.dispatch.__func__

    async def counted(cls, node, router, spec, workers):
        dispatches.append(spec.job_id)
        return await dispatch(cls, node, router, spec, workers)

    Task.dispatch = classmethod(counted)
    gw = Gateway(Tcp(), peer_id="gw")
    await gw.start(listen)
    boot = [gw.node.listen_addrs[0]]
    data = DataNode(Tcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot)
    if ps == "port":
        psw = TWorkerNode(TTcp(), resources=TResources(cpu=4, memory=1000), device="cpu",
                          peer_id="psw", bootstrap=boot, work_root=short / "psw")
    else:
        psw = JWorkerNode(JTcp(), resources=JResources(cpu=4, memory=1000), peer_id="psw",
                          bootstrap=boot, work_root=short / "psw")
    wj = JWorkerNode(JTcp(), resources=JResources(gpu=2, cpu=8, memory=1000), peer_id="wjax",
                     offer=JOffer(strategy="whole"), bootstrap=boot, work_root=short / "wjax")
    wt = TWorkerNode(TTcp(), resources=TResources(gpu=2, cpu=8, memory=1000), device="cpu",
                     peer_id="wtorch", offer=TOffer(strategy="whole"), bootstrap=boot,
                     work_root=short / "wtorch")
    sched = Node(Tcp(), peer_id="sched", bootstrap=boot)
    parts = [data, wj, wt, psw, sched]
    started: list = []
    killed = asyncio.Event()

    reported: set = set()

    def on_metric(worker, rnd, name, value):
        if kill and rnd >= kill_round:
            reported.add(worker)
            if not close or len(reported) == 2:
                killed.set()

    dead = asyncio.Event()

    def hold(node) -> None:
        push = node.push

        async def held(peer_id, resource, source):
            r = resource if isinstance(resource, dict) else {}
            if close and kill and r.get("round") == kill_round and \
                    str(r.get("resource", "")).startswith("updates"):
                await dead.wait()
            return await push(peer_id, resource, source)

        node.push = held

    lines: list = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    loggers = [logging.getLogger(n) for n in ("hypha.torch.worker.ps",
                                              "hypha.torch.scheduler.orchestrator",
                                              "hypha.scheduler.orchestrator")]
    handler, levels = Lines(), [lg.level for lg in loggers]
    for lg in loggers:
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)

    hold(wj.node)
    hold(wt.node)
    on_hello, first_hello = TArbiter._on_hello, []

    async def silent_hello(self, peer, msg):
        if self is wt.arbiter:
            first_hello.append(time.monotonic())
            await asyncio.sleep(max(first_hello[0] + silent_s - time.monotonic(), 0.0))
        return await on_hello(self, peer, msg)

    if silent_s:
        TArbiter._on_hello = silent_hello
    # The torch server's executions, to read how each one ended.
    ps_execs: list = []
    if ps == "port":
        execute = psw.job_manager.execute

        async def recorded(spec, lease_id, scheduler_peer):
            execution = await execute(spec, lease_id, scheduler_peer)
            ps_execs.append(execution)
            return execution

        psw.job_manager.execute = recorded
    out: dict = {}
    try:
        for part in parts:
            await part.start(listen)
            started.append(part)
        await sched.wait_for_bootstrap()
        orch = (jorch if jax_sched else torch_orch).Orchestrator(
            sched, metrics_connector=Callback(on_metric))
        first = asyncio.create_task(orch.run(job, auction_timeout=1.0, status_timeout=60.0))
        waiter = asyncio.create_task(killed.wait())
        await asyncio.wait([first, waiter], return_when=asyncio.FIRST_COMPLETED)
        if first.done():
            waiter.cancel()
            out["result"] = first.result()
        else:
            # The scheduler's process dies: its node first, then its run.
            await sched.stop()
            first.cancel()
            await asyncio.gather(first, return_exceptions=True)
            out["dispatched_before"] = len(dispatches)
            dead.set()
            # The gateway drops a closed peer's registrations by peer id; a
            # node under that id started before it noticed would lose its own.
            await asyncio.sleep(1.0)

            def went_out() -> bool:
                return any("UPDATED failed twice" in line for line in lines)

            for _ in range(300 if close else 0):
                if went_out():
                    break
                await asyncio.sleep(0.1)
            out["broadcast_first"] = went_out()
            sched2 = Node(Tcp(), peer_id="sched", bootstrap=boot)
            await sched2.start(listen)
            started.append(sched2)
            await sched2.wait_for_bootstrap()
            orch = (jorch if jax_sched else torch_orch).Orchestrator(
                sched2, metrics_connector=Callback(on_metric))
            out["result"] = await orch.run(job, auction_timeout=1.0, status_timeout=60.0)
            out["lines_at_done"] = list(lines)
            out["dispatched_after"] = len(dispatches) - out["dispatched_before"]
        out["counts"] = None if jax_sched else dict(orch.counts)
        # How the torch server's execution ended: completed, or failed when
        # a parked notify outlived the job (bounded past the 60 s grace).
        out["ps_states"] = [(await asyncio.wait_for(e.wait(), 90)).state for e in ps_execs]
    finally:
        Task.dispatch = classmethod(dispatch)
        TArbiter._on_hello = on_hello
        for lg, level in zip(loggers, levels):
            lg.removeHandler(handler)
            lg.setLevel(level)
        for part in reversed(started):
            await part.stop()
        await gw.stop()
        shutil.rmtree(short, ignore_errors=True)
    out["lines"] = lines
    out["state"] = _ps_final_state(ckpt)
    out["journal_left"] = (ckpt / "scheduler" / "sched-journal.cbor").exists()
    return out


@pytest.mark.parametrize("scheduler,ps,kill_round,close,silent_s", [
    ("port", "jax", 1, False, 0.0), ("jax", "port", 1, False, 0.0), ("port", "port", 2, True, 0.0),
    ("jax", "port", 2, True, 0.0), ("port", "port", 2, True, 25.0), ("jax", "port", 2, True, 25.0)],
    ids=["port-scheduler", "jax-scheduler", "port-last-round", "jax-scheduler-last-round",
         "port-last-round-silent-worker", "jax-scheduler-last-round-silent-worker"])
def test_kill_scheduler_e2e_bit_equal(tmp_path, scheduler, ps, kill_round, close, silent_s,
                                      monkeypatch):
    """The scheduler killed mid-job and restarted under its peer id adopts
    every live execution (the JAX and the torch worker and the server)
    with nothing re-dispatched, every round completes in the first
    attempt, and the server's final state is the run without the kill's,
    byte for byte. Under the port's scheduler with a JAX server, under the
    JAX scheduler with a torch server, and killed in the last round with a
    torch server, which commits and broadcasts that round during the
    outage: the adoption credits it, and the job completes once the
    server's parked notify is answered. The same under the JAX scheduler,
    which has no account of the parked notify: the torch server's
    execution still ends ``completed`` (its notify answered, or ended when
    the scheduler released its lease). A torch server's execution ends
    ``completed`` in every run. With a worker silent for 25 s at the
    adoption, the server's notify stays parked past it and the job still
    completes under either scheduler."""
    from _torch_parity import tiny_pair

    from hypha_tpu.executor.serialization import flatten_tree

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    ids = ((np.random.default_rng(3).integers(0, 256, (8, 1)) + np.arange(16)) % 256)
    for i in range(4):  # identical slices: whichever a worker draws, it sees the same
        save_file({"input_ids": ids.astype(np.int32)}, str(data_dir / f"slice_{i:04d}.safetensors"))
    FT_METRICS.reset()
    runs = {}
    for kill in (False, True):
        d = tmp_path / f"run-{kill}"
        d.mkdir()
        runs[kill] = asyncio.run(asyncio.wait_for(
            _kill_scheduler_run(scheduler, ps, kill_round, close, d, weights, data_dir, kill,
                                silent_s=silent_s),
            150))
    base, chaos = runs[False], runs[True]
    for r in (base, chaos):
        assert r["result"].rounds == 3 and r["result"].attempt == 0
        assert not r["journal_left"]  # the finished job wiped its journal
    assert chaos["result"].ft["active"] == ["wjax", "wtorch"]
    if close:  # the last round went out during the outage and was credited
        assert chaos["broadcast_first"]
        assert any("fast-forwarded round 2 -> 3" in line for line in chaos["lines"])
        if scheduler == "port":
            # The server's parked UPDATED was answered DONE before the job ended.
            assert any("round 2 UPDATED answered after" in line
                       for line in chaos["lines_at_done"])
        else:
            # The reference's scheduler completes from the adoption alone:
            # the server's parked UPDATED was answered before the job ended,
            # or ended when the scheduler released the server's lease.
            assert any("round 2 UPDATED answered after" in line
                       or "round 2 UPDATED: scheduler generation 2 adopted this execution and "
                          "released its lease" in line for line in chaos["lines"])
        if silent_s:
            # The notify stayed parked through the silent adoption.
            (parked,) = [float(line.rsplit(" in ", 1)[1].split(" s")[0])
                         for line in chaos["lines"] if "round 2 UPDATED answered after" in line
                         or "released its lease" in line]
            assert parked > silent_s, parked
    assert chaos["dispatched_before"] == 3 and chaos["dispatched_after"] == 0
    if ps == "port":
        assert base["ps_states"] == chaos["ps_states"] == ["completed"]
    if scheduler == "port":
        assert chaos["counts"]["scheduler_recoveries"] == 1
        assert chaos["counts"]["adopted_executions"] == 3
        assert chaos["counts"]["stale_generation_dropped"] == 0
    else:
        snap = FT_METRICS.snapshot()
        assert snap["scheduler_recoveries"] == 1 and snap["adopted_executions"] == 3
    assert sorted(chaos["state"]) == sorted(base["state"])
    assert chaos["state"] == base["state"], [k for k in base["state"]
                                             if base["state"][k] != chaos["state"][k]]
