"""Port parity: elastic rounds, the rejoin catch-up and the chaos injector
(``hypha_tpu_torch/ft``, ``worker/ps_executor.py``), then the orchestrated
fault-tolerant job on the CPU.

1. ``FTConfig``, ``RoundMembership`` and ``MembershipUpdate`` built in both
   packages from the same values give the same CBOR bytes and cross-decode;
   ``quorum_size`` and ``MembershipView`` agree step for step.
2. The elastic collector (``_collect_round_elastic``) of both packages'
   parameter servers, fed the same scripted pushes (the reference's
   ``tests/test_ft.py`` scenarios: the deadline at quorum, every active
   worker in, a stale delta, an early delta parked and credited, a re-send
   replacing, a non-member, a membership shrinking mid-round), accepts the
   same peers, parks the same ones, drains the same ones, and folds sums
   bit-equal (the port's ``RoundAccum`` against the reference's numpy one).
3. ``CatchupBuffer``: the same update files (f32, bf16 and int8 frames of
   either package) give byte-equal Σ in both packages, and each package
   reads the other's catch-up file; ``await_catchup``,
   ``merge_catchup_arrays`` and ``sum_updates`` agree.
4. The chaos spec grammar parses alike; the port's controller fires its
   kills at the round trigger, and every kind (the scheduler's too) acts
   on the same nodes as the reference's.
5. ``chip_smoke.run_ft_job`` on the CPU (a tiny Llama, int8 deltas, trainer
   processes), held to ``chip_smoke.ft_problems``: ``w1`` killed after
   round 0 and replaced by ``w2`` through the catch-up, the parameter
   server killed in round 3 and restarted under its peer id from its
   journal, the trainers' checkpoints.
6. A JAX and a torch worker share an elastic, checkpointed blocking job
   (θ₀ from a ``source`` file, or drawn by each trainer from the job's
   seed) under either package's scheduler, with the other package's
   parameter server.
7. The bridge client's ``receive`` ends its stream when its block ends (a
   stream left open kept catching the next round's broadcast: the rejoin
   path lost every update after its catch-up).
"""

from __future__ import annotations

import asyncio
import shutil
import tempfile
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import chip_smoke
from _torch_parity import tiny_pair
from hypha_tpu import compress as jcompress
from hypha_tpu import messages as jmsg
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.ft import chaos as jchaos
from hypha_tpu.ft import membership as jm
from hypha_tpu.ft import rejoin as jrejoin
from hypha_tpu.worker import ps_executor as jps
from hypha_tpu_torch import compress as tcompress
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor.serialization import load_file as tload
from hypha_tpu_torch.ft import chaos as tchaos
from hypha_tpu_torch.ft import membership as tm
from hypha_tpu_torch.ft import rejoin as trejoin
from hypha_tpu_torch.stream import RoundAccum
from hypha_tpu_torch.worker import ps_executor as tps


def run(coro, timeout=20):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# ---------------------------------------------------------------- messages

FT_CASES = {
    "ft default": lambda m: m.FTConfig(),
    "ft custom": lambda m: m.FTConfig(quorum_fraction=0.5, round_deadline_s=12.5,
                                      phi_threshold=6.0, rejoin_attempts=5,
                                      ps_restart_attempts=1, ps_restart_backoff_s=0.25),
    "ft adopt fields": lambda m: m.FTConfig(scheduler_adopt_grace_s=90.0,
                                            scheduler_adopt_deadline_s=15.0),
    "membership": lambda m: m.RoundMembership(epoch=7, active=["w0", "w2"], suspected=["w2"],
                                              departed=["w1"]),
    "membership steps": lambda m: m.RoundMembership(epoch=3, active=["a"],
                                                    inner_steps={"a": 12}),
    "update": lambda m: m.MembershipUpdate(
        job_id="j-ps", membership=m.RoundMembership(epoch=2, active=["w0", "w2"],
                                                    departed=["w1"]), joined=["w2"]),
}


@pytest.mark.parametrize("case", sorted(FT_CASES))
def test_ft_messages_encode_as_the_reference(case):
    jobj, tobj = FT_CASES[case](jm), FT_CASES[case](tm)
    jbytes, tbytes = jmsg.encode(jobj), tmsg.encode(tobj)
    assert tbytes == jbytes
    assert tmsg.decode(jbytes) == tobj
    assert jmsg.decode(tbytes) == jobj


def test_quorum_and_membership_view_agree():
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        for n in range(0, 9):
            assert tm.quorum_size(frac, n) == jm.quorum_size(frac, n), (frac, n)
    rng = np.random.default_rng(1)
    jv, tv = jm.MembershipView(["w0", "w1", "w2"]), tm.MembershipView(["w0", "w1", "w2"])
    for _ in range(40):
        op = rng.choice(["suspect", "reinstate", "depart", "join"])
        peer = f"w{rng.integers(0, 5)}"
        assert getattr(tv, op)(peer) == getattr(jv, op)(peer), (op, peer)
        assert tmsg.encode(tv.snapshot()) == jmsg.encode(jv.snapshot())
        assert tv.snapshot().quorum(0.75) == jv.snapshot().quorum(0.75)
        assert tv.snapshot().expected() == jv.snapshot().expected()


def test_ft_config_checks_match_the_reference():
    for bad in ({"quorum_fraction": 1.5}, {"round_deadline_s": -1.0}, {"phi_threshold": 0.0}):
        for m in (jm, tm):
            with pytest.raises(ValueError):
                m.FTConfig(**bad)
    assert tm.FTConfig(quorum_fraction=0.0).enabled is jm.FTConfig(quorum_fraction=0.0).enabled


# ------------------------------------------------------ elastic collector


class FakePush:
    def __init__(self, peer: str, round_num: int, value: float, samples: float):
        self.peer = peer
        self.resource = {"resource": "u", "name": f"d-{peer}", "round": round_num,
                         "num_samples": samples}
        self._tree = {"w": np.full((3,), value, np.float32),
                      "b": np.arange(4, dtype=np.float32) * value}
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


class FakeConsumer:
    def __init__(self, pushes):
        self._pushes = list(pushes)

    async def next(self, timeout=None):
        if self._pushes:
            return self._pushes.pop(0)
        await asyncio.sleep(min(timeout or 0.01, 0.01))
        raise asyncio.TimeoutError


def _cfg(m, peers, quorum_fraction, deadline):
    return m.AggregateExecutorConfig(
        updates=m.Receive(m.Reference.from_peers(list(peers), "u")),
        results=m.Send(m.Reference.from_peers(list(peers), "r")),
        optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=len(peers),
        quorum_fraction=quorum_fraction, round_deadline_s=deadline)


# (peers, quorum fraction, deadline s, [(round collected, [pushes])], a
# membership adopted 0.2 s into round 0 or None)
ELASTIC = {
    "deadline at quorum": (4, 0.75, 0.4, [(0, [("w0", 0, 1.0, 10.0), ("w1", 0, 2.0, 20.0),
                                              ("w2", 0, 3.0, 10.0)])], None),
    "all active reported": (2, 0.5, 30.0, [(0, [("w0", 0, 1.0, 1.0), ("w1", 0, 2.0, 1.0)])],
                            None),
    "stale delta": (2, 0.5, 0.3, [(1, [("w0", 0, 9.0, 1.0), ("w1", 1, 2.0, 1.0)])], None),
    "early delta parked": (2, 0.5, 0.3, [(0, [("w0", 1, 5.0, 1.0), ("w1", 0, 2.0, 1.0)]),
                                         (1, [("w1", 1, 1.0, 1.0)])], None),
    "re-send replaces": (2, 0.5, 0.3, [(0, [("w0", 0, 1.0, 10.0), ("w0", 0, 5.0, 10.0),
                                            ("w1", 0, 3.0, 10.0)])], None),
    "early re-send parks the latest": (2, 0.5, 0.3, [(0, [("w0", 1, 1.0, 1.0),
                                                          ("w0", 1, 7.0, 1.0),
                                                          ("w1", 0, 2.0, 1.0)]),
                                                     (1, [("w1", 1, 1.0, 1.0)])], None),
    "non-member dropped": (2, 0.5, 0.3, [(0, [("evil", 0, 100.0, 1.0), ("w0", 0, 1.0, 1.0)])],
                           None),
    "membership shrinks": (3, 0.5, 30.0, [(0, [("w0", 0, 1.0, 1.0), ("w1", 0, 2.0, 1.0)])],
                           ["w0", "w1"]),
}


async def _elastic(pkg: str, tmp: Path, case: str) -> list:
    n, frac, deadline, rounds, shrink = ELASTIC[case]
    peers = [f"w{i}" for i in range(n)]
    if pkg == "jax":
        m, mod = jmsg, jps
        cfg = _cfg(m, peers, frac, deadline)
        st, ps = mod._ElasticState(cfg, "sched"), mod.ParameterServerExecutor(None, tmp)
    else:
        m, mod = tmsg, tps
        cfg = _cfg(m, peers, frac, deadline)
        st, ps = mod._ElasticState(cfg, "sched"), mod.ParameterServerExecutor(None, tmp,
                                                                               device="cpu")
    out = []
    for round_num, script in rounds:
        pushes = [FakePush(*p) for p in script]
        accum = jps._RoundAccum() if pkg == "jax" else RoundAccum(device="cpu")
        collect = asyncio.create_task(ps._collect_round_elastic(
            FakeConsumer(pushes), "job", st, cfg, tmp, round_num, accum=accum))
        if shrink is not None and round_num == 0:
            await asyncio.sleep(0.2)
            assert not collect.done()  # still waiting for the third worker
            ft = jm if pkg == "jax" else tm
            st.adopt(ft.MembershipUpdate(job_id="job", membership=ft.RoundMembership(
                epoch=1, active=shrink, departed=sorted(set(peers) - set(shrink)))))
        received = await asyncio.wait_for(collect, 10)
        mean = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v).tobytes()
                for k, v in accum.mean().items()}
        out.append({"received": sorted(received), "early": sorted(
            (r, sorted(b)) for r, b in st.early.items()), "drained": [p.drained for p in pushes],
            "mean": mean, "total": float(accum.total_samples),
            "files": all(path.is_file() for path, _ in received.values())})
    return out


@pytest.mark.parametrize("case", sorted(ELASTIC))
def test_elastic_collector_matches_the_reference(case, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = run(_elastic("jax", tmp_path / "jax", case))
    got = run(_elastic("port", tmp_path / "port", case))
    assert got == want
    assert got[0]["received"]  # every scenario closes with someone


# ----------------------------------------------------------------- rejoin


def _updates(root: Path, codec: str, writer: str) -> list:
    rng = np.random.default_rng(11)
    shapes = {"params/embed_tokens": (40, 8), "params/layers_0/mlp/up_proj/kernel": (8, 24),
              "params/norm/weight": (8,)}
    paths = []
    for r in range(3):
        tree = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
        path = root / f"{writer}-{codec}-{r}.bin"
        if codec == "bf16" and writer == "jax":
            save_file({k: v.astype(ml_dtypes.bfloat16) for k, v in tree.items()}, str(path))
        elif writer == "jax":
            jcompress.write_delta(path, tree, codec)
        else:
            tcompress.write_delta(path, {k: torch.from_numpy(v) for k, v in tree.items()}, codec)
        paths.append(path)
    return paths


@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "int4"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_catchup_sum_is_byte_equal(tmp_path, codec, writer):
    paths = _updates(tmp_path, codec, writer)
    jbuf, tbuf = jrejoin.CatchupBuffer(), trejoin.CatchupBuffer()
    for p in paths:
        jbuf.accumulate(p)
        tbuf.accumulate(p)
    jcum, jrounds, jfr = jbuf.state()
    tcum, trounds, tfr = tbuf.state()
    assert (trounds, tfr) == (jrounds, jfr) == (3, {None: 3})
    assert sorted(tcum) == sorted(jcum)
    for k in jcum:
        assert tcum[k].dtype == np.float32 and tcum[k].tobytes() == jcum[k].tobytes(), k
    # Each package reads the other's catch-up file to the same bytes.
    jfile, tfile = jbuf.write(tmp_path / "j.safetensors"), tbuf.write(tmp_path / "t.safetensors")
    for k, v in load_file(str(tfile)).items():
        assert v.tobytes() == jcum[k].tobytes()
    for k, v in tload(jfile).items():
        assert v.numpy().tobytes() == jcum[k].tobytes()
    assert trejoin.sum_updates(paths).keys() == jrejoin.sum_updates(paths).keys()
    # A decoded tree (the server's encode returns one) folds the same way.
    tree_buf = trejoin.CatchupBuffer()
    for p in paths:
        tree_buf.accumulate_tree(tcompress.read_delta(p, device="cpu"))
    assert all(tree_buf.state()[0][k].tobytes() == jcum[k].tobytes() for k in jcum)


def test_catchup_helpers_agree(tmp_path):
    assert trejoin.CatchupBuffer().is_empty() and jrejoin.CatchupBuffer().is_empty()
    empty = trejoin.CatchupBuffer().write(tmp_path / "e.safetensors")
    assert load_file(str(empty)) == {}
    events = [{"path": "a", "meta": {"round": 3}}, {"path": "b", "meta": None},
              {"path": "c", "meta": {"round": 4, "catchup": True, "epoch": 2}}]
    got = {}
    for name, mod in (("jax", jrejoin), ("port", trejoin)):
        skipped = []
        got[name] = (mod.await_catchup(iter(events), on_skip=skipped.append)["path"],
                     [e["path"] for e in skipped])
        with pytest.raises(RuntimeError, match="catch-up"):
            mod.await_catchup(iter([{"path": "a", "meta": {}}]))
    assert got["port"] == got["jax"] == ("c", ["a", "b"])
    params = {"w": np.array([1.0, 2.0], np.float32), "h": np.array([3.0], np.float16)}
    cum = {"w": np.array([0.5, 0.25], np.float32), "h": np.array([0.125], np.float32)}
    a, b = trejoin.merge_catchup_arrays(params, cum), jrejoin.merge_catchup_arrays(params, cum)
    assert all(a[k].tobytes() == b[k].tobytes() and a[k].dtype == b[k].dtype for k in a)
    with pytest.raises(KeyError):
        trejoin.merge_catchup_arrays(params, {"x": np.zeros(1, np.float32)})


# ------------------------------------------------------------------ chaos

SPECS = ["kill-worker:2", "kill:1", "kill-ps:3", "delay-worker:1:0.25", "partition:2",
         "partition-ps:1:2.5", "kill-scheduler:2", "partition-scheduler:1", "slow-worker:3",
         "slow-worker:w2:4:1", "bw-cap:w1:10", "jitter:w3:0.5:2", "jitter-link:0.2"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_as_the_reference(spec):
    j, t = jchaos.parse_chaos_spec(spec, "wX"), tchaos.parse_chaos_spec(spec, "wX")
    fields = ("kind", "target", "at_round", "delay_s", "factor", "rate_bps")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]


def test_chaos_spec_errors_and_lists_match():
    for bad in ("explode:1", "bw-cap:10", "bw-cap:w1", "", "kill-worker:-1"):
        for mod in (jchaos, tchaos):
            with pytest.raises(ValueError):
                mod.parse_chaos_specs(bad, "w") if "," in bad or not bad else \
                    mod.parse_chaos_spec(bad, "w")
    j = jchaos.parse_chaos_specs("kill-worker:1, kill-ps:3", "w1")
    t = tchaos.parse_chaos_specs("kill-worker:1, kill-ps:3", "w1")
    assert [(a.kind, a.at_round) for a in t] == [(a.kind, a.at_round) for a in j]


class FakeWorker:
    def __init__(self):
        self.events = []
        node = type("N", (), {})()

        async def node_stop():
            self.events.append("node")

        node.stop = node_stop
        self.node = node

    async def stop(self):
        self.events.append("worker")


def test_chaos_controller_kills_at_the_round_trigger():
    async def scenario():
        w, ps = FakeWorker(), FakeWorker()
        seen = []
        ctl = tchaos.ChaosController(tchaos.parse_chaos_specs("kill-worker:2", "w1") + [
            tchaos.ChaosAction(kind="kill-ps", target="psw", at_round=3)], {"w1": w, "psw": ps})
        hook = ctl.metrics_hook(lambda p, r, m: seen.append((p, r)))
        hook("w1", 0, {})  # round 0 done, round 1 running: nothing fires
        await asyncio.sleep(0)
        assert not ctl.fired and not w.events
        hook("w1", 1, {})  # round 2 running: the worker's kill
        await ctl.drain()
        assert w.events == ["node", "worker"] and not ps.events
        ctl.on_round_metrics(2)
        ctl.on_round_metrics(2)  # fires once
        await ctl.drain()
        assert ps.events == ["node", "worker"] and len(ctl.fired) == 2
        assert seen == [("w1", 0), ("w1", 1)] and ctl.fired_at("psw") is not None

    run(scenario())


class _ChaosNode:
    """A node stand-in whose push drains its source (bytes or an async
    iterator of chunks) and whose request answers at once; every call is
    logged as ``(kind, node, peer, what)``."""

    def __init__(self, name: str, log: list) -> None:
        self.name, self.log, self._pull_handler = name, log, None

    async def push(self, peer_id, resource, source):
        if isinstance(source, (bytes, bytearray)):
            chunks = [bytes(source)]
        else:
            chunks = [c async for c in source]
        self.log.append(("push", self.name, peer_id, [len(c) for c in chunks]))
        return sum(len(c) for c in chunks)

    async def request(self, peer_id, protocol, msg, **kw):
        self.log.append(("request", self.name, peer_id, getattr(msg, "kind", None).value))
        return "ok"

    async def stop(self):
        self.log.append(("stop", self.name))

    def on_pull(self, handler):
        self._pull_handler = handler


async def _chaos_transcript(pkg, chaos, m, spec: str, monkeypatch) -> list:
    """One package's controller fires ``spec`` against three stand-in
    workers; every node then pushes 40 KiB to each other and sends the
    scheduler two Status and one Update message (a partition-ps heals and
    the script runs again). Sleeps are recorded, not slept; the slow
    kind's clock ticks 0.1 s a read."""
    log: list = []
    real_sleep = asyncio.sleep

    async def sleep(seconds, *a, **k):
        log.append(("sleep", round(float(seconds), 9)))
        await real_sleep(0)

    monkeypatch.setattr(asyncio, "sleep", sleep)
    ticks = iter(np.arange(1000) * 0.1)
    monkeypatch.setattr(chaos, "time", type("T", (), {"monotonic": staticmethod(lambda: float(next(ticks)))}))
    workers = {}
    # The scheduler kinds' victim is a scheduler entry (a node and stop()).
    for name in ("w0", "w1", "psw") + (("sched",) if "scheduler" in spec else ()):
        w = FakeWorker()
        w.node = _ChaosNode(name, log)
        workers[name] = w
    actions = chaos.parse_chaos_specs(spec, "w1")
    if "partition-ps" in spec:
        actions[0].target = "psw"
    elif "scheduler" in spec:
        actions[0].target = "sched"
    ctl = chaos.ChaosController(actions, workers)
    if actions[0].at_round:
        ctl.on_round_metrics(actions[0].at_round - 1)

    async def script():
        for name, w in workers.items():
            for peer in workers:
                if peer != name:
                    try:
                        await w.node.push(peer, {"resource": "r"}, bytes(40 * 1024))
                    except Exception as e:  # a partition's refusal, by type name
                        log.append(("raised", name, peer, type(e).__name__, str(e)))
            for kind in ("STATUS", "STATUS", "UPDATE"):
                msg = m.Progress(kind=m.ProgressKind[kind], job_id="j")
                try:
                    await w.node.request("sched", m.PROTOCOL_PROGRESS, msg)
                except Exception as e:
                    log.append(("raised", name, "sched", type(e).__name__, str(e)))

    await script()
    await ctl.drain()
    await script()
    return [[a.kind, a.target, a.at_round] for a in ctl.fired] + log


# The data-plane kinds and the two aimed at the scheduler: each fires
# against the same nodes, at the same round, with the same sleeps, drops,
# chunking and stops as the reference's.
@pytest.mark.parametrize("spec", ["delay-worker:1", "partition-ps:1", "slow-worker:2",
                                  "bw-cap:w1:10", "partition-worker:1", "jitter:w1:0.2",
                                  "kill-scheduler:1", "partition-scheduler:1"])
def test_chaos_kinds_fire_as_the_reference(spec, monkeypatch):
    got = {}
    for pkg, chaos, m in (("jax", jchaos, jmsg), ("port", tchaos, tmsg)):
        with monkeypatch.context() as mp:
            got[pkg] = run(_chaos_transcript(pkg, chaos, m, spec, mp))
    assert got["port"] == got["jax"]
    assert any(e[0] in ("sleep", "raised", "stop") for e in got["port"]), \
        "the action took effect"


# --------------------------------------------------- the orchestrated job

TINY = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
        "config": {"dtype": "float32"}, "seed": 0}


def test_orchestrated_kill_worker_and_kill_ps_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ``train_ft`` phase rehearsed on the CPU (a killed
    node's job reports ``cancelled`` at once, so the 10 s leases do not
    slow the departure or the restart), with its third fault: the
    scheduler killed in round 4 and restarted under its peer id."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = Path(tempfile.mkdtemp(prefix="tft"))
    try:
        run_ = asyncio.run(asyncio.wait_for(chip_smoke.run_ft_job(
            root, TINY, device="cpu", rounds=6, steps=3, batch=2, seq=16, period=64, lr=3e-3,
            deadline_s=30.0, limit_s=60, auction_timeout=1.0, status_timeout=60.0), 180))
        rep = chip_smoke.ft_report(run_)
        problems = chip_smoke.ft_problems(run_, rep, rounds=6, steps=3, layers=2, device="cpu")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert problems == [], (problems, run_["logs"]["ps"][-30:])
    assert run_["result"].ft["departed"] == ["w1"] and run_["result"].ft["rejoins"] == 1
    assert rep["catchup"][0]["rounds"] == 2 and rep["replay"]["s"] >= 0
    assert rep["journal_records"] > 0 and rep["journal_bytes"] > 0
    assert rep["kill_to_departure_s"] >= 0 and rep["ps_kill_to_gen2_broadcast_s"] > 0
    # w2's stale round-... none: w2 joined at round 2 and delivered every round after.
    w2_rounds = sorted({d["round"] for d in run_["rec"]["deltas"] if d["from"] == "w2"})
    assert w2_rounds == [2, 3, 4, 5]
    sched = rep["scheduler"]
    assert sched["adopted"]["round"] == 5 and sched["kill_to_restart_s"] > 0
    assert {a["peer"] for a in sched["acks"]} == {"w0", "w2", "psw"}


# ------------------------------------------- a mixed JAX/torch elastic job


def _mixed_ft_job(pkg: str, weights: "Path | None", ckpt: Path, family: str = "llama"):
    from hypha_tpu.scheduler import job_config as jjob
    from hypha_tpu_torch.scheduler import job_config as tjob

    m, job, ft = (jmsg, jjob, jm) if pkg == "jax" else (tmsg, tjob, tm)
    model = {"model_type": "causal-lm", "family": family, "preset": "tiny",
             "config": {"dtype": "float32"}, "seed": 7}
    if weights is not None:
        model["source"] = m.to_json_dict(m.Fetch(m.Reference.from_uri(weights.as_uri())))
    res = (jmsg if pkg == "jax" else tmsg)
    from hypha_tpu.resources import Resources as JRes
    from hypha_tpu_torch.resources import Resources as TRes

    R = JRes if pkg == "jax" else TRes
    return job.DiLoCoJob(
        model=model, dataset="counting",
        rounds=job.DiLoCoRounds(update_rounds=2, avg_samples_between_updates=8, max_batch_size=2),
        inner_optimizer=res.Adam(lr=3e-3), outer_optimizer=res.Nesterov(lr=0.7, momentum=0.9),
        resources=job.JobResources(
            num_workers=2, worker=R(gpu=1.0, cpu=1.0, memory=10),
            parameter_server=R(cpu=1.0, memory=10),
            worker_price=res.PriceRange(bid=1.0, max=10.0),
            parameter_server_price=res.PriceRange(bid=1.0, max=10.0)),
        ft=ft.FTConfig(quorum_fraction=0.5, round_deadline_s=30.0),
        checkpoint_dir=str(ckpt))


@pytest.mark.parametrize("scheduler", ["jax", "port", "port-seeded", "jax-mixtral-seeded"])
def test_mixed_workers_run_an_elastic_job(tmp_path, scheduler, monkeypatch):
    """A JAX and a torch worker under ``scheduler``'s orchestrator, gateway
    and data node, the parameter server the other package's (so the
    membership and the durable journal cross packages): every round
    closes with both workers' deltas, every membership snapshot the server
    adopted came from the scheduler, and both trainers checkpoint.
    ``port-seeded`` ships no ``source``: each trainer draws θ₀ from the
    job's seed (``models/seed_init.py`` in the port), and the two draws
    are bit-equal, so a torch rejoiner's θ₀ + Σ is the job's (before, the
    port drew another θ₀). ``jax-mixtral-seeded`` is that job on a tiny
    Mixtral under the JAX scheduler: both θ₀ bit-equal, and the two
    trainers' Δθ files carry the same names, dtypes and shapes each round
    (the router's ``moe/gate/kernel`` transposed, the expert stacks in the
    flax layout)."""
    from hypha_tpu.data_node import DataNode as JDataNode
    from hypha_tpu.gateway import Gateway as JGateway
    from hypha_tpu.network import Node as JNode
    from hypha_tpu.network import TcpTransport as JTcp
    from hypha_tpu.resources import Resources as JResources
    from hypha_tpu.scheduler.orchestrator import Orchestrator as JOrch
    from hypha_tpu.worker.arbiter import OfferConfig as JOffer
    from hypha_tpu.worker.runtime import WorkerNode as JWorkerNode
    from hypha_tpu_torch.data_node import DataNode as TDataNode
    from hypha_tpu_torch.executor.checkpoint import latest_manifest
    from hypha_tpu_torch.gateway import Gateway as TGateway
    from hypha_tpu_torch.network import Node as TNode
    from hypha_tpu_torch.network import TcpTransport as TTcp
    from hypha_tpu_torch.resources import Resources as TResources
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator as TOrch
    from hypha_tpu_torch.worker.arbiter import OfferConfig as TOffer
    from hypha_tpu_torch.worker.runtime import WorkerNode as TWorkerNode

    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        starts = rng.integers(0, 256, (8, 1))
        save_file({"input_ids": ((starts + np.arange(16)) % 256).astype(np.int32)},
                  str(data_dir / f"slice_{i:04d}.safetensors"))
    ckpt = tmp_path / "ckpt"
    family = "mixtral" if "mixtral" in scheduler else "llama"
    seeded = scheduler.endswith("seeded")
    scheduler = scheduler.split("-")[0]
    job = _mixed_ft_job(scheduler, None if seeded else weights, ckpt, family)
    listen = ["127.0.0.1:0"]
    short = Path(tempfile.mkdtemp(prefix="tmx"))  # a bridge socket path stays under 108 bytes

    async def main():
        if scheduler == "jax":
            gw = JGateway(JTcp(), peer_id="gw")
            await gw.start(listen)
            boot = [gw.node.listen_addrs[0]]
            data = JDataNode(JTcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot)
            psw = TWorkerNode(TTcp(), resources=TResources(cpu=4, memory=1000), device="cpu",
                              peer_id="psw", bootstrap=boot, work_root=short / "psw")
            sched = JNode(JTcp(), peer_id="sched", bootstrap=boot)
        else:
            gw = TGateway(TTcp(), peer_id="gw")
            await gw.start(listen)
            boot = [gw.node.listen_addrs[0]]
            data = TDataNode(TTcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot)
            psw = JWorkerNode(JTcp(), resources=JResources(cpu=4, memory=1000), peer_id="psw",
                              bootstrap=boot, work_root=short / "psw")
            sched = TNode(TTcp(), peer_id="sched", bootstrap=boot)
        wj = JWorkerNode(JTcp(), resources=JResources(gpu=2, cpu=8, memory=1000),
                         peer_id="wjax", offer=JOffer(strategy="whole"), bootstrap=boot,
                         work_root=short / "wjax")
        wt = TWorkerNode(TTcp(), resources=TResources(gpu=2, cpu=8, memory=1000), device="cpu",
                         peer_id="wtorch", offer=TOffer(strategy="whole"), bootstrap=boot,
                         work_root=short / "wtorch")
        parts = [data, wj, wt, psw, sched]
        started = []
        try:
            for part in parts:
                await part.start(listen)
                started.append(part)
            await sched.wait_for_bootstrap()
            orch = (JOrch if scheduler == "jax" else TOrch)(sched)
            return await orch.run(job, auction_timeout=1.0, status_timeout=60.0)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    theta0 = {"jax": [], "torch": []}  # each trainer's θ₀, as flat f32 arrays
    if seeded:
        from hypha_tpu.models import llama as jllama
        from hypha_tpu.models import mixtral as jmixtral
        from hypha_tpu_torch.models import llama as tllama
        from hypha_tpu_torch.models.convert import llama_params_to_flat

        jmodel = jmixtral.Mixtral if family == "mixtral" else jllama.Llama
        j_init, t_init = jmodel.init, tllama.Llama.init_weights  # Mixtral's is Llama's

        def record_jax(self, *a, **kw):
            out = j_init(self, *a, **kw)
            theta0["jax"].append({k: np.asarray(v) for k, v in flatten_tree(out).items()})
            return out

        def record_torch(self, seed=0):
            out = t_init(self, seed)
            # A copy: on the CPU the flat arrays alias the trained parameters.
            theta0["torch"].append({k: v.copy() for k, v in llama_params_to_flat(self).items()})
            return out

        monkeypatch.setattr(jmodel, "init", record_jax)
        monkeypatch.setattr(tllama.Llama, "init_weights", record_torch)
    try:
        with chip_smoke.node_probes("cpu") as rec:
            result = asyncio.run(asyncio.wait_for(main(), 120))
    finally:
        shutil.rmtree(short, ignore_errors=True)
    assert result.rounds == 2 and result.attempt == 0
    assert result.ft["active"] == ["wjax", "wtorch"] and result.ft["departed"] == []
    losses = {(w, r) for w, r, _ in result.metrics}
    assert losses == {(w, r) for w in ("wjax", "wtorch") for r in range(2)}
    for peer in ("wjax", "wtorch"):
        manifest = latest_manifest(ckpt / peer)
        assert manifest is not None and manifest["round"] == 2, (peer, manifest)
    assert (ckpt / "ps" / "journal.cbor").is_file()
    if seeded:  # one θ₀, drawn by each package from the seed
        (jtheta,), (ttheta,) = theta0["jax"], theta0["torch"]
        assert set(jtheta) == set(ttheta)
        for name in jtheta:
            assert np.array_equal(jtheta[name].view(np.uint32), ttheta[name].view(np.uint32)), name
    if scheduler == "jax":  # the port's server folded both deltas each round
        assert sorted((d["from"], d["round"]) for d in rec["deltas"]) == sorted(
            (w, r) for w in ("wjax", "wtorch") for r in range(2))
    if family == "mixtral":  # one Δθ layout on the wire from both packages
        for r in range(2):
            wire = {d["from"]: d["tensors"] for d in rec["deltas"] if d["round"] == r}
            assert wire["wjax"] == wire["wtorch"], r
        names = wire["wtorch"]
        assert names["params/layers_1/moe/w_down"] == ("F32", (4, 128, 64))
        assert names["params/layers_0/moe/gate/kernel"] == ("F32", (64, 4))


@pytest.mark.parametrize("over", [
    {"job.quorum_fraction": 0.5, "job.round_deadline_s": 45.0, "job.phi_threshold": 6.0},
    {"job.checkpoint_dir": "/ckpt", "job.checkpoint_every": 2,
     "job.ps_checkpoint_every_rounds": 3},
    {"job.quorum_fraction": 0.75, "job.checkpoint_dir": "/ckpt", "job.delta_codec": "int8"},
], ids=["ft keys", "checkpoint keys", "both"])
def test_toml_ft_and_checkpoint_keys_build_the_reference_job(over):
    """A TOML job with the reference's elastic and checkpoint keys builds
    the same ``DiLoCoJob`` bytes under either package's scheduler config."""
    from hypha_tpu import config as jcfg
    from hypha_tpu import node_config as jnc
    from hypha_tpu_torch import config as tcfg
    from hypha_tpu_torch import node_config as tnc

    over = {**over, "job.dataset": "counting", "job.worker_tpu": 0.0}
    jjob = jcfg.builder(jnc.SchedulerConfig).with_overrides(over).build().validate().value.job
    tjob = tcfg.builder(tnc.SchedulerConfig).with_overrides(over).build().validate().value.job
    # The job's resources differ by the accelerator axis alone (gpu asked).
    want, got = jmsg.to_json_dict(jjob.to_job()), tmsg.to_json_dict(tjob.to_job())
    want["resources"]["worker"]["gpu"] = got["resources"]["worker"]["gpu"]
    assert tmsg.codec.dumps(got) == jmsg.codec.dumps(want)
    assert (tjob.to_job().ft is None) == ("job.quorum_fraction" not in over)


def _ft_dispatch(pkg: str) -> tuple:
    """Each package's orchestrator plans an elastic, checkpointed job for
    fixed peers and a fixed base id: every DispatchJob it would send, and
    a rejoiner's."""
    from types import SimpleNamespace

    from hypha_tpu.stream import placement_parts
    from test_torch_scheduler import BASE_ID, PKG, _jobs

    jobs = _jobs(**{k: {"ft": (jm if k == "jax" else tm).FTConfig(quorum_fraction=0.5),
                        "checkpoint_dir": "/ckpt", "checkpoint_every": 2,
                        "ps_checkpoint_every_rounds": 3} for k in PKG})
    job = jobs[pkg]
    orch = PKG[pkg].orch.Orchestrator(SimpleNamespace(peer_id="sched"))
    ctx = PKG[pkg].orch._RunContext()
    ctx.job, ctx.base_id, ctx.ft = job, BASE_ID, job.ft
    workers = ["w0", "w1"]
    handles = [SimpleNamespace(peer_id=p, lease_id=f"lease-{p}", batch_size=2)
               for p in workers + ["w2"]]
    ps_handle = SimpleNamespace(peer_id="psw", lease_id="lease-psw", batch_size=0)
    ctx.ps_handles = [ps_handle]
    if pkg == "jax":
        orch._plan_streams(ctx, job, workers, ["psw"], 1, placement_parts("blocking", 0, 1))
    else:
        orch._plan_streams(ctx, job, workers, ["psw"])
    m = PKG[pkg].m
    sent = [m.DispatchJob(lease_id=ps_handle.lease_id, spec=ctx.ps_specs[0])]
    sent += [m.DispatchJob(lease_id=h.lease_id, spec=orch._train_spec(ctx, f"w{i}", h))
             for i, h in enumerate(handles[:2])]
    sent.append(m.DispatchJob(lease_id="lease-w2",
                              spec=orch._train_spec(ctx, "r0", handles[2], rejoin=True)))
    return [m.encode(msg) for msg in sent]


def test_elastic_checkpointed_specs_dispatch_as_the_reference():
    t, j = _ft_dispatch("port"), _ft_dispatch("jax")
    assert t == j
    agg = tmsg.decode(t[0]).spec.executor.aggregate
    assert (agg.checkpoint_dir, agg.quorum_fraction, agg.ps_checkpoint_every_rounds) == \
        ("/ckpt/ps", 0.5, 3)
    rejoin = tmsg.decode(t[3]).spec.executor.train
    assert rejoin.rejoin is True and rejoin.checkpoint == {"dir": "/ckpt/w2", "every_rounds": 2}


def test_batch_scheduler_takes_a_departure_and_a_join_mid_round():
    """Both packages' batch schedulers, one injected clock, the same
    messages, the trainers' countdown (``adopt_schedule``): w1 leaves after
    its second batch of round 0 (``remove_worker``), w2 joins after w0's
    first batch of round 1 (``add_worker``); every answer agrees and the
    job completes on w0 and w2."""
    from test_torch_scheduler import _Pair

    K = jmsg.ProgressKind
    now = [0.0]
    pair = _Pair([2, 2], 16, 3, now)

    def both(fn):
        for pkg in ("jax", "port"):
            fn(pair.bs[pkg].tracker)

    active, countdown, waiting, done = ["w0", "w1"], {}, set(), set()
    r, beats = 0, {}
    for _ in range(2000):
        if r == 3 or len(done) == len(active):
            break
        training = [p for p in active if p not in waiting and p not in done]
        if not training:
            pair.send("ps", kind=K.UPDATED, round=r)
            for peer in sorted(waiting):
                now[0] += 0.1
                if pair.send(peer, kind=K.UPDATE_RECEIVED).kind.value == "done":
                    done.add(peer)
            waiting.clear()
            r += 1
            continue
        for peer in training:
            now[0] += 0.5
            resp = pair.send(peer, kind=K.STATUS, batch_size=2)
            beats[(peer, r)] = beats.get((peer, r), 0) + 1
            if resp.kind.value == "schedule-update" and countdown.get(peer) is None:
                countdown[peer] = resp.counter
            if countdown.get(peer) is not None and countdown[peer] <= 0:
                countdown[peer] = None
                pair.send(peer, kind=K.UPDATE)
                waiting.add(peer)
            elif countdown.get(peer) is not None:
                countdown[peer] -= 1
            if peer == "w1" and beats[(peer, r)] == 2 and r == 0:
                both(lambda t: t.remove_worker("w1"))
                active.remove("w1")
                waiting.discard("w1")
            if peer == "w0" and r == 1 and beats[(peer, r)] == 1 and "w2" not in active:
                both(lambda t: t.add_worker("w2", 2))
                active.append("w2")
    assert r == 3 and pair.done == {"jax": [True], "port": [True]}, (r, pair.answers[-5:])
    assert pair.bs["port"].tracker.peers == pair.bs["jax"].tracker.peers == ["w0", "w2"]
    assert {"schedule-update", "done"} <= {a[0] for a in pair.answers}
    assert beats.get(("w2", 1), 0) > 0 and ("w1", 1) not in beats


# ------------------------------------------------------- the bridge client


def test_session_receive_ends_its_stream_with_its_block(tmp_path):
    """A push that lands after a ``receive`` block ended (its events still
    referenced, as the rejoin's are) reaches the next ``receive``."""
    import threading

    from hypha_tpu_torch.executor.bridge_client import Session
    from hypha_tpu_torch.network import MemoryTransport, Node
    from hypha_tpu_torch.worker.bridge import Bridge
    from hypha_tpu_torch.worker.connectors import Connector

    async def main():
        hub = MemoryTransport()
        ps, w = Node(hub.shared(), peer_id="ps"), Node(hub.shared(), peer_id="w")
        for n in (ps, w):
            await n.start()
        ps.add_peer_addr("w", w.listen_addrs[0])
        bridge = Bridge(w, tmp_path, "job", "sched", Connector(w, "sched"))
        sock = await bridge.start()
        ref = tmsg.Receive(tmsg.Reference.from_peers(["ps"], "results"))
        files = []
        for i in range(2):
            f = tmp_path / f"u{i}.bin"
            f.write_bytes(bytes([i]) * 64)
            files.append(f)
        got, kept = [], []

        def trainer():
            with Session(str(sock)) as session:
                with session.receive(ref) as events:
                    got.append(next(events))
                    kept.append(events)  # still referenced after the block
                with session.receive(ref) as events:
                    got.append(next(events))

        thread = threading.Thread(target=trainer)
        thread.start()
        for i, f in enumerate(files):
            while len(got) < i:
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.3)
            await ps.push("w", {"resource": "results", "name": f.name, "round": i}, f)
        for _ in range(500):
            if not thread.is_alive():
                break
            await asyncio.sleep(0.01)
        alive = thread.is_alive()
        await bridge.stop()
        for n in (ps, w):
            await n.stop()
        thread.join(5)
        return alive, got

    alive, got = run(main(), 30)
    assert not alive and [e["meta"]["round"] for e in got] == [0, 1]
