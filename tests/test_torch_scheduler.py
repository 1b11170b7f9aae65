"""Port parity: the scheduler's pure logic, its wire and its job.

The same seeded inputs and the same injected clock go through
``hypha_tpu/scheduler/`` and ``hypha_tpu_torch/scheduler/``:

* ``RunningMean`` and ``project`` (the reference's scenarios of
  ``tests/test_scheduling.py`` in both packages, and seeded fleets compared
  field for field);
* ``SliceTracker`` (affinity, stealing, a new epoch, removal; a seeded
  operation sequence) and ``DataScheduler.assign``;
* ``ProgressTracker`` (counts, stats, rounds; seeded clocks);
* ``BatchScheduler`` driven through whole rounds by seeded fleets of 1, 2
  and 3 workers, every message put through the JAX codec and decoded by
  the port's: each response (kind, counter, message) equal to the JAX
  scheduler's, message by message; and its error answers;
* ``Candidates``, the allocator's offer aggregation, ``batch_size_for``
  and the adaptive watchdog's deadline;
* ``DiLoCoJob`` and the dispatched train and aggregate specs
  (``_train_spec``, ``_plan_streams`` for fixed peers and a fixed base id)
  encoded by both codecs, byte for byte;
* ``BatchScheduler`` with a ``StragglerController`` (``adaptive``) over a
  transcript of whole rounds, answers and assignments equal;
* every job option the port does not run raising ``NotImplementedError``
  with its ROADMAP.md label, one case per option.
"""

from __future__ import annotations

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest

from hypha_tpu import messages as jmsg
from hypha_tpu.resources import Resources as JResources
from hypha_tpu.scheduler import allocator as jalloc
from hypha_tpu.scheduler import batch_scheduler as jbs
from hypha_tpu.scheduler import data_scheduler as jds
from hypha_tpu.scheduler import job_config as jjob
from hypha_tpu.scheduler import metrics_bridge as jmb
from hypha_tpu.scheduler import orchestrator as jorch
from hypha_tpu.scheduler import simulation as jsim
from hypha_tpu.scheduler import statistics as jstat
from hypha_tpu.scheduler import trackers as jtr
from hypha_tpu.stream import placement_parts
from hypha_tpu_torch import aio as taio
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.resources import Resources as TResources
from hypha_tpu_torch.scheduler import allocator as talloc
from hypha_tpu_torch.scheduler import batch_scheduler as tbs
from hypha_tpu_torch.scheduler import data_scheduler as tds
from hypha_tpu_torch.scheduler import job_config as tjob
from hypha_tpu_torch.scheduler import metrics_bridge as tmb
from hypha_tpu_torch.scheduler import orchestrator as torch_orch
from hypha_tpu_torch.scheduler import simulation as tsim
from hypha_tpu_torch.scheduler import statistics as tstat
from hypha_tpu_torch.scheduler import trackers as ttr
from hypha_tpu_torch.scheduler import worker_handle as twh

PKG = {
    "jax": SimpleNamespace(m=jmsg, R=JResources, alloc=jalloc, bs=jbs, ds=jds, job=jjob, mb=jmb,
                           orch=jorch, sim=jsim, stat=jstat, tr=jtr),
    "port": SimpleNamespace(m=tmsg, R=TResources, alloc=talloc, bs=tbs, ds=tds, job=tjob, mb=tmb,
                            orch=torch_orch, sim=tsim, stat=tstat, tr=ttr),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


# -- statistics ---------------------------------------------------------------


def test_running_mean_matches_on_seeded_samples():
    rng = np.random.default_rng(0)
    j, t = jstat.RunningMean(), tstat.RunningMean()
    assert j.mean() is None and t.mean() is None
    for v in rng.exponential(300.0, 50):
        j.record(float(v))
        t.record(float(v))
        assert t.mean() == j.mean() and t.count == j.count


@BOTH
def test_runtime_statistic_is_abstract(pkg):
    stat = PKG[pkg].stat.RuntimeStatistic()
    with pytest.raises(NotImplementedError):
        stat.record(1.0)
    with pytest.raises(NotImplementedError):
        stat.mean()


# -- simulation: tests/test_scheduling.py's scenarios, in both packages --------

# name -> (remaining, [(batch, mean_ms, elapsed_ms)], kwargs, expected fields)
SCENARIOS = {
    "single_worker": (30, [(10, 100.0, 0.0)], {"updates_cap": 10},
                      {"left": 0, "capped": False, "updates": (3,), "time_ms": 300.0}),
    "heterogeneous": (50, [(10, 50.0, 0.0), (10, 200.0, 0.0)], {"updates_cap": 10},
                      {"left": 0, "capped": False, "updates": (4, 1)}),
    "elapsed_credit": (10, [(10, 100.0, 80.0)], {"updates_cap": 10},
                       {"updates": (1,), "time_ms": 20.0}),
    "updates_cap": (1000, [(10, 100.0, 0.0)], {"updates_cap": 3},
                    {"capped": True, "updates": (3,)}),
    "time_cap": (10_000, [(1, 5_000.0, 0.0)], {"time_cap_ms": 10_000.0, "updates_cap": 100},
                 {"capped": True}),
    "no_statistics": (100, [(10, None, 0.0)], {},
                      {"capped": True, "left": 100, "no_stats": True}),
    "nothing_remaining": (0, [(10, 100.0, 0.0)], {},
                          {"left": 0, "capped": False, "updates": (0,)}),
}


def _project(pkg, remaining, workers, kwargs):
    sim = PKG[pkg].sim
    return sim.project(remaining, [sim.WorkerSim(b, m, e) for b, m, e in workers], **kwargs)


def _fields(p) -> tuple:
    return (p.time_ms, p.left, p.updates, p.capped, p.no_stats)


@BOTH
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_project_scenario(pkg, name):
    remaining, workers, kwargs, want = SCENARIOS[name]
    p = _project(pkg, remaining, workers, kwargs)
    for field, value in want.items():
        assert getattr(p, field) == pytest.approx(value), field


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_project_scenario_parity(name):
    remaining, workers, kwargs, _ = SCENARIOS[name]
    assert _fields(_project("port", remaining, workers, kwargs)) == \
        _fields(_project("jax", remaining, workers, kwargs))


@pytest.mark.parametrize("seed", range(4))
def test_project_seeded_fleets(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        n = int(rng.integers(1, 6))
        workers = [(int(rng.integers(1, 9)),
                    None if rng.random() < 0.05 else float(rng.uniform(10, 6000)),
                    float(rng.uniform(0, 3000))) for _ in range(n)]
        remaining = int(rng.integers(-4, 120))
        kwargs = {"updates_cap": int(rng.integers(1, 6)),
                  "time_cap_ms": float(rng.choice([10_000.0, 2_000.0, float("inf")]))}
        assert _fields(_project("port", remaining, workers, kwargs)) == \
            _fields(_project("jax", remaining, workers, kwargs))


# -- slice tracker ------------------------------------------------------------


@BOTH
def test_slice_affinity_and_fresh_assignment(pkg):
    t = PKG[pkg].tr.SliceTracker(4)
    a0 = t.next("A")
    assert t.next("A") == a0
    t.mark_processed(a0)
    assert t.next("A") != a0


@BOTH
def test_slice_stealing_from_slowest(pkg):
    t = PKG[pkg].tr.SliceTracker(4)
    for peer in ("A", "A", "A", "B"):
        t._assigned[len(t._assigned)] = peer
    assert t.next("C") == 3 and t._assigned[3] == "C"


@BOTH
def test_slice_new_epoch_when_exhausted(pkg):
    t = PKG[pkg].tr.SliceTracker(2)
    for _ in range(2):
        t.mark_processed(t.next("A"))
    assert t.epoch == 0
    assert t.next("A") == 0 and t.epoch == 1


@BOTH
def test_slice_remove_worker_reclaims(pkg):
    t = PKG[pkg].tr.SliceTracker(3)
    s = t.next("A")
    t.remove_worker("A")
    assert s in t.available()


@pytest.mark.parametrize("seed", range(3))
def test_slice_tracker_seeded_operations(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    j, t = jtr.SliceTracker(n), ttr.SliceTracker(n)
    peers = ["A", "B", "C"]
    for _ in range(300):
        op, peer = rng.integers(0, 10), peers[int(rng.integers(0, 3))]
        if op < 6:
            assert t.next(peer) == j.next(peer)
        elif op < 9:
            held = j.remaining_of(peer)
            if held:
                index = held[int(rng.integers(0, len(held)))]
                j.mark_processed(index)
                t.mark_processed(index)
        else:
            j.remove_worker(peer)
            t.remove_worker(peer)
        assert (t.available(), t.epoch, t._assigned) == (j.available(), j.epoch, j._assigned)


@pytest.mark.parametrize("seed", range(3))
def test_data_scheduler_assigns_the_same_slices(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    node = SimpleNamespace(peer_id="sched")
    j, t = jds.DataScheduler(node, "data", "d", n), tds.DataScheduler(node, "data", "d", n)
    for _ in range(60):
        peer = f"w{int(rng.integers(0, 3))}"
        if rng.random() < 0.05:
            j.remove_worker(peer)
            t.remove_worker(peer)
            continue
        assert t.assign(peer) == j.assign(peer)
        assert t.held_of(peer) == j.held_of(peer)
    # A prefetch window (the input pipeline) holds that many slices alike.
    for _ in range(30):
        peer, window = f"w{int(rng.integers(0, 3))}", int(rng.integers(1, 4))
        assert t.assign(peer, prefetch=window) == j.assign(peer, prefetch=window)
        assert t.held_of(peer) == j.held_of(peer)
        assert t.tracker.epoch == j.tracker.epoch


# -- progress tracker ---------------------------------------------------------


def _tracker(pkg, clock, batch_sizes=(10, 10), target=100, epochs=2):
    t = PKG[pkg].tr.ProgressTracker("ps-peer", update_target=target, update_epochs=epochs,
                                    clock=clock)
    for i, b in enumerate(batch_sizes):
        t.add_worker(f"w{i}", b)
    return t


@BOTH
def test_progress_tracker_counts_and_stats(pkg):
    now = [0.0]
    t = _tracker(pkg, lambda: now[0])
    now[0] = 0.1
    t.update("w0", 10)
    assert t.counter == 90 and t.stats[0].mean() == pytest.approx(100.0)
    now[0] = 0.3
    t.update("w0", 10)
    assert t.stats[0].mean() == pytest.approx(150.0)


@BOTH
def test_progress_tracker_rounds(pkg):
    t = _tracker(pkg, lambda: 0.0, target=50, epochs=3)
    t.counter = 0
    t.advance_round()
    assert (t.round, t.counter, t.rounds_left, t.is_last_round()) == (1, 50, 2, False)
    t.advance_round()
    assert t.is_last_round()
    with pytest.raises(ValueError):
        t.add_worker("w0", 10)


def test_progress_tracker_seeded_clock():
    rng = np.random.default_rng(5)
    now = [0.0]
    j = _tracker("jax", lambda: now[0], batch_sizes=(2, 3, 5), target=40, epochs=3)
    t = _tracker("port", lambda: now[0], batch_sizes=(2, 3, 5), target=40, epochs=3)
    states = list(jtr.WorkerState)
    for _ in range(200):
        now[0] += float(rng.exponential(0.3))
        peer, r = f"w{int(rng.integers(0, 3))}", rng.random()
        if r < 0.8:
            j.update(peer, j.batch_sizes[j.index_of(peer)])
            t.update(peer, t.batch_sizes[t.index_of(peer)])
        elif r < 0.95:
            k = int(rng.integers(0, len(states)))
            j.set_state(peer, states[k])
            t.set_state(peer, ttr.WorkerState(states[k].value))
        elif j.round < 3:
            j.advance_round()
            t.advance_round()
        assert (t.counter, t.round, t.stats_version, t.sim_batch_total) == \
            (j.counter, j.round, j.stats_version, j.sim_batch_total)
        assert [(s.batch_size, s.mean_batch_ms, s.elapsed_ms) for s in t.sims()] == \
            [(s.batch_size, s.mean_batch_ms, s.elapsed_ms) for s in j.sims()]
        assert t.has_full_stats() == j.has_full_stats()
        assert t.all_in(ttr.WorkerState.TRAINING) == j.all_in(jtr.WorkerState.TRAINING)


# -- batch scheduler: whole rounds, message by message -------------------------


def _answer(resp) -> tuple:
    return (resp.kind.value, resp.counter, resp.message)


class _Pair:
    """The JAX and the port batch scheduler on one injected clock. Each
    message is built in the JAX package, encoded by its codec and decoded
    by the port's: the two answers must agree."""

    def __init__(self, batches, target, rounds, now, generation=None):
        self.now = now
        self.last: dict = {}
        self.done = {"jax": [], "port": []}
        self.metrics = {"jax": [], "port": []}
        self.bs = {}
        for pkg in ("jax", "port"):
            tracker = PKG[pkg].tr.ProgressTracker("ps", update_target=target,
                                                  update_epochs=rounds, clock=lambda: now[0])
            for i, b in enumerate(batches):
                tracker.add_worker(f"w{i}", int(b))
            self.bs[pkg] = PKG[pkg].bs.BatchScheduler(
                tracker, on_metrics=lambda p, r, m, pkg=pkg: self.metrics[pkg].append((p, r, m)),
                on_complete=lambda pkg=pkg: self.done[pkg].append(True),
                generation=generation)
        self.answers: list = []

    def send(self, peer, **fields):
        msg = jmsg.Progress(**fields)
        j = self.bs["jax"].on_progress(peer, msg)
        t = self.bs["port"].on_progress(peer, tmsg.decode(jmsg.encode(msg)))
        self.last = {"jax": j, "port": t}
        assert _answer(t) == _answer(j), (peer, fields)
        self.answers.append(_answer(j))
        return j


def _drive_rounds(n, seed):
    """A seeded fleet of ``n`` workers through whole rounds: each worker's
    batches take its own time (jittered), a SCHEDULE_UPDATE counter is
    counted down as the trainer does (``adopt_schedule``), the parameter
    server's UPDATED follows the last UPDATE, each worker's UPDATE_RECEIVED
    follows in a seeded order."""
    rng = np.random.default_rng(seed)
    K = jmsg.ProgressKind
    speed = rng.uniform(0.2, 4.0, n)  # seconds a batch
    batches = rng.integers(1, 5, n)
    target = int(batches.sum() * rng.integers(2, 6))
    rounds = int(rng.integers(2, 4))
    now = [0.0]
    pair = _Pair(batches, target, rounds, now)
    peers = [f"w{i}" for i in range(n)]
    due = {p: float(rng.uniform(2.0, 20.0)) for p in peers}  # start-up, then batches
    countdown = {p: None for p in peers}
    waiting, done, r = set(), set(), 0
    for _ in range(10_000):
        if len(done) == n:
            break
        training = [p for p in peers if p not in waiting and p not in done]
        if not training:
            resp = pair.send("ps", kind=K.UPDATED, round=r)
            assert resp.kind.value == ("done" if r == rounds - 1 else "ok")
            for p in rng.permutation(sorted(waiting)):
                now[0] += float(rng.uniform(0.01, 0.5))
                resp = pair.send(str(p), kind=K.UPDATE_RECEIVED)
                if resp.kind.value == "done":
                    done.add(str(p))
                else:
                    assert resp.kind.value == "continue"
                    due[str(p)] = now[0] + speed[peers.index(str(p))] * float(rng.uniform(0.8, 1.2))
            waiting.clear()
            r += 1
            continue
        peer = min(training, key=due.get)
        now[0] = due[peer]
        i = peers.index(peer)
        resp = pair.send(peer, kind=K.STATUS, batch_size=int(batches[i]))
        if resp.kind.value == "schedule-update" and countdown[peer] is None:
            countdown[peer] = resp.counter
        if countdown[peer] is not None and countdown[peer] <= 0:
            countdown[peer] = None
            pair.send(peer, kind=K.UPDATE)
            pair.send(peer, kind=K.METRICS, round=r, metrics={"loss": float(rng.random())})
            waiting.add(peer)
        else:
            if countdown[peer] is not None:
                countdown[peer] -= 1
            due[peer] = now[0] + speed[i] * float(rng.uniform(0.8, 1.2))
    assert len(done) == n and r == rounds
    return pair


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("seed", range(3))
def test_batch_scheduler_whole_rounds_match(n, seed):
    pair = _drive_rounds(n, seed)
    assert pair.done == {"jax": [True], "port": [True]}
    assert pair.metrics["port"] == pair.metrics["jax"]
    kinds = {a[0] for a in pair.answers}
    assert "schedule-update" in kinds and "done" in kinds
    assert pair.bs["port"].tracker.round == pair.bs["jax"].tracker.round


@pytest.mark.parametrize("peer,kind,want", [
    ("ghost", "status", "unknown worker"),
    ("ghost", "update-received", "unknown worker"),
    ("w0", "updated", "not the parameter server"),
])
def test_batch_scheduler_errors_match(peer, kind, want):
    pair = _Pair([2], 8, 2, [0.0])
    resp = pair.send(peer, kind=jmsg.ProgressKind(kind), batch_size=2)
    assert resp.kind.value == "error" and resp.message == want
    assert pair.bs["port"].tracker.round == 0


def test_batch_scheduler_refuses_a_newer_generation_alike():
    pair = _Pair([2], 8, 2, [0.0])
    resp = pair.send("w0", kind=jmsg.ProgressKind.STATUS, batch_size=2, scheduler_generation=2)
    assert resp.kind.value == "error" and "stale scheduler generation 1" in resp.message


def test_batch_scheduler_caps_are_the_reference_constants():
    assert (tbs.TIME_CAP_MS, tbs.UPDATES_CAP) == (jbs.TIME_CAP_MS, jbs.UPDATES_CAP) == (10_000.0, 3)


@pytest.mark.parametrize("generation", [2, 3])
def test_batch_scheduler_generation_stamps_alike(generation):
    """A restarted scheduler's ``generation`` (refused until scheduler
    recovery was ported): whole rounds through both packages' schedulers,
    every answer stamped with the generation and the round, byte for byte;
    newer-generation traffic refused, older processed."""
    now = [0.0]
    pair = _Pair([2, 1], 6, 2, now, generation=generation)
    K = jmsg.ProgressKind
    script = [("w0", {"kind": K.STATUS, "batch_size": 2}), ("w1", {"kind": K.STATUS, "batch_size": 1}),
              ("w0", {"kind": K.STATUS, "batch_size": 2}), ("w1", {"kind": K.UPDATE}),
              ("w0", {"kind": K.UPDATE}),
              ("ps", {"kind": K.UPDATED, "round": 0, "scheduler_generation": generation + 1}),
              ("ps", {"kind": K.UPDATED, "round": 0, "scheduler_generation": generation - 1}),
              ("w0", {"kind": K.UPDATE_RECEIVED}), ("w1", {"kind": K.UPDATE_RECEIVED}),
              ("w1", {"kind": K.STATUS, "batch_size": 1, "scheduler_generation": generation})]
    wires = []
    for peer, fields in script:
        now[0] += 1.0
        j = pair.send(peer, **fields)
        t = pair.last["port"]
        assert tmsg.encode(t) == jmsg.encode(j), (peer, fields)
        wires.append((j.kind.value, j.generation, j.round))
    assert wires[5][0] == "error" and wires[6] == ("ok", generation, 1)
    assert all(g == generation for k, g, _ in wires if k != "error")


def adaptive_transcript(pkg: str, shards: int = 1, speeds=(1.0, 1.0, 4.0, 1.0), rounds=4,
                        drop: "set | None" = None) -> list:
    """One package's ``BatchScheduler`` with its ``StragglerController`` on
    an injected clock, driven through ``rounds`` rounds by workers of batch
    2 whose batches take ``speeds`` seconds each: each runs until its
    ``SCHEDULE_UPDATE`` countdown ends, then sends UPDATE; once all have,
    every shard sends UPDATED with the arrival lags (a peer in ``drop``
    is left out of them, as a quorum-dropped one), and each worker
    UPDATE_RECEIVED. Every message is built in the JAX package, encoded
    and decoded by the package under test. Returns every answer as
    ``(peer, kind, counter, message)`` and each round's assignments."""
    from hypha_tpu.ft.adaptive import StragglerController as JSC
    from hypha_tpu_torch.ft.adaptive import StragglerController as TSC

    P = PKG[pkg]
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    ps = [f"ps{k}" for k in range(shards)]
    tracker = P.tr.ProgressTracker(ps, 1000, rounds, clock=clock)
    peers = [f"w{i}" for i in range(len(speeds))]
    for p in peers:
        tracker.add_worker(p, 2)
    ctrl = (JSC if pkg == "jax" else TSC)(base_steps=8, clock=clock)
    sched = P.bs.BatchScheduler(tracker, adaptive=ctrl,
                                shards_due=(lambda r: tuple(range(shards))) if shards > 1 else None)
    out: list = []

    def send(peer, **kw):
        msg = P.m.decode(jmsg.encode(jmsg.Progress(job_id="j", **kw)))
        resp = sched.on_progress(peer, msg)
        out.append((peer, resp.kind.value, resp.counter, resp.message))
        return resp

    for r in range(rounds):
        t0 = now[0]
        done_at = {}
        for i, p in enumerate(peers):
            t, left = t0, None
            while left is None or left > 0:
                t += speeds[i]
                now[0] = t
                resp = send(p, kind=jmsg.ProgressKind.STATUS, batch_size=2)
                if resp.kind.value == "schedule-update":
                    left = resp.counter
                elif left is not None:
                    left -= 1
            done_at[p] = t
        # The scheduler's clock moves on every Status in wall order: replay
        # is per worker, so the controller sees each worker's own cadence.
        now[0] = max(done_at.values()) + 0.5
        for p in peers:
            send(p, kind=jmsg.ProgressKind.UPDATE)
        arrivals = {p: round(done_at[p] - t0 + 0.25, 6) for p in peers
                    if p not in (drop or set())}
        for k in range(shards):
            send(ps[k], kind=jmsg.ProgressKind.UPDATED, round=r, shard=k,
                 metrics={"arrival_s": arrivals})
        out.append(("assignments", dict(sorted(ctrl.assignments().items()))))
        for p in peers:
            send(p, kind=jmsg.ProgressKind.UPDATE_RECEIVED)
    out.append(("snapshot", ctrl.snapshot()))
    return out


# The batch scheduler with a straggler controller (formerly refused, with
# shards_due beside it too): every answer and assignment as the reference's.
@pytest.mark.parametrize("option", ["adaptive", "shards_due"])
def test_batch_scheduler_adaptive_answers_as_the_reference(option):
    shards = 2 if option == "shards_due" else 1
    want = adaptive_transcript("jax", shards)
    got = adaptive_transcript("port", shards)
    assert got == want
    counters = [c for _, kind, c, _ in (e for e in got if len(e) == 4) if kind == "schedule-update"]
    assert counters and min(counters) < 7, "the slow worker was given fewer steps"


# -- allocation: Candidates, the offer window, batch sizing --------------------


def _offer(pkg, rng_vals, i):
    gpu, cpu, price, ttl = rng_vals
    m, R = PKG[pkg].m, PKG[pkg].R
    return m.WorkerOffer(request_id="req", lease_id=f"l{i}", peer_id=f"p{i % 5}",
                         resources=R(gpu=gpu, cpu=cpu, memory=64.0), price=price, expires_in=ttl)


@pytest.mark.parametrize("seed", range(3))
def test_candidates_rank_alike(seed):
    rng = np.random.default_rng(seed)
    capacity = int(rng.integers(1, 4))
    cands = {pkg: PKG[pkg].alloc.Candidates(capacity) for pkg in PKG}
    evals = {"jax": jalloc.WeightedResourceEvaluator(), "port": talloc.WeightedResourceEvaluator()}
    for i in range(30):
        vals = (float(rng.integers(0, 3)), float(rng.integers(1, 9)), float(rng.uniform(0.1, 5)),
                float(rng.uniform(0.1, 0.5)))
        got = {}
        for pkg in PKG:
            offer = _offer(pkg, vals, i)
            score = evals[pkg].evaluate(offer.price, offer.resources)
            got[pkg] = (score, cands[pkg].try_insert(score, offer, 100.0 + vals[3]))
        assert got["port"] == got["jax"]
        assert [o.lease_id for o in cands["port"].best()] == \
            [o.lease_id for o in cands["jax"].best()]
        assert cands["port"].earliest_expiry() == cands["jax"].earliest_expiry()


@pytest.mark.parametrize("seed", range(2))
def test_offer_window_picks_alike(seed):
    """The aggregation loop with every offer already queued: offers over
    the price cap dropped, the best N per peer kept, early return."""
    rng = np.random.default_rng(seed)
    draws = [(float(rng.integers(0, 3)), float(rng.integers(1, 9)), float(rng.uniform(0.1, 12)),
              0.5) for _ in range(12)]
    want = int(rng.integers(1, 4))

    async def window(pkg):
        queue = asyncio.Queue()
        for i, vals in enumerate(draws):
            queue.put_nowait(_offer(pkg, vals, i))
        alloc = PKG[pkg].alloc.GreedyWorkerAllocator(SimpleNamespace(peer_id="sched"))
        price = PKG[pkg].m.PriceRange(bid=1.0, max=10.0)
        return [o.lease_id for o in await alloc._aggregate(queue, price, 0.3, want)]

    assert asyncio.run(window("port")) == asyncio.run(window("jax"))


@pytest.mark.parametrize("offered,required,max_batch,want", [
    ({"gpu": 1}, {"gpu": 0.5}, 2, 2),  # a whole offer at half a GPU each: the smoke's batch 2
    ({"gpu": 0.5}, {"gpu": 0.5}, 2, 1),  # a flexible offer gives what was asked: batch 1
    ({"gpu": 8}, {"gpu": 1}, 600, 8),
    ({"gpu": 8}, {"gpu": 1}, None, 8),
    ({"tpu": 8, "gpu": 4}, {"tpu": 2, "gpu": 1}, 600, 4),
    ({"cpu": 4}, {"cpu": 1}, 5, 5),
    ({"cpu": 4}, {"cpu": 1}, None, 1),
    ({"gpu": 0.2}, {"gpu": 1}, 600, 1),
])
def test_batch_size_for_alike(offered, required, max_batch, want):
    got = {pkg: PKG[pkg].orch.Orchestrator.batch_size_for(
        PKG[pkg].R(**offered), PKG[pkg].R(**required), max_batch) for pkg in PKG}
    assert got == {"jax": want, "port": want}


@pytest.mark.parametrize("seed", range(3))
def test_watchdog_deadline_alike(seed):
    """``_effective_timeout``: the adaptive per-round deadline (600 s until
    every worker has statistics, then clamp(5 x projected round, 60 s,
    600 s)) from the same seeded tracker."""
    rng = np.random.default_rng(seed)
    now = [0.0]
    n, target = int(rng.integers(1, 4)), int(rng.integers(4, 40))
    got = {}
    for pkg in PKG:
        tracker = _tracker(pkg, lambda: now[0], batch_sizes=tuple(range(1, n + 1)),
                           target=target, epochs=2)
        ctx = PKG[pkg].orch._RunContext()
        ctx.tracker, ctx.status_timeout = tracker, None
        got[pkg] = ctx
    orch = {pkg: PKG[pkg].orch.Orchestrator(SimpleNamespace(peer_id="s")) for pkg in PKG}
    rng2 = np.random.default_rng(seed + 100)
    deadlines = set()
    for _ in range(40):
        now[0] += float(rng2.exponential(8.0))
        peer = f"w{int(rng2.integers(0, n))}"
        for pkg in PKG:
            got[pkg].tracker.update(peer, 1)
        d = {pkg: orch[pkg]._effective_timeout(got[pkg]) for pkg in PKG}
        assert d["port"] == d["jax"]
        deadlines.add(d["port"])
    assert 600.0 in deadlines and min(deadlines) >= 60.0
    ctx = torch_orch._RunContext()
    ctx.status_timeout = 7.0
    assert orch["port"]._effective_timeout(ctx) == 7.0


# -- the job and the dispatched specs, byte for byte ----------------------------


def _jobs(**over):
    """The same DiLoCoJob built in both packages."""
    out = {}
    for pkg in PKG:
        m, R, job = PKG[pkg].m, PKG[pkg].R, PKG[pkg].job
        kw = dict(
            model={"model_type": "causal-lm", "family": "llama", "preset": "tiny", "seed": 3},
            dataset="counting",
            rounds=job.DiLoCoRounds(update_rounds=2, avg_samples_between_updates=8,
                                    max_batch_size=2),
            inner_optimizer=m.Adam(lr=3e-4), outer_optimizer=m.Nesterov(lr=0.7, momentum=0.9),
            resources=job.JobResources(
                num_workers=2, worker=R(gpu=0.5, cpu=1.0, memory=1024),
                parameter_server=R(cpu=1.0, memory=1024),
                worker_price=m.PriceRange(bid=1.0, max=10.0),
                parameter_server_price=m.PriceRange(bid=2.0, max=20.0)),
        )
        kw.update(over.get(pkg, {}))
        out[pkg] = job.DiLoCoJob(**kw)
    return out


@pytest.mark.parametrize("over", ["defaults", "smoke", "scheduled"])
def test_job_encodes_to_the_same_bytes(over):
    if over == "defaults":
        jobs = {pkg: PKG[pkg].job.DiLoCoJob(model={"preset": "tiny"}, dataset="d") for pkg in PKG}
    elif over == "smoke":
        jobs = _jobs()
    else:
        jobs = _jobs(**{pkg: {"lr_scheduler": PKG[pkg].m.LRScheduler(
            kind=PKG[pkg].m.LRSchedulerKind("cosine-with-warmup"), warmup_steps=3, total_steps=30),
            "loss": PKG[pkg].m.Loss("cross-entropy"), "checkpoint_every": 2,
            "num_fragments": 0, "metrics_dir": "/m"} for pkg in PKG})
    raw = jmsg.encode(jobs["jax"])
    assert tmsg.encode(jobs["port"]) == raw
    assert tmsg.decode(raw) == jobs["port"]
    assert jmsg.decode(tmsg.encode(jobs["port"])) == jobs["jax"]


BASE_ID = "00000000-0000-4000-8000-00000000abcd"


def _dispatched(pkg, job, workers, ps):
    """Each package's orchestrator plans the streams for fixed peers and a
    fixed base id and builds every DispatchJob it would send."""
    orch = PKG[pkg].orch.Orchestrator(SimpleNamespace(peer_id="sched"))
    ctx = PKG[pkg].orch._RunContext()
    ctx.job, ctx.base_id = job, BASE_ID
    handles = [SimpleNamespace(peer_id=p, lease_id=f"lease-{p}", batch_size=2) for p in workers]
    ps_handle = SimpleNamespace(peer_id=ps, lease_id=f"lease-{ps}", batch_size=0)
    if pkg == "jax":
        ctx.ft = None
        ctx.ps_handles = [ps_handle]
        orch._plan_streams(ctx, job, workers, [ps], 1, placement_parts(job.sync_mode,
                                                                        job.num_fragments, 1))
    else:
        orch._plan_streams(ctx, job, workers, [ps])
    m = PKG[pkg].m
    sent = [m.DispatchJob(lease_id=ps_handle.lease_id, spec=ctx.ps_specs[0])]
    sent += [m.DispatchJob(lease_id=h.lease_id, spec=orch._train_spec(ctx, f"w{i}", h))
             for i, h in enumerate(handles)]
    return [m.encode(msg) for msg in sent], ctx


@pytest.mark.parametrize("workers", [["w0"], ["w0", "w1"], ["wjax", "wtorch", "w2"]])
def test_dispatched_specs_are_the_same_bytes(workers):
    jobs = _jobs()
    j, jctx = _dispatched("jax", jobs["jax"], workers, "psw")
    t, tctx = _dispatched("port", jobs["port"], workers, "psw")
    assert t == j
    assert (tctx.updates_tag, tctx.results_tag, tctx.ps_job_ids) == \
        (jctx.updates_tag, jctx.results_tag, jctx.ps_job_ids) == \
        (f"updates:{BASE_ID}", f"results:{BASE_ID}", [f"{BASE_ID}-ps"])
    spec = tmsg.decode(t[1]).spec
    assert spec.executor.train.batch_size == 2 and spec.job_id == f"{BASE_ID}-w0"


# The wire codecs and sync modes the port runs: the job takes them, and the
# dispatched train and aggregate specs carry them as the JAX wire does.
STREAM_OPTIONS = {
    "sync_mode": {"sync_mode": "overlap"},
    "delta_codec": {"delta_codec": "int8"},
    "delta_dtype": {"delta_dtype": "bfloat16"},
    "stream": {"sync_mode": "stream", "num_fragments": 2, "delta_codec": "int4"},
    "input_pipeline": {"input_pipeline": True, "prefetch_slices": 3},
    "input_pipeline_default_depth": {"input_pipeline": True},
    "preprocessor": {"preprocessor": {"kind": "tokenizer", "inputs": ["text"]}},
    "metrics_plane": {"metrics_plane": True, "metrics_interval_s": 0.5},
}


@pytest.mark.parametrize("option", sorted(STREAM_OPTIONS))
def test_stream_and_codec_options_dispatch_as_the_jax_wire(option):
    over = STREAM_OPTIONS[option]
    jobs = _jobs(jax=over, port=over)
    assert tmsg.encode(jobs["port"]) == jmsg.encode(jobs["jax"])
    j, _ = _dispatched("jax", jobs["jax"], ["w0", "w1"], "psw")
    t, _ = _dispatched("port", jobs["port"], ["w0", "w1"], "psw")
    assert t == j
    agg, train = tmsg.decode(t[0]).spec.executor.aggregate, tmsg.decode(t[1]).spec.executor.train
    assert train.sync_mode == agg.sync_mode == over.get("sync_mode", "blocking")
    assert train.fragments == agg.fragments == over.get("num_fragments", 0)
    assert train.delta_codec == agg.delta_codec == over.get("delta_codec", "none")
    assert train.delta_dtype == over.get("delta_dtype", "float32")
    # The input pipeline's window: the job's depth, or the default for 0,
    # on the trainer's config and its fetch reference alike; None when off.
    depth = (over.get("prefetch_slices") or 2) if over.get("input_pipeline") else None
    assert (train.prefetch_slices, train.data.ref.prefetch) == (depth, depth)
    assert train.input_pipeline is (True if depth else None)
    assert train.preprocessor == over.get("preprocessor")
    # The metrics plane's cadence and collector (the scheduler) ride both
    # specs; None, off the wire, when it is off.
    cadence = over.get("metrics_interval_s") if over.get("metrics_plane") else None
    assert train.report_metrics_s == agg.report_metrics_s == cadence
    assert (train.metrics_peer is not None) == (agg.metrics_peer is not None) == bool(cadence)


# Each option outside the port's path, set to a value the reference
# accepts, with the other fields the reference needs beside it.
UNPORTED = {
    "sharding": ({"dp": 1}, "intra-replica sharding"),
}


@pytest.mark.parametrize("option", sorted(UNPORTED))
def test_unported_job_option_raises_with_its_label(option):
    value, label, *extra = UNPORTED[option]
    kw = {option: value, **(extra[0] if extra else {})}
    jjob.DiLoCoJob(model={}, dataset="d", **kw)
    with pytest.raises(NotImplementedError, match=f"{option}=.*ROADMAP.md, Queue 1: {label}"):
        tjob.DiLoCoJob(model={}, dataset="d", **kw)


# Fault tolerance with a streaming sync mode, several shards or a reduce
# group (each refused until fault tolerance reached them), the broadcast
# tree, serving followers, the input pipeline and preprocessors (refused
# until they were ported): both packages build the job, and it encodes to
# the same bytes.
LIFTED = {
    "scheduler_recovery": {"scheduler_recovery": True, "checkpoint_dir": "/ckpt", "ft": "on"},
    "adaptive_steps": {"adaptive_steps": True, "ft": "on"},
    "adaptive_codec": {"adaptive_codec": True, "codec_bw_hi_mbps": 400.0,
                       "codec_bw_lo_mbps": 250.0},
    "broadcast_tree": {"broadcast_tree": True, "reduce_group_size": 2},
    "serve_peers": {"serve_peers": ["s0"], "broadcast_tree": True, "reduce_group_size": 2},
    "ft": {"ft": "on", "sync_mode": "stream"},
    "checkpoint_dir": {"checkpoint_dir": "/ckpt", "sync_mode": "stream"},
    "num_ps_shards": {"num_ps_shards": 2, "checkpoint_dir": "/ckpt"},
    "reduce_group_size": {"reduce_group_size": 2, "ft": "on"},
    "reduce_tree_depth": {"reduce_tree_depth": 2, "reduce_group_size": 2,
                          "checkpoint_dir": "/ckpt"},
    "lora": {"lora": {"rank": 16, "alpha": 32.0, "targets": ["q_proj", "v_proj"]}},
    "input_pipeline": {"input_pipeline": True, "prefetch_slices": 3},
    "preprocessor": {"preprocessor": {"kind": "tokenizer", "inputs": ["text"]}},
    "metrics_plane": {"metrics_plane": True, "metrics_interval_s": 0.5, "metrics_dir": "/m"},
    "slo_rules": {"metrics_plane": True,
                  "slo_rules": ["round_wall_s <= 30", "hypha.het.quorum_drops == 0"]},
}


@pytest.mark.parametrize("option", sorted(LIFTED))
def test_lifted_job_option_encodes_as_the_reference(option):
    from hypha_tpu.ft.membership import FTConfig as JFT
    from hypha_tpu_torch.ft.membership import FTConfig as TFT

    out = {}
    for name, job, m, ft in (("jax", jjob, jmsg, JFT), ("port", tjob, tmsg, TFT)):
        kw = {k: (ft(quorum_fraction=0.5) if v == "on" else v) for k, v in LIFTED[option].items()}
        out[name] = m.encode(job.DiLoCoJob(model={}, dataset="d", **kw))
    assert out["port"] == out["jax"]


def test_every_unported_option_has_a_case_and_its_off_value_runs():
    assert sorted(UNPORTED) == sorted(name for name, _, _ in tjob._NOT_PORTED)
    assert not set(LIFTED) & {n for n, _, _ in tjob._NOT_PORTED}
    job = tjob.DiLoCoJob(model={}, dataset="d", reduce_tree_depth=1, sharding=None)
    assert job.sync_mode == "blocking" and job.num_ps_shards == 1


@pytest.mark.parametrize("bad", [
    {"delta_dtype": "float16"}, {"delta_codec": "zstd"}, {"sync_mode": "eager"},
    {"num_ps_shards": 0}, {"num_fragments": -1}, {"prefetch_slices": 2},
    {"codec_bw_lo_mbps": 200.0}, {"metrics_interval_s": 0.0},
    {"slo_rules": ["no operator"]},
])
def test_malformed_job_raises_value_error_in_both(bad):
    for pkg in PKG:
        with pytest.raises(ValueError):
            PKG[pkg].job.DiLoCoJob(model={}, dataset="d", **bad)


# Jobs the reference refuses for a cross-field reason: the port raises the
# same ValueError, not "not ported".
CROSS_FIELD = {
    "tree without groups": {"reduce_tree_depth": 2},
    "broadcast tree alone": {"broadcast_tree": True},
    "broadcast tree, adaptive codec": {"broadcast_tree": True, "reduce_group_size": 2,
                                       "adaptive_codec": True},
    "recovery alone": {"scheduler_recovery": True},
    "recovery without ft": {"scheduler_recovery": True, "checkpoint_dir": "/ckpt"},
    "adaptive codec, stream": {"adaptive_codec": True, "sync_mode": "stream"},
    "adaptive codec, shards": {"adaptive_codec": True, "num_ps_shards": 2},
    "adaptive codec, checkpoint": {"adaptive_codec": True, "checkpoint_dir": "/ckpt"},
    "shards, overlap": {"num_ps_shards": 2, "sync_mode": "overlap"},
    "shards over fragments": {"num_ps_shards": 8, "sync_mode": "stream", "num_fragments": 4},
}


@pytest.mark.parametrize("case", sorted(CROSS_FIELD))
def test_cross_field_job_raises_the_reference_error(case):
    raised = {}
    for pkg in PKG:
        with pytest.raises(Exception) as info:
            PKG[pkg].job.DiLoCoJob(model={}, dataset="d", **CROSS_FIELD[case])
        raised[pkg] = (type(info.value), str(info.value))
    assert raised["port"] == raised["jax"]
    assert raised["jax"][0] is ValueError


@pytest.mark.parametrize("args", [("blocking", 0, 0), ("eager", 0, 2), ("stream", -1, 2),
                                  ("stream", 0, -3)])
def test_placement_parts_raises_the_reference_error(args):
    from hypha_tpu_torch.stream import placement_parts as t_parts

    raised = {}
    for name, fn in (("jax", placement_parts), ("port", t_parts)):
        with pytest.raises(Exception) as info:
            fn(*args)
        raised[name] = (type(info.value), str(info.value))
    assert raised["port"] == raised["jax"] and raised["jax"][0] is ValueError


# -- the rest of the scheduler's surface ---------------------------------------


def test_metrics_bridge_tracks_alike():
    got = {pkg: [] for pkg in PKG}
    for pkg in PKG:
        bridge = PKG[pkg].mb.MetricsBridge(PKG[pkg].mb.CallbackConnector(
            lambda w, r, n, v, pkg=pkg: got[pkg].append((w, r, n, v))))
        bridge.on_metrics("w0", 1, {"loss": 2.5, "samples": 8, "note": "x"})
        asyncio.run(bridge.close())
    assert got["port"] == got["jax"] == [("w0", 1, "loss", 2.5), ("w0", 1, "samples", 8.0)]


def test_gather_bounded_keeps_order_and_limit():
    live, peak = [0], [0]

    async def job(i):
        live[0] += 1
        peak[0] = max(peak[0], live[0])
        await asyncio.sleep(0.001 * (7 - i))
        live[0] -= 1
        return i * i

    async def main():
        out = await taio.gather_bounded([lambda i=i: job(i) for i in range(7)], limit=3)
        assert await taio.gather_bounded([]) == []
        return out

    assert asyncio.run(main()) == [i * i for i in range(7)] and peak[0] == 3


def test_gather_bounded_cancels_siblings_on_failure():
    cancelled = []

    async def slow():
        try:
            await asyncio.sleep(10)
        except asyncio.CancelledError:
            cancelled.append(True)
            raise

    async def boom():
        await asyncio.sleep(0.01)
        raise RuntimeError("boom")

    async def main():
        with pytest.raises(RuntimeError, match="boom"):
            await taio.gather_bounded([slow, boom, slow], limit=4)

    asyncio.run(main())
    assert cancelled == [True, True]


def test_worker_handle_adopt_rearms_the_journaled_lease():
    """``WorkerHandle.adopt`` (refused until scheduler recovery was ported):
    both packages' handles renew the journaled lease of the named peer with
    the same bytes, keep renewing it, and report a failed re-arm."""
    from hypha_tpu.scheduler import worker_handle as jwh

    got = {}
    for pkg, m, mod in (("jax", jmsg, jwh), ("port", tmsg, twh)):
        class _Node:
            def __init__(self, ok):
                self.ok, self.sent = ok, []

            async def request(self, peer, protocol, msg, timeout=None):
                self.sent.append((peer, protocol, m.encode(msg), timeout))
                if not self.ok:
                    raise mod.RequestError("no route")
                return m.RenewLeaseResponse(lease_id=msg.lease_id, timeout=10.0)

        async def main():
            node = _Node(True)
            handle = await mod.WorkerHandle.adopt(node, "w0", "lease-7")
            out = (handle.peer_id, handle.lease_id, handle.batch_size, node.sent)
            await handle.release()
            with pytest.raises(mod.RequestError):
                await mod.WorkerHandle.adopt(_Node(False), "w0", "lease-7")
            return out

        got[pkg] = asyncio.run(main())
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ("w0", "lease-7") and len(got["port"][3]) == 1
