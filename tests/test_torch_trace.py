"""Port parity: round and serving trace spans and the flight recorder
(``hypha_tpu_torch/telemetry/trace.py``, ``flight.py``) against
``hypha_tpu/telemetry``, mirroring ``tests/test_trace.py``.

1. Wire bytes. ``Progress``, ``ProgressResponse`` and ``GenerateRequest``
   with ``traceparent`` None and set encode byte-identical under both
   packages' codecs, and the untraced ones equal the bytes the port sent
   before tracing existed (goldens below); a push header gains no key when
   tracing is off.
2. ``parse_traceparent`` agrees with the reference on a seeded corpus of
   good and malformed values; span and event records have the reference's
   keys and values; ids come from ``os.urandom``.
3. The recorder, the no-op helpers, the environment switch, ``reparent``
   and the flight ring behave as the reference's.
4. Both packages' ``BatchScheduler``s, driven through the same rounds with
   tracing on, hand down the same shape of round contexts; with tracing
   off their answers are byte-equal.
"""

from __future__ import annotations

import asyncio
import json
import random

import numpy as np
import pytest

from hypha_tpu import codec as jcodec
from hypha_tpu import messages as jmsg
from hypha_tpu.scheduler.batch_scheduler import BatchScheduler as JBatch
from hypha_tpu.scheduler.trackers import ProgressTracker as JTracker
from hypha_tpu.telemetry import flight as jflight
from hypha_tpu.telemetry import trace as jtrace
from hypha_tpu_torch import codec as tcodec
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.scheduler.batch_scheduler import BatchScheduler as TBatch
from hypha_tpu_torch.scheduler.trackers import ProgressTracker as TTracker
from hypha_tpu_torch.telemetry import flight as tflight
from hypha_tpu_torch.telemetry import trace as ttrace

TP = "ab" * 16 + "-" + "cd" * 8


@pytest.fixture
def tracing_off():
    for t in (jtrace, ttrace):
        t._reset_for_tests()
        t.disable()
    yield
    for t in (jtrace, ttrace):
        t._reset_for_tests()


@pytest.fixture
def tracing_on(tmp_path):
    jtrace._reset_for_tests()
    ttrace._reset_for_tests()
    yield jtrace.enable(tmp_path / "jax", node="testnode"), ttrace.enable(tmp_path / "port",
                                                                           node="testnode")
    jtrace._reset_for_tests()
    ttrace._reset_for_tests()


# ------------------------------------------------------------ wire bytes


def _messages(m, tp):
    """Every message kind a traced round or request carries, with ``tp``."""
    K, R = m.ProgressKind, m.ProgressResponseKind
    return [
        m.Progress(kind=K.STATUS, job_id="job-1", batch_size=2, traceparent=tp),
        m.Progress(kind=K.UPDATE, job_id="job-1", traceparent=tp),
        m.Progress(kind=K.METRICS, job_id="job-1", round=1,
                   metrics={"loss": 2.5, "samples": 4.0}, traceparent=tp),
        m.Progress(kind=K.UPDATED, job_id="job-1-ps", round=1, traceparent=tp),
        m.Progress(kind=K.UPDATE_RECEIVED, job_id="job-1", traceparent=tp),
        m.ProgressResponse(kind=R.CONTINUE, traceparent=tp),
        m.ProgressResponse(kind=R.SCHEDULE_UPDATE, counter=3, traceparent=tp),
        m.ProgressResponse(kind=R.OK, traceparent=tp),
        m.ProgressResponse(kind=R.DONE, traceparent=tp),
        m.GenerateRequest(serve_name="llm", prompts=[[1, 2, 3]], max_new_tokens=8, seed=4,
                          traceparent=tp),
    ]


# The port's bytes for the untraced messages above and three push headers
# (a delta, a broadcast, a stream fragment's delta), encoded by the tree
# before tracing was ported.
GOLDEN = [
    "a7625f746850726f6772657373646b696e64a2625f656c50726f67726573734b696e6461766673746174"
    "7573666a6f625f6964656a6f622d316a62617463685f73697a650265726f756e6400676d657472696373"
    "a065736861726400",
    "a7625f746850726f6772657373646b696e64a2625f656c50726f67726573734b696e6461766675706461"
    "7465666a6f625f6964656a6f622d316a62617463685f73697a650065726f756e6400676d657472696373"
    "a065736861726400",
    "a7625f746850726f6772657373646b696e64a2625f656c50726f67726573734b696e646176676d657472"
    "696373666a6f625f6964656a6f622d316a62617463685f73697a650065726f756e6401676d6574726963"
    "73a2646c6f7373fb40040000000000006773616d706c6573fb401000000000000065736861726400",
    "a7625f746850726f6772657373646b696e64a2625f656c50726f67726573734b696e6461766775706461"
    "746564666a6f625f6964686a6f622d312d70736a62617463685f73697a650065726f756e6401676d6574"
    "72696373a065736861726400",
    "a7625f746850726f6772657373646b696e64a2625f656c50726f67726573734b696e6461766f75706461"
    "74652d7265636569766564666a6f625f6964656a6f622d316a62617463685f73697a650065726f756e64"
    "00676d657472696373a065736861726400",
    "a4625f747050726f6772657373526573706f6e7365646b696e64a2625f657450726f6772657373526573"
    "706f6e73654b696e64617668636f6e74696e756567636f756e74657200676d65737361676560",
    "a4625f747050726f6772657373526573706f6e7365646b696e64a2625f657450726f6772657373526573"
    "706f6e73654b696e6461766f7363686564756c652d75706461746567636f756e74657203676d65737361"
    "676560",
    "a4625f747050726f6772657373526573706f6e7365646b696e64a2625f657450726f6772657373526573"
    "706f6e73654b696e646176626f6b67636f756e74657200676d65737361676560",
    "a4625f747050726f6772657373526573706f6e7365646b696e64a2625f657450726f6772657373526573"
    "706f6e73654b696e64617664646f6e6567636f756e74657200676d65737361676560",
    "a5625f746f47656e6572617465526571756573746a73657276655f6e616d65636c6c6d6770726f6d7074"
    "7381830102036e6d61785f6e65775f746f6b656e7308647365656404",
    "a26b6e756d5f73616d706c6573fb401000000000000065726f756e6401",
    "a3687265736f7572636567726573756c7473646e616d65747570646174652d312e7361666574656e736f"
    "727365726f756e6401",
    "a56b6e756d5f73616d706c6573fb401000000000000065726f756e640169726f756e645f746167016b66"
    "7261676d656e745f69640069667261676d656e747302",
]


def _golden_now() -> list:
    msgs = _messages(tmsg, None)
    headers = [{"num_samples": 4.0, "round": 1},
               {"resource": "results", "name": "update-1.safetensors", "round": 1},
               {"num_samples": 4.0, "round": 1, "round_tag": 1, "fragment_id": 0,
                "fragments": 2}]
    return [tmsg.encode(x).hex() for x in msgs] + [tcodec.dumps(h).hex() for h in headers]


def test_untraced_messages_keep_the_bytes_of_the_tree_before_tracing(tracing_off):
    assert len(GOLDEN) == 13 and _golden_now() == GOLDEN
    # And the reference's bytes, which no tracing change touched.
    assert _golden_now()[:10] == [jmsg.encode(x).hex() for x in _messages(jmsg, None)]


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("index", range(10))
def test_messages_encode_byte_identical_in_both_packages(index, traced):
    tp = TP if traced else None
    j, t = _messages(jmsg, tp)[index], _messages(tmsg, tp)[index]
    jb, tb = jmsg.encode(j), tmsg.encode(t)
    assert jb == tb
    assert ("traceparent" in tmsg.to_json_dict(t)) == traced
    back = tmsg.decode(jb)
    assert back.traceparent == tp
    assert jmsg.decode(tb).traceparent == tp


@pytest.mark.parametrize("tp", [None, TP], ids=["off", "on"])
def test_push_header_injection_equals_the_reference(tracing_off, tp):
    for header in ({"round": 2, "num_samples": 8.0},
                   {"resource": "results", "name": "u.safetensors", "round": 0}):
        jh, th = dict(header), dict(header)
        assert ttrace.inject(th, tp) is th
        jtrace.inject(jh, tp)
        assert tcodec.dumps(th) == jcodec.dumps(jh)
        assert (tmsg.TRACEPARENT_KEY in th) == (tp is not None)
    assert tmsg.TRACEPARENT_KEY == jmsg.TRACEPARENT_KEY == "traceparent"


# ----------------------------------------------------- traceparent format


def _corpus(seed: int, n: int = 300) -> list:
    rng = random.Random(seed)
    hexd = "0123456789abcdef"
    out: list = [None, 7, 3.5, b"ab", "", "-", TP, TP.upper(), TP + "-01", "00-" + TP]
    for _ in range(n):
        a = "".join(rng.choice(hexd + "g-XZ ") for _ in range(rng.choice([31, 32, 33])))
        b = "".join(rng.choice(hexd + "g") for _ in range(rng.choice([15, 16, 17])))
        good = "".join(rng.choice(hexd) for _ in range(32)) + "-" + "".join(
            rng.choice(hexd) for _ in range(16))
        out += [a + "-" + b, good, good.replace("-", rng.choice(["", "_", "--"])),
                [good], {"tp": good}]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_parse_traceparent_agrees_with_the_reference(seed):
    corpus = _corpus(seed)
    got = [ttrace.parse_traceparent(v) for v in corpus]
    assert got == [jtrace.parse_traceparent(v) for v in corpus]
    assert any(g is not None for g in got) and any(g is None for g in got)


def test_ids_use_urandom_not_the_seeded_global_rng():
    from hypha_tpu_torch.telemetry import _rand_id

    random.seed(1234)
    a = (_rand_id(16), ttrace._rand_hex(16))
    random.seed(1234)
    b = (_rand_id(16), ttrace._rand_hex(16))
    assert a[0] != b[0] and a[1] != b[1]
    assert len(a[0]) == 32 and len(a[1]) == 32


def _fixed_span(mod):
    return mod.TraceSpan(name="upload", trace_id="ab" * 16, span_id="cd" * 8,
                         parent_id="ef" * 8, node="psw", start_ns=10, start_mono_ns=3,
                         attributes={"round": 2, "peer": "w1", "bytes": 7}, end_ns=25,
                         end_mono_ns=18, status_ok=False)


def test_span_records_equal_the_reference():
    j, t = _fixed_span(jtrace), _fixed_span(ttrace)
    assert t.to_record() == j.to_record()
    assert t.traceparent == j.traceparent == "ab" * 16 + "-" + "cd" * 8
    # An unfinished span serializes its start as its end, in both.
    j.end_ns = j.end_mono_ns = t.end_ns = t.end_mono_ns = None
    assert t.to_record() == j.to_record()
    assert list(t.to_record()) == ["node", "name", "trace_id", "span_id", "parent_id",
                                   "start_ns", "end_ns", "mono_start_ns", "mono_end_ns", "ok",
                                   "attrs"]


def test_span_vocabulary_equals_the_reference():
    assert ttrace.ROUND_SPANS == jtrace.ROUND_SPANS
    assert ttrace.SERVE_SPANS == jtrace.SERVE_SPANS
    assert set(ttrace.__all__) == set(jtrace.__all__)


@pytest.mark.parametrize("value", [
    "s", 3, 2.5, True, None, [1, "a"], (1, 2), {"k": {1, 2}}, {3: ValueError("boom")},
    ValueError("x"), b"raw", frozenset({"a"}), np.float32(1.5)],
    ids=lambda v: type(v).__name__)
def test_event_attribute_cleaning_equals_the_reference(value):
    got, want = tflight._clean(value), jflight._clean(value)
    if isinstance(value, (set, frozenset)) or (isinstance(value, dict) and value.get("k")):
        # Set iteration order is the same object's in both calls.
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    else:
        assert got == want
    json.dumps(got)


def test_event_records_have_the_reference_keys():
    jr, tr = jflight.FlightRecorder(node="n"), tflight.FlightRecorder(node="n")
    for fr in (jr, tr):
        fr.record("chaos.bw-cap", node="w1", target="w1", at_round=0, rate_bps=1e9)
        fr.record("retry", what="push", attempt=2)
    for j, t in zip(jr.snapshot(), tr.snapshot()):
        assert list(t) == list(j)
        assert {k: t[k] for k in t if not k.startswith("t_")} == \
            {k: j[k] for k in j if not k.startswith("t_")}


# ------------------------------------------------------ the span recorder


def test_node_tracing_writes_per_node_jsonl(tmp_path, tracing_on):
    _, t = tracing_on
    root = t.begin("round", attrs={"round": 0}, node="scheduler")
    child = t.begin("upload", parent=root.traceparent, attrs={"peer": "w0"})
    assert child.trace_id == root.trace_id and child.parent_id == root.span_id
    t.finish(child)
    t.finish(root)
    with t.span("merge", parent=root, attrs={"round": 0}) as s:
        assert s.trace_id == root.trace_id
    port = tmp_path / "port"
    sched = [json.loads(x) for x in (port / "spans-scheduler.jsonl").read_text().splitlines()]
    local = [json.loads(x) for x in (port / "spans-testnode.jsonl").read_text().splitlines()]
    assert [s["name"] for s in sched] == ["round"]
    assert [s["name"] for s in local] == ["upload", "merge"]
    assert local[0]["trace_id"] == root.trace_id and local[0]["end_ns"] >= local[0]["start_ns"]
    assert local[0]["attrs"] == {"peer": "w0"}


def test_a_failing_span_is_recorded_not_ok(tmp_path, tracing_on):
    _, t = tracing_on
    with pytest.raises(RuntimeError):
        with ttrace.span("encode", attrs={"round": 1}):
            raise RuntimeError("disk full")
    (rec,) = [json.loads(x) for x in
              (tmp_path / "port" / "spans-testnode.jsonl").read_text().splitlines()]
    assert rec["name"] == "encode" and rec["ok"] is False


def test_module_helpers_are_no_ops_when_off(tracing_off):
    for t in (jtrace, ttrace):
        assert t.active() is None
        assert t.begin("x") is None
        t.finish(None)
        with t.span("y") as s:
            assert s is None
        assert t.traceparent_of(None) is None
        t.reparent(None, TP)


def test_the_environment_enables_tracing(tmp_path, monkeypatch):
    ttrace._reset_for_tests()
    monkeypatch.setenv("HYPHA_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("HYPHA_TRACE_NODE", "envnode")
    try:
        t = ttrace.active()
        assert t is not None and t.node == "envnode"
        ttrace.finish(ttrace.begin("input_wait"))
        assert (tmp_path / "spans-envnode.jsonl").exists()
        # An explicit disable wins over the environment.
        ttrace.disable()
        assert ttrace.active() is None
        # Without a node name a process labels itself pid<N>, as the
        # reference's trainers do.
        ttrace._reset_for_tests()
        monkeypatch.delenv("HYPHA_TRACE_NODE")
        import os

        assert ttrace.active().node == f"pid{os.getpid()}"
    finally:
        ttrace._reset_for_tests()


def test_reparent_binds_only_parentless_spans(tracing_on):
    _, t = tracing_on
    orphan = t.begin("quorum_wait")
    ttrace.reparent(orphan, TP)
    assert orphan.trace_id == "ab" * 16 and orphan.parent_id == "cd" * 8
    child = t.begin("fold", parent=orphan)
    ttrace.reparent(child, "ef" * 16 + "-" + "12" * 8)  # keeps its parent
    assert child.parent_id == orphan.span_id
    ttrace.reparent(t.begin("x"), "not a context")  # malformed: left alone


# -------------------------------------------------------- flight recorder


def test_flight_recorder_ring_and_spill(tmp_path):
    fr = tflight.FlightRecorder(capacity=4, node="psw")
    for i in range(7):
        fr.record("retry", attempt=i)
    events = fr.snapshot()
    assert [e["attrs"]["attempt"] for e in events] == [3, 4, 5, 6]
    fr.record("chaos.kill", node="w1", target="w1")
    paths = fr.spill(tmp_path)
    assert sorted(p.name for p in paths) == ["events-psw.jsonl", "events-w1.jsonl"]
    w1 = [json.loads(x) for x in (tmp_path / "events-w1.jsonl").read_text().splitlines()]
    assert w1[0]["event"] == "chaos.kill" and "t_mono_ns" in w1[0] and "t_wall_ns" in w1[0]
    assert fr.snapshot() == [] and fr.spill(tmp_path) == []  # spill drains
    assert tflight.FlightRecorder().spill() == []


def test_flight_dump_leaves_the_ring_and_configure_arms_the_spill(tmp_path):
    fr = tflight.FlightRecorder(node="psw")
    fr.record("ps.recovered", generation=2)
    path = fr.dump(tmp_path / "d.jsonl")
    assert [json.loads(x)["event"] for x in path.read_text().splitlines()] == ["ps.recovered"]
    assert len(fr.snapshot()) == 1  # dump does not drain
    fr.configure(node="psw2", spill_dir=tmp_path / "spill")
    fr.record("x")
    assert sorted(p.name for p in fr.spill()) == ["events-psw.jsonl", "events-psw2.jsonl"]
    fr.disarm()
    fr.record("after")
    assert fr.spill() == []


def test_the_port_records_flight_events_where_the_reference_does():
    """``aio.retry``, chaos firing and a durable server's generation bump
    leave the reference's events in the process ring."""
    from hypha_tpu_torch import aio
    from hypha_tpu_torch.telemetry.flight import FLIGHT

    FLIGHT.clear()
    calls = []

    async def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise OSError("blip")
        return "ok"

    assert asyncio.run(aio.retry(flaky, base_delay=0.01, retry_on=(OSError,),
                                 what="probe")) == "ok"
    (ev,) = [e for e in FLIGHT.snapshot() if e["event"] == "retry"]
    assert ev["attrs"] == {"what": "probe", "attempt": 1, "error": "blip"}
    FLIGHT.clear()


# ---------------------------------------- the scheduler's round contexts


def _drive(pkg: str, update_epochs: int = 2):
    """Both workers through round 0 and into round 1 (the reference test's
    schedule); every answer in order."""
    m, Tracker, Batch = ((jmsg, JTracker, JBatch) if pkg == "jax" else (tmsg, TTracker, TBatch))
    K = m.ProgressKind
    now = [0.0]
    tracker = Tracker("ps", update_target=60, update_epochs=update_epochs, clock=lambda: now[0])
    tracker.add_worker("w0", 10)
    tracker.add_worker("w1", 10)
    bs = Batch(tracker)
    answers = []

    def status(peer, t_ms):
        now[0] = t_ms / 1000.0
        r = bs.on_progress(peer, m.Progress(kind=K.STATUS, batch_size=10))
        answers.append(r)
        return r

    status("w0", 100)
    scheduled = 0
    for t_ms in range(200, 1200, 100):
        for w in ("w0", "w1"):
            if status(w, t_ms).kind == m.ProgressResponseKind.SCHEDULE_UPDATE:
                scheduled += 1
        if scheduled >= 2:
            break
    for w in ("w0", "w1"):
        answers.append(bs.on_progress(w, m.Progress(kind=K.UPDATE)))
    answers.append(bs.on_progress("ps", m.Progress(kind=K.UPDATED, round=0)))
    answers.append(bs.on_progress("w0", m.Progress(kind=K.UPDATE_RECEIVED)))
    return answers


def _shape(answers) -> list:
    """Each answer's kind and counter, and which round context it carries
    (0 for the first context seen, 1 for the next; None for none)."""
    seen: list = []
    out = []
    for r in answers:
        tp = r.traceparent
        if tp is not None and tp not in seen:
            seen.append(tp)
        out.append((r.kind.value, r.counter, None if tp is None else seen.index(tp)))
    return out


def test_schedulers_hand_down_the_same_round_contexts_when_on(tmp_path, tracing_on):
    j, t = _drive("jax"), _drive("port")
    assert _shape(t) == _shape(j)
    tps = [r.traceparent for r in t if r.traceparent is not None]
    assert len(set(tps)) == 2 and all(ttrace.parse_traceparent(tp) for tp in tps)
    (root,) = [json.loads(x) for x in
               (tmp_path / "port" / "spans-scheduler.jsonl").read_text().splitlines()]
    assert root["name"] == "round" and root["attrs"] == {"round": 0}
    assert f"{root['trace_id']}-{root['span_id']}" == tps[0]


def test_schedulers_answer_byte_equal_when_off(tracing_off):
    j, t = _drive("jax"), _drive("port")
    assert [tmsg.encode(r) for r in t] == [jmsg.encode(r) for r in j]
    assert all(r.traceparent is None for r in t)


def test_the_last_round_closes_its_root_span(tmp_path, tracing_on):
    """A one-round job: the round's root is written when the last worker's
    UPDATE_RECEIVED completes the job, as in the reference."""
    for pkg in ("jax", "port"):
        answers = _drive(pkg, update_epochs=1)
        assert answers[-1].kind.value == "done"
    for d in ("jax", "port"):
        names = [json.loads(x)["name"] for x in
                 (tmp_path / d / "spans-scheduler.jsonl").read_text().splitlines()]
        assert names == ["round"]
