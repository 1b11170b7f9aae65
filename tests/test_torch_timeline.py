"""Port parity: the timeline merger (``hypha_tpu_torch/telemetry/
timeline.py``) against ``hypha_tpu/telemetry/timeline.py``, mirroring
``tests/test_timeline.py``.

Seeded trace directories (skewed clocks, a torn tail, a metrics journal in
the directory, foreign records in a spans file, a peer with events and no
spans, an empty directory) go through both packages' ``build_timeline``,
``render_text`` and ``to_otlp``: the outputs are equal. The port's merger
also runs as ``python -m hypha_tpu_torch.telemetry.timeline <dir>``.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
from pathlib import Path

import pytest

from hypha_tpu.telemetry import timeline as jtl
from hypha_tpu_torch.telemetry import timeline as ttl

ROOT = Path(__file__).resolve().parents[1]


def _span(node, name, start_s, dur_s, *, rnd=None, peer=None, trace_id="ab" * 16, parent=None,
          span_id="cd" * 8, ok=True) -> dict:
    attrs: dict = {}
    if rnd is not None:
        attrs["round"] = rnd
    if peer is not None:
        attrs["peer"] = peer
    start_ns, end_ns = int(start_s * 1e9), int((start_s + dur_s) * 1e9)
    return {"node": node, "name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent, "start_ns": start_ns, "end_ns": end_ns,
            "mono_start_ns": start_ns, "mono_end_ns": end_ns, "ok": ok, "attrs": attrs}


def _write(path: Path, recs: list) -> None:
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))


def _trace(d: Path, seed: int, skews: dict, rounds: int = 3) -> None:
    """A scheduler, two workers and a server over ``rounds`` rounds, with
    seeded durations; each node's wall clock shifted by its skew."""
    rng = random.Random(seed)
    t0 = 1000.0 + rng.random()
    per: dict = {n: [] for n in ("scheduler", "w0", "w1", "psw")}
    for r in range(rounds):
        rs = t0 + r * 10.0
        tid = f"{r:02x}" * 16
        per["scheduler"].append(_span("scheduler", "round", rs, 9.0 + rng.random(), rnd=r,
                                      trace_id=tid))
        for w in ("w0", "w1"):
            s, lag = skews.get(w, 0.0), rng.uniform(0.01, 0.2)
            per[w] += [_span(w, "inner_steps", rs + lag + s, rng.uniform(3, 5), rnd=r, trace_id=tid),
                       _span(w, "input_wait", rs + lag + s + 0.1, rng.uniform(0, 0.3), trace_id=tid),
                       _span(w, "encode", rs + 5.0 + s, rng.uniform(0.1, 0.6), rnd=r, trace_id=tid),
                       _span(w, "upload", rs + 5.6 + s, rng.uniform(0.1, 1.0), rnd=r, trace_id=tid),
                       _span(w, "merge", rs + 8.0 + s, rng.uniform(0.1, 0.3), rnd=r, trace_id=tid)]
        ps = skews.get("psw", 0.0)
        per["psw"].append(_span("psw", "quorum_wait", rs + 0.02 + ps, 6.5, rnd=r, trace_id=tid))
        for w in ("w0", "w1"):
            per["psw"] += [_span("psw", "upload", rs + 5.6 + ps, rng.uniform(0.1, 1.5), rnd=r,
                                 peer=w, trace_id=tid),
                           _span("psw", "fold", rs + 6.0 + ps, rng.uniform(0.05, 0.2), rnd=r,
                                 peer=w, trace_id=tid)]
        per["psw"] += [_span("psw", "outer_step", rs + 6.6 + ps, rng.uniform(0.2, 0.6), rnd=r,
                             trace_id=tid),
                       _span("psw", "broadcast", rs + 7.2 + ps, rng.uniform(0.5, 1.5), rnd=r,
                             trace_id=tid, ok=rng.random() > 0.3)]
    for node, recs in per.items():
        _write(d / f"spans-{node}.jsonl", recs)
    events = [{"t_mono_ns": i, "t_wall_ns": int((t0 + rng.uniform(0, 30)) * 1e9),
               "event": rng.choice(["retry", "chaos.bw-cap", "ps.recovered"]),
               "node": rng.choice(["w0", "psw"]), "attrs": {"round": i % rounds}}
              for i in range(20)]
    _write(d / "events-mixed.jsonl", events)


def _equal(d: Path) -> dict:
    t, j = ttl.build_timeline(d), jtl.build_timeline(d)
    assert t == j
    assert ttl.render_text(t) == jtl.render_text(j)
    t_spans, t_events = ttl.load_dir(d)
    j_spans, j_events = jtl.load_dir(d)
    assert (t_spans, t_events) == (j_spans, j_events)
    assert ttl.to_otlp(t_spans) == jtl.to_otlp(j_spans)
    assert ttl.to_otlp(t_spans, {"service.name": "x", "k": 3}) == \
        jtl.to_otlp(j_spans, {"service.name": "x", "k": 3})
    assert ttl.align_offsets(t_spans) == jtl.align_offsets(j_spans)
    json.dumps(t)
    return t


@pytest.mark.parametrize("seed", range(3))
def test_skewed_clocks_merge_alike(tmp_path, seed):
    skews = {"w0": 2.5 * seed, "w1": -1.75, "psw": 0.4 * seed}
    _trace(tmp_path, seed, skews)
    tl = _equal(tmp_path)
    assert [r["round"] for r in tl["rounds"]] == [0, 1, 2]
    assert set(tl["clock_offsets_s"]) == {"scheduler", "w0", "w1", "psw"}
    assert all(r["straggler"] in ("w0", "w1") for r in tl["rounds"])


def test_torn_tail_reads_as_clean_eof_alike(tmp_path):
    _trace(tmp_path, 5, {})
    path = tmp_path / "spans-w1.jsonl"
    path.write_text(path.read_text() + '{"node": "w1", "name": "upl')
    tl = _equal(tmp_path)
    assert tl["num_spans"] == 3 * 5 + 3 * 5 + 3 * 7 + 3
    assert ttl.load_jsonl(path) == jtl.load_jsonl(path)


def test_a_metrics_journal_in_the_directory_merges_alike(tmp_path):
    _trace(tmp_path, 6, {"w0": 0.3})
    _write(tmp_path / "metrics-abc123.jsonl",
           [{"type": "report", "t": 1.0, "peer": "w0", "counters": {"node.bytes_out": 10}},
            {"type": "quality", "t": 2.0, "peer": "w0", "round": 0, "loss": 3.5}])
    assert len(_equal(tmp_path)["rounds"]) == 3


def test_foreign_records_in_a_spans_file_are_skipped_alike(tmp_path, capsys):
    _trace(tmp_path, 7, {})
    _write(tmp_path / "spans-oops.jsonl",
           [{"type": "report", "t": 1.0, "peer": "w9"}, {"name": 42, "start_ns": "soon"}])
    assert len(_equal(tmp_path)["rounds"]) == 3
    err = capsys.readouterr().err
    assert err.count("non-span records") == 4  # two merges, two loads per package


def test_a_peer_with_events_and_no_spans_merges_alike(tmp_path, capsys):
    _trace(tmp_path, 8, {})
    _write(tmp_path / "events-ghost.jsonl",
           [{"t_mono_ns": 1, "t_wall_ns": int(1001e9), "event": "chaos.kill", "node": "ghost"}])
    tl = _equal(tmp_path)
    assert any(e["event"] == "chaos.kill" for e in tl["events"])
    assert "ghost" in capsys.readouterr().err


def test_an_untraced_scheduler_bounds_rounds_by_their_spans_alike(tmp_path):
    _trace(tmp_path, 9, {"w0": 1.0})
    (tmp_path / "spans-scheduler.jsonl").unlink()
    tl = _equal(tmp_path)
    assert tl["reference_node"] == "psw" and all(r["wall_s"] > 0 for r in tl["rounds"])


def test_an_empty_directory_merges_alike(tmp_path):
    tl = _equal(tmp_path)
    assert tl["rounds"] == [] and tl["num_spans"] == 0
    (tmp_path / "spans-x.jsonl").write_text("")
    assert _equal(tmp_path)["rounds"] == []
    assert ttl.load_jsonl(tmp_path / "nope.jsonl") == []


def test_the_merger_runs_as_a_module(tmp_path):
    _trace(tmp_path, 10, {"w1": 0.5})
    otlp = tmp_path / "otlp.json"
    out = subprocess.run([sys.executable, "-m", "hypha_tpu_torch.telemetry.timeline",
                          str(tmp_path), "--otlp", str(otlp)], cwd=ROOT, capture_output=True,
                         text=True, timeout=60, check=True)
    assert out.stdout.strip() == jtl.render_text(jtl.build_timeline(tmp_path))
    written = json.loads((tmp_path / "timeline.json").read_text())
    assert written == json.loads(json.dumps(jtl.build_timeline(tmp_path)))
    spans, _ = jtl.load_dir(tmp_path)
    assert json.loads(otlp.read_text()) == jtl.to_otlp(spans)
    assert "import jax" not in out.stderr


def test_the_merger_refuses_a_missing_directory(tmp_path, capsys):
    assert ttl.main([str(tmp_path / "absent")]) == 2
    assert "not a directory" in capsys.readouterr().err
    assert ttl.main([str(tmp_path), "--json", "-"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["rounds"] == []
