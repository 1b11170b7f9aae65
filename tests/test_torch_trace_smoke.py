"""``chip_smoke.py``'s traced phases rehearsed on the CPU at a tiny size:
``train_het``, ``train_data`` (b) and ``serve_router`` under
``chip_smoke.traced_phase``, each held to its trace gates
(``het_trace_problems``, ``data_trace_problems``,
``router_trace_problems``) as the smoke holds them on the card; tracing is
off again after each, and the merged timeline names the capped peer as
the straggler."""

from __future__ import annotations

import asyncio
import shutil
import tempfile
from pathlib import Path

import pytest

import chip_smoke
from hypha_tpu_torch.telemetry import trace
from hypha_tpu_torch.telemetry.flight import FLIGHT

TINY = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
        "config": {"dtype": "float32"}, "seed": 0}


@pytest.fixture(autouse=True)
def untraced():
    trace._reset_for_tests()
    trace.disable()
    yield
    trace._reset_for_tests()
    FLIGHT.disarm()
    FLIGHT.clear()


def test_traced_het_job_passes_the_trace_gates_on_the_cpu(monkeypatch):
    """The tiny ``train_het`` (w1 capped at 1 Mbit/s): one root a round,
    every trainer's and the server's spans in the round's trace, the
    outer-step span within 10% or 50 ms of the probe, w1's receiver uploads
    at least 0.9 x bytes over the cap, the chaos actions in the events,
    wall clocks within 1 s and the merger's clock offsets equal to minus
    each node's least round-open lag, with no round beginning 1 s after
    its node's round before ended; w1 is each steady round's straggler."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = Path(tempfile.mkdtemp(prefix="thet"))
    tdir = None
    try:
        with chip_smoke.traced_phase("train_het") as tdir:
            run = asyncio.run(asyncio.wait_for(chip_smoke.run_het_job(
                root, TINY, device="cpu", rounds=4, steps=4, batch=2, seq=16, period=64,
                lr=3e-3, deadline_s=5.0, chaos="bw-cap:w1:1,slow-worker:w2:8,jitter:w3:0.2",
                hi_mbps=8.0, lo_mbps=8.0, limit_s=60, auction_timeout=1.0,
                status_timeout=60.0), 150))
        assert trace.active() is None
        rep = chip_smoke.het_report(run)
        assert chip_smoke.het_problems(run, rep, rounds=4, steps=4, layers=2, device="cpu") == []
        problems, fig = chip_smoke.het_trace_problems(tdir, run, rounds=4, rate_mbps=1.0)
        summary = chip_smoke.trace_summary(tdir, "train_het")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if tdir is not None:
            shutil.rmtree(tdir, ignore_errors=True)
    assert problems == [], problems
    assert [row["straggler"] for row in fig["steady"]] == ["w1"] * 3, fig["steady"]
    assert fig["chaos_events"] == [("chaos.bw-cap", "w1"), ("chaos.jitter", "w3"),
                                   ("chaos.slow", "w2")]
    assert summary["spans"] > 4 * 4 * 3 and summary["bytes"] > 0
    assert {"spans-w0.jsonl", "spans-psw.jsonl", "spans-scheduler.jsonl",
            "events-w1.jsonl"} <= set(summary["files"])


def test_traced_data_job_passes_the_trace_gates_on_the_cpu(monkeypatch):
    """The tiny ``train_data`` (b): each trainer process's ``input_wait``
    spans equal its logged boundary waits, and every wait after its first
    encode sits in a round's trace."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    model = {"model_type": "causal-lm", "family": "llama", "preset": "tiny", "seed": 0,
             "config": {"num_layers": 1, "remat": True}}
    root = Path(tempfile.mkdtemp(prefix="hda"))
    tdir = None
    try:
        with chip_smoke.traced_phase("train_data") as tdir:
            run = asyncio.run(asyncio.wait_for(chip_smoke.run_data_job(
                root, model, device="cpu", rounds=3, steps=4, batch=2, seq=16, period=64), 300))
        rep = chip_smoke.data_report(run)
        assert chip_smoke.data_problems(run, rep, rounds=3, layers=1, device="cpu") == []
        problems, waits = chip_smoke.data_trace_problems(tdir, rep)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if tdir is not None:
            shutil.rmtree(tdir, ignore_errors=True)
    assert problems == [], (problems, waits)
    assert sorted(waits) == ["w0", "w1"] and all(w["count"] >= 3 for w in waits.values())


def test_traced_serve_router_passes_the_trace_gates_on_the_cpu(tmp_path):
    """The tiny ``serve_router`` as processes, traced and exporting to a
    loopback collector: every answer's route span holds the answering
    worker's prefill in its trace, w1's spans read through its kill, and
    the collector got the scheduler's ``serve_job`` span and every node's
    bandwidth gauge."""
    from test_torch_node_cli import ROUTER_NEW, ROUTER_PROMPTS

    job = {"job.kind": "serve", "job.serve_name": "tiny", "job.model_family": "llama",
           "job.model_preset": "tiny", "job.model_type": "causal-lm", "job.model_seed": 2,
           "job.model_config": {"max_seq_len": 512}, "job.serve_max_batch": 4,
           "job.serve_block_size": 16, "job.serve_ragged": True,
           "job.serve_max_new_tokens": 32, "job.serve_workers": 2,
           "job.serve_prefix_cache": True, "job.serve_prefix_affinity": True,
           "job.serve_queue_limit": 4}
    root = Path(tempfile.mkdtemp(prefix="tsr"))
    collector = chip_smoke.OtlpCollector()
    tdir = None
    try:
        with chip_smoke.traced_phase("serve_router") as tdir:
            run = asyncio.run(chip_smoke.run_serve_router(
                root, job, ROUTER_PROMPTS, ROUTER_NEW, device="cpu", trace_dir=tdir,
                otlp=collector.endpoint))
        answered = len(run["answers"]) + len(run["again"]) + len(run["after_kill"])
        problems, fig = chip_smoke.router_trace_problems(
            tdir, collector, answered=answered, alive=chip_smoke.ROUTER_ROLES)
    finally:
        collector.close()
        shutil.rmtree(root, ignore_errors=True)
        if tdir is not None:
            shutil.rmtree(tdir, ignore_errors=True)
    assert problems == [], (problems, fig)
    assert answered == len(ROUTER_PROMPTS) + 8 and fig["w1_spans"] > 0
    assert fig["services"] == ["hypha-gateway", "hypha-scheduler", "hypha-w0", "hypha-w1"]
