"""``chip_smoke.py``'s metrics-plane gates rehearsed on the CPU: the tiny
``train_het`` and ``serve_router`` with the live metrics plane on (as the
smoke runs them on the card), each held to ``het_metrics_problems`` /
``router_metrics_problems``; the gates fed synthetic journals that each
fail one of them; and ``shard0_resends``, the ``train_shard_ft`` gate that
tells a group reducer's replacing partial from a re-send, fed one
synthetic report of each kind."""

from __future__ import annotations

import asyncio
import shutil
import tempfile
from pathlib import Path

import pytest

import chip_smoke
from hypha_tpu_torch.telemetry import trace
from hypha_tpu_torch.telemetry.flight import FLIGHT
from hypha_tpu_torch.telemetry.ft_metrics import HET_METRICS

TINY = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
        "config": {"dtype": "float32"}, "seed": 0}


@pytest.fixture(autouse=True)
def untraced():
    trace._reset_for_tests()
    trace.disable()
    HET_METRICS.reset()
    yield
    trace._reset_for_tests()
    FLIGHT.disarm()
    FLIGHT.clear()
    HET_METRICS.reset()


# -- shard 0's re-sends in train_shard_ft --------------------------------------

SHARD_REPORTS = {
    # The reducer w0's flush timer shipped a partial of w2 alone, then its
    # replacement covering w1 and w2: no re-send.
    "reducer-replacement": ({"0/0/w0/partial": 2, "1/1/w0/partial": 1},
                            {"0/0/w0": [["w2"], ["w1", "w2"]], "1/1/w0": [["w1", "w2"]]}, {}),
    # A trainer re-sent its own delta to shard 0.
    "trainer-resend": ({"0/0/w3/direct": 2, "0/0/w0/partial": 1},
                       {"0/0/w0": [["w1", "w2"]]}, {"0/0/w3/direct": 2}),
    # The reducer shipped a cover already folded.
    "repeated-cover": ({"0/2/w0/partial": 2}, {"0/2/w0": [["w1", "w2"], ["w1", "w2"]]},
                       {"0/2/w0/partial": 2}),
    # A later partial that covers less than the one before.
    "shrinking-cover": ({"0/2/w0/partial": 2}, {"0/2/w0": [["w1", "w2"], ["w2"]]},
                        {"0/2/w0/partial": 2}),
    # Shard 1's re-sends are the fault the phase injects: not shard 0's.
    "shard-1-resend": ({"1/1/w1/direct": 2}, {}, {}),
}


@pytest.mark.parametrize("kind", sorted(SHARD_REPORTS))
def test_shard0_resend_gate_tells_a_replacing_partial_from_a_resend(kind):
    pushes, covers, want = SHARD_REPORTS[kind]
    assert chip_smoke.shard0_resends({"pushes_by_shard": pushes, "partial_covers": covers}) == want


# -- the gates on synthetic journals --------------------------------------------


def _het_fixture():
    run = {"workers": ["w0", "w1"],
           "result": type("R", (), {"metrics": [("w0", 0, {"loss": 3.0, "samples": 4.0}),
                                               ("w1", 0, {"loss": 3.5, "samples": 4.0})]})()}
    rep = {"per_round": [{"round": 0, "assigned": {"w0": 4}},
                         {"round": 1, "assigned": {"w0": 4, "w1": 2}}]}
    gauges = {"hypha.het.assigned_steps.w0": 4.0, "hypha.het.assigned_steps.w1": 2.0}
    recs = [{"type": "report", "peer": p, "round": 1, "gauges": gauges if p == "psw" else {}}
            for p in ("psw", "w0", "w1")]
    recs += [{"type": "quality", "peer": "w0", "round": 0, "loss": 3.0, "samples": 4.0},
             {"type": "quality", "peer": "w1", "round": 0, "loss": 3.5, "samples": 4.0},
             {"type": "slo", "rule": "round_wall_s <= 10", "peer": "", "breached": True}]
    return run, rep, recs


@pytest.mark.parametrize("fault", ["none", "no-server-report", "assignment", "quality",
                                   "recovered", "quorum-drop"])
def test_het_metrics_gate_fails_on_each_fault(fault):
    run, rep, recs = _het_fixture()
    if fault == "no-server-report":
        recs = [r for r in recs if r.get("peer") != "psw"]
    elif fault == "assignment":
        recs[0]["gauges"] = {"hypha.het.assigned_steps.w0": 4.0}
    elif fault == "quality":
        recs[3]["loss"] = 3.0001
    elif fault == "recovered":
        recs.append({"type": "slo", "rule": "round_wall_s <= 10", "peer": "", "breached": False})
    elif fault == "quorum-drop":
        recs.append({"type": "slo", "rule": "hypha.het.quorum_drops == 0", "peer": "",
                     "breached": True})
    problems = chip_smoke.het_metrics_problems(run, rep, recs, round_wall_s=10.0)
    assert (problems == []) is (fault == "none"), problems


def _router_fixture():
    latency = {"hypha.serve.request_latency_ms": {"count": 7.0}}
    recs = [{"type": "report", "peer": "w0:r@0", "summaries": latency},
            {"type": "report", "peer": "w1:r@1",
             "summaries": {"hypha.serve.request_latency_ms": {"count": 5.0}}},
            {"type": "slo", "rule": "silent_s <= 3 @peer", "peer": "w1:r@1", "breached": True,
             "t": 105.0},
            {"type": "slo", "rule": "silent_s <= 3 @peer", "peer": "r@1", "breached": True,
             "t": 105.5}]
    run = {"workers": {"w0": {"launches": {"requests": 8, "fallbacks": 0},
                              "cache": {"rejections": 1}}},
           "w1_before_kill": {"launches": {"requests": 5, "fallbacks": 0}, "cache": {}},
           "metrics": {"killed_at": 100.0, "ended_at": 120.0,
                       "top_live": {"last_seen": {"w0:r@0": 1, "w1:r@1": 1, "r@0": 1}},
                       "top_dir": {"last_seen": {"w0:r@0": 1, "w1:r@1": 1, "r@0": 1, "r@1": 1}}}}
    return run, recs


@pytest.mark.parametrize("fault", ["none", "w0-silent", "before-kill", "p99", "count",
                                   "top-live", "top-dir"])
def test_router_metrics_gate_fails_on_each_fault(fault):
    run, recs = _router_fixture()
    if fault == "w0-silent":
        recs.append({"type": "slo", "rule": "silent_s <= 3 @peer", "peer": "r@0",
                     "breached": True, "t": 110.0})
    elif fault == "before-kill":
        recs[2]["t"] = 99.0
    elif fault == "p99":
        recs.append({"type": "slo", "rule": "hypha.serve.request_latency_ms.p99 <= 120000",
                     "peer": "", "breached": True, "t": 110.0})
    elif fault == "count":
        recs[0]["summaries"] = {"hypha.serve.request_latency_ms": {"count": 8.0}}
    elif fault == "top-live":
        run["metrics"]["top_live"] = {"last_seen": {"w0:r@0": 1}}
    elif fault == "top-dir":
        run["metrics"]["top_dir"] = {"last_seen": {"w0:r@0": 1}}
    problems = chip_smoke.router_metrics_problems(run, recs, silent_s=3.0)
    assert (problems == []) is (fault == "none"), problems


# -- the phases on the CPU -------------------------------------------------------


def test_het_job_with_the_plane_passes_the_metrics_gates_on_the_cpu(monkeypatch):
    """The tiny ``train_het`` with the plane on and traced (the journal in
    the trace directory): every node reports, the server's assigned-step
    gauges hold each round's assignment, the journal's quality points are
    the trainers' METRICS, the round wall rule (0.2 s here: the tiny rounds
    are seconds long) breaches once and the quorum-drop rule never."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = Path(tempfile.mkdtemp(prefix="mhet"))
    tdir = None
    rules = chip_smoke.het_slo_rules(0.2)
    try:
        with chip_smoke.traced_phase("train_het") as tdir:
            run = asyncio.run(asyncio.wait_for(chip_smoke.run_het_job(
                root, TINY, device="cpu", rounds=3, steps=4, batch=2, seq=16, period=64,
                lr=3e-3, deadline_s=5.0, chaos="bw-cap:w1:1,slow-worker:w2:8,jitter:w3:0.2",
                hi_mbps=8.0, lo_mbps=8.0, limit_s=60, auction_timeout=1.0,
                status_timeout=60.0, slo_rules=rules, metrics_interval_s=0.2), 150))
        rep = chip_smoke.het_report(run)
        het = chip_smoke.het_problems(run, rep, rounds=3, steps=4, layers=2, device="cpu")
        recs, nbytes = chip_smoke.metrics_journal(tdir)
        problems = chip_smoke.het_metrics_problems(run, rep, recs, round_wall_s=0.2)
        fig = chip_smoke.plane_figures(recs, nbytes)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if tdir is not None:
            shutil.rmtree(tdir, ignore_errors=True)
    assert het == [] and problems == [], (het, problems)
    assert sorted(fig["per_node"]) == ["psw", "w0", "w1", "w2", "w3"]
    assert fig["breaches"] == {"round_wall_s <= 0.2 [fleet]": 1} and nbytes > 0
    assert run["plane"]["reports"] == sum(n["reports"] for n in fig["per_node"].values())
    assert chip_smoke.sample_cost_us(50) > 0


def test_serve_router_with_the_plane_passes_the_metrics_gates_on_the_cpu():
    """The tiny ``serve_router`` as processes with the plane on: ``w1``
    alone breaches the silence rule (6 s here, above a loaded CPU's
    stalls), after its kill; the p99 rule holds; the journal's latency
    counts are the requests each worker answered; ``telemetry.top --once``
    lists both workers live and every reporter from the journal."""
    from test_torch_node_cli import ROUTER_NEW, ROUTER_PROMPTS

    job = {"job.kind": "serve", "job.serve_name": "tiny", "job.model_family": "llama",
           "job.model_preset": "tiny", "job.model_type": "causal-lm", "job.model_seed": 2,
           "job.model_config": {"max_seq_len": 512}, "job.serve_max_batch": 4,
           "job.serve_block_size": 16, "job.serve_ragged": True,
           "job.serve_max_new_tokens": 32, "job.serve_workers": 2,
           "job.serve_prefix_cache": True, "job.serve_prefix_affinity": True,
           "job.serve_queue_limit": 4}
    root = Path(tempfile.mkdtemp(prefix="msr"))
    try:
        run = asyncio.run(chip_smoke.run_serve_router(
            root, job, ROUTER_PROMPTS, ROUTER_NEW, device="cpu",
            slo_rules=chip_smoke.router_slo_rules(6.0)))
        m = run["metrics"]
        problems = chip_smoke.router_metrics_problems(run, m["records"], silent_s=6.0)
        fig = chip_smoke.plane_figures(m["records"], m["journal_bytes"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert problems == [], (problems, fig)
    assert {label.split(":")[0] for label in fig["per_node"]} == {"w0", "w1"}
    assert all(k.startswith("silent_s <= 6 @peer [") for k in fig["breaches"])
