"""Port parity: WAN-adaptive outer rounds and the data-plane chaos kinds.

The same numpy-seeded inputs go through ``hypha_tpu`` and
``hypha_tpu_torch`` (``tests/test_het.py``'s cases, less its slow e2e):

* ``Ewma`` and ``StragglerController`` over seeded feeds of ``note_batch``,
  ``note_round_closed`` and ``start_round`` on one injected clock, with the
  warmup, drop-penalty, min-steps, deadband, boost and cadence-floor cases
  and ``snapshot`` / ``resume_warmup``: every ``steps_for``, ``counter_for``,
  ``assignments`` and ``snapshot`` equal, exactly;
* ``codec_for_bandwidth`` and ``LinkTable`` over a grid of rates, base
  codecs and thresholds, the raises included;
* the batch scheduler's answers over a Status/Updated transcript with a
  quorum-dropped peer (``tests/test_torch_scheduler.py``'s ``adaptive_transcript``);
* the wire: ``UPDATED`` without ``adaptive_steps`` byte-identical, with it
  carrying ``arrival_s``; ``RoundMembership.inner_steps`` and the TOML keys
  reaching the job as in the reference;
* ``_broadcast_adaptive``: each codec group's files byte-equal to the JAX
  server's, with the same headers, over rounds with a codec switch, and
  the per-peer residuals equal;
* the trainer's upload codec after a hint, against the JAX trainer's
  (losses within the parity bound of ``tests/test_torch_training.py``);
* the elastic collector: the static deadline drops the slow uploader, the
  first-round grace waits for it, an abandoned drain still measures the
  link (a lower bound), arrivals credited as in the reference;
* the chaos kinds on real nodes: jitter's delays are the reference's
  seeded sequence, a bandwidth cap is measured mid-stream in both
  directions, a slow worker stretches its Status cadence, partition-ps
  severs and heals;
* a JAX and a torch worker in an elastic int8 job with ``adaptive_steps``
  and ``adaptive_codec`` under either package's scheduler and server (θ₀
  from a ``source`` file): every round closes, and both trainers switch
  their uploads to the hinted int4.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import random
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import chip_smoke
from _torch_parity import tiny_pair
from hypha_tpu import compress as jcompress
from hypha_tpu import messages as jmsg
from hypha_tpu import native
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.ft import adaptive as jad
from hypha_tpu.ft import chaos as jchaos
from hypha_tpu.ft.membership import RoundMembership as JRM
from hypha_tpu.worker import ps_executor as jps
from hypha_tpu_torch import compress as tcompress
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.ft import adaptive as tad
from hypha_tpu_torch.ft import chaos as tchaos
from hypha_tpu_torch.ft.membership import RoundMembership as TRM
from hypha_tpu_torch.network import Node, TcpTransport
from hypha_tpu_torch.stream import RoundAccum
from hypha_tpu_torch.worker import ps_executor as tps
from test_torch_scheduler import adaptive_transcript

PKGS = {"jax": (jad, jmsg, jps, jcompress), "port": (tad, tmsg, tps, tcompress)}


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# -- Ewma and the straggler controller ----------------------------------------


@pytest.mark.parametrize("alpha", [0.1, 0.4, 1.0])
def test_ewma_matches_the_reference(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    j, t = jad.Ewma(alpha), tad.Ewma(alpha)
    assert j.value is t.value is None
    for i, v in enumerate(rng.exponential(2.0, 40)):
        assert t.update(float(v)) == j.update(float(v))
        if i % 7 == 3:
            j.scale(1.5)
            t.scale(1.5)
        assert t.value == j.value
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            tad.Ewma(bad)


# name -> (constructor kwargs, per-batch seconds of w0..w3, peers left out
# of the arrivals by round, a resume (round, snapshot?) after some round)
CONTROLLER_CASES = {
    "warmup": ({"base_steps": 8}, (1.0, 1.0, 1.0, 4.0), {}, None),
    "no_warmup": ({"base_steps": 8, "warmup_rounds": 0}, (1.0, 1.2, 0.9, 3.0), {}, None),
    "drop_penalty": ({"base_steps": 8, "drop_penalty": 2.0}, (1.0, 1.0, 1.0, 1.0),
                     {1: {"w3"}, 2: {"w3"}, 3: {"w3"}}, None),
    "min_steps": ({"base_steps": 8, "min_steps": 3}, (1.0, 1.0, 1.0, 16.0), {}, None),
    "deadband": ({"base_steps": 16, "deadband": 3.0}, (1.0, 1.0, 2.5, 5.0), {}, None),
    "boost": ({"base_steps": 8, "max_boost": 4.0}, (1.0, 1.0, 0.2, 1.0), {}, None),
    "cadence_floor": ({"base_steps": 8}, (1.0, 1.0, 1.0, 4.0), {}, "headstart"),
    "resume_warmup": ({"base_steps": 8}, (1.0, 1.0, 4.0, 1.0), {}, (2, True)),
    "resume_cold": ({"base_steps": 8}, (1.0, 4.0, 1.0, 1.0), {2: {"w1"}}, (2, False)),
}


def _controller_feed(mod, case: str) -> list:
    """Drive one package's controller through 5 rounds of a seeded fleet
    and record every answer. Each worker's batches take its speed times a
    seeded jitter; its arrival lag is its batches' time plus an upload."""
    kw, speeds, drops, resume = CONTROLLER_CASES[case]
    rng = np.random.default_rng(sorted(CONTROLLER_CASES).index(case))
    now = [0.0]
    ctrl = mod.StragglerController(clock=lambda: now[0], **kw)
    peers = [f"w{i}" for i in range(len(speeds))]
    out = []
    for r in range(5):
        lags = {}
        for i, p in enumerate(peers):
            steps = ctrl.steps_for(p)
            out.append(("counter", r, p, ctrl.counter_for(p)))
            t = 0.0
            for _ in range(steps):
                dt = float(speeds[i] * rng.uniform(0.9, 1.1))
                t += dt
                now[0] += dt
                ctrl.note_batch(p)
            out.append(("counter_after", r, p, ctrl.counter_for(p)))
            lags[p] = t + float(rng.uniform(0.1, 0.3))
            if resume == "headstart" and p == "w3":
                lags[p] = 0.05  # landed inside the previous broadcast window
        arrivals = {p: v for p, v in lags.items() if p not in drops.get(r, set())}
        ctrl.note_round_closed(r, arrivals)
        ctrl.note_round_closed(r - 1, {"w0": 99.0})  # a stale re-notify: ignored
        out.append(("assignments", r, dict(sorted(ctrl.assignments().items()))))
        ctrl.start_round(r + 1, peers)
        out.append(("frozen", r + 1, dict(sorted(ctrl.assignments().items()))))
        if isinstance(resume, tuple) and r + 1 == resume[0]:
            snap = ctrl.snapshot()
            out.append(("snapshot", snap))
            ctrl = mod.StragglerController(clock=lambda: now[0], **kw)
            ctrl.resume_warmup(r + 1, snap if resume[1] else None)
            out.append(("resumed", [ctrl.steps_for(p) for p in peers], ctrl.assignments()))
    out.append(("snapshot", ctrl.snapshot()))
    return out


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_straggler_controller_matches_the_reference(case):
    want = _controller_feed(jad, case)
    assert _controller_feed(tad, case) == want
    if case in ("warmup", "min_steps"):
        last = [e for e in want if e[0] == "frozen"][-1][2]
        assert last["w3"] < last["w0"], "the slow worker runs fewer steps"


@pytest.mark.parametrize("kw", [{"base_steps": 0}, {"base_steps": 4, "min_steps": 0},
                                {"base_steps": 4, "max_boost": 0.5},
                                {"base_steps": 4, "deadband": 1.2}])
def test_straggler_controller_refuses_what_the_reference_refuses(kw):
    for mod in (jad, tad):
        with pytest.raises(ValueError):
            mod.StragglerController(**kw)


# -- codec ladder and link table ------------------------------------------------


@pytest.mark.parametrize("base", ["none", "bf16", "int8", "int4"])
def test_codec_for_bandwidth_matches_the_reference(base):
    rates = [0.0, 1e3, 9.99e6, 1e7, 5e7, 9.99e7, 1e8, 1e9, float("inf")]
    for bps in rates:
        for hi, lo in ((1e8, 1e7), (1e7, 1e7), (1e9, 0.0), (0.0, 0.0)):
            assert tcompress.codec_for_bandwidth(bps, base, hi, lo) == \
                jcompress.codec_for_bandwidth(bps, base, hi, lo), (bps, hi, lo)
    with pytest.raises(ValueError, match="base codec"):
        tcompress.codec_for_bandwidth(1.0, "zstd", 1.0, 1.0)


@pytest.mark.parametrize("base,hi,lo", [("none", 100.0, 10.0), ("int8", 200.0, 150.0),
                                        ("bf16", 5.0, 5.0), ("int4", 1e6, 1e3)])
def test_link_table_matches_the_reference(base, hi, lo):
    rng = np.random.default_rng(5)
    tables = {pkg: m[0].LinkTable(base_codec=base, hi_mbps=hi, lo_mbps=lo) for pkg, m in PKGS.items()}
    peers = ["a", "b", "c"]
    for pkg, tab in tables.items():
        assert [tab.codec_for(p) for p in peers] == [base] * 3
        assert not tab.measured("a") and tab.first_round_grace == 6.0
    for _ in range(12):
        p = peers[int(rng.integers(0, 3))]
        n, s = int(rng.integers(1, 10 ** 8)), float(rng.exponential(2.0))
        got = {pkg: tab.observe(p, n, s) for pkg, tab in tables.items()}
        assert got["port"] == got["jax"]
        for q in peers:
            assert tables["port"].codec_for(q) == tables["jax"].codec_for(q)
            assert tables["port"].bandwidth_bps(q) == tables["jax"].bandwidth_bps(q)
            assert tables["port"].measured(q) == tables["jax"].measured(q)
    snap = tables["port"].snapshot()
    assert snap == tables["jax"].snapshot()
    restored = {pkg: m[0].LinkTable(base_codec=base, hi_mbps=hi, lo_mbps=lo)
                for pkg, m in PKGS.items()}
    for tab in restored.values():
        tab.restore({**snap, "bad": "x", "zero": 0.0})
    assert restored["port"].snapshot() == restored["jax"].snapshot() == snap
    with pytest.raises(ValueError):
        tad.LinkTable(hi_mbps=1.0, lo_mbps=2.0)
    assert tad.LinkTable(first_round_grace=0.2).first_round_grace == 1.0


# -- the scheduler --------------------------------------------------------------


@pytest.mark.parametrize("case", ["slow_peer", "dropped_peer", "two_shards"])
def test_batch_scheduler_counters_match_the_reference(case):
    kw = {"slow_peer": {}, "dropped_peer": {"drop": {"w1"}, "speeds": (1.0, 1.0, 1.0, 1.0)},
          "two_shards": {"shards": 2}}[case]
    want = adaptive_transcript("jax", **kw)
    assert adaptive_transcript("port", **kw) == want
    assigned = [e[1] for e in want if e[0] == "assignments"]
    slow = "w1" if case == "dropped_peer" else "w2"
    assert assigned[-1][slow] < assigned[-1]["w0"]


def test_membership_inner_steps_encode_as_the_reference():
    for steps in (None, {}, {"w0": 8, "w1": 2}):
        j = jmsg.encode(JRM(epoch=3, active=["w0", "w1"], inner_steps=steps))
        t = tmsg.encode(TRM(epoch=3, active=["w0", "w1"], inner_steps=steps))
        assert t == j
        assert (b"inner_steps" in t) == bool(steps is not None)
        assert tmsg.decode(j) == TRM(epoch=3, active=["w0", "w1"], inner_steps=steps)


class _ReqNode:
    """Takes the server's UPDATED and answers OK."""

    def __init__(self, m) -> None:
        self.m, self.sent = m, []

    async def request(self, peer, protocol, msg, timeout=30):
        self.sent.append(self.m.encode(msg))
        return self.m.ProgressResponse(kind=self.m.ProgressResponseKind.OK)


@pytest.mark.parametrize("arrivals", [None, {"w0": 1.2345678, "w1": 0.5}])
def test_updated_bytes_match_the_reference(tmp_path, arrivals):
    sent = {}
    for pkg, (_, m, ps_mod, _) in PKGS.items():
        node = _ReqNode(m)
        kw = {"device": "cpu"} if pkg == "port" else {}
        ps = ps_mod.ParameterServerExecutor(node, tmp_path, **kw)
        run(ps._notify_updated("sched", "job", 3, arrivals=arrivals))
        sent[pkg] = node.sent
    assert sent["port"] == sent["jax"]
    assert (b"arrival_s" in sent["port"][0]) == (arrivals is not None)


def test_toml_adaptive_keys_reach_the_job_as_in_the_reference(tmp_path):
    from hypha_tpu import config as jcfg
    from hypha_tpu import node_config as jnc
    from hypha_tpu_torch import config as tcfg
    from hypha_tpu_torch import node_config as tnc

    toml = tmp_path / "scheduler.toml"
    toml.write_text('[job]\nadaptive_steps = true\nadaptive_codec = true\n'
                    'codec_bw_hi_mbps = 400.0\ncodec_bw_lo_mbps = 250.0\n'
                    'delta_codec = "int8"\n')
    jobs = {}
    for pkg, cfg, nc, m in (("jax", jcfg, jnc, jmsg), ("port", tcfg, tnc, tmsg)):
        job = cfg.builder(nc.SchedulerConfig).with_toml(toml).build().validate().value.job
        jobs[pkg] = m.encode(job.to_job())
    # The accelerator keys differ between the packages' defaults; the rest
    # of the job is the reference's.
    fields = ("adaptive_steps", "adaptive_codec", "codec_bw_hi_mbps", "codec_bw_lo_mbps",
              "delta_codec", "rounds", "inner_optimizer", "outer_optimizer", "ft")
    port, ref = tmsg.decode(jobs["port"]), tmsg.decode(jobs["jax"])
    assert [getattr(port, f) for f in fields] == [getattr(ref, f) for f in fields]
    assert (port.adaptive_steps, port.adaptive_codec, port.codec_bw_hi_mbps,
            port.codec_bw_lo_mbps) == (True, True, 400.0, 250.0)


# -- the parameter server --------------------------------------------------------


class _SpyNode:
    """Takes the server's broadcast pushes: (peer, header, payload)."""

    def __init__(self) -> None:
        self.pushes: list = []

    async def push(self, peer, header, source) -> int:
        data = Path(source).read_bytes()
        self.pushes.append((peer, dict(header), data))
        return len(data)


def _cfg(m, peers, **over):
    return m.AggregateExecutorConfig(
        updates=m.Receive(m.Reference.from_peers(list(peers), "u")),
        results=m.Send(m.Reference.from_peers(list(peers), "r")),
        optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=len(peers), **over)


# base codec -> each peer's measured bits/s in rounds 0 and 1 (thresholds
# 100 / 10 Mbit/s): every codec group, and a link switching codec.
BROADCAST_CASES = {
    "none": {"fast": (8e8, 8e8), "mid": (5e7, 5e7), "slow": (8e5, 8e5)},
    "bf16": {"fast": (8e8, 8e8), "mid": (5e7, 8e5), "slow": (8e5, 8e5)},
    "int8": {"fast": (8e8, 8e8), "mid": (5e7, 5e7), "slow": (5e7, 8e5)},
    "int4": {"fast": (8e8, 8e8), "slow": (8e5, 8e5)},
}


def _adaptive_broadcasts(pkg: str, root: Path, base: str) -> tuple:
    ad, m, ps_mod, comp = PKGS[pkg]
    rates = BROADCAST_CASES[base]
    node = _SpyNode()
    kw = {"device": "cpu"} if pkg == "port" else {}
    ps = ps_mod.ParameterServerExecutor(node, root, **kw)
    table = ad.LinkTable(base_codec=base, hi_mbps=100.0, lo_mbps=10.0, alpha=1.0)
    efs: dict = {}
    rng = np.random.default_rng(11)
    shapes = {"b/w": (33, 17), "a/v": (300,), "c": (1,)}
    out = []
    for rnd in range(3):
        for peer, (r0, r1) in rates.items():
            table.observe(peer, 10 ** 6, 8e6 / (r0 if rnd == 0 else r1))
        update = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 0)).astype(np.float32)
                  for k, s in shapes.items()}
        path = root / f"update-{rnd}.safetensors"
        save_file(update, str(path))
        node.pushes.clear()
        run(ps._broadcast_adaptive(_cfg(m, sorted(rates)), path, rnd, None, table, efs, root))
        out.append(sorted(node.pushes, key=lambda x: x[0]))
        assert not list(root.glob("*.wire.safetensors")), "scratch wires removed"
    residuals = {p: {k: np.asarray(torch.as_tensor(v).numpy() if pkg == "port" else v)
                     for k, v in ef.state().items()} for p, ef in efs.items()}
    return out, residuals


@pytest.mark.parametrize("base", sorted(BROADCAST_CASES))
def test_adaptive_broadcast_files_match_the_reference(tmp_path, monkeypatch, base):
    monkeypatch.setattr(native, "_load", lambda: None)
    got = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        got[pkg] = _adaptive_broadcasts(pkg, tmp_path / pkg, base)
    (want, want_res), (out, res) = got["jax"], got["port"]
    assert out == want  # every peer's header and bytes, every round
    assert set(res) == set(want_res)
    for peer in res:
        for name in want_res[peer]:
            np.testing.assert_array_equal(res[peer][name], want_res[peer][name])
    codecs = {(p, r): h["codec"] for r, pushes in enumerate(out) for p, h, _ in pushes}
    assert set(codecs.values()) >= {base}
    assert all(h["round"] == r for r, pushes in enumerate(out) for _, h, _ in pushes)


class _TimedConsumer:
    """Pushes handed out at scheduled offsets from the first ``next``."""

    def __init__(self, schedule) -> None:
        self._sched = sorted(schedule, key=lambda x: x[0])
        self._t0 = None

    async def next(self, timeout=None):
        loop = asyncio.get_running_loop()
        if self._t0 is None:
            self._t0 = loop.time()
        if not self._sched:
            await asyncio.sleep(min(timeout or 0.05, 0.05))
            raise asyncio.TimeoutError
        due, push = self._sched[0]
        remaining = self._t0 + due - loop.time()
        if timeout is not None and remaining > timeout:
            await asyncio.sleep(timeout)
            raise asyncio.TimeoutError
        if remaining > 0:
            await asyncio.sleep(remaining)
        self._sched.pop(0)
        return push


class _Push:
    """A delta push whose payload takes ``drain_s`` to stream in."""

    def __init__(self, peer, value, drain_s=0.0) -> None:
        self.peer, self.drain_s, self.finished = peer, drain_s, False
        self.resource = {"resource": "u", "name": f"d-{peer}", "round": 0, "num_samples": 8.0}
        self.value = value

    async def save_to(self, dest, hasher=None):
        if self.drain_s > 0:
            # Part of the payload lands, then the rest streams on.
            Path(dest).write_bytes(b"x" * 4096)
            await asyncio.sleep(self.drain_s)
        save_file({"w": np.full((3,), self.value, np.float32)}, str(dest))
        return Path(dest).stat().st_size

    async def read_all(self):
        return b""

    def finish(self):
        self.finished = True


def _collect(pkg: str, root: Path, schedule, adaptive: bool, quorum=0.75, deadline=0.4):
    ad, m, ps_mod, _ = PKGS[pkg]
    peers = ["w0", "w1", "w2", "w3"]
    cfg = _cfg(m, peers, quorum_fraction=quorum, round_deadline_s=deadline)
    st = ps_mod._ElasticState(cfg, "sched")
    link = ad.LinkTable(first_round_grace=6.0) if adaptive else None
    arrivals: dict = {}
    if pkg == "port":
        ps = ps_mod.ParameterServerExecutor(None, root, device="cpu")
        coro = ps._collect_round_elastic(_TimedConsumer(schedule()), "job", st, cfg, root, 0,
                                         RoundAccum(device="cpu"), link=link, arrivals=arrivals)
    else:
        ps = ps_mod.ParameterServerExecutor(node=None, work_root=root)
        coro = ps._collect_round_elastic(_TimedConsumer(schedule()), "job", st, cfg, root, 0,
                                         link=link, arrivals=arrivals)
    t0 = time.monotonic()
    received = run(coro, timeout=20)
    return set(received), arrivals, link, time.monotonic() - t0


@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "grace"])
def test_first_round_grace_as_the_reference(tmp_path, monkeypatch, adaptive):
    """Static: the capped peer's delta (at 1.5 s) misses the 0.4 s deadline
    and the round closes at quorum; adaptive: the first-round grace (6x)
    waits for the unmeasured peer, and its lag is the largest."""
    monkeypatch.setattr(native, "_load", lambda: None)

    def schedule():
        return [(0.02, _Push("w0", 1.0)), (0.03, _Push("w1", 2.0)), (0.05, _Push("w2", 3.0)),
                (1.5, _Push("w3", 4.0))]

    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        out[pkg] = _collect(pkg, tmp_path / pkg, schedule, adaptive)
    want = {"w0", "w1", "w2", "w3"} if adaptive else {"w0", "w1", "w2"}
    assert out["port"][0] == out["jax"][0] == want
    assert set(out["port"][1]) == set(out["jax"][1]) == want
    if adaptive:
        assert out["port"][2].measured("w3") and out["jax"][2].measured("w3")
        assert out["port"][1]["w3"] == max(out["port"][1].values())


def test_abandoned_drain_is_a_lower_bound_sample(tmp_path, monkeypatch):
    """Quorate at 0.4 s, the capped peer's payload still streaming: the
    drain is abandoned at the deadline (plus slack), and the bytes it took
    over that budget still feed the link table, in both packages."""
    monkeypatch.setattr(native, "_load", lambda: None)
    slow = {}

    def schedule_for(pkg):
        def schedule():
            slow[pkg] = _Push("w3", 4.0, drain_s=5.0)
            return [(0.02, _Push("w0", 1.0)), (0.03, _Push("w1", 2.0)),
                    (0.05, _Push("w2", 3.0)), (0.1, slow[pkg])]
        return schedule

    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        ad = PKGS[pkg][0]
        # Measured already (a later round): the plain deadline applies.
        link = ad.LinkTable(first_round_grace=6.0)
        for p in ("w0", "w1", "w2", "w3"):
            link.observe(p, 10 ** 6, 0.01)
        orig = ad.LinkTable
        monkeypatch.setattr(ad, "LinkTable", lambda **kw: link)
        out[pkg] = _collect(pkg, tmp_path / pkg, schedule_for(pkg), True)
        monkeypatch.setattr(ad, "LinkTable", orig)
    for pkg, (received, arrivals, link, elapsed) in out.items():
        assert received == {"w0", "w1", "w2"} and slow[pkg].finished, pkg
        assert elapsed < 3.0, pkg
        # EWMA (0.4) of 8e8 bit/s and the drain's 4096 B over ~0.55 s.
        assert link.bandwidth_bps("w3") < 0.7 * 8e8, pkg
        partial = hashlib.sha256(b"w3").hexdigest()[:24]
        assert not list((tmp_path / pkg).glob(f"delta-0-{partial}*")), pkg
    assert out["port"][2].bandwidth_bps("w3") == pytest.approx(
        out["jax"][2].bandwidth_bps("w3"), rel=0.05)


# -- the trainer -----------------------------------------------------------------


def _hint_session(msgs, compress_mod, work_dir: Path, weights: Path, hints: list):
    """``tests/test_torch_training.py``'s session whose broadcasts carry a
    per-link codec hint per round and which records each upload's codec."""
    from test_torch_training import _Session

    class HintSession(_Session):
        codecs: list = []

        def send_resource(self, send, path, resource="updates", meta=None):
            src = self.dir / path
            header = tcompress.frame_header(src) if tcompress.is_frame(src) else None
            self.codecs.append(header["codec"] if header else "none")
            delta = {k: np.asarray(v, np.float32) for k, v in jcompress.read_delta(src).items()}
            self.deltas.append(delta)
            update = {}
            for k, g in delta.items():
                mom = 0.9 * self.momentum.get(k, np.zeros_like(g)) + g
                self.momentum[k] = mom
                update[k] = (0.7 * (0.9 * mom + g)).astype(np.float32)
            (self.dir / "incoming").mkdir(exist_ok=True)
            out = self.dir / "incoming" / f"update-{meta['round']}.safetensors"
            save_file(update, str(out))
            self.events.put({"path": f"incoming/{out.name}",
                             "meta": {"round": meta["round"], "codec": hints[meta["round"]]}})

    s = HintSession(work_dir, msgs, weights, rounds=len(hints))
    s.codecs = []
    return s


def test_trainer_switches_its_upload_codec_as_the_reference(tmp_path, monkeypatch):
    """Hints int4 (a switch), int4 again (ignored: equal), "zstd"
    (ignored: unknown), none (a switch, residual kept): both trainers
    upload int8, int4, int4, int4, none."""
    from hypha_tpu.executor.training import run_training as jax_run
    from hypha_tpu_torch.executor.training import run_training as port_run
    from test_torch_training import _port_spec, _spec

    monkeypatch.setattr(native, "_load", lambda: None)
    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    hints = ["int4", "int4", "zstd", "none", "none"]
    spec = _spec(delta_codec="int8")
    js = _hint_session(jmsg, jcompress, tmp_path, weights, hints)
    jres = jax_run(js, tmp_path, spec)
    ps = _hint_session(tmsg, tcompress, tmp_path, weights, hints)
    pres = port_run(ps, tmp_path, _port_spec(spec), device="cpu")
    assert js.codecs == ps.codecs == ["int8", "int4", "int4", "int4", "none"]
    assert pres.rounds == jres.rounds == 5
    # f32 on the host both ways, as tests/test_torch_training.py, but the
    # uploads are quantized: a Δθ element the two trainers round ~1e-6
    # apart can land one int4 level (scale / 7) apart, and the outer step
    # carries that into the later rounds. Within 1e-3 over 5 rounds.
    np.testing.assert_allclose(pres.losses, jres.losses, atol=1e-3, rtol=0)


# -- chaos on real nodes -----------------------------------------------------------


class _Holder:
    def __init__(self, node) -> None:
        self.node = node

    async def stop(self) -> None:
        await self.node.stop()


async def _mesh(names) -> dict:
    nodes = {n: Node(TcpTransport(), peer_id=n) for n in names}
    for n in nodes.values():
        await n.start(["127.0.0.1:0"])
    for x in nodes.values():
        for y in nodes.values():
            if x is not y:
                x.add_peer_addr(y.peer_id, y.listen_addrs[0])
    return nodes


def test_jitter_delays_are_the_reference_sequence(monkeypatch):
    """Every push touching the jittered peer waits the reference's seeded
    draws, in order; pushes between other peers do not wait."""
    delays = []
    real_sleep = asyncio.sleep

    async def sleep(s, *a, **k):
        delays.append(s)
        await real_sleep(0)

    async def main():
        nodes = await _mesh(["w0", "w1", "w3"])
        try:
            tchaos.ChaosController(tchaos.parse_chaos_specs("jitter:w3:0.2", "w0"),
                                   {n: _Holder(v) for n, v in nodes.items()})
            got = [nodes[n].consume_pushes(lambda p: True) for n in nodes]
            monkeypatch.setattr(asyncio, "sleep", sleep)
            for src, dst in (("w3", "w0"), ("w0", "w1"), ("w0", "w3"), ("w1", "w3"), ("w3", "w1")):
                await nodes[src].push(dst, {"resource": "r"}, b"x" * 100)
            monkeypatch.setattr(asyncio, "sleep", real_sleep)
            del got
        finally:
            for n in nodes.values():
                await n.stop()

    run(main())
    rng = random.Random("hypha-chaos-jitter:w3:0.2")
    want = [rng.uniform(0.0, 0.2) for _ in range(4)]
    assert [d for d in delays if d > 0] == want


@pytest.mark.parametrize("direction", ["upload", "broadcast"])
def test_bw_cap_is_measured_mid_stream_in_both_directions(direction):
    """A 2 Mbit/s cap on w1: a 256 KiB push from it (an upload) or to it (a
    broadcast) drains at the cap at the receiver, which measures it with a
    ``LinkTable`` as the server does; an uncapped link stays fast."""

    async def main():
        nodes = await _mesh(["w1", "ps", "w2"])
        try:
            tchaos.ChaosController(tchaos.parse_chaos_specs("bw-cap:w1:2", "w1"),
                                   {n: _Holder(v) for n, v in nodes.items()})
            table = tad.LinkTable()
            src, dst = ("w1", "ps") if direction == "upload" else ("ps", "w1")
            for a, b in ((src, dst), ("w2", "ps")):
                consumer = nodes[b].consume_pushes(lambda p: True)
                send = asyncio.create_task(nodes[a].push(b, {"resource": "r"}, b"y" * 262144))
                push = await consumer.next(timeout=10)
                t0 = time.monotonic()
                n = await push.save_to(Path(tempfile.mkdtemp()) / "f")
                table.observe(a, n or 262144, time.monotonic() - t0)
                await send
                consumer.close()
            return table.bandwidth_bps(src), table.bandwidth_bps("w2")
        finally:
            for n in nodes.values():
                await n.stop()

    capped, free = run(main())
    assert 0.5 * 2e6 < capped < 1.1 * 2e6
    assert free > 20 * capped


def test_slow_worker_stretches_its_status_cadence():
    """slow-worker:w2:3: each Status after the first waits twice the gap
    since the previous answer; another protocol passes untouched."""

    async def main():
        nodes = await _mesh(["w2", "sched"])
        try:
            nodes["sched"].on(tmsg.PROTOCOL_PROGRESS, tmsg.Progress).respond_with(
                lambda peer, p: _ok())
            tchaos.ChaosController(tchaos.parse_chaos_specs("slow-worker:w2:3", "w2"),
                                   {"w2": _Holder(nodes["w2"])})
            status = tmsg.Progress(kind=tmsg.ProgressKind.STATUS, job_id="j", batch_size=2)
            t0 = time.monotonic()
            for _ in range(3):
                await asyncio.sleep(0.05)  # the batch
                await nodes["w2"].request("sched", tmsg.PROTOCOL_PROGRESS, status)
            slow = time.monotonic() - t0
            t0 = time.monotonic()
            await nodes["w2"].request("sched", tmsg.PROTOCOL_PROGRESS,
                                      tmsg.Progress(kind=tmsg.ProgressKind.UPDATE, job_id="j"))
            return slow, time.monotonic() - t0
        finally:
            for n in nodes.values():
                await n.stop()

    slow, other = run(main())
    assert slow >= 0.05 * (1 + 2 * 2.0)
    assert other < 0.1


async def _ok():
    return tmsg.ProgressResponse(kind=tmsg.ProgressResponseKind.OK)


def test_partition_ps_severs_then_heals():
    """partition-ps:1:0.5 on psw: pushes to it and from it fail with
    ``RequestError`` for half a second, then flow again."""
    from hypha_tpu_torch.network.node import RequestError

    async def main():
        nodes = await _mesh(["w0", "psw"])
        try:
            actions = tchaos.parse_chaos_specs("partition-ps:1:0.5", "psw")
            ctl = tchaos.ChaosController(actions, {n: _Holder(v) for n, v in nodes.items()})
            ctl.on_round_metrics(0)
            for src, dst in (("w0", "psw"), ("psw", "w0")):
                with pytest.raises(RequestError, match="chaos partition-ps"):
                    await nodes[src].push(dst, {"resource": "r"}, b"z")
            await ctl.drain()
            consumer = nodes["psw"].consume_pushes(lambda p: True)
            assert await nodes["w0"].push("psw", {"resource": "r"}, b"z" * 10) == 10
            push = await consumer.next(timeout=5)
            return push.peer
        finally:
            for n in nodes.values():
                await n.stop()

    assert run(main()) == "w0"


# -- a mixed JAX/torch adaptive job --------------------------------------------------


@pytest.mark.parametrize("scheduler", ["port", "jax"])
def test_mixed_workers_run_an_adaptive_job(tmp_path, scheduler, caplog):
    """An elastic int8 job with ``adaptive_steps`` and ``adaptive_codec``
    (thresholds above any loopback link: every measured link degrades to
    int4) on a JAX and a torch worker, under the port's scheduler and
    server, then under the JAX ones: both rounds close with finite losses,
    and both trainers switch their uploads to int4 on the first hint."""
    from hypha_tpu.data_node import DataNode as JDataNode
    from hypha_tpu.ft.membership import FTConfig
    from hypha_tpu.gateway import Gateway as JGateway
    from hypha_tpu.network import Node as JNode
    from hypha_tpu.network import TcpTransport as JTcp
    from hypha_tpu.resources import Resources as JResources
    from hypha_tpu.scheduler.metrics_bridge import CallbackConnector
    from hypha_tpu.scheduler.orchestrator import Orchestrator
    from hypha_tpu.worker.arbiter import OfferConfig as JOfferConfig
    from hypha_tpu.worker.runtime import WorkerNode as JWorkerNode
    from hypha_tpu_torch.data_node import DataNode
    from hypha_tpu_torch.gateway import Gateway
    from hypha_tpu_torch.resources import Resources
    from hypha_tpu_torch.scheduler.metrics_bridge import CallbackConnector as TCallbackConnector
    from hypha_tpu_torch.scheduler.orchestrator import Orchestrator as TOrchestrator
    from hypha_tpu_torch.worker.arbiter import OfferConfig
    from hypha_tpu_torch.worker.runtime import WorkerNode
    from test_torch_worker_node import _dataset, _mixed_job

    rounds, port = 2, scheduler == "port"
    _, variables, _ = tiny_pair("llama", seed=7)
    weights = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(weights))
    data_dir = _dataset(tmp_path)
    job = _mixed_job(weights, rounds, delta_codec="int8", adaptive_steps=True,
                     adaptive_codec=True, codec_bw_hi_mbps=1e9, codec_bw_lo_mbps=1e9,
                     ft=FTConfig(quorum_fraction=0.5, round_deadline_s=60.0))
    root = Path(tempfile.mkdtemp(prefix="wh"))  # bridge sockets: paths under 108 bytes
    tracked: list = []
    listen = ["127.0.0.1:0"]

    async def main():
        Tcp, GW, DN, Sched = (TcpTransport, Gateway, DataNode, Node) if port else \
            (JTcp, JGateway, JDataNode, JNode)
        gw = GW(Tcp(), peer_id="gw")
        await gw.start(listen)
        boot = [gw.node.listen_addrs[0]]
        ps = (WorkerNode(TcpTransport(), resources=Resources(cpu=2, memory=200), device="cpu",
                         peer_id="psw", bootstrap=boot, work_root=root / "p") if port else
              JWorkerNode(JTcp(), resources=JResources(cpu=2, memory=200), peer_id="psw",
                          bootstrap=boot, work_root=root / "p"))
        parts = [DN(Tcp(), {"counting": data_dir}, peer_id="data", bootstrap=boot),
                 JWorkerNode(JTcp(), resources=JResources(gpu=2, cpu=8, memory=1000),
                             peer_id="wjax", offer=JOfferConfig(strategy="whole"),
                             bootstrap=boot, work_root=root / "j"),
                 WorkerNode(TcpTransport(), resources=Resources(gpu=2, cpu=8, memory=1000),
                            device="cpu", peer_id="wtorch", offer=OfferConfig(strategy="whole"),
                            bootstrap=boot, work_root=root / "t"),
                 ps]
        sched = Sched(Tcp(), peer_id="sched", bootstrap=boot)
        started = []
        try:
            for part in (*parts, sched):
                await part.start(listen)
                started.append(part)
            await sched.wait_for_bootstrap()
            if port:
                orch = TOrchestrator(sched, metrics_connector=TCallbackConnector(
                    lambda w, r, n, v: tracked.append((w, r, n, v))))
                return await orch.run(tmsg.decode(jmsg.encode(job)), auction_timeout=1.5)
            orch = Orchestrator(sched, metrics_connector=CallbackConnector(
                lambda w, r, n, v: tracked.append((w, r, n, v))))
            return await orch.run(job, auction_timeout=1.5)
        finally:
            for part in reversed(started):
                await part.stop()
            await gw.stop()

    caplog.set_level(logging.INFO)
    try:
        with chip_smoke.node_probes("cpu") as rec:
            result = asyncio.run(asyncio.wait_for(main(), 200))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert result.rounds == rounds
    losses = {(w, r): v for w, r, n, v in tracked if n == "loss"}
    assert set(losses) == {(w, r) for w in ("wjax", "wtorch") for r in range(rounds)}, losses
    assert all(np.isfinite(v) for v in losses.values()), losses
    switches = [r.getMessage() for r in caplog.records
                if "switching upload codec int8 -> int4" in r.getMessage()]
    assert len(switches) == 2, switches
    if port:
        frames = {(d["from"], d["round"]): d["frame"]["codec"] for d in rec["deltas"]}
        assert frames == {("wjax", 0): "int8", ("wtorch", 0): "int8",
                          ("wjax", 1): "int4", ("wtorch", 1): "int4"}, frames


# -- the smoke's train_het, rehearsed on the CPU ----------------------------------

TINY = {"model_type": "causal-lm", "family": "llama", "preset": "tiny",
        "config": {"dtype": "float32"}, "seed": 0}


def test_het_job_passes_the_smokes_gates_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ``train_het`` at the tiny size: w1's 110 KB int8
    delta over a 1 Mbit/s cap lands inside the first-round grace of a 5 s
    deadline, every later round is int4 on w1's link both ways and int8
    elsewhere, the 8x slow w2 runs fewer steps from round 1, the published
    assignments are the batches run and the weights folded, each per-peer
    wire decodes to update + residual before - residual after, no residual
    is shared, and nothing is dropped or left over (``het_problems``)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = Path(tempfile.mkdtemp(prefix="thet"))
    try:
        run_ = asyncio.run(asyncio.wait_for(chip_smoke.run_het_job(
            root, TINY, device="cpu", rounds=4, steps=4, batch=2, seq=16, period=64, lr=3e-3,
            deadline_s=5.0, chaos="bw-cap:w1:1,slow-worker:w2:8,jitter:w3:0.2", hi_mbps=8.0,
            lo_mbps=8.0, limit_s=60, auction_timeout=1.0, status_timeout=60.0), 150))
        rep = chip_smoke.het_report(run_)
        problems = chip_smoke.het_problems(run_, rep, rounds=4, steps=4, layers=2, device="cpu")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert problems == [], (problems, run_["logs"]["ps"][-30:])
    bw = rep["per_round"][-1]["bandwidth_bps"]
    assert 0.5e6 < bw["w1"] < 1.1e6 and min(bw[p] for p in ("w0", "w2", "w3")) > 8e6, bw
    assert [k for k, _, _ in run_["chaos"]] == ["bw-cap", "slow", "jitter"]
