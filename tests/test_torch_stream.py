"""Port parity: the streaming outer sync (``hypha_tpu_torch/stream``, the
trainer's ``_WorkerStream`` and the parameter server's stream loop)
against ``hypha_tpu/stream``, the JAX trainer and the JAX
``ParameterServerExecutor`` (numpy outer step: ``native._load`` patched to
None).

  * ``partition_names``, ``fragment_due``, ``effective_fragments`` and
    ``merge_corrected`` equal the JAX functions (the merge bit for bit);
  * ``run_training`` with ``sync_mode`` overlap and stream (F = 2, a tiny
    two-layer Llama) behind one fake session per package gives the JAX
    trainer's losses, fragment deltas and tags, also when a broadcast lands
    only after a step has run in flight (the drift the correction keeps);
  * overlap with zero flight time is bit-equal to the port's blocking path;
  * the port's parameter-server stream loop, fed the JAX trainer's HQD1
    frames by two workers (a delta for a round not yet open included),
    broadcasts frames byte-identical to the JAX loop's; a frame whose tag
    contradicts its push header is dropped.
"""

from __future__ import annotations

import asyncio
import queue
import threading
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from _torch_parity import tiny_pair
from hypha_tpu import compress as jcomp
from hypha_tpu import messages as jmsg
from hypha_tpu import native
from hypha_tpu import stream as jstream
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu_torch import compress as tcomp
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch import stream as tstream

SEQ, VOCAB, LR = 16, 256, 3e-3


# ------------------------------------------------------------ pure functions


def test_partition_and_schedule_equal_jax():
    rng = np.random.default_rng(3)
    for n in (1, 2, 5, 17, 40):
        sizes = {f"t{i:02d}/{'k' * (i % 3)}": int(s)
                 for i, s in enumerate(rng.integers(1, 1000, n))}
        sizes.update({f"tie{i}": 64 for i in range(n % 4)})  # equal sizes: the name breaks ties
        for f in range(1, min(len(sizes), 6) + 1):
            assert tstream.partition_names(sizes, f) == jstream.partition_names(sizes, f)
            assert tstream.fragment_of(sizes, f) == jstream.fragment_of(sizes, f)
    for bad in (0, 3):
        with pytest.raises(ValueError):
            jstream.partition_names({"a": 1, "b": 2}, bad)
        with pytest.raises(ValueError):
            tstream.partition_names({"a": 1, "b": 2}, bad)
    for r in range(12):
        for f in (1, 2, 4, 5):
            assert tstream.fragment_due(r, f) == jstream.fragment_due(r, f)
    for mode in ("blocking", "overlap", "stream"):
        for f in (0, 1, 3, 8):
            assert tstream.effective_fragments(mode, f) == jstream.effective_fragments(mode, f)
            assert tstream.placement_parts(mode, f) == jstream.placement_parts(mode, f)
    with pytest.raises(ValueError):
        tstream.effective_fragments("async")
    for mode in ("blocking", "overlap", "stream"):
        for n in (2, 3):
            assert tstream.placement_parts(mode, 4, num_shards=n) == \
                jstream.placement_parts(mode, 4, num_shards=n)


def test_merge_corrected_is_bit_equal():
    from hypha_tpu_torch.executor.diloco import merge_update

    rng = np.random.default_rng(5)
    names = ("a", "b/c", "d")
    live, snap, upd = ({n: rng.standard_normal((3, 4)).astype(np.float32) for n in names}
                       for _ in range(3))
    jl, ja = jstream.merge_corrected(live, snap, upd)
    t = lambda d: {k: torch.from_numpy(v.copy()) for k, v in d.items()}  # noqa: E731
    tl, ta = tstream.merge_corrected(t(live), t(snap), t(upd))
    for n in names:
        np.testing.assert_array_equal(tl[n].numpy(), np.asarray(jl[n]))
        np.testing.assert_array_equal(ta[n].numpy(), np.asarray(ja[n]))
    # bf16 leaves: the update is cast to the leaf's dtype before the add.
    bl = {k: v.to(torch.bfloat16) for k, v in t(live).items()}
    tl, _ = tstream.merge_corrected(bl, bl, t(upd))
    assert all(tl[n].dtype == torch.bfloat16 for n in names)
    assert all(torch.equal(tl[n], merge_update({n: bl[n]}, {n: t(upd)[n]})[n]) for n in names)
    with pytest.raises(ValueError, match="fragment key mismatch"):
        tstream.merge_corrected(t(live), t(snap), {"a": t(upd)["a"]})


# ------------------------------------------------------------ the trainers


class _StreamSession:
    """A scheduler and a parameter server behind the bridge-client API,
    answering in ``msgs``' types. Each pushed delta (any wire format, read
    by the JAX package's ``read_delta``) gets an f32 Nesterov update (lr
    0.7, momentum 0.9) tagged like the push; the broadcast is held until
    ``hold`` more ``STATUS`` messages arrive, so ``hold`` steps run with
    the sync in flight."""

    def __init__(self, work_dir: Path, msgs, weights: Path, rounds=3, per_round=3, hold=0):
        self.dir, self.m, self.weights = Path(work_dir), msgs, weights
        self.rounds, self.per_round, self.hold = rounds, per_round, hold
        self.done = self.batches = self.fetches = 0
        self.scheduled = False
        self.events: "queue.Queue[dict]" = queue.Queue()
        self.held: list = []  # [statuses still to wait, event]
        self.momentum: dict = {}
        self.pushes: list = []  # (meta, {name: f32 array}, frame tag)
        self.frames: list = []  # each push an HQD1 frame?
        self.lock = threading.Lock()
        rng = np.random.default_rng(42)
        starts = rng.integers(0, VOCAB, (4, 5, 1))
        self.slices = [((s + np.arange(SEQ)) % VOCAB).astype(np.int32) for s in starts]
        (self.dir / "artifacts").mkdir(parents=True, exist_ok=True)
        (self.dir / "incoming").mkdir(exist_ok=True)

    def fetch(self, ref):
        if ref.ref.uri == "file:///weights":
            return [str(self.weights.relative_to(self.dir))]
        with self.lock:
            i = self.fetches % len(self.slices)
            self.fetches += 1
        path = self.dir / "artifacts" / f"slice{self.fetches}.safetensors"
        save_file({"input_ids": self.slices[i]}, str(path))
        return [f"artifacts/{path.name}"]

    def send_status(self, progress):
        K, R, RK = self.m.ProgressKind, self.m.ProgressResponse, self.m.ProgressResponseKind
        with self.lock:
            if progress.kind == K.STATUS:
                for h in self.held:
                    h[0] -= 1
                for h in [h for h in self.held if h[0] <= 0]:
                    self.held.remove(h)
                    self.events.put(h[1])
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
        delta = {k: np.asarray(v, np.float32)
                 for k, v in jcomp.read_delta(self.dir / path).items()}
        with self.lock:
            self.pushes.append((meta, delta, jcomp.frame_tag(self.dir / path)))
            self.frames.append(jcomp.is_frame(self.dir / path))
            update = {}
            for k, g in delta.items():
                m = np.float32(0.9) * self.momentum.get(k, np.zeros_like(g)) + g
                self.momentum[k] = m
                update[k] = (np.float32(0.7) * (np.float32(0.9) * m + g)).astype(np.float32)
            out = self.dir / "incoming" / f"update-{len(self.pushes)}.safetensors"
            save_file(update, str(out))
            event = {"path": f"incoming/{out.name}",
                     "meta": {k: meta[k] for k in ("round", "fragment_id", "fragments")
                              if k in meta}}
            if self.hold:
                self.held.append([self.hold, event])
            else:
                self.events.put(event)

    @contextmanager
    def receive(self, ref):
        def gen():
            while True:
                try:
                    yield self.events.get(timeout=30)
                except queue.Empty:
                    return

        yield gen()


def _spec(m, **overrides):
    cfg = m.TrainExecutorConfig(
        model={"model_type": "causal-lm", "family": "llama", "preset": "tiny",
               "config": {"dtype": "float32", "num_layers": 2},
               "source": m.to_json_dict(m.Fetch(m.Reference.from_uri("file:///weights")))},
        data=m.Fetch(m.Reference.from_uri("file:///slices")),
        updates=m.Send(m.Reference.from_peers(["ps"], "updates")),
        results=m.Receive(m.Reference.from_peers(["ps"], "results")),
        optimizer=m.Adam(lr=LR, weight_decay=0.01),
        batch_size=2,
        **overrides,
    )
    return m.JobSpec(job_id="job", executor=m.Executor("train", "diloco-transformer", train=cfg))


@pytest.fixture
def weights(tmp_path):
    _, variables, _ = tiny_pair("llama", seed=7, num_layers=2)
    path = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(path))
    return path


def _run(pkg: str, work: Path, weights: Path, *, hold=0, **over):
    work.mkdir()
    wpath = work / weights.name
    wpath.write_bytes(weights.read_bytes())
    if pkg == "jax":
        from hypha_tpu.executor.training import run_training

        session = _StreamSession(work, jmsg, wpath, hold=hold)
        result = run_training(session, work, _spec(jmsg, **over))
    else:
        from hypha_tpu_torch.executor.training import run_training

        session = _StreamSession(work, tmsg, wpath, hold=hold)
        result = run_training(session, work, _spec(tmsg, **over), device="cpu")
    assert not list((work / "incoming").iterdir()), "every broadcast was merged and removed"
    return result, session


def _close(got: np.ndarray, ref: np.ndarray, steps: float, first: bool) -> bool:
    """Δθ agreement: every element within 0.05 x lr (tests/test_torch_training.py)
    plus ``steps`` (the codec's rounding) before the first merge. After a
    quantized merge the two trajectories differ by a quantization step,
    which Adam turns into a whole step of either sign on elements whose
    gradient is near zero: then 99% of the elements keep that bound and
    every one stays within 3 steps x 2 x lr x 3.2 (Adam's largest normalized
    step at betas 0.9/0.999, in either direction)."""
    diff = np.abs(got - ref)
    tight = diff <= 0.05 * LR + steps
    if first or not steps:
        return bool(tight.all())
    return bool(tight.mean() >= 0.99 and diff.max() <= 3 * 2 * LR * 3.2)


@pytest.mark.parametrize("over,hold", [
    ({"sync_mode": "overlap"}, 0),
    ({"sync_mode": "stream", "fragments": 2}, 0),
    ({"sync_mode": "stream", "fragments": 2, "delta_codec": "int8"}, 1),
], ids=["overlap", "stream", "stream-int8-drift"])
def test_run_training_stream_matches_jax(tmp_path, weights, monkeypatch, over, hold):
    # The loop waits up to 2 s for a landed broadcast before each step, so
    # each flight spans exactly ``hold`` steps in both trainers. The JAX
    # flight quantizes on its numpy path: its C++ library would be compiled
    # inside the first flight, which could outlast the wait.
    monkeypatch.setenv("HYPHA_STREAM_POLL_WAIT", "2")
    monkeypatch.setattr(native, "_load", lambda: None)
    jres, js = _run("jax", tmp_path / "jax", weights, hold=hold, **over)
    pres, ps = _run("port", tmp_path / "port", weights, hold=hold, **over)
    # Each round: 3 steps, then ``hold`` more with its sync in flight.
    assert pres.rounds == jres.rounds == 3 and pres.batches == jres.batches == 3 * (3 + hold)
    np.testing.assert_allclose(pres.losses, jres.losses, atol=1e-4, rtol=0)
    F = 2 if over["sync_mode"] == "stream" else 1
    names = set(flatten_tree(tiny_pair("llama", seed=7, num_layers=2)[1]))
    assert len(js.pushes) == len(ps.pushes) == 3
    for r, ((jm, jd, jtag), (pm, pd, ptag)) in enumerate(zip(js.pushes, ps.pushes)):
        assert pm == jm and pm["round"] == r and pm["fragment_id"] == r % F
        assert pm["fragments"] == F
        assert ptag == jtag and (ptag is None) == ("delta_codec" not in over)
        assert set(pd) == set(jd)
        # int8 adds at most two quantization steps (a rounding that flips,
        # and the error-feedback residual carrying one): ``_close``.
        steps = 0.0
        if "delta_codec" in over:
            steps = 2 * max(np.abs(v).max() for v in jd.values()) / 127
        for n, ref in jd.items():
            assert pd[n].shape == ref.shape, n
            assert _close(pd[n], ref, steps, first=r == 0), (r, n)
    frags = [set(d) for _, d, _ in ps.pushes]
    if F == 2:
        assert frags[0] == frags[2] and frags[0].isdisjoint(frags[1])
        assert frags[0] | frags[1] == names
    else:
        assert all(f == names for f in frags)


@pytest.mark.parametrize("over", [{"delta_codec": "int8"}, {"delta_codec": "int4"},
                                  {"delta_dtype": "bfloat16"}], ids=["int8", "int4", "bf16"])
def test_run_training_blocking_codecs_match_jax(tmp_path, weights, monkeypatch, over):
    """The blocking path with a wire codec: the same files' formats and
    tags, Δθ within the trainer tolerance plus two quantization steps."""
    monkeypatch.setattr(native, "_load", lambda: None)
    jres, js = _run("jax", tmp_path / "jax", weights, **over)
    pres, ps = _run("port", tmp_path / "port", weights, **over)
    assert pres.rounds == jres.rounds == 3 and pres.batches == jres.batches == 9
    np.testing.assert_allclose(pres.losses, jres.losses, atol=1e-4, rtol=0)
    qmax = {"int8": 127, "int4": 7}.get(over.get("delta_codec"))
    assert ps.frames == js.frames == [qmax is not None] * 3
    for r, ((jm, jd, jtag), (pm, pd, ptag)) in enumerate(zip(js.pushes, ps.pushes)):
        assert pm == jm and pm["round"] == r and ptag is jtag is None
        assert set(pd) == set(jd)
        # Two quantization steps of int8 / int4, or bf16's rounding of each
        # element to 8 mantissa bits.
        top = max(np.abs(v).max() for v in jd.values())
        steps = 2 * top / qmax if qmax else top * 2 ** -8
        for n, ref in jd.items():
            assert pd[n].shape == ref.shape, n
            assert _close(pd[n], ref, steps, first=r == 0), (r, n)


def test_overlap_with_zero_flight_equals_blocking_bit_for_bit(tmp_path, weights, monkeypatch):
    monkeypatch.setenv("HYPHA_STREAM_POLL_WAIT", "30")
    bres, bs = _run("port", tmp_path / "blocking", weights, sync_mode="blocking")
    ores, os_ = _run("port", tmp_path / "overlap", weights, sync_mode="overlap")
    assert bres.rounds == ores.rounds == 3 and bres.batches == ores.batches
    assert bres.losses == ores.losses
    for (bm, bd, _), (om, od, _) in zip(bs.pushes, os_.pushes):
        assert om == {**bm, "fragment_id": 0, "fragments": 1}
        assert set(bd) == set(od)
        for n in bd:
            np.testing.assert_array_equal(od[n], bd[n])


# ------------------------------------------------------- the parameter server

WORKERS = ("w0", "w1")
SAMPLES = {"w0": 6.0, "w1": 10.0}
SHAPES = {"params/embed_tokens": (96, 16), "params/layers_0/self_attn/q_proj/kernel": (16, 16),
          "params/norm/weight": (16,), "params/layers_0/mlp/down_proj/kernel": (3, 5, 7),
          "params/layers_1/mlp/up_proj/kernel": (16, 40)}
F, ROUNDS = 2, 4


def _frames(root: Path, codec: str) -> list:
    """The pushes of two JAX trainers over ``ROUNDS`` stream rounds: (peer,
    header, file). w1 ships round 2 before w0 ships round 1 (a delta for a
    round not yet open); in round 3 a relabeled frame (header round 3, frame
    round 1) and a push naming the wrong fragment precede w0's real one."""
    parts = jstream.partition_names({n: int(np.prod(s)) for n, s in SHAPES.items()}, F)
    rng = np.random.default_rng(11)
    efs = {(w, f): jcomp.ErrorFeedback() for w in WORKERS for f in range(F)}
    made = {}
    for r in range(ROUNDS):
        f = jstream.fragment_due(r, F)
        for w in WORKERS:
            flat = {n: (rng.standard_normal(SHAPES[n]) * 10 ** rng.uniform(-4, 0)).astype(np.float32)
                    for n in parts[f]}
            tag = jmsg.FragmentTag(round=r, fragment_id=f, fragments=F).header()
            path = root / f"delta-{w}-{r}"
            jcomp.write_delta(path, flat, codec, ef=efs[(w, f)], tag=tag)
            made[(w, r)] = ({"num_samples": SAMPLES[w], **tag}, path)
    order = [("w0", 0), ("w1", 0), ("w1", 1), ("w1", 2), ("w0", 1), ("w0", 2), ("w1", 3)]
    pushes = [(w, *made[(w, r)]) for w, r in order]
    bad_tag = {"num_samples": 6.0, **jmsg.FragmentTag(round=3, fragment_id=1, fragments=F).header()}
    pushes.append(("w0", bad_tag, made[("w0", 1)][1]))  # a relabeled round-1 frame
    wrong = {"num_samples": 6.0, **jmsg.FragmentTag(round=3, fragment_id=0, fragments=F).header()}
    pushes.append(("w0", wrong, made[("w0", 3)][1]))  # round 3 is fragment 1's
    pushes.append(("w0", *made[("w0", 3)]))
    return pushes


async def _serve_stream(pkg: str, root: Path, pushes: list, codec: str) -> tuple:
    from hypha_tpu.network import Node as JNode
    from hypha_tpu.network import TcpTransport as JTcp
    from hypha_tpu.worker.ps_executor import ParameterServerExecutor as JPS
    from hypha_tpu_torch.network import Node as TNode
    from hypha_tpu_torch.network import TcpTransport as TTcp
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as TPS

    m, Node, Tcp, PS = {"jax": (jmsg, JNode, JTcp, JPS), "port": (tmsg, TNode, TTcp, TPS)}[pkg]
    nodes = {p: Node(Tcp(), peer_id=p) for p in ("ps", "sched", *WORKERS)}
    for n in nodes.values():
        await n.start(["127.0.0.1:0"])
    for x in nodes.values():
        for y in nodes.values():
            if x is not y:
                x.add_peer_addr(y.peer_id, y.listen_addrs[0])
    updated: list = []

    async def on_progress(peer, p):
        updated.append((peer, p.kind.value, p.round, p.job_id))
        last = p.round >= ROUNDS - 1
        return m.ProgressResponse(kind=m.ProgressResponseKind.DONE if last else m.ProgressResponseKind.OK)

    nodes["sched"].on(m.PROTOCOL_PROGRESS, m.Progress).respond_with(on_progress)
    spec = m.JobSpec(job_id="agg", executor=m.Executor(
        kind="aggregate", name="parameter-server", aggregate=m.AggregateExecutorConfig(
            updates=m.Receive(m.Reference.from_peers(list(WORKERS), "updates")),
            results=m.Send(m.Reference.from_peers(list(WORKERS), "results")),
            optimizer=m.Nesterov(lr=0.7, momentum=0.9), num_workers=len(WORKERS),
            delta_codec=codec, sync_mode="stream", fragments=F)))
    ps = PS(nodes["ps"], root / "ps", **({"device": "cpu"} if pkg == "port" else {}))
    execution = await ps.execute("agg", spec, "sched")
    consumers = {w: nodes[w].consume_pushes(lambda push: push.resource.get("resource") == "results")
                 for w in WORKERS}
    for w, meta, path in pushes:
        await nodes[w].push("ps", {"resource": "updates", "name": path.name, **meta}, path)
    got: dict = {}
    for w in WORKERS:
        for _ in range(ROUNDS):
            push = await consumers[w].next(timeout=30)
            dest = root / f"{pkg}-{w}-{push.resource['round']}"
            await push.save_to(dest)
            got[(w, push.resource["round"])] = (dict(push.resource), dest.read_bytes())
    status = await asyncio.wait_for(execution.wait(), 30)
    for n in nodes.values():
        await n.stop()
    return got, updated, status


@pytest.mark.parametrize("codec", ["int8", "int4", "none"])
def test_ps_stream_rounds_match_jax(tmp_path, monkeypatch, codec):
    monkeypatch.setattr(native, "_load", lambda: None)
    pushes = _frames(tmp_path, codec)
    out = {}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        out[pkg] = asyncio.run(asyncio.wait_for(
            _serve_stream(pkg, tmp_path / pkg, pushes, codec), 90))
    (jgot, jupd, jstat), (pgot, pupd, pstat) = out["jax"], out["port"]
    assert jstat.state == pstat.state == "completed"
    assert pupd == jupd == [("ps", "updated", r, "agg") for r in range(ROUNDS)]
    assert set(pgot) == set(jgot) == {(w, r) for w in WORKERS for r in range(ROUNDS)}
    parts = jstream.partition_names({n: int(np.prod(s)) for n, s in SHAPES.items()}, F)
    for key, (jhead, jbytes) in jgot.items():
        phead, pbytes = pgot[key]
        r = key[1]
        assert phead == jhead and phead["fragment_id"] == r % F and phead["fragments"] == F
        # The whole broadcast file, byte for byte: the frame (or f32
        # SafeTensors) of the same update, with the same residual.
        if codec == "none":
            a = jcomp.read_delta(tmp_path / "jax" / f"jax-{key[0]}-{r}")
            b = jcomp.read_delta(tmp_path / "port" / f"port-{key[0]}-{r}")
            assert set(a) == set(b) == set(parts[r % F])
            for n in a:
                np.testing.assert_array_equal(a[n], b[n])
        else:
            assert pbytes == jbytes, key
            assert tcomp.frame_tag(tmp_path / "port" / f"port-{key[0]}-{r}") == {
                "round": r, "fragment_id": r % F, "fragments": F}


def test_frame_tag_check_drops_a_relabeled_frame(tmp_path):
    from hypha_tpu.worker.ps_executor import ParameterServerExecutor as JPS
    from hypha_tpu_torch.worker.ps_executor import ParameterServerExecutor as TPS

    path = tmp_path / "relabel.bin"
    tcomp.write_delta(path, {"w": torch.ones(8)}, "int8",
                      tag={"round": 0, "fragment_id": 0, "fragments": 1})
    plain = tmp_path / "plain.bin"
    tcomp.write_delta(plain, {"w": torch.ones(8)}, "none")
    for PS, m in ((JPS, jmsg), (TPS, tmsg)):
        assert PS._frame_tag_matches(path, m.FragmentTag(round=0, fragment_id=0, fragments=1))
        assert not PS._frame_tag_matches(path, m.FragmentTag(round=1, fragment_id=0, fragments=1))
        assert not PS._frame_tag_matches(path, m.FragmentTag(round=0, fragment_id=1, fragments=2))
        assert PS._frame_tag_matches(plain, m.FragmentTag(round=5, fragment_id=1, fragments=2))
