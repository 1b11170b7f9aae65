"""Port parity: ``run_training``. The JAX package's trainer and the port's,
each behind the same fake bridge session (a deterministic scheduler plus a
parameter server running the Nesterov outer step in numpy, the
tests/test_data_pipeline.py harness), on the same slices, from the same θ₀
(one SafeTensors ``source`` file in native flat names), for 2 rounds of a
tiny f32 Llama. Per-batch losses agree, the Δθ files hold the same names,
shapes and dtypes with close values, and every option the port has not
ported raises NotImplementedError."""

from __future__ import annotations

import queue
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
from safetensors.numpy import load_file, save_file

from _torch_parity import tiny_pair
from hypha_tpu import messages as jmsg
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu_torch import messages as tmsg

SEQ, VOCAB, LR = 16, 256, 3e-3


class _Session:
    """Scheduler + parameter server behind the bridge-client API, answering
    with the given package's message types."""

    def __init__(self, work_dir: Path, msgs, weights: Path, rounds=2, per_round=3):
        self.dir, self.m, self.weights = Path(work_dir), msgs, weights
        self.rounds, self.per_round = rounds, per_round
        self.done = self.batches = self.fetches = 0
        self.scheduled = False
        self.events: "queue.Queue[dict]" = queue.Queue()
        self.momentum: dict = {}
        self.deltas: list = []
        rng = np.random.default_rng(42)
        starts = rng.integers(0, VOCAB, (4, 5, 1))
        self.slices = [((s + np.arange(SEQ)) % VOCAB).astype(np.int32) for s in starts]
        (self.dir / "artifacts").mkdir(parents=True, exist_ok=True)

    def fetch(self, ref):
        if ref.ref.uri == "file:///weights":
            return [str(self.weights.relative_to(self.dir))]
        i = self.fetches % len(self.slices)
        self.fetches += 1
        path = self.dir / "artifacts" / f"slice{self.fetches}.safetensors"
        save_file({"input_ids": self.slices[i]}, str(path))
        return [f"artifacts/{path.name}"]

    def send_status(self, progress):
        K, R, RK = self.m.ProgressKind, self.m.ProgressResponse, self.m.ProgressResponseKind
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
        delta = dict(load_file(str(self.dir / path)))
        self.deltas.append(delta)
        update = {}
        for k, g in delta.items():  # Nesterov, lr 0.7, momentum 0.9
            m = 0.9 * self.momentum.get(k, np.zeros_like(g)) + g
            self.momentum[k] = m
            update[k] = (0.7 * (0.9 * m + g)).astype(np.float32)
        (self.dir / "incoming").mkdir(exist_ok=True)
        out = self.dir / "incoming" / f"update-{meta['round']}.safetensors"
        save_file(update, str(out))
        self.events.put({"path": f"incoming/{out.name}", "meta": {"round": meta["round"]}})

    @contextmanager
    def receive(self, ref):
        def gen():
            while True:
                try:
                    yield self.events.get(timeout=30)
                except queue.Empty:
                    return

        yield gen()


def _spec(model=None, **overrides):
    cfg = jmsg.TrainExecutorConfig(
        model=model or {
            "model_type": "causal-lm", "family": "llama", "preset": "tiny",
            "config": {"dtype": "float32"},
            "source": jmsg.to_json_dict(jmsg.Fetch(jmsg.Reference.from_uri("file:///weights"))),
        },
        data=jmsg.Fetch(jmsg.Reference.from_uri("file:///slices")),
        updates=jmsg.Send(jmsg.Reference.from_peers(["ps"], "updates")),
        results=jmsg.Receive(jmsg.Reference.from_peers(["ps"], "results")),
        optimizer=jmsg.Adam(lr=LR, weight_decay=0.01),
        batch_size=2,
        **overrides,
    )
    return jmsg.JobSpec(job_id="job", executor=jmsg.Executor("train", "diloco-transformer", train=cfg))


def _port_spec(spec):
    return tmsg.from_json_dict(jmsg.to_json_dict(spec))


@pytest.fixture
def weights(tmp_path):
    _, variables, _ = tiny_pair("llama", seed=7)
    path = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(path))
    return path


def test_run_training_matches_jax(tmp_path, weights):
    from hypha_tpu.executor.training import run_training as jax_run
    from hypha_tpu_torch.executor.training import run_training as port_run

    spec = _spec()
    js = _Session(tmp_path, jmsg, weights)
    jres = jax_run(js, tmp_path, spec)
    ps = _Session(tmp_path, tmsg, weights)
    pres = port_run(ps, tmp_path, _port_spec(spec), device="cpu")

    assert (pres.rounds, pres.batches) == (jres.rounds, jres.batches) == (2, 6)
    # f32 on the host both ways, summed in another order; the outer update
    # (lr 0.7) carries round 0's differences into round 1: within 1e-4.
    np.testing.assert_allclose(pres.losses, jres.losses, atol=1e-4, rtol=0)
    assert len(js.deltas) == len(ps.deltas) == 2
    for jd, pd in zip(js.deltas, ps.deltas):
        assert list(pd) and set(pd) == set(jd)
        for name, ref in jd.items():
            got = pd[name]
            assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape, name
            # Each Δθ element is a sum of Adam steps of about lr each;
            # elements whose gradient is near Adam's eps amplify rounding
            # (tests/test_torch_train.py): within 0.05 * lr.
            assert np.abs(got - ref).max() <= 0.05 * LR, name
    # The merged update files were consumed and removed by both trainers.
    assert not list((tmp_path / "incoming").glob("*.safetensors"))


@pytest.mark.parametrize("option", [
    {"sharding": {"dp": 2}},
    {"lora": {"rank": 4}},
    {"checkpoint": {"dir": "ckpt"}},
    {"rejoin": True},
    {"reduce_via": "reducer"},
    {"ps_shards": "shards"},
    {"reduce_members": ["w1"]},
    {"relay_results": True},
    {"input_pipeline": True},
    {"preprocessor": {"kind": "tokenizer"}},
    {"report_metrics_s": 1.0},
    {"model": "gpt2"},
])
def test_unported_options_raise(tmp_path, weights, option):
    from hypha_tpu_torch.executor.training import run_training

    if option.get("ps_shards"):
        option = {"ps_shards": jmsg.ShardMap(shards=["ps0", "ps1"], tags=["u0", "u1"])}
    if option.get("model"):
        option = {"model": {"model_type": "causal-lm", "family": "gpt2"}}
    spec = _port_spec(_spec(**option))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_training(_Session(tmp_path, tmsg, weights), tmp_path, spec, device="cpu")
