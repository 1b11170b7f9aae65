"""Port parity: ``run_training``. The JAX package's trainer and the port's,
each behind the same fake bridge session (a deterministic scheduler plus a
parameter server running the Nesterov outer step in numpy, the
tests/test_data_pipeline.py harness), on the same slices, from the same θ₀
(one SafeTensors ``source`` file in native flat names), for 2 rounds of a
tiny f32 Llama. Per-batch losses agree, the Δθ files hold the same names,
shapes and dtypes with close values, and every option the port has not
ported raises NotImplementedError. A LoRA job from an HF-named source
trains and ships the adapters alone, under the JAX package's names, and
resumes its adapters and their moments from a checkpoint."""

from __future__ import annotations

import queue
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
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


def test_relay_results_trains_as_the_reference(tmp_path, weights):
    """``relay_results`` (refused until the broadcast tree was ported) asks
    the worker runtime for a relay beside the trainer; the trainer itself
    runs as without it, as the reference's does: the same rounds, losses
    within the parity bound and the same Δθ names."""
    from hypha_tpu.executor.training import run_training as jax_run
    from hypha_tpu_torch.executor.training import run_training as port_run

    spec = _spec(relay_results=True)
    js = _Session(tmp_path, jmsg, weights)
    jres = jax_run(js, tmp_path, spec)
    ps = _Session(tmp_path, tmsg, weights)
    pres = port_run(ps, tmp_path, _port_spec(spec), device="cpu")
    assert _port_spec(spec).executor.train.relay_results is True
    assert (pres.rounds, pres.batches) == (jres.rounds, jres.batches) == (2, 6)
    np.testing.assert_allclose(pres.losses, jres.losses, atol=1e-4, rtol=0)
    assert [sorted(d) for d in ps.deltas] == [sorted(d) for d in js.deltas]


@pytest.mark.parametrize("option", [
    {"sharding": {"dp": 2}},
    {"sharding": {"fsdp": 2}},
    # checkpoint and rejoin run in every sync mode and placement
    # (tests/test_torch_shard_ft.py::test_lifted_trainer_option_runs);
    # relay_results runs (test_relay_results_trains_as_the_reference);
    # input_pipeline and preprocessor run (tests/test_torch_data_pipeline.py,
    # tests/test_torch_preprocess.py).
    {"sharding": {"tp": 2}},
    {"sharding": {"sp": 2}},
    # report_metrics_s runs (tests/test_torch_metrics_plane.py).
    {"sharding": {"ep": 2}},
    {"model": "gpt2"},
])
def test_unported_options_raise(tmp_path, weights, option):
    from hypha_tpu_torch.executor.training import run_training

    if option.get("model"):
        option = {"model": {"model_type": "causal-lm", "family": "gpt2"}}
    spec = _port_spec(_spec(**option))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_training(_Session(tmp_path, tmsg, weights), tmp_path, spec, device="cpu")


LORA = {"rank": 4, "alpha": 8.0, "targets": ["q_proj", "k_proj", "v_proj", "o_proj"]}


@pytest.fixture
def hf_weights(tmp_path):
    """The ``weights`` fixture's θ₀ in HF names (a ``save_pretrained``
    layout), written by the port's writer."""
    from hypha_tpu_torch.executor.serialization import save_file as tsave
    from hypha_tpu_torch.models.convert import hf_state_dict

    _, _, tm = tiny_pair("llama", seed=7)
    path = tmp_path / "model.safetensors"
    tsave(hf_state_dict(tm.state_dict()), path)
    return path


def _captured(monkeypatch):
    """The port trainer's model, captured as ``run_training`` builds it."""
    import hypha_tpu_torch.executor.training as training

    built: list = []
    build = training.build_model

    def capture(spec, device=None, attn_impl=None):
        model, cfg = build(spec, device=device, attn_impl=attn_impl)
        built.append(model)
        return model, cfg

    monkeypatch.setattr(training, "build_model", capture)
    return built


def test_lora_job_from_an_hf_source_matches_jax(tmp_path, hf_weights, weights, monkeypatch):
    """Both trainers on the same HF-named source with ``lora``: the same
    rounds and batches, the first loss within 1e-5 (``B`` = 0: the base's
    output; the two packages draw other ``A``, so later losses differ, and
    mixed jobs wait for a shared θ₀), every Δθ holding exactly the 16
    adapters under the names of the JAX trainer's, f32 and of its shapes,
    and the port's base bit-equal to the checkpoint's after training."""
    from hypha_tpu.executor.training import run_training as jax_run
    from hypha_tpu_torch.executor.training import run_training as port_run
    from hypha_tpu_torch.models.convert import base_names

    spec = _spec(lora=LORA)
    js = _Session(tmp_path, jmsg, hf_weights)
    jres = jax_run(js, tmp_path, spec)
    built = _captured(monkeypatch)
    ps = _Session(tmp_path, tmsg, hf_weights)
    pres = port_run(ps, tmp_path, _port_spec(spec), device="cpu")
    assert (pres.rounds, pres.batches) == (jres.rounds, jres.batches) == (2, 6)
    np.testing.assert_allclose(pres.losses[0], jres.losses[0], atol=1e-5, rtol=0)
    assert all(np.isfinite(pres.losses))
    assert len(js.deltas) == len(ps.deltas) == 2
    for jd, pd in zip(js.deltas, ps.deltas):
        assert len(pd) == 16 and set(pd) == set(jd)
        assert all("_lora_" in n for n in pd)
        for name, ref in jd.items():
            assert pd[name].dtype == ref.dtype == np.float32 and pd[name].shape == ref.shape
    model = built[0]
    theta0 = load_file(str(weights))
    state = model.state_dict()
    for name in base_names(model):
        assert not state[name].requires_grad
    from hypha_tpu_torch.models.convert import state_to_flat

    flat = state_to_flat(model, {n: state[n] for n in base_names(model)})
    assert set(flat) == set(theta0)
    for name, t in flat.items():
        np.testing.assert_array_equal(t.numpy(), theta0[name], err_msg=name)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_lora_without_adapters_raises(tmp_path, weights, package):
    """``lora`` whose rank leaves the model no adapter: the reference's
    ValueError, in both packages."""
    from hypha_tpu.executor.training import run_training as jax_run
    from hypha_tpu_torch.executor.training import run_training as port_run

    spec = _spec(lora={"rank": 0})
    with pytest.raises(ValueError, match="produced no adapters"):
        if package == "jax":
            jax_run(_Session(tmp_path, jmsg, weights), tmp_path, spec)
        else:
            port_run(_Session(tmp_path, tmsg, weights), tmp_path, _port_spec(spec), device="cpu")


def test_lora_checkpoint_resumes_the_adapters_and_their_moments(tmp_path, hf_weights,
                                                                monkeypatch):
    """A LoRA trainer checkpoints its adapters and their AdamW moments
    only (bf16 ``mu`` off: f32), under the wire's names; a second trainer
    on the same directory resumes them bit for bit, the base from the
    source again, and counts rounds on."""
    from hypha_tpu_torch.executor.checkpoint import latest_manifest
    from hypha_tpu_torch.executor.serialization import load_file as tload
    from hypha_tpu_torch.executor.training import run_training as port_run
    from hypha_tpu_torch.models.convert import state_to_flat

    ckpt = tmp_path / "ckpt"
    spec = _spec(lora=LORA, checkpoint={"dir": str(ckpt), "every_rounds": 1})
    built = _captured(monkeypatch)
    port_run(_Session(tmp_path, tmsg, hf_weights), tmp_path, _port_spec(spec), device="cpu")
    manifest = latest_manifest(ckpt)
    assert (manifest["round"], manifest["step"]) == (2, 6)
    version = ckpt / (ckpt / "LATEST").read_text().strip()
    params, opt = tload(version / "params.safetensors"), tload(version / "opt_state.safetensors")
    first = built[0]
    adapters = {n: p for n, p in first.state_dict().items() if "_lora_" in n}
    want = state_to_flat(first, adapters)
    assert set(params) == set(want) and len(params) == 16
    for name, t in want.items():
        assert torch.equal(params[name], t.contiguous()), name
    assert set(opt) == {"count"} | {f"{k}/{n}" for k in ("mu", "nu") for n in want}
    assert int(opt["count"]) == 6
    # The second trainer: what it holds right after the restore.
    resumed: dict = {}
    import hypha_tpu_torch.executor.training as training

    real = training.restore_train_state

    def restore(model, optimizer, p, o):
        real(model, optimizer, p, o)
        resumed["params"] = {k: v.clone() for k, v in model.state_dict().items()}
        resumed["mu"] = [m.clone() for m in optimizer.mu]
        resumed["nu"] = [v.clone() for v in optimizer.nu]
        resumed["count"] = optimizer.count

    monkeypatch.setattr(training, "restore_train_state", restore)
    port_run(_Session(tmp_path, tmsg, hf_weights, rounds=1), tmp_path, _port_spec(spec),
             device="cpu")
    second = built[1]
    got = state_to_flat(second, {n: resumed["params"][n] for n in adapters})
    for name, t in got.items():
        assert torch.equal(t, params[name]), name
    base = {n: t for n, t in resumed["params"].items() if "_lora_" not in n}
    for name, t in base.items():
        assert torch.equal(t, first.state_dict()[name]), name
    assert resumed["count"] == 6
    for key in ("mu", "nu"):  # the optimizer's moments, in its (state_dict) order
        flat = state_to_flat(second, dict(zip(adapters, resumed[key])))
        for name, t in flat.items():
            assert torch.equal(t, opt[f"{key}/{name}"]), (key, name)
    assert latest_manifest(ckpt)["round"] == 3
