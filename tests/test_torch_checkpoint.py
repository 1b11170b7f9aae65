"""Port parity: trainer checkpoints (``hypha_tpu_torch/executor/checkpoint.py``
against ``hypha_tpu/executor/checkpoint.py``) and resume.

1. The same saves in both packages leave the same tree: version dirs
   ``v{round:08d}-{step}``, the same three files in each, equal manifests,
   the ``LATEST`` pointer, the two newest versions kept.
2. A save that fails while staging leaves the previous checkpoint whole and
   no staging dir, in both packages.
3. The reference's ``load_flat`` reads the port's ``params.safetensors``:
   the wire's flat names, the reference's orientation, the model's values.
4. A trainer resumed from the checkpoint of round 1 ships a round-2 Δθ
   within the training parity bound (0.05 x the inner lr) of an
   uninterrupted run's, in each package (the same fake scheduler and
   parameter server, the same slices; the port's is bit-equal).
5. A property of the reference, pinned in both packages: a rejoiner
   dispatched with a checkpoint dir that already holds its own checkpoint
   restores it and then adds the whole catch-up Σ on top (θ = θ_k + Σ,
   not θ₀ + Σ): Σ up to round k counts twice.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from _torch_parity import tiny_pair
from hypha_tpu import messages as jmsg
from hypha_tpu.executor import checkpoint as jckpt
from hypha_tpu.executor.serialization import flatten_tree, load_flat
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor import checkpoint as tckpt
from test_torch_training import LR, SEQ, VOCAB, _port_spec, _Session, _spec

SAVES = [(1, 4), (2, 8), (3, 12), (3, 12)]  # (round, step); the last re-saves round 3


def _trees(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    params = {"params/a/kernel": rng.standard_normal((4, 3)).astype(np.float32),
              "params/norm": rng.standard_normal(3).astype(np.float32)}
    opt = {"count": np.array(seed, np.int64),
           "mu/params/a/kernel": rng.standard_normal((4, 3)).astype(np.float32)}
    return params, opt


def _listing(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_layout_manifest_and_pruning_match_the_reference(tmp_path):
    for pkg, mod in (("jax", jckpt), ("port", tckpt)):
        for i, (rnd, step) in enumerate(SAVES):
            params, opt = _trees(i)
            if pkg == "port":
                params = {k: torch.from_numpy(v) for k, v in params.items()}
                opt = {k: torch.from_numpy(v) for k, v in opt.items()}
            mod.save_train_checkpoint(tmp_path / pkg, params, opt, step, rnd,
                                      extra={"peer": "w0"})
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax") == [
        "LATEST", "v00000002-8", "v00000002-8/manifest.json", "v00000002-8/opt_state.safetensors",
        "v00000002-8/params.safetensors", "v00000003-12", "v00000003-12/manifest.json",
        "v00000003-12/opt_state.safetensors", "v00000003-12/params.safetensors"]
    for name in ("LATEST", "v00000003-12/manifest.json", "v00000002-8/manifest.json"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert tckpt.latest_manifest(tmp_path / "port") == jckpt.latest_manifest(tmp_path / "jax") \
        == {"version": 1, "step": 12, "round": 3, "extra": {"peer": "w0"}}
    # The newest save's tensors, read back by the other package's reader.
    params, _ = _trees(len(SAVES) - 1)
    back = load_file(str(tmp_path / "port" / "v00000003-12" / "params.safetensors"))
    assert all(back[k].tobytes() == v.tobytes() for k, v in params.items())
    assert tckpt.latest_manifest(tmp_path / "none") is None
    assert tckpt.load_train_checkpoint(tmp_path / "none", {}, {}) is None


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_crash_while_staging_keeps_the_previous_checkpoint(tmp_path, pkg, monkeypatch):
    mod = jckpt if pkg == "jax" else tckpt
    params, opt = _trees(0)
    if pkg == "port":
        params = {k: torch.from_numpy(v) for k, v in params.items()}
        opt = {k: torch.from_numpy(v) for k, v in opt.items()}
    mod.save_train_checkpoint(tmp_path, params, opt, 4, 1)
    writer = "save_tree" if pkg == "jax" else "save_file"
    real = getattr(mod, writer)

    def crash(*args, **kwargs):  # save_tree(path, tree) / save_file(tensors, path)
        if any(isinstance(a, Path) and a.name == "opt_state.safetensors" for a in args):
            raise OSError("disk vanished")
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, writer, crash)
    with pytest.raises(OSError, match="disk vanished"):
        mod.save_train_checkpoint(tmp_path, params, opt, 8, 2)
    assert _listing(tmp_path) == ["LATEST", "v00000001-4", "v00000001-4/manifest.json",
                                  "v00000001-4/opt_state.safetensors",
                                  "v00000001-4/params.safetensors"]
    assert mod.latest_manifest(tmp_path)["round"] == 1


def test_a_bad_checkpoint_fails_loudly(tmp_path):
    params, opt = _trees(0)
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    opt = {k: torch.from_numpy(v) for k, v in opt.items()}
    tckpt.save_train_checkpoint(tmp_path, params, opt, 4, 1)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_train_checkpoint(tmp_path, {**params, "params/norm": torch.zeros(5)}, opt)
    with pytest.raises(ValueError, match="names differ"):
        tckpt.load_train_checkpoint(tmp_path, {"params/other": torch.zeros(3)}, opt)
    (tmp_path / "LATEST").write_text("v00000009-1")
    with pytest.raises(ValueError, match="missing"):
        tckpt.load_train_checkpoint(tmp_path, params, opt)


def test_the_reference_reads_the_ports_params(tmp_path):
    from hypha_tpu_torch.executor.train import build_optimizer
    from hypha_tpu_torch.models.convert import llama_params_to_flat

    _, jvars, tm = tiny_pair("llama", seed=3)
    opt = build_optimizer(list(tm.parameters()), tmsg.Adam(lr=1e-3))
    version = tckpt.save_train_checkpoint(tmp_path, *tckpt.train_state(tm, opt), 0, 1)
    got = load_flat(version / "params.safetensors")
    want = flatten_tree(jvars)
    assert sorted(got) == sorted(want)
    ours = llama_params_to_flat(tm)
    for name, value in got.items():
        assert value.shape == want[name].shape and value.tobytes() == ours[name].tobytes(), name
    # The port's own reader restores model and optimizer in place.
    _, _, tm2 = tiny_pair("llama", seed=4)
    opt2 = build_optimizer(list(tm2.parameters()), tmsg.Adam(lr=1e-3))
    opt.count = 7
    for m in opt.mu:
        m.fill_(0.25)
    tckpt.save_train_checkpoint(tmp_path, *tckpt.train_state(tm, opt), 7, 2)
    restored = tckpt.load_train_checkpoint(tmp_path, *tckpt.train_state(tm2, opt2))
    tckpt.restore_train_state(tm2, opt2, restored[0], restored[1])
    assert restored[2:4] == (7, 2) and opt2.count == 7
    assert all(torch.equal(a, b) for a, b in zip(tm.state_dict().values(),
                                                  tm2.state_dict().values()))
    assert all(torch.equal(a, b) for a, b in zip(opt.mu, opt2.mu))
    assert all(torch.equal(a, b) for a, b in zip(opt.nu, opt2.nu))


class _RoundSlices(_Session):
    """The training tests' scheduler and server, with slices of exactly one
    round's samples (3 batches of 2), so a resumed trainer's first slice is
    the one an uninterrupted trainer trains its second round on; and a
    catch-up event queued ahead of everything (``catchup``)."""

    def __init__(self, work_dir, msgs, weights, rounds, catchup=None):
        super().__init__(work_dir, msgs, weights, rounds=rounds, per_round=3)
        rng = np.random.default_rng(42)
        starts = rng.integers(0, VOCAB, (4, 6, 1))
        self.slices = [((s + np.arange(SEQ)) % VOCAB).astype(np.int32) for s in starts]
        if catchup is not None:
            self.events.put(catchup)


def _run(pkg: str, session, work_dir: Path, spec):
    if pkg == "jax":
        from hypha_tpu.executor.training import run_training

        return run_training(session, work_dir, spec)
    from hypha_tpu_torch.executor.training import run_training

    return run_training(session, work_dir, _port_spec(spec), device="cpu")


@pytest.fixture
def weights(tmp_path):
    _, variables, _ = tiny_pair("llama", seed=7)
    path = tmp_path / "theta0.safetensors"
    save_file(flatten_tree(variables), str(path))
    return path


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_resume_after_round_one_ships_round_twos_delta(tmp_path, weights, pkg):
    m = jmsg if pkg == "jax" else tmsg
    whole = _RoundSlices(tmp_path, m, weights, rounds=2)
    wres = _run(pkg, whole, tmp_path, _spec())
    ckpt = tmp_path / f"ckpt-{pkg}"
    spec = _spec(checkpoint={"dir": str(ckpt), "every_rounds": 1})
    parts = _RoundSlices(tmp_path, m, weights, rounds=1)
    first = _run(pkg, parts, tmp_path, spec)
    manifest = json.loads((ckpt / (ckpt / "LATEST").read_text() / "manifest.json").read_text())
    assert (first.rounds, manifest["round"], manifest["step"]) == (1, 1, 3)
    parts.rounds, parts.scheduled, parts.batches = 2, False, 0
    resumed = _run(pkg, parts, tmp_path, spec)
    assert resumed.rounds == 1 and len(parts.deltas) == len(whole.deltas) == 2
    assert (ckpt / "v00000002-6" / "manifest.json").is_file()  # rounds counted across resumes
    np.testing.assert_allclose(resumed.losses, wres.losses[3:], atol=1e-5, rtol=0)
    for name, want in whole.deltas[1].items():
        got = parts.deltas[1][name]
        assert np.abs(got - want).max() <= 0.05 * LR, name
        if pkg == "port":
            assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rejoin_with_its_own_checkpoint_counts_the_sum_twice(tmp_path, weights, pkg):
    """θ_k from a first round (lr 3e-3), then a rejoiner with the same
    checkpoint dir (lr 0, so its steps and the server's zero update leave
    θ alone): its next checkpoint holds θ_k + Σ, not θ₀ + Σ."""
    m = jmsg if pkg == "jax" else tmsg
    ckpt = tmp_path / "ckpt"
    _run(pkg, _RoundSlices(tmp_path, m, weights, rounds=1), tmp_path,
         _spec(checkpoint={"dir": str(ckpt), "every_rounds": 1}))
    theta_k = load_file(str(ckpt / "v00000001-3" / "params.safetensors"))
    theta_0 = load_file(str(weights))
    rng = np.random.default_rng(5)
    sigma = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
             for k, v in theta_0.items()}
    (tmp_path / "incoming").mkdir(exist_ok=True)
    save_file(sigma, str(tmp_path / "incoming" / "catchup.safetensors"))
    catchup = {"path": "incoming/catchup.safetensors",
               "meta": {"round": 1, "epoch": 2, "catchup": True}}
    spec = _spec(checkpoint={"dir": str(ckpt), "every_rounds": 1}, rejoin=True)
    spec.executor.train.optimizer = jmsg.Adam(lr=0.0)
    _run(pkg, _RoundSlices(tmp_path, m, weights, rounds=1, catchup=catchup), tmp_path, spec)
    got = load_file(str(ckpt / "v00000003-6" / "params.safetensors"))
    for name, s in sigma.items():
        twice = (theta_k[name] + s).astype(np.float32)
        assert np.array_equal(got[name], twice), name
    assert any(not np.array_equal(got[n], theta_0[n] + s) for n, s in sigma.items())
