"""Port parity: the φ-accrual failure detector (``hypha_tpu_torch/ft/
detector.py``, a copy of ``hypha_tpu/ft/detector.py``) gives the
reference's φ and verdicts for the same arrival times (the counterparts of
``tests/test_ft.py``'s detector cases), on seeded arrival sequences."""

from __future__ import annotations

import numpy as np
import pytest

from hypha_tpu.ft import detector as jdet
from hypha_tpu_torch.ft import detector as tdet

PKG = {"jax": jdet, "port": tdet}


def _pair(threshold=8.0, **kw):
    t = [0.0]
    return {name: mod.PhiAccrualDetector(threshold=threshold, clock=lambda: t[0], **kw)
            for name, mod in PKG.items()}, t


def _arrivals(seed: int, n: int) -> list:
    """Heartbeat times: a seeded mean cadence, jitter and a few stalls."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(0.05, 2.0)
    gaps = rng.gamma(shape=rng.uniform(2, 20), scale=mean / 10, size=n)
    stalls = rng.random(n) < 0.05
    gaps[stalls] *= rng.uniform(3, 12, size=int(stalls.sum()))
    return np.cumsum(gaps).tolist()


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("threshold", [1.0, 8.0, 16.0])
def test_phi_and_verdicts_equal_the_reference(seed, threshold):
    dets, t = _pair(threshold, window=32)
    beats = _arrivals(seed, 60)
    probes = np.random.default_rng(100 + seed).uniform(0.0, 30.0, size=12)
    for i, at in enumerate(beats):
        t[0] = at
        for d in dets.values():
            d.heartbeat("w")
            d.heartbeat(f"w{i % 3}")
        for silence in probes[: 1 + i % 4]:
            t[0] = at + float(silence)
            phis = {k: d.phi("w") for k, d in dets.items()}
            assert abs(phis["port"] - phis["jax"]) <= 1e-12 * max(1.0, abs(phis["jax"]))
            assert dets["port"].suspected("w") == dets["jax"].suspected("w")
            assert (dets["port"].suspicion_levels().keys()
                    == dets["jax"].suspicion_levels().keys())
        t[0] = at
    for name in ("w0", "w"):
        for d in dets.values():
            d.remove(name)
    assert dets["port"].peers() == dets["jax"].peers()


@pytest.mark.parametrize("threshold", [0.5, 3.0, 8.0, 40.0, 5000.0])
def test_threshold_solve_equals_the_reference(threshold):
    assert tdet._solve_z(threshold) == jdet._solve_z(threshold)
    for z in (-3.0, 0.0, 1.5, 7.0, 30.0):
        assert tdet._phi_of_z(z) == jdet._phi_of_z(z)


def test_unknown_peer_warm_up_and_reheal_as_the_reference():
    dets, t = _pair(8.0)
    out = {}
    for name, d in dets.items():
        t[0] = 0.0
        seen = [d.phi("ghost"), d.suspected("ghost")]
        for i in range(10):
            t[0] = i * 0.1
            d.heartbeat("w")
            seen.append(d.phi("w"))
        t[0] = 0.9 + 5.0
        seen += [d.suspected("w"), d.phi("w")]
        d.heartbeat("w")
        t[0] += 0.05
        seen += [d.suspected("w"), d.phi("w")]
        out[name] = seen
    assert out["port"] == out["jax"]
    assert out["jax"][-2] is False and out["jax"][-4] is True


def test_bad_threshold_raises_in_both():
    for mod in PKG.values():
        with pytest.raises(ValueError, match="positive"):
            mod.PhiAccrualDetector(threshold=0.0)
