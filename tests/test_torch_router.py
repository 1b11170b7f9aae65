"""Port parity: the serving router (``hypha_tpu_torch/scheduler/serving.py``
with ``num_workers > 1`` or ``route=True``) against the JAX package's
``ServingSupervisor``, the counterparts of ``tests/test_router.py``.

Both supervisors live in one process (the prefix-affinity owner is a
rendezvous over Python's ``hash`` of strings, which is salted per
process), on ``MemoryTransport`` nodes, over the same fake backends. The
same seeded sequences of ``ServeLoad`` heartbeats and requests give the
same backend order, affinity owners and skew-guard fallbacks, the same
rejections with their ``retry_after_ms``, the same busy hints passed on and
the same fall-through after a ``RequestError``. The same heartbeat times
give the same ejection passes and the same failure of the lease handle.
The dispatched ``InferExecutorConfig`` is the JAX supervisor's, byte for
byte: with ``num_workers=1`` the single-deployment wire (``load_report_s``
0, the public name), routed with the backend name.
"""

from __future__ import annotations

import asyncio
import time
import types

import numpy as np
import pytest

from hypha_tpu import messages as jmsg
from hypha_tpu.ft.detector import PhiAccrualDetector as JDetector
from hypha_tpu.network import MemoryTransport as JMemory
from hypha_tpu.network import Node as JNode
from hypha_tpu.network.node import RequestError as JRequestError
from hypha_tpu.scheduler import serving as jserving
from hypha_tpu.telemetry import SERVE_METRICS
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.ft.detector import PhiAccrualDetector as TDetector
from hypha_tpu_torch.network import MemoryTransport, Node
from hypha_tpu_torch.network.node import RequestError as TRequestError
from hypha_tpu_torch.scheduler import serving as tserving

NAME = "r"
MODEL = {"family": "llama", "preset": "tiny", "seed": 1}
PKG = {
    "jax": types.SimpleNamespace(m=jmsg, serving=jserving, node=lambda: JNode(
        JMemory().shared(), peer_id="sched"), error=JRequestError, detector=JDetector),
    "port": types.SimpleNamespace(m=tmsg, serving=tserving, node=lambda: Node(
        MemoryTransport().shared(), peer_id="sched"), error=TRequestError, detector=TDetector),
}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=120))


class Pair:
    """A JAX and a port supervisor over the same fake backends, driven in
    lockstep. Each backend's next answer is set per request (``ok``,
    ``("busy", ms)`` or ``"error"``); every forwarded request is recorded."""

    def __init__(self, workers: int, knobs: "dict | None" = None, monkeypatch=None,
                 **kw) -> None:
        # The reference's affinity knobs are keyword arguments; the port's
        # are module constants at the reference's defaults.
        knobs = knobs or {}
        for name, value in knobs.items():
            monkeypatch.setattr(tserving, name.upper(), value)
        self.sup = {k: p.serving.ServingSupervisor(
            p.node(), MODEL, NAME, num_workers=workers, **kw, **(knobs if k == "jax" else {}))
            for k, p in PKG.items()}
        loop = asyncio.get_running_loop()
        self.failed = {k: [loop.create_future() for _ in range(workers)] for k in PKG}
        for k, p in PKG.items():
            self.sup[k]._deployments = [
                p.serving._Deployment(
                    slot=s, handle=types.SimpleNamespace(peer_id=f"w{s}", failed=self.failed[k][s]),
                    task=None, job_id=f"j{s}", backend_name=f"{NAME}@{s}")
                for s in range(workers)]
            self.sup[k].node.request = self._fake(k)
        self.calls = {k: [] for k in PKG}
        self.answers: dict = {}

    def _fake(self, pkg):
        m, err = PKG[pkg].m, PKG[pkg].error

        async def request(peer, proto, msg, timeout=None):
            self.calls[pkg].append((peer, proto, msg.serve_name, [list(p) for p in msg.prompts]))
            how = self.answers.get(msg.serve_name, "ok")
            if how == "error":
                raise err(f"{peer} unreachable")
            if isinstance(how, tuple):
                return m.GenerateResponse(tokens=[], ok=False, retry_after_ms=how[1])
            return m.GenerateResponse(tokens=[[len(self.calls[pkg]), int(msg.serve_name[-1])]])

        return request

    async def load(self, slot: int, **fields) -> None:
        acks = {}
        for k, p in PKG.items():
            ack = await self.sup[k]._on_load(f"w{slot}", p.m.ServeLoad(
                job_id=f"j{slot}", serve_name=f"{NAME}@{slot}", **fields))
            acks[k] = tmsg.encode(ack) if k == "port" else jmsg.encode(ack)
        assert acks["port"] == acks["jax"]

    def age(self, slot: int, seconds: float) -> None:
        for sup in self.sup.values():
            sup._deployments[slot].load_at -= seconds

    async def request(self, prompt: list) -> tuple:
        out = {}
        for k, p in PKG.items():
            req = p.m.GenerateRequest(serve_name=NAME, prompts=[prompt], max_new_tokens=4)
            try:
                resp = await self.sup[k]._route_request("client", req)
                out[k] = ("resp", resp.tokens, resp.ok, resp.retry_after_ms)
            except PKG[k].error as e:
                out[k] = ("error", str(e))
        assert out["port"] == out["jax"], (out, self.calls)
        assert self.calls["port"] == self.calls["jax"]
        return out["port"]

    def counters(self) -> dict:
        snap = SERVE_METRICS.snapshot()
        jax = {"routed": snap["routed_requests"], "rejected": snap["rejections"],
               "affinity_routed": snap["affinity_routed"], "ejections": snap["ejections"]}
        port = {k: v for k, v in self.sup["port"].counters().items() if k in jax}
        return {"jax": jax, "port": port}

    def close(self) -> None:
        for sup in self.sup.values():
            sup._router.close()


FAMILIES = [[(7 * f + 3 * i) % 200 + 1 for i in range(80)] for f in range(4)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("affinity", [False, True])
@pytest.mark.parametrize("queue_limit", [0, 3])
def test_routing_decisions_equal_the_reference(seed, affinity, queue_limit, monkeypatch):
    rng = np.random.default_rng(seed)

    async def main():
        SERVE_METRICS.reset()
        knobs = {"affinity_tokens": int(rng.choice([8, 64])),
                 "affinity_skew": int(rng.integers(0, 5))}
        pair = Pair(3, knobs, monkeypatch, queue_limit=queue_limit, prefix_affinity=affinity)
        kinds = []
        # Nothing has heartbeated: every request is told to retry.
        kinds.append(await pair.request(FAMILIES[0][:20]))
        for step in range(40):
            for slot in rng.permutation(3)[: rng.integers(1, 4)]:
                await pair.load(int(slot), queue_depth=int(rng.integers(0, 6)),
                                free_blocks=int(rng.integers(0, 64)),
                                live_requests=int(rng.integers(0, 8)))
            if rng.random() < 0.15:
                pair.age(int(rng.integers(0, 3)), 999.0)  # a stale load
            pair.answers = {f"{NAME}@{s}": rng.choice(["ok", "ok", "ok", "busy", "error"])
                            for s in range(3)}
            pair.answers = {k: ("busy", float(rng.integers(1, 400))) if v == "busy" else str(v)
                            for k, v in pair.answers.items()}
            fam = FAMILIES[int(rng.integers(0, 4))]
            prompt = fam[: int(rng.integers(10, 80))] + [int(rng.integers(1, 250))]
            kinds.append(await pair.request(prompt))
        assert pair.counters()["port"] == pair.counters()["jax"]
        pair.close()
        return kinds

    kinds = run(main())
    assert kinds[0] == ("resp", [], False, 250.0)
    seen = {k[0] if k[0] == "error" else ("ok" if k[2] else "busy") for k in kinds}
    assert "ok" in seen and "busy" in seen


def test_affinity_owner_and_skew_guard_equal_the_reference(monkeypatch):
    """Shared-prefix requests go to one owner in both, the same one; an
    owner pushed past the skew loses its traffic to the least loaded; the
    counterpart of ``tests/test_router.py::test_router_prefix_affinity_unit``."""

    async def main():
        SERVE_METRICS.reset()
        pair = Pair(3, {"affinity_skew": 2}, monkeypatch, prefix_affinity=True)
        for s in range(3):
            await pair.load(s, queue_depth=0, free_blocks=10)
        owners = {}
        for fam in FAMILIES:
            for tail in range(4):
                await pair.request(fam[:70] + [tail])
            names = {c[2] for c in pair.calls["port"][-4:]}
            assert len(names) == 1, names
            owners[tuple(fam[:8])] = names.pop()
        owner = int(owners[tuple(FAMILIES[0][:8])][-1])
        await pair.load(owner, queue_depth=50, free_blocks=10)
        await pair.request(FAMILIES[0][:70])
        assert pair.calls["port"][-1][2] != f"{NAME}@{owner}"
        counts = pair.counters()
        assert counts["port"] == counts["jax"] and counts["port"]["affinity_routed"] == 16
        pair.close()

    run(main())


def test_backpressure_equals_the_reference():
    """Every backend at the line: ``ok=False`` and a hint of 50 ms per
    request past it; a healthy backend lets the request through (the
    counterpart of ``test_router_backpressure_unit``)."""

    async def main():
        SERVE_METRICS.reset()
        pair = Pair(2, queue_limit=2)
        await pair.load(0, queue_depth=5)
        await pair.load(1, queue_depth=3)
        assert await pair.request([1]) == ("resp", [], False, 100.0)
        await pair.load(1, queue_depth=1)
        assert (await pair.request([1]))[2] is True
        pair.answers = {f"{NAME}@1": ("busy", 75.0), f"{NAME}@0": ("busy", 20.0)}
        assert await pair.request([1]) == ("resp", [], False, 75.0)
        pair.answers = {f"{NAME}@0": "error", f"{NAME}@1": "error"}
        kind = await pair.request([1])
        assert kind[0] == "error" and "all 2 backends of 'r' failed" in kind[1]
        counts = pair.counters()
        assert counts["port"] == counts["jax"] == {"routed": 1, "rejected": 1,
                                                   "affinity_routed": 0, "ejections": 0}
        pair.close()

    run(main())


@pytest.mark.parametrize("seed", range(4))
def test_ejection_equals_the_reference(seed):
    """The same heartbeat times give the same ejection passes: nothing
    while healthy, nothing inside the absolute grace, then the silent
    backend's lease handle fails with the same reason (the counterpart of
    ``test_phi_ejection_fails_the_lease_handle``)."""
    rng = np.random.default_rng(seed)

    async def main():
        SERVE_METRICS.reset()
        pair = Pair(3)
        now = [0.0]
        for k, p in PKG.items():
            pair.sup[k]._detector = p.detector(threshold=8.0, clock=lambda: now[0])
        period = float(rng.uniform(0.2, 2.0))
        silent = int(rng.integers(0, 3))
        history = []
        for beat in range(30):
            for s in range(3):
                if s == silent and beat >= 12:
                    continue
                await pair.load(s, queue_depth=0)
            now[0] += period * float(rng.uniform(0.8, 1.2))
            if beat in (5, 14, 20):
                pair.age(silent, 0.0)
                for sup in pair.sup.values():
                    sup._eject_pass()
                history.append({k: [f.done() for f in pair.failed[k]] for k in PKG})
        history.append("grace")
        for seconds in (4.5, 5.0):  # short of the 10 s grace (10 heartbeats)
            pair.age(silent, seconds)
            for sup in pair.sup.values():
                sup._eject_pass()
            history.append({k: [f.done() for f in pair.failed[k]] for k in PKG})
        pair.age(silent, 999.0)
        for sup in pair.sup.values():
            sup._eject_pass()
        history.append({k: [f.done() for f in pair.failed[k]] for k in PKG})
        reasons = {k: [str(f.result()) for f in pair.failed[k] if f.done()] for k in PKG}
        counts = pair.counters()
        pair.close()
        return history, reasons, counts, silent

    history, reasons, counts, silent = run(main())
    for h in history:
        if h != "grace":
            assert h["port"] == h["jax"]
    assert history[-1]["port"] == [s == silent for s in range(3)]
    assert reasons["port"] == reasons["jax"] == [f"worker w{silent} failed: phi-accrual ejection"]
    assert counts["port"] == counts["jax"] and counts["port"]["ejections"] == 1


@pytest.mark.parametrize("options", [{}, {"num_workers": 2}, {"route": True},
                                     {"num_workers": 2, "queue_limit": 4, "prefix_affinity": True,
                                      "pool_prefix_cache": True, "pool_block_size": 16}])
def test_dispatched_config_bytes_equal_the_reference(options, monkeypatch):
    """``_deploy`` dispatches the JAX supervisor's ``InferExecutorConfig``
    bytes: with one worker and no ``route`` the single-deployment wire
    (``load_report_s`` 0, the public name), routed the backend name and
    the heartbeat period."""
    dispatched = {}

    async def main():
        for k, p in PKG.items():
            sup = p.serving.ServingSupervisor(p.node(), MODEL, NAME, pool_ragged=True, **options)

            class Alloc:
                async def request(self, spec, price, timeout, num_workers):
                    return [p.m.WorkerOffer(request_id="q", lease_id="l", peer_id="w0",
                                            resources=spec.resources, price=1.0,
                                            expires_in=10.0)]

            class Handle:
                peer_id, lease_id = "w0", "l"

                @classmethod
                async def create(cls, node, offer):
                    return cls()

            class FakeTask:
                @classmethod
                async def dispatch(cls, node, router, job, handles):
                    dispatched[k] = job
                    return cls()

            sup._allocator = Alloc()
            monkeypatch.setattr(p.serving, "WorkerHandle", Handle)
            monkeypatch.setattr(p.serving, "Task", FakeTask)
            dep = await sup._deploy(1 if sup.route else 0)
            assert dep.backend_name == dispatched[k].executor.infer.serve_name
            sup._router.close()

    run(main())
    cfg = {k: dispatched[k].executor.infer for k in PKG}
    assert tmsg.encode(cfg["port"]) == jmsg.encode(cfg["jax"])
    routed = bool(options)
    assert cfg["port"].load_report_s == (1.0 if routed else 0.0)
    assert cfg["port"].serve_name == (f"{NAME}@1" if routed else NAME)
    assert dispatched["port"].job_id.rsplit("-", 1)[0] == dispatched["jax"].job_id.rsplit("-", 1)[0]


@pytest.mark.parametrize("option,label", [
    (dict(report_metrics_s=1.0), "telemetry"), (dict(metrics=object()), "telemetry"),
])
def test_unported_router_options_raise(option, label):
    async def main():
        with pytest.raises(NotImplementedError, match=label):
            tserving.ServingSupervisor(PKG["port"].node(), MODEL, NAME, num_workers=2, **option)

    run(main())


def test_follow_config_dispatches_as_the_reference():
    """``serve_follow_rounds`` (refused until live weight swap was ported)
    goes out in every deployment's config, byte-equal to the reference's,
    and a following backend's heartbeat stamps land in ``weight_rounds``."""
    from hypha_tpu.serving import follow_for as jfollow
    from hypha_tpu_torch.serving import follow_for as tfollow

    async def main():
        sups = {k: p.serving.ServingSupervisor(
            p.node(), MODEL, NAME, num_workers=2,
            serve_follow_rounds=f("results:job", ["ps0"], groups=[["w0", "w1"]], start_round=3))
            for (k, p), f in zip(PKG.items(), (jfollow, tfollow))}
        assert tmsg.encode(sups["port"]._config) == jmsg.encode(sups["jax"]._config)
        sup = sups["port"]
        dep = tserving._Deployment(slot=0, handle=types.SimpleNamespace(peer_id="b0"), task=None,
                                   job_id="j0", backend_name=f"{NAME}@0")
        sup._deployments = [dep]
        await sup._on_load("b0", tmsg.ServeLoad(job_id="j0", serve_name=f"{NAME}@0",
                                                weight_round=4, weight_generation=1))
        return sup.weight_rounds()

    assert run(main()) == {f"{NAME}@0": (4, 1)}


def test_heartbeats_of_another_deployment_are_not_taken():
    """The router's ``ServeLoad`` handler matches its own deployment's
    backend names only, so a second supervisor on the node keeps its own."""

    async def main():
        node = PKG["port"].node()
        a = tserving.ServingSupervisor(node, MODEL, "a", num_workers=2)
        b = tserving.ServingSupervisor(node, MODEL, "ab", num_workers=2)
        for sup in (a, b):
            sup.route = True
        try:
            tasks = [asyncio.create_task(sup.run()) for sup in (a, b)]
            await asyncio.sleep(0.05)
            handlers = [h for h in node._handlers.get(tmsg.PROTOCOL_SERVE, [])]
            assert len(handlers) == 2
            load = tmsg.ServeLoad(job_id="j", serve_name="ab@1")
            assert [h.matches(load) for h in handlers] == [False, True]
        finally:
            for sup in (a, b):
                await sup.stop()
            await asyncio.gather(*tasks)

    run(main())


def test_route_uses_the_wall_clock_for_freshness():
    """A backend whose last load is older than the grace is routed only
    when no fresh one exists (the reference reads ``time.monotonic``)."""

    async def main():
        pair = Pair(2)
        await pair.load(0, queue_depth=0)
        await pair.load(1, queue_depth=3)
        pair.age(0, 999.0)
        await pair.request([5])
        assert pair.calls["port"][-1][2] == f"{NAME}@1"
        pair.age(1, 999.0)
        await pair.request([5])
        assert pair.calls["port"][-1][2] == f"{NAME}@0"
        assert time.monotonic() - pair.sup["port"]._deployments[0].load_at > 900
        pair.close()

    run(main())
