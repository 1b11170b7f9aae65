"""Port parity: the multiplexed transport (``hypha_tpu_torch/network/mux.py``)
against the JAX package's.

The cases of ``tests/test_mux.py`` on port nodes: many concurrent logical
streams on one base connection, push and pull, interleaved pushes, a
dropped base connection, window credit returned by an abandoned stream,
mux over mTLS keeping certificate identities. Then across packages: a JAX
``MuxTransport`` and the port's exchange RPCs both ways and a push each
way over one TCP connection, plain and under mTLS.
"""

from __future__ import annotations

import asyncio

import pytest

from hypha_tpu import certutil as jcertutil
from hypha_tpu import messages as jmsg
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.network.mux import MuxTransport as JMux
from hypha_tpu.network.secure import secure_node as jsecure_node
from hypha_tpu_torch import certutil
from hypha_tpu_torch.messages import DataSlice, HealthRequest, HealthResponse
from hypha_tpu_torch.network import MemoryTransport, MuxTransport, Node, RequestError, TcpTransport
from hypha_tpu_torch.network.secure import secure_node


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=30))


async def _healthy(*_):
    return HealthResponse(healthy=True)


def test_many_streams_one_connection_tcp():
    """100 concurrent RPCs over a muxed TCP transport — one TCP connection
    carries them all (dial-side connection reuse)."""

    async def main():
        a_mux, b_mux = MuxTransport(TcpTransport()), MuxTransport(TcpTransport())
        a, b = Node(a_mux, peer_id="a"), Node(b_mux, peer_id="b")
        await a.start(["127.0.0.1:0"])
        await b.start(["127.0.0.1:0"])
        a.add_peer_addr("b", b.listen_addrs[0])
        calls = 0

        async def handler(peer, msg):
            nonlocal calls
            calls += 1
            await asyncio.sleep(0.01)  # force real concurrency
            return HealthResponse(healthy=True)

        b.on("/health", HealthRequest).concurrency(100).respond_with(handler)
        replies = await asyncio.gather(
            *(a.request("b", "/health", HealthRequest()) for _ in range(100)))
        assert calls == 100 and all(r.healthy for r in replies)
        assert len(b_mux._accepted) == 1  # all rode ONE accepted base connection
        assert a_mux.base.counts["dialed"] == b_mux.base.counts["accepted"] == 1
        assert a_mux.counts["streams_dialed"] == b_mux.counts["streams_accepted"] == 100
        await a.stop()
        await b.stop()

    run(main())


def test_push_and_pull_over_mux():
    async def main():
        hub = MemoryTransport()
        a = Node(MuxTransport(hub.shared()), peer_id="a")
        b = Node(MuxTransport(hub.shared()), peer_id="b")
        await a.start()
        await b.start()
        a.add_peer_addr("b", b.listen_addrs[0])
        b.add_peer_addr("a", a.listen_addrs[0])
        payload = bytes(range(256)) * 8192  # 2 MiB

        async def recv():
            p = await b.next_push(timeout=10)
            return await p.read_all()

        t = asyncio.create_task(recv())
        sent = await a.push("b", DataSlice(dataset="g", index=0), payload)
        assert sent == len(payload) and await t == payload

        async def pull_handler(peer, resource):
            return payload

        b.on_pull(pull_handler)
        stream = await a.pull("b", DataSlice(dataset="g", index=0))
        got = []
        while chunk := await stream.read(1 << 20):
            got.append(chunk)
        assert b"".join(got) == payload
        await a.stop()
        await b.stop()

    run(main())


def test_interleaved_streams_do_not_corrupt():
    """Two large pushes interleave frame-by-frame on one connection; each
    consumer gets exactly its own bytes."""

    async def main():
        hub = MemoryTransport()
        a = Node(MuxTransport(hub.shared()), peer_id="a")
        b = Node(MuxTransport(hub.shared()), peer_id="b")
        await a.start()
        await b.start()
        a.add_peer_addr("b", b.listen_addrs[0])
        pay1, pay2 = b"\x01" * (3 << 20), b"\x02" * (3 << 20)
        got = {}

        async def recv(n):
            for _ in range(n):
                p = await b.next_push(timeout=15)
                got[p.resource.dataset] = await p.read_all()

        t = asyncio.create_task(recv(2))
        await asyncio.gather(a.push("b", DataSlice(dataset="one", index=0), pay1),
                             a.push("b", DataSlice(dataset="two", index=0), pay2))
        await t
        assert got["one"] == pay1 and got["two"] == pay2
        await a.stop()
        await b.stop()

    run(main())


def test_base_connection_drop_fails_open_streams():
    """When the remote tears down the base connection, later requests fail
    with RequestError instead of hanging."""

    async def main():
        hub = MemoryTransport()
        a = Node(MuxTransport(hub.shared()), peer_id="a")
        b = Node(MuxTransport(hub.shared()), peer_id="b")
        await a.start()
        await b.start()
        a.add_peer_addr("b", b.listen_addrs[0])
        b.on("/health", HealthRequest).respond_with(_healthy)
        r = await a.request("b", "/health", HealthRequest(), timeout=5)
        assert r.healthy  # connection proven live first
        await b.stop()  # tears down the accepted mux connection
        with pytest.raises(RequestError):
            await a.request("b", "/health", HealthRequest(), timeout=5)
        await a.stop()

    run(main())


def test_abandoned_stream_returns_window_credit():
    """A consumer that abandons a large message mid-read must not stall the
    connection: unread bytes are credited back on close/reset, so later
    streams still flow."""

    async def main():
        hub = MemoryTransport()
        a = Node(MuxTransport(hub.shared()), peer_id="a")
        b = Node(MuxTransport(hub.shared()), peer_id="b")
        await a.start()
        await b.start()
        a.add_peer_addr("b", b.listen_addrs[0])
        big = b"\x05" * (6 << 20)  # > the 4 MiB connection window

        async def recv_and_abandon():
            push = await b.next_push(timeout=10)
            await push.stream.read(10)  # taste it, then walk away
            await push.stream.abort()
            push.finish()

        t = asyncio.create_task(recv_and_abandon())
        try:
            await asyncio.wait_for(a.push("b", DataSlice(dataset="big", index=0), big), 10)
        except (RequestError, ConnectionError, asyncio.TimeoutError):
            pass  # the abort may surface at the sender; the point is below
        await t
        b.on("/health", HealthRequest).respond_with(_healthy)
        r = await asyncio.wait_for(a.request("b", "/health", HealthRequest()), 5)
        assert r.healthy  # the SAME connection still serves new streams
        await a.stop()
        await b.stop()

    run(main())


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """One root and org; nodes a and b from the port's certutil, j from
    the reference's."""
    out = tmp_path_factory.mktemp("pki")
    for tool, args in ((certutil, ["root"]), (certutil, ["org", "--name", "o"]),
                       (certutil, ["node", "--org", "o", "--name", "a"]),
                       (certutil, ["node", "--org", "o", "--name", "b"]),
                       (jcertutil, ["node", "--org", "o", "--name", "j"])):
        assert tool.main([args[0], "--out", str(out), *args[1:]]) == 0
    return out


def test_mux_over_mtls_preserves_peer_identity(pki):
    """PeerID = cert-key-hash checks pass through the muxer (logical
    streams expose the base connection's certificate)."""

    async def main():
        def mk(name):
            node = secure_node(pki / f"{name}.crt", pki / f"{name}.key", pki / "trust.crt")
            node.transport = MuxTransport(node.transport)
            return node

        a, b = mk("a"), mk("b")
        await a.start(["127.0.0.1:0"])
        await b.start(["127.0.0.1:0"])
        assert await a.dial(b.listen_addrs[0]) == b.peer_id  # verified through the muxer

        async def handler(p, msg):
            assert p == a.peer_id
            return HealthResponse(healthy=True)

        b.on("/health", HealthRequest).respond_with(handler)
        assert (await a.request(b.peer_id, "/health", HealthRequest())).healthy
        await a.stop()
        await b.stop()

    run(main())


@pytest.mark.parametrize("secured", [False, True], ids=["tcp", "mtls"])
def test_mux_crosses_packages(pki, secured):
    """A JAX MuxTransport and the port's: RPCs both ways and a push each
    way, each direction over one base connection."""

    async def main():
        if secured:
            j = jsecure_node(pki / "j.crt", pki / "j.key", pki / "trust.crt")
            t = secure_node(pki / "a.crt", pki / "a.key", pki / "trust.crt")
            j.transport, t.transport = JMux(j.transport), MuxTransport(t.transport)
        else:
            j, t = JNode(JMux(JTcp()), peer_id="j"), Node(MuxTransport(TcpTransport()), peer_id="t")
        await j.start(["127.0.0.1:0"])
        await t.start(["127.0.0.1:0"])
        j.add_peer_addr(t.peer_id, t.listen_addrs[0])
        t.add_peer_addr(j.peer_id, j.listen_addrs[0])
        seen = {"j": [], "t": []}

        async def j_health(peer, msg):
            seen["j"].append(peer)
            return jmsg.HealthResponse(healthy=True)

        async def t_health(peer, msg):
            seen["t"].append(peer)
            return HealthResponse(healthy=True)

        j.on("/health", jmsg.HealthRequest).concurrency(8).respond_with(j_health)
        t.on("/health", HealthRequest).concurrency(8).respond_with(t_health)
        for _ in range(2):
            got = await asyncio.gather(
                *(t.request(j.peer_id, "/health", HealthRequest()) for _ in range(8)),
                *(j.request(t.peer_id, "/health", jmsg.HealthRequest()) for _ in range(8)))
            assert all(r.healthy for r in got)
        assert seen == {"j": [t.peer_id] * 16, "t": [j.peer_id] * 16}
        payload = bytes(range(256)) * 12288  # 3 MiB: several mux frames
        for src, dst, slice_ in ((t, j, jmsg.DataSlice(dataset="x", index=1)),
                                 (j, t, DataSlice(dataset="y", index=2))):
            recv = asyncio.create_task(dst.next_push(timeout=10))
            await src.push(dst.peer_id, slice_, payload)
            push = await recv
            assert await push.read_all() == payload and push.resource.index == slice_.index
        assert len(j.transport._conns) == len(t.transport._conns) == 1
        assert t.transport.counts["streams_dialed"] == 17
        assert t.transport.counts["streams_accepted"] == 17
        assert t.transport.base.counts == {"dialed": 1, "accepted": 1, "refused": 0}
        await j.stop()
        await t.stop()

    run(main())
