"""Port parity: the Job Bridge and its client.

Clients: the port's ``Session`` (``http.client`` over the unix socket) and
the JAX ``Session`` (``httpx``) each drive the JAX ``Bridge`` and the
port's ``Bridge``, both over the JAX fabric on ``MemoryTransport`` (the
tests/test_bridge.py harness): a ``file://`` fetch, a status round trip to
the scheduler, a delta sent to the parameter server and its update
received over SSE. All four pairs see the same paths, responses and
events. The port's bridge reaches the JAX node and connector through an
adapter that carries its messages across as their tagged JSON.

Bridges: the JAX and the port's ``Bridge`` take the same raw HTTP requests
with the same fake node and connector and answer with the same status
codes and JSON bodies (200, 202, 400, 404, 413, refused traversal and
absolute paths as 500), keep one connection alive over several
heartbeats, bind the socket 0600, and stop while a receive is open,
draining a background send first."""

from __future__ import annotations

import asyncio
import json
import stat
from pathlib import Path

import pytest

from hypha_tpu import messages as jmsg
from hypha_tpu.executor.bridge_client import Session as JSession
from hypha_tpu.network import MemoryTransport, Node
from hypha_tpu.worker.bridge import MAX_BODY
from hypha_tpu.worker.bridge import Bridge as JBridge
from hypha_tpu.worker.connectors import Connector as JConnector
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.executor.bridge_client import BridgeHTTPError
from hypha_tpu_torch.executor.bridge_client import Session as TSession
from hypha_tpu_torch.worker.bridge import Bridge as TBridge
from hypha_tpu_torch.worker.bridge import BridgeError, safe_rel
from hypha_tpu_torch.worker.connectors import Connector as TConnector
from hypha_tpu_torch.worker.connectors import ReceivedFile, _safe_name, fetch_uri, shard_route

PKG = {"jax": (jmsg, JSession, JBridge), "port": (tmsg, TSession, TBridge)}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


def _as(msgs, msg):
    """``msg`` as the other package's message, through the tagged JSON."""
    src = tmsg if msgs is jmsg else jmsg
    return msgs.from_json_dict(src.to_json_dict(msg))


class _JaxNodeForPort:
    """The JAX fabric node behind the port's bridge."""

    def __init__(self, node) -> None:
        self.node = node

    async def request(self, peer, protocol, msg, timeout=30.0):
        resp = await self.node.request(peer, protocol, _as(jmsg, msg), timeout=timeout)
        return _as(tmsg, resp)


class _JaxConnectorForPort:
    """The JAX peer connector behind the port's bridge."""

    def __init__(self, conn) -> None:
        self.conn = conn

    async def fetch(self, fetch, dest):
        return await self.conn.fetch(_as(jmsg, fetch), dest)

    async def send(self, send, path, resource, meta=None):
        await self.conn.send(_as(jmsg, send), path, resource, meta)

    def receive(self, receive, dest):
        return self.conn.receive(_as(jmsg, receive), dest)


@pytest.mark.parametrize("client,bridge", [("jax", "jax"), ("port", "jax"),
                                           ("jax", "port"), ("port", "port")])
def test_session_and_bridge_pairs_agree(tmp_path, client, bridge):
    msgs, Session, _ = PKG[client]
    src = tmp_path / "model.safetensors"
    src.write_bytes(b"weights" * 100)
    work = tmp_path / "work"
    seen: dict = {"progress": [], "pushes": []}

    async def main():
        hub = MemoryTransport()
        nodes = {p: Node(hub.shared(), peer_id=p) for p in ("worker", "sched", "ps")}
        for n in nodes.values():
            await n.start()
        for x in nodes.values():
            for y in nodes.values():
                if x is not y:
                    x.add_peer_addr(y.peer_id, y.listen_addrs[0])
        worker, sched, ps = nodes["worker"], nodes["sched"], nodes["ps"]

        async def on_progress(peer, progress):
            seen["progress"].append((peer, progress.kind.value, progress.job_id))
            return jmsg.ProgressResponse(kind=jmsg.ProgressResponseKind.SCHEDULE_UPDATE, counter=3)

        sched.on(jmsg.PROTOCOL_PROGRESS, jmsg.Progress).respond_with(on_progress)

        async def parameter_server():
            push = await ps.next_push(timeout=20)
            seen["pushes"].append((push.peer, dict(push.resource), len(await push.read_all())))
            await ps.push("worker", {"resource": "results", "name": "update", "round": 0},
                          b"U" * 777)

        server = asyncio.create_task(parameter_server())
        conn = JConnector(worker, "sched")
        if bridge == "jax":
            b = JBridge(worker, work, "j1", "sched", conn)
        else:
            b = TBridge(_JaxNodeForPort(worker), work, "j1", "sched", _JaxConnectorForPort(conn))
        sock = await b.start()
        (work / "delta.st").write_bytes(b"D" * 4321)

        def client_ops():
            with Session(str(sock)) as s:
                paths = s.fetch(msgs.Fetch(msgs.Reference.from_uri(src.as_uri())))
                resp = s.send_status(msgs.Progress(kind=msgs.ProgressKind.STATUS, batch_size=8))
                s.send_resource(msgs.Send(msgs.Reference.from_peers(["ps"], "updates")),
                                "delta.st", "updates", meta={"num_samples": 8.0, "round": 0})
                with s.receive(msgs.Receive(msgs.Reference.from_peers(["ps"], "results"))) as ev:
                    events = [next(ev)]
            return paths, resp, events

        paths, resp, events = await asyncio.to_thread(client_ops)
        await asyncio.wait_for(server, 20)
        await b.stop()
        for n in nodes.values():
            await n.stop()
        return paths, resp, events

    paths, resp, events = run(main())
    assert paths == ["artifacts/model.safetensors"]
    assert (work / paths[0]).read_bytes() == src.read_bytes()
    assert isinstance(resp, msgs.ProgressResponse)
    assert (resp.kind.value, resp.counter) == ("schedule-update", 3)
    assert seen["progress"] == [("worker", "status", "j1")]
    assert seen["pushes"] == [("worker", {"num_samples": 8.0, "round": 0, "resource": "updates",
                                          "name": "delta.st"}, 4321)]
    assert events == [{"path": f"incoming/{_safe_name('ps-update')}.bin", "size": 777,
                       "from_peer": "ps", "resource": "results",
                       "meta": {"resource": "results", "name": "update", "round": 0}}]
    assert (work / events[0]["path"]).read_bytes() == b"U" * 777
    assert not (work / "bridge.sock").exists()


# --------------------------------------------------------------- raw HTTP


class _FakeNode:
    def __init__(self, msgs) -> None:
        self.msgs, self.calls = msgs, []

    async def request(self, peer, protocol, msg, timeout=30.0):
        self.calls.append((peer, protocol, msg.kind.value, msg.job_id, timeout))
        return self.msgs.ProgressResponse(kind=self.msgs.ProgressResponseKind.CONTINUE, counter=2)


class _FakeConnector:
    """file:// fetches; sends recorded after a pause (so stop() must wait
    for them); receives yield what the test queues."""

    def __init__(self) -> None:
        self.sent: list = []
        self.landed: "asyncio.Queue" = asyncio.Queue()

    async def fetch(self, fetch, dest):
        return [await asyncio.to_thread(fetch_uri, fetch.ref.uri, dest)]

    async def send(self, send, path, resource, meta=None):
        await asyncio.sleep(0.2)
        self.sent.append((send.ref.peers, path.name, resource, meta))

    async def receive(self, receive, dest):
        while True:
            yield await self.landed.get()


async def _response(reader):
    line = await reader.readline()
    if not line:
        return None
    status = int(line.split()[1])
    headers = {}
    while (h := await reader.readline()) not in (b"\r\n", b""):
        k, _, v = h.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    if "content-length" not in headers:
        return status, headers.get("content-type")
    body = await reader.readexactly(int(headers["content-length"]))
    return status, json.loads(body)


async def _request(conn, method, path, body=None, *, length=None):
    reader, writer = conn
    data = b"" if body is None else json.dumps(body).encode()
    n = len(data) if length is None else length
    writer.write(f"{method} {path} HTTP/1.1\r\nhost: bridge\r\ncontent-length: {n}\r\n\r\n"
                 .encode() + (data if length is None else b""))
    await writer.drain()
    return await _response(reader)


async def _drive(kind: str, work: Path, src: Path) -> tuple:
    """One transcript of raw requests against ``kind``'s bridge."""
    msgs, _, Bridge = PKG[kind]
    node, connector = _FakeNode(msgs), _FakeConnector()
    bridge = Bridge(node, work, "job-7", "sched", connector)
    sock = await bridge.start()
    out: list = [("mode", stat.S_IMODE(sock.stat().st_mode))]
    (work / "delta.st").write_bytes(b"D" * 99)
    j = msgs.to_json_dict
    status = j(msgs.Progress(kind=msgs.ProgressKind.STATUS, batch_size=2))
    send = j(msgs.Send(msgs.Reference.from_peers(["ps"], "updates")))

    async def connect():
        return await asyncio.open_unix_connection(str(sock))

    conn = await connect()  # one keep-alive connection for all of these
    out.append(await _request(conn, "GET", "/openapi.json"))
    for _ in range(3):  # heartbeats
        out.append(await _request(conn, "POST", "/status/send", {"progress": status}))
    out.append(await _request(conn, "POST", "/status/send",
                              {"progress": j(msgs.Fetch(msgs.Reference.from_uri("file:///x")))}))
    out.append(await _request(conn, "POST", "/resources/fetch", {"fetch": status}))
    out.append(await _request(conn, "POST", "/resources/fetch",
                              {"fetch": j(msgs.Fetch(msgs.Reference.from_uri(src.as_uri())))}))
    out.append(await _request(conn, "POST", "/resources/send",
                              {"send": send, "path": "delta.st", "meta": {"round": 1}}))
    out.append(await _request(conn, "POST", "/resources/send", {"send": send, "path": "nope.st"}))
    out.append(await _request(conn, "POST", "/resources/send",
                              {"send": send, "path": "delta.st", "meta": [1]}))
    out.append(await _request(conn, "POST", "/resources/send", {"send": status, "path": "delta.st"}))
    out.append(await _request(conn, "POST", "/nowhere", {}))
    out.append(await _request(conn, "GET", "/resources/fetch"))
    out.append(await _request(conn, "POST", "/resources/send", {"send": send, "path": "../x"}))
    out.append(await conn[0].read())  # the 500 closed the connection
    for bad in ("/etc/passwd", "a/../../b"):
        conn = await connect()
        out.append(await _request(conn, "POST", "/resources/send", {"send": send, "path": bad}))
    conn = await connect()
    out.append(await _request(conn, "POST", "/status/send", length=MAX_BODY + 1))
    out.append(await conn[0].read())
    conn = await connect()
    out.append(await _request(conn, "POST", "/resources/receive", {"receive": status}))
    out.append(await conn[0].read())
    # An open receive: one event, then stop() with a send in flight.
    recv = j(msgs.Receive(msgs.Reference.from_peers(["ps"], "results")))
    conn = await connect()
    out.append(await _request(conn, "POST", "/resources/receive", {"receive": recv}))
    (work / "incoming").mkdir(exist_ok=True)
    connector.landed.put_nowait(ReceivedFile(work / "incoming" / "u.bin", 5, "ps", "results",
                                             {"round": 1}))
    out.append(await conn[0].readline())
    out.append(await conn[0].readline())
    side = await connect()
    out.append(await _request(side, "POST", "/resources/send",
                              {"send": send, "path": "delta.st", "meta": {"round": 2}}))
    await asyncio.wait_for(bridge.stop(), 10)
    out.append(await asyncio.wait_for(conn[0].read(), 5))  # the stream ended
    out.append(("socket left", sock.exists()))
    out.append(("node", node.calls))
    out.append(("sent", connector.sent))  # both sends drained before stop() returned
    return out


def test_bridges_answer_raw_requests_alike(tmp_path):
    src = tmp_path / "model.safetensors"
    src.write_bytes(b"weights" * 10)
    jax = run(_drive("jax", tmp_path / "jax", src))
    port = run(_drive("port", tmp_path / "port", src))
    assert port == jax
    codes = [r[0] for r in port if isinstance(r, tuple) and isinstance(r[0], int)]
    assert codes == [200, 200, 200, 200, 400, 400, 200, 202, 400, 400, 400, 404, 404,
                     500, 500, 500, 413, 400, 200, 202]
    assert port[0] == ("mode", 0o600)
    assert port[-1] == ("sent", [(["ps"], "delta.st", "updates", {"round": 1}),
                                 (["ps"], "delta.st", "updates", {"round": 2})])
    assert port[-2] == ("node", [("sched", tmsg.PROTOCOL_PROGRESS, "status", "job-7", 30)] * 3)
    assert b'"path": "incoming/u.bin"' in port[-7]


def test_port_bridge_refuses_what_it_does_not_port(tmp_path):
    # Without a connector the bridge builds the port's on its node, as the
    # reference does; only the status retry across an outage is refused.
    node = _FakeNode(tmsg)
    default = TBridge(node, tmp_path, "j", "sched").connector
    assert isinstance(default, TConnector)
    assert (default.node, default.scheduler_peer) == (node, "sched")
    with pytest.raises(NotImplementedError, match="sharded PS/FT/rejoin"):
        TBridge(_FakeNode(tmsg), tmp_path, "j", "sched", _FakeConnector(), status_retry_s=5.0)
    assert safe_rel(tmp_path, "artifacts/m.bin") == tmp_path / "artifacts/m.bin"
    for bad in ("/etc/passwd", "../../secrets"):
        with pytest.raises(BridgeError):
            safe_rel(tmp_path, bad)


def test_port_connector_routes(tmp_path):
    src = tmp_path / "slice.safetensors"
    src.write_bytes(b"s" * 64)
    conn = TConnector()  # no fabric Node: the uri fetch only

    async def main():
        got = await conn.fetch(tmsg.Fetch(tmsg.Reference.from_uri(src.as_uri())), tmp_path / "a")
        assert got == [tmp_path / "a" / "slice.safetensors"] and got[0].read_bytes() == b"s" * 64
        hf = tmsg.Fetch(tmsg.Reference(repo="org/model", filenames=["w.safetensors"]))
        with pytest.raises(NotImplementedError, match="HF checkpoints"):
            await conn.fetch(hf, tmp_path)
        with pytest.raises(ValueError, match="fabric's Node"):
            await conn.fetch(tmsg.Fetch(tmsg.Reference(scheduler_peer="s", dataset="d")), tmp_path)
        peers = tmsg.Reference.from_peers(["ps"], "updates")
        with pytest.raises(ValueError, match="fabric's Node"):
            await conn.send(tmsg.Send(peers), src, "updates")
        with pytest.raises(ValueError, match="fabric's Node"):
            conn.receive(tmsg.Receive(peers), tmp_path)
        # The unported pieces name their ROADMAP.md labels.
        with pytest.raises(NotImplementedError, match="input_pipeline"):
            TConnector(None, "s", slice_cache=object())
        with pytest.raises(NotImplementedError, match="input_pipeline"):
            await TConnector(object(), "s").fetch(
                tmsg.Fetch(tmsg.Reference.from_scheduler("s", "d", prefetch=2)), tmp_path)
        with pytest.raises(NotImplementedError, match="sharded PS/FT/rejoin"):
            shard_route(tmsg.ShardMap(shards=["a"]), 0)

    run(main())
    with pytest.raises(ValueError, match="scheme"):
        fetch_uri("ftp://host/x", tmp_path)
    assert _safe_name("ps-update") == _safe_name("ps-update") and len(_safe_name("x")) == 32


def test_port_session_raises_on_error_status(tmp_path):
    """A 4xx from the bridge surfaces as BridgeHTTPError, and the session's
    next request still goes through on a fresh connection."""

    async def main():
        bridge = TBridge(_FakeNode(tmsg), tmp_path / "w", "j", "sched", _FakeConnector())
        sock = await bridge.start()

        def ops():
            with TSession(str(sock)) as s:
                with pytest.raises(BridgeHTTPError) as e:
                    s.send_resource(tmsg.Send(tmsg.Reference.from_peers(["ps"], "u")), "none.st")
                assert e.value.status == 400
                with pytest.raises(BridgeHTTPError) as e:
                    s.send_resource(tmsg.Send(tmsg.Reference.from_peers(["ps"], "u")), "../x")
                assert e.value.status == 500  # the bridge closes after a 500
                return s.send_status(tmsg.Progress(kind=tmsg.ProgressKind.STATUS))

        resp = await asyncio.to_thread(ops)
        await bridge.stop()
        return resp

    assert run(main()).kind == tmsg.ProgressResponseKind.CONTINUE
