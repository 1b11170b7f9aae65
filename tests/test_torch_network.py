"""Port parity: the fabric's Node against the JAX package's.

A JAX ``Node`` and a port ``Node``, each on its own package's
``TcpTransport`` at 127.0.0.1 (ephemeral ports), bootstrapped through a
JAX ``Gateway`` and then through the port's:

  * registry: records and providers written by one are read by the other,
    and an RPC to a peer neither dialed resolves through the gateway;
  * RPC in both directions, first-wins handler order, predicate routing
    and a remote handler's error;
  * gossip flood through the gateway, with a direct link added so every
    message reaches each node twice, and each subscriber sees it once;
  * a 3 MB push each way, byte-equal, its header (``meta``) intact;
  * a slice pulled from a JAX ``DataNode`` and from the port's, and an
    out-of-range index refused.

The same checks run port-to-port on the port's ``MemoryTransport``.
"""

from __future__ import annotations

import asyncio
import hashlib
from pathlib import Path

import numpy as np
import pytest

from hypha_tpu import messages as jmsg
from hypha_tpu.data_node import DataNode as JDataNode
from hypha_tpu.gateway import Gateway as JGateway
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import RequestError as JRequestError
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu_torch import messages as tmsg
from hypha_tpu_torch.data_node import DataNode as TDataNode
from hypha_tpu_torch.gateway import Gateway as TGateway
from hypha_tpu_torch.network import MemoryTransport as TMemory
from hypha_tpu_torch.network import Node as TNode
from hypha_tpu_torch.network import RequestError as TRequestError
from hypha_tpu_torch.network import TcpTransport as TTcp

PKG = {
    "jax": dict(m=jmsg, Node=JNode, Gateway=JGateway, DataNode=JDataNode, Error=JRequestError),
    "port": dict(m=tmsg, Node=TNode, Gateway=TGateway, DataNode=TDataNode, Error=TRequestError),
}
CASES = {
    "tcp-jax-gateway": ("tcp", "jax", "jax", "port", ("jax", "port")),
    "tcp-port-gateway": ("tcp", "port", "jax", "port", ("jax", "port")),
    "memory-port-only": ("memory", "port", "port", "port", ("port",)),
}


def _slices(root: Path) -> tuple:
    d = root / "slices"
    d.mkdir()
    rng = np.random.default_rng(11)
    blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (70_001, 3)]
    for i, blob in enumerate(blobs):
        (d / f"slice_{i}.bin").write_bytes(blob)
    return d, blobs


async def _next(sub, timeout=10.0):
    return await asyncio.wait_for(anext(sub), timeout)


async def _scenario(root: Path, kind: str, gw_pkg: str, a_pkg: str, b_pkg: str, data_pkgs):
    hub = TMemory()

    def transport(pkg):
        if kind == "memory":
            return hub.shared()
        return JTcp() if pkg == "jax" else TTcp()

    listen = None if kind == "memory" else ["127.0.0.1:0"]
    data_dir, blobs = _slices(root)
    gw = PKG[gw_pkg]["Gateway"](transport(gw_pkg), peer_id="gw")
    await gw.start(listen)
    boot = [gw.node.listen_addrs[0]]
    A = PKG[a_pkg]["Node"](transport(a_pkg), peer_id="a", bootstrap=boot)
    B = PKG[b_pkg]["Node"](transport(b_pkg), peer_id="b", bootstrap=boot)
    datas = [PKG[p]["DataNode"](transport(p), {f"ds-{p}": data_dir}, peer_id=f"data-{p}",
                                bootstrap=boot) for p in data_pkgs]
    started = []
    try:
        for part in (A, B, *datas):
            await part.start(listen)
            started.append(part)
        await A.wait_for_bootstrap(10)
        await B.wait_for_bootstrap(10)
        am, bm = PKG[a_pkg]["m"], PKG[b_pkg]["m"]

        # ---- registry: records, providers, and routing through a lookup
        await A.put_record("rec", b"from-a")
        assert await B.get_record("rec") == b"from-a"
        await B.provide("svc")
        assert await A.find_providers("svc") == ["b"]
        for p in data_pkgs:
            record = am.decode(await A.get_record(f"ds-{p}"))
            assert record == am.DataRecord(num_slices=2)

        # ---- RPC both ways: first wins, predicates route, errors surface
        for server, client, sm, cm, err in ((B, A, bm, am, PKG[a_pkg]["Error"]),
                                            (A, B, am, bm, PKG[b_pkg]["Error"])):
            async def first(peer, msg, sm=sm):
                return sm.RenewLeaseResponse(lease_id=msg.lease_id + f"@{peer}", timeout=10.0)

            async def second(peer, msg, sm=sm):
                return sm.RenewLeaseResponse(lease_id="second", timeout=0.0)

            async def only_x(peer, msg, sm=sm):
                return sm.DataResponse(data_provider="x", index=len(msg.peer_id))

            async def failing(peer, msg):
                raise RuntimeError(f"no slices for {msg.dataset}")

            regs = [server.on(sm.PROTOCOL_API, sm.RenewLease).respond_with(first),
                    server.on(sm.PROTOCOL_API, sm.RenewLease).respond_with(second),
                    server.on(sm.PROTOCOL_API, sm.DataRequest).match(
                        lambda m: m.dataset == "x").respond_with(only_x),
                    server.on(sm.PROTOCOL_API, sm.DataRequest).respond_with(failing)]
            resp = await client.request(server.peer_id, cm.PROTOCOL_API, cm.RenewLease("L"))
            assert resp == cm.RenewLeaseResponse(lease_id=f"L@{client.peer_id}", timeout=10.0)
            resp = await client.request(server.peer_id, cm.PROTOCOL_API,
                                        cm.DataRequest(dataset="x", peer_id="four"))
            assert resp == cm.DataResponse(data_provider="x", index=4)
            with pytest.raises(err, match="no slices for y"):
                await client.request(server.peer_id, cm.PROTOCOL_API, cm.DataRequest(dataset="y"))
            regs[0].close()
            resp = await client.request(server.peer_id, cm.PROTOCOL_API, cm.RenewLease("L"))
            assert resp.lease_id == "second"
            for reg in regs[1:]:
                reg.close()
            with pytest.raises(err, match="no handler"):
                await client.request(server.peer_id, cm.PROTOCOL_API, cm.RenewLease("L"))

        # ---- gossip: flood through the gateway plus a direct link; one copy each
        subs = {"a": await A.subscribe(am.TOPIC_WORKER), "b": await B.subscribe(bm.TOPIC_WORKER)}
        A.add_gossip_peer("b")
        B.add_gossip_peer("a")
        sent = []
        for i, (pub, m) in enumerate(((B, bm), (A, am), (B, bm))):
            ad = m.RequestWorker(id=f"ad-{i}", bid=float(i), reply_to=pub.peer_id)
            await pub.publish(m.TOPIC_WORKER, ad)
            sent.append((pub.peer_id, ad.id))
        for name, sub in subs.items():
            got = [await _next(sub) for _ in sent]
            assert sorted((origin, msg.id) for origin, msg in got) == sorted(sent), name
        # Every ad reached each node on two paths; a copy that got past the
        # dedup would show up before (or instead of) the next fresh ad.
        await A.publish(am.TOPIC_WORKER, am.RequestWorker(id="last", reply_to="a"))
        for name, sub in subs.items():
            assert (await _next(sub))[1].id == "last", name
        for sub in subs.values():
            await sub.close()

        # ---- push each way: 3 MB, byte-equal, header intact
        payload = np.random.default_rng(5).integers(0, 256, 3 << 20, dtype=np.uint8).tobytes()
        src = root / "delta.bin"
        src.write_bytes(payload)
        for sender, receiver in ((A, B), (B, A)):
            tag = f"updates-{receiver.peer_id}"
            consumer = receiver.consume_pushes(
                lambda push, tag=tag: isinstance(push.resource, dict)
                and push.resource.get("resource") == tag)
            header = {"resource": tag, "name": "delta.bin", "round": 3, "num_samples": 6.0}
            sent_n, push = await asyncio.gather(sender.push(receiver.peer_id, header, src),
                                                consumer.next(timeout=10))
            dest = root / f"got-{receiver.peer_id}.bin"
            assert await push.save_to(dest) == sent_n == len(payload)
            assert push.peer == sender.peer_id and push.resource == header
            assert hashlib.sha256(dest.read_bytes()).digest() == hashlib.sha256(payload).digest()
            consumer.close()

        # ---- pull slices from every data node, and a refused index
        for node, pkg in ((A, a_pkg), (B, b_pkg)):
            m = PKG[pkg]["m"]
            for data, dataset in zip(datas, (f"ds-{p}" for p in data_pkgs)):
                for i, blob in enumerate(blobs):
                    stream = await node.pull(data.peer_id, m.DataSlice(dataset=dataset, index=i))
                    chunks = []
                    while chunk := await stream.read(1 << 16):
                        chunks.append(chunk)
                    await stream.close()
                    assert b"".join(chunks) == blob
                with pytest.raises(PKG[pkg]["Error"], match="out of range"):
                    await node.pull(data.peer_id, m.DataSlice(dataset=dataset, index=2))
    finally:
        for part in reversed(started):
            await part.stop()
        await gw.stop()


@pytest.mark.parametrize("case", sorted(CASES))
def test_fabric_interoperates(tmp_path, case):
    asyncio.run(asyncio.wait_for(_scenario(tmp_path, *CASES[case]), 60))


def test_port_node_refuses_mtls(tmp_path):
    """What a port mTLS node refuses: a plain-TCP dial (the handshake is
    counted and logged as refused, the dialer sees the connection drop),
    and an unsigned gossip frame (a keyed node runs a signed mesh)."""
    from hypha_tpu_torch import certutil
    from hypha_tpu_torch.network import FrameError
    from hypha_tpu_torch.network.secure import secure_node

    for args in (["root"], ["org", "--name", "o"], ["node", "--org", "o", "--name", "a"]):
        assert certutil.main([args[0], "--out", str(tmp_path), *args[1:]]) == 0

    async def main():
        node = secure_node(tmp_path / "a.crt", tmp_path / "a.key", tmp_path / "trust.crt")
        plain = TNode(TTcp(), peer_id="plain")
        await node.start(["127.0.0.1:0"])
        await plain.start(["127.0.0.1:0"])
        try:
            with pytest.raises((ConnectionError, OSError, FrameError)):
                await plain.dial(node.listen_addrs[0])
            for _ in range(100):  # the refusal lands on the node's side
                if node.transport.counts["refused"]:
                    break
                await asyncio.sleep(0.02)
            assert node.transport.counts == {"dialed": 0, "accepted": 0, "refused": 1}
            # Unsigned gossip into the keyed node, over a memory link.
            hub = TMemory()
            keyed = TNode(hub.shared(), peer_id=node.peer_id, gossip_key=node._gossip_key)
            loose = TNode(hub.shared(), peer_id="loose")
            for n in (keyed, loose):
                await n.start()
            loose.add_peer_addr(keyed.peer_id, keyed.listen_addrs[0])
            loose.add_gossip_peer(keyed.peer_id)
            sub = await keyed.subscribe("ads")
            await loose.publish("ads", {"kind": "ad"})
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(sub.__anext__(), 0.5)
            assert keyed.gossip_counts == {"signed": 0, "verified": 0, "dropped": 1}
            for n in (keyed, loose):
                await n.stop()
        finally:
            await node.stop()
            await plain.stop()

    asyncio.run(asyncio.wait_for(main(), 30))
