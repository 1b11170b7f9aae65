"""Port parity: signed gossip (``hypha_tpu_torch/network/node.py`` on
``hypha_tpu_torch/ed25519.py``) against the JAX package's.

The cases of ``tests/test_gossip_signing.py`` on port nodes keyed with the
port's Ed25519; then across packages over TCP: a frame a JAX node signs
is delivered by a port node and the other way round, and a forged frame
(altered data under a genuine signature, a forged origin, a stale
timestamp) is dropped by both. The canonical signed bytes are the
reference's for the same fields.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ed25519 as ced25519

from hypha_tpu import messages as jmessages
from hypha_tpu.network import Node as JNode
from hypha_tpu.network import TcpTransport as JTcp
from hypha_tpu.network.node import _gossip_sign_bytes as j_sign_bytes
from hypha_tpu_torch import messages
from hypha_tpu_torch.certs import peer_id_from_spki_der
from hypha_tpu_torch.ed25519 import Ed25519PrivateKey
from hypha_tpu_torch.network import MemoryTransport, Node, TcpTransport
from hypha_tpu_torch.network.node import PROTOCOL_GOSSIP, _gossip_sign_bytes


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=30))


def _keyed_peer(hub, name):
    key = Ed25519PrivateKey.generate()
    return Node(hub.shared(), peer_id=peer_id_from_spki_der(key.public_key().spki_der()),
                gossip_key=key)


async def _mesh(*nodes):
    for n in nodes:
        await n.start()
    for a in nodes:
        for b in nodes:
            if a is not b:
                a.add_peer_addr(b.peer_id, b.listen_addrs[0])
                a.add_gossip_peer(b.peer_id)


def test_sign_bytes_equal_the_references():
    rng = np.random.default_rng(5)
    for i in range(8):
        body = rng.integers(0, 256, int(rng.integers(0, 200)), dtype=np.uint8).tobytes()
        fields = (f"topic-{i}", f"{i:032x}", "12H" + "ab" * 20, int(rng.integers(0, 2**62)), body)
        assert _gossip_sign_bytes(*fields) == j_sign_bytes(*fields)


def test_signed_gossip_delivered_between_keyed_nodes():
    async def main():
        hub = MemoryTransport()
        a, b = _keyed_peer(hub, "a"), _keyed_peer(hub, "b")
        await _mesh(a, b)
        sub = await b.subscribe("ads")
        await a.publish("ads", {"kind": "ad", "n": 1})
        origin, msg = await asyncio.wait_for(sub.__anext__(), 5)
        assert origin == a.peer_id
        assert msg == {"kind": "ad", "n": 1}
        assert a.gossip_counts["signed"] == 1 and b.gossip_counts["verified"] == 1
        assert len(b.gossip_verify_s) == 1
        await a.stop()
        await b.stop()

    run(main())


def test_unsigned_gossip_dropped_by_keyed_node():
    async def main():
        hub = MemoryTransport()
        a = Node(hub.shared(), peer_id="plain-a")  # keyless attacker/dev node
        b = _keyed_peer(hub, "b")
        await _mesh(a, b)
        sub = await b.subscribe("ads")
        await a.publish("ads", {"kind": "ad"})
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(sub.__anext__(), 0.5)
        assert b.gossip_counts["dropped"] == 1
        await a.stop()
        await b.stop()

    run(main())


def _forgeries(key, origin, spki, ts, body):
    """Frames b must drop: tampered data under a genuine signature, a
    forged origin under the key, a stale but genuine frame; and the
    genuine frame itself (same message id as the tampered one)."""
    sig = key.sign(_gossip_sign_bytes("ads", "mid1", origin, ts, body))
    old_ts = ts - int(600e9)
    forged = [
        {"t": "pub", "topic": "ads", "id": "mid1", "origin": origin,
         "data": messages.encode({"kind": "ad", "n": 666}), "key": spki, "sig": sig, "ts": ts},
        {"t": "pub", "topic": "ads", "id": "mid2", "origin": "12Hforged", "data": body,
         "key": spki, "sig": key.sign(_gossip_sign_bytes("ads", "mid2", "12Hforged", ts, body)),
         "ts": ts},
        {"t": "pub", "topic": "ads", "id": "mid3", "origin": origin, "data": body, "key": spki,
         "sig": key.sign(_gossip_sign_bytes("ads", "mid3", origin, old_ts, body)), "ts": old_ts},
    ]
    genuine = {"t": "pub", "topic": "ads", "id": "mid1", "origin": origin, "data": body,
               "key": spki, "sig": sig, "ts": ts}
    return forged, genuine


async def _send(transport, addr, sender, frame, *, tcp=False):
    stream = await transport.dial(addr)
    await stream.write_frame({"from": sender, "proto": PROTOCOL_GOSSIP, "addr": ""})
    await stream.write_frame(frame)
    await stream.close()
    if tcp:  # a TCP stream's close is a half-close: release the socket too
        await stream.abort()


def test_tampered_gossip_dropped():
    """A relay that rewrites the payload (or forges the origin) is caught:
    the signature covers topic/id/origin/data."""

    async def main():
        hub = MemoryTransport()
        a, b = _keyed_peer(hub, "a"), _keyed_peer(hub, "b")
        await _mesh(a, b)
        sub = await b.subscribe("ads")
        body = messages.encode({"kind": "ad", "n": 1})
        forged, genuine = _forgeries(a._gossip_key, a.peer_id,
                                     a._gossip_key.public_key().spki_der(), time.time_ns(), body)
        for frame in forged:
            await _send(b.transport, b.listen_addrs[0], a.peer_id, frame)
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(sub.__anext__(), 0.5)
        await _send(b.transport, b.listen_addrs[0], a.peer_id, genuine)
        origin, msg = await asyncio.wait_for(sub.__anext__(), 5)
        assert origin == a.peer_id and msg == {"kind": "ad", "n": 1}
        assert b.gossip_counts == {"signed": 0, "verified": 1, "dropped": 3}
        await a.stop()
        await b.stop()

    run(main())


def test_signature_survives_multi_hop_relay():
    """Verification is end-to-end: hop b relays a's frame to c untouched,
    and c verifies against a's key."""

    async def main():
        hub = MemoryTransport()
        a, b, c = (_keyed_peer(hub, n) for n in "abc")
        await a.start()
        await b.start()
        await c.start()
        for x, y in ((a, b), (b, c)):  # a <-> b <-> c, no a-c link
            x.add_peer_addr(y.peer_id, y.listen_addrs[0])
            y.add_peer_addr(x.peer_id, x.listen_addrs[0])
            x.add_gossip_peer(y.peer_id)
            y.add_gossip_peer(x.peer_id)
        sub = await c.subscribe("ads")
        await a.publish("ads", {"kind": "ad", "hop": 2})
        origin, msg = await asyncio.wait_for(sub.__anext__(), 5)
        assert origin == a.peer_id and msg["hop"] == 2
        await a.stop()
        await b.stop()
        await c.stop()

    run(main())


def _jax_keyed():
    key = ced25519.Ed25519PrivateKey.generate()
    spki = key.public_key().public_bytes(serialization.Encoding.DER,
                                         serialization.PublicFormat.SubjectPublicKeyInfo)
    return JNode(JTcp(), peer_id=peer_id_from_spki_der(spki), gossip_key=key), key, spki


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_signed_gossip_crosses_packages(direction):
    """Over TCP: the publisher's signed frame reaches the other package's
    subscriber with its origin, and forged frames in the publisher's name
    are dropped."""

    async def main():
        jnode, _, _ = _jax_keyed()
        tkey = Ed25519PrivateKey.generate()
        tnode = Node(TcpTransport(), peer_id=peer_id_from_spki_der(tkey.public_key().spki_der()),
                     gossip_key=tkey)
        await jnode.start(["127.0.0.1:0"])
        await tnode.start(["127.0.0.1:0"])
        jnode.add_peer_addr(tnode.peer_id, tnode.listen_addrs[0])
        tnode.add_peer_addr(jnode.peer_id, jnode.listen_addrs[0])
        pub, recv, recv_msgs = ((jnode, tnode, messages) if direction == "jax-to-port"
                                else (tnode, jnode, jmessages))
        pub.add_gossip_peer(recv.peer_id)
        sub = await recv.subscribe("ads")
        await pub.publish("ads", {"kind": "ad", "n": 7})
        origin, msg = await asyncio.wait_for(sub.__anext__(), 5)
        assert origin == pub.peer_id and msg == {"kind": "ad", "n": 7}
        # Forgeries in the publisher's name, signed by the publisher's key.
        if pub is jnode:
            signer = pub._gossip_key
            spki = signer.public_key().public_bytes(
                serialization.Encoding.DER, serialization.PublicFormat.SubjectPublicKeyInfo)
        else:
            signer, spki = pub._gossip_key, pub._gossip_key.public_key().spki_der()
        forged, _ = _forgeries(signer, pub.peer_id, spki, time.time_ns(),
                               recv_msgs.encode({"kind": "ad", "n": 1}))
        for frame in forged:
            await _send(JTcp() if pub is jnode else TcpTransport(), recv.listen_addrs[0],
                        pub.peer_id, frame, tcp=True)
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(sub.__anext__(), 0.5)
        if recv is tnode:
            assert tnode.gossip_counts == {"signed": 0, "verified": 1, "dropped": 3}
        await jnode.stop()
        await tnode.stop()

    run(main())
