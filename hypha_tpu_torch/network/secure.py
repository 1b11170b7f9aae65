"""mTLS-secured node construction (counterpart of
``hypha_tpu/network/secure.py``, on the port's ``certs.py``).

Ties L0 (certs) to L1 (fabric): every connection is mutual-TLS against the
root of trust, and the node's fabric identity is *derived from its
certificate* — PeerID = hash of the cert public key — so a peer cannot claim
an identity its certificate doesn't prove (reference:
crates/network/src/cert.rs:30-79 identity_from_private_key;
transport construction crates/scheduler/src/network.rs:109-131).
"""

from __future__ import annotations

from pathlib import Path

from .. import certs
from .fabric import TcpTransport
from .node import Node

__all__ = ["secure_node"]


def secure_node(
    cert_file: str | Path,
    key_file: str | Path,
    trust_file: str | Path,
    crl_file: str | Path | None = None,
    bootstrap: list[str] | None = None,
    registry_server: bool = False,
    **node_kwargs,
) -> Node:
    """A Node whose transport is mTLS and whose peer id is its cert-key hash.

    The handshake's claimed ``from`` id is checked against the TLS-layer
    certificate on every inbound stream; a mismatch aborts the stream.
    """
    cert_path = Path(cert_file)
    transport = TcpTransport(
        server_ssl=certs.make_server_context(cert_path, key_file, trust_file, crl_file),
        client_ssl=certs.make_client_context(cert_path, key_file, trust_file, crl_file),
    )
    peer_id = certs.peer_id_from_cert_pem(cert_path.read_bytes())

    # One-connection-per-stream means this runs per message; certs are
    # immutable, so cache the DER -> peer-id derivation.
    id_cache: dict[bytes, str] = {}

    def expected_peer_id(stream) -> str | None:
        der = getattr(stream, "peer_certificate_der", lambda: None)()
        # Under TLS a missing client cert is impossible (CERT_REQUIRED);
        # None here means a non-TLS transport, where no check applies.
        if not der:
            return None
        pid = id_cache.get(der)
        if pid is None:
            pid = certs.peer_id_from_cert_der(der)
            if len(id_cache) > 256:
                id_cache.clear()
            id_cache[der] = pid
        return pid

    return Node(
        transport,
        peer_id=peer_id,
        bootstrap=bootstrap,
        registry_server=registry_server,
        expected_peer_id=expected_peer_id,
        # The node-cert key signs gossip frames (reference signs gossipsub
        # messages with the swarm keypair, scheduler/network.rs:132-136);
        # receivers verify self-certifying key-hash == origin.
        gossip_key=certs.load_private_key_from_pem(key_file),
        **node_kwargs,
    )
