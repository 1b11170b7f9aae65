"""mTLS-secured node construction (counterpart of
``hypha_tpu/network/secure.py``), not ported.

The reference derives a node's peer id from its certificate and checks
every stream's claimed id against the TLS layer's certificate, with the
contexts, ids and gossip keys built by its ``certs.py`` on
``cryptography``, which the port does not depend on (ROADMAP.md, Queue 1:
mTLS). ``TcpTransport`` still takes caller-built ``ssl.SSLContext``s.
"""

from __future__ import annotations

__all__ = ["secure_node"]


def secure_node(cert_file, key_file, trust_file, crl_file=None, bootstrap=None,
                registry_server=False, **node_kwargs):
    """The reference's mTLS node; raises here."""
    raise NotImplementedError(
        "mTLS nodes (certificate-derived peer ids, signed gossip) are not ported to "
        "PyTorch yet (ROADMAP.md, Queue 1: mTLS)"
    )
