"""L0 security: PKI generation, loading and mTLS contexts (counterpart of
``hypha_tpu/certs.py``).

The reference builds its certificates with the ``cryptography`` package;
the port writes the same DER itself (``der.py``) and signs with its own
Ed25519 (``ed25519.py``):

  * a three-tier Ed25519 hierarchy: root CA -> org CA -> node
    certificates with SANs, each with the reference's extensions, critical
    flags and validity, a 159-bit random serial and the issuer Name copied
    byte for byte from the parent's subject;
  * **PeerID = hash of the certificate's SubjectPublicKeyInfo**, so
    transport identity and cryptographic identity coincide;
  * PEM loading for certificate chains, private keys and CRLs
    (certificates and CRLs come back as small records of their DER);
  * mutual TLS where both sides require and verify the peer chain against
    the root of trust, with optional CRL checking, on stdlib ``ssl``.

CRLs are loaded at context-build time only: rotating a CRL needs a node
restart, as in the reference.
"""

from __future__ import annotations

import datetime
import hashlib
import ipaddress
import secrets
import ssl
from dataclasses import dataclass
from pathlib import Path

from . import der
from .ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
    load_private_key_der,
    load_public_key_spki,
)

__all__ = [
    "generate_root_ca",
    "generate_org_ca",
    "generate_node_cert",
    "generate_crl",
    "peer_id_from_cert_pem",
    "peer_id_from_cert_der",
    "load_certs_from_pem",
    "load_private_key_from_pem",
    "load_crls_from_pem",
    "make_server_context",
    "make_client_context",
    "write_node_dir",
]

_ONE_DAY = datetime.timedelta(days=1)

_ED25519 = der.sequence(der.oid("1.3.101.112"))  # AlgorithmIdentifier, no parameters
_CN = "2.5.4.3"
_SKI, _KEY_USAGE, _SAN, _BASIC, _AKI, _EKU = (
    "2.5.29.14", "2.5.29.15", "2.5.29.17", "2.5.29.19", "2.5.29.35", "2.5.29.37")
_SERVER_AUTH, _CLIENT_AUTH = "1.3.6.1.5.5.7.3.1", "1.3.6.1.5.5.7.3.2"
# digitalSignature (bit 0), keyCertSign (5), cRLSign (6): 0b10000110, the
# trailing zero bit trimmed.
_CA_KEY_USAGE = der.bit_string(b"\x86", unused_bits=1)


@dataclass(frozen=True)
class Certificate:
    """An X.509 certificate's DER and the fields the port reads from it."""

    der: bytes
    serial_number: int
    issuer: bytes  # the issuer Name's DER
    subject: bytes  # the subject Name's DER
    spki: bytes  # the SubjectPublicKeyInfo's DER

    def public_key(self) -> Ed25519PublicKey:
        return load_public_key_spki(self.spki)


@dataclass(frozen=True)
class RevocationList:
    """A CRL's DER and its revoked serials."""

    der: bytes
    revoked_serials: tuple


def _parse_cert(data: bytes) -> Certificate:
    tbs = der.children(der.children(der.parse(data), der.SEQUENCE)[0], der.SEQUENCE)
    if tbs and tbs[0].tag == 0xA0:  # [0] version
        tbs = tbs[1:]
    serial, _alg, issuer, _validity, subject, spki = tbs[:6]
    return Certificate(data, der.read_integer(serial), issuer.raw, subject.raw, spki.raw)


def _parse_crl(data: bytes) -> RevocationList:
    tbs = der.children(der.children(der.parse(data), der.SEQUENCE)[0], der.SEQUENCE)
    if tbs and tbs[0].tag == der.INTEGER:  # version
        tbs = tbs[1:]
    rest = tbs[3:]  # past signature, issuer and thisUpdate
    if rest and rest[0].tag in (der.UTC_TIME, der.GENERALIZED_TIME):  # nextUpdate
        rest = rest[1:]
    serials = ()
    if rest and rest[0].tag == der.SEQUENCE:
        serials = tuple(der.read_integer(der.children(entry, der.SEQUENCE)[0])
                        for entry in der.children(rest[0]))
    return RevocationList(data, serials)


def _name(common_name: str) -> bytes:
    """A Name of one RDN, the CN as a UTF8String (as ``cryptography`` writes it)."""
    return der.sequence(der.set_of(der.sequence(der.oid(_CN), der.utf8_string(common_name))))


def _validity(days: int) -> "tuple[datetime.datetime, datetime.datetime]":
    now = datetime.datetime.now(datetime.timezone.utc)
    return now - _ONE_DAY, now + datetime.timedelta(days=days)


def _serial() -> int:
    """159 random bits: positive and at most 20 octets (RFC 5280 4.1.2.2)."""
    return int.from_bytes(secrets.token_bytes(20), "big") >> 1


def _key_id(key: Ed25519PublicKey) -> bytes:
    """RFC 5280 4.2.1.2 method 1: SHA-1 of the subjectPublicKey bits."""
    return hashlib.sha1(key.public_bytes_raw()).digest()


def _extension(oid: str, value: bytes, critical: bool = False) -> bytes:
    # DER omits a BOOLEAN at its DEFAULT (FALSE).
    return der.sequence(der.oid(oid), *([der.boolean(True)] if critical else []),
                        der.octet_string(value))


def _ca_extensions(key: Ed25519PublicKey, path_length: int) -> list:
    return [
        _extension(_BASIC, der.sequence(der.boolean(True), der.integer(path_length)), True),
        _extension(_KEY_USAGE, _CA_KEY_USAGE, True),
        _extension(_SKI, der.octet_string(_key_id(key))),
    ]


def _aki(issuer_key: Ed25519PublicKey) -> bytes:
    return _extension(_AKI, der.sequence(der.implicit(0, _key_id(issuer_key))))


def _sign_cert(*, issuer: bytes, subject: bytes, key: Ed25519PublicKey, days: int,
               extensions: list, signer: Ed25519PrivateKey) -> bytes:
    not_before, not_after = _validity(days)
    tbs = der.sequence(
        der.explicit(0, der.integer(2)),  # v3
        der.integer(_serial()),
        _ED25519,
        issuer,
        der.sequence(der.time(not_before), der.time(not_after)),
        subject,
        key.spki_der(),
        der.explicit(3, der.sequence(*extensions)),
    )
    return der.sequence(tbs, _ED25519, der.bit_string(signer.sign(tbs)))


def _cert_pem(cert_der: bytes) -> bytes:
    return der.pem_encode("CERTIFICATE", cert_der)


def _load_cert_pem(pem: bytes) -> Certificate:
    blocks = der.pem_decode_all(pem, "CERTIFICATE")
    if not blocks:
        raise ValueError("no PEM certificate")
    return _parse_cert(blocks[0])


def generate_root_ca(
    common_name: str = "hypha-root", days: int = 3650
) -> "tuple[bytes, bytes]":
    """Self-signed Ed25519 root CA. Returns (cert_pem, key_pem)."""
    key = Ed25519PrivateKey.generate()
    name = _name(common_name)
    cert = _sign_cert(issuer=name, subject=name, key=key.public_key(), days=days,
                      extensions=_ca_extensions(key.public_key(), 1), signer=key)
    return _cert_pem(cert), key.private_bytes_pem()


def generate_org_ca(
    common_name: str, root_cert_pem: bytes, root_key_pem: bytes, days: int = 1825
) -> "tuple[bytes, bytes]":
    """Org-level intermediate CA signed by the root."""
    root = _load_cert_pem(root_cert_pem)
    root_key = load_private_key_from_pem(root_key_pem)
    key = Ed25519PrivateKey.generate()
    cert = _sign_cert(
        issuer=root.subject, subject=_name(common_name), key=key.public_key(), days=days,
        extensions=[*_ca_extensions(key.public_key(), 0), _aki(root.public_key())],
        signer=root_key)
    return _cert_pem(cert), key.private_bytes_pem()


def generate_node_cert(
    common_name: str,
    org_cert_pem: bytes,
    org_key_pem: bytes,
    sans: "list[str] | None" = None,
    days: int = 825,
) -> "tuple[bytes, bytes]":
    """Leaf certificate for one node, usable as both TLS client and server
    (every peer both dials and listens). SANs default to localhost."""
    org = _load_cert_pem(org_cert_pem)
    org_key = load_private_key_from_pem(org_key_pem)
    key = Ed25519PrivateKey.generate()
    names = []
    for san in sans or ["localhost", "127.0.0.1"]:
        try:
            names.append(der.implicit(7, ipaddress.ip_address(san).packed))  # iPAddress
        except ValueError:
            names.append(der.implicit(2, san.encode("ascii")))  # dNSName
    cert = _sign_cert(
        issuer=org.subject, subject=_name(common_name), key=key.public_key(), days=days,
        extensions=[
            _extension(_BASIC, der.sequence(), True),  # cA FALSE, at its default
            _extension(_SAN, der.sequence(*names)),
            _extension(_EKU, der.sequence(der.oid(_SERVER_AUTH), der.oid(_CLIENT_AUTH))),
            _aki(org.public_key()),
        ],
        signer=org_key)
    return _cert_pem(cert), key.private_bytes_pem()


def generate_crl(
    org_cert_pem: bytes,
    org_key_pem: bytes,
    revoked_cert_pems: "list[bytes]",
    days: int = 365,
    extra_revoked_serials: "list[int] | None" = None,
) -> bytes:
    """Certificate revocation list (v2) signed by the org CA.

    AVAILABILITY NOTE: with ``VERIFY_CRL_CHECK_LEAF`` OpenSSL hard-fails
    *all* verification once the CRL's next_update passes — an expired CRL
    cuts the node off from every peer, not just revoked ones. ``days`` is
    therefore a re-issuance deadline; regenerate CRLs well before it.

    ``extra_revoked_serials`` carries forward serials from a previous CRL
    so re-issuing never silently un-revokes certificates.
    """
    org = _load_cert_pem(org_cert_pem)
    org_key = load_private_key_from_pem(org_key_pem)
    now = datetime.datetime.now(datetime.timezone.utc)
    serials = {_load_cert_pem(pem).serial_number for pem in revoked_cert_pems}
    serials.update(extra_revoked_serials or [])
    entries = [der.sequence(der.integer(s), der.time(now - _ONE_DAY)) for s in sorted(serials)]
    tbs = der.sequence(
        der.integer(1),  # v2
        _ED25519,
        org.subject,
        der.time(now - _ONE_DAY),
        der.time(now + datetime.timedelta(days=days)),
        *([der.sequence(*entries)] if entries else []),
    )
    crl = der.sequence(tbs, _ED25519, der.bit_string(org_key.sign(tbs)))
    return der.pem_encode("X509 CRL", crl)


# ---------------------------------------------------------------------------
# Identity: PeerID = multihash-style digest of the SubjectPublicKeyInfo
# ---------------------------------------------------------------------------


def peer_id_from_spki_der(spki: bytes) -> str:
    """PeerID from a DER SubjectPublicKeyInfo — the one identity derivation
    shared by the cert layer and gossip message signing (a gossip frame's
    embedded key must hash to its claimed origin)."""
    return "12H" + hashlib.sha256(spki).hexdigest()[:40]


def peer_id_from_cert_der(cert_der: bytes) -> str:
    return peer_id_from_spki_der(_parse_cert(cert_der).spki)


def peer_id_from_cert_pem(pem: bytes) -> str:
    return peer_id_from_spki_der(_load_cert_pem(pem).spki)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def load_certs_from_pem(path: "str | Path") -> "list[Certificate]":
    return [_parse_cert(block)
            for block in der.pem_decode_all(Path(path).read_bytes(), "CERTIFICATE")]


def load_private_key_from_pem(pem_or_path: "bytes | str | Path") -> Ed25519PrivateKey:
    data = (
        pem_or_path
        if isinstance(pem_or_path, bytes)
        else Path(pem_or_path).read_bytes()
    )
    blocks = der.pem_decode_all(data, "PRIVATE KEY")
    if len(blocks) != 1:
        raise ValueError(f"want one PEM private key, found {len(blocks)}")
    return load_private_key_der(blocks[0])


def load_crls_from_pem(path: "str | Path") -> "list[RevocationList]":
    return [_parse_crl(block)
            for block in der.pem_decode_all(Path(path).read_bytes(), "X509 CRL")]


# ---------------------------------------------------------------------------
# mTLS contexts
# ---------------------------------------------------------------------------


def _mtls_context(
    purpose: ssl.Purpose,
    cert_file: "str | Path",
    key_file: "str | Path",
    trust_file: "str | Path",
    crl_file: "str | Path | None" = None,
) -> ssl.SSLContext:
    ctx = ssl.SSLContext(
        ssl.PROTOCOL_TLS_SERVER
        if purpose is ssl.Purpose.CLIENT_AUTH
        else ssl.PROTOCOL_TLS_CLIENT
    )
    ctx.minimum_version = ssl.TLSVersion.TLSv1_3
    ctx.load_cert_chain(str(cert_file), str(key_file))
    ctx.load_verify_locations(str(trust_file))
    ctx.verify_mode = ssl.CERT_REQUIRED
    # Identity is the cert-key hash (peer id), not a DNS name.
    ctx.check_hostname = False
    if crl_file is not None:
        ctx.load_verify_locations(str(crl_file))
        ctx.verify_flags |= ssl.VERIFY_CRL_CHECK_LEAF
    return ctx


def make_server_context(
    cert_file: "str | Path",
    key_file: "str | Path",
    trust_file: "str | Path",
    crl_file: "str | Path | None" = None,
) -> ssl.SSLContext:
    """Server side of mTLS: presents the node chain, requires client certs."""
    return _mtls_context(ssl.Purpose.CLIENT_AUTH, cert_file, key_file, trust_file, crl_file)


def make_client_context(
    cert_file: "str | Path",
    key_file: "str | Path",
    trust_file: "str | Path",
    crl_file: "str | Path | None" = None,
) -> ssl.SSLContext:
    """Client side of mTLS: presents the node chain, verifies the server."""
    return _mtls_context(ssl.Purpose.SERVER_AUTH, cert_file, key_file, trust_file, crl_file)


def write_node_dir(
    out_dir: "str | Path",
    node_name: str,
    org_cert_pem: bytes,
    org_key_pem: bytes,
    root_cert_pem: bytes,
    sans: "list[str] | None" = None,
) -> dict:
    """Generate and lay out one node's credentials:

      <out>/<name>.crt   — node cert + org CA (the chain the node presents)
      <out>/<name>.key   — node private key (0600)
      <out>/trust.crt    — root CA (what the node trusts)

    Returns the paths plus the node's derived peer id under key "peer_id".
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cert_pem, key_pem = generate_node_cert(node_name, org_cert_pem, org_key_pem, sans)
    cert_path = out / f"{node_name}.crt"
    key_path = out / f"{node_name}.key"
    trust_path = out / "trust.crt"
    cert_path.write_bytes(cert_pem + org_cert_pem)
    key_path.write_bytes(key_pem)
    key_path.chmod(0o600)
    # Always (re)write: a regenerated root must not leave a stale trust
    # anchor behind, or every later handshake fails inscrutably.
    trust_path.write_bytes(root_cert_pem)
    return {
        "cert": cert_path,
        "key": key_path,
        "trust": trust_path,
        "peer_id": peer_id_from_cert_pem(cert_pem),
    }
