"""Port parity: the PKI and mTLS layer (``hypha_tpu_torch/ed25519.py``,
``der.py``, ``certs.py``, ``certutil.py``, ``network/secure.py``) against
the JAX package's (``hypha_tpu/certs.py`` on ``cryptography``).

1. Ed25519: keys the reference generates, loaded from their PEMs, give
   byte-equal public keys and signatures, and ``verify`` agrees with
   ``cryptography`` on genuine, tampered and S + L signatures.
2. Certificates and CRLs the port writes load in ``cryptography``, verify
   against their parent, carry the reference's extensions and critical
   flags, and give the reference's peer ids; the reference's PEMs read in
   the port give the same ids and serials; both ``certutil``s print the
   same lines.
3. The cases of ``tests/test_certs.py`` on port nodes, and a mixed mTLS
   network: a JAX ``secure_node`` and the port's under one root, with
   certificates from either ``certutil``, exchange RPCs both ways; a
   spoofed ``from`` id, an untrusted root and a revoked certificate are
   refused in either direction.
"""

from __future__ import annotations

import asyncio
import re
import ssl

import numpy as np
import pytest
from cryptography import x509
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import serialization

from hypha_tpu import certs as jcerts
from hypha_tpu import certutil as jcertutil
from hypha_tpu.messages import HealthRequest as JHealthRequest
from hypha_tpu.messages import HealthResponse as JHealthResponse
from hypha_tpu.network.secure import secure_node as jsecure_node
from hypha_tpu_torch import certs, certutil, ed25519
from hypha_tpu_torch.messages import PROTOCOL_HEALTH, HealthRequest, HealthResponse
from hypha_tpu_torch.network import FrameError, RequestError
from hypha_tpu_torch.network.secure import secure_node

_L = 2**252 + 27742317777372353535851937790883648493
CUTILS = {"jax": jcertutil, "port": certutil}
SECURE = {"jax": jsecure_node, "port": secure_node}
HEALTH = {"jax": (JHealthRequest, JHealthResponse), "port": (HealthRequest, HealthResponse)}
REFUSED = (ssl.SSLError, ConnectionError, OSError, FrameError)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=30))


def _cli(tool, *args) -> None:
    assert tool.main(list(args)) == 0


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """root -> org-a -> {alice, bob, eve} from the port's certutil, {jx,
    jy} from the reference's under the same org; mallory under a root of
    its own."""
    out = tmp_path_factory.mktemp("pki")
    _cli(certutil, "root", "--out", str(out))
    _cli(certutil, "org", "--out", str(out), "--name", "org-a")
    for name in ("alice", "bob", "eve"):
        _cli(certutil, "node", "--out", str(out), "--org", "org-a", "--name", name)
    for name in ("jx", "jy"):
        _cli(jcertutil, "node", "--out", str(out), "--org", "org-a", "--name", name)
    other = tmp_path_factory.mktemp("pki-other")
    _cli(certutil, "root", "--out", str(other))
    _cli(certutil, "org", "--out", str(other), "--name", "org-x")
    _cli(certutil, "node", "--out", str(other), "--org", "org-x", "--name", "mallory")
    return out, other


def _node(pkg, out, name, **kw):
    return SECURE[pkg](out / f"{name}.crt", out / f"{name}.key", out / "trust.crt", **kw)


def _health(node, pkg, seen=None):
    req, resp = HEALTH[pkg]

    async def answer(peer, msg):
        if seen is not None:
            seen.append(peer)
        return resp(healthy=True)

    node.on(PROTOCOL_HEALTH, req).respond_with(answer)


# ---------------------------------------------------------------------------
# Ed25519
# ---------------------------------------------------------------------------


def test_ed25519_matches_cryptography_on_the_references_keys():
    rng = np.random.default_rng(13)
    for i in range(32):
        _, key_pem = jcerts.generate_root_ca(f"k{i}")
        ref = jcerts.load_private_key_from_pem(key_pem)
        mine = certs.load_private_key_from_pem(key_pem)
        assert mine.private_bytes_pem() == key_pem
        spki = ref.public_key().public_bytes(serialization.Encoding.DER,
                                             serialization.PublicFormat.SubjectPublicKeyInfo)
        assert mine.public_key().spki_der() == spki and len(spki) == 44
        assert mine.public_key().public_bytes_raw() == ref.public_key().public_bytes_raw()
        msg = rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
        sig = mine.sign(msg)
        assert sig == ref.sign(msg)
        pub = ed25519.load_public_key_spki(spki)
        s_plus_l = sig[:32] + (int.from_bytes(sig[32:], "little") + _L).to_bytes(32, "little")
        flipped = bytes([sig[0] ^ 1]) + sig[1:]
        for m, sg in ((msg, sig), (msg + b"!", sig), (msg, flipped), (msg, s_plus_l)):
            try:
                ref.public_key().verify(sg, m)
                want = True
            except InvalidSignature:
                want = False
            assert pub.verify(sg, m) is want, (i, m == msg, sg == sig)
        assert not pub.verify(s_plus_l, msg)


def test_ed25519_refuses_malformed_keys():
    with pytest.raises(ValueError):
        ed25519.load_private_key_der(ed25519.PKCS8_PREFIX + b"\x00" * 31)
    with pytest.raises(ValueError):
        ed25519.load_public_key_spki(b"\x30" + b"\x00" * 43)
    key = ed25519.Ed25519PrivateKey.generate()
    not_on_curve = (2).to_bytes(32, "little")  # y = 2 has no x on the curve
    assert not ed25519.Ed25519PublicKey(not_on_curve).verify(key.sign(b"m"), b"m")
    assert not key.public_key().verify(key.sign(b"m")[:63], b"m")


# ---------------------------------------------------------------------------
# Certificates in both directions
# ---------------------------------------------------------------------------


def _chain(pkg_certs):
    root, root_key = pkg_certs.generate_root_ca()
    org, org_key = pkg_certs.generate_org_ca("org-a", root, root_key)
    node, _ = pkg_certs.generate_node_cert("n1", org, org_key, ["localhost", "10.0.0.5", "::1"])
    crl = pkg_certs.generate_crl(org, org_key, [node], extra_revoked_serials=[7])
    return [x509.load_pem_x509_certificate(p) for p in (root, org, node)], crl, (root, org, node)


def test_port_certificates_are_read_by_the_reference():
    (root, org, node), crl_pem, pems = _chain(certs)
    (jroot, jorg, jnode), jcrl_pem, _ = _chain(jcerts)
    root.verify_directly_issued_by(root)
    org.verify_directly_issued_by(root)
    node.verify_directly_issued_by(org)
    for mine, ref, issuer in ((root, jroot, root), (org, jorg, root), (node, jnode, org)):
        assert mine.version == x509.Version.v3 and 0 < mine.serial_number < 2**159
        assert mine.issuer.public_bytes() == issuer.subject.public_bytes()
        assert mine.subject.public_bytes() == ref.subject.public_bytes()
        assert mine.not_valid_after_utc - mine.not_valid_before_utc == \
            ref.not_valid_after_utc - ref.not_valid_before_utc
        assert [(e.oid, e.critical) for e in mine.extensions] == \
            [(e.oid, e.critical) for e in ref.extensions]
        for ext in mine.extensions:
            value = ext.value
            if isinstance(value, x509.SubjectKeyIdentifier):
                assert value == x509.SubjectKeyIdentifier.from_public_key(mine.public_key())
            elif isinstance(value, x509.AuthorityKeyIdentifier):
                assert value == x509.AuthorityKeyIdentifier.from_issuer_public_key(
                    issuer.public_key())
            elif isinstance(value, x509.SubjectAlternativeName):
                assert [str(v.value) for v in value] == ["localhost", "10.0.0.5", "::1"]
            else:
                assert value == ref.extensions.get_extension_for_oid(ext.oid).value
    for pem in pems:
        assert certs.peer_id_from_cert_pem(pem) == jcerts.peer_id_from_cert_pem(pem)
    crl = x509.load_pem_x509_crl(crl_pem)
    assert crl.is_signature_valid(org.public_key())
    assert crl.issuer.public_bytes() == org.subject.public_bytes()
    assert sorted(r.serial_number for r in crl) == sorted([7, node.serial_number])
    jcrl = x509.load_pem_x509_crl(jcrl_pem)
    assert (crl.next_update_utc - crl.last_update_utc) == (jcrl.next_update_utc
                                                           - jcrl.last_update_utc)
    assert crl.public_bytes(serialization.Encoding.PEM) == crl_pem


def test_reference_pems_are_read_by_the_port(pki, tmp_path):
    out, _ = pki
    for name in ("jx", "jy", "alice"):
        path = out / f"{name}.crt"
        chain = certs.load_certs_from_pem(path)
        ref = jcerts.load_certs_from_pem(path)
        assert [c.der for c in chain] == [c.public_bytes(serialization.Encoding.DER) for c in ref]
        assert [c.serial_number for c in chain] == [c.serial_number for c in ref]
        assert certs.peer_id_from_cert_der(chain[0].der) == \
            jcerts.peer_id_from_cert_pem(path.read_bytes())
        key = certs.load_private_key_from_pem(out / f"{name}.key")
        assert key.public_key().spki_der() == chain[0].spki
    _, jcrl, (_, _, node) = _chain(jcerts)
    (tmp_path / "j.crl").write_bytes(jcrl)
    serial = x509.load_pem_x509_certificate(node).serial_number
    assert [c.revoked_serials for c in certs.load_crls_from_pem(tmp_path / "j.crl")] == \
        [tuple(sorted([7, serial]))]


def test_certutil_prints_the_references_lines(tmp_path, capsys):
    lines = {}
    for pkg, tool in CUTILS.items():
        out = tmp_path / pkg
        for args in (["root"], ["org", "--name", "o"], ["node", "--org", "o", "--name", "n"],
                     ["revoke", "--org", "o", "--cert", str(out / "n.crt")]):
            _cli(tool, args[0], "--out", str(out), *args[1:])
        text = capsys.readouterr().out.replace(str(out), "<out>")
        lines[pkg] = re.sub(r"12H[0-9a-f]{40}", "<peer id>", text).splitlines()
        assert sorted(p.name for p in out.iterdir()) == [
            "n.crt", "n.key", "o.crl", "o.crt", "o.key", "root.crt", "root.key", "trust.crt"]
        assert (out / "n.key").stat().st_mode & 0o777 == 0o600
    assert lines["port"] == lines["jax"]


def test_peer_id_is_cert_key_hash(pki):
    out, _ = pki
    pid = certs.peer_id_from_cert_pem((out / "alice.crt").read_bytes())
    assert pid.startswith("12H") and len(pid) == 43
    assert pid == certs.peer_id_from_cert_pem((out / "alice.crt").read_bytes())
    assert pid != certs.peer_id_from_cert_pem((out / "bob.crt").read_bytes())


def test_loaders(pki):
    out, _ = pki
    chain = certs.load_certs_from_pem(out / "alice.crt")
    assert len(chain) == 2  # node + org CA
    assert chain[0].issuer == chain[1].subject
    assert isinstance(certs.load_private_key_from_pem(out / "alice.key"),
                      ed25519.Ed25519PrivateKey)


# ---------------------------------------------------------------------------
# mTLS nodes, port-only and mixed
# ---------------------------------------------------------------------------

# (dialer package and cert, listener package and cert)
PAIRS = {
    "port-port": ("port", "alice", "port", "bob"),
    "port-to-jax": ("port", "alice", "jax", "jx"),
    "jax-to-port": ("jax", "jy", "port", "bob"),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_mtls_rpc_roundtrip(pki, pair):
    out, _ = pki
    dpkg, dname, lpkg, lname = PAIRS[pair]

    async def main():
        dialer, listener = _node(dpkg, out, dname), _node(lpkg, out, lname)
        await dialer.start(listen=["127.0.0.1:0"])
        await listener.start(listen=["127.0.0.1:0"])
        seen: list = []
        _health(listener, lpkg, seen)
        _health(dialer, dpkg)
        assert await dialer.dial(listener.listen_addrs[0]) == listener.peer_id
        resp = await dialer.request(listener.peer_id, PROTOCOL_HEALTH, HEALTH[dpkg][0]())
        assert resp.healthy and seen == [dialer.peer_id]  # the caller's id is its cert's
        back = await listener.request(dialer.peer_id, PROTOCOL_HEALTH, HEALTH[lpkg][0]())
        assert back.healthy
        await dialer.stop()
        await listener.stop()

    run(main())


@pytest.mark.parametrize("listener_pkg", ["port", "jax"])
def test_untrusted_hierarchy_rejected(pki, listener_pkg):
    out, other = pki

    async def main():
        alice = _node(listener_pkg, out, "alice" if listener_pkg == "port" else "jx")
        mallory = _node("port", other, "mallory")
        await alice.start(listen=["127.0.0.1:0"])
        await mallory.start(listen=["127.0.0.1:0"])
        with pytest.raises(REFUSED):
            await mallory.dial(alice.listen_addrs[0])
        with pytest.raises(REFUSED):
            await alice.dial(mallory.listen_addrs[0])
        await alice.stop()
        await mallory.stop()

    run(main())


@pytest.mark.parametrize("listener_pkg", ["port", "jax"])
def test_identity_spoof_rejected(pki, listener_pkg):
    """A trusted port peer claiming another's peer id in the handshake is
    cut off by either package's listener, and a port dialer whose target
    answers with another certificate aborts."""
    out, _ = pki
    bob_name = "bob" if listener_pkg == "port" else "jx"

    async def main():
        alice = _node("port", out, "alice")
        bob = _node(listener_pkg, out, bob_name)
        eve = _node("port", out, "eve")
        for n in (alice, bob, eve):
            await n.start(listen=["127.0.0.1:0"])
        _health(bob, listener_pkg)
        eve.peer_id = alice.peer_id  # eve lies about being alice
        eve.add_peer_addr(bob.peer_id, bob.listen_addrs[0])
        with pytest.raises(RequestError):
            await eve.request(bob.peer_id, PROTOCOL_HEALTH, HealthRequest())
        honest_eve = _node("port", out, "eve")
        await honest_eve.start(listen=["127.0.0.1:0"])
        alice.add_peer_addr(bob.peer_id, honest_eve.listen_addrs[0])
        with pytest.raises(RequestError):
            await alice.request(bob.peer_id, PROTOCOL_HEALTH, HealthRequest())
        for n in (alice, bob, eve, honest_eve):
            await n.stop()

    run(main())


def test_crl_reissue_keeps_prior_revocations(pki):
    """Revoking B after A must keep A revoked (CRL serials merge)."""
    out, _ = pki
    for name in ("alice", "bob"):
        _cli(certutil, "revoke", "--out", str(out), "--org", "org-a",
             "--cert", str(out / f"{name}.crt"))
    crl = out / "org-a.crl"
    serials = {s for c in certs.load_crls_from_pem(crl) for s in c.revoked_serials}
    assert serials == {s for c in jcerts.load_crls_from_pem(crl) for s in
                       (r.serial_number for r in c)}
    want = {x509.load_pem_x509_certificate((out / f"{n}.crt").read_bytes()).serial_number
            for n in ("alice", "bob")}
    assert want <= serials
    crl.unlink()  # later tests start from a clean slate


@pytest.mark.parametrize("listener_pkg", ["port", "jax"])
def test_crl_revocation(pki, listener_pkg):
    """eve revoked by the port's certutil: a listener of either package
    loading the CRL refuses her (the port's counts and logs the refusal),
    and bob, not revoked, still connects."""
    out, _ = pki
    _cli(certutil, "revoke", "--out", str(out), "--org", "org-a", "--cert", str(out / "eve.crt"))
    crl = out / "org-a.crl"

    async def main():
        alice = _node(listener_pkg, out, "alice" if listener_pkg == "port" else "jx",
                      crl_file=crl)
        eve = _node("port", out, "eve")
        await alice.start(listen=["127.0.0.1:0"])
        await eve.start(listen=["127.0.0.1:0"])
        with pytest.raises(REFUSED):
            await eve.dial(alice.listen_addrs[0])
        bob = _node("port", out, "bob", crl_file=crl)
        await bob.start(listen=["127.0.0.1:0"])
        assert await bob.dial(alice.listen_addrs[0]) == alice.peer_id
        if listener_pkg == "port":
            assert alice.transport.counts["refused"] == 1
        for n in (alice, eve, bob):
            await n.stop()

    try:
        run(main())
    finally:
        crl.unlink()
