"""Dev PKI generator CLI — ``python -m hypha_tpu_torch.certutil``
(counterpart of ``hypha_tpu/certutil.py``: the same subcommands, flags,
file layout and printed lines, on the port's ``certs.py``).

Generates the three-tier Ed25519 hierarchy (root CA → org CA → node certs
with SANs) plus CRLs.

    python -m hypha_tpu_torch.certutil root --out pki/
    python -m hypha_tpu_torch.certutil org  --out pki/ --name my-org
    python -m hypha_tpu_torch.certutil node --out pki/ --org my-org --name worker-1 \
        --san localhost --san 10.0.0.5
    python -m hypha_tpu_torch.certutil revoke --out pki/ --org my-org --cert pki/worker-1.crt
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import certs


def _cmd_root(args) -> int:
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cert, key = certs.generate_root_ca(args.name, days=args.days)
    (out / "root.crt").write_bytes(cert)
    key_path = out / "root.key"
    key_path.write_bytes(key)
    key_path.chmod(0o600)
    print(f"root CA written to {out}/root.crt")
    return 0


def _cmd_org(args) -> int:
    out = Path(args.out)
    cert, key = certs.generate_org_ca(
        args.name,
        (out / "root.crt").read_bytes(),
        (out / "root.key").read_bytes(),
        days=args.days,
    )
    (out / f"{args.name}.crt").write_bytes(cert)
    key_path = out / f"{args.name}.key"
    key_path.write_bytes(key)
    key_path.chmod(0o600)
    print(f"org CA written to {out}/{args.name}.crt")
    return 0


def _cmd_node(args) -> int:
    out = Path(args.out)
    paths = certs.write_node_dir(
        out,
        args.name,
        (out / f"{args.org}.crt").read_bytes(),
        (out / f"{args.org}.key").read_bytes(),
        (out / "root.crt").read_bytes(),
        sans=args.san or None,
    )
    print(f"node cert written to {paths['cert']}")
    print(f"peer id: {paths['peer_id']}")
    return 0


def _cmd_revoke(args) -> int:
    out = Path(args.out)
    crl_path = out / f"{args.org}.crl"
    revoked = [Path(c).read_bytes() for c in args.cert]
    # Carry forward serials already revoked: re-issuing the CRL must never
    # silently un-revoke certificates from earlier invocations.
    prior_serials: list[int] = []
    if crl_path.exists():
        for crl in certs.load_crls_from_pem(crl_path):
            prior_serials.extend(crl.revoked_serials)
    crl_pem = certs.generate_crl(
        (out / f"{args.org}.crt").read_bytes(),
        (out / f"{args.org}.key").read_bytes(),
        revoked,
        days=args.days,
        extra_revoked_serials=prior_serials,
    )
    crl_path.write_bytes(crl_pem)
    total = len(set(prior_serials)) + len(revoked)
    print(f"CRL written to {crl_path} ({len(revoked)} new, {total} total entries)")
    print("note: nodes load CRLs at startup only; restart nodes to apply")
    print(
        f"note: CRL expires in {args.days} days — an expired CRL blocks ALL "
        "peers on CRL-checking nodes; re-issue before then"
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="hypha-certutil", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("root", help="generate the root CA")
    p.add_argument("--out", default="pki")
    p.add_argument("--name", default="hypha-root")
    p.add_argument("--days", type=int, default=3650)
    p.set_defaults(fn=_cmd_root)

    p = sub.add_parser("org", help="generate an org CA signed by the root")
    p.add_argument("--out", default="pki")
    p.add_argument("--name", required=True)
    p.add_argument("--days", type=int, default=1825)
    p.set_defaults(fn=_cmd_org)

    p = sub.add_parser("node", help="generate a node cert signed by an org CA")
    p.add_argument("--out", default="pki")
    p.add_argument("--org", required=True)
    p.add_argument("--name", required=True)
    p.add_argument("--san", action="append", default=[])
    p.set_defaults(fn=_cmd_node)

    p = sub.add_parser("revoke", help="generate a CRL revoking node certs")
    p.add_argument("--out", default="pki")
    p.add_argument("--org", required=True)
    p.add_argument("--cert", action="append", required=True)
    p.add_argument("--days", type=int, default=365, help="CRL validity (re-issuance deadline)")
    p.set_defaults(fn=_cmd_revoke)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
