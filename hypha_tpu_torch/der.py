"""A minimal DER (X.690) writer and reader: what ``certs.py`` needs to
build and read X.509 certificates and CRLs (RFC 5280) without the
``cryptography`` package.

Writers return the whole TLV as bytes. The reader walks TLVs and keeps
each element's raw bytes, so a parent's Name or a certificate's
SubjectPublicKeyInfo can be copied byte for byte.
"""

from __future__ import annotations

import base64
import datetime
from typing import NamedTuple

__all__ = [
    "tlv", "sequence", "set_of", "integer", "boolean", "bit_string", "octet_string",
    "oid", "utf8_string", "time", "explicit", "implicit",
    "Element", "parse", "children", "read_integer", "pem_encode", "pem_decode_all",
    "SEQUENCE", "SET", "INTEGER", "BOOLEAN", "BIT_STRING", "OCTET_STRING", "OID",
    "UTF8_STRING", "UTC_TIME", "GENERALIZED_TIME",
]

BOOLEAN, INTEGER, BIT_STRING, OCTET_STRING, OID = 0x01, 0x02, 0x03, 0x04, 0x06
UTF8_STRING, UTC_TIME, GENERALIZED_TIME = 0x0C, 0x17, 0x18
SEQUENCE, SET = 0x30, 0x31


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        length = bytes([n])
    else:
        body = n.to_bytes((n.bit_length() + 7) // 8, "big")
        length = bytes([0x80 | len(body)]) + body
    return bytes([tag]) + length + content


def sequence(*items: bytes) -> bytes:
    return tlv(SEQUENCE, b"".join(items))


def set_of(*items: bytes) -> bytes:
    """A SET OF: DER sorts its elements by their encodings."""
    return tlv(SET, b"".join(sorted(items)))


def integer(n: int) -> bytes:
    """Two's complement, minimal (a positive value whose top bit is set
    gets a leading zero byte)."""
    length = (n + (n < 0)).bit_length() // 8 + 1
    return tlv(INTEGER, n.to_bytes(length, "big", signed=True))


def boolean(value: bool) -> bytes:
    return tlv(BOOLEAN, b"\xff" if value else b"\x00")


def bit_string(data: bytes, unused_bits: int = 0) -> bytes:
    return tlv(BIT_STRING, bytes([unused_bits]) + data)


def octet_string(data: bytes) -> bytes:
    return tlv(OCTET_STRING, data)


def oid(dotted: str) -> bytes:
    arcs = [int(a) for a in dotted.split(".")]
    out = bytearray([40 * arcs[0] + arcs[1]])
    for arc in arcs[2:]:
        chunk = [arc & 0x7F]
        arc >>= 7
        while arc:
            chunk.append(0x80 | (arc & 0x7F))
            arc >>= 7
        out += bytes(reversed(chunk))
    return tlv(OID, bytes(out))


def utf8_string(text: str) -> bytes:
    return tlv(UTF8_STRING, text.encode())


def time(when: datetime.datetime) -> bytes:
    """RFC 5280 4.1.2.5: UTCTime through 2049, GeneralizedTime from 2050,
    in UTC to the second."""
    when = when.astimezone(datetime.timezone.utc)
    if when.year < 2050:
        return tlv(UTC_TIME, when.strftime("%y%m%d%H%M%SZ").encode())
    return tlv(GENERALIZED_TIME, when.strftime("%Y%m%d%H%M%SZ").encode())


def explicit(number: int, content: bytes) -> bytes:
    """[number] EXPLICIT: a constructed context tag around a whole TLV."""
    return tlv(0xA0 | number, content)


def implicit(number: int, content: bytes) -> bytes:
    """[number] IMPLICIT of a primitive type: the context tag in place of
    the type's own; ``content`` is the value without its tag and length."""
    return tlv(0x80 | number, content)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class Element(NamedTuple):
    tag: int
    content: bytes
    raw: bytes  # tag, length and content


def _read(data: bytes, pos: int) -> "tuple[Element, int]":
    if pos + 2 > len(data):
        raise ValueError("DER: truncated")
    tag, first = data[pos], data[pos + 1]
    if tag & 0x1F == 0x1F:
        raise ValueError("DER: high tag numbers are not supported")
    pos += 2
    if first < 0x80:
        n = first
    else:
        width = first & 0x7F
        if not 0 < width <= 4 or pos + width > len(data):
            raise ValueError("DER: bad length")
        n = int.from_bytes(data[pos:pos + width], "big")
        if n < 0x80 or data[pos] == 0:
            raise ValueError("DER: length not minimal")
        pos += width
    end = pos + n
    if end > len(data):
        raise ValueError("DER: truncated")
    start = pos - 2 - (0 if first < 0x80 else first & 0x7F)
    return Element(tag, bytes(data[pos:end]), bytes(data[start:end])), end


def parse(data: bytes) -> Element:
    """The one element ``data`` holds; trailing bytes are an error."""
    element, end = _read(data, 0)
    if end != len(data):
        raise ValueError("DER: trailing bytes")
    return element


def children(element: Element, tag: "int | None" = None) -> list:
    """The elements of a constructed element's content (checking its tag)."""
    if tag is not None and element.tag != tag:
        raise ValueError(f"DER: tag {element.tag:#x}, wanted {tag:#x}")
    out, pos = [], 0
    while pos < len(element.content):
        child, pos = _read(element.content, pos)
        out.append(child)
    return out


def read_integer(element: Element) -> int:
    if element.tag != INTEGER or not element.content:
        raise ValueError("DER: not an INTEGER")
    return int.from_bytes(element.content, "big", signed=True)


# ---------------------------------------------------------------------------
# PEM (RFC 7468)
# ---------------------------------------------------------------------------


def pem_encode(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der).decode()
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return (f"-----BEGIN {label}-----\n" + "\n".join(lines)
            + f"\n-----END {label}-----\n").encode()


def pem_decode_all(data: bytes, label: str) -> list:
    """The DER of every ``label`` block in ``data``, in order."""
    begin, end = f"-----BEGIN {label}-----".encode(), f"-----END {label}-----".encode()
    out, pos = [], 0
    while (i := data.find(begin, pos)) >= 0:
        j = data.find(end, i)
        if j < 0:
            raise ValueError(f"PEM: unterminated {label}")
        out.append(base64.b64decode(b"".join(data[i + len(begin):j].split()), validate=True))
        pos = j + len(end)
    return out
