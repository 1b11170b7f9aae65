"""Minimal CBOR (RFC 8949) codec (a copy of ``hypha_tpu/codec.py``).

Every wire message of the fabric is CBOR: unsigned/negative integers,
byte strings, text strings, arrays, maps, floats, bool and null. Encoding
is canonical-ish: definite lengths only, shortest integer heads, f64 for
every float. Decoding also accepts f16/f32 and indefinite strings, arrays
and maps. The bytes are the JAX package's, so a JAX node reads what a
torch node writes and the other way (``tests/test_torch_codec.py``).

The reference prefers a C++ extension it compiles with g++ at first
import and keeps this module as its portable path and semantic spec; the
port runs the portable path only, which gives the same bytes.
"""

from __future__ import annotations

import struct
from io import BytesIO
from typing import Any

__all__ = ["dumps", "loads", "CBORDecodeError", "MAX_DEPTH"]

_BREAK = object()

# Nesting bound for untrusted input: a deeply nested frame must fail with a
# decode error, not blow the interpreter stack.
MAX_DEPTH = 128


class CBORDecodeError(ValueError):
    pass


def _head(fp: BytesIO, major: int, value: int) -> None:
    if value < 24:
        fp.write(bytes([(major << 5) | value]))
    elif value < 0x100:
        fp.write(bytes([(major << 5) | 24, value]))
    elif value < 0x10000:
        fp.write(bytes([(major << 5) | 25]) + struct.pack(">H", value))
    elif value < 0x100000000:
        fp.write(bytes([(major << 5) | 26]) + struct.pack(">I", value))
    else:
        fp.write(bytes([(major << 5) | 27]) + struct.pack(">Q", value))


def _encode(fp: BytesIO, obj: Any, depth: int = 0) -> None:
    if depth > MAX_DEPTH:
        # The reference's bound and exception class: what one package
        # refuses to serialize, the other refuses too.
        raise ValueError("object nesting too deep to encode")
    if obj is None:
        fp.write(b"\xf6")
    elif obj is True:
        fp.write(b"\xf5")
    elif obj is False:
        fp.write(b"\xf4")
    elif isinstance(obj, int):
        if not (-(2**64) <= obj < 2**64):
            raise TypeError(f"integer out of CBOR 64-bit range: {obj}")
        if obj >= 0:
            _head(fp, 0, obj)
        else:
            _head(fp, 1, -1 - obj)
    elif isinstance(obj, float):
        fp.write(b"\xfb" + struct.pack(">d", obj))
    elif isinstance(obj, bytes):
        # No defensive copy: a large byte-string frame (e.g. a quantized
        # delta header's payload) writes straight through.
        _head(fp, 2, len(obj))
        fp.write(obj)
    elif isinstance(obj, (bytearray, memoryview)):
        # Mutable/view types still copy once — len(memoryview) counts
        # elements, not bytes, for non-'B' formats, so bytes() normalizes.
        b = bytes(obj)
        _head(fp, 2, len(b))
        fp.write(b)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(fp, 3, len(b))
        fp.write(b)
    elif isinstance(obj, (list, tuple)):
        _head(fp, 4, len(obj))
        for item in obj:
            _encode(fp, item, depth + 1)
    elif isinstance(obj, dict):
        _head(fp, 5, len(obj))
        for k, v in obj.items():
            _encode(fp, k, depth + 1)
            _encode(fp, v, depth + 1)
    else:
        raise TypeError(f"cannot CBOR-encode {type(obj).__name__}")


def dumps(obj: Any) -> bytes:
    fp = BytesIO()
    _encode(fp, obj)
    return fp.getvalue()


def _read(fp: BytesIO, n: int) -> bytes:
    try:
        b = fp.read(n)
    except OverflowError:
        # A hostile header can declare a length beyond Py_ssize_t; that is
        # by definition longer than the buffer — a truncation, not a crash.
        raise CBORDecodeError("truncated input") from None
    if len(b) != n:
        raise CBORDecodeError("truncated input")
    return b


def _read_uint(fp: BytesIO, info: int) -> int:
    if info < 24:
        return info
    if info == 24:
        return _read(fp, 1)[0]
    if info == 25:
        return struct.unpack(">H", _read(fp, 2))[0]
    if info == 26:
        return struct.unpack(">I", _read(fp, 4))[0]
    if info == 27:
        return struct.unpack(">Q", _read(fp, 8))[0]
    raise CBORDecodeError(f"invalid additional info {info}")


def _decode_f16(b: bytes) -> float:
    # Decode IEEE 754 half precision without numpy.
    h = struct.unpack(">H", b)[0]
    sign = -1.0 if h & 0x8000 else 1.0
    exp = (h >> 10) & 0x1F
    frac = h & 0x3FF
    if exp == 0:
        return sign * frac * 2.0**-24
    if exp == 31:
        return sign * (float("inf") if frac == 0 else float("nan"))
    return sign * (1 + frac * 2.0**-10) * 2.0 ** (exp - 15)


def _decode(fp: BytesIO, depth: int = 0) -> Any:
    if depth > MAX_DEPTH:
        raise CBORDecodeError(f"nesting deeper than {MAX_DEPTH}")
    ib = _read(fp, 1)[0]
    major, info = ib >> 5, ib & 0x1F
    if major == 0:
        return _read_uint(fp, info)
    if major == 1:
        return -1 - _read_uint(fp, info)
    if major in (2, 3):
        if info == 31:  # indefinite string: concatenate chunks
            chunks = []
            while True:
                item = _decode(fp, depth + 1)
                if item is _BREAK:
                    break
                chunks.append(item)
            joined: Any = b"".join(chunks) if major == 2 else "".join(chunks)
            return joined
        n = _read_uint(fp, info)
        b = _read(fp, n)
        return b if major == 2 else b.decode("utf-8")
    if major == 4:
        if info == 31:
            out = []
            while True:
                item = _decode(fp, depth + 1)
                if item is _BREAK:
                    break
                out.append(item)
            return out
        out = []
        for _ in range(_read_uint(fp, info)):
            item = _decode(fp, depth + 1)
            if item is _BREAK:
                raise CBORDecodeError("break inside definite-length array")
            out.append(item)
        return out
    if major == 5:
        if info == 31:
            d = {}
            while True:
                k = _decode(fp, depth + 1)
                if k is _BREAK:
                    break
                v = _decode(fp, depth + 1)
                if v is _BREAK:
                    # A break in value position must reject the frame, not
                    # leak the sentinel into the decoded map.
                    raise CBORDecodeError("break in map value position")
                d[k] = v
            return d
        d = {}
        for _ in range(_read_uint(fp, info)):
            mk = _decode(fp, depth + 1)
            mv = _decode(fp, depth + 1)
            if mk is _BREAK or mv is _BREAK:
                raise CBORDecodeError("break inside definite-length map")
            d[mk] = mv
        return d
    if major == 6:  # tag: decode and discard the tag number
        _read_uint(fp, info)
        return _decode(fp, depth + 1)
    # major == 7: simple values / floats
    if info == 20:
        return False
    if info == 21:
        return True
    if info in (22, 23):
        return None
    if info == 25:
        return _decode_f16(_read(fp, 2))
    if info == 26:
        return struct.unpack(">f", _read(fp, 4))[0]
    if info == 27:
        return struct.unpack(">d", _read(fp, 8))[0]
    if info == 31:
        return _BREAK
    if info < 24 or info == 24:
        _read_uint(fp, info)  # unassigned simple value: skip payload
        return None
    raise CBORDecodeError(f"unsupported simple/float info {info}")


def loads(data: bytes) -> Any:
    fp = BytesIO(data)
    try:
        obj = _decode(fp)
    except CBORDecodeError:
        raise
    except (TypeError, UnicodeDecodeError, struct.error) as e:
        # Malformed untrusted input (mixed-type indefinite chunks, invalid
        # UTF-8, unhashable map keys) must surface as a decode error.
        raise CBORDecodeError(f"malformed CBOR: {e}") from e
    if obj is _BREAK:
        raise CBORDecodeError("unexpected break")
    if fp.read(1):
        raise CBORDecodeError("trailing bytes")
    return obj
