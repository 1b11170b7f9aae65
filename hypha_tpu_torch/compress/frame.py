"""HQD1, the self-describing compressed-delta container (counterpart of
``hypha_tpu/compress/frame.py``).

Layout (little-endian):

    bytes 0..3   magic ``HQD1``
    bytes 4..7   u32 header length H
    bytes 8..8+H CBOR header map:
        {"codec": "int8"|"int4", "chunk": int,
         "tensors": [{"name": str, "shape": [int, ...],
                      "qoff": int, "qlen": int,
                      "soff": int, "slen": int}, ...],
         "tag": {...}}                      # optional stream identity
    payload      per tensor: quantized bytes, then its f32 scales; every
                 offset is relative to the payload start.

The header rides the port's CBOR codec, which gives the JAX package's
bytes, so a frame written here is byte-identical to the reference's for the
same tensors, and each package reads the other's. Every offset follows
from the shapes alone, so the writer puts the header first and then
quantizes one tensor at a time on its device, writing each as it goes.
SafeTensors files fail the magic check, which is how :func:`read_delta`
reads any per-job wire format. Frames are written under a temporary name
and renamed, so a crashed writer never leaves a torn frame.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Any

import torch

from .. import codec as cbor
from ..executor.serialization import load_file, save_file
from ..hw import default_device
from .feedback import ErrorFeedback
from .quant import DEFAULT_CHUNK, dequantize, payload_nbytes, quantize

__all__ = ["MAGIC", "is_frame", "write_frame", "read_frame", "read_delta", "write_delta",
           "frame_header", "frame_tag"]

MAGIC = b"HQD1"

# Header bound for untrusted input: a bigger tensor table is malformed.
_MAX_HEADER = 64 * 1024 * 1024


def is_frame(path: "Path | str") -> bool:
    """True when ``path`` starts with the HQD1 magic."""
    try:
        with open(path, "rb") as fp:
            return fp.read(4) == MAGIC
    except OSError:
        return False


def _as_1d(value) -> torch.Tensor:
    t = torch.as_tensor(value)
    return t.reshape(1) if t.dim() == 0 else t


def write_frame(path: "Path | str", flat: dict, codec: str, chunk: int = DEFAULT_CHUNK,
                tag: "dict | None" = None, ef: "ErrorFeedback | None" = None) -> dict:
    """Quantize ``flat`` (name -> tensor; a kernel in the reference's
    orientation) and write one HQD1 frame atomically.

    Returns the dequantized tree on each tensor's device: what a receiver
    decodes. With ``ef``, each tensor is compensated (x + e) before it is
    quantized and ``ef``'s residuals become the new errors, tensor by
    tensor, as ``ErrorFeedback.compensate`` then ``absorb`` would."""
    path = Path(path)
    table, off = [], 0
    for name, value in flat.items():
        shape = list(_as_1d(value).shape)
        n = 1
        for d in shape:
            n *= int(d)
        qlen = payload_nbytes(n, codec)
        slen = 4 * ((n + chunk - 1) // chunk)
        table.append({"name": name, "shape": shape, "qoff": off, "qlen": qlen,
                      "soff": off + qlen, "slen": slen})
        off += qlen + slen
    head: dict[str, Any] = {"codec": codec, "chunk": chunk, "tensors": table}
    if tag:
        head["tag"] = dict(tag)
    header = cbor.dumps(head)
    decoded: dict = {}
    residual: dict = {}
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as fp:
            fp.write(MAGIC)
            fp.write(struct.pack("<I", len(header)))
            fp.write(header)
            for name, value in flat.items():
                comp = ef.compensate_one(name, value) if ef is not None else value
                a = _as_1d(comp)
                payload, scales = quantize(a, codec, chunk)
                d = dequantize(payload, scales, a.numel(), codec, chunk).reshape(a.shape)
                fp.write(payload.cpu().numpy())
                fp.write(scales.cpu().numpy())
                decoded[name] = d
                if ef is not None:
                    residual[name] = comp - d.reshape(comp.shape)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    if ef is not None:
        ef.replace(residual)
    return decoded


def _parse(data, path) -> tuple:
    """(header dict, payload memoryview) of a whole frame's bytes."""
    if bytes(data[:4]) != MAGIC:
        raise ValueError(f"{path}: not an HQD1 frame")
    if len(data) < 8:
        raise ValueError(f"{path}: truncated frame header")
    (hlen,) = struct.unpack("<I", bytes(data[4:8]))
    if hlen > _MAX_HEADER or 8 + hlen > len(data):
        raise ValueError(f"{path}: header length {hlen} exceeds frame")
    header = cbor.loads(bytes(data[8:8 + hlen]))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: malformed frame header")
    if not isinstance(header.get("chunk"), int) or not isinstance(header.get("tensors"), list):
        raise ValueError(f"{path}: malformed frame header")
    return header, memoryview(data)[8 + hlen:]


def read_frame(path: "Path | str", device=None) -> dict:
    """Decode one HQD1 frame -> {name: f32 tensor}, dequantized on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = default_device(device)
    with open(path, "rb") as fp:
        data = bytearray(os.fstat(fp.fileno()).st_size)
        fp.readinto(data)
    header, payload = _parse(data, path)
    codec, chunk = header.get("codec"), header["chunk"]
    out: dict = {}
    for entry in header["tensors"]:
        name = entry["name"]
        shape = tuple(int(d) for d in entry["shape"])
        n = 1
        for d in shape:
            n *= d
        qoff, qlen = int(entry["qoff"]), int(entry["qlen"])
        soff, slen = int(entry["soff"]), int(entry["slen"])
        if qoff < 0 or soff < 0 or qoff + qlen > len(payload) or soff + slen > len(payload):
            raise ValueError(f"{path}: tensor {name!r} spans outside payload")
        q = torch.frombuffer(payload[qoff:qoff + qlen], dtype=torch.uint8) if qlen else \
            torch.zeros(0, dtype=torch.uint8)
        # A copy: the scales may sit at any byte offset.
        s = torch.frombuffer(bytearray(payload[soff:soff + slen]), dtype=torch.float32) \
            if slen else torch.zeros(0, dtype=torch.float32)
        out[name] = dequantize(q.to(dev), s.to(dev), n, codec, chunk).reshape(shape)
    return out


def write_delta(path: "Path | str", flat: dict, codec: str, chunk: int = DEFAULT_CHUNK,
                ef: "ErrorFeedback | None" = None, tag: "dict | None" = None) -> dict:
    """The send-side entry point: encode ``flat`` per ``codec``.

    int8/int4 write an HQD1 frame, compensated through ``ef`` when given;
    bf16 casts f32 tensors (others pass through) into SafeTensors; "none"
    writes them as they are. ``tag`` stamps HQD1 frames with the sender's
    (round, fragment). Returns the tree as a receiver will decode it."""
    if codec in ("int8", "int4"):
        return write_frame(path, flat, codec, chunk, tag=tag, ef=ef)
    norm = {k: _as_1d(v).contiguous() for k, v in flat.items()}
    if codec == "bf16":
        norm = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                for k, v in norm.items()}
    elif codec != "none":
        raise ValueError(f"unknown wire codec {codec!r}")
    save_file(norm, path)
    return norm


def frame_header(path: "Path | str") -> "dict | None":
    """An HQD1 frame's CBOR header (codec, chunk, tensor table, tag), read
    without the payload; None when ``path`` is not a well-formed frame."""
    try:
        with open(path, "rb") as fp:
            head = fp.read(8)
            if head[:4] != MAGIC or len(head) < 8:
                return None
            (hlen,) = struct.unpack("<I", head[4:8])
            if hlen > _MAX_HEADER:
                return None
            header = cbor.loads(fp.read(hlen))
    except (OSError, ValueError):
        return None
    return header if isinstance(header, dict) else None


def frame_tag(path: "Path | str") -> "dict | None":
    """The stream tag an HQD1 frame carries (None: untagged, not a frame,
    or malformed)."""
    tag = (frame_header(path) or {}).get("tag")
    return dict(tag) if isinstance(tag, dict) else None


def read_delta(path: "Path | str", device=None) -> dict:
    """Read a delta or update file in any per-job wire format: an HQD1
    frame dequantizes to f32 on ``device`` (CUDA unless the caller asks for
    the CPU); a SafeTensors file loads on the host in its own dtype (f32
    or bf16), and callers move and widen it one tensor at a time, so a
    whole file never sits on the device beside what it updates."""
    if is_frame(path):
        return read_frame(path, device)
    return load_file(path)
