"""SafeTensors files and flat tensor names (counterpart of
``hypha_tpu/executor/serialization.py``).

DiLoCo ships dataset slices, pseudo-gradients Δθ and outer updates as
SafeTensors files, named by the flat tree paths of the JAX package
(``params/layers_0/self_attn/q_proj/kernel``), so a file written here is
read unchanged by the JAX workers and parameter server, and the other way.

The format: an 8-byte little-endian header length, a JSON header mapping
each name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets
into the data that follows) plus an optional ``"__metadata__"`` map of
strings, then the raw little-endian data. bf16 is stored as its raw bits.
This module reads and writes that format itself: the ``safetensors``
package is not a dependency of the port.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np
import torch

__all__ = ["save_file", "load_file", "read_header", "flatten", "unflatten"]

# SafeTensors dtype name -> (torch dtype, numpy dtype of the raw bits).
_DTYPES = {
    "F64": (torch.float64, np.dtype("<f8")),
    "F32": (torch.float32, np.dtype("<f4")),
    "F16": (torch.float16, np.dtype("<f2")),
    "BF16": (torch.bfloat16, np.dtype("<i2")),
    "I64": (torch.int64, np.dtype("<i8")),
    "I32": (torch.int32, np.dtype("<i4")),
    "I16": (torch.int16, np.dtype("<i2")),
    "I8": (torch.int8, np.dtype("i1")),
    "U8": (torch.uint8, np.dtype("u1")),
    "BOOL": (torch.bool, np.dtype("?")),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}
_ALIGN = 8  # the header is padded with spaces to this many bytes


def _as_tensor(value: Any) -> torch.Tensor:
    """A contiguous CPU tensor holding ``value`` (a tensor on any device, or
    a numpy array; numpy bfloat16 from ml_dtypes is taken by its bits)."""
    if isinstance(value, torch.Tensor):
        return value.detach().contiguous().cpu()
    arr = np.require(value, requirements="C")  # keeps 0-d arrays 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy() if not arr.flags.writeable else arr)


def _raw(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a numpy array (bf16 as int16 bits)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def save_file(tensors: Mapping[str, Any], path: "str | Path",
              metadata: "Mapping[str, str] | None" = None) -> Path:
    """Write ``tensors`` (name -> tensor or numpy array) to ``path``.

    Tensors are copied to the host one at a time as they are written, so a
    map of device tensors never needs its whole size in host memory."""
    specs: dict[str, Any] = {}
    offset = 0
    order = list(tensors)
    for name in order:
        t = tensors[name]
        dtype = t.dtype if isinstance(t, torch.Tensor) else _as_tensor(t).dtype
        if dtype not in _NAMES:
            raise TypeError(f"{name!r}: dtype {dtype} has no SafeTensors name")
        shape = list(t.shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        specs[name] = {"dtype": _NAMES[dtype], "shape": shape,
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    header = dict(specs)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * ((-len(raw)) % _ALIGN)
    path = Path(path)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = _as_tensor(tensors[name])
            if list(t.shape) != specs[name]["shape"]:
                raise ValueError(f"{name!r} changed shape while being written")
            f.write(memoryview(_raw(t).reshape(-1)).cast("B"))
    return path


def read_header(path: "str | Path") -> tuple:
    """``(header dict without __metadata__, metadata dict, data start)``."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a SafeTensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
        if len(raw) != n:
            raise ValueError(f"{path}: truncated SafeTensors header")
    header = json.loads(raw)
    metadata = header.pop("__metadata__", {}) or {}
    return header, metadata, 8 + n


def load_file(path: "str | Path", names: "Iterable[str] | None" = None) -> dict:
    """Read ``path`` into ``{name: CPU tensor}`` in file order, or only
    ``names`` (a missing name raises KeyError)."""
    header, _meta, start = read_header(path)
    wanted = list(header) if names is None else list(names)
    missing = [n for n in wanted if n not in header]
    if missing:
        raise KeyError(f"{path}: no tensors {missing}")
    out: dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        for name in wanted:
            spec = header[name]
            if spec["dtype"] not in _DTYPES:
                raise TypeError(f"{path}: {name!r} has unsupported dtype {spec['dtype']}")
            tdtype, ndtype = _DTYPES[spec["dtype"]]
            begin, end = spec["data_offsets"]
            f.seek(start + begin)
            buf = bytearray(end - begin)
            if f.readinto(buf) != end - begin:
                raise ValueError(f"{path}: {name!r} is truncated")
            arr = np.frombuffer(buf, dtype=ndtype).reshape(spec["shape"])
            t = torch.from_numpy(arr)
            out[name] = t.view(torch.bfloat16) if tdtype == torch.bfloat16 else t
    return out


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """A nested dict of tensors -> ``{"a/b/c": leaf}`` (the JAX package's
    ``flatten_tree`` names for dict trees)."""
    flat: dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten(value, name + "/"))
        elif name in flat:
            raise ValueError(f"duplicate tensor name {name!r}")
        else:
            flat[name] = value
    return flat


def unflatten(flat: Mapping[str, Any]) -> dict:
    """The inverse of :func:`flatten`."""
    tree: dict[str, Any] = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"{name!r} nests under a leaf")
        if leaf in node:
            raise ValueError(f"duplicate tensor name {name!r}")
        node[leaf] = value
    return tree
