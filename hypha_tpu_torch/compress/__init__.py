"""Compressed delta transport for the DiLoCo outer round (counterpart of
``hypha_tpu/compress/__init__.py``).

Each end of the outer sync ships its tensors in the job's wire codec:
"none" ships f32 SafeTensors, "bf16" casts to bfloat16 SafeTensors (the
older ``delta_dtype`` behaviour), and the quantized pair ship HQD1 frames
of chunkwise int8 / packed int4 with per-chunk f32 scales, with an
error-feedback residual on both ends so the compressed trajectory tracks
the uncompressed one.

  * :mod:`quant`    -- ``quantize`` / ``dequantize``, torch operations on
    the tensor's device, byte-equal to the reference's numpy path;
  * :mod:`frame`    -- the HQD1 container, ``write_delta`` / ``read_delta``;
  * :mod:`feedback` -- :class:`ErrorFeedback`.

The per-link codec ladder (``codec_for_bandwidth``, ``adaptive_codec``)
is not ported (ROADMAP.md, Queue 1: sharded PS/FT/rejoin).
"""

from __future__ import annotations

from .feedback import ErrorFeedback
from .frame import (MAGIC, frame_header, frame_tag, is_frame, read_delta, read_frame, write_delta,
                    write_frame)
from .quant import DEFAULT_CHUNK, dequantize, quantize

__all__ = [
    "CODECS", "QUANT_CODECS", "DEFAULT_CHUNK", "MAGIC", "ErrorFeedback", "effective_codec",
    "quantize", "dequantize", "write_frame", "read_frame", "read_delta", "write_delta",
    "is_frame", "frame_header", "frame_tag",
]

# Every per-job wire codec.
CODECS = ("none", "bf16", "int8", "int4")

# Codecs that quantize (and therefore keep error feedback).
QUANT_CODECS = ("int8", "int4")


def effective_codec(delta_codec: str, delta_dtype: str = "float32") -> str:
    """The job's wire codec: ``delta_codec`` unless it is "none", in which
    case the legacy ``delta_dtype="bfloat16"`` still selects bf16."""
    if delta_codec not in CODECS:
        raise ValueError(f"delta_codec must be one of {'|'.join(CODECS)}, got {delta_codec!r}")
    if delta_codec == "none" and delta_dtype == "bfloat16":
        return "bf16"
    return delta_codec
