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

``codec_for_bandwidth`` is the per-link codec ladder of ``adaptive_codec``
(``ft/adaptive.py``'s ``LinkTable``).
"""

from __future__ import annotations

from ..lazy import exports

# Each name's submodule, imported on first use (``lazy.exports``): they
# import torch, and the job's options (``CODECS``, ``codec_for_bandwidth``)
# are read by processes that hold no tensor (the node CLI, a training job's
# scheduler).
_SUBMODULE = {
    "ErrorFeedback": "feedback",
    **dict.fromkeys(("MAGIC", "frame_header", "frame_tag", "is_frame", "read_delta", "read_frame",
                     "write_delta", "write_frame"), "frame"),
    **dict.fromkeys(("DEFAULT_CHUNK", "dequantize", "quantize"), "quant"),
}

__getattr__ = exports(__name__, _SUBMODULE)
__all__ = ["CODECS", "QUANT_CODECS", "effective_codec", "codec_for_bandwidth", *_SUBMODULE]

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


# Bits each codec ships per f32 parameter: the order ``codec_for_bandwidth``
# degrades along (it never ships more bits than the job's base codec).
_CODEC_BITS = {"none": 32, "bf16": 16, "int8": 8, "int4": 4}


def codec_for_bandwidth(bps: float, base: str, hi_bps: float, lo_bps: float) -> str:
    """Per-link codec for a measured bandwidth: ``bps >= hi_bps`` keeps the
    base codec, below it int8, below ``lo_bps`` int4, never more bits than
    the base asks for."""
    if base not in CODECS:
        raise ValueError(f"base codec must be one of {'|'.join(CODECS)}, got {base!r}")
    if bps >= hi_bps:
        return base
    pick = "int8" if bps >= lo_bps else "int4"
    if _CODEC_BITS[pick] >= _CODEC_BITS[base]:
        return base
    return pick
