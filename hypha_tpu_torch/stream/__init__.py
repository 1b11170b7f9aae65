"""Outer-sync helpers of the port (counterpart of ``hypha_tpu/stream``):
the parameter server's streaming sample-weighted fold, ``RoundAccum``."""

from .accum import RoundAccum

__all__ = ["RoundAccum"]
