"""Measured-link estimates (counterpart of the ``Ewma`` and ``LinkTable``
of ``hypha_tpu/ft/adaptive.py``).

The serving plane keeps one :class:`LinkTable` per serving job: each fleet
pull feeds it the chain's bytes and the RPC's seconds, and the pull
pre-check and the migration policy compare its estimate with the pool's
measured prefill rate (transfer against recompute). The table's other
consumer in the reference, per-link delta codecs on the parameter server
(``adaptive_codec``), is not ported: :meth:`LinkTable.codec_for` raises
naming its label. The straggler controller is not ported either.
"""

from __future__ import annotations

__all__ = ["Ewma", "LinkTable"]


class Ewma:
    """Exponentially weighted moving average; None until the first sample."""

    __slots__ = ("alpha", "_value")

    def __init__(self, alpha: float = 0.4) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError("ewma alpha must be in (0, 1]")
        self.alpha = alpha
        self._value: "float | None" = None

    def update(self, sample: float) -> float:
        if self._value is None:
            self._value = float(sample)
        else:
            self._value = self.alpha * float(sample) + (1.0 - self.alpha) * self._value
        return self._value

    @property
    def value(self) -> "float | None":
        return self._value


class LinkTable:
    """Per-peer EWMA (the reference's alpha, 0.4) of measured bandwidth, in
    bits per second."""

    def __init__(self) -> None:
        self._bw: dict = {}

    def observe(self, peer: str, nbytes: int, seconds: float) -> float:
        """Record one measured transfer; returns the updated bits/s EWMA."""
        bps = (max(int(nbytes), 1) * 8.0) / max(float(seconds), 1e-6)
        return self._bw.setdefault(peer, Ewma()).update(bps)

    def bandwidth_bps(self, peer: str) -> "float | None":
        """The peer's estimate; None until its first transfer."""
        est = self._bw.get(peer)
        return est.value if est is not None else None

    def codec_for(self, peer: str) -> str:
        raise NotImplementedError(
            "per-link delta codecs (adaptive_codec) are not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1: sharded PS/FT/rejoin)"
        )
