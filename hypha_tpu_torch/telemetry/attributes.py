"""Attribute-string parsing (port of ``hypha_tpu/telemetry/attributes.py``).

``service.name=scheduler,deployment=prod`` → dict. Values keep their
string form (OTLP resource attributes are stringly typed at this layer).
"""

from __future__ import annotations

__all__ = ["parse_attributes"]


def parse_attributes(raw: str | None) -> dict[str, str]:
    out: dict[str, str] = {}
    if not raw:
        return out
    for pair in raw.split(","):
        pair = pair.strip()
        if not pair:
            continue
        key, sep, value = pair.partition("=")
        if not sep or not key.strip():
            raise ValueError(f"bad attribute {pair!r}: want key=value")
        out[key.strip()] = value.strip()
    return out
