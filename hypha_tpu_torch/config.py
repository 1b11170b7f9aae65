"""Layered configuration with provenance, validation and documented emit
(a copy of ``hypha_tpu/config.py``, which imports only the standard
library).

Behavioral parity with the reference's ``hypha-config`` crate
(crates/config/src/lib.rs): a builder layering

    dataclass defaults ← TOML file ← HYPHA_* env ← CLI overrides

(figment layering, crates/scheduler/src/bin/hypha-scheduler.rs:537-543),
a ``ConfigWithMetadata`` wrapper that remembers **which layer set every
key** so errors point at the exact file/env/flag source (miette-style
``find_metadata``, lib.rs:418-436), a ``validate()`` hook (lib.rs:438-451)
and a doc-comment-preserving TOML emitter for ``init`` (``to_toml``,
lib.rs:544). ``TLSConfig`` keeps the reference's credential keys.

Config schemas are plain dataclasses; field docs come from
``field(metadata={"doc": ...})`` and nested sections from nested
dataclasses.
"""

from __future__ import annotations

import os

import tomllib
import typing
from dataclasses import MISSING, dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, TypeVar

# HYPHA_* variables that configure the process, not a node: the env layer
# passes over them.
_PROCESS_ENV = frozenset({"HYPHA_TRACE_DIR", "HYPHA_TRACE_NODE"})

__all__ = [
    "ConfigError",
    "Provenance",
    "ConfigWithMetadata",
    "LayeredConfigBuilder",
    "builder",
    "to_toml",
    "TLSConfig",
]

T = TypeVar("T")


class ConfigError(ValueError):
    """A config problem, pointing at the layer that caused it."""

    def __init__(self, message: str, provenance: "Provenance | None" = None) -> None:
        if provenance is not None:
            message = f"{message} (set by {provenance.source})"
        super().__init__(message)
        self.provenance = provenance


@dataclass(frozen=True, slots=True)
class Provenance:
    """Where a key's value came from (lib.rs ConfigWithMetadata metadata)."""

    key: str  # dotted path, e.g. "offer.price"
    source: str  # "default" | "file:<path>" | "env:<VAR>" | "cli"


@dataclass
class TLSConfig:
    """Credential file locations (lib.rs:464-540 TLSConfig).

    PeerID is derived from the certificate key (rfc/2025-05-30_mtls.md);
    the CLI builds an mTLS node (``network.secure.secure_node``) from a
    section with cert, key and trust set.
    """

    cert: str = field(default="", metadata={"doc": "node certificate chain (PEM)"})
    key: str = field(default="", metadata={"doc": "node private key (PEM)"})
    trust: str = field(default="", metadata={"doc": "trusted root CA (PEM)"})
    crls: str = field(default="", metadata={"doc": "certificate revocation lists (PEM), optional"})

    def enabled(self) -> bool:
        return bool(self.cert and self.key and self.trust)

    def validate_files(self) -> None:
        for name in ("cert", "key", "trust"):
            p = getattr(self, name)
            if p and not Path(p).is_file():
                raise ConfigError(f"tls.{name}: no such file {p!r}")
        if self.crls and not Path(self.crls).is_file():
            raise ConfigError(f"tls.crls: no such file {self.crls!r}")


# --------------------------------------------------------------------------
# dict <-> dataclass with provenance
# --------------------------------------------------------------------------


def _type_hints(cls) -> dict[str, Any]:
    return typing.get_type_hints(cls)


def _coerce(value: Any, hint: Any, key: str, source: str) -> Any:
    """Coerce a layered raw value to the field's annotated type."""
    origin = typing.get_origin(hint)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0], key, source) if len(args) == 1 else value
    if is_dataclass(hint):
        if not isinstance(value, dict):
            raise ConfigError(
                f"{key}: expected a table for {hint.__name__}, got {type(value).__name__}",
                Provenance(key, source),
            )
        return _build_dataclass(hint, value, source, prefix=key + ".")[0]
    if hint is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("1", "true", "yes", "on"):
                return True
            if value.lower() in ("0", "false", "no", "off"):
                return False
        raise ConfigError(f"{key}: not a bool: {value!r}", Provenance(key, source))
    if hint is int:
        try:
            return int(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{key}: not an int: {value!r}", Provenance(key, source))
    if hint is float:
        try:
            return float(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{key}: not a float: {value!r}", Provenance(key, source))
    if hint is str:
        return str(value)
    if origin in (list, tuple):
        if isinstance(value, str):
            value = [v.strip() for v in value.split(",") if v.strip()]
        args = typing.get_args(hint)
        inner = args[0] if args else str
        return [_coerce(v, inner, f"{key}[]", source) for v in value]
    if origin is dict or hint is dict:
        # Plain-dict fields (free-form tables): strip the layering tags that
        # _tag_layer attached to what it thought were config leaves.
        return _untag(value)
    return value


def _untag(value: Any) -> Any:
    if isinstance(value, tuple) and len(value) == 2 and isinstance(value[1], str):
        return _untag(value[0])
    if isinstance(value, dict):
        return {k: _untag(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_untag(v) for v in value]
    return value


def _build_dataclass(
    cls, data: dict, source: str, prefix: str = ""
) -> tuple[Any, dict[str, Provenance]]:
    hints = _type_hints(cls)
    kwargs: dict[str, Any] = {}
    meta: dict[str, Provenance] = {}
    known = {f.name for f in fields(cls)}
    for k in data:
        if k not in known:
            raise ConfigError(
                f"unknown config key {prefix}{k!r} (known: {sorted(known)})",
                Provenance(prefix + k, source),
            )
    for f in fields(cls):
        key = prefix + f.name
        if f.name in data:
            raw = data[f.name]
            src = source
            if isinstance(raw, tuple) and len(raw) == 2 and isinstance(raw[1], str):
                raw, src = raw  # (value, source) pair from env/cli layering
            hint = hints[f.name]
            hint_dc = hint
            if typing.get_origin(hint) is typing.Union:
                args = [a for a in typing.get_args(hint) if a is not type(None)]
                hint_dc = args[0] if len(args) == 1 else hint
            if is_dataclass(hint_dc) and isinstance(raw, dict):
                value, sub = _build_dataclass(hint_dc, raw, src, prefix=key + ".")
                kwargs[f.name] = value
                meta.update(sub)
            else:
                kwargs[f.name] = _coerce(raw, hint, key, src)
            meta[key] = Provenance(key, src)
        elif f.default is not MISSING or f.default_factory is not MISSING:  # type: ignore[misc]
            meta[key] = Provenance(key, "default")
            hint = hints[f.name]
            if is_dataclass(hint):
                meta.update(_default_meta(hint, key + "."))
        else:
            raise ConfigError(f"missing required config key {key!r}")
    try:
        return cls(**kwargs), meta
    except (TypeError, ValueError) as e:
        raise ConfigError(f"{prefix or cls.__name__}: {e}") from e


def _default_meta(cls, prefix: str) -> dict[str, Provenance]:
    """Provenance entries for every key of an all-default section."""
    meta: dict[str, Provenance] = {}
    hints = _type_hints(cls)
    for f in fields(cls):
        key = prefix + f.name
        meta[key] = Provenance(key, "default")
        if is_dataclass(hints[f.name]):
            meta.update(_default_meta(hints[f.name], key + "."))
    return meta


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------------
# builder
# --------------------------------------------------------------------------


class ConfigWithMetadata(typing.Generic[T]):
    """The built config plus per-key provenance (lib.rs:403-451)."""

    def __init__(self, value: T, metadata: dict[str, Provenance]) -> None:
        self.value = value
        self.metadata = metadata

    def find_metadata(self, key: str) -> Provenance | None:
        return self.metadata.get(key)

    def validate(self) -> "ConfigWithMetadata[T]":
        """Run the schema's ``validate()`` hook, wrapping failures with the
        offending key's provenance when the hook names one."""
        hook = getattr(self.value, "validate", None)
        if callable(hook):
            try:
                hook()
            except ConfigError:
                raise
            except (TypeError, ValueError) as e:
                key = getattr(e, "config_key", None)
                raise ConfigError(str(e), self.metadata.get(key)) from e
        return self


class LayeredConfigBuilder(typing.Generic[T]):
    """TOML ← HYPHA_* env ← OTEL_* env ← CLI overrides (figment layering)."""

    def __init__(self, cls: type[T]) -> None:
        self._cls = cls
        self._layers: list[tuple[dict, str]] = []

    def with_toml(self, path: str | Path) -> "LayeredConfigBuilder[T]":
        p = Path(path)
        try:
            data = tomllib.loads(p.read_text())
        except FileNotFoundError:
            raise ConfigError(f"config file not found: {p}")
        except tomllib.TOMLDecodeError as e:
            raise ConfigError(f"invalid TOML in {p}: {e}")
        self._layers.append((data, f"file:{p}"))
        return self

    def with_env(self, prefix: str = "HYPHA_") -> "LayeredConfigBuilder[T]":
        """``HYPHA_OFFER__PRICE=2.5`` sets ``offer.price`` (double underscore
        separates nesting; single underscores stay inside key names). The
        trace switch (``HYPHA_TRACE_DIR``, ``HYPHA_TRACE_NODE``, read by
        ``telemetry.trace``) is no config key and is passed over, so a node
        started by the CLI can trace through its environment (the
        reference's builder refuses it as an unknown key)."""
        data: dict = {}
        for var, raw in os.environ.items():
            if not var.startswith(prefix) or var == prefix or var in _PROCESS_ENV:
                continue
            path = [p.lower() for p in var[len(prefix):].split("__")]
            node = data
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = (raw, f"env:{var}")
        if data:
            self._layers.append((data, "env"))
        return self

    def with_overrides(
        self, overrides: dict, source: str = "cli"
    ) -> "LayeredConfigBuilder[T]":
        """Dotted keys allowed: {"offer.price": 2.0}."""
        data: dict = {}
        for k, v in overrides.items():
            if v is None:
                continue
            node = data
            parts = k.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = (v, source)
        if data:
            self._layers.append((data, source))
        return self

    def build(self) -> ConfigWithMetadata[T]:
        merged: dict = {}
        for data, _source in self._layers:
            merged = _deep_merge(merged, _tag_layer(data, _source))
        value, meta = _build_dataclass(self._cls, merged, "merged")
        return ConfigWithMetadata(value, meta)


def _tag_layer(data: dict, source: str) -> dict:
    """Attach the layer's source to every leaf (unless already tagged)."""
    out: dict = {}
    for k, v in data.items():
        if isinstance(v, dict):
            out[k] = _tag_layer(v, source)
        elif isinstance(v, tuple) and len(v) == 2 and isinstance(v[1], str):
            out[k] = v
        else:
            out[k] = (v, source)
    return out


def builder(cls: type[T]) -> LayeredConfigBuilder[T]:
    return LayeredConfigBuilder(cls)


# --------------------------------------------------------------------------
# documented TOML emitter (lib.rs to_toml)
# --------------------------------------------------------------------------


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise ConfigError(f"cannot emit TOML for {type(v).__name__}: {v!r}")


def to_toml(config: Any, _prefix: str = "") -> str:
    """Emit a config instance as TOML with each field's doc as a comment —
    what ``init`` writes so operators get a self-describing file."""
    if not is_dataclass(config):
        raise ConfigError("to_toml needs a dataclass instance")
    lines: list[str] = []
    tables: list[str] = []
    for f in fields(config):
        v = getattr(config, f.name)
        doc = f.metadata.get("doc")
        if is_dataclass(v):
            name = f"{_prefix}{f.name}"
            sub = to_toml(v, _prefix=name + ".")
            header = []
            if doc:
                header.append(f"# {doc}")
            header.append(f"[{name}]")
            tables.append("\n".join(header) + "\n" + sub)
            continue
        if v is None or (isinstance(v, dict) and not v):
            if doc:
                lines.append(f"# {doc}")
            lines.append(f"# {f.name} = ...")
            continue
        if isinstance(v, dict):
            tables.append(
                f"[{_prefix}{f.name}]\n"
                + "\n".join(f"{k} = {_toml_value(x)}" for k, x in v.items())
                + "\n"
            )
            continue
        if doc:
            lines.append(f"# {doc}")
        lines.append(f"{f.name} = {_toml_value(v)}")
    body = "\n".join(lines)
    if body:
        body += "\n"
    return body + ("\n" if body and tables else "") + "\n".join(tables)
