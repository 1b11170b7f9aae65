"""Model registry (counterpart of ``hypha_tpu/models/registry.py``) for the
Llama lineage: Llama, Mistral, Qwen2, Qwen3 and Gemma are all ``Llama``
under config toggles. The spec names its ``family`` explicitly; other
families are not ported yet (ROADMAP.md, Queue 1).

A model spec: ``{"family": ..., "preset": "tiny" | "llama2-7b",
"hf_config": {...config.json...}, "config": {...overrides...}}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .llama import Llama, LlamaConfig

__all__ = ["build_model", "FAMILIES"]

_PRESETS = {"llama": {"tiny": LlamaConfig.tiny, "llama2-7b": LlamaConfig.llama2_7b}}

FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "gemma")

# Architecture toggles implied by the family name.
_FAMILY_DEFAULTS: dict = {
    "qwen2": {"attn_bias": True},
    "qwen3": {"qk_norm": True},
    "gemma": {
        "mlp_act": "gelu_tanh",
        "rms_offset": True,
        "embed_scale": True,
        "tie_word_embeddings": True,
    },
}


def build_model(spec: dict[str, Any], device=None, attn_impl=None) -> tuple:
    """Build ``(module, config)`` from a model spec. Parameters are
    allocated on ``device`` (CUDA by default) but not initialized;
    ``attn_impl`` replaces the training forward's plain attention."""
    family = spec.get("family")
    if family is None:
        raise ValueError("the model spec must name its 'family'")
    if family not in FAMILIES:
        raise NotImplementedError(
            f"model family {family!r} is not ported to PyTorch yet "
            f"(ported: {', '.join(FAMILIES)}); see ROADMAP.md, Queue 1"
        )
    preset = spec.get("preset")
    hf_config = spec.get("hf_config")
    if preset is not None:
        presets = _PRESETS.get(family, {})
        if preset not in presets:
            raise KeyError(
                f"unknown preset {preset!r} for family {family!r} "
                f"(have {sorted(presets) or 'none'})"
            )
        cfg = presets[preset]()
    elif hf_config is not None:
        hf = dict(hf_config)
        hf.setdefault("model_type", family)
        cfg = LlamaConfig.from_hf(hf)
    else:
        cfg = LlamaConfig()
    # Family defaults fill gaps only when no checkpoint config drove the
    # build: from_hf already derives the toggles from config.json.
    base = {} if hf_config is not None else _FAMILY_DEFAULTS.get(family, {})
    overrides = {**base, **(spec.get("config") or {})}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return Llama(cfg, device=device, attn_impl=attn_impl), cfg
