"""Model registry (counterpart of ``hypha_tpu/models/registry.py``) for the
Llama lineage and Mixtral: Llama, Mistral, Qwen2, Qwen3 and Gemma are all
``Llama`` under config toggles; ``mixtral`` is ``models/mixtral.py``. The
spec names its ``family`` explicitly; other families, and the reference's
choice of one from ``model_type`` when the spec names none, are not ported
yet (ROADMAP.md, Queue 1).

A model spec: ``{"family": ..., "preset": "tiny" | "llama2-7b" | "8x7b",
"hf_config": {...config.json...}, "config": {...overrides...}}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .llama import Llama, LlamaConfig
from .mixtral import Mixtral, MixtralConfig

__all__ = ["build_model", "FAMILIES"]

_PRESETS = {
    "llama": {"tiny": LlamaConfig.tiny, "llama2-7b": LlamaConfig.llama2_7b},
    "mixtral": {"tiny": MixtralConfig.tiny, "8x7b": MixtralConfig.mixtral_8x7b},
}

FAMILIES = {
    "llama": (Llama, LlamaConfig),
    "mistral": (Llama, LlamaConfig),
    "qwen2": (Llama, LlamaConfig),
    "qwen3": (Llama, LlamaConfig),
    "gemma": (Llama, LlamaConfig),
    "mixtral": (Mixtral, MixtralConfig),
}

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
        # The reference picks a family from model_type (causal LM -> GPT-2).
        raise NotImplementedError(
            "a model spec without 'family' builds GPT-2 in the JAX package, which is "
            "not ported yet (ROADMAP.md, Queue 1: model families)"
        )
    if family not in FAMILIES:
        raise NotImplementedError(
            f"model family {family!r} is not ported to PyTorch yet "
            f"(ported: {', '.join(FAMILIES)}); see ROADMAP.md, Queue 1"
        )
    module_cls, config_cls = FAMILIES[family]
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
    elif hf_config is not None and hasattr(config_cls, "from_hf"):
        hf = dict(hf_config)
        hf.setdefault("model_type", family)
        cfg = config_cls.from_hf(hf)
    else:  # MixtralConfig has no from_hf: its defaults, then the overrides
        cfg = config_cls()
    # Family defaults fill gaps only when no checkpoint config drove the
    # build: from_hf already derives the toggles from config.json.
    base = {} if hf_config is not None else _FAMILY_DEFAULTS.get(family, {})
    overrides = {**base, **(spec.get("config") or {})}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return module_cls(cfg, device=device, attn_impl=attn_impl), cfg
