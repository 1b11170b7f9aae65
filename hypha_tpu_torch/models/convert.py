"""Weights carried across between the JAX package and the port.

The JAX package names parameters by their flat tree path
(``hypha_tpu.executor.serialization.flatten_tree``):
``params/layers_{i}/self_attn/q_proj/kernel``, ``params/embed_tokens``,
``params/layers_{i}/input_layernorm/weight``,
``params/layers_{i}/self_attn/q_norm``. The port's modules carry the same
names in PyTorch spelling (``layers.{i}.self_attn.q_proj.weight``), so the
mapping is mechanical. Flax ``Dense`` kernels are ``[in, out]`` and
``nn.Linear`` weights ``[out, in]``: every ``kernel`` transposes (the
projections ``hypha_tpu/models/convert.py:82-124`` marks as transposing);
embeddings, the ``[vocab, hidden]`` head, norms and biases do not.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["llama_params_from_flat", "llama_params_to_flat", "flat_to_state", "state_to_flat"]


def _torch_name(flat_name: str) -> tuple:
    """Flat JAX name -> (state_dict name, transpose?)."""
    parts = []
    for p in flat_name.removeprefix("params/").split("/"):
        m = re.fullmatch(r"layers_(\d+)", p)
        parts += ["layers", m.group(1)] if m else [p]
    transpose = parts[-1] == "kernel"
    if transpose:
        parts[-1] = "weight"
    return ".".join(parts), transpose


def _flat_name(torch_name: str, linear: bool) -> str:
    """state_dict name -> flat JAX name (inverse of :func:`_torch_name`)."""
    name = re.sub(r"layers\.(\d+)", r"layers_\1", torch_name)
    if linear and name.endswith(".weight"):
        name = name.removesuffix(".weight") + ".kernel"
    return "params/" + name.replace(".", "/")


def _linear_weights(model) -> set:
    return {
        f"{name}.weight"
        for name, mod in model.named_modules()
        if isinstance(mod, torch.nn.Linear)
    }


@torch.no_grad()
def llama_params_from_flat(flat: dict, model):
    """Load ``flat`` (name -> numpy array, as ``flatten_tree`` gives them,
    with or without the ``params/`` head) into ``model`` in place, in the
    model's parameter dtype. Every parameter must be covered and every
    name must map; returns ``model``."""
    state = model.state_dict()
    loaded = set()
    for name, arr in flat.items():
        tname, transpose = _torch_name(name)
        if tname not in state:
            raise KeyError(f"{name!r} has no counterpart {tname!r} in {type(model).__name__}")
        if isinstance(arr, torch.Tensor):
            t = arr
        else:
            a = np.asarray(arr)
            if a.dtype.name == "bfloat16":  # ml_dtypes; numpy-to-torch needs f32
                a = a.astype(np.float32)
            t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
        if transpose:
            t = t.T
        dst = state[tname]
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{name!r}: shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.copy_(t.to(dst.dtype))
        loaded.add(tname)
    missing = sorted(set(state) - loaded)
    if missing:
        raise KeyError(f"flat weights miss {len(missing)} parameters, e.g. {missing[:3]}")
    return model


@torch.no_grad()
def llama_params_to_flat(model) -> dict:
    """The inverse: ``{flat JAX name: numpy array}`` in the reference's
    orientation (bf16 parameters come out as f32, exactly)."""
    out = {}
    for name, p in state_to_flat(model, model.state_dict()).items():
        a = p.detach().float().cpu() if p.dtype == torch.bfloat16 else p.detach().cpu()
        out[name] = np.ascontiguousarray(a.numpy())
    return out


def state_to_flat(model, state) -> dict:
    """``{state_dict name: tensor}`` (any subset of ``model``'s, e.g. a
    pseudo-gradient) -> ``{flat JAX name: tensor}`` in the reference's
    orientation. Kernels come out as transposed views, not copies."""
    linear = _linear_weights(model)
    return {_flat_name(t, t in linear): (v.T if t in linear else v) for t, v in state.items()}


def flat_to_state(flat) -> dict:
    """``{flat JAX name: tensor}`` -> ``{state_dict name: tensor}``, kernels
    transposed back (as views)."""
    out = {}
    for name, t in flat.items():
        tname, transpose = _torch_name(name)
        out[tname] = t.T if transpose else t
    return out
