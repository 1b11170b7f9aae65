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
LoRA adapters (``q_proj_lora_a`` [in, r], ``q_proj_lora_b`` [r, out]) keep
the JAX layout in both and map by name alone.

Mixtral's stacked experts (``layers.{i}.moe.w_gate`` ``[E, D, F]``,
``w_up``, ``w_down`` ``[E, F, D]``) are raw parameters in the flax layout
and map by name alone, with no transpose; its router is an ``nn.Linear``
(``moe/gate/kernel``) and transposes like every kernel.

HF-format checkpoints of the Llama lineage and Mixtral (the counterpart of
``hypha_tpu/models/convert.py``): :func:`convert_state_dict` maps a whole
state dict in HF names (``model.layers.0.self_attn.q_proj.weight``) onto
the port's ``state_dict`` names, and :func:`convert_checkpoint` streams a
checkpoint file, directory or ``.index.json`` tensor by tensor
(:class:`ShardedCheckpoint`, through the port's own SafeTensors reader).
HF ``Linear`` weights are ``[out, in]``, as the port's are, so nothing
transposes but Mixtral's experts: HF stores them as separate
``experts.{e}.w1|w2|w3`` Linears, which :class:`_Stacker` transposes and
stacks into ``[E, ...]`` once an expert stack is whole. A Llama-lineage
checkpoint without ``lm_head.weight`` (tied embeddings) into an untied
model gets its head from the embeddings. Checkpoints carry the base only:
a LoRA model's adapters are not among the names a conversion must cover.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..executor.lora import is_lora
from ..executor.serialization import load_file, read_header

__all__ = ["llama_params_from_flat", "llama_params_to_flat", "flat_to_state", "state_to_flat",
           "flat_names", "HF_CONVERTERS", "convert_state_dict", "convert_checkpoint",
           "load_checkpoint_files", "ShardedCheckpoint", "base_names", "load_state", "hf_state_dict"]

log = logging.getLogger("hypha.torch.models.convert")


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


def base_names(model) -> list:
    """``model``'s ``state_dict`` names without its LoRA adapters: what a
    checkpoint of the base must cover."""
    return [n for n in model.state_dict() if not is_lora(n)]


@torch.no_grad()
def llama_params_from_flat(flat: dict, model, *, base_only: bool = False):
    """Load ``flat`` (name -> numpy array, as ``flatten_tree`` gives them,
    with or without the ``params/`` head) into ``model`` in place, in the
    model's parameter dtype. Every parameter must be covered (with
    ``base_only``, every one but the LoRA adapters, which keep their
    values and skip any adapter in ``flat``) and every name must map;
    returns ``model``."""
    state = model.state_dict()
    loaded = set()
    for name, arr in flat.items():
        tname, transpose = _torch_name(name)
        if base_only and is_lora(tname):
            continue  # the adapters keep their init, as the reference's do
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
    missing = sorted(set(base_names(model) if base_only else state) - loaded)
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


def flat_names(model) -> dict:
    """``{flat JAX name without the params/ head: (parameter name,
    transposed?)}`` for every parameter of ``model``: where a wire tensor
    of that name lands, and whether its layout is the transpose."""
    linear = _linear_weights(model)
    return {_flat_name(t, t in linear).removeprefix("params/"): (t, t in linear)
            for t, _ in model.named_parameters()}


# ------------------------------------------------- HF-format checkpoints


def _llama_key(key: str) -> "str | None":
    """HF Llama name -> the port's ``state_dict`` name, or None to skip
    (the reference's ``_llama_key``, whose flat names the port spells as
    ``state_dict`` names)."""
    key = key.removeprefix("model.")
    if key in ("embed_tokens.weight", "lm_head.weight"):
        return key.removesuffix(".weight")
    if key == "norm.weight":
        return key
    if key.endswith("rotary_emb.inv_freq"):
        return None  # recomputed
    m = re.fullmatch(r"layers\.(\d+)\.(.+)", key)
    if m is None:
        return None
    i, rest = m.group(1), m.group(2)
    if rest in ("input_layernorm.weight", "post_attention_layernorm.weight"):
        return f"layers.{i}.{rest}"
    if re.fullmatch(r"(self_attn|mlp)\.\w+_proj\.weight", rest):
        return f"layers.{i}.{rest}"
    raise KeyError(f"unmapped llama tensor {key!r}")


def _qwen2_key(key: str) -> "str | None":
    """Qwen2 is the Llama architecture plus q/k/v projection biases."""
    m = re.fullmatch(r"model\.layers\.(\d+)\.self_attn\.([qkv]_proj)\.bias", key)
    if m is not None:
        return f"layers.{m.group(1)}.self_attn.{m.group(2)}.bias"
    return _llama_key(key)


def _qwen3_key(key: str) -> "str | None":
    """Qwen3 adds per-head QK-norm weights (1-D) and drops the biases."""
    m = re.fullmatch(r"model\.layers\.(\d+)\.self_attn\.([qk]_norm)\.weight", key)
    if m is not None:
        return f"layers.{m.group(1)}.self_attn.{m.group(2)}"
    return _llama_key(key)


class StackSlot(NamedTuple):
    """A mapper's answer for one expert's slice of a stacked tensor: the
    stack's ``state_dict`` name, the expert index, and whether the HF
    ``[out, in]`` slice transposes into the stack's layout."""

    name: str
    index: int
    transpose: bool


# HF Mixtral's expert Linears: w1 the gate projection and w3 the up
# projection ([F, D] -> [D, F]), w2 the down projection ([D, F] -> [F, D]).
_EXPERT_NAMES = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}


def _mixtral_key(key: str):
    """HF Mixtral name -> ``state_dict`` name, a :class:`StackSlot`, or
    None (the reference's ``_mixtral_key``)."""
    m = re.fullmatch(r"model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight",
                     key)
    if m is not None:
        i, e, w = m.group(1), int(m.group(2)), m.group(3)
        return StackSlot(f"layers.{i}.moe.{_EXPERT_NAMES[w]}", e, True)
    m = re.fullmatch(r"model\.layers\.(\d+)\.block_sparse_moe\.gate\.weight", key)
    if m is not None:  # the router Linear, [E, D] in both
        return f"layers.{m.group(1)}.moe.gate.weight"
    return _llama_key(key)  # attention, norms, embeddings and head are Llama's


class _Stacker:
    """Expert slices gathered into ``[E, ...]`` stacks. With ``expected``
    counts (from the model's stacks) a stack is returned as soon as its
    last slice arrives, so a streaming conversion holds one layer's
    experts; without them, stacks are finished at the end."""

    def __init__(self, expected: "dict | None" = None) -> None:
        self._slices: dict = {}
        self._expected = expected or {}

    def add(self, slot: StackSlot, t: torch.Tensor):
        got = self._slices.setdefault(slot.name, {})
        if slot.index in got:
            raise KeyError(f"duplicate expert slice {slot.index} for {slot.name}")
        got[slot.index] = t.T if slot.transpose else t
        if len(got) == self._expected.get(slot.name):
            del self._slices[slot.name]
            return slot.name, self._stack(slot.name, got)
        return None

    @staticmethod
    def _stack(name: str, got: dict) -> torch.Tensor:
        if sorted(got) != list(range(len(got))):
            raise KeyError(f"{name}: expert indices {sorted(got)} are not contiguous")
        return torch.stack([got[i] for i in range(len(got))])

    def finalize(self):
        for name, got in self._slices.items():
            yield name, self._stack(name, got)
        self._slices.clear()


def hf_state_dict(state: dict) -> dict:
    """The inverse of the HF mappings: ``{state_dict name: tensor}`` (a
    model's base; adapters are skipped) -> ``{HF name: tensor}``, as
    ``save_pretrained`` names them; Mixtral's stacks come apart into
    ``experts.{e}.w1|w2|w3``."""
    out = {}
    experts = {v: k for k, v in _EXPERT_NAMES.items()}
    for name, t in state.items():
        if is_lora(name):
            continue
        m = re.fullmatch(r"layers\.(\d+)\.moe\.(w_gate|w_up|w_down)", name)
        if m is not None:
            for e in range(t.shape[0]):
                key = f"model.layers.{m.group(1)}.block_sparse_moe.experts.{e}"
                out[f"{key}.{experts[m.group(2)]}.weight"] = t[e].T.contiguous()
        elif ".moe.gate." in name:
            out["model." + name.replace(".moe.", ".block_sparse_moe.")] = t
        elif name == "lm_head":
            out["lm_head.weight"] = t
        elif name == "embed_tokens" or name.endswith(("q_norm", "k_norm")):
            out[f"model.{name}.weight"] = t
        else:
            out[f"model.{name}"] = t
    return out


# Mistral and Gemma checkpoints carry Llama's tensor names: the sliding
# window, Gemma's offset norms, GeGLU and embedding scale are config.
HF_CONVERTERS: dict = {
    "llama": _llama_key,
    "mistral": _llama_key,
    "qwen2": _qwen2_key,
    "qwen3": _qwen3_key,
    "gemma": _llama_key,
    "mixtral": _mixtral_key,
}

# Families whose checkpoints may tie the head to the embeddings (no
# ``lm_head.weight`` on disk); a Mixtral checkpoint without one is refused.
_TIED_HEAD_FAMILIES = frozenset({"llama", "mistral", "qwen2", "qwen3", "gemma"})


def _mapper(family: str) -> Callable:
    mapper = HF_CONVERTERS.get(family)
    if mapper is None:
        raise ValueError(f"no HF converter for family {family!r} (have {sorted(HF_CONVERTERS)})")
    return mapper


def _check(name: str, t, template: dict, source: str) -> None:
    if tuple(t.shape) != tuple(template[name].shape):
        raise ValueError(f"{source}: {name!r} has shape {tuple(t.shape)}, the model "
                         f"{tuple(template[name].shape)}")


def _covered(out: dict, template: dict, source: str) -> dict:
    """``out`` checked against ``template``'s names and shapes: a
    half-converted model must never train."""
    missing = sorted(set(template) - set(out))
    if missing:
        raise KeyError(f"{source}: {len(missing)} tensors missing, e.g. {missing[:3]}")
    for name, t in out.items():
        _check(name, t, template, source)
    return out


def _template(model) -> dict:
    state = model.state_dict()
    return {n: state[n] for n in base_names(model)}


def _tied(family: str, out: dict, template: dict) -> bool:
    return (family in _TIED_HEAD_FAMILIES and "lm_head" in template and "lm_head" not in out
            and "embed_tokens" in out)


def _stacks(template: dict) -> dict:
    """``{stack name: expert count}`` of a model's stacked experts."""
    return {n: int(t.shape[0]) for n, t in template.items()
            if n.endswith((".w_gate", ".w_up", ".w_down"))}


def convert_state_dict(family: str, state_dict: dict, model, *,
                       dtype: "torch.dtype | None" = None) -> dict:
    """An HF state dict (name -> tensor or numpy array) -> ``{state_dict
    name: tensor}`` covering ``model``'s base parameters, in ``dtype``
    (f32 by default, as the reference converts). A missing tensor raises
    KeyError, a wrong shape ValueError; a tensor the model has no place
    for (a tied model's stored head) is skipped, as the reference's
    ``unflatten_like`` skips it."""
    mapper = _mapper(family)
    template = _template(model)
    target = dtype or torch.float32
    out: dict = {}
    stacker = _Stacker()
    for key, value in state_dict.items():
        name = mapper(key)
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
        if isinstance(name, StackSlot):
            stacker.add(name, t.to(target))
            continue
        if name is None or name not in template:
            continue  # a tied checkpoint's stored head, as the reference skips it
        out[name] = t.to(target)
    out.update((n, t) for n, t in stacker.finalize() if n in template)
    if _tied(family, out, template):
        log.info("%s: tied checkpoint; the head is the embeddings", family)
        out["lm_head"] = out["embed_tokens"]
    return _covered(out, template, f"{family} state dict")


def load_state(model, state: dict) -> None:
    """Copy ``state`` (``state_dict`` names) into ``model``'s parameters in
    place, each cast to its parameter's dtype and device."""
    params = model.state_dict()
    with torch.no_grad():
        for name, t in state.items():
            params[name].copy_(t)


def load_checkpoint_files(paths: list) -> dict:
    """Tensors of checkpoint files in one state dict: ``.safetensors``
    through the port's reader (bf16 stays bf16), ``.bin`` / ``.pt`` /
    ``.pth`` through ``torch.load(weights_only=True)``; other files are
    skipped."""
    state: dict = {}
    for path in map(Path, paths):
        if path.suffix == ".safetensors":
            state.update(load_file(path))
        elif path.suffix in (".bin", ".pt", ".pth"):
            loaded = torch.load(path, map_location="cpu", weights_only=True)
            state.update({k: v for k, v in loaded.items() if isinstance(v, torch.Tensor)})
        else:
            log.debug("skipping non-checkpoint artifact %s", path)
    return state


class ShardedCheckpoint:
    """Tensors of an HF checkpoint read one at a time: a single
    ``.safetensors`` file, a directory of them, or a sharded repo's
    ``*.safetensors.index.json`` (a directory holding one, or its path).
    Headers are read once per shard; each tensor is one seek and read,
    so host memory holds one tensor."""

    def __init__(self, path: "str | Path") -> None:
        path = Path(path)
        if path.is_dir():
            index = sorted(path.glob("*.safetensors.index.json"))
            if index:
                self._weight_map = self._index(index[0])
            else:
                shards = sorted(path.glob("*.safetensors"))
                if not shards:
                    raise FileNotFoundError(f"no .safetensors or index.json under {path}")
                self._weight_map = {n: s for s in shards for n in read_header(s)[0]}
        elif path.name.endswith(".index.json"):
            self._weight_map = self._index(path)
        else:
            self._weight_map = {n: path for n in read_header(path)[0]}

    @staticmethod
    def _index(path: Path) -> dict:
        meta = json.loads(path.read_text())
        return {k: path.parent / v for k, v in meta["weight_map"].items()}

    def keys(self) -> list:
        return list(self._weight_map)

    def tensor(self, name: str) -> torch.Tensor:
        shard = self._weight_map.get(name)
        if shard is None:
            raise KeyError(name)
        return load_file(shard, [name])[name]


def convert_checkpoint(family: str, path: "str | Path", model, *,
                       dtype: "torch.dtype | None" = None, put: "Callable | None" = None) -> dict:
    """Streaming HF -> port conversion for checkpoints of any size: each
    tensor is read, named, cast to ``dtype`` (each parameter's own by
    default) and handed to ``put(name, tensor)`` before the next is read.
    The default ``put`` copies it into ``model``'s parameter in place, so
    a model allocated in the serving dtype loads without a full f32 copy.
    Returns ``{state_dict name: what put returned}``, checked to cover
    ``model``'s base parameters."""
    mapper = _mapper(family)
    template = _template(model)
    if put is None:
        def put(name, t):
            return template[name].copy_(t) if name in template else t
    out: dict = {}
    ckpt = ShardedCheckpoint(path)
    keys: dict = {}
    stacker = _Stacker(_stacks(template))

    def put_stack(name, t):
        _check(name, t, template, str(path))
        out[name] = put(name, t.to(dtype or template[name].dtype))

    for key in ckpt.keys():
        name = mapper(key)
        if isinstance(name, StackSlot):
            done = stacker.add(name, ckpt.tensor(key))
            if done is not None:  # the stack's last expert: emitted, its slices freed
                put_stack(*done)
            continue
        if name is None:
            continue
        keys[name] = key
        if name not in template:
            continue
        t = ckpt.tensor(key)
        _check(name, t, template, str(path))
        out[name] = put(name, t.to(dtype or template[name].dtype))
    for name, t in stacker.finalize():  # stacks the model does not expect
        if name in template:
            put_stack(name, t)
    if _tied(family, out, template):
        log.info("%s: tied checkpoint; the head is the embeddings", family)
        t = ckpt.tensor(keys["embed_tokens"])
        out["lm_head"] = put("lm_head", t.to(dtype or template["lm_head"].dtype))
    return _covered(out, template, str(path))
