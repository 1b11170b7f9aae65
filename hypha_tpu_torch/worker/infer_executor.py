"""Model loading for serving (counterpart of ``_load_model`` and
``_generate_grouped`` in ``hypha_tpu/worker/infer_executor.py``). The
network ``InProcessInferExecutor`` needs ports of ``messages``, ``network``
and ``node`` and comes with a later slice (ROADMAP.md, Queue 1)."""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from ..executor.generate import generate
from ..executor.serialization import load_file
from ..hw import default_device
from ..models.convert import llama_params_from_flat
from ..models.registry import build_model

__all__ = ["load_model", "generate_grouped"]

log = logging.getLogger("hypha.torch.worker.infer_executor")


def load_model(model_spec: dict, device=None):
    """Build the spec's model on ``device`` (CUDA by default), fill it with
    a seeded init (``seed``, default 0) or a flat SafeTensors file
    (``weights``, names as the JAX package's ``flatten_tree`` gives them),
    and cast f32 parameters to the serving dtype: ``serve_dtype`` is
    ``"bfloat16"`` by default, ``"float32"`` opts out."""
    dev = default_device(device)
    serve_dtype = model_spec.get("serve_dtype", "bfloat16")
    if serve_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"serve_dtype must be 'bfloat16' or 'float32', got {serve_dtype!r}")
    model, _cfg = build_model(model_spec, device=dev)
    path = model_spec.get("weights")
    if path:
        if Path(path).is_dir():
            raise NotImplementedError(
                "HF checkpoint directories are not ported yet; pass a flat "
                "SafeTensors file (ROADMAP.md, Queue 1)"
            )
        llama_params_from_flat(load_file(path), model)
    else:
        model.init_weights(int(model_spec.get("seed", 0)))
    if serve_dtype == "bfloat16":
        log.info("serving params cast f32->bf16 (serve_dtype=float32 keeps f32)")
        model.to(torch.bfloat16)
    model.requires_grad_(False)
    return model.eval()


def generate_grouped(model, prompts, n_new, temperature, top_k, seed) -> list:
    """Blocking one-shot generation for ``PoolServer``'s fallback: prompts
    of equal length batch together; order is preserved."""
    by_len: dict = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    out: list = [None] * len(prompts)
    for idxs in by_len.values():
        gen = torch.Generator(device=model.device).manual_seed(int(seed))
        toks = generate(
            model, [prompts[i] for i in idxs], n_new, temperature=temperature,
            top_k=top_k, generator=gen,
        ).cpu()
        for row, i in enumerate(idxs):
            out[i] = toks[row].tolist()
    return out
