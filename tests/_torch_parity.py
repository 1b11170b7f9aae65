"""Shared fixtures of the port's parity tests: a tiny Llama built by the
JAX package and carried into hypha_tpu_torch through its flat names, and
one decode step driven through both packages with the same row
variables."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hypha_tpu.executor.serialization import flatten_tree, unflatten_like
from hypha_tpu.models import Llama as JLlama
from hypha_tpu.models import LlamaConfig as JConfig
from hypha_tpu_torch.models import Llama as TLlama
from hypha_tpu_torch.models import LlamaConfig as TConfig
from hypha_tpu_torch.models.convert import llama_params_from_flat
from hypha_tpu_torch.ops.kvcache import KVCache

FAMILIES = {
    "llama": {},
    "mistral": {"sliding_window": 5},
    "qwen2": {"attn_bias": True},
    "qwen3": {"qk_norm": True},
    "gemma": {"mlp_act": "gelu_tanh", "rms_offset": True, "embed_scale": True,
              "tie_word_embeddings": True},
}


def tiny_pair(family: str = "llama", dtype: str = "float32", seed: int = 0, **over):
    """(JAX module, JAX variables, port module) with identical weights.
    Every parameter gets seeded noise, so norms and biases matter."""
    over = {**FAMILIES[family], **over}
    jm = JLlama(dataclasses.replace(JConfig.tiny(), dtype=dtype, **over))
    variables = jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)
    flat = {k: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_tree(variables).items()}
    variables = unflatten_like(flat, variables)
    tm = TLlama(dataclasses.replace(TConfig.tiny(), dtype=dtype, **over), device="cpu")
    llama_params_from_flat(flat, tm)
    return jm, variables, tm


def _set_rowvars(cache, **values):
    def repl(path, leaf):
        key = getattr(path[-1], "key", None)
        if key in values:
            return jnp.broadcast_to(jnp.asarray(values[key]), leaf.shape).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(repl, cache)


class DecodePair:
    """One paged decode state in each package, stepped in lockstep."""

    def __init__(self, jm, variables, tm, *, B, L, blocks, bs, ragged=False, kv_quant=""):
        self.dec = dataclasses.replace(
            jm, decode=True, decode_len=L, per_row_decode=True, kv_blocks=blocks,
            kv_block_size=bs, ragged_attention=ragged, kv_quant=kv_quant,
        )
        skel = jax.eval_shape(
            lambda: self.dec.init(jax.random.key(0), jnp.zeros((B, 1), jnp.int32))
        )["cache"]
        self.jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), skel)
        self.variables, self.tm = variables, tm
        self.tcache = KVCache.for_model(
            tm, B, L, per_row=True, blocks=blocks, block_size=bs, ragged=ragged,
            kv_quant=kv_quant,
        )

    def step(self, toks, idx, start, table):
        """Run ``toks`` [B, S] at row variables (idx, start, table); returns
        (JAX logits, port logits) as numpy."""
        idx, start, table = (np.asarray(a, np.int32) for a in (idx, start, table))
        cache = _set_rowvars(self.jcache, idx=idx, start=start, table=table)
        jl, out = self.dec.apply({**self.variables, "cache": cache}, jnp.asarray(toks),
                                 mutable=["cache"])
        self.jcache = out["cache"]
        c = self.tcache
        c.idx.copy_(torch.from_numpy(idx))
        c.start.copy_(torch.from_numpy(start))
        c.table.copy_(torch.from_numpy(table))
        with torch.inference_mode():
            tl = self.tm(torch.from_numpy(np.asarray(toks)), c)
        return np.asarray(jl, np.float32), tl.float().numpy()


def paged_script(rng, *, B=3, L=32, bs=4, blocks=12, prefill=8, steps=3, vocab=256):
    """A pool-like run: lanes 0 and 1 prefill ``prefill`` tokens (lane 1
    left-padded by 2), lane 2 idle, parked past the window; then ``steps``
    single-token decode steps. Yields (toks, idx, start, table)."""
    table = np.full((B, L // bs), blocks, np.int32)
    ids = rng.permutation(blocks)
    need = -(-(prefill + steps) // bs)
    table[0, :need] = ids[:need]
    table[1, :need] = ids[need : 2 * need]
    start = np.array([0, 2, 0], np.int32)
    yield rng.integers(0, vocab, (B, prefill)), np.array([0, 0, L]), start, table
    for i in range(steps):
        yield rng.integers(0, vocab, (B, 1)), np.array([prefill + i, prefill + i, L + i]), start, table
