"""One-shot KV-cached generation (counterpart of
``hypha_tpu/executor/generate.py``): the prompt prefills the cache in one
forward, then one token per step against the static-size cache. A Mixtral's cached
forward routes drop-free, so its tokens equal the full drop-free forward's.

Greedy decoding matches the JAX package token for token. Sampling draws
from an explicit ``torch.Generator``; its numbers differ from JAX's, so a
sampled stream is reproducible within the port, not across packages.
"""

from __future__ import annotations

import torch

from ..ops.kvcache import KVCache

__all__ = ["generate", "logits_of"]


def logits_of(out) -> torch.Tensor:
    """A forward's logits: a Mixtral returns ``(logits, aux)``, a Llama the
    logits alone."""
    return out[0] if isinstance(out, tuple) else out


def _sample(logits, temperature: float, top_k, generator):
    """logits [B, V] -> token ids [B]."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(
    model,
    prompt_ids,  # [B, S] ints (tensor, array or nested list)
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: "int | None" = None,
    generator: "torch.Generator | None" = None,
    eos_token_id: "int | None" = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations: int32 [B, max_new_tokens]
    on the model's device. After ``eos_token_id`` a row keeps emitting it
    (callers trim). ``generator`` seeds sampling (default: seed 0)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    dev = model.device
    prompt = torch.as_tensor(prompt_ids, dtype=torch.int64, device=dev)
    B, S = prompt.shape
    total = S + max_new_tokens
    limit = model.config.max_seq_len
    if total > limit:
        raise ValueError(f"prompt+new = {total} exceeds the model's {limit} positions")
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = KVCache.for_model(model, B, total)
    tok = _sample(logits_of(model(prompt, cache))[:, -1], temperature, top_k, generator)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        nxt = _sample(logits_of(model(tok[:, None], cache))[:, -1], temperature, top_k,
                      generator)
        if eos_token_id is not None:
            nxt = torch.where(tok == eos_token_id, eos_token_id, nxt)
        tok = nxt
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)
