"""Mixtral-style sparse MoE decoder in PyTorch (counterpart of
``hypha_tpu/models/mixtral.py``).

Experts live in stacked parameters with a leading expert axis, laid out as
the flax tree holds them (``w_gate``/``w_up`` ``[E, D, F]``, ``w_down``
``[E, F, D]``, not transposed), and the router is a bias-free
``nn.Linear`` computed in f32 (``layers.{i}.moe.gate.weight`` for
``params/layers_{i}/moe/gate/kernel``). Attention and norms are the
port's Llama modules (``models/llama.py``), so a Mixtral trains through
the flash kernels and serves through the ragged paged kernel as a Llama
does; the MoE products are plain torch einsums, as the reference's are
XLA einsums.

Two routings, both with the reference's aux loss
(``router_aux_coef * E * sum(frac_routed * mean_prob)``):

* **capacity** (training): each expert takes at most
  ``C = max(1, ceil(S*K*capacity_factor/E))`` tokens a sequence, in
  token-major, k-minor order; the rest are dropped;
* **drop-free** (every cached forward, and the plain forward under
  ``dropless``): every expert runs on every token and the top-k weights
  combine them, exact for any router load.

``forward`` returns ``(logits f32, aux summed over the layers)``, or
``(hidden, aux)`` with ``with_head=False``. An ``intermediates`` dict
passed to it receives each capacity layer's ``drop_frac`` (the
reference's ``sow``; nothing is computed without one).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..hw import default_device
from ..ops.kvcache import KVCache
from .llama import Llama, LlamaConfig, _Attention, _Linear, _Remat, _RMSNorm

__all__ = ["Mixtral", "MixtralConfig"]


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32_000
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 4096
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-5
    router_aux_coef: float = 0.02
    dtype: str = "bfloat16"
    remat: bool = False  # gradient checkpointing of each block (training)
    dropless: bool = False  # drop-free routing in training too

    @classmethod
    def mixtral_8x7b(cls) -> "MixtralConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "MixtralConfig":
        return cls(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, num_experts=4, experts_per_token=2, max_seq_len=128,
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def as_llama(self) -> LlamaConfig:
        """The attention sublayer's config (Mixtral reuses Llama's)."""
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size, num_layers=self.num_layers,
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta, rms_eps=self.rms_eps,
            dtype=self.dtype,
        )


class MoELayer(nn.Module):
    """Top-k routed expert MLP; ``forward`` returns ``(out, aux)``."""

    def __init__(self, cfg: MixtralConfig, device) -> None:
        super().__init__()
        self.cfg = cfg
        E, D, Fi = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        self.gate = _Linear(D, E, False, torch.float32, device)
        self.w_gate = nn.Parameter(torch.empty(E, D, Fi, device=device))
        self.w_up = nn.Parameter(torch.empty(E, D, Fi, device=device))
        self.w_down = nn.Parameter(torch.empty(E, Fi, D, device=device))

    def forward(self, x, dropless: bool, record: "dict | None" = None):
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        B, S, _ = x.shape
        E, K = cfg.num_experts, cfg.experts_per_token
        probs = torch.softmax(self.gate(x.float()), dim=-1)  # [B, S, E]
        top_w, top_idx = torch.topk(probs, K, dim=-1)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        onehot = F.one_hot(top_idx, E).float()  # [B, S, K, E]
        if dropless:
            # Every expert on every token: [E, B*S, D] through the stacks.
            out_all = self._experts(x.reshape(1, B * S, -1).expand(E, -1, -1), dt)
            combine = torch.einsum("bsk,bske->bse", top_w, onehot).to(dt)
            out = torch.einsum("bse,ebsd->bsd", combine, out_all.reshape(E, B, S, -1))
            routed = onehot
        else:
            C = max(1, math.ceil(S * K * cfg.capacity_factor / E))
            # Position in the expert: the count of earlier (token, k) picks
            # of that expert, in token-major, k-minor order.
            pos = torch.cumsum(onehot.reshape(B, S * K, E), dim=1).reshape(B, S, K, E) - onehot
            keep = (pos < C).float() * onehot
            if record is not None:
                kept = keep.sum() / torch.clamp(onehot.sum(), min=1.0)
                record["drop_frac"] = (1.0 - kept).detach()
            # A dropped pick's position is past C: clamped, its keep of 0
            # zeroes it, as JAX's one_hot of an out-of-range index does.
            pos_cap = F.one_hot(pos.long().clamp(max=C - 1), C).float()  # [B, S, K, E, C]
            dispatch = torch.einsum("bske,bskec->bsec", keep, pos_cap)
            combine = torch.einsum("bsk,bske,bskec->bsec", top_w, keep, pos_cap)
            expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x)  # [E, B, C, D]
            expert_out = self._experts(expert_in.reshape(E, B * C, -1), dt).reshape(E, B, C, -1)
            out = torch.einsum("bsec,ebcd->bsd", combine.to(dt), expert_out)
            routed = keep
        frac_routed = routed.sum(2).mean(dim=(0, 1))  # [E]
        mean_prob = probs.mean(dim=(0, 1))  # [E]
        aux = cfg.router_aux_coef * E * torch.sum(frac_routed * mean_prob)
        return out, aux

    def _experts(self, xs, dt):
        """SwiGLU of each expert on its own rows: ``xs`` [E, N, D] -> [E, N,
        D] in ``dt``. Batched matmuls read the stacks in place (an einsum
        of the token-major input would copy each stack first)."""
        h = F.silu(torch.bmm(xs, self.w_gate.to(dt))) * torch.bmm(xs, self.w_up.to(dt))
        return torch.bmm(h, self.w_down.to(dt))


class _MoEBlock(nn.Module):
    def __init__(self, cfg: MixtralConfig, device, attn_impl=None) -> None:
        super().__init__()
        lcfg = cfg.as_llama()
        self.input_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_eps, False, device)
        self.self_attn = _Attention(lcfg, device, attn_impl)
        self.post_attention_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_eps, False, device)
        self.moe = MoELayer(cfg, device)

    def forward(self, x, cos, sin, cache, layer, offset, dropless=False, record=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, cache, layer, offset)
        out, aux = self.moe(self.post_attention_layernorm(x), dropless, record)
        return x + out, aux


class Mixtral(Llama):
    """Mixtral causal LM with the Llama module's attributes
    (``embed_tokens``, ``layers``, ``norm``, ``lm_head``, ``config``,
    ``device``), so caches and the pool's self-draft take it as they take
    a Llama. Parameters are allocated on ``device`` (CUDA unless the
    caller asks for another) and left uninitialized."""

    def __init__(self, config: MixtralConfig = MixtralConfig(), *, device=None,
                 attn_impl: "Callable | None" = None) -> None:
        nn.Module.__init__(self)
        dev = default_device(device)
        self.config = config
        V, E = config.vocab_size, config.hidden_size
        self.embed_tokens = nn.Parameter(torch.empty(V, E, device=dev))
        self.layers = nn.ModuleList(
            _MoEBlock(config, dev, attn_impl) for _ in range(config.num_layers)
        )
        self.norm = _RMSNorm(E, config.rms_eps, False, dev)
        self.lm_head = nn.Parameter(torch.empty(V, E, device=dev))
        self._rope: dict = {}

    def init_plan(self, seed: int) -> list:
        """Each parameter's draw (see ``Llama.init_plan``), in the keys of
        ``hypha_tpu/models/mixtral.py``: embeddings and head normal(0.02)
        at the root (counters 1 and 2), attention projections and the
        router lecun_normal kernels in their own scopes (``moe/gate``
        counter 1), the stacked experts normal(0.02) in ``layers_i/moe``
        (``w_gate``, ``w_up``, ``w_down``: counters 1-3, untransposed)."""
        from . import seed_init as si

        experts = {"w_gate": 1, "w_up": 2, "w_down": 3}
        root_count = {"embed_tokens": 1, "lm_head": 2}
        plan = []
        for name, leaf in self.named_parameters():
            parts = name.split(".")
            if name in root_count:
                plan.append((name, ((), root_count[name], "normal", 0.02), False))
            elif parts[-1] == "weight" and parts[-2] in ("q_proj", "k_proj", "v_proj", "o_proj",
                                                          "gate"):
                scope = (f"layers_{parts[1]}", parts[2], parts[3])
                plan.append((name, (scope, 1, "truncated_normal", si.lecun_scale(leaf.shape[1])),
                             True))
            elif parts[-1] in experts:
                plan.append((name, ((f"layers_{parts[1]}", "moe"), experts[parts[-1]], "normal",
                                    0.02), False))
            else:  # norms
                plan.append((name, None, False))
        root = si.key(seed)
        return [
            (name, None if d is None else (si.param_key(root, d[0], d[1]), d[2], d[3]), t)
            for name, d, t in plan
        ]

    def forward(
        self,
        input_ids: torch.Tensor,
        cache: "KVCache | None" = None,
        *,
        with_head: bool = True,
        dropless: bool = False,
        intermediates: "dict | None" = None,
    ) -> tuple:
        """input_ids [B, S] -> (f32 logits [B, S, vocab], aux), or (final
        hidden states, aux) with ``with_head=False``. With ``cache`` this
        is the decode forward (drop-free routing; K/V written at the
        cache's index, which then advances by S). ``intermediates``
        receives ``layers_{i}/moe/drop_frac`` of each capacity layer."""
        cfg = self.config
        dt = getattr(torch, cfg.dtype)
        x = self.embed_tokens[input_ids.long()].to(dt)
        length = max(cfg.max_seq_len, cache.decode_len if cache is not None else 0)
        cos, sin = self._rope_table(length, x.device)
        offset = None if cache is None else cache.idx
        free = cache is not None or dropless or cfg.dropless
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            record = None if intermediates is None else {}
            if remat:  # the block's forward runs again in the backward
                def run(x, cos, sin, layer=layer, i=i, record=record):
                    return layer(x, cos, sin, None, i, None, free, record)

                x, aux = _Remat.apply(run, x, cos, sin, *layer.parameters())
            else:
                x, aux = layer(x, cos, sin, cache, i, offset, free, record)
            aux_total = aux_total + aux
            if record:
                intermediates[f"layers_{i}/moe/drop_frac"] = record["drop_frac"]
        if cache is not None:
            cache.advance(input_ids.shape[1])
        x = self.norm(x)
        if not with_head:
            return x, aux_total
        return torch.einsum("bse,ve->bsv", x.float(), self.lm_head.float()), aux_total
