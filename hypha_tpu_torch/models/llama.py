"""Llama family in PyTorch (counterpart of ``hypha_tpu/models/llama.py``).

RMSNorm, rotary embeddings, SwiGLU (or Gemma's GeGLU) MLP, grouped-query
attention; Mistral (sliding window), Qwen2 (q/k/v biases), Qwen3 (QK-norm)
and Gemma (offset RMSNorm, scaled embeddings, tied head) are config
toggles, as in the reference. Module and parameter names mirror the flax
tree (``layers.{i}.self_attn.q_proj.weight`` for
``params/layers_{i}/self_attn/q_proj/kernel``), so ``models/convert.py``
maps the JAX package's flat names mechanically.

Numerics follow the reference: parameters are f32 unless cast for
serving, projections compute in ``config.dtype`` (inputs and weights cast
at use, like flax ``Dense(dtype=...)``), norms and RoPE in f32, and the
head einsum in f32.

``forward(input_ids)`` is the training forward (plain causal attention).
``forward(input_ids, cache)`` is the decode forward: the explicit
:class:`~hypha_tpu_torch.ops.kvcache.KVCache` selects scalar, per-row,
paged or paged+ragged mode and is updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..hw import default_device
from ..ops.attention import dot_product_attention
from ..ops.kvcache import KVCache
from ..ops.paged_attention import paged_attention
from ..ops.rmsnorm import rms_norm
from ..ops.rope import apply_rope, rope_frequencies

__all__ = ["Llama", "LlamaConfig"]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32_000
    hidden_size: int = 4096
    intermediate_size: int = 11_008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 4096
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    attn_bias: bool = False  # Qwen2: biases on q/k/v projections
    remat: bool = False  # gradient checkpointing (training slice)
    sliding_window: "int | None" = None  # Mistral: local attention window
    tie_word_embeddings: bool = False  # Qwen2-small/Gemma: head = embeddings
    head_dim_override: "int | None" = None  # Gemma: head_dim != hidden/heads
    mlp_act: str = "silu"  # "silu" (Llama) | "gelu_tanh" (Gemma GeGLU)
    rms_offset: bool = False  # Gemma RMSNorm: x * (1 + weight)
    embed_scale: bool = False  # Gemma: embeddings scaled by sqrt(hidden)
    qk_norm: bool = False  # Qwen3: per-head RMSNorm on q/k before RoPE
    lora_rank: int = 0  # LoRA adapters: the training slice
    lora_alpha: float = 16.0
    lora_targets: tuple = ("q_proj", "v_proj")

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def from_hf(cls, d: dict, **overrides) -> "LlamaConfig":
        """Map an HF ``config.json`` dict (llama / mistral / qwen2 / qwen3 /
        gemma) onto the native config."""
        fields = dict(
            vocab_size=d.get("vocab_size", 32_000),
            hidden_size=d.get("hidden_size", 4096),
            intermediate_size=d.get("intermediate_size", 11_008),
            num_layers=d.get("num_hidden_layers", 32),
            num_heads=d.get("num_attention_heads", 32),
            num_kv_heads=d.get("num_key_value_heads", d.get("num_attention_heads", 32)),
            max_seq_len=d.get("max_position_embeddings", 4096),
            rope_theta=d.get("rope_theta", 10_000.0),
            rms_eps=d.get("rms_norm_eps", 1e-5),
            attn_bias=d.get("model_type") == "qwen2",
            qk_norm=d.get("model_type") == "qwen3",
            # Qwen2 ships a sliding_window with use_sliding_window=false.
            sliding_window=(
                d.get("sliding_window") if d.get("use_sliding_window", True) else None
            ),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            head_dim_override=d.get("head_dim"),
        )
        if d.get("model_type") == "gemma":
            fields.update(
                mlp_act="gelu_tanh",
                rms_offset=True,
                embed_scale=True,
                tie_word_embeddings=d.get("tie_word_embeddings", True),
            )
        fields.update(overrides)
        return cls(**fields)

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """CI-sized config (GQA exercised: 4 q heads, 2 kv)."""
        return cls(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=128,
        )

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_heads


class _Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``: input, weight and bias
    are cast at use (a no-op once the weights are stored in that dtype)."""

    def __init__(self, in_features, out_features, bias, compute_dtype, device):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class _RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, offset: bool, device) -> None:
        super().__init__()
        self.eps, self.offset = eps, offset
        # Gemma stores the delta from identity (effective scale 1 + weight).
        init = torch.zeros if offset else torch.ones
        self.weight = nn.Parameter(init(dim, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight + 1.0 if self.offset else self.weight, self.eps)


class _Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device) -> None:
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        hd, E = cfg.head_dim, cfg.hidden_size
        self.q_proj = _Linear(E, cfg.num_heads * hd, cfg.attn_bias, dt, device)
        self.k_proj = _Linear(E, cfg.num_kv_heads * hd, cfg.attn_bias, dt, device)
        self.v_proj = _Linear(E, cfg.num_kv_heads * hd, cfg.attn_bias, dt, device)
        self.o_proj = _Linear(cfg.num_heads * hd, E, False, dt, device)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, device=device))
            self.k_norm = nn.Parameter(torch.ones(hd, device=device))

    def forward(self, x, cos, sin, cache: "KVCache | None", layer: int, offset):
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        B, S, _ = x.shape
        H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.q_proj(x).reshape(B, S, H, hd)
        k = self.k_proj(x).reshape(B, S, Hkv, hd)
        v = self.v_proj(x).reshape(B, S, Hkv, hd)
        if cfg.qk_norm:  # before RoPE, in every mode
            q = rms_norm(q, self.q_norm, cfg.rms_eps).to(dt)
            k = rms_norm(k, self.k_norm, cfg.rms_eps).to(dt)
        window = cfg.sliding_window
        if cache is None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            if window is not None and S > window:
                attn = dot_product_attention(q, k, v, causal=True, window=window)
            else:
                attn = dot_product_attention(q, k, v, causal=True)
        elif cache.per_row:
            # Rows are left-padded into their window: RoPE runs on logical
            # positions, and attention masks keys below the row's start.
            ar = torch.arange(S, device=x.device)[None, :]
            logical = torch.clamp(offset[:, None] - cache.start[:, None] + ar, min=0)
            q = apply_rope(q, cos, sin, positions=logical)
            k = apply_rope(k, cos, sin, positions=logical).to(dt)
            full_k, full_v = cache.update(layer, k, v.to(dt), offset)
            if cache.ragged:
                attn = paged_attention(
                    q, full_k, blocks=cache.blocks, block_size=cache.block_size,
                    q_offset=offset, k_start=cache.start, window=window,
                )
            else:
                attn = dot_product_attention(
                    q, full_k, full_v, causal=True, q_offset=offset,
                    window=window, k_start=cache.start,
                )
        else:
            positions = (offset + torch.arange(S, device=x.device))[None, :].expand(B, S)
            q = apply_rope(q, cos, sin, positions=positions)
            k = apply_rope(k, cos, sin, positions=positions).to(dt)
            full_k, full_v = cache.update(layer, k, v.to(dt), offset)
            attn = dot_product_attention(
                q, full_k, full_v, causal=True, q_offset=offset, window=window,
            )
        return self.o_proj(attn.reshape(B, S, H * hd))


class _MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device) -> None:
        super().__init__()
        if cfg.mlp_act not in ("silu", "gelu_tanh", "gelu"):
            raise ValueError(f"unknown mlp_act {cfg.mlp_act!r} (silu | gelu_tanh)")
        dt = getattr(torch, cfg.dtype)
        E, I = cfg.hidden_size, cfg.intermediate_size
        self.act = cfg.mlp_act
        self.gate_proj = _Linear(E, I, False, dt, device)
        self.up_proj = _Linear(E, I, False, dt, device)
        self.down_proj = _Linear(I, E, False, dt, device)

    def forward(self, x):
        gate = self.gate_proj(x)
        if self.act == "silu":
            act = F.silu(gate)
        else:  # Gemma GeGLU: flax nn.gelu's default is the tanh approximation
            act = F.gelu(gate, approximate="tanh")
        return self.down_proj(act * self.up_proj(x))


class _Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device) -> None:
        super().__init__()
        self.input_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.rms_offset, device)
        self.self_attn = _Attention(cfg, device)
        self.post_attention_layernorm = _RMSNorm(
            cfg.hidden_size, cfg.rms_eps, cfg.rms_offset, device
        )
        self.mlp = _MLP(cfg, device)

    def forward(self, x, cos, sin, cache, layer, offset):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, cache, layer, offset)
        return x + self.mlp(self.post_attention_layernorm(x))


class Llama(nn.Module):
    """Llama-family causal LM. Parameters are allocated on ``device`` (CUDA
    unless the caller asks for another) and left uninitialized: call
    :meth:`init_weights` or load weights through ``models/convert.py``."""

    def __init__(self, config: LlamaConfig = LlamaConfig(), *, device=None) -> None:
        super().__init__()
        if config.lora_rank > 0:
            raise NotImplementedError(
                "LoRA adapters come with the training slice (ROADMAP.md, Queue 1)"
            )
        dev = default_device(device)
        self.config = config
        V, E = config.vocab_size, config.hidden_size
        self.embed_tokens = nn.Parameter(torch.empty(V, E, device=dev))
        self.layers = nn.ModuleList(_Block(config, dev) for _ in range(config.num_layers))
        self.norm = _RMSNorm(E, config.rms_eps, config.rms_offset, dev)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Parameter(torch.empty(V, E, device=dev))
        self._rope: dict = {}

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Llama":
        """Seeded init with the reference's distributions (embeddings and
        head normal(0.02); projections flax's lecun_normal, a normal of
        variance 1/fan_in truncated at two standard deviations; biases 0;
        norms 1, or 0 for Gemma's offset form). The draws come from a
        ``torch.Generator`` and differ from JAX's."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name in ("embed_tokens", "lm_head"):
                p.normal_(0.0, 0.02, generator=g)
            elif name.endswith("proj.weight"):
                # lecun_normal: std of the truncated draw is sqrt(1/fan_in).
                std = (1.0 / p.shape[1]) ** 0.5 / 0.8796256610342398
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=g)
            elif name.endswith("proj.bias"):
                p.zero_()
            elif name.endswith("norm.weight"):
                p.fill_(0.0 if self.config.rms_offset else 1.0)
            else:  # Qwen3 q_norm / k_norm
                p.fill_(1.0)
        return self

    def _rope_table(self, length: int, device) -> tuple:
        key = (length, str(device))
        if key not in self._rope:
            cfg = self.config
            self._rope[key] = rope_frequencies(cfg.head_dim, length, cfg.rope_theta, device)
        return self._rope[key]

    def forward(
        self,
        input_ids: torch.Tensor,
        cache: "KVCache | None" = None,
        *,
        with_head: bool = True,
    ) -> torch.Tensor:
        """input_ids [B, S] -> f32 logits [B, S, vocab] (or the final hidden
        states with ``with_head=False``). With ``cache`` this is the decode
        forward: K/V are written at the cache's index, which then
        advances by S."""
        cfg = self.config
        dt = getattr(torch, cfg.dtype)
        x = self.embed_tokens[input_ids.long()].to(dt)
        if cfg.embed_scale:  # Gemma: scaled in the compute dtype
            x = x * torch.tensor(cfg.hidden_size**0.5, dtype=dt, device=x.device)
        length = max(cfg.max_seq_len, cache.decode_len if cache is not None else 0)
        cos, sin = self._rope_table(length, x.device)
        offset = None if cache is None else cache.idx
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, cache, i, offset)
        if cache is not None:
            cache.advance(input_ids.shape[1])
        x = self.norm(x)
        if not with_head:
            return x
        head = self.embed_tokens if cfg.tie_word_embeddings else self.lm_head
        return torch.einsum("bse,ve->bsv", x.float(), head.float())
