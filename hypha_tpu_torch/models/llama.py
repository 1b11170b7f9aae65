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

``forward(input_ids)`` is the training forward: causal attention, with
the sliding window when one is set, through the model's ``attn_impl``
(the plain ``dot_product_attention`` when None; the trainer installs
``flash_attention`` on CUDA, whose kernels take the window), each block
rematerialized in the backward (``_Remat``) when ``config.remat`` is set
and gradients are on. ``forward(input_ids, cache)`` is the decode forward: the explicit
:class:`~hypha_tpu_torch.ops.kvcache.KVCache` selects scalar, per-row,
paged or paged+ragged mode and is updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

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
    remat: bool = False  # gradient checkpointing of each block (training)
    sliding_window: "int | None" = None  # Mistral: local attention window
    tie_word_embeddings: bool = False  # Qwen2-small/Gemma: head = embeddings
    head_dim_override: "int | None" = None  # Gemma: head_dim != hidden/heads
    mlp_act: str = "silu"  # "silu" (Llama) | "gelu_tanh" (Gemma GeGLU)
    rms_offset: bool = False  # Gemma RMSNorm: x * (1 + weight)
    embed_scale: bool = False  # Gemma: embeddings scaled by sqrt(hidden)
    qk_norm: bool = False  # Qwen3: per-head RMSNorm on q/k before RoPE
    # LoRA adapters (executor/lora.py): rank 0 = off. Each target computes
    # y = xW + ((xA)B)·(α/r), A [in, r] and B [r, out] f32 parameters.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ("q_proj", "v_proj")

    _LORA_SUPPORTED = frozenset({"q_proj", "k_proj", "v_proj", "o_proj"})

    def __post_init__(self):
        if self.lora_rank > 0:
            bad = set(self.lora_targets) - self._LORA_SUPPORTED
            if bad or not self.lora_targets:
                # A misspelt target would train no adapter at all.
                raise ValueError(
                    f"lora_targets {sorted(bad) or '(empty)'} unsupported; "
                    f"choose from {sorted(self._LORA_SUPPORTED)}"
                )

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
    def __init__(self, cfg: LlamaConfig, device, attn_impl: "Callable | None" = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.attn_impl = attn_impl
        dt = getattr(torch, cfg.dtype)
        hd, E = cfg.head_dim, cfg.hidden_size
        self.q_proj = _Linear(E, cfg.num_heads * hd, cfg.attn_bias, dt, device)
        self.k_proj = _Linear(E, cfg.num_kv_heads * hd, cfg.attn_bias, dt, device)
        self.v_proj = _Linear(E, cfg.num_kv_heads * hd, cfg.attn_bias, dt, device)
        self.o_proj = _Linear(cfg.num_heads * hd, E, False, dt, device)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, device=device))
            self.k_norm = nn.Parameter(torch.ones(hd, device=device))
        if cfg.lora_rank > 0:
            # The JAX layout, no transpose: A [in, r], B [r, out].
            for name in cfg.lora_targets:
                proj = getattr(self, name)
                self.register_parameter(f"{name}_lora_a", nn.Parameter(
                    torch.empty(proj.in_features, cfg.lora_rank, device=device)))
                self.register_parameter(f"{name}_lora_b", nn.Parameter(
                    torch.empty(cfg.lora_rank, proj.out_features, device=device)))

    def _proj(self, name: str, x):
        """The projection ``name``, plus its low-rank adapter when it has
        one: ``((x A) B)·(α/r)`` in the compute dtype, added to ``x W``
        (the two products in the reference's order; ``A B`` is never formed)."""
        y = getattr(self, name)(x)
        a = getattr(self, f"{name}_lora_a", None)
        if a is None:
            return y
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        b = getattr(self, f"{name}_lora_b")
        return y + ((x.to(dt) @ a.to(dt)) @ b.to(dt)) * (cfg.lora_alpha / cfg.lora_rank)

    def forward(self, x, cos, sin, cache: "KVCache | None", layer: int, offset):
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        B, S, _ = x.shape
        H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self._proj("q_proj", x).reshape(B, S, H, hd)
        k = self._proj("k_proj", x).reshape(B, S, Hkv, hd)
        v = self._proj("v_proj", x).reshape(B, S, Hkv, hd)
        if cfg.qk_norm:  # before RoPE, in every mode
            q = rms_norm(q, self.q_norm, cfg.rms_eps).to(dt)
            k = rms_norm(k, self.k_norm, cfg.rms_eps).to(dt)
        window = cfg.sliding_window
        if cache is None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            impl = self.attn_impl or dot_product_attention
            attn = impl(q, k, v, causal=True, window=window)
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
        return self._proj("o_proj", attn.reshape(B, S, H * hd))


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


class _Remat(torch.autograd.Function):
    """One block rematerialized (``remat``): the forward keeps only the
    block's inputs, the backward runs the block again and differentiates
    it, the same bits as ``torch.utils.checkpoint`` (whose first call
    imports torch._dynamo: seconds of a trainer's first step). ``run(x,
    cos, sin)`` is the block's training forward, returning a tensor or a
    tuple of them (a Mixtral block's output and aux loss); the block's
    parameters are inputs, so ``torch.autograd.grad`` over them works."""

    @staticmethod
    def forward(ctx, run, x, cos, sin, *params):
        ctx.run, ctx.params = run, params
        ctx.save_for_backward(x, cos, sin)
        return run(x, cos, sin)

    @staticmethod
    def backward(ctx, *grad):
        x, cos, sin = ctx.saved_tensors
        with torch.enable_grad():
            xg = x.detach().requires_grad_(x.requires_grad)
            out = ctx.run(xg, cos, sin)
        outs = out if isinstance(out, tuple) else (out,)
        inputs = (xg, *ctx.params)
        need = [t.requires_grad for t in inputs]
        got = iter(torch.autograd.grad(outs, [t for t, n in zip(inputs, need) if n], grad,
                                       allow_unused=True))
        grads = [next(got) if n else None for n in need]
        return (None, grads[0], None, None, *grads[1:])


class _Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, attn_impl=None) -> None:
        super().__init__()
        self.input_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.rms_offset, device)
        self.self_attn = _Attention(cfg, device, attn_impl)
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
    :meth:`init_weights` or load weights through ``models/convert.py``.
    ``attn_impl(q, k, v, causal=True, window=None)`` replaces the plain
    attention of the training forward (the JAX model's hook of the same
    name; the port's also takes the sliding window, so that Mistral trains
    through the flash kernels)."""

    def __init__(self, config: LlamaConfig = LlamaConfig(), *, device=None,
                 attn_impl: "Callable | None" = None) -> None:
        super().__init__()
        dev = default_device(device)
        self.config = config
        V, E = config.vocab_size, config.hidden_size
        self.embed_tokens = nn.Parameter(torch.empty(V, E, device=dev))
        self.layers = nn.ModuleList(
            _Block(config, dev, attn_impl) for _ in range(config.num_layers)
        )
        self.norm = _RMSNorm(E, config.rms_eps, config.rms_offset, dev)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Parameter(torch.empty(V, E, device=dev))
        self._rope: dict = {}

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def init_plan(self, seed: int) -> list:
        """How :meth:`init_weights` draws each parameter, in the reference's
        terms: ``(name, draw, transposed)`` where ``draw`` is None for a
        constant (norms 1, or 0 in Gemma's offset form; biases and LoRA
        ``B`` 0) or ``(key, kind, mul)`` for a seeded draw of the flax
        parameter's flat elements, and ``transposed`` says the torch layout
        is the transpose of flax's ``[in, out]`` kernel. The key is flax's:
        the scope path of the parameter and its count in that scope
        (``hypha_tpu/models/llama.py``: embeddings and head at the root,
        ``nn.Dense`` kernels in their own scope, LoRA ``A`` in ``self_attn``
        counted in declaration order)."""
        from . import seed_init as si

        cfg = self.config
        plan = []
        root_count = {"embed_tokens": 1, "lm_head": 2}
        attn_order = []  # self_attn's own parameters, in the reference's order
        for proj in ("q_proj", "k_proj", "v_proj"):
            if cfg.lora_rank > 0 and proj in cfg.lora_targets:
                attn_order += [f"{proj}_lora_a", f"{proj}_lora_b"]
        if cfg.qk_norm:
            attn_order += ["q_norm", "k_norm"]
        if cfg.lora_rank > 0 and "o_proj" in cfg.lora_targets:
            attn_order += ["o_proj_lora_a", "o_proj_lora_b"]
        for name, leaf in self.named_parameters():
            parts = name.split(".")
            if name in root_count:
                plan.append((name, ((), root_count[name], "normal", 0.02), False))
            elif parts[-1] == "weight" and parts[-2].endswith("proj"):
                # layers.{i}.{self_attn|mlp}.{x}_proj.weight: an nn.Dense
                # kernel, lecun_normal over fan_in = the torch weight's columns.
                scope = (f"layers_{parts[1]}", parts[2], parts[3])
                mul = si.lecun_scale(leaf.shape[1])
                plan.append((name, (scope, 1, "truncated_normal", mul), True))
            elif parts[-1].endswith("_lora_a"):
                scope = (f"layers_{parts[1]}", parts[2])
                plan.append((name, (scope, attn_order.index(parts[-1]) + 1, "normal", 0.02),
                             False))
            else:  # biases, LoRA B, norms: constants
                plan.append((name, None, False))
        root = si.key(seed)
        return [
            (name, None if d is None else (si.param_key(root, d[0], d[1]), d[2], d[3]), t)
            for name, d, t in plan
        ]

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Llama":
        """Seeded init bit-equal to the JAX package's
        ``model.init(jax.random.key(seed), ...)`` (``models/seed_init.py``):
        embeddings, head and LoRA ``A`` normal(0.02), projections flax's
        lecun_normal (a normal truncated at two standard deviations, scaled
        to variance 1/fan_in), biases and LoRA ``B`` 0, norms 1 (0 in
        Gemma's offset form). Each draw is made in f32 on the parameter's
        device and rounded into the parameter's dtype."""
        from . import seed_init as si

        params = dict(self.named_parameters())
        for name, d, transposed in self.init_plan(int(seed)):
            leaf = params[name]
            if d is None:
                if name.endswith("norm.weight") and getattr(self.config, "rms_offset", False):
                    leaf.zero_()
                elif name.endswith("norm.weight") or name.endswith(("q_norm", "k_norm")):
                    leaf.fill_(1.0)
                else:
                    leaf.zero_()
                continue
            k, kind, mul = d
            shape = tuple(reversed(leaf.shape)) if transposed else tuple(leaf.shape)
            buf = torch.empty(shape, dtype=torch.float32, device=leaf.device)
            si.draw(k, kind, buf, mul=mul)
            leaf.copy_(buf.t() if transposed else buf)
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
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:  # the block's forward runs again in the backward
                def run(x, cos, sin, layer=layer, i=i):
                    return layer(x, cos, sin, None, i, None)

                x = _Remat.apply(run, x, cos, sin, *layer.parameters())
            else:
                x = layer(x, cos, sin, cache, i, offset)
        if cache is not None:
            cache.advance(input_ids.shape[1])
        x = self.norm(x)
        if not with_head:
            return x
        head = self.embed_tokens if cfg.tie_word_embeddings else self.lm_head
        return torch.einsum("bse,ve->bsv", x.float(), head.float())
