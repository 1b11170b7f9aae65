"""Port parity: seeded weights (``hypha_tpu_torch/models/seed_init.py``)
held bit for bit against ``jax.random`` and flax's ``model.init`` on the CPU.

* threefry, ``key``, ``fold_in``, ``split`` and 32-bit random bits under
  partitionable counters equal ``jax.random``'s, for odd lengths too;
* ``normal`` and ``truncated_normal`` over 2^20 + 3 draws, XLA's ``erf_inv``
  over every mantissa the uniform can produce, and index ranges drawn alone;
* each family's whole seeded θ₀ at its tiny preset (Llama, Mistral, Qwen2,
  Qwen3, Gemma; f32 and bf16; with and without LoRA adapters) equals
  ``model.init(jax.random.key(seed), ...)`` of ``hypha_tpu.models``;
* the draw kernel's C entry point has the arity ``ops/_build.py`` binds,
  and a CPU tensor never reaches it.
"""

from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_parity import FAMILIES
from hypha_tpu.executor.serialization import flatten_tree
from hypha_tpu.models import Llama as JLlama
from hypha_tpu.models import LlamaConfig as JConfig
from hypha_tpu_torch.models import Llama
from hypha_tpu_torch.models import LlamaConfig as TConfig
from hypha_tpu_torch.models import seed_init as si
from hypha_tpu_torch.models.convert import llama_params_to_flat
from hypha_tpu_torch.ops import _build

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]


def _words(key) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)).reshape(-1))


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_partitionable_counters_are_the_installed_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_and_bits_match_jax(seed):
    k = jax.random.key(seed)
    assert _words(k) == si.key(seed)
    for data in (0, 1, 12345, 2**32 - 1):
        assert _words(jax.random.fold_in(k, data)) == si.fold_in(si.key(seed), data)
    want = [tuple(int(x) for x in w) for w in np.asarray(jax.random.key_data(jax.random.split(k, 5)))]
    assert want == si.split(si.key(seed), 5)
    for shape in [(1,), (7,), (3, 5), (1001,)]:
        bits = np.asarray(jax.random.bits(k, shape, jnp.uint32)).reshape(-1).astype(np.int64)
        got = si.random_bits(si.key(seed), 0, int(np.prod(shape))).numpy()
        assert np.array_equal(bits, got), shape


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", ["normal", "truncated_normal"])
def test_million_draws_are_bit_equal(kind, seed):
    n = (1 << 20) + 3
    k = jax.random.key(seed)
    want = (jax.random.normal(k, (n,)) if kind == "normal"
            else jax.random.truncated_normal(k, -2.0, 2.0, (n,)))
    got = si.draw_plain(si.key(seed), kind, 0, n, mul=1.0)
    assert _bits_equal(want, got)


def test_erf_inv_over_every_uniform_mantissa():
    """The normal's uniform takes 2^23 values; XLA's ``erf_inv`` of each,
    times sqrt(2), fused as ``_normal_real`` fuses it, against the port's."""
    m = np.arange(1 << 23, dtype=np.uint32)
    lo = np.nextafter(np.float32(-1), np.float32(0))

    @jax.jit
    def ref(fb):
        f = lax.bitcast_convert_type(fb, jnp.float32) - jnp.float32(1)
        u = lax.max(lo, f * (jnp.float32(1) - lo) + lo)
        return jnp.float32(np.sqrt(2)) * lax.erf_inv(u)

    want = ref(jnp.asarray(m | np.uint32(0x3F800000)))
    u = si.uniform(torch.from_numpy(m.astype(np.int64) << 9), lo, 1.0)
    got = torch.tensor(np.float32(np.sqrt(2))) * si.erf_inv(u)
    assert _bits_equal(want, got)


@pytest.mark.parametrize("kind", ["normal", "truncated_normal"])
def test_index_ranges_draw_alone(kind):
    k = si.fold_in(si.key(11), 7)
    full = si.draw_plain(k, kind, 0, 5000, mul=0.02)
    for a, b in [(0, 1), (17, 4099), (4999, 5000)]:
        assert torch.equal(si.draw_plain(k, kind, a, b, mul=0.02), full[a:b])
    out = torch.empty(4000)
    si.draw(k, kind, out, 1000, mul=0.02)
    assert torch.equal(out, full[1000:])


def test_lecun_scale_and_erf_bounds_match_jax():
    for fan_in in (16, 64, 4096, 11008):
        std = jnp.sqrt(jnp.array(1.0 / fan_in, jnp.float32)) / jnp.array(
            0.87962566103423978, jnp.float32)
        assert _bits_equal(std, si.lecun_scale(fan_in))
    a = lax.erf(jnp.float32(-2.0) / jnp.float32(np.sqrt(2)))
    assert _bits_equal(a, si._erf32(-2.0))


FAMILY_CASES = [(f, d, lora) for f in FAMILIES for d in ("float32", "bfloat16")
                for lora in (False, True)]


@pytest.mark.parametrize("family,dtype,lora", FAMILY_CASES,
                         ids=[f"{f}-{d}-{'lora' if lo else 'base'}" for f, d, lo in FAMILY_CASES])
def test_seeded_theta0_is_the_jax_init(family, dtype, lora):
    over = dict(FAMILIES[family])
    if lora:
        over.update(lora_rank=4, lora_targets=("q_proj", "k_proj", "v_proj", "o_proj"))
    seed = 7
    jm = JLlama(dataclasses.replace(JConfig.tiny(), dtype=dtype, **over))
    want = flatten_tree(jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32)))
    tm = Llama(dataclasses.replace(TConfig.tiny(), dtype=dtype, **over), device="cpu")
    got = llama_params_to_flat(tm.init_weights(seed))
    assert set(got) == set(want)
    for name, arr in want.items():
        assert _bits_equal(arr, got[name]), name


def test_a_bf16_model_holds_the_f32_draw_rounded():
    """A model stored in bf16 gets the f32 θ₀ rounded to bf16, as the JAX
    serving path casts its f32 init (``astype(bfloat16)``)."""
    cfg = dataclasses.replace(TConfig.tiny(), dtype="bfloat16")
    f32 = Llama(cfg, device="cpu").init_weights(3)
    bf16 = Llama(cfg, device="cpu").to(torch.bfloat16).init_weights(3)
    for (n, a), (_, b) in zip(f32.named_parameters(), bf16.named_parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b), n


def test_draw_kernel_entry_point_matches_its_binding():
    src = (_build.CSRC / "seed_init.cu").read_text()
    assert "seed_init.cu" in _build.SOURCES
    m = re.search(r'extern "C"\s*\{.*?int seed_init_draw\(([^)]*)\)', src, re.S)
    assert m, "seed_init_draw is not extern \"C\""
    params = [p for p in m.group(1).split(",") if p.strip()]

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, type("F", (), {})())

    lib = Lib()
    _build._bind(lib, "seed_init.cu")
    assert len(lib.fns["seed_init_draw"].argtypes) == len(params)
    assert re.search(r"__global__\s+void\s+seed_init_draw_kernel\(", src)


def test_a_cpu_tensor_takes_the_plain_version(monkeypatch):
    def no_kernel(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(si, "_launch", no_kernel)
    before = si.seed_launches["draw"]
    out = torch.empty(100)
    si.draw(si.key(1), "normal", out, mul=0.02)
    assert si.seed_launches["draw"] == before
    assert torch.equal(out, si.draw_plain(si.key(1), "normal", 0, 100, mul=0.02))
