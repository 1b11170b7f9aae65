"""Port parity: ragged paged attention. The port's plain
``ragged_block_attention`` against the JAX package's XLA version and its
Pallas ``_ragged_kernel`` (interpret mode, as tests/test_paged_attention.py
runs it), on pool-valid states made with numpy: prefix-packed disjoint
lane tables, idle lanes with all-sentinel tables, garbage and unallocated
blocks poisoned. f32, atol 1e-5."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypha_tpu.ops.kvcache import _quantize_rows as j_quant
from hypha_tpu.ops.paged_attention import PagedKV as JKV
from hypha_tpu.ops.paged_attention import paged_attention as j_paged
from hypha_tpu.ops.paged_attention import ragged_block_attention as j_ragged
from hypha_tpu_torch.ops.paged_attention import PagedKV as TKV
from hypha_tpu_torch.ops.paged_attention import paged_attention as t_paged
from hypha_tpu_torch.ops.paged_attention import ragged_block_attention as t_ragged

ATOL = 1e-5


def _state(seed, *, B=3, hq, hkv, D=8, bs, max_blocks=4, sq, full=False, idle=(1,),
           quant=False, zero_rows=False, poison=1e4):
    rng = np.random.default_rng(seed)
    blocks = B * max_blocks + 2
    rows = (blocks + 1) * bs
    k = rng.standard_normal((rows, hkv, D)).astype(np.float32)
    v = rng.standard_normal((rows, hkv, D)).astype(np.float32)
    table = np.full((B, max_blocks), blocks, np.int32)
    qoff = np.zeros(B, np.int32)
    free = list(rng.permutation(blocks))
    held = np.zeros(blocks + 1, bool)
    for b in range(B):
        if b in idle and not full:
            qoff[b] = max_blocks * bs
            continue
        occ = max_blocks if full else int(rng.integers(1, max_blocks + 1))
        table[b, :occ] = [free.pop() for _ in range(occ)]
        held[table[b, :occ]] = True
        hi, lo = occ * bs - sq, max((occ - 1) * bs - sq + 1, 0)
        qoff[b] = int(rng.integers(lo, hi + 1)) if hi >= lo else 0
    unreachable = np.repeat(~held, bs)
    k[unreachable] = poison
    v[unreachable] = poison
    if zero_rows:  # rows whose int8 scale is zero must read back as zeros
        k[:: 3] = 0.0
        v[1:: 4] = 0.0
    q = rng.standard_normal((B, sq, hq, D)).astype(np.float32)
    ks = vs = None
    if quant:
        k, ks = (np.array(a) for a in j_quant(jnp.asarray(k)))
        v, vs = (np.array(a) for a in j_quant(jnp.asarray(v)))
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table, qoff=qoff, blocks=blocks,
                bs=bs, unreachable=unreachable)


def _opt(a, conv):
    return None if a is None else conv(a)


def _port(s, *, k_start=None, window=None, **kw):
    kv = TKV(*(_opt(s[n], torch.from_numpy) for n in ("k", "v", "ks", "vs", "table")))
    return t_ragged(
        torch.from_numpy(s["q"]), kv, blocks=s["blocks"], block_size=s["bs"],
        q_offset=torch.from_numpy(s["qoff"]), k_start=_opt(k_start, torch.from_numpy),
        window=window, **kw,
    ).numpy()


def _jax(s, *, kernel=False, k_start=None, window=None):
    kv = JKV(*(_opt(s[n], jnp.asarray) for n in ("k", "v", "ks", "vs", "table")))
    kw = dict(blocks=s["blocks"], block_size=s["bs"], q_offset=jnp.asarray(s["qoff"]),
              k_start=_opt(k_start, jnp.asarray), window=window)
    if kernel:
        return np.asarray(j_paged(jnp.asarray(s["q"]), kv, use_kernel=True, interpret=True, **kw))
    return np.asarray(j_ragged(jnp.asarray(s["q"]), kv, **kw))


@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_plain_matches_jax_partial_occupancy(hq, hkv, bs, sq):
    s = _state(hq * 100 + bs * 10 + sq, hq=hq, hkv=hkv, bs=bs, sq=sq)
    got = _port(s)
    np.testing.assert_allclose(got, _jax(s), atol=ATOL, rtol=0)
    assert np.all(got[1] == 0), "idle lane must be exactly zero"


@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_plain_matches_pallas_kernel_interpret(hq, hkv, sq):
    s = _state(7 + sq, hq=hq, hkv=hkv, bs=4, sq=sq)
    np.testing.assert_allclose(_port(s), _jax(s, kernel=True), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bs", [4, 8])
def test_full_occupancy_takes_the_dense_branch(bs):
    """Every lane full: the reference's dense gather branch, both sides."""
    s = _state(21, hq=4, hkv=2, bs=bs, sq=1, full=True)
    np.testing.assert_allclose(_port(s), _jax(s), atol=ATOL, rtol=0)


def test_window_and_k_start():
    s = _state(5, hq=8, hkv=2, bs=4, sq=4, max_blocks=6)
    kst = np.array([3, 0, 6], np.int32)
    got = _port(s, k_start=kst, window=9)
    np.testing.assert_allclose(got, _jax(s, k_start=kst, window=9), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _jax(s, kernel=True, k_start=kst, window=9), atol=ATOL, rtol=0)


def test_int8_with_zero_scale_rows():
    s = _state(9, hq=4, hkv=2, bs=4, sq=4, quant=True, zero_rows=True)
    assert (s["ks"] == 0).any() and (s["vs"] == 0).any()
    got = _port(s)
    np.testing.assert_allclose(got, _jax(s), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _jax(s, kernel=True), atol=ATOL, rtol=0)


@pytest.mark.parametrize("blocks_per_iter", [0, 1, 3])
def test_poisoned_unreachable_blocks_never_contribute(blocks_per_iter):
    """Re-poisoning the garbage block and every unallocated block leaves
    every output bit, at any streaming chunk width."""
    s = _state(13, hq=8, hkv=2, bs=4, sq=4, max_blocks=5)
    a = _port(s, blocks_per_iter=blocks_per_iter)
    s["k"][s["unreachable"]] = -7e3
    s["v"][s["unreachable"]] = 3e4
    b = _port(s, blocks_per_iter=blocks_per_iter)
    np.testing.assert_array_equal(a, b)


def test_dispatcher_runs_plain_on_cpu_and_counts_it():
    s = _state(2, hq=4, hkv=2, bs=4, sq=1)
    kv = TKV(*(_opt(s[n], torch.from_numpy) for n in ("k", "v", "ks", "vs", "table")))
    before = t_paged.plain_calls
    got = t_paged(torch.from_numpy(s["q"]), kv, blocks=s["blocks"], block_size=4,
                  q_offset=torch.from_numpy(s["qoff"]))
    assert t_paged.plain_calls == before + 1
    np.testing.assert_allclose(got.numpy(), _jax(s), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "sq,dtype,route",
    [(1, torch.bfloat16, "simt"), (15, torch.bfloat16, "simt"), (16, torch.bfloat16, "mma"),
     (64, torch.bfloat16, "mma"), (1, torch.float32, "simt"), (64, torch.float32, "simt")],
)
def test_ragged_route_by_shape(sq, dtype, route):
    """Decode and every f32 call take the CUDA-core kernel; bf16 prefill
    chunks from MMA_MIN_ROWS rows up take the tensor-core kernel."""
    from hypha_tpu_torch.ops.paged_attention import MMA_MIN_ROWS, _ragged_route

    assert MMA_MIN_ROWS == 16
    assert _ragged_route(sq, dtype) == route


class _RecordingLibrary:
    """Stands in for the loaded kernel library: records each call."""

    def __init__(self):
        self.calls = []

    def ragged_paged_attention(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize(
    "sq,dtype,quant,route",
    [(1, torch.bfloat16, False, 0), (16, torch.bfloat16, False, 1), (4, torch.bfloat16, True, 0),
     (64, torch.bfloat16, True, 1), (64, torch.float32, False, 0)],
)
def test_wrapper_hands_the_route_to_the_kernel(monkeypatch, sq, dtype, quant, route):
    """The wrapper passes _ragged_route's choice to the C entry point (the
    argument before the stream) and counts the launch under that route."""
    import importlib

    from hypha_tpu_torch.ops import _build
    from hypha_tpu_torch.ops.paged_attention import ragged_paged_attention

    pa = importlib.import_module("hypha_tpu_torch.ops.paged_attention")
    lib = _RecordingLibrary()
    monkeypatch.setattr(pa, "_require_card", lambda q: None)
    monkeypatch.setattr(pa, "_stream", lambda q: "stream")
    monkeypatch.setattr(_build, "load_library", lambda *a: lib)
    s = _state(4, hq=4, hkv=2, D=64, bs=4, sq=sq, quant=quant)
    kv = TKV(*(_opt(s[n], torch.from_numpy) for n in ("k", "v", "ks", "vs", "table")))
    if not quant:
        kv = kv._replace(k=kv.k.to(dtype), v=kv.v.to(dtype))
    before = (ragged_paged_attention.launches, ragged_paged_attention.simt_launches,
              ragged_paged_attention.mma_launches)
    ragged_paged_attention(torch.from_numpy(s["q"]).to(dtype), kv, blocks=s["blocks"],
                           block_size=4, q_offset=torch.from_numpy(s["qoff"]))
    (args,) = lib.calls
    assert args[-1] == "stream"
    assert args[-2] == route
    assert args[-4:-2] == (0 if dtype == torch.bfloat16 else 1, int(quant))
    after = (ragged_paged_attention.launches, ragged_paged_attention.simt_launches,
             ragged_paged_attention.mma_launches)
    assert after == (before[0] + 1, before[1] + (route == 0), before[2] + (route == 1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90); tests/test_torch_cuda.py holds the card tests")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda):
    from hypha_tpu_torch.ops.paged_attention import ragged_paged_attention

    s = _state(3, hq=8, hkv=2, D=64, bs=8, sq=4)
    kv = TKV(*(_opt(s[n], lambda a: torch.from_numpy(a).to(cuda)) for n in ("k", "v", "ks", "vs", "table")))
    q, qoff = torch.from_numpy(s["q"]).to(cuda), torch.from_numpy(s["qoff"]).to(cuda)
    kw = dict(blocks=s["blocks"], block_size=8, q_offset=qoff)
    got = ragged_paged_attention(q, kv, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), t_ragged(q, kv, **kw).cpu().numpy(), atol=1e-4, rtol=0)
