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
    [(1, torch.bfloat16, "decode"), (2, torch.bfloat16, "simt"), (15, torch.bfloat16, "simt"),
     (16, torch.bfloat16, "mma"), (64, torch.bfloat16, "mma"), (1, torch.float32, "simt"),
     (64, torch.float32, "simt")],
)
def test_ragged_route_by_shape(sq, dtype, route):
    """bf16 decode takes the decode kernel, bf16 prefill chunks from
    MMA_MIN_ROWS rows up the tensor-core kernel, every f32 call and short
    bf16 chunk the CUDA-core kernel."""
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
    "sq,dtype,quant,max_blocks,route",
    [(1, torch.bfloat16, False, 4, 2), (1, torch.bfloat16, False, 48, 2),
     (1, torch.bfloat16, True, 4, 2), (1, torch.bfloat16, True, 48, 2),
     (1, torch.float32, False, 4, 0), (1, torch.float32, True, 48, 0),
     (16, torch.bfloat16, False, 4, 1), (4, torch.bfloat16, True, 4, 0),
     (64, torch.bfloat16, True, 4, 1), (64, torch.float32, False, 4, 0)],
)
def test_wrapper_hands_the_route_to_the_kernel(monkeypatch, sq, dtype, quant, max_blocks, route):
    """The wrapper passes _ragged_route's choice to the C entry point (the
    arguments before the stream: route, key splits, workspace) and counts
    the launch under that route. The decode route gets _decode_splits'
    count and, past one split, an f32 workspace of B * Hq * splits * (D + 2);
    the other routes one split and no workspace."""
    import importlib

    from hypha_tpu_torch.ops import _build
    from hypha_tpu_torch.ops.paged_attention import _decode_splits, ragged_paged_attention

    pa = importlib.import_module("hypha_tpu_torch.ops.paged_attention")
    lib = _RecordingLibrary()
    monkeypatch.setattr(pa, "_require_card", lambda q: None)
    monkeypatch.setattr(pa, "_stream", lambda q: "stream")
    monkeypatch.setattr(pa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "load_library", lambda *a: lib)
    allocs = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocs.append(t)
        return t

    monkeypatch.setattr(pa.torch, "empty", recording_empty)
    s = _state(4, hq=4, hkv=2, D=64, bs=4, sq=sq, quant=quant, max_blocks=max_blocks)
    kv = TKV(*(_opt(s[n], torch.from_numpy) for n in ("k", "v", "ks", "vs", "table")))
    if not quant:
        kv = kv._replace(k=kv.k.to(dtype), v=kv.v.to(dtype))
    names = ("launches", "simt_launches", "mma_launches", "decode_launches")
    before = [getattr(ragged_paged_attention, n) for n in names]
    ragged_paged_attention(torch.from_numpy(s["q"]).to(dtype), kv, blocks=s["blocks"],
                           block_size=4, q_offset=torch.from_numpy(s["qoff"]))
    (args,) = lib.calls
    assert args[-1] == "stream"
    assert args[-4] == route
    assert args[-6:-4] == (0 if dtype == torch.bfloat16 else 1, int(quant))
    splits, ws = args[-3], args[-2].value
    if route == 2:
        assert splits == _decode_splits(3, 2, max_blocks, 4, 132)
        assert (splits > 1) == (max_blocks == 48)
    else:
        assert splits == 1
    if splits > 1:
        (buf,) = allocs
        assert ws == buf.data_ptr() and buf.dtype == torch.float32
        assert buf.numel() == 3 * 4 * splits * (64 + 2)
    else:
        assert ws is None and not allocs
    after = [getattr(ragged_paged_attention, n) for n in names]
    assert after == [before[0] + 1, before[1] + (route == 0), before[2] + (route == 1),
                     before[3] + (route == 2)]


@pytest.mark.parametrize("sms", [114, 132])
def test_decode_splits_depend_only_on_the_shapes(sms):
    """The split count is a function of (B, Hkv, max_blocks, block_size)
    and the card's SM count alone (114 on the PCIe H100, 132 on the SXM
    part), so a decode launch is the same at every step; at the
    Llama-2-7B and GQA 32/8 serving shapes (8 lanes, 64 entries of 16) it
    gives the most splits that keep the grid within two CTAs per SM (at
    least 0.9 of two per SM on the SXM part), and never fewer than two
    32-key tiles of the longest window per split. At 132 SMs the counts are the
    ones the rule gave when it assumed the SXM part."""
    import inspect

    from hypha_tpu_torch.ops.paged_attention import DECODE_TILE, _decode_splits

    assert list(inspect.signature(_decode_splits).parameters) == [
        "batch", "kv_heads", "max_blocks", "block_size", "sms"]
    for B, hkv in ((8, 32), (8, 8), (4, 8), (1, 32)):
        n = _decode_splits(B, hkv, 64, 16, sms)
        assert n == _decode_splits(B, hkv, 64, 16, sms) >= 1
        assert B * hkv * n <= 2 * sms or n == 1  # never past two CTAs per SM
        assert B * hkv * (n + 1) > 2 * sms  # the most splits that stay within
        if sms == 132:
            assert B * hkv * n >= 2 * sms * 0.9
        assert n * 2 * DECODE_TILE <= 64 * 16
    assert _decode_splits(1, 8, 1, 16, sms) == 1  # one tile: nothing to split
    assert _decode_splits(64, 32, 64, 16, sms) == 1  # the card is full without splits
    assert all(_decode_splits(B, 8, 64, 16, sms) >= _decode_splits(B + 1, 8, 64, 16, sms)
               for B in range(1, 64))
    # The serving shapes' counts: 7B (8 lanes x 32 kv heads) and GQA 32/8.
    assert [_decode_splits(8, h, 64, 16, sms) for h in (32, 8)] == {
        114: [1, 3], 132: [1, 4]}[sms]


# The decode route's split and merge (_split_decode_plain, the plain mirror
# of ragged_decode_kernel + ragged_decode_merge_kernel) against the JAX
# package's Pallas kernel in interpret mode and its XLA version, at f32.
# Each case runs several split counts and tile widths against one JAX
# output: 5-key tiles cut blocks of 4, 16 and 48 keys mid-block, and
# 8 or 16 splits leave some with no visible key.
SPLITS = (1, 2, 3, 8, 16)
TILES = (32, 5)


def _check_split_decode(s, **mask):
    from hypha_tpu_torch.ops.paged_attention import _split_decode_plain

    want = _jax(s, kernel=True, **mask)
    np.testing.assert_allclose(_jax(s, **mask), want, atol=ATOL, rtol=0)
    kv = TKV(*(_opt(s[n], torch.from_numpy) for n in ("k", "v", "ks", "vs", "table")))
    kst = mask.get("k_start")
    for splits in SPLITS:
        for tile in TILES:
            got = _split_decode_plain(
                torch.from_numpy(s["q"]), kv, blocks=s["blocks"], block_size=s["bs"],
                q_offset=torch.from_numpy(s["qoff"]), k_start=_opt(kst, torch.from_numpy),
                window=mask.get("window"), splits=splits, tile=tile,
            ).numpy()
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"{splits} x {tile}")
            assert np.all(got[1] == 0), "idle lane must be exactly zero"


@pytest.mark.parametrize("bs,max_blocks", [(4, 12), (16, 4), (48, 2)])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2), (7, 1)])  # G 1, 4, 7
def test_split_decode_matches_pallas_kernel_interpret(hq, hkv, bs, max_blocks):
    s = _state(31 * hq + bs, hq=hq, hkv=hkv, bs=bs, max_blocks=max_blocks, sq=1)
    _check_split_decode(s)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (7, 1)])
def test_split_decode_window_and_k_start(hq, hkv):
    s = _state(17 + hq, hq=hq, hkv=hkv, bs=4, sq=1, max_blocks=12)
    _check_split_decode(s, k_start=np.array([3, 0, 9], np.int32), window=13)


@pytest.mark.parametrize("bs", [4, 16])
def test_split_decode_int8_with_zero_scale_rows(bs):
    s = _state(23 + bs, hq=8, hkv=2, bs=bs, sq=1, max_blocks=48 // bs, quant=True, zero_rows=True)
    assert (s["ks"] == 0).any() and (s["vs"] == 0).any()
    _check_split_decode(s)


def test_split_decode_splits_with_no_visible_key():
    """A window of 3 keys leaves one 5-key tile per lane: every split but
    one sees nothing (m = -inf, l = 0) and the merge must skip them."""
    from hypha_tpu_torch.ops.paged_attention import _split_decode_plain

    s = _state(41, hq=4, hkv=2, bs=4, sq=1, max_blocks=12)
    kv = TKV(*(_opt(s[n], torch.from_numpy) for n in ("k", "v", "ks", "vs", "table")))
    want = _jax(s, kernel=True, window=3)
    got = _split_decode_plain(torch.from_numpy(s["q"]), kv, blocks=s["blocks"], block_size=4,
                              q_offset=torch.from_numpy(s["qoff"]), window=3, splits=16, tile=5)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(got.numpy()[1] == 0)


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
