"""The ragged paged-attention kernels' contract with the code around them,
on the CPU.

* ``chip_smoke.py`` finds the kernels in the profiler by name
  (``RAGGED_NAMES``, matched by substring): each name must be a
  ``__global__`` function of ``ops/csrc/ragged_paged_attention.cu`` that no
  other kernel's name contains, or a renamed kernel would read 0 ms.
* ``ops/_build.py`` binds the C entry point with ``ctypes``: it must be
  ``extern "C"`` in the source, with as many parameters as it is bound to
  (a ctypes arity mismatch does not raise: it passes garbage pointers).
* The wrapper counts a launch per route, and a failed launch raises on
  every route and counts nothing: there is no fallback.
"""

from __future__ import annotations

import ast
import importlib
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from hypha_tpu_torch.ops import _build
from hypha_tpu_torch.ops.paged_attention import PagedKV, _launch, ragged_paged_attention

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (_build.CSRC / "ragged_paged_attention.cu").read_text()
pa = importlib.import_module("hypha_tpu_torch.ops.paged_attention")


def _smoke_constant(name: str):
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            return ast.literal_eval(node.value)
    raise AssertionError(f"chip_smoke.py assigns no {name}")


RAGGED_NAMES = _smoke_constant("RAGGED_NAMES")
KERNELS = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", SOURCE)


def _bound_entry_points(source: str) -> dict:
    """{C name: ctypes argtypes} as ``_build._bind`` declares them."""

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, SimpleNamespace())

    lib = Lib()
    _build._bind(lib, source)
    return {name: getattr(fn, "argtypes", None) for name, fn in lib.fns.items()}


ENTRY_POINTS = _bound_entry_points("ragged_paged_attention.cu")


def test_smoke_names_every_kernel_of_the_source():
    """The profile sums attention over RAGGED_NAMES: every kernel of the
    source is in it, the decode kernel and its merge among them."""
    assert sorted(RAGGED_NAMES) == sorted(KERNELS)
    assert {"ragged_decode_kernel", "ragged_decode_merge_kernel"} <= set(RAGGED_NAMES)


@pytest.mark.parametrize("name", RAGGED_NAMES)
def test_profiled_name_is_one_kernel_of_the_source(name):
    """The profiler rows are matched by substring: exactly one kernel of the
    source may carry the name."""
    assert name in KERNELS, f"{name} is not a __global__ function of ragged_paged_attention.cu"
    assert [k for k in KERNELS if name in k] == [name]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_bound_entry_point_is_extern_c(name):
    m = re.search(r'extern "C"\s+[\w\s\*]+?\b' + name + r"\s*\(([^)]*)\)", SOURCE)
    assert m, f'{name} is bound in ops/_build.py but not extern "C" in ragged_paged_attention.cu'
    if name != "ragged_paged_attention_error":
        assert len(m.group(1).split(",")) == len(ENTRY_POINTS[name]), "C parameters != ctypes argtypes"


def test_smoke_counts_every_route_of_the_wrapper():
    assert sorted(_smoke_constant("ROUTES")) == sorted(pa._ROUTES)
    assert all(hasattr(ragged_paged_attention, f"{r}_launches") for r in pa._ROUTES)


class _FailingLibrary:
    """Stands in for the loaded library: every launch returns an error."""

    def __init__(self):
        self.calls = 0

    def ragged_paged_attention(self, *args):
        self.calls += 1
        return 1

    def ragged_paged_attention_error(self, err):
        return b"invalid argument"


@pytest.mark.parametrize("route,sq", [("decode", 1), ("simt", 1), ("mma", 16)])
def test_failed_launch_raises_and_counts_nothing(monkeypatch, route, sq):
    lib = _FailingLibrary()
    monkeypatch.setattr(pa, "_require_card", lambda q: None)
    monkeypatch.setattr(pa, "_stream", lambda q: "stream")
    monkeypatch.setattr(pa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "load_library", lambda *a: lib)
    B, Hq, Hkv, D, bs, max_blocks, blocks = 2, 4, 2, 64, 16, 8, 16
    rows = (blocks + 1) * bs
    kv = PagedKV(torch.zeros(rows, Hkv, D, dtype=torch.bfloat16),
                 torch.zeros(rows, Hkv, D, dtype=torch.bfloat16), None, None,
                 torch.full((B, max_blocks), blocks, dtype=torch.int32))
    q = torch.zeros(B, sq, Hq, D, dtype=torch.bfloat16)
    names = ["launches"] + [f"{r}_launches" for r in pa._ROUTES]
    before = [getattr(ragged_paged_attention, n) for n in names]
    with pytest.raises(RuntimeError, match=rf"launch failed \({route}\): invalid argument"):
        _launch(q, kv, route, blocks=blocks, block_size=bs,
                q_offset=torch.zeros(B, dtype=torch.int32))
    assert lib.calls == 1
    assert [getattr(ragged_paged_attention, n) for n in names] == before


@pytest.mark.parametrize("sq,dtype,msg", [(2, torch.bfloat16, "one query row"),
                                          (1, torch.float32, "bfloat16 q only")])
def test_decode_route_refuses_what_its_kernel_does_not_take(monkeypatch, sq, dtype, msg):
    monkeypatch.setattr(pa, "_require_card", lambda q: None)
    kv = PagedKV(torch.zeros(34, 2, 64, dtype=dtype), torch.zeros(34, 2, 64, dtype=dtype),
                 None, None, torch.full((2, 4), 16, dtype=torch.int32))
    q = torch.zeros(2, sq, 4, 64, dtype=dtype)
    with pytest.raises(ValueError, match=msg):
        _launch(q, kv, "decode", blocks=16, block_size=2, q_offset=torch.zeros(2, dtype=torch.int32))
