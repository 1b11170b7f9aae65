"""The flash kernels' contract with the code around them, on the CPU.

* ``chip_smoke.py`` finds the kernels in the profiler by name
  (``FLASH_NAMES``, matched by substring): each name must be a
  ``__global__`` function of ``ops/csrc/flash_attention.cu`` that no other
  kernel's name contains, or a renamed kernel would read 0 ms.
* ``ops/_build.py`` binds the C entry points with ``ctypes``: each must be
  ``extern "C"`` in the source, with as many parameters as it is bound to.
* The wrappers hand the C entry points what the kernels expect (dtype code,
  causal flag, window, the 15 strides, dims, pointers) and count each
  launch, checked with a recording stand-in for the library.
"""

from __future__ import annotations

import ast
import ctypes
import importlib
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from hypha_tpu_torch.ops import _build
from hypha_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_dkv_cuda,
    flash_dq_cuda,
    flash_forward_cuda,
)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (_build.CSRC / "flash_attention.cu").read_text()
fa = importlib.import_module("hypha_tpu_torch.ops.flash_attention")


def _smoke_constant(name: str):
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            return node.value
    raise AssertionError(f"chip_smoke.py assigns no {name}")


FLASH_NAMES = ast.literal_eval(_smoke_constant("FLASH_NAMES"))
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


ENTRY_POINTS = _bound_entry_points("flash_attention.cu")


def test_smoke_names_the_three_bf16_kernels():
    """Training runs bf16: the profile reads the tensor-core kernels, while
    the f32 CUDA-core kernels stay in the source."""
    assert len(FLASH_NAMES) == 3 and all(n.endswith("_mma_kernel") for n in FLASH_NAMES)
    assert {"flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"} <= set(KERNELS)


@pytest.mark.parametrize("name", FLASH_NAMES)
def test_profiled_name_is_one_kernel_of_the_source(name):
    """The profiler rows are matched by substring: exactly one kernel of the
    source may carry the name."""
    assert name in KERNELS, f"{name} is not a __global__ function of flash_attention.cu"
    assert [k for k in KERNELS if name in k] == [name]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_bound_entry_point_is_extern_c(name):
    m = re.search(r'extern "C"\s+[\w\s\*]+?\b' + name + r"\s*\(([^)]*)\)", SOURCE)
    assert m, f'{name} is bound in ops/_build.py but not extern "C" in flash_attention.cu'
    argtypes = ENTRY_POINTS[name]
    if name != "flash_attention_error":
        assert len(m.group(1).split(",")) == len(argtypes), "C parameters != ctypes argtypes"


class _RecordingLibrary:
    """Stands in for the loaded flash library: records each call and
    returns ``err``."""

    def __init__(self, err: int = 0):
        self.calls = []
        self.err = err

    def _record(self, *args):
        self.calls.append(args)
        return self.err

    flash_attention_forward = _record
    flash_attention_backward_dq = _record
    flash_attention_backward_dkv = _record

    def flash_attention_error(self, err):
        return b"invalid argument"


@pytest.fixture
def lib(monkeypatch):
    rec = _RecordingLibrary()
    monkeypatch.setattr(fa, "_check_inputs", lambda *t: None)
    monkeypatch.setattr(fa, "_stream", lambda t: "stream")
    monkeypatch.setattr(_build, "load_library", lambda *a: rec)
    return rec


def _inputs(dtype, strided: bool, B=2, Sq=5, Sk=7, H=4, Hkv=2, D=64):
    """q, k, v, o, dO and L on the CPU; ``strided`` takes q, k and v as
    views into one fused projection, as a model's qkv matmul gives them."""
    if strided:
        qkv = torch.zeros(B, Sq, H + 2 * Hkv, D, dtype=dtype)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    else:
        q = torch.zeros(B, Sq, H, D, dtype=dtype)
        k, v = (torch.zeros(B, Sk, Hkv, D, dtype=dtype) for _ in range(2))
    o, do = (torch.zeros(B, Sq, H, D, dtype=dtype) for _ in range(2))
    lse = torch.zeros(B, H, Sq, dtype=torch.float32)
    return q, k, v, o, lse, do


def _ptr(x):
    return x.value if isinstance(x, ctypes.c_void_p) else x


COUNTERS = ("fwd_launches", "dq_launches", "dkv_launches", "plain_calls")


def _counters():
    return {c: getattr(flash_attention, c) for c in COUNTERS}


def _check_tail(args, q, k, *, strides, causal, window, dtype):
    """The arguments after the pointers: dims, strides, scale, causal,
    window, dtype code, stream."""
    B, Sq, H, D = q.shape
    assert args[-12:-6] == (B, H, k.shape[2], Sq, k.shape[1], D)
    assert list(args[-6]) == strides
    assert args[-5] == pytest.approx(D ** -0.5)
    assert args[-4] == int(causal)
    assert args[-3] == (0 if window is None else window)
    assert args[-2] == (0 if dtype == torch.bfloat16 else 1)
    assert args[-1] == "stream"


MASKS = [(True, None), (False, None), (True, 100), (False, 7)]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dq_wrapper_hands_the_kernel_its_arguments(lib, dtype, causal, window, strided):
    q, k, v, o, lse, do = _inputs(dtype, strided, Sk=5 if strided else 7)
    before = _counters()
    dq = flash_dq_cuda(q, k, v, o, lse, do, causal, None, window)
    (args,) = lib.calls
    assert len(args) == 7 + 6 + 6
    assert [_ptr(a) for a in args[:7]] == [t.data_ptr() for t in (q, k, v, o, do, lse, dq)]
    assert dq.shape == q.shape and dq.dtype == dtype
    strides = [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
    _check_tail(args, q, k, strides=strides, causal=causal, window=window, dtype=dtype)
    assert _counters() == {**before, "dq_launches": before["dq_launches"] + 1}


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dkv_wrapper_hands_the_kernel_its_arguments(lib, dtype, causal, window, strided):
    q, k, v, o, lse, do = _inputs(dtype, strided, Sk=5 if strided else 7)
    before = _counters()
    dk, dv = flash_dkv_cuda(q, k, v, o, lse, do, causal, None, window)
    (args,) = lib.calls
    assert len(args) == 8 + 6 + 6
    assert [_ptr(a) for a in args[:8]] == [t.data_ptr() for t in (q, k, v, o, do, lse, dk, dv)]
    assert dk.shape == k.shape and dv.shape == v.shape and dk.dtype == dv.dtype == dtype
    strides = [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
    _check_tail(args, q, k, strides=strides, causal=causal, window=window, dtype=dtype)
    assert _counters() == {**before, "dkv_launches": before["dkv_launches"] + 1}


@pytest.mark.parametrize("causal,window", [(True, None), (False, 9)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_wrapper_hands_the_kernel_its_arguments(lib, dtype, causal, window):
    q, k, v, *_ = _inputs(dtype, strided=True, Sk=5)
    before = _counters()
    o, lse = flash_forward_cuda(q, k, v, causal, None, window)
    (args,) = lib.calls
    assert len(args) == 5 + 6 + 6
    assert [_ptr(a) for a in args[:5]] == [t.data_ptr() for t in (q, k, v, o, lse)]
    strides = [s for t in (q, k, v) for s in t.stride()[:3]] + [0] * 6
    _check_tail(args, q, k, strides=strides, causal=causal, window=window, dtype=dtype)
    assert _counters() == {**before, "fwd_launches": before["fwd_launches"] + 1}


@pytest.mark.parametrize("wrapper", [flash_dq_cuda, flash_dkv_cuda])
def test_failed_launch_raises_and_counts_nothing(lib, wrapper):
    lib.err = 1
    q, k, v, o, lse, do = _inputs(torch.bfloat16, strided=False)
    before = _counters()
    with pytest.raises(RuntimeError, match="launch failed: invalid argument"):
        wrapper(q, k, v, o, lse, do, True)
    assert _counters() == before
