"""Port hygiene: hypha_tpu_torch and chip_smoke.py import no JAX, nothing
of the JAX package, and no package the card's machine lacks (safetensors,
httpx); entry points never drop quietly to the CPU; the kernel
dispatchers never fall back to the plain versions."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from hypha_tpu_torch.hw import default_device
from hypha_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_dkv_cuda,
    flash_dq_cuda,
    flash_forward_cuda,
)
from hypha_tpu_torch.ops.paged_attention import PagedKV, paged_attention, ragged_paged_attention

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hypha_tpu", "safetensors", "httpx"}


def _port_files():
    files = sorted((ROOT / "hypha_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    bad = [
        f"{p.relative_to(ROOT)}:{line} imports {mod}"
        for p in _port_files()
        for mod, line in _imported_roots(p)
        if mod in FORBIDDEN
    ]
    assert not bad, bad


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


def _cpu_view():
    kv = PagedKV(torch.zeros(8, 1, 64), torch.zeros(8, 1, 64), None, None,
                 torch.full((1, 1), 1, dtype=torch.int32))
    return torch.zeros(1, 1, 1, 64), kv, torch.zeros(1, dtype=torch.int32)


def test_forced_kernel_on_cpu_tensors_raises():
    q, kv, off = _cpu_view()
    before = paged_attention.plain_calls
    with pytest.raises(RuntimeError, match="CUDA"):
        paged_attention(q, kv, blocks=1, block_size=4, q_offset=off, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ragged_paged_attention(q, kv, blocks=1, block_size=4, q_offset=off)
    assert paged_attention.plain_calls == before, "no quiet fallback to the plain version"


def test_flash_kernels_refuse_cpu_tensors():
    q = torch.zeros(1, 4, 2, 64)
    before = flash_attention.plain_calls
    with pytest.raises(ValueError, match="CUDA"):
        flash_forward_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_dq_cuda(q, q, q, q, torch.zeros(1, 2, 4), q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_dkv_cuda(q, q, q, q, torch.zeros(1, 2, 4), q)
    assert flash_attention.plain_calls == before, "no quiet fallback to the plain version"
