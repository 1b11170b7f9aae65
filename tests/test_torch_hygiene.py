"""Port hygiene: hypha_tpu_torch and chip_smoke.py import no JAX, nothing
of the JAX package, and no package the card's machine lacks (safetensors,
httpx, cryptography); the node roles that hold no tensor import no torch;
entry points never drop quietly to the CPU; the kernel dispatchers never
fall back to the plain versions."""

from __future__ import annotations

import ast
import importlib
import os
import subprocess
import sys
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
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hypha_tpu", "safetensors", "httpx",
             "cryptography", "ml_dtypes"}


def _port_files():
    files = sorted((ROOT / "hypha_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    rel = {str(p.relative_to(ROOT)) for p in files}
    for must in ("hypha_tpu_torch/network/node.py", "hypha_tpu_torch/network/fabric.py",
                 "hypha_tpu_torch/worker/arbiter.py", "hypha_tpu_torch/worker/runtime.py",
                 "hypha_tpu_torch/data_node.py", "hypha_tpu_torch/codec.py",
                 "hypha_tpu_torch/scheduler/orchestrator.py",
                 "hypha_tpu_torch/scheduler/batch_scheduler.py",
                 "hypha_tpu_torch/scheduler/metrics_bridge.py",
                 "hypha_tpu_torch/cli.py", "hypha_tpu_torch/__main__.py",
                 "hypha_tpu_torch/config.py", "hypha_tpu_torch/node_config.py",
                 "hypha_tpu_torch/worker/batcher.py", "hypha_tpu_torch/worker/infer_executor.py",
                 "hypha_tpu_torch/scheduler/serving.py",
                 "hypha_tpu_torch/compress/quant.py", "hypha_tpu_torch/compress/frame.py",
                 "hypha_tpu_torch/compress/feedback.py", "hypha_tpu_torch/stream/sync.py",
                 "hypha_tpu_torch/stream/partition.py", "hypha_tpu_torch/ft/__init__.py",
                 "hypha_tpu_torch/ft/detector.py", "hypha_tpu_torch/executor/block_cache.py",
                 "hypha_tpu_torch/ed25519.py", "hypha_tpu_torch/der.py",
                 "hypha_tpu_torch/certs.py", "hypha_tpu_torch/certutil.py",
                 "hypha_tpu_torch/network/secure.py", "hypha_tpu_torch/network/mux.py",
                 "hypha_tpu_torch/ft/membership.py", "hypha_tpu_torch/ft/rejoin.py",
                 "hypha_tpu_torch/ft/durable.py", "hypha_tpu_torch/ft/chaos.py",
                 "hypha_tpu_torch/executor/checkpoint.py",
                 "hypha_tpu_torch/executor/preprocess.py",
                 "hypha_tpu_torch/worker/slice_cache.py",
                 "hypha_tpu_torch/telemetry/ft_metrics.py",
                 "hypha_tpu_torch/telemetry/__init__.py",
                 "hypha_tpu_torch/telemetry/attributes.py",
                 "hypha_tpu_torch/telemetry/flight.py",
                 "hypha_tpu_torch/telemetry/trace.py",
                 "hypha_tpu_torch/telemetry/timeline.py",
                 "hypha_tpu_torch/telemetry/otlp.py",
                 "hypha_tpu_torch/telemetry/series.py",
                 "hypha_tpu_torch/telemetry/slo.py",
                 "hypha_tpu_torch/telemetry/metrics_plane.py",
                 "hypha_tpu_torch/telemetry/top.py",
                 "hypha_tpu_torch/aim_driver.py"):
        assert must in rel, must
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


def test_transformers_is_imported_only_inside_the_processor_loader():
    """``transformers`` (HF processors: host-side text and image transforms)
    is the one package a job may need beyond torch: only a job with a
    ``preprocessor`` imports it, inside ``preprocess.load_processor``."""
    sites = []
    for p in _port_files():
        tree = ast.parse(p.read_text(), filename=str(p))
        inside = {id(n) for f in ast.walk(tree)
                  if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(f)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] == "transformers" for n in names):
                sites.append((str(p.relative_to(ROOT)), id(node) in inside))
    assert sites == [("hypha_tpu_torch/executor/preprocess.py", True)], sites


def test_refusals_name_the_current_roadmap_label():
    """Codecs and streaming, the serving router, the prefix cache, the
    fleet cache with KV migration, mTLS, mux, the process executor's
    command, checkpoint resume, the fault tolerance of sharded and
    streaming jobs, the broadcast tree, live weight swap, adaptive rounds
    with the data-plane chaos kinds, scheduler recovery, LoRA, the bf16
    first moment, HF checkpoints as initial weights, the input pipeline,
    slice preprocessors and the live metrics plane (telemetry) are ported:
    no module refuses an option under a label that named them (Hub
    downloads stay refused as HF Hub)."""
    retired = ("codecs/streaming", "serving router", "prefix cache with copy_blocks",
               "fleet cache and kv migration", "queue 1: mtls", "queue 1: network/mux.py",
               "queue 1: process executor command", "queue 1: checkpoint resume",
               "sharded ps/ft/rejoin", "queue 1: broadcast tree", "queue 1: live weight swap",
               "adaptive rounds and chaos kinds", "queue 1: scheduler recovery",
               "queue 1: lora", "queue 1: mu_dtype", "queue 1: hf checkpoints",
               "queue 1: input_pipeline", "queue 1: preprocessor", "queue 1: telemetry")
    stale = [f"{p.relative_to(ROOT)}:{i}" for p in _port_files()
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if any(label in line.lower() for label in retired)]
    assert not stale, stale


@pytest.mark.parametrize("module", ["hypha_tpu_torch.cli", "hypha_tpu_torch.gateway",
                                    "hypha_tpu_torch.data_node", "hypha_tpu_torch.node_config",
                                    "hypha_tpu_torch.scheduler.orchestrator",
                                    "hypha_tpu_torch.telemetry.trace",
                                    "hypha_tpu_torch.telemetry.timeline",
                                    "hypha_tpu_torch.telemetry.metrics_plane",
                                    "hypha_tpu_torch.telemetry.top",
                                    "hypha_tpu_torch.aim_driver"])
def test_node_roles_without_tensors_import_no_torch(module):
    """The CLI, the gateway, the data node and the training scheduler load
    without torch (its import is seconds of every such process's start); the
    packages they reach (``ft``, ``compress``, ``stream``) import their torch
    modules lazily. The span recorder and the timeline merger need only the
    standard library."""
    code = (f"import sys, {module}; "
            "sys.exit('torch imported' if 'torch' in sys.modules else 0)")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:] or proc.stdout[-2000:]


@pytest.mark.parametrize("package", ["hypha_tpu_torch.ft", "hypha_tpu_torch.compress",
                                     "hypha_tpu_torch.stream"])
def test_lazy_package_exports_resolve(package):
    """Every name a lazy package exports resolves: to its submodule's object,
    or to the package's own definition."""
    mod = importlib.import_module(package)
    for name in mod.__all__:
        value = getattr(mod, name)
        sub = mod._SUBMODULE.get(name)
        home = importlib.import_module(f"{package}.{sub}") if sub else mod
        assert value is getattr(home, name), name
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from hypha_tpu_torch.compress import read_delta, write_delta
    from hypha_tpu_torch.stream import RoundAccum

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")
    # A quantized frame dequantizes on the caller's device: CUDA unless asked.
    write_delta(tmp_path / "f", {"w": torch.ones(4)}, "int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        read_delta(tmp_path / "f")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RoundAccum()
    assert torch.equal(read_delta(tmp_path / "f", device="cpu")["w"], torch.ones(4))


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
