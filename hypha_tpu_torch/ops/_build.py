"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers: a build takes seconds, not minutes). Libraries go to
``ops/_build/`` (git-ignored), named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so a changed source rebuilds and an
unchanged one loads at once.
All sources compile in parallel, one ``nvcc`` each. A failed build raises
with nvcc's log; nothing falls back to the plain PyTorch versions.

Importing this module builds nothing: the first kernel launch does, or
``build()`` called directly (``chip_smoke.py`` times it).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "load_library", "BUILD_DIR", "SOURCES"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("ragged_paged_attention.cu", "flash_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

log = logging.getLogger("hypha.torch.ops.build")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(source: str, nvcc: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the sources include the shared headers
        h.update(header.read_bytes())
    h.update(" ".join((nvcc, *NVCC_FLAGS)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{source: {"path", "seconds", "log", "cached"}}``; raises
    RuntimeError carrying nvcc's output when a build fails."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    running = []
    for src in sources:
        target = _target(src, nvcc)
        if target.exists():
            out[src] = {"path": target, "seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, target, tmp, proc, time.perf_counter()))
    failures = []
    for src, target, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        out[src] = {"path": target, "seconds": seconds, "log": log, "cached": False}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def _bind(lib: ctypes.CDLL, source: str) -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    if source == "ragged_paged_attention.cu":
        # ..., route, splits, workspace, stream
        entry = {"ragged_paged_attention": [vp] * 9 + [i] * 14 + [vp, vp]}
        error = lib.ragged_paged_attention_error
    elif source == "flash_attention.cu":
        tail = [strides, f, i, i, i, vp]  # strides, scale, causal, window, dtype, stream
        entry = {
            "flash_attention_forward": [vp] * 5 + [i] * 6 + tail,
            "flash_attention_backward_dq": [vp] * 7 + [i] * 6 + tail,
            "flash_attention_backward_dkv": [vp] * 8 + [i] * 6 + tail,
        }
        error = lib.flash_attention_error
    else:
        raise KeyError(f"no C interface is declared for {source}")
    for name, argtypes in entry.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    error.argtypes = [i]
    error.restype = ctypes.c_char_p
    return lib


def load_library(source: str = "ragged_paged_attention.cu") -> ctypes.CDLL:
    """The loaded, bound library of ``source``, building it on first use.
    Logs whether the library was built or found ``cached`` (a process that
    reuses its parent's build says so)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            built = build((source,))[source]
            log.info("kernel library %s: %s", source,
                     "cached" if built["cached"] else f"built in {built['seconds']:.1f} s")
            lib = _libs[source] = _bind(ctypes.CDLL(str(built["path"])), source)
        return lib
