"""PyTorch/CUDA port of hypha_tpu, beside the JAX package it is held against.

The layout mirrors ``hypha_tpu/`` file for file, so each module here names
its reference. This package imports torch, numpy, einops and the standard
library only — never JAX, flax, optax, safetensors, httpx or anything under
``hypha_tpu`` (tests/test_torch_hygiene.py enforces it). Entry points run on
the CUDA device unless the caller passes ``device="cpu"``; the hand-written
Hopper kernels live in ``ops/csrc/``: ragged paged attention for serving,
and the flash-attention forward, dQ and dK/dV kernels for training. The
node CLI is ``python -m hypha_tpu_torch {gateway|data|worker|scheduler}
{init|probe|run}`` (``cli.py``).
"""
