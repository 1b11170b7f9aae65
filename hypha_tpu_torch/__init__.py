"""PyTorch/CUDA port of hypha_tpu, beside the JAX package it is held against.

The layout mirrors ``hypha_tpu/`` file for file, so each module here names
its reference. This package imports torch, numpy and einops only — never
JAX, flax, optax or anything under ``hypha_tpu`` (tests/test_torch_hygiene.py
enforces it). Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the one hand-written Hopper kernel lives in
``ops/csrc/ragged_paged_attention.cu``.
"""
