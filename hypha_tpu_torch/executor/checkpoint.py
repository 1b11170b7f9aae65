"""Checkpoint and resume of a trainer's state (counterpart of
``hypha_tpu/executor/checkpoint.py``).

Every ``every_rounds`` completed rounds the trainer persists its params,
its optimizer state and its round counter, so an executor re-dispatched
after a preemption resumes from the last completed round instead of θ₀.

Layout (the reference's): one version directory ``v{round:08d}-{step}``
per save holding ``params.safetensors``, ``opt_state.safetensors`` and
``manifest.json`` (``{"version": 1, "step", "round", "extra"}``), staged in
a ``.staging-*`` directory and renamed into place; then the ``LATEST``
pointer file flips (written beside, then renamed), and only the newest
``_KEEP_VERSIONS`` versions stay. A crash at any instant leaves the
previous complete checkpoint or the new one, never a mix.

``params.safetensors`` holds the wire's flat names and layouts
(``models/convert.py``: ``params/layers_0/self_attn/q_proj/kernel``, ...),
so the reference's ``load_flat`` reads it. ``opt_state.safetensors`` holds
the port's own names: ``count`` (I64, the optimizer's update count),
``mu/<flat name>`` and ``nu/<flat name>`` (the moments, in the flat
layout of their parameter). A LoRA trainer saves and resumes its adapters
and their moments only, as the reference does: its base is the job's
``source`` and never changes. The reference names optax's state tree
instead, so resuming a checkpoint written by the other package is not
supported. Files go through the port's own SafeTensors writer
(``executor/serialization.py``), one tensor at a time to the host.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
from pathlib import Path

import torch

from ..models.convert import flat_to_state, state_to_flat
from .serialization import load_file, save_file

__all__ = ["save_train_checkpoint", "load_train_checkpoint", "latest_manifest", "train_state",
           "restore_train_state"]

log = logging.getLogger("hypha.torch.executor.checkpoint")

_MANIFEST = "manifest.json"
_PARAMS = "params.safetensors"
_OPT = "opt_state.safetensors"
_LATEST = "LATEST"
_KEEP_VERSIONS = 2


def _atomic_write_text(path: Path, text: str) -> None:
    """Write one small file beside ``path`` and rename it into place."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".tmp")
    os.close(fd)
    committed = False
    try:
        Path(tmp).write_text(text)
        os.replace(tmp, path)
        committed = True
    finally:
        if not committed:
            Path(tmp).unlink(missing_ok=True)


def save_train_checkpoint(directory: "str | Path", params: dict, opt_state: dict, step: int,
                          round_num: int, extra: "dict | None" = None) -> Path:
    """Persist one checkpoint, atomically as a whole: ``params`` and
    ``opt_state`` map names to tensors on any device. Returns the version
    directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    version = f"v{round_num:08d}-{step}"
    staging = Path(tempfile.mkdtemp(dir=directory, prefix=".staging-"))
    committed = False
    try:
        save_file(params, staging / _PARAMS)
        save_file(opt_state, staging / _OPT)
        manifest = {"version": 1, "step": int(step), "round": int(round_num),
                    "extra": extra or {}}
        (staging / _MANIFEST).write_text(json.dumps(manifest))
        target = directory / version
        if target.exists():  # a re-save of the same round replaces it whole
            shutil.rmtree(target, ignore_errors=True)
        os.replace(staging, target)
        committed = True
    except Exception as e:
        log.warning("checkpoint save to %s (round %d) failed: %s", directory, round_num, e)
        raise
    finally:
        if not committed:
            shutil.rmtree(staging, ignore_errors=True)
    _atomic_write_text(directory / _LATEST, version)
    _prune_versions(directory, keep=_KEEP_VERSIONS)
    log.info("checkpoint saved to %s/%s (round %d)", directory, version, round_num)
    return directory / version


def _prune_versions(directory: Path, keep: int) -> None:
    versions = sorted((p for p in directory.iterdir() if p.is_dir() and p.name.startswith("v")),
                      key=lambda p: p.name)
    for old in versions[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def load_train_checkpoint(directory: "str | Path", params_template: dict,
                          opt_template: dict) -> "tuple | None":
    """``(params, opt_state, step, round, extra)`` of the ``LATEST``
    version, or None without one. The templates (name -> tensor) fix the
    names and shapes: a checkpoint of another model fails loudly. Tensors
    come back on the host."""
    directory = Path(directory)
    pointer = directory / _LATEST
    if not pointer.is_file():
        return None
    target = directory / pointer.read_text().strip()
    manifest_path = target / _MANIFEST
    if not manifest_path.is_file():
        raise ValueError(f"checkpoint pointer {pointer} names missing {target}")
    manifest = json.loads(manifest_path.read_text())
    if manifest.get("version") != 1:
        raise ValueError(f"unknown checkpoint version {manifest.get('version')}")
    params = _like(load_file(target / _PARAMS), params_template, target / _PARAMS)
    opt_state = _like(load_file(target / _OPT), opt_template, target / _OPT)
    return params, opt_state, int(manifest["step"]), int(manifest["round"]), \
        manifest.get("extra", {})


def _like(loaded: dict, template: dict, path: Path) -> dict:
    """``loaded`` checked against ``template``'s names and shapes."""
    if set(loaded) != set(template):
        missing = sorted(set(template) - set(loaded))[:3]
        extra = sorted(set(loaded) - set(template))[:3]
        raise ValueError(f"{path}: names differ from the model's (missing {missing}, "
                         f"unexpected {extra})")
    for name, t in template.items():
        if tuple(loaded[name].shape) != tuple(t.shape):
            raise ValueError(f"{path}: {name!r} has shape {tuple(loaded[name].shape)}, "
                             f"the model {tuple(t.shape)}")
    return {name: loaded[name] for name in template}


def latest_manifest(directory: "str | Path") -> "dict | None":
    """The ``LATEST`` version's manifest, or None."""
    directory = Path(directory)
    pointer = directory / _LATEST
    if not pointer.is_file():
        return None
    manifest = directory / pointer.read_text().strip() / _MANIFEST
    if not manifest.is_file():
        return None
    return json.loads(manifest.read_text())


def _trained_names(model, optimizer) -> list:
    """The ``state_dict`` names of the parameters ``optimizer`` updates, in
    its order: every parameter, or a LoRA trainer's adapters."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for p in optimizer.params]


@torch.no_grad()
def train_state(model, optimizer) -> tuple:
    """``(params, opt_state)`` of a trainer, in the checkpoint's names:
    the flat wire names of the parameters ``optimizer`` updates (a LoRA
    trainer's adapters alone: its base is the job's source), and
    ``count``, ``mu/<flat>``, ``nu/<flat>`` (kernels as transposed views;
    the writer copies them)."""
    names = _trained_names(model, optimizer)
    state = model.state_dict()
    params = state_to_flat(model, {n: state[n] for n in names})
    opt = {"count": torch.tensor(int(optimizer.count), dtype=torch.int64)}
    for key, moments in (("mu", optimizer.mu), ("nu", optimizer.nu)):
        for flat, t in state_to_flat(model, dict(zip(names, moments))).items():
            opt[f"{key}/{flat}"] = t
    return params, opt


@torch.no_grad()
def restore_train_state(model, optimizer, params: dict, opt_state: dict) -> None:
    """Load what :func:`train_state` saved back into ``model`` and
    ``optimizer``, in place, on their device."""
    state = model.state_dict()
    for name, t in flat_to_state(params).items():
        state[name].copy_(t)
    index = {n: i for i, n in enumerate(_trained_names(model, optimizer))}
    for key, moments in (("mu", optimizer.mu), ("nu", optimizer.nu)):
        prefix = key + "/"
        flat = {k[len(prefix):]: v for k, v in opt_state.items() if k.startswith(prefix)}
        for name, t in flat_to_state(flat).items():
            dst = moments[index[name]]
            dst.copy_(t.to(dst.device, dst.dtype))
    optimizer.count = int(opt_state["count"])
