"""Lazy package exports (PEP 562), without a counterpart in ``hypha_tpu/``.

A package whose submodules import torch re-exports their names through
:func:`exports`, so a process that reads only its torch-free parts (the
node CLI's gateway and data node, a training job's scheduler) never loads
torch: its import is seconds of every such process's start."""

from __future__ import annotations

import importlib
import sys
from typing import Callable

__all__ = ["exports"]


def exports(package: str, submodules: dict) -> Callable[[str], object]:
    """A module ``__getattr__`` for ``package``: the first use of a name in
    ``submodules`` (name -> submodule) imports that submodule and keeps the
    name in the package."""

    def __getattr__(name: str) -> object:
        module = submodules.get(name)
        if module is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(f".{module}", package), name)
        setattr(sys.modules[package], name, value)
        return value

    return __getattr__
