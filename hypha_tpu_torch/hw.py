"""Device selection (counterpart of ``hypha_tpu/hw.py``).

The JAX package asks "is the backend a TPU?" to pick a Pallas kernel or its
XLA path. Here the question is simpler and stricter: the port runs on a
CUDA device unless the caller asks for the CPU, and the hand-written
kernels run only on Hopper (sm_90). Nothing falls back quietly: a missing
GPU or an older card raises.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "require_sm90"]


def default_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA.

    With no CUDA device and no explicit request this raises instead of
    running on the CPU — a serving run that silently lands on the host
    would report host numbers under a device's name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return torch.device("cuda")


def require_sm90(device: torch.device) -> None:
    """Raise unless ``device`` is a Hopper GPU (compute capability 9.0).
    The kernels are compiled for ``sm_90a`` only."""
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != (9, 0):
        raise RuntimeError(
            f"the port's CUDA kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap[0]}.{cap[1]}"
        )
