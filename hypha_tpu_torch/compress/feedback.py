"""Error-feedback residuals for quantized delta transport (counterpart of
``hypha_tpu/compress/feedback.py``).

The recurrence (Streaming DiLoCo, Douillard et al., 2025; Seide et al.,
2014):

    send_t  = Q(x_t + e_t)            # what goes on the wire
    e_{t+1} = (x_t + e_t) - send_t    # the error, kept locally

so the error a round's quantizer introduced rides the next round's
payload instead of being dropped. Both transport ends hold one: the
trainer over its shipped pseudo-gradients, the parameter server over its
broadcast updates. The residuals are f32 tensors on the device of the
values they compensate; each sum and difference is one f32 rounding, as in
the reference.
"""

from __future__ import annotations

import torch

__all__ = ["ErrorFeedback"]


class ErrorFeedback:
    """One f32 residual per tensor, keyed like the flat delta dicts."""

    def __init__(self) -> None:
        self._residual: dict = {}

    def compensate_one(self, name: str, value) -> torch.Tensor:
        """``x + e`` for one tensor, as a fresh f32 tensor."""
        v = torch.as_tensor(value).to(torch.float32)
        r = self._residual.get(name)
        if r is not None and tuple(r.shape) != tuple(v.shape):
            # A reshaped tensor between rounds invalidates the stored
            # error; dropping it costs one round's compensation.
            r = None
        return v + r.to(v.device) if r is not None else v.clone()

    def compensate(self, flat: dict) -> dict:
        """``x_t + e_t`` as fresh f32 tensors (inputs are never mutated)."""
        return {name: self.compensate_one(name, value) for name, value in flat.items()}

    def absorb(self, compensated: dict, decoded: dict) -> None:
        """Store ``e_{t+1} = compensated - Q(compensated)`` per tensor,
        replacing the whole residual tree."""
        residual = {}
        for name, comp in compensated.items():
            d = torch.as_tensor(decoded[name]).to(comp.device, torch.float32)
            if tuple(d.shape) != tuple(comp.shape) and d.numel() == comp.numel():
                d = d.reshape(comp.shape)  # scalars travel as (1,) in the frame
            residual[name] = comp - d
        self.replace(residual)

    def replace(self, residual: dict) -> None:
        """Install a whole new residual tree: what ``absorb`` computes, for a
        writer that builds it one tensor at a time (``frame.write_frame``)."""
        self._residual = residual

    def reset(self) -> None:
        self._residual = {}

    def state(self) -> dict:
        """The residual tree, for the durable parameter server's checkpoint
        (a restart that dropped it would lose one round's quantization
        error from the broadcast stream)."""
        return dict(self._residual)

    def restore(self, residual: dict) -> None:
        """Install a checkpointed residual tree (f32)."""
        self._residual = {name: torch.as_tensor(value).to(torch.float32)
                          for name, value in residual.items()}

    @property
    def tensors(self) -> int:
        return len(self._residual)
