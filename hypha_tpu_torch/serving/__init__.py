"""Serve-side subsystems that ride a training job's data plane
(counterpart of ``hypha_tpu/serving``): live weight swap
(:mod:`~hypha_tpu_torch.serving.weight_stream`), a serving worker that
follows the parameter server's per-round update broadcast and swaps the
decode pool's weights between its forwards."""

from .weight_stream import WeightStager, WeightSubscriber, follow_for

__all__ = ["WeightStager", "WeightSubscriber", "follow_for"]
