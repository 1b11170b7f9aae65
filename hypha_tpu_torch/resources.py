"""Resource vectors and offer scoring (a copy of ``hypha_tpu/resources.py``).

Behavioral parity with the reference's ``hypha-resources`` crate
(reference: crates/resources/src/lib.rs:10-193), extended TPU-first: the
vector carries a ``tpu`` axis (whole chips of a leased slice) alongside the
reference's gpu/cpu/memory/storage axes, so a TPU pod-slice can be priced,
auctioned and leased as one worker. The axes and their wire names stay
the reference's: a torch worker on a GPU sells ``gpu``.

Semantics preserved from the reference:
  * element-wise arithmetic with checked subtraction
    (crates/resources/src/lib.rs:70-143),
  * a *partial* order — ``a <= b`` only when every axis satisfies it, so
    incomparable resource vectors exist exactly as in the reference,
  * ``WeightedResourceEvaluator`` scoring offers by price per weighted unit
    with default weights gpu=25, cpu=1, memory=0.1, storage=0.01
    (crates/resources/src/lib.rs:158-189); tpu gets the gpu weight by default.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = [
    "Resources",
    "ResourceEvaluator",
    "WeightedResourceEvaluator",
    "InsufficientResources",
]

_AXES = ("tpu", "gpu", "cpu", "memory", "storage")


class InsufficientResources(ValueError):
    """Checked subtraction underflow (reference: checked_sub returning None)."""


@dataclass(frozen=True, slots=True)
class Resources:
    """A non-negative resource vector.

    Units follow the reference: ``gpu``/``cpu`` in whole devices/cores,
    ``memory``/``storage`` in MB (crates/resources/src/lib.rs:10-15).
    ``tpu`` counts chips in the leased slice.
    """

    tpu: float = 0.0
    gpu: float = 0.0
    cpu: float = 0.0
    memory: float = 0.0
    storage: float = 0.0

    def __post_init__(self) -> None:
        for axis in _AXES:
            v = getattr(self, axis)
            if v < 0:
                raise ValueError(f"negative {axis}: {v}")

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other: "Resources") -> "Resources":
        return Resources(**{a: getattr(self, a) + getattr(other, a) for a in _AXES})

    def __sub__(self, other: "Resources") -> "Resources":
        """Checked subtraction: raises InsufficientResources on underflow."""
        out = {}
        for a in _AXES:
            d = getattr(self, a) - getattr(other, a)
            if d < 0:
                raise InsufficientResources(f"{a}: {getattr(self, a)} - {getattr(other, a)}")
            out[a] = d
        return Resources(**out)

    def checked_sub(self, other: "Resources") -> "Resources | None":
        try:
            return self - other
        except InsufficientResources:
            return None

    def scale(self, k: float) -> "Resources":
        if k < 0:
            raise ValueError("negative scale")
        return Resources(**{a: getattr(self, a) * k for a in _AXES})

    # -- partial order ------------------------------------------------------
    def __le__(self, other: "Resources") -> bool:
        return all(getattr(self, a) <= getattr(other, a) for a in _AXES)

    def __ge__(self, other: "Resources") -> bool:
        return other.__le__(self)

    def __lt__(self, other: "Resources") -> bool:
        return self <= other and self != other

    def __gt__(self, other: "Resources") -> bool:
        return other < self

    def fits_within(self, capacity: "Resources") -> bool:
        return self <= capacity

    def is_zero(self) -> bool:
        return all(getattr(self, a) == 0 for a in _AXES)

    # -- wire ---------------------------------------------------------------
    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "Resources":
        return cls(**{a: float(d.get(a, 0.0)) for a in _AXES})


class ResourceEvaluator:
    """Scores (price, resources) offers; lower is better.

    Reference: ``ResourceEvaluator`` trait, crates/resources/src/lib.rs:191-193.
    """

    def evaluate(self, price: float, resources: Resources) -> float:
        raise NotImplementedError


@dataclass(frozen=True)
class WeightedResourceEvaluator(ResourceEvaluator):
    """Price per weighted resource unit (crates/resources/src/lib.rs:158-189).

    Default weights follow the reference (gpu=25, cpu=1, memory=0.1,
    storage=0.01); tpu chips are priced like gpus by default. An offer of
    zero weighted units scores +inf (never selected).
    """

    tpu: float = 25.0
    gpu: float = 25.0
    cpu: float = 1.0
    memory: float = 0.1
    storage: float = 0.01

    def weighted_units(self, r: Resources) -> float:
        return (
            self.tpu * r.tpu
            + self.gpu * r.gpu
            + self.cpu * r.cpu
            + self.memory * r.memory
            + self.storage * r.storage
        )

    def evaluate(self, price: float, resources: Resources) -> float:
        units = self.weighted_units(resources)
        if units <= 0:
            return float("inf")
        return price / units
