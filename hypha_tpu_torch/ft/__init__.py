"""Fault tolerance (counterpart of ``hypha_tpu/ft/``): so far only the
φ-accrual failure detector, which the request router's ejector reads.
Elastic membership, rejoin, the durable parameter server and the chaos
injector are not ported yet (ROADMAP.md, Queue 1: sharded PS/FT/rejoin)."""

from .detector import PHI_THRESHOLD_DEFAULT, PhiAccrualDetector

__all__ = ["PhiAccrualDetector", "PHI_THRESHOLD_DEFAULT"]
