"""Fault tolerance (counterpart of ``hypha_tpu/ft/``): so far the φ-accrual
failure detector, which the request router's ejector reads, and the
measured-link table (``Ewma``, ``LinkTable``) that the serving plane's
fleet prefix cache and KV migration read. Elastic membership, rejoin, the durable
parameter server, the straggler controller and the chaos injector are not
ported yet (ROADMAP.md, Queue 1: sharded PS/FT/rejoin)."""

from .adaptive import Ewma, LinkTable
from .detector import PHI_THRESHOLD_DEFAULT, PhiAccrualDetector

__all__ = ["Ewma", "LinkTable", "PhiAccrualDetector", "PHI_THRESHOLD_DEFAULT"]
