"""Lease management: atomic resource reservation + ledger entry (a copy of
``hypha_tpu/worker/lease_manager.py``).

Reference: crates/worker/src/lease_manager.rs:28-121 — ``request`` reserves
resources and inserts a ledger lease atomically (rolling back the
reservation if the insert fails); removal releases the reservation;
renewal resets expiry. A lease's reservation id is its lease id.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..leases import Lease, LeaseNotFound, Ledger
from ..resources import Resources
from .resources_mgr import ResourceManager

__all__ = ["ResourceLease", "LeaseManager"]


@dataclass(slots=True)
class ResourceLease:
    """What a lease reserves and for whom (the scheduler peer)."""

    peer_id: str
    reservation: Resources


class LeaseManager:
    def __init__(self, resources: ResourceManager) -> None:
        self.resources = resources
        self.ledger: Ledger[ResourceLease] = Ledger()

    def request(
        self, peer_id: str, reservation: Resources, duration: float
    ) -> Lease[ResourceLease]:
        """Reserve resources and create the lease; all-or-nothing."""
        lease = Lease(
            leasable=ResourceLease(peer_id=peer_id, reservation=reservation),
            timeout=0.0,  # set by ledger insert below
        )
        self.resources.reserve(reservation, lease.id)
        try:
            inserted = self.ledger.insert(lease.leasable, duration, lease_id=lease.id)
        except Exception:
            self.resources.release(lease.id)
            raise
        return inserted

    def get(self, lease_id: str) -> Lease[ResourceLease]:
        return self.ledger.get(lease_id)

    def get_by_peer(self, peer_id: str) -> Lease[ResourceLease] | None:
        return self.ledger.find(lambda l: l.leasable.peer_id == peer_id)

    def renew(self, lease_id: str, peer_id: str, duration: float) -> Lease[ResourceLease]:
        """Renew only for the owning peer (crates/worker/src/arbiter.rs:150-200)."""
        lease = self.ledger.get(lease_id)
        if lease.leasable.peer_id != peer_id:
            raise PermissionError(f"lease {lease_id} not owned by {peer_id}")
        return self.ledger.renew(lease_id, duration)

    def remove(self, lease_id: str) -> Lease[ResourceLease]:
        lease = self.ledger.remove(lease_id)
        self.resources.release(lease_id)
        return lease

    def remove_expired(self) -> list[Lease[ResourceLease]]:
        expired = self.ledger.remove_expired()
        for lease in expired:
            self.resources.release(lease.id)
        return expired
