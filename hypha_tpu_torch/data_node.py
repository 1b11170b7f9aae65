"""Data node runtime: serve dataset slices over pull streams (a copy of
``hypha_tpu/data_node.py``).

Reference: crates/data/src/bin/hypha-data.rs:153-209 and
crates/data/src/tensor_data.rs:8-16 — each file in the dataset directory is
one slice (sorted order), the node announces a ``DataRecord{num_slices}``
registry record under the dataset name, and serves concurrent pull streams
whose header names ``DataSlice{dataset, index}``; the payload is the raw
bytes of the slice file.

The reference's index bounds check is off-by-one (``>`` where ``>=`` is
needed, hypha-data.rs:195) — fixed here per SURVEY.md §7 "Known reference
bugs to fix, not replicate".
"""

from __future__ import annotations

import logging
from pathlib import Path

from . import messages
from .health import serve_health
from .messages import DataRecord, DataSlice
from .network.node import Node
from .network.fabric import Transport

__all__ = ["DataNode"]

log = logging.getLogger("hypha.torch.data")


class DataNode:
    """Serves one or more datasets; ``datasets`` maps name -> directory."""

    def __init__(
        self,
        transport: Transport | None,
        datasets: dict[str, str | Path],
        peer_id: str | None = None,
        bootstrap: list[str] | None = None,
        node: Node | None = None,
        **node_kwargs,
    ) -> None:
        # ``node`` injection: a caller may hand in a Node it built itself.
        self.node = node or Node(
            transport, peer_id=peer_id, bootstrap=bootstrap, **node_kwargs
        )
        self._slices: dict[str, list[Path]] = {}
        for name, directory in datasets.items():
            files = sorted(p for p in Path(directory).iterdir() if p.is_file())
            if not files:
                raise ValueError(f"dataset {name!r}: no slice files in {directory}")
            self._slices[name] = files
        self._health = None
        self._ready = False

    @property
    def peer_id(self) -> str:
        return self.node.peer_id

    def num_slices(self, dataset: str) -> int:
        return len(self._slices[dataset])

    async def start(self, listen: list[str] | None = None) -> None:
        await self.node.start(listen)
        self.node.on_pull(self._serve_slice)
        self._health = serve_health(self.node, lambda: self._ready)
        # Node.start pre-sets the bootstrapped event for self-anchored nodes,
        # so this returns immediately when there are no gateways.
        await self.node.wait_for_bootstrap()
        # Announce one record per dataset (hypha-data.rs:176-185) and mark
        # this peer a provider so schedulers can resolve name -> peer.
        for name, files in self._slices.items():
            await self.node.put_record(
                name, messages.encode(DataRecord(num_slices=len(files)))
            )
            await self.node.provide(name)
        self._ready = True
        log.info(
            "data node %s serving %s",
            self.peer_id,
            {n: len(f) for n, f in self._slices.items()},
        )

    async def _serve_slice(self, peer: str, resource) -> Path:
        """Pull handler: validate the header, hand back the slice file path
        (the Node streams it — the raw ``io::copy`` role, tensor_data.rs:8-16)."""
        if not isinstance(resource, DataSlice):
            raise ValueError(f"unsupported pull resource {type(resource).__name__}")
        files = self._slices.get(resource.dataset)
        if files is None:
            raise ValueError(f"unknown dataset {resource.dataset!r}")
        if not 0 <= resource.index < len(files):
            raise ValueError(
                f"slice index {resource.index} out of range 0..{len(files) - 1}"
            )
        log.debug("serving %s[%d] to %s", resource.dataset, resource.index, peer)
        return files[resource.index]

    async def stop(self) -> None:
        self._ready = False
        if self._health is not None:
            self._health.close()
        await self.node.stop()
