"""Worker runtime: the compute-selling node (counterpart of
``hypha_tpu/worker/runtime.py``).

Composes the worker stack:

    Node                  — fabric endpoint (RPC, gossip, streams, discovery)
    StaticResourceManager — configured capacity minus live reservations
    LeaseManager          — atomic reserve + ledger
    JobManager            — routes jobs to executors
    Arbiter               — auction + leases + dispatch + prune
    health                — readiness = listening + bootstrapped

Default executor table:

    ("train", "diloco-transformer")   → the in-process torch trainer
                                        (default) or ``train_cmd
                                        train_args...`` as a process of its
                                        own (``train_runtime="process"``;
                                        by default the port's trainer CLI)
    ("aggregate", "parameter-server") → the parameter server, folding and
                                        stepping on the node's device
    ("infer", "generate")             → the serving executor: the model
                                        and its decode pool on the node's
                                        device, answering
                                        ``/hypha-generate/0.0.1``

Everything runs on ``device``: CUDA unless the
caller asks for the CPU; without CUDA and without that request the
constructor raises. A torch worker sells its cards on the ``gpu`` axis of
``resources``::

    node = WorkerNode(TcpTransport(), resources=Resources(gpu=1, cpu=8, memory=64_000),
                      bootstrap=["gw-host:7000"], work_root="/tmp/hw")
    await node.start(["0.0.0.0:0"])

``node`` injects a ready ``Node`` (the CLI passes an mTLS-secured one
from ``network.secure.secure_node``) in place of one built on
``transport``. ``work_root`` defaults to the system's temporary directory. Keep it
short: each job's bridge socket is
``{work_root}/hypha-{12 hex}/bridge.sock`` and a unix socket path must
stay under 108 bytes.
"""

from __future__ import annotations

import logging
import tempfile
from pathlib import Path

from ..health import serve_health
from ..hw import default_device
from ..messages import AGGREGATE_EXECUTOR_NAME, INFER_EXECUTOR_NAME, TRAIN_EXECUTOR_NAME
from ..network.node import Node
from ..resources import Resources
from .arbiter import Arbiter, OfferConfig
from .infer_executor import InProcessInferExecutor
from .job_manager import JobManager
from .lease_manager import LeaseManager
from .process_executor import ProcessExecutor
from .ps_executor import ParameterServerExecutor
from .resources_mgr import StaticResourceManager
from .train_executor import InProcessTrainExecutor

__all__ = ["WorkerNode", "TRAIN_EXECUTOR_NAME", "AGGREGATE_EXECUTOR_NAME", "INFER_EXECUTOR_NAME"]

log = logging.getLogger("hypha.torch.worker")

class WorkerNode:
    def __init__(
        self,
        transport,
        *,
        resources: Resources,
        device=None,
        peer_id: "str | None" = None,
        offer: "OfferConfig | None" = None,
        train_runtime: str = "in-process",  # "in-process" | "process"
        train_cmd: "str | None" = None,
        train_args: "list[str] | None" = None,
        work_root: "Path | str | None" = None,
        node: "Node | None" = None,
        **node_kwargs,
    ) -> None:
        self.device = default_device(device)
        self.node = node or Node(transport, peer_id=peer_id, **node_kwargs)
        self.resource_manager = StaticResourceManager(resources)
        self.lease_manager = LeaseManager(self.resource_manager)
        work_root = Path(work_root or tempfile.gettempdir())
        if train_runtime == "process":
            train = ProcessExecutor(self.node, work_root, self.device)
            train.cmd = train_cmd or train.cmd
            train.args = list(train_args or train.args)
        elif train_runtime == "in-process":
            train = InProcessTrainExecutor(self.node, work_root, self.device)
        else:
            raise ValueError(f"unknown train_runtime {train_runtime!r}")
        executors = {
            ("train", TRAIN_EXECUTOR_NAME): train,
            ("aggregate", AGGREGATE_EXECUTOR_NAME): ParameterServerExecutor(
                self.node, work_root, self.device),
            ("infer", INFER_EXECUTOR_NAME): InProcessInferExecutor(
                self.node, self.device, work_root),
        }
        self.job_manager = JobManager(self.node, executors)
        self.arbiter = Arbiter(
            node=self.node,
            lease_manager=self.lease_manager,
            job_manager=self.job_manager,
            offer=offer or OfferConfig(),
        )
        self._health = None
        self._ready = False

    @property
    def peer_id(self) -> str:
        return self.node.peer_id

    async def start(self, listen: "list[str] | None" = None) -> None:
        await self.node.start(listen)
        self._health = serve_health(self.node, lambda: self._ready)
        await self.node.wait_for_bootstrap()
        await self.arbiter.start()
        self._ready = True
        log.info("worker %s ready (%s, %s)", self.peer_id, self.resource_manager.capacity(),
                 self.device)

    async def stop(self) -> None:
        self._ready = False
        if self._health is not None:
            self._health.close()
        await self.arbiter.stop()
        await self.node.stop()
