"""In-process train executor: the DiLoCo inner loop without a process hop
(counterpart of ``hypha_tpu/worker/train_executor.py``).

The executor starts the same Job Bridge on the job's unix socket as the
process executor does, and runs
:func:`hypha_tpu_torch.executor.training.run_training` with the same
bridge client in a worker thread, on the node's device (CUDA unless the
node was built for the CPU) — the whole fetch/send/receive/status
contract, without the subprocess. It is the worker runtime's default
train runtime, as in the reference.

A worker its job names its group's reducer (``reduce_members``) runs a
:class:`~hypha_tpu_torch.stream.reduce.GroupReducer` beside the loop, in
the node's event loop and on its device, stopped with the job.

The bridge's connector serves the slice fetches of pipelined jobs from an
on-disk :class:`~hypha_tpu_torch.worker.slice_cache.SliceCache` under
``work_root / "slice-cache"``, which outlives each job's work dir.

Not ported: the metrics reporter the reference starts beside the loop
(ROADMAP.md, Queue 1: telemetry); a job asking for it raises inside
``run_training``.
"""

from __future__ import annotations

import asyncio
import logging
import shutil
import threading
import uuid
from pathlib import Path

from .. import aio
from ..hw import default_device
from ..messages import JobSpec
from ..stream.reduce import maybe_start_reducer
from .bridge import Bridge
from .connectors import Connector
from .job_manager import Execution, JobExecutor
from .slice_cache import SliceCache

__all__ = ["InProcessTrainExecutor"]

log = logging.getLogger("hypha.torch.worker.train")


class InProcessTrainExecutor(JobExecutor):
    """``device``: CUDA unless the caller asks for the CPU; without CUDA and
    without that request the constructor raises."""

    def __init__(self, node, work_root: "Path | str", device=None) -> None:
        self.node = node
        self.work_root = Path(work_root)
        self.device = default_device(device)

    async def execute(self, job_id: str, spec: JobSpec, scheduler_peer: str) -> Execution:
        work_dir = self.work_root / f"hypha-{uuid.uuid4().hex[:12]}"
        work_dir.mkdir(parents=True, mode=0o700)
        execution = Execution(job_id)
        grace = float(getattr(spec.executor.train, "adopt_grace_s", 0) or 0)
        execution.adopt_grace_s = grace or None  # the lease outlives a dead scheduler

        def probe(progress) -> None:
            if progress.round > execution.round:
                execution.round = progress.round

        try:
            bridge = Bridge(self.node, work_dir, job_id, scheduler_peer,
                            Connector(self.node, scheduler_peer,
                                      slice_cache=SliceCache(self.work_root / "slice-cache")),
                            status_retry_s=grace, progress_probe=probe)
            socket_path = await bridge.start()
        except BaseException:
            await asyncio.to_thread(shutil.rmtree, work_dir, ignore_errors=True)
            raise
        stop_flag = threading.Event()
        reducer = maybe_start_reducer(self.node, spec, self.device, work_dir / "reduce")
        runner = asyncio.create_task(
            self._run(execution, spec, socket_path, work_dir, bridge, stop_flag, reducer))

        async def cancel() -> None:
            # Cooperative: the training thread polls the flag between
            # batches. Cancelling the awaiting task alone would leave the
            # thread computing while the work dir is deleted under it.
            if runner.done():
                execution.finish("cancelled")
                return
            stop_flag.set()
            try:
                await asyncio.wait_for(asyncio.shield(runner), timeout=5.0)
            except asyncio.TimeoutError:
                # The thread may be parked in a bridge call (the receive
                # awaiting a broadcast) where the flag is never polled;
                # severing the bridge unblocks it with an error.
                await bridge.stop()
                try:
                    await asyncio.wait_for(asyncio.shield(runner), timeout=55.0)
                except asyncio.TimeoutError:
                    log.warning("job %s did not stop cooperatively; abandoning thread",
                                spec.job_id)
                    await aio.reap(runner)
            except Exception:
                pass
            execution.finish("cancelled")

        execution.cancel = cancel  # type: ignore[method-assign]
        return execution

    async def _run(self, execution: Execution, spec: JobSpec, socket_path: Path,
                   work_dir: Path, bridge: Bridge, stop_flag: threading.Event,
                   reducer=None) -> None:
        from ..executor.bridge_client import Session
        from ..executor.training import run_training

        def blocking() -> None:
            with Session(str(socket_path)) as session:
                run_training(session, work_dir, spec, should_stop=stop_flag.is_set,
                             device=self.device)

        try:
            # The training loop is synchronous (device work and bridge
            # HTTP): it runs in a worker thread while the bridge serves it
            # from this event loop.
            await asyncio.to_thread(blocking)
            execution.finish("cancelled" if stop_flag.is_set() else "completed")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if stop_flag.is_set():
                execution.finish("cancelled")
            else:
                log.exception("in-process training job %s failed", spec.job_id)
                execution.finish("failed", str(e))
        finally:
            if reducer is not None:
                await reducer.stop()
            await bridge.stop()
            await asyncio.to_thread(shutil.rmtree, work_dir, ignore_errors=True)
