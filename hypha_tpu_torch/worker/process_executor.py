"""Process executor: run the training executor as a supervised subprocess
(counterpart of ``hypha_tpu/worker/process_executor.py``).

Per job: a work dir ``hypha-{uuid}`` under ``work_root`` holding the Job
Bridge's unix socket; ``cmd args...`` is spawned with ``{SOCKET_PATH}``,
``{WORK_DIR}`` and ``{JOB_JSON}`` substituted in the args (and exported as
environment variables), and, beyond the reference, ``{DEVICE}``: the
worker's torch device. By default the command is this interpreter running
the port's trainer CLI, ``-m hypha_tpu_torch.executor.training --socket
{SOCKET_PATH} --work-dir {WORK_DIR} --job {JOB_JSON} --device {DEVICE}``
(``node_config.TRAINER_ARGS``). Its output is piped through the worker's
log; cancelling sends SIGTERM and escalates to SIGKILL after a 5 s grace;
the work dir is removed afterwards.

A unix socket path must stay under 108 bytes, so ``work_root`` must be
short: the socket is ``{work_root}/hypha-{12 hex}/bridge.sock``. The
child's ``PYTHONPATH`` starts with the directory holding
``hypha_tpu_torch``, so ``-m hypha_tpu_torch.executor.training`` resolves
from the job's work dir.

When the job names this worker its group's reducer (``reduce_members``),
a :class:`~hypha_tpu_torch.stream.reduce.GroupReducer` runs beside the
process, in the node's event loop and on its device (it consumes the
node's pushes), and stops when the process ends.

The bridge's connector serves the slice fetches of pipelined jobs from an
on-disk :class:`~hypha_tpu_torch.worker.slice_cache.SliceCache` under
``work_root / "slice-cache"``, which outlives each job's work dir.

A node that traces (``telemetry.trace``) hands its trace directory to the
child as ``HYPHA_TRACE_DIR`` and, unless the environment names one, its
peer id as ``HYPHA_TRACE_NODE``: the trainer's spans carry the worker's
name, as an in-process trainer's do (the reference's child inherits only
the environment, and labels itself ``pid<N>``).

A job with ``report_metrics_s`` (the live metrics plane) starts a
:class:`~hypha_tpu_torch.telemetry.metrics_plane.MetricsReporter` beside
the process, as the in-process executor does (the reference's process
executor starts none): the node's registry and byte deltas go to the
scheduler's collector under the node's peer id, stamped with the round the
child last reported, until the process ends. The trainer's own quality
keys reach the collector on its round METRICS.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import signal
import sys
import uuid
from dataclasses import dataclass, field
from pathlib import Path

from .. import aio, messages
from ..messages import JobSpec
from ..node_config import TRAINER_ARGS
from ..stream.reduce import maybe_start_reducer
from ..telemetry import trace
from ..telemetry.metrics_plane import MetricsReporter
from .bridge import Bridge
from .connectors import Connector
from .job_manager import Execution, JobExecutor
from .slice_cache import SliceCache

__all__ = ["ProcessExecutor", "GRACE_S"]

log = logging.getLogger("hypha.torch.worker.process")

GRACE_S = 5.0  # SIGTERM -> SIGKILL escalation

# The directory holding the hypha_tpu_torch package.
_PORT_ROOT = str(Path(__file__).resolve().parents[2])


@dataclass(slots=True)
class ProcessExecutor(JobExecutor):
    """Spawns ``cmd args...`` per job (config runtime=process,
    crates/worker/src/config.rs:135-141); ``device`` fills ``{DEVICE}``."""

    node: object
    work_root: Path
    device: object  # torch.device
    cmd: str = sys.executable
    args: list = field(default_factory=lambda: list(TRAINER_ARGS))

    async def execute(self, job_id: str, spec: JobSpec, scheduler_peer: str) -> Execution:
        work_dir = Path(self.work_root) / f"hypha-{uuid.uuid4().hex[:12]}"
        work_dir.mkdir(parents=True, mode=0o700)
        grace = float(getattr(spec.executor.train, "adopt_grace_s", 0) or 0) \
            if spec.executor.train is not None else 0.0
        probe_target: list = []

        def probe(progress) -> None:
            for execution in probe_target:
                if progress.round > execution.round:
                    execution.round = progress.round

        try:
            bridge = Bridge(self.node, work_dir, job_id, scheduler_peer,
                            Connector(self.node, scheduler_peer,
                                      slice_cache=SliceCache(Path(self.work_root) / "slice-cache")),
                            status_retry_s=grace, progress_probe=probe)
            socket_path = await bridge.start()
        except BaseException:
            await asyncio.to_thread(shutil.rmtree, work_dir, ignore_errors=True)
            raise
        subst = {
            "SOCKET_PATH": str(socket_path),
            "WORK_DIR": str(work_dir),
            "JOB_JSON": json.dumps(messages.to_json_dict(spec)),
            "DEVICE": str(self.device),
        }
        argv = [self.cmd] + [_substitute(a, subst) for a in self.args]
        env = {**os.environ, "PYTHONPATH": _pythonpath(), **subst}
        tracing = trace.active()
        if tracing is not None:
            env["HYPHA_TRACE_DIR"] = str(tracing.trace_dir)
            env.setdefault("HYPHA_TRACE_NODE", str(self.node.peer_id))
        proc = await asyncio.create_subprocess_exec(
            *argv, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
            env=env, cwd=str(work_dir),
        )
        log.info("job %s: spawned pid %s: %s", job_id, proc.pid, argv[:3])
        train_cfg = spec.executor.train
        reporter = None
        if train_cfg is not None and train_cfg.report_metrics_s:
            reporter = MetricsReporter(
                self.node, train_cfg.metrics_peer or scheduler_peer, job_id,
                interval_s=float(train_cfg.report_metrics_s),
                round_fn=lambda: probe_target[0].round if probe_target else 0).start()
        execution = _ProcessExecution(job_id, proc, bridge, work_dir,
                                      reducer=maybe_start_reducer(self.node, spec, self.device,
                                                                  work_dir / "reduce"),
                                      reporter=reporter)
        execution.adopt_grace_s = grace or None  # the lease outlives a dead scheduler
        probe_target.append(execution)
        execution.start_supervision()
        return execution


def _pythonpath() -> str:
    """This process's PYTHONPATH with the port's root first."""
    rest = os.environ.get("PYTHONPATH", "").split(os.pathsep)
    return os.pathsep.join(dict.fromkeys([_PORT_ROOT, *filter(None, rest)]))


def _substitute(arg: str, subst: dict) -> str:
    for key, value in subst.items():
        arg = arg.replace("{" + key + "}", value)
    return arg


class _ProcessExecution(Execution):
    def __init__(self, job_id: str, proc: asyncio.subprocess.Process, bridge: Bridge,
                 work_dir: Path, reducer=None, reporter=None) -> None:
        super().__init__(job_id)
        self.proc = proc
        self.bridge = bridge
        self.work_dir = work_dir
        self.reducer = reducer
        self.reporter = reporter
        self._cancelled = False
        self._tasks: list = []

    def start_supervision(self) -> None:
        self._tasks.append(aio.spawn(self._pump_stdout(), what="executor stdout pump", logger=log))
        self._tasks.append(aio.spawn(self._supervise(), what="executor supervise", logger=log))

    async def _pump_stdout(self) -> None:
        """Pipe the executor's output through our log."""
        assert self.proc.stdout is not None
        while True:
            line = await self.proc.stdout.readline()
            if not line:
                return
            log.info("[%s] %s", self.job_id, line.decode(errors="replace").rstrip())

    async def _supervise(self) -> None:
        rc = await self.proc.wait()
        if self.reporter is not None:
            await self.reporter.stop()
        if self.reducer is not None:
            await self.reducer.stop()
        await self.bridge.stop()
        await asyncio.to_thread(shutil.rmtree, self.work_dir, ignore_errors=True)
        if self._cancelled:
            self.finish("cancelled")
        elif rc == 0:
            self.finish("completed")
        else:
            self.finish("failed", f"exit code {rc}")

    async def cancel(self) -> None:
        """SIGTERM, then SIGKILL after the grace period."""
        if self._cancelled or self.proc.returncode is not None:
            return
        self._cancelled = True
        try:
            self.proc.send_signal(signal.SIGTERM)
        except ProcessLookupError:
            return
        try:
            await asyncio.wait_for(self.proc.wait(), GRACE_S)
        except asyncio.TimeoutError:
            log.warning("job %s ignored SIGTERM; killing", self.job_id)
            try:
                self.proc.kill()
            except ProcessLookupError:
                pass
