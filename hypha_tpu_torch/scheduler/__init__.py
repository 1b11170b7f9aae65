"""Scheduler: DiLoCo orchestration — allocation, data/batch scheduling,
tracking and the serving supervisor (a copy of ``hypha_tpu/scheduler/``:
every codec and sync mode, the sharded parameter service and the tree
reduce, elastic and checkpointed jobs with per-shard restarts, a
restarted scheduler that adopts its predecessor's executions, and
``serving.py``).

Mirrors the reference's ``hypha-scheduler`` crate (SURVEY.md §2.4). The
entry point is ``orchestrator.Orchestrator(node).run(job)`` with a
``job_config.DiLoCoJob``."""

from .statistics import RunningMean, RuntimeStatistic
from .simulation import Projection, WorkerSim, project
from .trackers import ProgressTracker, SliceTracker, WorkerState

__all__ = [
    "RunningMean",
    "RuntimeStatistic",
    "Projection",
    "WorkerSim",
    "project",
    "ProgressTracker",
    "SliceTracker",
    "WorkerState",
]
