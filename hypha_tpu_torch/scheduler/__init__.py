"""Scheduler: DiLoCo orchestration — allocation, data/batch scheduling,
tracking (a copy of ``hypha_tpu/scheduler/`` for the
single-parameter-server path: every codec and sync mode, and elastic,
checkpointed blocking jobs).

Mirrors the reference's ``hypha-scheduler`` crate (SURVEY.md §2.4). The
entry point is ``orchestrator.Orchestrator(node).run(job)`` with a
``job_config.DiLoCoJob``. Not ported: the serving supervisor
(``serving.py``; ROADMAP.md, Queue 1: the network infer executor)."""

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
