"""The scheduler's job specification: what a DiLoCo run needs (a copy of
``hypha_tpu/scheduler/job_config.py``).

Reference: crates/scheduler/src/scheduler_config.rs:18-180 —
``Job::Diloco(DiLoCo{model, preprocessor?, dataset, rounds{update_rounds,
avg_samples_between_updates, max_batch_size?}, inner_optimizer: Adam,
outer_optimizer: Nesterov, resources{num_workers, worker,
parameter_server, *_price}})``. Defaults follow the reference's
(scheduler_config.rs:79-102: 2 workers, 100 rounds, 1200 samples/round,
max batch 600).

Every field keeps the JAX package's name, order and default, and the three
classes are registered with the port's codec, so ``messages.encode(job)``
gives the JAX package's bytes. The port schedules every wire codec
(``delta_codec``, ``delta_dtype``), every sync mode (``sync_mode``,
``num_fragments``), the sharded parameter service (``num_ps_shards``), the
tree reduce (``reduce_group_size``, ``reduce_tree_depth``) and its
broadcast tree (``broadcast_tree``), serving followers (``serve_peers``),
WAN-adaptive rounds (``adaptive_steps``, ``adaptive_codec`` and its
``codec_bw_hi_mbps`` / ``codec_bw_lo_mbps``), LoRA fine-tuning (``lora``,
which the trainer reads), slice preprocessors (``preprocessor``), the input
pipeline (``input_pipeline``, ``prefetch_slices``), and, with any of them, fault
tolerance (``ft``, an ``FTConfig``), checkpoints (``checkpoint_dir``,
``checkpoint_every``, ``ps_checkpoint_every_rounds``) and the scheduler's
own crash recovery (``scheduler_recovery``, which needs both).
Each option outside it is accepted only at its off value (``_NOT_PORTED``),
and any other value raises ``NotImplementedError`` naming its ROADMAP.md
label. Malformed values raise the reference's ``ValueError`` first, with
its texts: every cross-field check of the reference runs before the
``_NOT_PORTED`` loop. A non-empty ``slo_rules`` raises under telemetry,
whose rule parser is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..compress import CODECS
from ..ft.membership import FTConfig
from ..messages import Adam, Loss, LRScheduler, Nesterov, PriceRange, _register
from ..resources import Resources
from ..stream import SYNC_MODES, effective_fragments

__all__ = ["DiLoCoRounds", "JobResources", "DiLoCoJob", "CODECS", "SYNC_MODES"]

# (field, the values the port runs, ROADMAP.md label of the rest).
_NOT_PORTED = (
    ("metrics_plane", (False,), "telemetry"),
    ("slo_rules", ([],), "telemetry"),
    ("sharding", (None,), "intra-replica sharding"),
)


@_register
@dataclass(slots=True)
class DiLoCoRounds:
    """Outer-loop shape (scheduler_config.rs Rounds)."""

    update_rounds: int = 100
    avg_samples_between_updates: int = 1200
    max_batch_size: int | None = 600


@_register
@dataclass(slots=True)
class JobResources:
    """What to buy at auction (scheduler_config.rs Resources)."""

    num_workers: int = 2
    worker: Resources = field(default_factory=lambda: Resources(gpu=1.0, cpu=1.0))
    parameter_server: Resources = field(default_factory=lambda: Resources(cpu=1.0))
    worker_price: PriceRange = field(default_factory=lambda: PriceRange(bid=1.0, max=10.0))
    parameter_server_price: PriceRange = field(
        default_factory=lambda: PriceRange(bid=1.0, max=10.0)
    )


@_register
@dataclass(slots=True)
class DiLoCoJob:
    """One DiLoCo training job, end to end. The fields after
    ``preprocessor``, ``lr_scheduler`` and ``loss`` are the reference's
    extensions (documented there); the port runs each at its off value."""

    # Model spec dict as the executor's registry understands it:
    # {"model_type": ModelType, "family": ..., "preset"/"config": ...,
    #  "seed": int, "source": Fetch?, "input_names": [...]}.
    model: dict
    dataset: str
    rounds: DiLoCoRounds = field(default_factory=DiLoCoRounds)
    inner_optimizer: Adam = field(default_factory=lambda: Adam(lr=1e-4))
    outer_optimizer: Nesterov = field(default_factory=Nesterov)
    resources: JobResources = field(default_factory=JobResources)
    preprocessor: dict | None = None
    lr_scheduler: LRScheduler | None = None
    loss: Loss | None = None
    sharding: dict | None = None
    lora: dict | None = None
    delta_dtype: str = "float32"
    delta_codec: str = "none"
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    ps_checkpoint_every_rounds: int = 1
    ft: FTConfig | None = None
    sync_mode: str = "blocking"
    num_fragments: int = 0
    num_ps_shards: int = 1
    reduce_group_size: int = 0
    reduce_tree_depth: int = 0
    broadcast_tree: bool = False
    adaptive_steps: bool = False
    adaptive_codec: bool = False
    codec_bw_hi_mbps: float = 100.0
    codec_bw_lo_mbps: float = 10.0
    scheduler_recovery: bool = False
    metrics_plane: bool = False
    metrics_interval_s: float = 1.0
    input_pipeline: bool = False
    prefetch_slices: int = 0
    metrics_dir: str | None = None
    slo_rules: list = field(default_factory=list)
    serve_peers: list = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.delta_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"delta_dtype must be float32|bfloat16, got {self.delta_dtype!r}"
            )
        if self.delta_codec not in CODECS:
            raise ValueError(
                f"delta_codec must be {'|'.join(CODECS)}, got {self.delta_codec!r}"
            )
        if self.sync_mode not in SYNC_MODES:
            raise ValueError(
                f"sync_mode must be {'|'.join(SYNC_MODES)}, got {self.sync_mode!r}"
            )
        if self.num_fragments < 0:
            raise ValueError("num_fragments must be >= 0 (0 = default)")
        if self.num_ps_shards < 1:
            raise ValueError("num_ps_shards must be >= 1")
        if self.reduce_group_size < 0:
            raise ValueError("reduce_group_size must be >= 0 (0 = disabled)")
        if self.reduce_tree_depth < 0:
            raise ValueError("reduce_tree_depth must be >= 0 (0/1 = single level)")
        if self.reduce_tree_depth >= 2 and self.reduce_group_size < 2:
            raise ValueError(
                "reduce_tree_depth >= 2 needs reduce_group_size >= 2 "
                "(the tree is built from the reduce groups)"
            )
        if self.broadcast_tree and self.reduce_group_size < 2:
            raise ValueError(
                "broadcast_tree needs reduce_group_size >= 2 (the relays "
                "ARE the reduce tree's reducers)"
            )
        if self.broadcast_tree and self.adaptive_codec:
            raise ValueError(
                "broadcast_tree is not supported with adaptive_codec "
                "(per-peer broadcast wires cannot be relayed verbatim)"
            )
        if self.num_ps_shards > 1 and self.sync_mode == "overlap":
            raise ValueError(
                "num_ps_shards > 1 requires sync_mode blocking or stream "
                "(use stream to combine compute overlap with sharding)"
            )
        if self.num_ps_shards > 1 and self.sync_mode == "stream":
            frags = effective_fragments(self.sync_mode, self.num_fragments)
            if self.num_ps_shards > frags:
                raise ValueError(
                    f"num_ps_shards={self.num_ps_shards} exceeds the "
                    f"{frags} stream fragments; every shard must own at "
                    "least one fragment"
                )
        if self.ps_checkpoint_every_rounds < 1:
            raise ValueError("ps_checkpoint_every_rounds must be >= 1")
        if self.adaptive_codec and self.sync_mode != "blocking":
            raise ValueError(
                "adaptive_codec requires sync_mode blocking "
                "(adaptive_steps works with every sync mode)"
            )
        if self.adaptive_codec and self.num_ps_shards > 1:
            raise ValueError(
                "adaptive_codec is not supported with a sharded parameter "
                "service yet"
            )
        if self.adaptive_codec and self.checkpoint_dir:
            raise ValueError(
                "adaptive_codec is not supported with checkpoint_dir "
                "(durable PS) yet"
            )
        if self.codec_bw_lo_mbps > self.codec_bw_hi_mbps:
            raise ValueError("codec_bw_lo_mbps must be <= codec_bw_hi_mbps")
        if self.scheduler_recovery and not self.checkpoint_dir:
            raise ValueError(
                "scheduler_recovery needs a checkpoint_dir (the scheduler "
                "journal lives there)"
            )
        if self.scheduler_recovery and not getattr(self.ft, "enabled", False):
            raise ValueError(
                "scheduler_recovery needs elastic membership (job.ft) — "
                "re-adoption rides the same lease/quorum machinery"
            )
        if self.metrics_interval_s <= 0:
            raise ValueError("metrics_interval_s must be positive")
        if self.prefetch_slices < 0:
            raise ValueError("prefetch_slices must be >= 0 (0 = default)")
        if self.prefetch_slices > 0 and not self.input_pipeline:
            raise ValueError(
                "prefetch_slices needs input_pipeline (the prefetcher IS "
                "the pipeline's fetch stage)"
            )
        if self.rounds.update_rounds <= 0:
            raise ValueError("update_rounds must be positive")
        if self.rounds.avg_samples_between_updates <= 0:
            raise ValueError("avg_samples_between_updates must be positive")
        if self.resources.num_workers <= 0:
            raise ValueError("num_workers must be positive")
        for name, runs, label in _NOT_PORTED:
            value = getattr(self, name)
            if value not in runs:
                raise NotImplementedError(
                    f"DiLoCoJob {name}={value!r} is not ported to PyTorch yet "
                    f"(ROADMAP.md, Queue 1: {label})"
                )
