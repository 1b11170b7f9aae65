"""Per-node configuration schemas (the four binaries' Config structs;
counterpart of ``hypha_tpu/node_config.py``).

Reference: each binary's config module — crates/worker/src/config.rs (the
richest: resources, offer pricing, executor table), crates/scheduler/src/
scheduler_config.rs (the DiLoCo job), and the shared network/TLS/telemetry
sections every binary carries. ``init`` emits these as documented TOML
(config crate ``to_toml``); ``run`` layers TOML ← HYPHA_* env ← CLI.

The sections, keys, defaults and checks are the JAX package's, so a TOML
the JAX CLI reads, the port reads. Three things differ:

* the accelerator axis: a torch worker sells ``gpu``. The job asks for
  ``job.worker_gpu`` (default 1.0); ``job.worker_tpu`` and
  ``resources.tpu`` stay as keys so a JAX file parses, and any value
  above 0 is a ``ConfigError``;
* the process executor's command: by default ``executor.cmd`` and
  ``executor.args`` name the port's trainer CLI (``TRAINER_CMD``,
  ``TRAINER_ARGS``, with a ``{DEVICE}`` placeholder for the worker's
  device), where the reference's are empty, so ``runtime = "process"``
  works as ``init`` writes it; an empty ``cmd`` under it is the
  reference's ``ConfigError``;
* every option outside the port's single-deployment slice is accepted at
  its default and raises ``NotImplementedError`` naming its ROADMAP.md
  label otherwise (``_refuse``), after the reference's own checks. The
  train job's options are refused by ``DiLoCoJob`` itself, which
  ``JobSection.validate`` builds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .config import ConfigError, TLSConfig
from .ft.membership import FTConfig
from .messages import Adam, LRScheduler, LRSchedulerKind, ModelType, Nesterov, PriceRange
from .resources import Resources
from .scheduler.job_config import CODECS, SYNC_MODES, DiLoCoJob, DiLoCoRounds, JobResources

__all__ = [
    "NetworkConfig",
    "TelemetryConfig",
    "GatewayConfig",
    "DataNodeConfig",
    "WorkerConfig",
    "SchedulerConfig",
    "ResourcesConfig",
    "OfferConfigSection",
    "MultihostSection",
    "ExecutorSection",
    "JobSection",
]

_GPU_ONLY = "the port sells gpu: set it to 0 and use {gpu_key} instead"

# The port's trainer CLI, as runtime=process spawns it by default. The
# process executor substitutes {SOCKET_PATH}, {WORK_DIR}, {JOB_JSON} and
# {DEVICE} (the worker's torch device).
TRAINER_CMD = "python3"
TRAINER_ARGS = ["-m", "hypha_tpu_torch.executor.training", "--socket", "{SOCKET_PATH}",
                "--work-dir", "{WORK_DIR}", "--job", "{JOB_JSON}", "--device", "{DEVICE}"]


def _refuse(option: str, label: str) -> None:
    raise NotImplementedError(
        f"{option} is not ported to PyTorch yet (ROADMAP.md, Queue 1: {label})"
    )


@dataclass
class NetworkConfig:
    listen: list[str] = field(
        default_factory=lambda: ["127.0.0.1:0"],
        metadata={"doc": "addresses to listen on (host:port; port 0 = ephemeral)"},
    )
    external: list[str] = field(
        default_factory=list,
        metadata={"doc": "publicly reachable addresses to advertise"},
    )
    gateways: list[str] = field(
        default_factory=list,
        metadata={"doc": "gateway addresses to bootstrap from"},
    )
    exclude_cidrs: list[str] = field(
        default_factory=list,
        metadata={"doc": "CIDR ranges never dialed (scheduler network.rs CIDR exclusion)"},
    )
    relay: bool = field(
        default=True,
        metadata={"doc": "hold gateway circuit reservations so NAT'd peers can reach us"},
    )
    advertise_listen: bool = field(
        default=True,
        metadata={
            "doc": "publish listen addresses to discovery; NAT'd nodes set "
            "false (private addrs travel via the direct-upgrade exchange "
            "instead — the dcutr role)"
        },
    )
    mux: bool = field(
        default=False,
        metadata={
            "doc": "multiplex streams over one connection per peer "
            "(yamux-role second transport; lower RPC latency, bulk pushes "
            "prefer the default parallel connections)"
        },
    )


@dataclass
class TelemetryConfig:
    """OTLP export settings (crates/telemetry; OTEL_* env overrides win)."""

    endpoint: str = field(default="", metadata={"doc": "OTLP endpoint; empty = disabled"})
    protocol: str = field(default="http", metadata={"doc": "otlp protocol: http | grpc"})
    service_name: str = field(default="", metadata={"doc": "service.name resource attribute"})
    sample_ratio: float = field(default=1.0, metadata={"doc": "trace sampling ratio 0..1"})
    attributes: dict = field(
        default_factory=dict, metadata={"doc": "extra resource attributes (k = v)"}
    )

    def validate(self) -> None:
        if self.protocol != "http":
            # Only OTLP/HTTP+JSON is implemented; accepting "grpc" here would
            # silently export nothing (the exporter would POST JSON at a gRPC
            # port and drop every failure).
            raise ConfigError(
                f"telemetry.protocol: only 'http' is supported, got {self.protocol!r}"
            )
        if not 0.0 <= self.sample_ratio <= 1.0:
            raise ConfigError("telemetry.sample_ratio must be in [0, 1]")


@dataclass
class ResourcesConfig:
    """Sellable capacity (crates/worker config resources section)."""

    tpu: float = field(
        default=0.0, metadata={"doc": "TPU chips (must stay 0: a torch worker sells gpu)"}
    )
    gpu: float = field(default=0.0, metadata={"doc": "GPUs this worker sells"})
    cpu: float = field(default=1.0, metadata={"doc": "CPU cores"})
    memory: float = field(default=1024.0, metadata={"doc": "memory in MB"})
    storage: float = field(default=0.0, metadata={"doc": "scratch storage in MB"})

    def validate(self) -> None:
        if self.tpu > 0:
            raise ConfigError("resources.tpu: " + _GPU_ONLY.format(gpu_key="resources.gpu"))

    def to_resources(self) -> Resources:
        return Resources(
            tpu=self.tpu, gpu=self.gpu, cpu=self.cpu,
            memory=self.memory, storage=self.storage,
        )


@dataclass
class OfferConfigSection:
    """Auction pricing (crates/worker/src/config.rs:54-104)."""

    price: float = field(default=1.0, metadata={"doc": "asking price per weighted unit"})
    floor: float = field(default=0.0, metadata={"doc": "reject ads bidding below this"})
    strategy: str = field(
        default="flexible",
        metadata={"doc": "flexible = offer what was asked; whole = offer everything"},
    )

    def validate(self) -> None:
        if self.strategy not in ("flexible", "whole"):
            raise ConfigError(f"offer.strategy: unknown {self.strategy!r}")


@dataclass
class ExecutorSection:
    """Train-executor runtime (crates/worker/src/config.rs:114-191)."""

    runtime: str = field(
        default="in-process",
        metadata={
            "doc": "in-process (the trainer in the worker) | process (spawn cmd; "
            "by default the port's trainer CLI)"
        },
    )
    cmd: str = field(default=TRAINER_CMD, metadata={"doc": "command for runtime=process"})
    args: list[str] = field(
        default_factory=lambda: list(TRAINER_ARGS),
        metadata={"doc": "args; {SOCKET_PATH} {WORK_DIR} {JOB_JSON} {DEVICE} substituted"},
    )

    def validate(self) -> None:
        if self.runtime not in ("in-process", "process"):
            raise ConfigError(f"executor.runtime: unknown {self.runtime!r}")
        if self.runtime == "process" and not self.cmd:
            raise ConfigError("executor.runtime=process needs executor.cmd")


@dataclass
class GatewayConfig:
    name: str = field(default="gateway", metadata={"doc": "node name (cert CN)"})
    network: NetworkConfig = field(default_factory=NetworkConfig)
    tls: TLSConfig = field(default_factory=TLSConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)

    def validate(self) -> None:
        self.tls.validate_files()
        self.telemetry.validate()
        _check_node_sections(self)


def _check_node_sections(conf) -> None:
    """The sections every node carries, past the reference's checks: a
    ``[tls]`` section sets cert, key and trust together (the reference
    starts a plain-TCP node from a partial one)."""
    tls = conf.tls
    if (tls.cert or tls.key or tls.trust or tls.crls) and not tls.enabled():
        raise ConfigError("tls: cert, key and trust go together; a partial [tls] "
                          "section would start an unsecured node")


@dataclass
class DataNodeConfig:
    name: str = field(default="data", metadata={"doc": "node name (cert CN)"})
    datasets: dict = field(
        default_factory=dict,
        metadata={"doc": "dataset name = directory of SafeTensors slice files"},
    )
    network: NetworkConfig = field(default_factory=NetworkConfig)
    tls: TLSConfig = field(default_factory=TLSConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)

    def validate(self) -> None:
        if not self.datasets:
            raise ConfigError("data node needs at least one [datasets] entry")
        self.tls.validate_files()
        self.telemetry.validate()
        _check_node_sections(self)


@dataclass
class MultihostSection:
    """Pod-slice membership: in the JAX package a worker process joins a
    multi-host runtime so one replica spans hosts (parallel/multihost.py).
    The port runs single-host replicas: ``coordinator_address`` raises."""

    coordinator_address: str = field(
        default="", metadata={"doc": "host:port of process 0; empty = single-host"}
    )
    num_processes: int = field(default=1, metadata={"doc": "processes in the slice"})
    process_id: int = field(default=0, metadata={"doc": "this process's rank"})

    def validate(self) -> None:
        if self.coordinator_address and self.num_processes < 2:
            raise ConfigError(
                "multihost.coordinator_address set but num_processes < 2"
            )
        if self.num_processes > 1 and not self.coordinator_address:
            # Half-configured pods must fail at startup — four workers each
            # running an independent "global" mesh would train silently
            # wrong, not loudly.
            raise ConfigError(
                "multihost.num_processes > 1 needs multihost.coordinator_address"
            )
        if not 0 <= self.process_id < max(self.num_processes, 1):
            raise ConfigError("multihost.process_id out of range")


@dataclass
class WorkerConfig:
    name: str = field(default="worker", metadata={"doc": "node name (cert CN)"})
    work_root: str = field(default="/tmp", metadata={"doc": "per-job work dirs live here"})
    resources: ResourcesConfig = field(default_factory=ResourcesConfig)
    offer: OfferConfigSection = field(default_factory=OfferConfigSection)
    executor: ExecutorSection = field(default_factory=ExecutorSection)
    multihost: MultihostSection = field(default_factory=MultihostSection)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    tls: TLSConfig = field(default_factory=TLSConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)

    def validate(self) -> None:
        self.offer.validate()
        self.executor.validate()
        self.multihost.validate()
        self.tls.validate_files()
        self.telemetry.validate()
        if self.resources.to_resources().is_zero():
            raise ConfigError("worker resources are all zero — nothing to sell")
        self.resources.validate()
        if self.multihost.coordinator_address:
            _refuse("multihost.coordinator_address", "Parallel and long context")
        _check_node_sections(self)


@dataclass
class JobSection:
    """The DiLoCo job (crates/scheduler/src/scheduler_config.rs:18-180)."""

    # Default job mirrors the reference's (scheduler_config.rs:79-102:
    # 2 workers, 100 rounds, 1200 samples/round, LeNet/MNIST).
    kind: str = field(
        default="train",
        metadata={"doc": "train (DiLoCo) | serve (inference deployment)"},
    )
    serve_name: str = field(
        default="", metadata={"doc": "serve jobs: name announced as serve:<name>"}
    )
    serve_max_new_tokens: int = field(
        default=256, metadata={"doc": "serve jobs: per-request generation cap"}
    )
    serve_max_batch: int = field(
        default=8, metadata={"doc": "serve jobs: prompts per request cap"}
    )
    serve_workers: int = field(
        default=1,
        metadata={
            "doc": "serve jobs: routed deployments to keep alive (>1 turns "
            "the supervisor into a request router with health ejection)"
        },
    )
    serve_queue_limit: int = field(
        default=0,
        metadata={
            "doc": "serve jobs: queue-depth backpressure — reject with "
            "retry-after beyond this many queued requests (0 = unbounded)"
        },
    )
    serve_block_size: int = field(
        default=0,
        metadata={
            "doc": "serve jobs: paged KV block size in positions "
            "(0 = fixed-slot pool, the pre-paging behavior)"
        },
    )
    serve_blocks: int = field(
        default=0,
        metadata={"doc": "serve jobs: physical KV blocks (0 = derive)"},
    )
    serve_prefill_chunk: int = field(
        default=0,
        metadata={
            "doc": "serve jobs: chunked-prefill tokens per decode chunk "
            "(0 = derive: 4x block size)"
        },
    )
    serve_eos_token_id: int = field(
        default=-1,
        metadata={
            "doc": "serve jobs: EOS token freeing KV rows early "
            "(-1 = use the model config's eos_token_id)"
        },
    )
    serve_prefix_cache: bool = field(
        default=False,
        metadata={
            "doc": "serve jobs: automatic prefix caching — shared prompt "
            "prefixes reuse cached KV blocks (paged mode only)"
        },
    )
    serve_spec_ngram: int = field(
        default=0,
        metadata={
            "doc": "serve jobs: speculative decoding via n-gram prompt "
            "lookup, verified by the chunked-prefill program (0 = off; "
            "paged mode only)"
        },
    )
    serve_spec_draft: int = field(
        default=0,
        metadata={
            "doc": "serve jobs: max draft tokens per speculation verify "
            "(0 = derive: prefill chunk - 1)"
        },
    )
    serve_ragged: bool = field(
        default=False,
        metadata={
            "doc": "serve jobs: ragged paged attention — decode visits "
            "occupied KV blocks only, occupancy-proportional cost "
            "(paged mode only; off = dense gather, bit-identical)"
        },
    )
    serve_kv_quant: str = field(
        default="",
        metadata={
            "doc": "serve jobs: KV block quantization — 'int8' stores "
            "K/V blocks as int8 with per-position max-abs scales "
            "(~4x more lanes per byte of KV); '' = full precision "
            "(paged mode only)"
        },
    )
    serve_spec_layers: int = field(
        default=0,
        metadata={
            "doc": "serve jobs: model-draft speculation — self-draft "
            "with the first N layers of the served model, verified by "
            "the chunked-prefill program (0 = off; paged mode only)"
        },
    )
    serve_prefix_affinity: bool = field(
        default=False,
        metadata={
            "doc": "serve jobs: route requests by prompt-prefix hash so "
            "shared-prefix traffic lands where the cache is warm "
            "(routed deployments only)"
        },
    )
    serve_fleet_cache: bool = field(
        default=False,
        metadata={
            "doc": "serve jobs: fleet-wide prefix cache — backends "
            "advertise cached chain hashes on heartbeats, the router "
            "routes to actual holders and names a pull source so cold "
            "workers fetch KV blocks instead of re-prefilling "
            "(requires serve_prefix_cache)"
        },
    )
    serve_kv_migration: bool = field(
        default=False,
        metadata={
            "doc": "serve jobs: migrate a preempted request's KV blocks "
            "+ cursor to a less-loaded worker instead of recomputing "
            "from scratch (requires serve_prefix_cache)"
        },
    )
    serve_digest_k: int = field(
        default=32,
        metadata={
            "doc": "serve jobs: fleet-cache digest bound — top-K hot "
            "chain hashes piggybacked per ServeLoad heartbeat"
        },
    )
    dataset: str = field(
        default="mnist", metadata={"doc": "dataset name announced by a data node"}
    )
    model_family: str = field(
        default="lenet", metadata={"doc": "gpt2 | llama | mixtral | lenet"}
    )
    model_preset: str = field(default="", metadata={"doc": "named preset, e.g. small"})
    model_config: dict = field(
        default_factory=dict, metadata={"doc": "model config overrides"}
    )
    model_seed: int = field(default=0, metadata={"doc": "init seed (same on all workers)"})
    model_type: str = field(
        default="image-classification",
        metadata={"doc": "ModelType selector (38 variants)"},
    )
    update_rounds: int = field(default=100, metadata={"doc": "outer rounds"})
    avg_samples_between_updates: int = field(
        default=1200, metadata={"doc": "round sample budget"}
    )
    max_batch_size: int = field(default=600, metadata={"doc": "per-worker batch cap"})
    num_workers: int = field(default=2, metadata={"doc": "DiLoCo replicas to buy"})
    inner_lr: float = field(default=1e-4, metadata={"doc": "AdamW learning rate"})
    inner_weight_decay: float = field(default=0.0, metadata={"doc": "AdamW weight decay"})
    outer_lr: float = field(default=0.7, metadata={"doc": "Nesterov outer LR"})
    outer_momentum: float = field(default=0.9, metadata={"doc": "Nesterov momentum"})
    lr_schedule: str = field(
        default="constant",
        metadata={"doc": "constant | cosine-with-warmup | linear-with-warmup | wsd"},
    )
    warmup_steps: int = field(default=0, metadata={"doc": "LR warmup steps"})
    total_steps: int = field(default=0, metadata={"doc": "LR schedule horizon"})
    worker_tpu: float = field(
        default=0.0, metadata={"doc": "TPU chips per replica (must stay 0: use worker_gpu)"}
    )
    worker_gpu: float = field(default=1.0, metadata={"doc": "GPUs required per replica"})
    worker_cpu: float = field(default=1.0, metadata={"doc": "cores required per replica"})
    worker_memory: float = field(default=100.0, metadata={"doc": "MB required per replica"})
    ps_cpu: float = field(default=1.0, metadata={"doc": "cores for the parameter server"})
    ps_memory: float = field(default=100.0, metadata={"doc": "MB for the parameter server"})
    worker_bid: float = field(default=1.0, metadata={"doc": "auction bid per worker"})
    worker_max_price: float = field(default=10.0, metadata={"doc": "auction price cap"})
    sharding: dict = field(
        default_factory=dict,
        metadata={"doc": "intra-replica mesh axes: dp/fsdp/tp/sp/ep = n"},
    )
    checkpoint_dir: str = field(
        default="", metadata={"doc": "resume checkpoints under this dir; empty = off"}
    )
    checkpoint_every: int = field(
        default=1, metadata={"doc": "checkpoint every N completed rounds"}
    )
    ps_checkpoint_every_rounds: int = field(
        default=1,
        metadata={
            "doc": "durable PS: outer-state checkpoint every N committed "
            "rounds (journal covers the gap; needs checkpoint_dir)"
        },
    )
    max_attempts: int = field(
        default=1,
        metadata={"doc": "re-run a failed job up to N times (elastic recovery)"},
    )
    quorum_fraction: float = field(
        default=0.0,
        metadata={
            "doc": "elastic rounds: aggregate at ceil(f*active) deltas after "
            "the round deadline; 0 = wait for every worker (seed behavior)"
        },
    )
    round_deadline_s: float = field(
        default=30.0,
        metadata={"doc": "elastic rounds: PS wait before quorum aggregation"},
    )
    phi_threshold: float = field(
        default=8.0,
        metadata={"doc": "phi-accrual suspicion threshold (Cassandra-style)"},
    )
    delta_codec: str = field(
        default="none",
        metadata={
            "doc": "outer-round wire codec: none | bf16 | int8 | int4 "
            "(int8/int4 = chunkwise quantization + error feedback)"
        },
    )
    sync_mode: str = field(
        default="blocking",
        metadata={
            "doc": "outer sync: blocking (ship, wait, merge) | overlap "
            "(upload + broadcast hidden behind inner steps) | stream "
            "(overlap + staggered parameter fragments)"
        },
    )
    num_fragments: int = field(
        default=0,
        metadata={
            "doc": "stream mode: parameter fragments per round cycle "
            "(0 = default 4); each fragment syncs every num_fragments rounds"
        },
    )
    input_pipeline: bool = field(
        default=False,
        metadata={
            "doc": "async input pipeline: background slice prefetch + "
            "zero-copy batch assembly + deferred device sync (batch order "
            "and losses stay bit-exact; off = the synchronous loader)"
        },
    )
    prefetch_slices: int = field(
        default=0,
        metadata={
            "doc": "input pipeline: dataset slices fetched ahead / held "
            "per worker (0 = executor default; needs input_pipeline)"
        },
    )
    adaptive_steps: bool = field(
        default=False,
        metadata={
            "doc": "straggler-adaptive inner steps: per-worker step counts "
            "from EWMA round-trip history (off = the reference projection)"
        },
    )
    adaptive_codec: bool = field(
        default=False,
        metadata={
            "doc": "per-link codec selection: slow links degrade to "
            "int8/int4 from the PS's measured-bandwidth table (off = one "
            "job-wide delta_codec)"
        },
    )
    codec_bw_hi_mbps: float = field(
        default=100.0,
        metadata={"doc": "adaptive_codec: links >= this keep the job codec"},
    )
    codec_bw_lo_mbps: float = field(
        default=10.0,
        metadata={"doc": "adaptive_codec: links below this ship int4"},
    )
    metrics_plane: bool = field(
        default=False,
        metadata={
            "doc": "live metrics plane: nodes push periodic MetricsReport "
            "deltas to the scheduler on /hypha-metrics/0.0.1; the scheduler "
            "aggregates, journals metrics-<job>.jsonl and evaluates "
            "slo_rules (off = byte-identical wire)"
        },
    )
    metrics_interval_s: float = field(
        default=1.0,
        metadata={"doc": "metrics plane: seconds between node reports"},
    )
    metrics_dir: str = field(
        default="",
        metadata={
            "doc": "metrics plane: journal directory (empty = the trace "
            "dir when tracing is on, else no journal)"
        },
    )
    slo_rules: list = field(
        default_factory=list,
        metadata={
            "doc": "metrics plane: declarative SLO rules, e.g. "
            "'hypha.serve.request_latency_ms.p99 <= 250', "
            "'round_wall_s <= 30', 'silent_s <= 15' — breaches log "
            "advisories and fire flight events"
        },
    )

    def validate(self) -> None:
        self._validate_reference()
        if self.worker_tpu > 0:
            raise ConfigError("job.worker_tpu: " + _GPU_ONLY.format(gpu_key="job.worker_gpu"))
        for name, value, label in (
            ("serve_spec_ngram", self.serve_spec_ngram, "speculative decoding"),
            ("serve_spec_draft", self.serve_spec_draft, "speculative decoding"),
            ("serve_spec_layers", self.serve_spec_layers, "speculative decoding"),
        ):
            if value:
                _refuse(f"job.{name}", label)
        if self.kind == "serve":
            if self.serve_block_size == 0:
                _refuse("job.serve_block_size = 0", "fixed-slot pool mode")
        else:
            # DiLoCoJob accepts each option outside the port's
            # single-PS path only at its off value and names
            # its label otherwise: build it now, so a bad file fails here.
            self.to_job()

    def _validate_reference(self) -> None:
        """The JAX package's checks, in its order and with its texts."""
        if self.kind not in ("train", "serve"):
            raise ConfigError("job.kind must be 'train' or 'serve'")
        try:
            ModelType(self.model_type)
        except ValueError:
            raise ConfigError(
                f"job.model_type: unknown {self.model_type!r}"
            ) from None
        if self.kind == "serve":
            if not self.serve_name:
                raise ConfigError("job.serve_name is required for serve jobs")
            if self.serve_max_new_tokens < 1:
                raise ConfigError("job.serve_max_new_tokens must be >= 1")
            if self.serve_max_batch < 1:
                raise ConfigError("job.serve_max_batch must be >= 1")
            if self.serve_workers < 1:
                raise ConfigError("job.serve_workers must be >= 1")
            if self.serve_queue_limit < 0:
                raise ConfigError("job.serve_queue_limit must be >= 0")
            if self.serve_block_size < 0:
                raise ConfigError("job.serve_block_size must be >= 0")
            if self.serve_spec_ngram < 0:
                raise ConfigError("job.serve_spec_ngram must be >= 0")
            if self.serve_spec_draft < 0:
                raise ConfigError("job.serve_spec_draft must be >= 0")
            if self.serve_prefix_cache and self.serve_block_size <= 0:
                raise ConfigError(
                    "job.serve_prefix_cache requires serve_block_size > 0 "
                    "(paged mode)"
                )
            if self.serve_spec_ngram > 0 and self.serve_block_size <= 0:
                raise ConfigError(
                    "job.serve_spec_ngram requires serve_block_size > 0 "
                    "(paged mode)"
                )
            if self.serve_ragged and self.serve_block_size <= 0:
                raise ConfigError(
                    "job.serve_ragged requires serve_block_size > 0 "
                    "(paged mode)"
                )
            if self.serve_kv_quant not in ("", "int8"):
                raise ConfigError(
                    "job.serve_kv_quant must be '' or 'int8'"
                )
            if self.serve_kv_quant and self.serve_block_size <= 0:
                raise ConfigError(
                    "job.serve_kv_quant requires serve_block_size > 0 "
                    "(paged mode)"
                )
            if self.serve_spec_layers < 0:
                raise ConfigError("job.serve_spec_layers must be >= 0")
            if self.serve_spec_layers > 0 and self.serve_block_size <= 0:
                raise ConfigError(
                    "job.serve_spec_layers requires serve_block_size > 0 "
                    "(paged mode)"
                )
            if (
                self.serve_fleet_cache or self.serve_kv_migration
            ) and not self.serve_prefix_cache:
                raise ConfigError(
                    "job.serve_fleet_cache / serve_kv_migration require "
                    "serve_prefix_cache (content-addressed blocks)"
                )
            if self.serve_digest_k < 1:
                raise ConfigError("job.serve_digest_k must be >= 1")
            return  # dataset/rounds are train-only concerns
        if not self.dataset:
            raise ConfigError("job.dataset is required")
        if self.max_attempts < 1:
            raise ConfigError("job.max_attempts must be >= 1")
        if self.ps_checkpoint_every_rounds < 1:
            raise ConfigError("job.ps_checkpoint_every_rounds must be >= 1")
        if not 0.0 <= self.quorum_fraction <= 1.0:
            raise ConfigError("job.quorum_fraction must be in [0, 1]")
        if self.delta_codec not in CODECS:
            raise ConfigError(
                f"job.delta_codec must be one of {'|'.join(CODECS)}, "
                f"got {self.delta_codec!r}"
            )
        if self.sync_mode not in SYNC_MODES:
            raise ConfigError(
                f"job.sync_mode must be one of {'|'.join(SYNC_MODES)}, "
                f"got {self.sync_mode!r}"
            )
        if self.num_fragments < 0:
            raise ConfigError("job.num_fragments must be >= 0 (0 = default)")
        if self.prefetch_slices < 0:
            raise ConfigError("job.prefetch_slices must be >= 0 (0 = default)")
        if self.prefetch_slices > 0 and not self.input_pipeline:
            raise ConfigError("job.prefetch_slices needs job.input_pipeline")
        if self.adaptive_codec and self.sync_mode != "blocking":
            raise ConfigError(
                "job.adaptive_codec requires sync_mode = blocking"
            )
        if self.adaptive_codec and self.checkpoint_dir:
            raise ConfigError(
                "job.adaptive_codec is not supported with checkpoint_dir yet"
            )
        if self.codec_bw_lo_mbps > self.codec_bw_hi_mbps:
            raise ConfigError(
                "job.codec_bw_lo_mbps must be <= job.codec_bw_hi_mbps"
            )
        if self.metrics_interval_s <= 0:
            raise ConfigError("job.metrics_interval_s must be positive")
        if self.slo_rules:
            from .telemetry.slo import parse_slo_rule

            for rule in self.slo_rules:
                try:
                    parse_slo_rule(str(rule))
                except ValueError as e:
                    raise ConfigError(f"job.slo_rules: {e}") from None
        if self.round_deadline_s < 0:
            raise ConfigError("job.round_deadline_s must be >= 0")
        if self.phi_threshold <= 0:
            raise ConfigError("job.phi_threshold must be positive")
        try:
            ModelType(self.model_type)
        except ValueError:
            raise ConfigError(f"job.model_type: unknown {self.model_type!r}")
        try:
            LRSchedulerKind(self.lr_schedule)
        except ValueError:
            raise ConfigError(f"job.lr_schedule: unknown {self.lr_schedule!r}")

    def to_model_spec(self) -> dict:
        """The model dict shared by train and serve jobs."""
        model: dict[str, Any] = {
            "model_type": ModelType(self.model_type),
            "family": self.model_family,
            "seed": self.model_seed,
        }
        if self.model_preset:
            model["preset"] = self.model_preset
        if self.model_config:
            model["config"] = dict(self.model_config)
        return model

    def worker_resources(self) -> Resources:
        return Resources(
            gpu=self.worker_gpu, cpu=self.worker_cpu, memory=self.worker_memory
        )

    def worker_price(self) -> PriceRange:
        return PriceRange(bid=self.worker_bid, max=self.worker_max_price)

    def to_job(self) -> DiLoCoJob:
        model = self.to_model_spec()
        schedule = None
        if self.lr_schedule != "constant":
            schedule = LRScheduler(
                kind=LRSchedulerKind(self.lr_schedule),
                warmup_steps=self.warmup_steps,
                total_steps=self.total_steps,
            )
        return DiLoCoJob(
            model=model,
            dataset=self.dataset,
            rounds=DiLoCoRounds(
                update_rounds=self.update_rounds,
                avg_samples_between_updates=self.avg_samples_between_updates,
                max_batch_size=self.max_batch_size,
            ),
            inner_optimizer=Adam(lr=self.inner_lr, weight_decay=self.inner_weight_decay),
            outer_optimizer=Nesterov(lr=self.outer_lr, momentum=self.outer_momentum),
            resources=JobResources(
                num_workers=self.num_workers,
                worker=self.worker_resources(),
                parameter_server=Resources(cpu=self.ps_cpu, memory=self.ps_memory),
                worker_price=self.worker_price(),
                parameter_server_price=self.worker_price(),
            ),
            lr_scheduler=schedule,
            sharding=dict(self.sharding) or None,
            checkpoint_dir=self.checkpoint_dir or None,
            checkpoint_every=self.checkpoint_every,
            ps_checkpoint_every_rounds=self.ps_checkpoint_every_rounds,
            delta_codec=self.delta_codec,
            sync_mode=self.sync_mode,
            num_fragments=self.num_fragments,
            input_pipeline=self.input_pipeline,
            prefetch_slices=self.prefetch_slices,
            adaptive_steps=self.adaptive_steps,
            adaptive_codec=self.adaptive_codec,
            codec_bw_hi_mbps=self.codec_bw_hi_mbps,
            codec_bw_lo_mbps=self.codec_bw_lo_mbps,
            metrics_plane=self.metrics_plane,
            metrics_interval_s=self.metrics_interval_s,
            metrics_dir=self.metrics_dir or None,
            slo_rules=list(self.slo_rules),
            ft=(
                FTConfig(
                    quorum_fraction=self.quorum_fraction,
                    round_deadline_s=self.round_deadline_s,
                    phi_threshold=self.phi_threshold,
                )
                if self.quorum_fraction > 0
                else None
            ),
        )


@dataclass
class SchedulerConfig:
    name: str = field(default="scheduler", metadata={"doc": "node name (cert CN)"})
    status_bridge: str = field(
        default="", metadata={"doc": "AIM metrics sink host:port; empty = log only"}
    )
    job: JobSection = field(default_factory=JobSection)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    tls: TLSConfig = field(default_factory=TLSConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)

    def validate(self) -> None:
        self.job.validate()
        self.tls.validate_files()
        self.telemetry.validate()
        _check_node_sections(self)
