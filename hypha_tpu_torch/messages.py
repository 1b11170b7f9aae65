"""Wire vocabulary: the messages the trainer, the worker runtime and the
parameter server speak (a copy of the subset of ``hypha_tpu/messages.py``
that the port sends or reads).

Field names, defaults, enum values, registered names and the tagged plain
form (``{"_t": class name, ...}`` for a dataclass, ``{"_e": enum name,
"v": value}`` for an enum, ``{"_d": ...}`` escaping a user dict with those
keys, optional ``None`` fields omitted) are the JAX package's, and
``encode`` / ``decode`` put that form through the port's CBOR codec, so a
message is the same bytes in both packages (``tests/test_torch_codec.py``).
A message of a subsystem that is not ported (live weight follow, elastic
membership) has no class here and does not decode.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
import uuid
from typing import Any, ClassVar

from . import codec
from .resources import Resources

__all__ = [
    "Ack", "Adam", "AdoptAck", "AggregateExecutorConfig", "CancelJob", "DataRecord",
    "DataRequest", "DataResponse", "DataSlice", "DispatchJob", "DispatchJobResponse",
    "Executor", "ExecutorDescriptor", "Fetch", "FragmentTag", "GenerateRequest", "GenerateResponse",
    "HealthRequest", "HealthResponse", "InferExecutorConfig", "JobSpec",
    "JobStatus", "Loss", "LRScheduler", "LRSchedulerKind", "ModelType", "Nesterov",
    "BlockChain", "BlockPull", "MigrateAck", "MigrateRequest",
    "Preprocessor", "PriceRange", "Progress", "ProgressKind", "ProgressResponse",
    "ProgressResponseKind",
    "Receive", "Reference", "RenewLease", "RenewLeaseResponse", "RequestWorker",
    "SchedulerHello", "Send", "ServeLoad", "ServeLoadAck", "ShardMap", "TrainExecutorConfig",
    "TransferStrategy", "WeightFollow",
    "WorkerOffer", "WorkerSpec", "decode", "encode", "from_json_dict", "to_json_dict",
    "PROTOCOL_API", "PROTOCOL_GENERATE", "PROTOCOL_HEALTH", "PROTOCOL_PROGRESS",
    "PROTOCOL_BLOCKS", "PROTOCOL_SERVE", "PROTOCOL_SHARD", "TOPIC_WORKER",
    "CODEC_KEY", "COVERS_KEY", "PREFOLD_KEY", "SHARD_KEY", "TRACEPARENT_KEY", "TRAIN_EXECUTOR_NAME", "AGGREGATE_EXECUTOR_NAME", "INFER_EXECUTOR_NAME",
]

PROTOCOL_API = "/hypha-api/0.0.1"
PROTOCOL_HEALTH = "/hypha-health/0.0.1"
# The scheduler's progress protocol (STATUS, UPDATE, ... -> ProgressResponse).
PROTOCOL_PROGRESS = "/hypha-progress/0.0.1"
# The serving RPC (GenerateRequest -> GenerateResponse).
PROTOCOL_GENERATE = "/hypha-generate/0.0.1"
# The request router's load heartbeats (ServeLoad -> ServeLoadAck).
PROTOCOL_SERVE = "/hypha-serve/0.0.1"
# The fleet KV-block plane: prefix-chain pulls (BlockPull -> BlockChain) and
# preempted-request migration (MigrateRequest -> MigrateAck).
PROTOCOL_BLOCKS = "/hypha-blocks/0.0.1"
# The sharded parameter service: delta pushes routed to the owning shard,
# per-shard broadcasts, and the ShardMap placement inside job specs.
PROTOCOL_SHARD = "/hypha-shard/0.0.1"
# The gossip topic of the auction's RequestWorker ads.
TOPIC_WORKER = "hypha/worker"

# Executor implementation names: what a scheduler asks for at auction and
# what a worker advertises.
TRAIN_EXECUTOR_NAME = "diloco-transformer"
AGGREGATE_EXECUTOR_NAME = "parameter-server"
INFER_EXECUTOR_NAME = "generate"

_REGISTRY: dict[str, type] = {}
_ENUMS: dict[str, type] = {}


def _register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def _enum(cls):
    _ENUMS[cls.__name__] = cls
    return cls


# The reference's manifest of which top-level types each stream protocol
# carries, and which types travel only nested inside others.
PROTOCOL_MESSAGES: dict[str, tuple[str, ...]] = {}
VALUE_VOCABULARY: set[str] = set()


def declare_protocol(protocol_id: str, *message_names: str) -> None:
    """Claim top-level message types for a stream protocol."""
    existing = PROTOCOL_MESSAGES.get(protocol_id, ())
    PROTOCOL_MESSAGES[protocol_id] = tuple(dict.fromkeys(existing + message_names))


def declare_values(*message_names: str) -> None:
    """Claim message types as nested value vocabulary (no stream of their own)."""
    VALUE_VOCABULARY.update(message_names)


def _to_plain(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d: dict[str, Any] = {"_t": type(obj).__name__}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None and f.default is None:
                continue  # optional-None is omitted, as in the JAX package
            d[f.name] = _to_plain(v)
        return d
    if isinstance(obj, enum.Enum):
        return {"_e": type(obj).__name__, "v": obj.value}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, dict):
        plain = {k: _to_plain(v) for k, v in obj.items()}
        if any(k in plain for k in ("_t", "_e", "_d")):
            return {"_d": plain}
        return plain
    return obj


def _from_plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "_d" in obj:
            return {k: _from_plain(v) for k, v in obj["_d"].items()}
        if "_t" in obj:
            if obj["_t"] == "Resources":
                return Resources.from_wire({k: v for k, v in obj.items() if k != "_t"})
            cls = _REGISTRY.get(obj["_t"])
            if cls is None:
                raise ValueError(f"unknown or unported wire tag {obj['_t']!r}")
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: _from_plain(v) for k, v in obj.items() if k != "_t" and k in known})
        if "_e" in obj:
            ecls = _ENUMS.get(obj["_e"])
            if ecls is None:
                raise ValueError(f"unknown enum tag {obj['_e']!r}")
            return ecls(obj["v"])
        return {k: _from_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_plain(v) for v in obj]
    return obj


def encode(msg: Any) -> bytes:
    """The message's CBOR wire bytes."""
    return codec.dumps(_to_plain(msg))


def decode(data: bytes) -> Any:
    """The inverse of :func:`encode`."""
    return _from_plain(codec.loads(data))


def to_json_dict(msg: Any) -> Any:
    """JSON-safe tagged plain form of a message."""
    return _to_plain(msg)


def from_json_dict(obj: Any) -> Any:
    """The inverse of :func:`to_json_dict`."""
    return _from_plain(obj)


@_enum
class ModelType(enum.Enum):
    CAUSAL_LM = "causal-lm"
    MASKED_LM = "masked-lm"
    SEQ2SEQ_LM = "seq2seq-lm"
    SEQUENCE_CLASSIFICATION = "sequence-classification"
    TOKEN_CLASSIFICATION = "token-classification"
    QUESTION_ANSWERING = "question-answering"
    MULTIPLE_CHOICE = "multiple-choice"
    NEXT_SENTENCE_PREDICTION = "next-sentence-prediction"
    AUDIO_CLASSIFICATION = "audio-classification"
    CTC = "ctc"
    SPEECH_SEQ2SEQ = "speech-seq2seq"
    AUDIO_FRAME_CLASSIFICATION = "audio-frame-classification"
    AUDIO_XVECTOR = "audio-xvector"
    TEXT_TO_WAVEFORM = "text-to-waveform"
    TEXT_TO_SPECTROGRAM = "text-to-spectrogram"
    IMAGE_CLASSIFICATION = "image-classification"
    VIDEO_CLASSIFICATION = "video-classification"
    IMAGE_SEGMENTATION = "image-segmentation"
    SEMANTIC_SEGMENTATION = "semantic-segmentation"
    INSTANCE_SEGMENTATION = "instance-segmentation"
    UNIVERSAL_SEGMENTATION = "universal-segmentation"
    OBJECT_DETECTION = "object-detection"
    ZERO_SHOT_OBJECT_DETECTION = "zero-shot-object-detection"
    ZERO_SHOT_IMAGE_CLASSIFICATION = "zero-shot-image-classification"
    DEPTH_ESTIMATION = "depth-estimation"
    MASKED_IMAGE_MODELING = "masked-image-modeling"
    IMAGE_TO_IMAGE = "image-to-image"
    KEYPOINT_DETECTION = "keypoint-detection"
    VISION2SEQ = "vision2seq"
    IMAGE_TEXT_TO_TEXT = "image-text-to-text"
    DOCUMENT_QUESTION_ANSWERING = "document-question-answering"
    VISUAL_QUESTION_ANSWERING = "visual-question-answering"
    TABLE_QUESTION_ANSWERING = "table-question-answering"
    FEATURE_EXTRACTION = "feature-extraction"
    IMAGE_FEATURE_EXTRACTION = "image-feature-extraction"
    MASK_GENERATION = "mask-generation"
    TIME_SERIES_PREDICTION = "time-series-prediction"
    PRETRAINING = "pretraining"


@_enum
class Preprocessor(enum.Enum):
    """HF Auto preprocessor selector (``TrainExecutorConfig.preprocessor``'s
    ``kind``; ``executor/preprocess.py``)."""

    TOKENIZER = "tokenizer"
    IMAGE_PROCESSOR = "image-processor"
    FEATURE_EXTRACTOR = "feature-extractor"
    PROCESSOR = "processor"
    VIDEO_PROCESSOR = "video-processor"


@_enum
class Loss(enum.Enum):
    CROSS_ENTROPY = "cross-entropy"
    MSE = "mse"
    MAE = "mae"
    BCE_WITH_LOGITS = "bce-with-logits"
    NLL = "nll"


@_enum
class LRSchedulerKind(enum.Enum):
    CONSTANT = "constant"
    COSINE_WITH_WARMUP = "cosine-with-warmup"
    LINEAR_WITH_WARMUP = "linear-with-warmup"
    WSD = "wsd"


@_register
@dataclass(slots=True)
class LRScheduler:
    kind: LRSchedulerKind = LRSchedulerKind.CONSTANT
    warmup_steps: int = 0
    total_steps: int = 0
    decay_start: float = 0.9  # WSD: the stable phase ends at decay_start * total


@_register
@dataclass(slots=True)
class Adam:
    """Inner optimizer; betas default to (0.9, 0.999), epsilon to 1e-8."""

    lr: float = 1e-3
    betas: tuple | None = None
    epsilon: float | None = None
    weight_decay: float = 0.0

    def __post_init__(self) -> None:
        if self.betas is not None:
            self.betas = tuple(self.betas)


@_register
@dataclass(slots=True)
class Nesterov:
    """Outer optimizer of the parameter server."""

    lr: float = 0.7
    momentum: float = 0.9


@_enum
class TransferStrategy(enum.Enum):
    ALL = "all"
    ANY = "any"


@_register
@dataclass(slots=True)
class Reference:
    """Fetch/send/receive addressing: exactly one variant's fields are set
    (``uri``; ``repo``/``revision``/``filenames``/``token``;
    ``peers``/``strategy``/``resource``; ``scheduler_peer``/``dataset``)."""

    uri: str | None = None
    repo: str | None = None
    revision: str | None = None
    filenames: list | None = None
    token: str | None = None
    peers: list | None = None
    strategy: TransferStrategy | None = None
    resource: str | None = None
    scheduler_peer: str | None = None
    dataset: str | None = None
    prefetch: int | None = None

    def variant(self) -> str:
        if self.uri is not None:
            return "uri"
        if self.repo is not None:
            return "huggingface"
        if self.peers is not None:
            return "peers"
        if self.scheduler_peer is not None or self.dataset is not None:
            return "scheduler"
        raise ValueError("empty Reference")

    @classmethod
    def from_uri(cls, uri: str) -> "Reference":
        return cls(uri=uri)

    @classmethod
    def hugging_face(cls, repo: str, filenames: list, revision: str = "main",
                     token: "str | None" = None) -> "Reference":
        if not repo or not filenames:
            raise ValueError("HuggingFace reference needs repo and filenames")
        return cls(repo=repo, revision=revision, filenames=list(filenames), token=token)

    @classmethod
    def from_peers(cls, peers: list, resource: str,
                   strategy: TransferStrategy = TransferStrategy.ALL) -> "Reference":
        return cls(peers=list(peers), strategy=strategy, resource=resource)

    @classmethod
    def from_scheduler(cls, peer: str, dataset: str,
                       prefetch: "int | None" = None) -> "Reference":
        return cls(scheduler_peer=peer, dataset=dataset, prefetch=prefetch)


def _newtype_ref(name: str, allowed: frozenset):
    """Reference wrappers that admit only some variants."""

    @dataclass(slots=True)
    class _Wrapper:
        ref: Reference

        _ALLOWED: ClassVar[frozenset] = allowed

        def __post_init__(self) -> None:
            v = self.ref.variant()
            if v not in self._ALLOWED:
                raise ValueError(f"{name} does not allow Reference variant {v!r}")

    _Wrapper.__name__ = _Wrapper.__qualname__ = name
    _REGISTRY[name] = _Wrapper
    return _Wrapper


Fetch = _newtype_ref("Fetch", frozenset({"uri", "huggingface", "peers", "scheduler"}))
Send = _newtype_ref("Send", frozenset({"peers"}))
Receive = _newtype_ref("Receive", frozenset({"peers"}))


@_register
@dataclass(slots=True)
class ShardMap:
    """The sharded parameter service's placement, riding inside dispatched
    train specs: shard ``k`` is the peer ``shards[k]`` under the updates
    tag ``tags[k]``; placement part ``f`` belongs to shard
    ``stream.shard_of(f, len(shards))``. ``groups`` is the tree-reduce plan
    (``stream.tree.build_reduce_groups``: ``[reducer, *members]`` each),
    ``tree_depth`` the depth it was built with (None at depth 1).
    ``serve_leaves`` are the serving followers hung off the relay heads
    under a broadcast tree (``stream.tree.with_serve_leaves``)."""

    round: int = 0  # the round the placement takes effect
    shards: list = field(default_factory=list)
    tags: list = field(default_factory=list)
    fragments: int = 1  # the placed part count
    groups: list = field(default_factory=list)
    tree_depth: int | None = None
    serve_leaves: list | None = None

    def __post_init__(self) -> None:
        if self.tags and len(self.tags) != len(self.shards):
            raise ValueError(f"ShardMap has {len(self.shards)} shards but {len(self.tags)} tags")

    @property
    def num_shards(self) -> int:
        return len(self.shards)


@_register
@dataclass(slots=True)
class FragmentTag:
    """The (round, fragment) identity of one streamed transfer: it rides
    the push header of every fragment delta and per-fragment broadcast, and
    is mirrored into HQD1 frame headers (``compress.write_delta(tag=)``).
    ``round`` always travels next to ``fragment_id``, so a stale fragment
    cannot fold into the wrong round's mean."""

    round: int = 0
    fragment_id: int = 0
    fragments: int = 1  # the fragment count (a cross-check)

    def header(self) -> dict:
        """The plain keys merged into a push header."""
        return {"round": self.round, "fragment_id": self.fragment_id,
                "fragments": self.fragments}

    @classmethod
    def from_header(cls, header: Any) -> "FragmentTag | None":
        """Parse a push header; None when untagged or malformed."""
        if not isinstance(header, dict) or "fragment_id" not in header:
            return None
        try:
            return cls(round=int(header.get("round", 0)),
                       fragment_id=int(header["fragment_id"]),
                       fragments=max(int(header.get("fragments", 1)), 1))
        except (TypeError, ValueError):
            return None


# The broadcast-header key of the per-link codec hint an adaptive parameter
# server stamps (ft.adaptive, ``adaptive_codec`` jobs only): the trainer
# switches its next upload to that codec.
CODEC_KEY = "codec"

# Push-header keys of the sharded service and the tree reduce: the sending
# or target shard's index (stamped by sharded jobs only, always beside
# ``round``); a reducer's partial, already Σ samples·Δθ over its group,
# which a shard folds verbatim; and the worker peers that partial covers.
SHARD_KEY = "shard"
PREFOLD_KEY = "prefold"
COVERS_KEY = "covers"

# Cross-peer trace propagation (telemetry.trace): the push / broadcast header
# key carrying a ``<trace_id>-<parent_span_id>`` context (32 + 16 lowercase
# hex chars). Only traced jobs stamp it: with tracing off no header carries
# the key and every message omits its ``traceparent`` field, so the wire is
# byte-identical to the untraced build.
TRACEPARENT_KEY = "traceparent"


@_register
@dataclass(slots=True)
class ExecutorDescriptor:
    """An executor class and implementation a worker supports."""

    executor_class: str  # "train" | "aggregate"
    name: str


@_register
@dataclass(slots=True)
class WorkerSpec:
    """What a scheduler wants of a worker."""

    resources: Resources
    executor: list  # list[ExecutorDescriptor]


@_register
@dataclass(slots=True)
class TrainExecutorConfig:
    """The train job; every field of the JAX package's config, so that a
    spec round-trips. ``run_training`` raises NotImplementedError on the
    options the port has not ported yet."""

    model: dict
    data: Any  # Fetch
    updates: Any  # Send
    results: Any  # Receive
    optimizer: Adam
    batch_size: int
    preprocessor: dict | None = None
    scheduler: LRScheduler | None = None
    loss: Loss | None = None
    sharding: dict | None = None
    checkpoint: dict | None = None
    lora: dict | None = None
    delta_dtype: str = "float32"
    delta_codec: str = "none"
    rejoin: bool = False
    sync_mode: str = "blocking"
    fragments: int = 0
    ps_shards: ShardMap | None = None
    reduce_via: str | None = None
    reduce_members: list = field(default_factory=list)
    relay_results: bool | None = None
    adopt_grace_s: float | None = None
    report_metrics_s: float | None = None
    metrics_peer: str | None = None
    input_pipeline: bool | None = None
    prefetch_slices: int | None = None


@_register
@dataclass(slots=True)
class AggregateExecutorConfig:
    """The parameter server's job; every field of the JAX package's config,
    so that a spec round-trips. The port's ``ParameterServerExecutor``
    raises NotImplementedError on the options it does not run."""

    updates: Any  # Receive
    results: Any  # Send
    optimizer: Nesterov
    num_workers: int = 0  # how many pseudo-gradients form one round
    checkpoint_dir: str | None = None
    quorum_fraction: float = 0.0
    round_deadline_s: float = 0.0
    delta_codec: str = "none"
    sync_mode: str = "blocking"
    fragments: int = 0
    ps_checkpoint_every_rounds: int = 1
    shard_index: int = 0
    num_ps_shards: int = 1
    adaptive_steps: bool | None = None
    adaptive_codec: bool | None = None
    broadcast_tree: ShardMap | None = None
    codec_bw_hi_mbps: float | None = None
    codec_bw_lo_mbps: float | None = None
    adopt_grace_s: float | None = None
    report_metrics_s: float | None = None
    metrics_peer: str | None = None
    serve_peers: list | None = None


@_register
@dataclass(slots=True)
class WeightFollow:
    """Live weight swap: attach a serving worker to a training job's update
    broadcast (``serving.weight_stream.WeightSubscriber``; reference
    ``hypha_tpu/messages.py:1052-1084``). ``results`` is the broadcast's
    Receive reference: the shard peers plus, under a broadcast tree, the
    relay heads (``follow_for``). The broadcast carries per-round updates,
    not weights, so rounds apply in order from ``round + 1`` (the round
    the dispatched weights embody), each only once whole; ``ps_generation``
    travels beside it. ``fragments`` is the wires a round needs (0: from
    each wire's fragment tag). ``pin_round`` holds serving at that round
    (later rounds stage, fold and defer; the previous round is restored
    from the ``keep_previous`` snapshot)."""

    results: Any = None  # Receive
    round: int = 0
    ps_generation: int = 0
    fragments: int = 0
    pin_round: int | None = None
    keep_previous: bool = False


@_register
@dataclass(slots=True)
class InferExecutorConfig:
    """Serving job: load a model, answer GenerateRequest RPCs. Fields,
    order and defaults are the JAX package's (documented there); the
    additive ones default to None and are omitted from the wire when
    unset. ``serve_follow_rounds`` is a :class:`WeightFollow`."""

    model: dict
    serve_name: str
    max_new_tokens: int = 256
    max_batch: int = 8
    temperature: float = 0.0
    top_k: int | None = None
    batch_window_ms: float = 4.0
    scheduling: str = "auto"
    pool_slots: int = 0
    pool_max_len: int = 0
    pool_chunk: int = 8
    pool_block_size: int = 0
    pool_blocks: int = 0
    pool_prefill_chunk: int = 0
    pool_prefix_cache: bool = False
    pool_spec_ngram: int = 0
    pool_spec_draft: int = 0
    pool_ragged: bool = False
    pool_kv_quant: str = ""
    pool_spec_layers: int = 0
    queue_limit: int = 0
    eos_token_id: int | None = None
    load_report_s: float = 1.0
    report_metrics_s: float | None = None
    metrics_peer: str | None = None
    serve_follow_rounds: WeightFollow | None = None
    pool_fleet_cache: bool | None = None
    pool_kv_migration: bool | None = None
    fleet_digest_k: int | None = None


@_register
@dataclass(slots=True)
class GenerateRequest:
    """One serving RPC: token-id prompts in, continuations out."""

    serve_name: str
    prompts: list  # list[list[int]]
    max_new_tokens: int = 64
    temperature: float | None = None  # None = server default
    top_k: int | None = None
    seed: int = 0
    traceparent: str | None = None
    pull_peer: str | None = None
    pull_serve: str | None = None


@_register
@dataclass(slots=True)
class GenerateResponse:
    """``ok=False`` is backpressure: retry after ``retry_after_ms``."""

    tokens: list  # list[list[int]], one continuation per prompt
    ok: bool = True
    retry_after_ms: float = 0.0
    weight_round: int | None = None
    weight_generation: int | None = None


@_register
@dataclass(slots=True)
class ServeLoad:
    """Serving worker -> request router heartbeat (``PROTOCOL_SERVE``): the
    pool's admission headroom on the router's liveness signal. The first
    one tells the router the backend is ready. ``cache_digest`` is the
    fleet cache's top-K ``[chain_hash, hits]`` list (``None`` with it off);
    the weight stamps are the (round, generation) a following backend
    serves, unset and off the wire until its first swap."""

    job_id: str = ""
    serve_name: str = ""
    queue_depth: int = 0
    free_blocks: int = 0
    live_requests: int = 0
    requests: int = 0  # served since job start
    rejections: int = 0  # backpressure rejections since job start
    weight_round: int | None = None
    weight_generation: int | None = None
    cache_digest: list | None = None


@_register
@dataclass(slots=True)
class ServeLoadAck:
    """The router's answer to a heartbeat; with KV migration on it names
    the least-loaded other backend in ``migrate_*``, the target a worker
    ships a preempted request to (``None`` otherwise, off the wire)."""

    ok: bool = True
    migrate_peer: str | None = None
    migrate_serve: str | None = None


@_register
@dataclass(slots=True)
class BlockPull:
    """Fleet prefix cache: puller -> holder (``PROTOCOL_BLOCKS``).
    ``chain_hashes`` is the prompt's root-first chain; the holder serves
    its longest cached prefix. The stamp is the puller's serving weights:
    a holder on other weights refuses."""

    serve_name: str = ""
    chain_hashes: list | None = None  # list[int], root first
    weight_round: int | None = None
    weight_generation: int | None = None


@_register
@dataclass(slots=True)
class BlockChain:
    """Fleet prefix cache: holder -> puller. ``leaves`` maps each pool
    leaf's tree path to ``[raw bytes, dtype, shape]`` (``ops.kvcache.
    leaves_to_wire``), ``block_size`` rows per hash of ``hashes``."""

    ok: bool = True
    chain_hash: int | None = None  # deepest served hash (= hashes[-1])
    hashes: list | None = None  # list[int], root first
    block_size: int | None = None
    leaves: dict | None = None
    weight_round: int | None = None
    weight_generation: int | None = None
    error: str | None = None  # ok=False: "stale-generation" | "not-cached" | ...


@_register
@dataclass(slots=True)
class MigrateRequest:
    """KV migration: preempting worker -> the router-named target. The
    full blocks (``BlockChain``'s ``leaves`` encoding), their chain
    hashes, the prompt, the tokens emitted so far and the remaining
    budget; the target injects the blocks and admits ``prompt + emitted``
    as a prefix hit."""

    serve_name: str = ""
    prompt: list | None = None
    emitted: list | None = None
    budget: int | None = None
    chain_hashes: list | None = None
    block_size: int | None = None
    leaves: dict | None = None
    weight_round: int | None = None
    weight_generation: int | None = None


@_register
@dataclass(slots=True)
class MigrateAck:
    """KV migration: target -> source. ``tokens`` is the continuation;
    ``ok=False`` sends the source down its recompute-resume path."""

    ok: bool = True
    tokens: list | None = None
    error: str | None = None
    retry_after_ms: float | None = None


@_register
@dataclass(slots=True)
class Executor:
    """Tagged union Train|Aggregate|Infer."""

    kind: str
    name: str
    train: TrainExecutorConfig | None = None
    aggregate: AggregateExecutorConfig | None = None
    infer: InferExecutorConfig | None = None

    def __post_init__(self) -> None:
        if self.kind not in ("train", "aggregate", "infer"):
            raise ValueError(f"unknown executor kind {self.kind!r}")
        if self.kind == "train" and self.train is None:
            raise ValueError("train executor needs train config")
        if self.kind == "aggregate" and self.aggregate is None:
            raise ValueError("aggregate executor needs aggregate config")
        if self.kind == "infer" and self.infer is None:
            raise ValueError("infer executor needs infer config")


@_register
@dataclass(slots=True)
class JobSpec:
    job_id: str
    executor: Executor


@_register
@dataclass(slots=True)
class DataRecord:
    """The registry record a data node announces under a dataset's name."""

    num_slices: int


@_register
@dataclass(slots=True)
class DataSlice:
    """The pull-stream resource header of one slice."""

    dataset: str
    index: int


@_register
@dataclass(slots=True)
class PriceRange:
    bid: float
    max: float


@_register
@dataclass(slots=True)
class WorkerOffer:
    """Worker -> scheduler auction counter-offer; ``expires_in`` is relative
    seconds (the backing temporary lease's remaining validity)."""

    request_id: str
    lease_id: str
    peer_id: str
    resources: Resources
    price: float
    expires_in: float
    executors: list = field(default_factory=list)  # list[ExecutorDescriptor]


@_register
@dataclass(slots=True)
class RenewLease:
    """Scheduler -> worker lease renewal; the first renewal accepts an offer."""

    lease_id: str


@_register
@dataclass(slots=True)
class RenewLeaseResponse:
    lease_id: str
    timeout: float  # seconds of validity granted


@_register
@dataclass(slots=True)
class JobStatus:
    """Worker -> scheduler job lifecycle event."""

    job_id: str
    state: str  # "dispatched" | "running" | "completed" | "failed" | "cancelled"
    message: str = ""


@_register
@dataclass(slots=True)
class DispatchJob:
    lease_id: str
    spec: JobSpec


@_register
@dataclass(slots=True)
class DispatchJobResponse:
    accepted: bool
    message: str = ""


@_register
@dataclass(slots=True)
class CancelJob:
    """Scheduler -> worker: roll back a dispatched job."""

    lease_id: str
    job_id: str


@_register
@dataclass(slots=True)
class DataRequest:
    """Worker -> scheduler: assign me the next slice."""

    dataset: str
    peer_id: str = ""
    prefetch: int | None = None


@_register
@dataclass(slots=True)
class DataResponse:
    data_provider: str
    index: int
    epoch: int | None = None


@_register
@dataclass(slots=True)
class Ack:
    ok: bool = True
    message: str = ""


@_register
@dataclass(slots=True)
class HealthRequest:
    pass


@_register
@dataclass(slots=True)
class HealthResponse:
    healthy: bool


@_register
@dataclass(slots=True)
class SchedulerHello:
    """Restarted scheduler -> worker: generation ``generation`` adopted your
    execution of ``job_id`` at round ``round``."""

    generation: int = 0
    job_id: str = ""
    round: int = 0


@_register
@dataclass(slots=True)
class AdoptAck:
    """Worker -> restarted scheduler: the execution's actual state
    (``running`` | ``gone`` | ``stale``)."""

    job_id: str = ""
    round: int = 0
    epoch: int = 0
    state: str = "running"
    generation: int = 0
    ok: bool = True


@_register
@dataclass(slots=True)
class RequestWorker:
    """Priced task ad, gossiped on ``TOPIC_WORKER``."""

    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    spec: WorkerSpec | None = None
    timeout: float = 0.2  # offer window seconds
    bid: float = 0.0
    reply_to: str = ""  # scheduler peer id to send WorkerOffer to


@_enum
class ProgressKind(enum.Enum):
    STATUS = "status"
    METRICS = "metrics"
    UPDATE = "update"
    UPDATED = "updated"
    UPDATE_RECEIVED = "update-received"


@_register
@dataclass(slots=True)
class Progress:
    kind: ProgressKind
    job_id: str = ""
    batch_size: int = 0
    round: int = 0
    metrics: dict = field(default_factory=dict)
    shard: int = 0
    scheduler_generation: int | None = None
    traceparent: str | None = None


@_enum
class ProgressResponseKind(enum.Enum):
    OK = "ok"
    CONTINUE = "continue"
    SCHEDULE_UPDATE = "schedule-update"
    DONE = "done"
    ERROR = "error"


@_register
@dataclass(slots=True, frozen=True)
class ProgressResponse:
    kind: ProgressResponseKind
    counter: int = 0  # inner steps left before the update (SCHEDULE_UPDATE)
    message: str = ""
    traceparent: str | None = None
    generation: int | None = None
    round: int | None = None
