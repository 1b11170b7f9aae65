"""The job-spec and progress messages the trainer needs (a copy of the
subset of ``hypha_tpu/messages.py`` that ``run_training`` reads).

Field names, defaults, enum values and the tagged JSON form
(``to_json_dict`` / ``from_json_dict``: ``{"_t": class name, ...}`` for a
dataclass, ``{"_e": enum name, "v": value}`` for an enum, ``{"_d": ...}``
escaping a user dict with those keys, optional ``None`` fields omitted)
are the JAX package's, so a job spec or a progress message reads the same
in both packages. The CBOR wire codec and the network messages are not
ported (ROADMAP.md, Queue 1); the Job Bridge needs only the progress
protocol's name, which it hands to its node with each ``Progress``.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, ClassVar

__all__ = [
    "Adam", "Executor", "Fetch", "JobSpec", "Loss", "LRScheduler", "LRSchedulerKind",
    "ModelType", "Nesterov", "Progress", "ProgressKind", "ProgressResponse",
    "ProgressResponseKind", "Receive", "Reference", "Send", "ShardMap",
    "TrainExecutorConfig", "TransferStrategy", "from_json_dict", "to_json_dict",
    "PROTOCOL_PROGRESS",
]

# The scheduler's progress protocol (STATUS, UPDATE, ... -> ProgressResponse).
PROTOCOL_PROGRESS = "/hypha-progress/0.0.1"

_REGISTRY: dict[str, type] = {}
_ENUMS: dict[str, type] = {}


def _register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def _enum(cls):
    _ENUMS[cls.__name__] = cls
    return cls


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
    def from_peers(cls, peers: list, resource: str,
                   strategy: TransferStrategy = TransferStrategy.ALL) -> "Reference":
        return cls(peers=list(peers), strategy=strategy, resource=resource)


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
    """Sharded parameter service placement (carried so that a spec naming
    one decodes; the port's trainer refuses it)."""

    round: int = 0
    shards: list = field(default_factory=list)
    tags: list = field(default_factory=list)
    fragments: int = 1
    groups: list = field(default_factory=list)
    tree_depth: int | None = None
    serve_leaves: list | None = None


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
class Executor:
    """The executor of a job; the port runs ``kind="train"`` only."""

    kind: str
    name: str
    train: TrainExecutorConfig | None = None

    def __post_init__(self) -> None:
        if self.kind != "train":
            raise NotImplementedError(
                f"executor kind {self.kind!r} is not ported (the port runs train jobs)"
            )
        if self.train is None:
            raise ValueError("train executor needs train config")


@_register
@dataclass(slots=True)
class JobSpec:
    job_id: str
    executor: Executor


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
