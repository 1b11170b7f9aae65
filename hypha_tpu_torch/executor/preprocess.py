"""Slice preprocessors: the five HF Auto processor kinds, run over the
configured slice keys before batching (counterpart of
``hypha_tpu/executor/preprocess.py``).

Job-spec shape (``TrainExecutorConfig.preprocessor``)::

    {"kind": Preprocessor, "source": Fetch, "inputs": ["text"],
     "options": {...forwarded to the processor call...}}

Slices are SafeTensors, so every value is a fixed-shape numeric array.
Text for the tokenizer kind rides as fixed-width uint8 UTF-8 rows (trailing
NULs stripped), decoded here and tokenized with ``padding="max_length"`` so
batch shapes stay static. The processor takes numpy (the uint8 rows, an
image array) and its numpy outputs come back as CPU torch tensors, merged
with the slice's other tensors.

``transformers`` is imported inside :func:`load_processor` only: a
processor is a host-side transform, not a kernel, and the package is needed
only by a job that names one. Without it such a job raises its
``ImportError``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..messages import Preprocessor, from_json_dict

__all__ = ["build_preprocessor", "load_processor", "make_apply"]

log = logging.getLogger("hypha.torch.executor.preprocess")

_AUTO_CLASSES = {
    Preprocessor.TOKENIZER: "AutoTokenizer",
    Preprocessor.IMAGE_PROCESSOR: "AutoImageProcessor",
    Preprocessor.FEATURE_EXTRACTOR: "AutoFeatureExtractor",
    Preprocessor.PROCESSOR: "AutoProcessor",
    Preprocessor.VIDEO_PROCESSOR: "AutoVideoProcessor",
}


def _decode_text_rows(arr: np.ndarray) -> list:
    """[N, W] uint8 UTF-8 rows (NUL-padded) -> a list of N strings."""
    if arr.dtype != np.uint8:
        raise ValueError(f"tokenizer input must be uint8 rows, got {arr.dtype}")
    rows = np.atleast_2d(arr)
    return [bytes(r).rstrip(b"\x00").decode("utf-8", errors="replace") for r in rows]


def load_processor(kind: "Preprocessor | str", path: "str | Path"):
    """The HF Auto processor for ``kind`` from a local directory or file."""
    import transformers

    kind = kind if isinstance(kind, Preprocessor) else Preprocessor(kind)
    cls = getattr(transformers, _AUTO_CLASSES[kind])
    return cls.from_pretrained(str(path), local_files_only=True)


def make_apply(processor: Any, kind: Preprocessor, inputs: list,
               options: "dict[str, Any] | None" = None) -> Callable[[dict], dict]:
    """Wrap an HF processor as the dataset's slice hook: pop the ``inputs``
    keys, run the processor on them, merge its outputs back."""
    options = dict(options or {})
    if kind is Preprocessor.TOKENIZER:
        options.setdefault("padding", "max_length")
        options.setdefault("truncation", True)
        options.setdefault("max_length", getattr(processor, "model_max_length", 128) or 128)
        if options["max_length"] > 4096:  # HF's "unset" sentinel is huge
            options["max_length"] = 128

    def apply(tensors: dict) -> dict:
        taken = {k: tensors.pop(k).numpy() for k in inputs if k in tensors}
        if not taken:
            return tensors
        if kind is Preprocessor.TOKENIZER:
            texts: list = []
            for v in taken.values():
                texts.extend(_decode_text_rows(v))
            out = processor(texts, return_tensors="np", **options)
        else:
            out = processor(*taken.values(), return_tensors="np", **options)
        processed = {k: torch.from_numpy(np.array(v)) for k, v in dict(out).items()}
        return {**processed, **tensors}

    return apply


def build_preprocessor(spec: "dict[str, Any]", session: Any,
                       work_dir: Path) -> "Callable[[dict], dict] | None":
    """Fetch the processor's files through the bridge and build the slice
    hook; None for an empty spec (the job streams its slices untouched)."""
    if not spec:
        return None
    kind = spec.get("kind", Preprocessor.TOKENIZER)
    kind = kind if isinstance(kind, Preprocessor) else Preprocessor(kind)
    inputs = list(spec.get("inputs") or [])
    if not inputs:
        raise ValueError("preprocessor spec needs 'inputs': slice keys to process")

    path = spec.get("path")
    if not path:
        source = spec.get("source")
        if source is None:
            raise ValueError("preprocessor spec needs 'source' (Fetch) or 'path'")
        fetch = from_json_dict(source) if isinstance(source, dict) else source
        rels = session.fetch(fetch)
        if not rels:
            raise ValueError("preprocessor fetch returned no artifacts")
        path = (Path(work_dir) / rels[0]).parent
    processor = load_processor(kind, path)
    log.info("preprocessor: %s from %s on keys %s", kind.value, path, inputs)
    return make_apply(processor, kind, inputs, spec.get("options"))
