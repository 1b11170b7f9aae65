"""Model families of the port (counterpart of ``hypha_tpu/models``): the
Llama lineage."""

from .llama import Llama, LlamaConfig
from .registry import build_model

__all__ = ["Llama", "LlamaConfig", "build_model"]
