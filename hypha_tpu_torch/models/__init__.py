"""Model families of the port (counterpart of ``hypha_tpu/models``): the
Llama lineage and Mixtral."""

from .llama import Llama, LlamaConfig
from .mixtral import Mixtral, MixtralConfig
from .registry import build_model

__all__ = ["Llama", "LlamaConfig", "Mixtral", "MixtralConfig", "build_model"]
