"""Generation: the ragged continuous-batching engine over a paged KV
cache (counterpart of ``paddle_tpu.generation``, ragged mode)."""

from .engine import GenerationEngine, GenerationMetrics, GenerationStream
from .kvcache import PagedKVCache, PagePoolExhausted
from .model import (CacheGeometry, GPTConfig, GPTLM, RaggedStepModel,
                    load_jax_params)

__all__ = ["GenerationEngine", "GenerationStream", "GenerationMetrics",
           "PagedKVCache", "PagePoolExhausted", "CacheGeometry", "GPTConfig",
           "GPTLM", "RaggedStepModel", "load_jax_params"]
