"""Generation: the continuous-batching engine over a paged KV cache
(counterpart of ``paddle_tpu.generation``), in ragged mode (the
default, with speculative decoding and the radix prefix cache) and
two_lane mode."""

from .draft import DraftModel, HostDraft
from .engine import GenerationEngine, GenerationMetrics, GenerationStream
from .kvcache import PagedKVCache, PagePoolExhausted
from .model import (CacheGeometry, DecodeStepModel, GPTConfig, GPTLM,
                    PrefillStepModel, RaggedStepModel, build_lm_program,
                    load_jax_params, share_params)

__all__ = ["GenerationEngine", "GenerationStream", "GenerationMetrics",
           "PagedKVCache", "PagePoolExhausted", "CacheGeometry", "GPTConfig",
           "GPTLM", "RaggedStepModel", "PrefillStepModel", "DecodeStepModel",
           "load_jax_params", "share_params", "build_lm_program",
           "DraftModel", "HostDraft"]
