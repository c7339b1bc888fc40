"""Models: GPT (the config and ``build_gpt_lm``, its Program-IR model)."""

from .gpt import GPTConfig, build_gpt_lm, synthetic_lm_batch

__all__ = ["GPTConfig", "build_gpt_lm", "synthetic_lm_batch"]
