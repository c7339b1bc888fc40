"""Models: GPT (``build_gpt_lm``) and BERT pretraining
(``build_bert_pretrain``), Program-IR models with their configs."""

from .bert import BertConfig, build_bert_pretrain, synthetic_batch
from .gpt import GPTConfig, build_gpt_lm, synthetic_lm_batch

__all__ = ["BertConfig", "build_bert_pretrain", "synthetic_batch",
           "GPTConfig", "build_gpt_lm", "synthetic_lm_batch"]
