"""Models: GPT (``build_gpt_lm``), BERT pretraining
(``build_bert_pretrain``) and ResNet-50 (``build_resnet50``), Program-IR
models with their configs and synthetic data."""

from .bert import BertConfig, build_bert_pretrain, synthetic_batch
from .gpt import GPTConfig, build_gpt_lm, synthetic_lm_batch
from .resnet import build_resnet50, synthetic_image_batch

__all__ = ["BertConfig", "build_bert_pretrain", "synthetic_batch",
           "GPTConfig", "build_gpt_lm", "synthetic_lm_batch",
           "build_resnet50", "synthetic_image_batch"]
