"""Models: GPT (``build_gpt_lm``, dense or switch-MoE), BERT
pretraining (``build_bert_pretrain``), ResNet-50 (``build_resnet50``),
VGG and SE-ResNeXt (``build_vgg``, ``build_se_resnext``), LeNet
(``build_lenet``) and the CTR models (``build_deepfm``,
``build_wide_deep``), Program-IR models with their configs and synthetic
data."""

from .bert import (BertConfig, apply_megatron_sharding, build_bert_pretrain,
                   synthetic_batch)
from .ctr import build_deepfm, build_wide_deep, synthetic_ctr_batch
from .gpt import (GPTConfig, apply_gpt_megatron_sharding, build_gpt_lm,
                  synthetic_lm_batch)
from .mnist import build_lenet, synthetic_mnist_batch
from .resnet import build_resnet50, synthetic_image_batch
from .vision import build_se_resnext, build_vgg

__all__ = ["BertConfig", "build_bert_pretrain", "synthetic_batch",
           "GPTConfig", "build_gpt_lm", "synthetic_lm_batch",
           "build_resnet50", "synthetic_image_batch", "build_deepfm",
           "build_wide_deep", "synthetic_ctr_batch", "build_vgg",
           "build_se_resnext", "build_lenet", "synthetic_mnist_batch",
           "apply_megatron_sharding", "apply_gpt_megatron_sharding"]
