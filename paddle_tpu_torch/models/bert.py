"""BERT pretraining: the configuration (a copy of the ``BertConfig``
dataclass of ``paddle_tpu/models/bert.py``), ``build_bert_pretrain``,
which builds the Program-IR encoder with the masked LM loss, and its
synthetic batch ``synthetic_batch``, copied so that the port builds the
same program as the JAX package (``bert.py:32-229``).

Attention is the fused ``flash_attention`` op with the [B, S] key mask
(``use_flash_attention``) or the op-graph
``nets.scaled_dot_product_attention`` with ``padding_mask``.
``apply_megatron_sharding`` stamps the JAX package's Megatron specs
(``bert.py:187-212``), which ``CompiledProgram.with_partitioning`` over
a mesh with that axis runs tensor-parallel (``runtime/tp_plan.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .. import layers, nets
from ..core.framework import Program, program_guard
from ..initializer import NormalInitializer
from ..kernels.flash_attention import flash_attention_layer
from ..param_attr import ParamAttr

__all__ = ["BertConfig", "build_bert_pretrain", "synthetic_batch",
           "apply_megatron_sharding"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    use_flash_attention: bool = False

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def large():
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16, ffn_size=4096)

    @staticmethod
    def tiny():
        return BertConfig(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            ffn_size=128, max_position=128,
        )


def _attr(name, std):
    return ParamAttr(name=name, initializer=NormalInitializer(0.0, std))


def _encoder_layer(x, cfg: BertConfig, idx: int, is_test=False,
                   input_mask=None):
    h = cfg.hidden_size
    std = cfg.initializer_range
    pre = f"enc{idx}"
    # self-attention: fused QKV projection (column-parallel under mp)
    qkv = layers.fc(
        x, 3 * h, num_flatten_dims=2,
        param_attr=_attr(f"{pre}_qkv.w", std), bias_attr=ParamAttr(name=f"{pre}_qkv.b"),
    )
    q, k, v = layers.split(qkv, 3, dim=2)
    if cfg.use_flash_attention:
        ctx = flash_attention_layer(q, k, v, cfg.num_heads,
                                    mask_var=input_mask)
    else:
        ctx = nets.scaled_dot_product_attention(
            q, k, v, num_heads=cfg.num_heads,
            dropout_rate=0.0 if is_test else cfg.attention_dropout,
            padding_mask=input_mask,
        )
    proj = layers.fc(
        ctx, h, num_flatten_dims=2,
        param_attr=_attr(f"{pre}_proj.w", std), bias_attr=ParamAttr(name=f"{pre}_proj.b"),
    )
    if not is_test and cfg.hidden_dropout:
        proj = layers.dropout(proj, cfg.hidden_dropout,
                              dropout_implementation="upscale_in_train")
    x = layers.layer_norm(
        layers.elementwise_add(x, proj), begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{pre}_ln1.scale"),
        bias_attr=ParamAttr(name=f"{pre}_ln1.bias"),
    )
    # FFN (column- then row-parallel under mp)
    ffn1 = layers.fc(
        x, cfg.ffn_size, num_flatten_dims=2, act="gelu",
        param_attr=_attr(f"{pre}_ffn1.w", std), bias_attr=ParamAttr(name=f"{pre}_ffn1.b"),
    )
    ffn2 = layers.fc(
        ffn1, h, num_flatten_dims=2,
        param_attr=_attr(f"{pre}_ffn2.w", std), bias_attr=ParamAttr(name=f"{pre}_ffn2.b"),
    )
    if not is_test and cfg.hidden_dropout:
        ffn2 = layers.dropout(ffn2, cfg.hidden_dropout,
                              dropout_implementation="upscale_in_train")
    x = layers.layer_norm(
        layers.elementwise_add(x, ffn2), begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{pre}_ln2.scale"),
        bias_attr=ParamAttr(name=f"{pre}_ln2.bias"),
    )
    return x


def build_bert_pretrain(
    cfg: BertConfig,
    seq_len: int,
    optimizer: Optional[object] = None,
    is_test: bool = False,
    dtype: str = "float32",
):
    """Returns (main_program, startup_program, feeds dict, fetch dict).

    Feeds: src_ids [B,S] int64, pos_ids [B,S] int64, labels [B,S] int64,
    input_mask [B,S] float32 (1 = real token, 0 = padding — the
    reference's BiasQK padding-mask capability,
    fused/multihead_matmul_op.cu:441, expressed as the cheap [B,S]
    key-mask form).
    Loss: full-softmax LM cross-entropy, masked mean over real tokens.
    """
    main, startup = Program(), Program()
    std = cfg.initializer_range
    with program_guard(main, startup):
        src = layers.data("src_ids", [seq_len], dtype="int64")
        pos = layers.data("pos_ids", [seq_len], dtype="int64")
        labels = layers.data("labels", [seq_len], dtype="int64")
        input_mask = layers.data("input_mask", [seq_len], dtype="float32")
        word_emb = layers.embedding(
            src, [cfg.vocab_size, cfg.hidden_size],
            param_attr=_attr("word_embedding", std),
        )
        pos_emb = layers.embedding(
            pos, [cfg.max_position, cfg.hidden_size],
            param_attr=_attr("pos_embedding", std),
        )
        x = layers.elementwise_add(word_emb, pos_emb)
        x = layers.layer_norm(
            x, begin_norm_axis=2,
            param_attr=ParamAttr(name="emb_ln.scale"),
            bias_attr=ParamAttr(name="emb_ln.bias"),
        )
        if not is_test and cfg.hidden_dropout:
            x = layers.dropout(x, cfg.hidden_dropout,
                               dropout_implementation="upscale_in_train")
        # per-layer outputs double as PipelineOptimizer cut points
        # (reference PipelineOptimizer cuts its program at user-chosen
        # vars, optimizer.py:3414); every boundary is the same
        # [B, S, H] activation, which the SPMD pipeline requires
        encoder_outputs = []
        for i in range(cfg.num_layers):
            x = _encoder_layer(x, cfg, i, is_test, input_mask=input_mask)
            encoder_outputs.append(x)
        logits = layers.fc(
            x, cfg.vocab_size, num_flatten_dims=2,
            param_attr=_attr("lm_head.w", std), bias_attr=ParamAttr(name="lm_head.b"),
        )
        lbl = layers.unsqueeze(labels, [2])
        ce = layers.softmax_with_cross_entropy(logits, lbl)  # [B, S, 1]
        ce = layers.elementwise_mul(layers.squeeze(ce, [2]), input_mask)
        # masked mean over real tokens only
        loss = layers.elementwise_div(
            layers.reduce_sum(ce), layers.reduce_sum(input_mask))
        if optimizer is not None and not is_test:
            optimizer.minimize(loss)
    return main, startup, {"src_ids": src, "pos_ids": pos,
                           "labels": labels, "input_mask": input_mask}, {
        "loss": loss, "logits": logits,
        "encoder_outputs": encoder_outputs,
    }


def apply_megatron_sharding(program: Program, mp_axis: str = "mp",
                            dp_axis: str = "dp"):
    """Annotate params with specs: column-parallel QKV / FFN-in (the
    output dim split), row-parallel proj / FFN-out (the input dim
    split), vocabulary-parallel embedding and LM head; the optimizer
    accumulators inherit their parameter's spec where the shapes
    match."""
    gb = program.global_block()
    for name, var in gb.vars.items():
        if not getattr(var, "persistable", False) or var.shape is None:
            continue
        if name.endswith("_qkv.w") or name.endswith("_ffn1.w"):
            var.sharding = (None, mp_axis)
        elif name.endswith("_qkv.b") or name.endswith("_ffn1.b"):
            var.sharding = (mp_axis,)
        elif name.endswith("_proj.w") or name.endswith("_ffn2.w"):
            var.sharding = (mp_axis, None)
        elif name in ("word_embedding", "lm_head.w"):
            var.sharding = ((mp_axis, None) if name == "word_embedding"
                            else (None, mp_axis))
    for name, var in gb.vars.items():
        owner = getattr(var, "accumulator_owner", None)
        if owner and owner in gb.vars:
            base = gb.vars[owner]
            if base.sharding is not None and var.shape == base.shape:
                var.sharding = base.sharding
    return program


def synthetic_batch(rng: np.random.RandomState, batch: int, seq_len: int,
                    vocab: int, min_len: Optional[int] = None):
    """min_len=None: full-length rows (throughput benchmarking).
    min_len=k: per-row lengths uniform in [k, seq_len] — a realistic
    padded batch exercising the attention mask."""
    src = rng.randint(0, vocab, (batch, seq_len)).astype("int64")
    pos = np.tile(np.arange(seq_len, dtype="int64"), (batch, 1))
    labels = np.roll(src, -1, axis=1)
    if min_len is None:
        mask = np.ones((batch, seq_len), "float32")
    else:
        lengths = rng.randint(min_len, seq_len + 1, batch)
        mask = (np.arange(seq_len)[None, :] < lengths[:, None]).astype("float32")
    return {"src_ids": src, "pos_ids": pos, "labels": labels,
            "input_mask": mask}
