"""GPT: the configuration (a copy of the ``GPTConfig`` dataclass of
``paddle_tpu/models/gpt.py``) and ``build_gpt_lm``, which builds the
Program-IR model, with its synthetic corpus ``synthetic_lm_batch``,
copied so that the port builds the same program as the JAX package.
The torch modules that serve a GPT live in ``generation/model.py``.

The op-graph attention or (``use_flash_attention``) the fused
``flash_attention`` op; every ``moe_every``-th decoder swaps its dense
FFN for a switch-MoE layer (``layers.switch_moe``), whose load-balance
loss joins the training loss (not an ``is_test`` program's).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import layers, nets
from ..core.framework import Program, program_guard
from ..initializer import NormalInitializer
from ..kernels.flash_attention import flash_attention_layer
from ..param_attr import ParamAttr

__all__ = ["GPTConfig", "build_gpt_lm", "synthetic_lm_batch",
           "apply_gpt_megatron_sharding"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    use_flash_attention: bool = False
    # MoE: every `moe_every`-th decoder swaps its dense FFN for a
    # switch-MoE layer (0 = dense)
    moe_every: int = 0
    moe_experts: int = 8
    moe_capacity: float = 1.25
    moe_aux_coeff: float = 0.01

    @staticmethod
    def small():
        return GPTConfig()

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=1000, hidden_size=64, num_layers=2,
                         num_heads=4, ffn_size=256, max_position=128,
                         hidden_dropout=0.0, attention_dropout=0.0)

    @staticmethod
    def gpt3_1p3b():
        """GPT-3 XL shape (paper table 2.1): 24 layers, d_model 2048,
        16 heads x 128; ~1.3B params."""
        return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                         ffn_size=8192, max_position=1024)


def _attr(name, std, axes=None):
    return ParamAttr(name=name, initializer=NormalInitializer(0.0, std),
                     logical_axes=axes)


def _decoder_layer(x, cfg: GPTConfig, idx: int, is_test=False,
                   aux_losses=None):
    h = cfg.hidden_size
    std = cfg.initializer_range
    pre = f"dec{idx}"
    ln1 = layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{pre}_ln1.scale"),
        bias_attr=ParamAttr(name=f"{pre}_ln1.bias"),
    )
    qkv = layers.fc(
        ln1, 3 * h, num_flatten_dims=2,
        param_attr=_attr(f"{pre}_qkv.w", std, axes=("embed", "heads")),
        bias_attr=ParamAttr(name=f"{pre}_qkv.b",
                            logical_axes=("heads",)),
    )
    q, k, v = layers.split(qkv, 3, dim=2)
    if cfg.use_flash_attention:
        # the flash path has no attention dropout, as in the reference
        ctx = flash_attention_layer(q, k, v, cfg.num_heads, causal=True)
    else:
        ctx = nets.scaled_dot_product_attention(
            q, k, v, num_heads=cfg.num_heads, causal=True,
            dropout_rate=0.0 if is_test else cfg.attention_dropout,
        )
    proj = layers.fc(
        ctx, h, num_flatten_dims=2,
        param_attr=_attr(f"{pre}_proj.w", std, axes=("heads", "embed")),
        bias_attr=ParamAttr(name=f"{pre}_proj.b"),
    )
    if not is_test and cfg.hidden_dropout:
        proj = layers.dropout(proj, cfg.hidden_dropout,
                              dropout_implementation="upscale_in_train")
    x = layers.elementwise_add(x, proj)
    ln2 = layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{pre}_ln2.scale"),
        bias_attr=ParamAttr(name=f"{pre}_ln2.bias"),
    )
    if cfg.moe_every and (idx + 1) % cfg.moe_every == 0:
        ffn2, aux = layers.switch_moe(
            ln2, cfg.moe_experts, cfg.ffn_size,
            capacity_factor=cfg.moe_capacity,
            param_attr=ParamAttr(name=f"{pre}_moe"),
            bias_attr=ParamAttr(name=f"{pre}_moe_b"))
        if aux_losses is not None:
            aux_losses.append(aux)
    else:
        ffn1 = layers.fc(
            ln2, cfg.ffn_size, num_flatten_dims=2, act="gelu",
            param_attr=_attr(f"{pre}_ffn1.w", std,
                             axes=("embed", "mlp")),
            bias_attr=ParamAttr(name=f"{pre}_ffn1.b",
                                logical_axes=("mlp",)),
        )
        ffn2 = layers.fc(
            ffn1, h, num_flatten_dims=2,
            param_attr=_attr(f"{pre}_ffn2.w", std,
                             axes=("mlp", "embed")),
            bias_attr=ParamAttr(name=f"{pre}_ffn2.b"),
        )
    if not is_test and cfg.hidden_dropout:
        ffn2 = layers.dropout(ffn2, cfg.hidden_dropout,
                              dropout_implementation="upscale_in_train")
    return layers.elementwise_add(x, ffn2)


def build_gpt_lm(cfg: GPTConfig, seq_len: int, optimizer=None, is_test=False):
    """Next-token LM: returns (main, startup, feeds, fetches).
    tokens [B, S] int64 -> loss (shifted CE) + logits."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        tokens = layers.data("tokens", [seq_len], dtype="int64")
        labels = layers.data("labels", [seq_len], dtype="int64")
        emb = layers.embedding(
            tokens, size=[cfg.vocab_size, cfg.hidden_size],
            param_attr=_attr("gpt_tok_emb", cfg.initializer_range,
                             axes=("vocab", "embed")),
        )
        pos = layers.embedding(
            layers.assign(np.arange(seq_len, dtype="int64")[None, :]),
            size=[cfg.max_position, cfg.hidden_size],
            param_attr=_attr("gpt_pos_emb", cfg.initializer_range,
                             axes=("seq", "embed")),
        )
        x = layers.elementwise_add(emb, pos)
        aux_losses = []
        for i in range(cfg.num_layers):
            x = _decoder_layer(x, cfg, i, is_test=is_test,
                               aux_losses=aux_losses)
        x = layers.layer_norm(
            x, begin_norm_axis=2,
            param_attr=ParamAttr(name="gpt_lnf.scale"),
            bias_attr=ParamAttr(name="gpt_lnf.bias"),
        )
        logits = layers.fc(
            x, cfg.vocab_size, num_flatten_dims=2,
            param_attr=_attr("gpt_head.w", cfg.initializer_range,
                             axes=("embed", "vocab")),
            bias_attr=ParamAttr(name="gpt_head.b",
                                logical_axes=("vocab",)),
        )
        loss = layers.mean(
            layers.softmax_with_cross_entropy(
                logits, layers.unsqueeze(labels, [2])
            )
        )
        if aux_losses and not is_test:
            # the switch-MoE load-balance term (the mean over the MoE
            # layers), in training only: an eval loss stays the LM's
            total_aux = aux_losses[0]
            for a in aux_losses[1:]:
                total_aux = layers.elementwise_add(total_aux, a)
            loss = layers.elementwise_add(
                layers.reshape(loss, [1]),
                layers.scale(total_aux,
                             scale=cfg.moe_aux_coeff / len(aux_losses)))
            loss = layers.mean(loss)
        if optimizer is not None:
            optimizer.minimize(loss)
    return main, startup, {"tokens": tokens, "labels": labels}, {
        "loss": loss, "logits": logits,
    }


def apply_gpt_megatron_sharding(program: Program, mp_axis: str = "mp"):
    """Column-parallel qkv / ffn1, row-parallel proj / ffn2,
    vocabulary-parallel embedding and head (``paddle_tpu/models/gpt.py:
    198-229``): the same specs as ``models.bert.apply_megatron_sharding``.
    Suffix matches, so an accumulator (``<param>_<acc>_0``) is never
    tagged by name; accumulators inherit their parameter's spec where
    the shapes match (moments yes, the scalar beta powers no)."""
    block = program.global_block()
    for name, v in block.vars.items():
        if v.sharding is not None or not getattr(v, "persistable", False):
            continue
        if name.endswith("_qkv.w") or name.endswith("_ffn1.w"):
            v.sharding = (None, mp_axis)
        elif name.endswith("_qkv.b") or name.endswith("_ffn1.b"):
            v.sharding = (mp_axis,)
        elif name.endswith("_proj.w") or name.endswith("_ffn2.w"):
            v.sharding = (mp_axis, None)
        elif name in ("gpt_tok_emb", "gpt_head.w"):
            v.sharding = ((None, mp_axis) if name == "gpt_head.w"
                          else (mp_axis, None))
    for name, v in block.vars.items():
        owner = getattr(v, "accumulator_owner", None)
        if owner and owner in block.vars:
            base = block.vars[owner]
            if base.sharding is not None and v.shape == base.shape:
                v.sharding = base.sharding
    program._bump()


def synthetic_lm_batch(rng: np.random.RandomState, batch: int, seq_len: int,
                       vocab: int):
    """Learnable synthetic corpus: next token = (3*cur + 7) % vocab with
    occasional noise."""
    toks = rng.randint(0, vocab, (batch, seq_len)).astype("int64")
    for t in range(1, seq_len):
        toks[:, t] = (3 * toks[:, t - 1] + 7) % vocab
    labels = np.concatenate(
        [toks[:, 1:], ((3 * toks[:, -1:] + 7) % vocab)], axis=1
    ).astype("int64")
    return {"tokens": toks, "labels": labels}
