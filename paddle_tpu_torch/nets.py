"""Composite networks: the port's copy of ``paddle_tpu/nets.py``
(Fluid's python/paddle/fluid/nets.py): ``simple_img_conv_pool``,
``img_conv_group``, ``glu`` and ``scaled_dot_product_attention``."""

from __future__ import annotations

import numpy as np

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention"]


def simple_img_conv_pool(
    input,
    num_filters,
    filter_size,
    pool_size,
    pool_stride,
    pool_padding=0,
    pool_type="max",
    global_pooling=False,
    conv_stride=1,
    conv_padding=0,
    conv_dilation=1,
    conv_groups=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    use_cudnn=True,
):
    """conv2d (with its activation) then pool2d."""
    conv_out = layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=conv_stride,
        padding=conv_padding,
        dilation=conv_dilation,
        groups=conv_groups,
        param_attr=param_attr,
        bias_attr=bias_attr,
        act=act,
    )
    return layers.pool2d(
        input=conv_out,
        pool_size=pool_size,
        pool_type=pool_type,
        pool_stride=pool_stride,
        pool_padding=pool_padding,
        global_pooling=global_pooling,
    )


def img_conv_group(
    input,
    conv_num_filter,
    pool_size,
    conv_padding=1,
    conv_filter_size=3,
    conv_act=None,
    param_attr=None,
    conv_with_batchnorm=False,
    conv_batchnorm_drop_rate=0.0,
    pool_stride=1,
    pool_type="max",
    use_cudnn=True,
):
    """A run of conv2d layers (each optionally batch-normed, the
    activation after the norm, and dropped out), then one pool2d."""
    tmp = input
    if not isinstance(conv_padding, list):
        conv_padding = [conv_padding] * len(conv_num_filter)
    if not isinstance(conv_with_batchnorm, list):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, list):
        conv_batchnorm_drop_rate = [conv_batchnorm_drop_rate] * len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(
            input=tmp,
            num_filters=nf,
            filter_size=conv_filter_size,
            padding=conv_padding[i],
            param_attr=param_attr,
            act=local_act,
        )
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(
        input=tmp, pool_size=pool_size, pool_type=pool_type, pool_stride=pool_stride
    )


def glu(input, dim=-1):
    """Gated linear unit: the first half times the sigmoid of the
    second, split on ``dim``."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(
    queries, keys, values, num_heads=1, dropout_rate=0.0, causal=False,
    padding_mask=None,
):
    """Multi-head attention from program-level ops. padding_mask: [B, S]
    float (1 = real token, 0 = padding) — keys at padded positions get
    -1e9 added to their logits."""
    d_key = queries.shape[-1] // num_heads

    def _split_heads(x):
        b, t, d = x.shape
        y = layers.reshape(x, [0, 0, num_heads, d // num_heads])
        return layers.transpose(y, [0, 2, 1, 3])

    def _merge_heads(x):
        b, h, t, d = x.shape
        y = layers.transpose(x, [0, 2, 1, 3])
        return layers.reshape(y, [0, 0, h * d])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    scaled = layers.scale(q, scale=d_key**-0.5)
    logits = layers.matmul(scaled, k, transpose_y=True)
    if padding_mask is not None:
        # (1 - mask) * -1e9 broadcast over [B, H, S_q, S_k]'s key dim
        neg = layers.scale(padding_mask, scale=1e9, bias=-1e9)  # 0 / -1e9
        neg = layers.unsqueeze(neg, [1, 2])  # [B, 1, 1, S]
        logits = layers.elementwise_add(logits, neg)
    if causal:
        T = int(logits.shape[-1])
        mask = layers.assign(
            np.triu(np.full((T, T), -1e9, "float32"), k=1)[None, None]
        )
        logits = layers.elementwise_add(logits, mask)
    weights = layers.softmax(logits)
    if dropout_rate:
        weights = layers.dropout(
            weights, dropout_rate, dropout_implementation="upscale_in_train"
        )
    ctx = layers.matmul(weights, v)
    return _merge_heads(ctx)
