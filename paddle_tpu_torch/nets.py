"""Composite networks: the port's copy of
``paddle_tpu/nets.py`` ``scaled_dot_product_attention`` (Fluid's
python/paddle/fluid/nets.py), multi-head attention from program-level
ops."""

from __future__ import annotations

import numpy as np

from . import layers

__all__ = ["scaled_dot_product_attention"]


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
