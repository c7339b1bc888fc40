"""CTR models: DeepFM and wide&deep over sparse id features, the
port's copy of ``paddle_tpu/models/ctr.py`` (Fluid's fleet CTR models:
huge sparse embedding tables and a small dense tower).

With ``is_sparse=True`` the tables' gradients are SelectedRows (the rows
a batch touched, ``core/selected_rows.py``) and the sparse updates of
``ops/optim.py`` touch only those rows: the update's cost scales with
the batch's ids, not the vocabulary.
"""

from __future__ import annotations

import numpy as np


def build_deepfm(num_fields=8, vocab_size=1000, embed_dim=8,
                 dense_dim=4, hidden=(32, 16), optimizer=None,
                 is_sparse=True):
    """DeepFM: first-order weights + FM second-order interactions +
    a deep MLP tower, all over one shared embedding table.

    Returns (main, startup, feeds, fetches): feed slots are
    ``sparse_ids`` [B, num_fields] int64, ``dense_x`` [B, dense_dim],
    ``label`` [B, 1]; fetches: loss, auc-ready prediction.
    """
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = layers.data("sparse_ids", [num_fields], dtype="int64")
        dense = layers.data("dense_x", [dense_dim])
        label = layers.data("label", [1])

        # first-order: per-id scalar weight
        w1 = layers.embedding(ids, size=[vocab_size, 1],
                              is_sparse=is_sparse,
                              param_attr=fluid.ParamAttr(name="fm_w1"))
        first_order = layers.reduce_sum(w1, dim=[1])  # [B, 1]

        # second-order: 0.5 * ((sum v)^2 - sum v^2)
        emb = layers.embedding(ids, size=[vocab_size, embed_dim],
                               is_sparse=is_sparse,
                               param_attr=fluid.ParamAttr(name="fm_v"))
        sum_v = layers.reduce_sum(emb, dim=[1])           # [B, D]
        sum_v_sq = layers.square(sum_v)
        sq_v = layers.square(emb)
        sum_sq_v = layers.reduce_sum(sq_v, dim=[1])
        second_order = layers.scale(
            layers.reduce_sum(sum_v_sq - sum_sq_v, dim=[1], keep_dim=True),
            scale=0.5)                                     # [B, 1]

        # deep tower over [flattened embeddings ++ dense]
        deep_in = layers.concat(
            [layers.reshape(emb, [-1, num_fields * embed_dim]), dense],
            axis=1)
        h = deep_in
        for width in hidden:
            h = layers.fc(h, width, act="relu")
        deep_out = layers.fc(h, 1)

        logit = first_order + second_order + deep_out
        pred = layers.sigmoid(logit)
        loss = layers.mean(
            layers.sigmoid_cross_entropy_with_logits(logit, label))
        if optimizer is not None:
            optimizer.minimize(loss)
    return main, startup, {"ids": "sparse_ids", "dense": "dense_x",
                           "label": "label"}, {"loss": loss, "pred": pred}


def build_wide_deep(num_fields=8, vocab_size=1000, embed_dim=8,
                    hidden=(32, 16), optimizer=None, is_sparse=True):
    """wide & deep: linear (wide) memorization + MLP (deep)
    generalization over the same sparse ids."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = layers.data("sparse_ids", [num_fields], dtype="int64")
        label = layers.data("label", [1])

        wide = layers.embedding(ids, size=[vocab_size, 1],
                                is_sparse=is_sparse,
                                param_attr=fluid.ParamAttr(name="wide_w"))
        wide_out = layers.reduce_sum(wide, dim=[1])

        emb = layers.embedding(ids, size=[vocab_size, embed_dim],
                               is_sparse=is_sparse,
                               param_attr=fluid.ParamAttr(name="deep_emb"))
        h = layers.reshape(emb, [-1, num_fields * embed_dim])
        for width in hidden:
            h = layers.fc(h, width, act="relu")
        deep_out = layers.fc(h, 1)

        logit = wide_out + deep_out
        pred = layers.sigmoid(logit)
        loss = layers.mean(
            layers.sigmoid_cross_entropy_with_logits(logit, label))
        if optimizer is not None:
            optimizer.minimize(loss)
    return main, startup, {"ids": "sparse_ids", "label": "label"}, {
        "loss": loss, "pred": pred}


def synthetic_ctr_batch(rng: np.random.RandomState, batch, num_fields=8,
                        vocab_size=1000, dense_dim=4):
    """Clickable synthetic data: label correlates with a few 'magic'
    ids so training visibly reduces loss."""
    ids = rng.randint(0, vocab_size, (batch, num_fields)).astype("int64")
    dense = rng.rand(batch, dense_dim).astype("float32")
    magic = (ids % 7 == 0).sum(1) + dense.sum(1)
    label = (magic > np.median(magic)).astype("float32").reshape(-1, 1)
    return {"sparse_ids": ids, "dense_x": dense, "label": label}
