"""Contrib layers, the port's counterpart of
``paddle_tpu/contrib/layers/nn.py`` (reference
python/paddle/fluid/contrib/layers/nn.py: the 11 layer functions). Each
emits its registered op with the JAX package's Program (ops, attrs,
vars); signatures mirror the reference.
"""

from __future__ import annotations


from ...layer_helper import LayerHelper
from ...layers.nn import _out
from ...initializer import XavierInitializer

__all__ = [
    "fused_elemwise_activation", "var_conv_2d", "match_matrix_tensor",
    "sequence_topk_avg_pooling", "tree_conv", "fused_embedding_seq_pool",
    "multiclass_nms2", "search_pyramid_hash", "shuffle_batch",
    "partial_concat", "partial_sum",
]


def fused_elemwise_activation(x, y, functor_list, axis=-1, scale=0.0,
                              save_intermediate_out=True):
    """Reference contrib/layers/nn.py:39 — fused binary+unary op pair
    (e.g. ["elementwise_add", "relu"])."""
    helper = LayerHelper("fused_elemwise_activation")
    out = _out(helper, x, shape=x.shape)
    inter = _out(helper, x, shape=x.shape, stop_gradient=True)
    helper.append_op(
        type="fused_elemwise_activation",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out], "IntermediateOut": [inter]},
        attrs={"functor_list": list(functor_list), "axis": axis,
               "scale": scale,
               "save_intermediate_out": save_intermediate_out},
    )
    return out


def var_conv_2d(input, row, col, input_channel, output_channel, filter_size,
                stride=1, param_attr=None, act=None, dtype="float32",
                name=None):
    """Reference contrib/layers/nn.py:103 — match-pyramid conv over
    per-pair grids; dense form masks by ROW/COLUMN valid extents."""
    helper = LayerHelper("var_conv_2d", param_attr=param_attr, act=act,
                         name=name)
    fs = filter_size if isinstance(filter_size, (list, tuple)) else (
        filter_size, filter_size)
    st = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    w = helper.create_parameter(
        helper.param_attr,
        [output_channel, input_channel * fs[0] * fs[1]], dtype,
        default_initializer=XavierInitializer())
    B, _, H, W = input.shape
    oh = (H + 2 * (fs[0] // 2) - fs[0]) // st[0] + 1
    ow = (W + 2 * (fs[1] // 2) - fs[1]) // st[1] + 1
    out = _out(helper, input, shape=(B, output_channel, oh, ow))
    col_mat = _out(helper, input, shape=(0,), stop_gradient=True)
    helper.append_op(
        type="var_conv_2d",
        inputs={"X": [input], "ROW": [row], "COLUMN": [col], "W": [w]},
        outputs={"Out": [out], "Col": [col_mat]},
        attrs={"InputChannel": input_channel,
               "OutputChannel": output_channel,
               "KernelH": fs[0], "KernelW": fs[1],
               "StrideH": st[0], "StrideW": st[1]},
    )
    return helper.append_activation(out)


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None):
    """Reference contrib/layers/nn.py:219 — bilinear match grid
    out[b,t,i,j] = x[b,i] . W[:,t,:] . y[b,j]."""
    helper = LayerHelper("match_matrix_tensor", param_attr=param_attr,
                         act=act, name=name)
    dx, dy = x.shape[-1], y.shape[-1]
    w = helper.create_parameter(
        helper.param_attr, [dx, channel_num, dy], dtype,
        default_initializer=XavierInitializer())
    B, Tx = x.shape[0], x.shape[1]
    Ty = y.shape[1]
    out = _out(helper, x, shape=(B, channel_num, Tx, Ty))
    tmp = _out(helper, x, shape=(B, channel_num, Tx, dy))
    helper.append_op(
        type="match_matrix_tensor",
        inputs={"X": [x], "Y": [y], "W": [w]},
        outputs={"Out": [out], "Tmp": [tmp]},
        attrs={"dim_t": channel_num},
    )
    return helper.append_activation(out), tmp


def sequence_topk_avg_pooling(input, row, col, topks, channel_num):
    """Reference contrib/layers/nn.py:302 — per-channel top-k average
    pooling; dense form: input [B, C, T] scored rows, `row` carries
    the valid lengths (col kept for signature parity)."""
    helper = LayerHelper("sequence_topk_avg_pooling")
    B, C = input.shape[0], input.shape[1]
    out = _out(helper, input, shape=(B, C * len(topks)))
    helper.append_op(
        type="sequence_topk_avg_pooling",
        inputs={"X": [input], "Length": [row]},
        outputs={"Out": [out]},
        attrs={"topks": list(topks), "channel_num": channel_num},
    )
    return out


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """Reference contrib/layers/nn.py:370 — TBCNN tree convolution.
    The op computes the raw message passing (act='identity'); bias and
    activation are applied here like the reference layer."""
    helper = LayerHelper("tree_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    D = nodes_vector.shape[-1]
    F = output_size * num_filters
    w = helper.create_parameter(
        helper.param_attr, [D, F, 3], nodes_vector.dtype,
        default_initializer=XavierInitializer())
    B, N = nodes_vector.shape[0], nodes_vector.shape[1]
    pre = _out(helper, nodes_vector, shape=(B, N, F))
    helper.append_op(
        type="tree_conv",
        inputs={"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                "Filter": [w]},
        outputs={"Out": [pre]},
        attrs={"max_depth": max_depth, "act": "identity"},
    )
    out = helper.append_bias_op(pre)
    out = helper.append_activation(out)
    from ...layers.nn import reshape

    return reshape(out, [B, N, output_size, num_filters])


def fused_embedding_seq_pool(input, size, is_sparse=False, padding_idx=None,
                             combiner="sum", param_attr=None,
                             dtype="float32"):
    """Reference contrib/layers/nn.py:435 — embedding lookup + sequence
    pool in one op."""
    helper = LayerHelper("fused_embedding_seq_pool", param_attr=param_attr)
    w = helper.create_parameter(
        helper.param_attr, list(size), dtype,
        default_initializer=XavierInitializer())
    B = input.shape[0]
    out = _out(helper, input, shape=(B, size[1]), dtype=dtype)
    helper.append_op(
        type="fused_embedding_seq_pool",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"combiner": combiner, "is_sparse": is_sparse,
               "padding_idx": -1 if padding_idx is None else padding_idx},
    )
    return out


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold=0.3, normalized=True, nms_eta=1.0,
                    background_label=0, return_index=False, name=None):
    """Reference contrib/layers/nn.py:501 — multiclass NMS returning
    the selected-box index handle."""
    helper = LayerHelper("multiclass_nms2", name=name)
    B = bboxes.shape[0] if len(bboxes.shape) == 3 else 1
    M, C = bboxes.shape[-2], scores.shape[-2]
    K = M * C if keep_top_k <= 0 else min(keep_top_k, M * C)
    out = _out(helper, bboxes, shape=(B, K, 6))
    index = _out(helper, bboxes, shape=(B, K), dtype="int32",
                 stop_gradient=True)
    nms_num = _out(helper, bboxes, shape=(B,), dtype="int32",
                   stop_gradient=True)
    helper.append_op(
        type="multiclass_nms2",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out], "Index": [index], "NmsRoisNum": [nms_num]},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "normalized": normalized, "nms_eta": nms_eta,
               "background_label": background_label},
    )
    if return_index:
        return out, index
    return out


def search_pyramid_hash(input, num_emb, space_len, pyramid_layer, rand_len,
                        drop_out_percent, is_training, use_filter,
                        white_list_len, black_list_len, seed, lr,
                        param_attr=None, param_attr_wl=None,
                        param_attr_bl=None, name=None,
                        distribute_update_vars=None, dtype="float32"):
    """Reference contrib/layers/nn.py:631 — pyramid-hashed n-gram
    embedding (the op hashes every n-gram into `space_len` buckets)."""
    helper = LayerHelper("search_pyramid_hash", param_attr=param_attr,
                         name=name)
    w = helper.create_parameter(
        helper.param_attr, [space_len, num_emb], dtype,
        default_initializer=XavierInitializer())
    B = input.shape[0]
    out = _out(helper, input, shape=(B, num_emb), dtype=dtype)
    drop_pos = _out(helper, input, shape=(0,), stop_gradient=True)
    x_temp = _out(helper, input, shape=(0,), stop_gradient=True)
    helper.append_op(
        type="pyramid_hash",
        inputs={"X": [input], "W": [w]},
        outputs={"Out": [out], "DropPos": [drop_pos],
                 "X_Temp_Out": [x_temp]},
        attrs={"num_emb": num_emb, "space_len": space_len,
               "pyramid_layer": pyramid_layer, "rand_len": rand_len,
               "drop_out_percent": drop_out_percent,
               "is_training": is_training, "use_filter": use_filter,
               "white_list_len": white_list_len,
               "black_list_len": black_list_len, "seed": seed, "lr": lr},
    )
    return out


def shuffle_batch(x, seed=None):
    """Reference contrib/layers/nn.py:747 — shuffle rows across the
    batch (the negative-sampling trick for pairwise ranking)."""
    helper = LayerHelper("shuffle_batch")
    out = _out(helper, x, shape=x.shape)
    shuffle_idx = _out(helper, x, shape=(x.shape[0],), dtype="int32",
                       stop_gradient=True)
    seed_out = _out(helper, x, shape=(1,), dtype="int64",
                    stop_gradient=True)
    helper.append_op(
        type="shuffle_batch",
        inputs={"X": [x]},
        outputs={"Out": [out], "ShuffleIdx": [shuffle_idx],
                 "SeedOut": [seed_out]},
        attrs={"startup_seed": int(seed) if seed is not None else 0},
    )
    return out


def partial_concat(input, start_index=0, length=-1):
    """Reference contrib/layers/nn.py:811 — concat a column slice of
    every input."""
    if not isinstance(input, (list, tuple)):
        input = [input]
    helper = LayerHelper("partial_concat")
    width = input[0].shape[1]
    start = start_index if start_index >= 0 else width + start_index
    n = length if length > 0 else width - start
    out = _out(helper, input[0], shape=(input[0].shape[0], n * len(input)))
    helper.append_op(
        type="partial_concat",
        inputs={"X": list(input)},
        outputs={"Out": [out]},
        attrs={"start_index": start_index, "length": length},
    )
    return out


def partial_sum(input, start_index=0, length=-1):
    """Reference contrib/layers/nn.py:873 — sum a column slice across
    the inputs."""
    if not isinstance(input, (list, tuple)):
        input = [input]
    helper = LayerHelper("partial_sum")
    width = input[0].shape[1]
    start = start_index if start_index >= 0 else width + start_index
    n = length if length > 0 else width - start
    out = _out(helper, input[0], shape=(input[0].shape[0], n))
    helper.append_op(
        type="partial_sum",
        inputs={"X": list(input)},
        outputs={"Out": [out]},
        attrs={"start_index": start_index, "length": length},
    )
    return out
