"""Dygraph nn classes: the port's copy of ``paddle_tpu/dygraph/nn.py``
(reference python/paddle/fluid/dygraph/nn.py), all 19 classes. Each
forward traces the same ops as JAX's (``base._trace``), so they run
the port's lowerings: ``LayerNorm`` K1 (forward) and K3 (backward) on
the card, the convolutions, pools and batch norm cuDNN.

``BatchNorm`` writes its running statistics back in train mode (a new
tensor each, so the step's saved tensors keep their versions) and
normalises with them in eval mode (``is_test``)."""

from __future__ import annotations

import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer
from .base import VarBase, _trace
from .layers import Layer


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__()
        self.weight = self.create_parameter([input_dim, output_dim], param_attr, dtype)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([output_dim], bias_attr, dtype, is_bias=True)
        self._act = act

    def forward(self, x):
        (out,) = _trace(
            "mul", {"X": [x], "Y": [self.weight]}, ["Out"],
            {"x_num_col_dims": len(x.shape) - 1, "y_num_col_dims": 1},
        )
        if self.bias is not None:
            (out,) = _trace(
                "elementwise_add", {"X": [out], "Y": [self.bias]}, ["Out"],
                {"axis": len(out.shape) - 1},
            )
        if self._act:
            (out,) = _trace(self._act, {"X": [out]}, ["Out"], {})
        return out


# reference dygraph/nn.py FC alias
FC = Linear


class Conv2D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1, padding=0,
                 dilation=1, groups=1, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__()
        fs = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
        std = (2.0 / (fs[0] * fs[1] * num_channels)) ** 0.5
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, fs[0], fs[1]], param_attr, dtype,
            default_initializer=NormalInitializer(0.0, std),
        )
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([num_filters], bias_attr, dtype, is_bias=True)
        self._attrs = {
            "strides": [stride] * 2 if isinstance(stride, int) else list(stride),
            "paddings": [padding] * 2 if isinstance(padding, int) else list(padding),
            "dilations": [dilation] * 2 if isinstance(dilation, int) else list(dilation),
            "groups": groups,
        }
        self._act = act

    def forward(self, x):
        ins = {"Input": [x], "Filter": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        (out,) = _trace("conv2d", ins, ["Output"], dict(self._attrs))
        if self._act:
            (out,) = _trace(self._act, {"X": [out]}, ["Out"], {})
        return out


class Pool2D(Layer):
    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
                 global_pooling=False, ceil_mode=False, exclusive=True):
        super().__init__()
        self._attrs = {
            "pooling_type": pool_type,
            "ksize": [pool_size] * 2 if isinstance(pool_size, int) else list(pool_size),
            "strides": [pool_stride] * 2 if isinstance(pool_stride, int) else list(pool_stride),
            "paddings": [pool_padding] * 2 if isinstance(pool_padding, int) else list(pool_padding),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        }

    def forward(self, x):
        (out,) = _trace("pool2d", {"X": [x]}, ["Out"], dict(self._attrs))
        return out


class BatchNorm(Layer):
    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", use_global_stats=False):
        super().__init__()
        self.weight = self.create_parameter(
            [num_channels], param_attr, dtype,
            default_initializer=ConstantInitializer(1.0),
        )
        self.bias = self.create_parameter([num_channels], bias_attr, dtype, is_bias=True)
        self._mean = VarBase(np.zeros(num_channels, dtype), persistable=True,
                             stop_gradient=True)
        self._variance = VarBase(np.ones(num_channels, dtype), persistable=True,
                                 stop_gradient=True)
        self._buffers["_mean"] = self._mean
        self._buffers["_variance"] = self._variance
        self._attrs = {
            "momentum": momentum,
            "epsilon": epsilon,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        }
        self._act = act

    def forward(self, x):
        attrs = dict(self._attrs)
        attrs["is_test"] = not self.training
        outs = _trace(
            "batch_norm",
            {
                "X": [x], "Scale": [self.weight], "Bias": [self.bias],
                "Mean": [self._mean], "Variance": [self._variance],
            },
            ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
            attrs,
        )
        y, mean_out, var_out = outs[0], outs[1], outs[2]
        self._mean.set_value(mean_out)
        self._variance.set_value(var_out)
        if self._act:
            (y,) = _trace(self._act, {"X": [y]}, ["Out"], {})
        return y


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, padding_idx=None, param_attr=None,
                 dtype="float32"):
        super().__init__()
        self.weight = self.create_parameter(list(size), param_attr, dtype)
        self._padding_idx = -1 if padding_idx is None else padding_idx

    def forward(self, ids):
        (out,) = _trace(
            "lookup_table_v2", {"W": [self.weight], "Ids": [ids]}, ["Out"],
            {"padding_idx": self._padding_idx},
        )
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True, epsilon=1e-5,
                 param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self.weight = self.create_parameter(
            [n], param_attr, dtype, default_initializer=ConstantInitializer(1.0)
        ) if scale else None
        self.bias = self.create_parameter([n], bias_attr, dtype, is_bias=True) if shift else None
        self._epsilon = epsilon
        self._act = act
        self._norm_ndim = len(normalized_shape)

    def forward(self, x):
        ins = {"X": [x]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        outs = _trace(
            "layer_norm", ins, ["Y", "Mean", "Variance"],
            {"begin_norm_axis": len(x.shape) - self._norm_ndim, "epsilon": self._epsilon},
        )
        y = outs[0]
        if self._act:
            (y,) = _trace(self._act, {"X": [y]}, ["Out"], {})
        return y


class Dropout(Layer):
    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer"):
        super().__init__()
        self._p = p
        self._impl = dropout_implementation

    def forward(self, x):
        outs = _trace(
            "dropout", {"X": [x]}, ["Out", "Mask"],
            {"dropout_prob": self._p, "is_test": not self.training,
             "dropout_implementation": self._impl},
        )
        return outs[0]


def _pair(v, n=2):
    return [v] * n if isinstance(v, int) else list(v)


class Conv2DTranspose(Layer):
    """Reference dygraph/nn.py:2128."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        fs = _pair(filter_size)
        self.weight = self.create_parameter(
            [num_channels, num_filters // groups, fs[0], fs[1]], param_attr,
            dtype)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([num_filters], bias_attr, dtype,
                                              is_bias=True)
        self._attrs = {"strides": _pair(stride), "paddings": _pair(padding),
                       "dilations": _pair(dilation), "groups": groups}
        self._act = act

    def forward(self, x):
        ins = {"Input": [x], "Filter": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        (out,) = _trace("conv2d_transpose", ins, ["Output"], dict(self._attrs))
        if self._act:
            (out,) = _trace(self._act, {"X": [out]}, ["Out"], {})
        return out


class Conv3D(Layer):
    """Reference dygraph/nn.py:272."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        fs = _pair(filter_size, 3)
        std = (2.0 / (fs[0] * fs[1] * fs[2] * num_channels)) ** 0.5
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, fs[0], fs[1], fs[2]],
            param_attr, dtype,
            default_initializer=NormalInitializer(0.0, std))
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([num_filters], bias_attr, dtype,
                                              is_bias=True)
        self._attrs = {"strides": _pair(stride, 3),
                       "paddings": _pair(padding, 3),
                       "dilations": _pair(dilation, 3), "groups": groups}
        self._act = act

    def forward(self, x):
        ins = {"Input": [x], "Filter": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        (out,) = _trace("conv3d", ins, ["Output"], dict(self._attrs))
        if self._act:
            (out,) = _trace(self._act, {"X": [out]}, ["Out"], {})
        return out


class Conv3DTranspose(Layer):
    """Reference dygraph/nn.py:474."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        if groups != 1:
            # same stance as the 2D lowering (ops/nn.py): running
            # ungrouped would silently compute full connectivity
            raise NotImplementedError(
                "conv3d_transpose with groups != 1 is not lowered yet")
        fs = _pair(filter_size, 3)
        self.weight = self.create_parameter(
            [num_channels, num_filters, fs[0], fs[1], fs[2]],
            param_attr, dtype)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([num_filters], bias_attr, dtype,
                                              is_bias=True)
        self._attrs = {"strides": _pair(stride, 3),
                       "paddings": _pair(padding, 3),
                       "dilations": _pair(dilation, 3)}
        self._act = act

    def forward(self, x):
        ins = {"Input": [x], "Filter": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        (out,) = _trace("conv3d_transpose", ins, ["Output"], dict(self._attrs))
        if self._act:
            (out,) = _trace(self._act, {"X": [out]}, ["Out"], {})
        return out


class GRUUnit(Layer):
    """Reference dygraph/nn.py:1505 (single-step GRU cell)."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 dtype="float32"):
        super().__init__()
        # size = 3 * hidden
        self._hidden = size // 3
        self._acts = {"activation": activation,
                      "gate_activation": gate_activation}
        self.weight = self.create_parameter(
            [self._hidden, size], param_attr, dtype)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([size], bias_attr, dtype,
                                              is_bias=True)

    def forward(self, input, hidden):
        ins = {"Input": [input], "HiddenPrev": [hidden],
               "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        outs = _trace("gru_unit", ins,
                      ["Gate", "ResetHiddenPrev", "Hidden"],
                      dict(self._acts))
        return outs[2], outs[1], outs[0]  # hidden, reset_hidden_prev, gate


class PRelu(Layer):
    """Reference dygraph/nn.py:1917."""

    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__()
        self._mode = mode
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [channel or 1]
        else:  # element: one alpha per feature cell, batch-free
            # (reference PRelu uses [1] + input_shape[1:])
            shape = [1] + list(input_shape or [1, 1])[1:]
        self.weight = self.create_parameter(
            shape, param_attr, dtype,
            default_initializer=ConstantInitializer(0.25))

    def forward(self, x):
        (out,) = _trace("prelu", {"X": [x], "Alpha": [self.weight]},
                        ["Out"], {"mode": self._mode})
        return out


class BilinearTensorProduct(Layer):
    """Reference dygraph/nn.py:2020."""

    def __init__(self, input1_dim, input2_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        self.weight = self.create_parameter(
            [output_dim, input1_dim, input2_dim], param_attr, dtype)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([1, output_dim], bias_attr,
                                              dtype, is_bias=True)
        self._act = act

    def forward(self, x, y):
        ins = {"X": [x], "Y": [y], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        (out,) = _trace("bilinear_tensor_product", ins, ["Out"], {})
        if self._act:
            (out,) = _trace(self._act, {"X": [out]}, ["Out"], {})
        return out


class SequenceConv(Layer):
    """Reference dygraph/nn.py:2356 (context-window conv over time)."""

    def __init__(self, name_scope=None, num_filters=1, filter_size=3,
                 context_start=None, input_dim=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        self._filter_size = filter_size
        self._context_start = (-((filter_size - 1) // 2)
                               if context_start is None else context_start)
        self.weight = self.create_parameter(
            [filter_size * input_dim, num_filters], param_attr, dtype)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([num_filters], bias_attr,
                                              dtype, is_bias=True)
        self._act = act

    def forward(self, x, length=None):
        ins = {"X": [x], "Filter": [self.weight]}
        if length is not None:
            ins["Length"] = [length]
        (out,) = _trace("sequence_conv", ins, ["Out"],
                        {"contextLength": self._filter_size,
                         "contextStart": self._context_start})
        if self.bias is not None:
            (out,) = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                            ["Out"], {"axis": len(out.shape) - 1})
        if self._act:
            (out,) = _trace(self._act, {"X": [out]}, ["Out"], {})
        return out


class RowConv(Layer):
    """Reference dygraph/nn.py:2450 (lookahead row convolution)."""

    def __init__(self, input_dim, future_context_size=2, param_attr=None,
                 act=None, dtype="float32"):
        super().__init__()
        self.weight = self.create_parameter(
            [future_context_size + 1, input_dim], param_attr, dtype)
        self._act = act

    def forward(self, x):
        (out,) = _trace("row_conv", {"X": [x], "Filter": [self.weight]},
                        ["Out"], {})
        if self._act:
            (out,) = _trace(self._act, {"X": [out]}, ["Out"], {})
        return out


class GroupNorm(Layer):
    """Reference dygraph/nn.py:2529."""

    def __init__(self, channels, groups, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        self._attrs = {"groups": groups, "epsilon": epsilon}
        self.weight = self.create_parameter(
            [channels], param_attr, dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([channels], bias_attr, dtype,
                                              is_bias=True)
        self._act = act

    def forward(self, x):
        ins = {"X": [x], "Scale": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        outs = _trace(
            "group_norm", ins,
            ["Y", "Mean", "Variance"], dict(self._attrs))
        y = outs[0]
        if self._act:
            (y,) = _trace(self._act, {"X": [y]}, ["Out"], {})
        return y


class SpectralNorm(Layer):
    """Reference dygraph/nn.py:2629."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._attrs = {"dim": dim, "power_iters": power_iters, "eps": eps}
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = VarBase(
            np.random.RandomState(0).randn(h).astype(dtype),
            persistable=True, stop_gradient=True)
        self.weight_v = VarBase(
            np.random.RandomState(1).randn(w).astype(dtype),
            persistable=True, stop_gradient=True)
        self._buffers["weight_u"] = self.weight_u
        self._buffers["weight_v"] = self.weight_v

    def forward(self, weight):
        (out,) = _trace(
            "spectral_norm",
            {"Weight": [weight], "U": [self.weight_u], "V": [self.weight_v]},
            ["Out"], dict(self._attrs))
        return out


class TreeConv(Layer):
    """Reference dygraph/nn.py:2734 (TBCNN over ops/misc tree_conv)."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=8, act="tanh", param_attr=None, bias_attr=None,
                 dtype="float32"):
        super().__init__()
        self.weight = self.create_parameter(
            [feature_size, output_size, 3], param_attr, dtype)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([output_size], bias_attr,
                                              dtype, is_bias=True)
        self._attrs = {"max_depth": max_depth}
        self._act = act

    def forward(self, nodes_vector, edge_set):
        (out,) = _trace(
            "tree_conv",
            {"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
             "Filter": [self.weight]},
            ["Out"], dict(self._attrs))
        if self.bias is not None:
            (out,) = _trace("elementwise_add", {"X": [out], "Y": [self.bias]},
                            ["Out"], {"axis": len(out.shape) - 1})
        if self._act:
            (out,) = _trace(self._act, {"X": [out]}, ["Out"], {})
        return out


class NCE(Layer):
    """Reference dygraph/nn.py:1683 (noise-contrastive estimation)."""

    def __init__(self, num_total_classes, dim, num_neg_samples=10,
                 sampler="uniform", param_attr=None, bias_attr=None,
                 dtype="float32"):
        super().__init__()
        self.weight = self.create_parameter(
            [num_total_classes, dim], param_attr, dtype)
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter([num_total_classes, 1],
                                              bias_attr, dtype, is_bias=True)
        self._attrs = {"num_total_classes": num_total_classes,
                       "num_neg_samples": num_neg_samples,
                       "sampler": 0 if sampler == "uniform" else 1}

    def forward(self, input, label, sample_weight=None):
        ins = {"Input": [input], "Label": [label], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        outs = _trace("nce", ins, ["Cost", "SampleLogits", "SampleLabels"],
                      dict(self._attrs))
        return outs[0]
