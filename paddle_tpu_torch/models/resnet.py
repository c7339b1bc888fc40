"""ResNet-50: the port's copy of ``paddle_tpu/models/resnet.py``
(``_conv_bn``, ``_bottleneck``, ``build_resnet50``), building the same
Program-IR model with the same parameter names (``{name}.conv.w``,
``{name}.bn.{scale,bias,mean,var}``, ``head.w``, ``head.b``), so
``io.load_scope_arrays`` carries the JAX package's parameters across
unchanged, and ``synthetic_image_batch``, the JAX bench's data.

``data_format="NCHW"`` is the reference's layout and the one the card
runs (cuDNN); ``"NHWC"`` builds the JAX package's TPU-layout variant
(one transpose of the NCHW image feed), which the port runs too.
"""

from __future__ import annotations

import numpy as np

from .. import layers
from ..core.framework import Program, program_guard
from ..param_attr import ParamAttr

__all__ = ["build_resnet50", "synthetic_image_batch"]


def _conv_bn(x, num_filters, filter_size, stride=1, act="relu", name="",
             fmt="NCHW", groups=1):
    """conv (no bias) + batch_norm, layout-aware."""
    conv = layers.conv2d(
        x, num_filters, filter_size, stride=stride,
        padding=(filter_size - 1) // 2, bias_attr=False, groups=groups,
        param_attr=ParamAttr(name=f"{name}.conv.w"),
        data_format=fmt,
    )
    return layers.batch_norm(
        conv, act=act,
        param_attr=ParamAttr(name=f"{name}.bn.scale"),
        bias_attr=ParamAttr(name=f"{name}.bn.bias"),
        moving_mean_name=f"{name}.bn.mean",
        moving_variance_name=f"{name}.bn.var",
        data_layout=fmt,
    )


def _bottleneck(x, num_filters, stride, name, fmt="NCHW"):
    ch_axis = 1 if fmt == "NCHW" else 3
    conv0 = _conv_bn(x, num_filters, 1, act="relu", name=f"{name}.b0",
                     fmt=fmt)
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride, act="relu",
                     name=f"{name}.b1", fmt=fmt)
    conv2 = _conv_bn(conv1, num_filters * 4, 1, act=None, name=f"{name}.b2",
                     fmt=fmt)
    if stride != 1 or x.shape[ch_axis] != num_filters * 4:
        short = _conv_bn(x, num_filters * 4, 1, stride=stride, act=None,
                         name=f"{name}.sc", fmt=fmt)
    else:
        short = x
    return layers.relu(layers.elementwise_add(short, conv2))


def build_resnet50(num_classes=1000, image_size=224, optimizer=None,
                   data_format="NCHW"):
    """(main, startup, feeds, fetches): image [N, 3, S, S] float32 and
    label [N, 1] int64 in; loss (mean softmax cross-entropy) and acc
    (top-1 accuracy) out; ``optimizer.minimize(loss)`` when given."""
    fmt = data_format
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", [3, image_size, image_size])
        label = layers.data("label", [1], dtype="int64")
        x = img
        if fmt == "NHWC":
            x = layers.transpose(x, [0, 2, 3, 1])
        x = _conv_bn(x, 64, 7, stride=2, name="stem", fmt=fmt)
        x = layers.pool2d(x, 3, "max", pool_stride=2, pool_padding=1,
                          data_format=fmt)
        depth = [3, 4, 6, 3]
        filters = [64, 128, 256, 512]
        for stage, (d, f) in enumerate(zip(depth, filters)):
            for blk in range(d):
                stride = 2 if blk == 0 and stage > 0 else 1
                x = _bottleneck(x, f, stride, name=f"s{stage}b{blk}",
                                fmt=fmt)
        pool = layers.pool2d(x, 7, "avg", global_pooling=True,
                             data_format=fmt)
        logits = layers.fc(pool, num_classes, param_attr=ParamAttr(name="head.w"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        if optimizer is not None:
            optimizer.minimize(loss)
    return main, startup, {"image": img, "label": label}, {"loss": loss, "acc": acc}


def synthetic_image_batch(rng: np.random.RandomState, batch: int,
                          image_size: int = 224, num_classes: int = 1000):
    """The JAX bench's ResNet data (``bench.py:202-204`` with
    ``RandomState(0)``): standard-normal NCHW images and uniform labels."""
    return {"image": rng.randn(batch, 3, image_size,
                               image_size).astype("float32"),
            "label": rng.randint(0, num_classes, (batch, 1)).astype("int64")}
