"""VGG and SE-ResNeXt: the port's copy of ``paddle_tpu/models/vision.py``,
the other two conv families the reference's book and dist tests train
(book/test_image_classification.py ``vgg16_bn_drop``;
tests/unittests/dist_se_resnext.py SE-ResNeXt-50). Both take
``data_format="NHWC"`` as ``resnet.py`` does; the feed stays NCHW with
one input transpose. Parameter names are the JAX package's, so
``io.load_scope_arrays`` carries its parameters across unchanged."""

from __future__ import annotations

from .. import layers
from ..core.framework import Program, program_guard
from ..param_attr import ParamAttr
from .resnet import _conv_bn

__all__ = ["build_vgg", "build_se_resnext"]

_VGG_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _ch(x, fmt):
    return x.shape[1] if fmt == "NCHW" else x.shape[3]


def build_vgg(num_classes=10, image_size=32, optimizer=None, depth=11,
              data_format="NCHW"):
    """VGG-{11,13,16,19} with batch norm: 3x3 conv (no bias) + batch norm
    + relu stacks with 2x2 max pools, dropout 0.5, fc 512 relu, dropout
    0.5, fc ``num_classes``. (main, startup, feeds, fetches) as
    ``build_resnet50``."""
    fmt = data_format
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", [3, image_size, image_size])
        label = layers.data("label", [1], dtype="int64")
        x = img
        if fmt == "NHWC":
            x = layers.transpose(x, [0, 2, 3, 1])
        i = 0
        for v in _VGG_CFGS[depth]:
            if v == "M":
                x = layers.pool2d(x, 2, "max", pool_stride=2,
                                  data_format=fmt)
                continue
            x = layers.conv2d(
                x, v, 3, padding=1, bias_attr=False,
                param_attr=ParamAttr(name=f"vgg.c{i}.w"), data_format=fmt)
            x = layers.batch_norm(
                x, act="relu", data_layout=fmt,
                param_attr=ParamAttr(name=f"vgg.bn{i}.s"),
                bias_attr=ParamAttr(name=f"vgg.bn{i}.b"),
                moving_mean_name=f"vgg.bn{i}.m",
                moving_variance_name=f"vgg.bn{i}.v")
            i += 1
        x = layers.dropout(x, 0.5)
        h = layers.fc(x, 512, act="relu", param_attr=ParamAttr(name="fc1.w"))
        h = layers.dropout(h, 0.5)
        logits = layers.fc(h, num_classes, param_attr=ParamAttr(name="fc2.w"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        if optimizer is not None:
            optimizer.minimize(loss)
    return main, startup, {"image": img, "label": label}, {"loss": loss,
                                                           "acc": acc}


def _squeeze_excite(x, reduction, name, fmt):
    """Global average pool, fc down by ``reduction`` (at least 4) with
    relu, fc back up with sigmoid, and the [B, C] gate multiplied into
    x as a rank-4 tensor at the layout's channel position."""
    c = _ch(x, fmt)
    pool = layers.pool2d(x, 1, "avg", global_pooling=True, data_format=fmt)
    sq = layers.fc(pool, max(c // reduction, 4), act="relu",
                   param_attr=ParamAttr(name=f"{name}.sq.w"))
    ex = layers.fc(sq, c, act="sigmoid",
                   param_attr=ParamAttr(name=f"{name}.ex.w"))
    ex4 = layers.reshape(ex, [-1, c, 1, 1] if fmt == "NCHW"
                         else [-1, 1, 1, c])
    return layers.elementwise_mul(x, ex4, axis=0)


def _sex_block(x, nf, stride, cardinality, reduction, name, fmt):
    """SE-ResNeXt bottleneck: 1x1, grouped 3x3 (``cardinality``
    groups), 1x1 to 2 * nf, squeeze-excite, then the shortcut (a
    projection when the shape changes) and relu."""
    conv0 = _conv_bn(x, nf, 1, 1, "relu", f"{name}.c0", fmt)
    conv1 = _conv_bn(conv0, nf, 3, stride, "relu", f"{name}.c1", fmt,
                     groups=cardinality)
    conv2 = _conv_bn(conv1, nf * 2, 1, 1, None, f"{name}.c2", fmt)
    scaled = _squeeze_excite(conv2, reduction, f"{name}.se", fmt)
    if stride != 1 or _ch(x, fmt) != nf * 2:
        short = _conv_bn(x, nf * 2, 1, stride, None, f"{name}.sc", fmt)
    else:
        short = x
    return layers.relu(layers.elementwise_add(short, scaled))


def build_se_resnext(num_classes=10, image_size=32, optimizer=None,
                     depth=(1, 1, 1), filters=(64, 128, 256),
                     cardinality=8, reduction=16, data_format="NCHW"):
    """SE-ResNeXt: a 3x3 stem, then ``depth[i]`` blocks of ``filters[i]``
    a stage (stride 2 at each later stage's first block; ``depth`` zips
    with ``filters``, so four stages need four filters), global average
    pool and the fc head. The default depth is the reference dist test's
    CI size; SE-ResNeXt-50 is depth (3, 4, 6, 3)."""
    fmt = data_format
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", [3, image_size, image_size])
        label = layers.data("label", [1], dtype="int64")
        x = img
        if fmt == "NHWC":
            x = layers.transpose(x, [0, 2, 3, 1])
        x = _conv_bn(x, 64, 3, 1, "relu", "stem", fmt)
        for stage, (d, f) in enumerate(zip(depth, filters)):
            for blk in range(d):
                stride = 2 if blk == 0 and stage > 0 else 1
                x = _sex_block(x, f, stride, cardinality, reduction,
                               f"s{stage}b{blk}", fmt)
        pool = layers.pool2d(x, 1, "avg", global_pooling=True,
                             data_format=fmt)
        logits = layers.fc(pool, num_classes,
                           param_attr=ParamAttr(name="head.w"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        if optimizer is not None:
            optimizer.minimize(loss)
    return main, startup, {"image": img, "label": label}, {"loss": loss,
                                                           "acc": acc}
