"""Sequence layers over dense padded tensors: the port's copy of
``paddle_tpu/layers/sequence.py`` (reference
python/paddle/fluid/layers/sequence_lod.py, LoD-based)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _out

__all__ = [
    "sequence_pool",
    "sequence_softmax",
    "sequence_reshape",
    "sequence_concat",
    "sequence_reverse",
    "sequence_mask",
    "sequence_pad",
    "sequence_unpad",
    "sequence_expand",
]


def sequence_pool(input, pool_type, length=None, is_test=False):
    helper = LayerHelper("sequence_pool")
    shp = tuple(input.shape or ())
    out_shape = (shp[0],) + tuple(shp[2:]) if len(shp) >= 2 else shp
    out = _out(helper, input, shape=out_shape)
    max_index = _out(helper, input, shape=(0,), dtype="int32", stop_gradient=True)
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_pool",
        inputs=inputs,
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper(), "is_test": is_test},
    )
    return out


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = _out(helper, input, shape=input.shape)
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_softmax", inputs=inputs, outputs={"Out": [out]}
    )
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    shp = tuple(input.shape or ())
    out = _out(helper, input, shape=(shp[0] if shp else -1, -1, new_dim))
    helper.append_op(
        type="sequence_reshape",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"new_dim": new_dim},
    )
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = _out(helper, input[0], shape=None)
    helper.append_op(type="sequence_concat", inputs={"X": list(input)}, outputs={"Out": [out]})
    return out


def sequence_reverse(x, length=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = _out(helper, x, shape=x.shape)
    inputs = {"X": [x]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="sequence_reverse", inputs=inputs, outputs={"Y": [out]})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    shp = tuple(x.shape or ()) + (maxlen if maxlen else -1,)
    out = _out(helper, x, shape=shp, dtype=dtype, stop_gradient=True)
    helper.append_op(
        type="sequence_mask",
        inputs={"X": [x]},
        outputs={"Y": [out]},
        attrs={"maxlen": maxlen or -1, "out_dtype": dtype},
    )
    return out


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = _out(helper, x, shape=x.shape)
    ln = _out(helper, x, shape=(x.shape[0] if x.shape else -1,), dtype="int64", stop_gradient=True)
    inputs = {"X": [x], "PadValue": [pad_value]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_pad", inputs=inputs, outputs={"Out": [out], "Length": [ln]}
    )
    return out, ln


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = _out(helper, x, shape=x.shape)
    helper.append_op(
        type="sequence_unpad",
        inputs={"X": [x], "Length": [length]},
        outputs={"Out": [out]},
    )
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = _out(helper, x, shape=y.shape)
    helper.append_op(
        type="sequence_expand",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"ref_level": ref_level},
    )
    return out
