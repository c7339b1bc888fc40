"""Collective layer wrappers: the port's copy of
``paddle_tpu/layers/collective.py``.

Reference: python/paddle/fluid/layers/collective.py:20-172:
``_c_allreduce`` / ``_c_broadcast`` / ``_c_allgather`` /
``_c_reducescatter`` append ``c_*`` ops with a ``ring_id`` attr, which
``ops/collective.py`` lowers: the ring resolves to a process group of
the ``torch.distributed`` world (``parallel.mesh.ring_group``), and with
no world the ops are identities.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _out

__all__ = ["_c_allreduce", "_c_broadcast", "_c_allgather", "_c_reducescatter"]


def _c_allreduce(x, out=None, reduce_type="sum", ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_allreduce_" + reduce_type)
    if out is None:
        out = _out(helper, x, shape=x.shape)
    helper.append_op(
        type="c_allreduce_" + reduce_type,
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"ring_id": ring_id, "use_calc_stream": use_calc_stream},
    )
    return out


def _c_broadcast(x, root=0, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_broadcast")
    out = _out(helper, x, shape=x.shape)
    helper.append_op(
        type="c_broadcast",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"root": root, "ring_id": ring_id, "use_calc_stream": use_calc_stream},
    )
    return out


def _c_allgather(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_allgather")
    shp = list(x.shape or ())
    if shp and shp[0] and shp[0] > 0:
        shp[0] *= nranks
    out = _out(helper, x, shape=tuple(shp))
    helper.append_op(
        type="c_allgather",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"nranks": nranks, "ring_id": ring_id, "use_calc_stream": use_calc_stream},
    )
    return out


def _c_reducescatter(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_reducescatter")
    shp = list(x.shape or ())
    if shp and shp[0] and shp[0] > 0:
        shp[0] //= nranks
    out = _out(helper, x, shape=tuple(shp))
    helper.append_op(
        type="c_reducescatter",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"nranks": nranks, "ring_id": ring_id, "use_calc_stream": use_calc_stream},
    )
    return out
