"""Contrib metric layer, the port's counterpart of
``paddle_tpu/contrib/layers/metric_op.py`` (reference
python/paddle/fluid/contrib/layers/metric_op.py:30 ctr_metric_bundle).
"""

from __future__ import annotations

from ...layer_helper import LayerHelper
from ...initializer import ConstantInitializer

__all__ = ["ctr_metric_bundle"]


def ctr_metric_bundle(input, label):
    """CTR metrics accumulator (reference metric_op.py:30): returns
    (local_sqrerr, local_abserr, local_prob, local_q, local_pos_num,
    local_ins_num) — persistable running sums the caller divides by
    instance count (all-reducing first in distributed jobs)."""
    helper = LayerHelper("ctr_metric_bundle")
    block = helper.main_program.global_block()

    from ...core.framework import unique_name

    def acc_var(tag):
        # unique per call site: two bundles in one program (e.g. two
        # output heads) must not alias their running sums
        v = block.create_var(name=unique_name.generate(f"ctr_metric_{tag}"),
                             shape=(1,), dtype="float32",
                             persistable=True, stop_gradient=True)
        sb = helper.startup_program.global_block()
        sv = sb.create_var(name=v.name, shape=(1,), dtype="float32",
                           persistable=True)
        ConstantInitializer(0.0)(sv, sb)
        return v

    local_sqrerr = acc_var("sqrerr")
    local_abserr = acc_var("abserr")
    local_prob = acc_var("prob")
    local_q = acc_var("q")
    local_pos = acc_var("pos_num")
    local_ins = acc_var("ins_num")

    from ...layers import (elementwise_sub, reduce_sum, abs as _abs,
                           sigmoid, reshape)

    diff = elementwise_sub(input, label)
    batch_sqrerr = reshape(reduce_sum(diff * diff), [1])
    batch_abserr = reshape(reduce_sum(_abs(diff)), [1])
    batch_prob = reshape(reduce_sum(input), [1])
    batch_q = reshape(reduce_sum(sigmoid(input)), [1])
    batch_pos = reshape(reduce_sum(label), [1])

    ones = input * 0.0 + 1.0
    batch_ins = reshape(reduce_sum(ones), [1])

    for acc, batch in ((local_sqrerr, batch_sqrerr),
                       (local_abserr, batch_abserr),
                       (local_prob, batch_prob), (local_q, batch_q),
                       (local_pos, batch_pos), (local_ins, batch_ins)):
        helper.append_op(
            type="elementwise_add",
            inputs={"X": [batch], "Y": [acc]},
            outputs={"Out": [acc]},
            attrs={"axis": -1},
        )
    return (local_sqrerr, local_abserr, local_prob, local_q, local_pos,
            local_ins)
