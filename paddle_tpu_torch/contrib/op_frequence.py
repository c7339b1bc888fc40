"""Op frequency statistics: the port's copy of
``paddle_tpu/contrib/op_frequence.py`` (reference
python/paddle/fluid/contrib/op_frequence.py:23 op_freq_statistic)."""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["op_freq_statistic"]


def op_freq_statistic(program):
    """Count single ops and length-2 op chains in a program (reference
    op_frequence.py). Returns (uni_op_freq, adj_2_op_freq) ordered by
    descending frequency."""
    uni = {}
    adj = {}
    prev = None
    for block in program.blocks:
        for op in block.ops:
            uni[op.type] = uni.get(op.type, 0) + 1
            if prev is not None:
                key = f"{prev}->{op.type}"
                adj[key] = adj.get(key, 0) + 1
            prev = op.type
    order = lambda d: OrderedDict(
        sorted(d.items(), key=lambda kv: -kv[1]))
    return order(uni), order(adj)
