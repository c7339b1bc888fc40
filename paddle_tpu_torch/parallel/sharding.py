"""ZeRO-style sharded optimizer state: the port's counterpart of
``paddle_tpu/parallel/sharding.py``.

``shard_optimizer_states`` annotates the accumulators (ZeRO-1) and
optionally the parameters with a spec over the ``dp`` axis, on the
dim JAX picks (dim 0 when the data-parallel degree divides it, else
the first dim it divides). Accumulators are found structurally, by the
``is_accumulator`` / ``accumulator_owner`` tags
``Optimizer._add_accumulator`` stamps.

Where GSPMD derives the reduce-scatter, sharded update and all-gather
from such specs in the JAX package, the port's step does them itself
(``runtime.dist_step``): a rank keeps its ``1/dp`` chunk of each
sharded accumulator in the scope, reduce-scatters the gradient, updates
its chunk and all-gathers the parameter.

The scope's layout of sharded values (which chunk of which var this
rank holds, and whether it writes it to a checkpoint) is recorded here
(``set_layout`` / ``layout``) for ``io.save_checkpoint``.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["shard_optimizer_states", "Shard", "set_layout", "layout"]


def _shardable_dim(shape, dp_size: int):
    """First dim divisible by dp_size (dim 0 preferred). None for
    scalars and for nothing divisible."""
    for d, extent in enumerate(shape):
        if extent and extent % dp_size == 0 and extent >= dp_size:
            return d
    return None


def shard_optimizer_states(program, dp_size: int, axis: str = "dp",
                           shard_params: bool = False):
    """Annotate accumulators (ZeRO-1) and, with ``shard_params``,
    parameters with a spec over ``axis``: dim 0 when divisible, else the
    first divisible dim. Scalar accumulators stay replicated. Returns
    (n_sharded, skipped): skipped names the non-scalar accumulators no
    dim of which ``dp_size`` divides."""
    from ..core.framework import Parameter

    gb = program.global_block()
    n_sharded, skipped = 0, []
    for name, var in gb.vars.items():
        if not getattr(var, "persistable", False) or not var.shape:
            continue
        is_accum = getattr(var, "is_accumulator", False)
        is_param = isinstance(var, Parameter)
        if not (is_accum or (shard_params and is_param)):
            continue
        if var.sharding is not None:
            continue  # an explicit spec is respected
        if max(var.shape) <= 1:
            continue
        d = _shardable_dim(var.shape, dp_size)
        if d is None:
            skipped.append(name)
            continue
        var.sharding = ((None,) * d + (axis,)
                        + (None,) * (len(var.shape) - d - 1))
        n_sharded += 1
    return n_sharded, skipped


class Shard(NamedTuple):
    """One var held as a chunk: ``dim`` split in ``parts``, this rank
    holding chunk ``index`` of a value of ``shape``; ``writer``: this
    rank writes the chunk to a checkpoint (one rank a chunk).

    ``groups`` > 1 cuts ``dim`` as ``groups`` equal runs, each split in
    ``parts``: the rank holds chunk ``index`` of every run, side by
    side. A fused projection whose output is split into ``groups``
    tensors (the ``[q | k | v]`` columns of a ``3h`` linear) is cut so,
    and each rank then owns ``[q_r | k_r | v_r]``, which the split of
    its local output gives back as its own q, k and v."""
    dim: int
    parts: int
    index: int
    shape: Tuple[int, ...]
    writer: bool
    groups: int = 1

    def pieces(self) -> List[Tuple[int, int]]:
        """The [lo, hi) ranges of ``dim`` this rank holds, in order."""
        run = self.shape[self.dim] // self.groups
        n = run // self.parts
        return [(g * run + self.index * n, g * run + (self.index + 1) * n)
                for g in range(self.groups)]

    def bounds(self) -> Tuple[int, int]:
        if self.groups != 1:
            raise ValueError("an interleaved chunk has several ranges: "
                             "use pieces()")
        return self.pieces()[0]

    def take(self, full):
        """This rank's chunk of the whole value ``full`` (a copy)."""
        parts = [full.narrow(self.dim, lo, hi - lo)
                 for lo, hi in self.pieces()]
        if len(parts) == 1:
            return parts[0].contiguous().clone()
        return torch.cat(parts, dim=self.dim).contiguous()


_LAYOUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def set_layout(scope, shards: Dict[str, Shard]) -> None:
    """Record that ``scope`` holds these vars as chunks."""
    cur = _LAYOUTS.get(scope)
    if cur is None:
        cur = _LAYOUTS[scope] = {}
    cur.update(shards)


def layout(scope) -> Dict[str, Shard]:
    """{name: Shard} of the vars ``scope`` holds as chunks."""
    return dict(_LAYOUTS.get(scope, {}))


def clear_layout(scope, names: Optional[list] = None) -> None:
    cur = _LAYOUTS.get(scope)
    if cur is None:
        return
    for n in (list(cur) if names is None else names):
        cur.pop(n, None)
