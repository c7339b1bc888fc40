"""The parameter server's tensor ops and the var-lifecycle ops, the
port's counterpart of ``paddle_tpu/ops/dist_compute.py`` (reference
operators/distributed_ops/split_ids_op.cc, merge_ids_op.cc,
split_byref_op.cc, ref_by_trainer_id_op.cc, split_selected_rows_op.cc,
distributed_lookup_table_op.cc, lookup_sparse_table_op.cc,
fake_init_op.cc, delete_var_op.cc, coalesce_tensor_op.cc).

The RPC legs of the parameter server (send, recv, listen_and_serv) run
outside the Program, in ``ps/`` on the host; these ops are the parts
that compute on tensors. The JAX package lowers them in XLA's
static-shape form, and the port copies that form rather than the
reference's compaction (ROADMAP §C lists each deviation):

* ``split_ids`` keeps every shard output at the input's length, with
  -1 in the slots another shard owns; ``merge_ids`` sums its X inputs
  (each position is owned by one shard, the others hold zero rows).
* ``split_selected_rows`` gives each shard every row, rebased into the
  shard's index space, with -1 and zero values where another shard
  owns the row.
* ``fake_init`` makes zeros of the declared shape (the reference
  declares the var without a value); ``delete_var`` lowers to nothing
  (a run's lifetimes already free values; ``Scope.erase`` deletes).
* ``coalesce_tensor``'s fused buffer is the concatenation of the
  flattened inputs and its outputs are copies of its slices (the
  reference's outputs alias the buffer).
* ``ref_by_trainer_id`` clamps the trainer id into range, as JAX's
  ``dynamic_index_in_dim`` does.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows


def _sections(total: int, n: int, given) -> list:
    """Row counts of ``n`` contiguous sections: ``given``, or an equal
    split with the remainder on the last (no row may be dropped)."""
    sections = [int(s) for s in given]
    if sections:
        return sections
    base = total // n
    return [base] * (n - 1) + [total - base * (n - 1)]


@register_op("split_ids", inputs=("Ids",), outputs=("Out",),
             stop_gradient=True)
def _split_ids(ctx, op, ins):
    """Route ids to N shards by id % N; every output keeps the input's
    length, -1 where another shard owns the slot."""
    ids = ins["Ids"][0].reshape(-1)
    n = len(op.outputs.get("Out", [])) or 1
    neg = torch.full_like(ids, -1)
    return {"Out": [torch.where(ids % n == k, ids, neg) for k in range(n)]}


@register_op("merge_ids", inputs=("Ids", "Rows", "X"), outputs=("Out",),
             no_grad=("Ids", "Rows"))
def _merge_ids(ctx, op, ins):
    """The inverse of ``split_ids`` and a lookup a shard: the sum of
    the X inputs (full length, zero rows where a shard does not own a
    position)."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("split_byref", inputs=("X",), outputs=("Out",))
def _split_byref(ctx, op, ins):
    """Contiguous row sections of X (``sections``, or an equal split,
    remainder to the last)."""
    x = ins["X"][0]
    n = len(op.outputs.get("Out", [])) or 1
    outs, start = [], 0
    for rows in _sections(x.shape[0], n, op.attrs.get("sections", [])):
        outs.append(x[start:start + rows])
        start += rows
    return {"Out": outs}


@register_op("ref_by_trainer_id", inputs=("X", "TrainerId"),
             outputs=("Out",), no_grad=("TrainerId",))
def _ref_by_trainer_id(ctx, op, ins):
    """X[trainer_id], the id clamped into [0, len(X) - 1]."""
    xs = ins["X"]
    tid = ins["TrainerId"][0].reshape(()).long().clamp(0, len(xs) - 1)
    return {"Out": [torch.stack(list(xs), 0)[tid]]}


@register_op("split_selected_rows", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _split_selected_rows(ctx, op, ins):
    """Split a SelectedRows by height sections; each shard keeps every
    row slot, rows outside its section as -1 with zero values."""
    x = ins["X"][0]
    if not isinstance(x, SelectedRows):
        raise TypeError("split_selected_rows needs a SelectedRows input")
    n = len(op.outputs.get("Out", [])) or 1
    outs, start = [], 0
    for h in _sections(x.height, n, op.attrs.get("height_sections", [])):
        owned = (x.rows >= start) & (x.rows < start + h)
        local = torch.where(owned, x.rows - start, torch.full_like(x.rows, -1))
        keep = owned.reshape((-1,) + (1,) * (x.values.dim() - 1))
        vals = torch.where(keep, x.values, torch.zeros_like(x.values))
        outs.append(SelectedRows(local, vals, h))
        start += h
    return {"Out": outs}


@register_op("distributed_lookup_table", inputs=("W", "Ids"),
             outputs=("Outputs",), no_grad=("Ids",))
def _distributed_lookup_table(ctx, op, ins):
    """A lookup an Ids input over the (prefetched) table; a trailing
    ids dim of 1 is replaced by the embedding dim."""
    w = ins["W"][0]
    outs = []
    for ids in ins["Ids"]:
        shape = tuple(ids.shape)
        flat = w[ids.reshape(-1).long()]
        lead = shape[:-1] if shape and shape[-1] == 1 else shape
        outs.append(flat.reshape(lead + (w.shape[-1],)))
    return {"Outputs": outs}


@register_op("lookup_sparse_table", inputs=("W", "Ids"), outputs=("Out",),
             no_grad=("Ids",))
def _lookup_sparse_table(ctx, op, ins):
    """The dense form of the auto-grown table: a gather of the
    flattened ids."""
    return {"Out": [ins["W"][0][ins["Ids"][0].reshape(-1).long()]]}


@register_op("fake_init", inputs=(), outputs=("Out",), stop_gradient=True)
def _fake_init(ctx, op, ins):
    shape = [int(s) for s in op.attrs.get("shape", [1])]
    return {"Out": [torch.zeros(shape, dtype=torch.float32,
                                device=ctx.device)]}


@register_op("delete_var", inputs=("X",), outputs=(), stop_gradient=True)
def _delete_var(ctx, op, ins):
    return {}


@register_op("coalesce_tensor", inputs=("Input",),
             outputs=("Output", "FusedOutput"))
def _coalesce_tensor(ctx, op, ins):
    """One flat buffer of the inputs (filled with ``constant`` under
    ``set_constant``) and each input's slice of it in its shape."""
    xs = ins["Input"]
    fused = torch.cat([x.reshape(-1) for x in xs]) if len(xs) > 1 \
        else xs[0].reshape(-1)
    if bool(op.attrs.get("set_constant", False)):
        fused = torch.full_like(fused, float(op.attrs.get("constant", 0.0)))
    outs, off = [], 0
    for x in xs:
        outs.append(fused[off:off + x.numel()].reshape(x.shape).clone())
        off += x.numel()
    return {"Output": outs, "FusedOutput": [fused]}
