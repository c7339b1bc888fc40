"""Local-shape execution of a bound step whose values are split along
one mesh axis: tensor parallelism (``tp``) and sequence parallelism
(``sp``). What GSPMD does for the JAX package from the specs alone, a
``ShardPlan`` works out once at bind time, op by op over the forward
ops of the step's ``_Plan``:

* which dim of each value is split over the axis (``dims``): the
  parameters by their specs (``runtime/dist_step.py`` holds their
  chunks in the scope), the feeds by theirs (``sp``: dim 1), and every
  other value from the op that writes it;
* for each op that meets a split value, what it runs instead (a
  ``hook``: the op with rewritten attrs, its inputs and outputs passed
  through collectives).

The rules, in Megatron's terms:

* **column-parallel** ``mul`` / ``matmul`` (the weight split on its
  output dim): the replicated input goes through ``comm.copy_to``
  (identity forward, sum backward) and the output keeps the rank's
  columns; **row-parallel** (the weight split on its input dim, the
  input split on its last dim): the partial product goes through
  ``comm.reduce_from`` (sum forward, identity backward);
* **heads**: ``reshape2``'s literal shape (``[0, 0, h, d / h]``,
  ``[0, 0, h * d]``) and the ``flash_attention`` op's ``num_heads``
  become the rank's ``h / tp``;
* **the fused QKV**: a column-parallel weight whose output is split in
  k along its last dim is held interleaved (``parallel.sharding.Shard``
  ``groups``), so the rank's local split gives its own q, k and v;
* **vocabulary-parallel** embedding: the rank's rows, ids outside them
  give zeros, then a sum over the axis (its explicit grad op scatters
  into the rank's rows only); the vocabulary-parallel head's logits are
  all-gathered over the axis before ``softmax_with_cross_entropy``
  (K4 / K5 keep whole rows): every op that cannot take a split input
  gets it gathered (``comm.gather_dim``), as GSPMD would;
* **reductions** over the split dim are summed over the axis: the
  global-norm clip's squared sums of the split gradients (the
  replicated ones are counted once, on every rank alike);
* **dropout** on a split value draws the whole-shape mask from the
  op's generator on every rank and keeps the rank's slice, so a world
  of ``tp`` (or ``sp``) ranks draws the masks of a world of one;
* a replicated value meeting a split one in an elementwise op is cut
  to the rank's slice (``comm.scatter_dim``).

Sequence parallelism splits dim 1 of the ``[B, S, ...]`` feeds: every
op runs on the rank's positions, the ``flash_attention`` op takes the
ring (``parallel/ring_attention.py``) or Ulysses
(``parallel/ulysses.py``) route, a replicated position-indexed value
(the positions constant) is cut to the rank's positions, and
reductions over the sequence are summed over the axis both ways
(``comm.all_reduce_sum``): each rank's loss is then the whole loss, and
the parameter gradients are averaged over the ranks as in data
parallelism (``DistStep``'s batch group is the world). A gathered
sequence's backward is the sum of the ranks' slices for the same
reason.

Gradients need nothing more: an automatic grad op replays its forward's
recorded graph, collectives included (their autograd forms), and a
gradient has its value's split. Only the embedding's explicit grad op
has a hook. What no rule covers raises, naming the op.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.framework import OpRole
from ..core.registry import OpDef
from ..parallel import comm

__all__ = ["ShardPlan", "interleave_groups"]

_logger = logging.getLogger("paddle_tpu_torch.tp_plan")

_BACKWARD = int(OpRole.Backward)
_OPT = int(OpRole.Optimize) | int(OpRole.LRSched)

# ops whose output has the input's shape element for element
_UNARY = {"scale", "gelu", "relu", "tanh", "sigmoid", "exp", "log", "sqrt",
          "rsqrt", "square", "abs", "cast", "assign", "leaky_relu", "pow",
          "clip", "sign", "logical_not", "softsign", "swish", "elu",
          "relu6", "hard_sigmoid", "silu", "reciprocal", "floor", "ceil",
          "round", "sin", "cos", "softplus", "erf"}
_BINARY = {"elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow"}
_REDUCE = {"reduce_sum", "reduce_mean", "mean"}
_LOOKUP = {"lookup_table", "lookup_table_v2"}


class _Proxy:
    """An op with some attrs replaced (the Program's op is never
    touched)."""

    def __init__(self, op, attrs):
        self.type = op.type
        self.inputs = op.inputs
        self.outputs = op.outputs
        self.attrs = dict(op.attrs)
        self.attrs.update(attrs)

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]


def _role(op) -> int:
    return int(op.attrs.get("op_role", 0) or 0)


def _base(name: str) -> str:
    i = name.find("@GRAD")
    return name if i < 0 else name[:i]


def interleave_groups(block, ops) -> Dict[str, int]:
    """{weight or bias name: k} for each column-parallel projection
    whose output (through its bias add) is split into k equal parts
    along its last dim: the fused QKV's ``[q | k | v]``."""
    producer: Dict[str, Any] = {}
    for op in ops:
        if _role(op) & (_BACKWARD | _OPT):
            continue
        for n in op.output_arg_names:
            producer[n] = op
    out: Dict[str, int] = {}
    for op in ops:
        if op.type != "split" or _role(op) & (_BACKWARD | _OPT):
            continue
        x = op.inputs["X"][0]
        nd = len(block.var(x).shape) if block.has_var(x) else 0
        if int(op.attrs.get("axis", 0)) % max(nd, 1) != nd - 1:
            continue
        k = int(op.attrs.get("num", 0)) or len(op.attrs.get("sections", []))
        if op.attrs.get("sections") and len(set(op.attrs["sections"])) > 1:
            continue
        if k < 2:
            continue
        names = []
        src = producer.get(x)
        if src is not None and src.type == "elementwise_add":
            names += src.inputs.get("Y", [])
            src = producer.get(src.inputs["X"][0])
        if src is not None and src.type in ("mul", "matmul",
                                            "quantized_fc",
                                            "quantized_matmul"):
            slot = "Y" if src.type in ("mul", "matmul") else "QWeight"
            names += src.inputs.get(slot, [])
            if slot == "QWeight":
                names += src.inputs.get("Scale", [])
            for n in names:
                out[n] = k
    return out


class ShardPlan:
    """See the module docstring. ``kind`` is "tp" or "sp";
    ``state_dims`` / ``feed_dims``: {name: split dim} of the split
    state and feeds; ``groups``: {name: k} of interleaved state;
    ``sp_mode``: "ring" or "ulysses" for the flash op's route."""

    def __init__(self, block, ops, mesh, axis: str, kind: str,
                 state_dims: Dict[str, int], feed_dims: Dict[str, int],
                 groups: Dict[str, int], fetch_names: Sequence[str],
                 sp_mode: str = "ring"):
        self.block = block
        self.axis = axis
        self.kind = kind
        self.n = mesh.axis_size(axis)
        self.index = mesh.coord(axis)
        self.group = mesh.group(axis)
        self.sp_mode = sp_mode
        self.dims: Dict[str, int] = dict(state_dims)
        self.dims.update(feed_dims)
        self.ilv: Dict[str, int] = {n: k for n, k in groups.items()
                                    if n in self.dims}
        self.hooks: Dict[int, Tuple[Any, OpDef]] = {}
        self.opaque: Dict[str, str] = {}
        for op in ops:
            role = _role(op)
            if role & _BACKWARD:
                if op.type.endswith("_grad") and \
                        op.type[:-len("_grad")] in _LOOKUP:
                    self._lookup_grad(op)
                continue
            self._forward(op, optimizer=bool(role & _OPT))
        self.fetch_dims = {n: self._dim(n) for n in fetch_names
                           if self._dim(n) is not None}

    # -- helpers ---------------------------------------------------------------
    def _dim(self, name) -> Optional[int]:
        if name in self.dims:
            return self.dims[name]
        b = _base(name)
        return self.dims.get(b) if b != name else None

    def _ilv(self, name) -> int:
        return self.ilv.get(name, self.ilv.get(_base(name), 1))

    def _shape(self, name) -> Tuple[int, ...]:
        if self.block.has_var(name):
            return tuple(int(d) if d is not None else -1
                         for d in (self.block.var(name).shape or ()))
        return ()

    def _nd(self, name) -> int:
        return len(self._shape(name))

    def _set(self, name, d, ilv=1):
        if d is None:
            self.dims.pop(name, None)
            self.ilv.pop(name, None)
        else:
            self.dims[name] = int(d)
            if ilv > 1:
                self.ilv[name] = int(ilv)
            else:
                self.ilv.pop(name, None)

    def _hook(self, op, lower: Callable, attrs=None):
        from ..core.registry import get_op_def

        base = get_op_def(op.type)
        proxy = _Proxy(op, attrs or {})
        hooked = OpDef(base.type, lambda ctx, _op, ins: lower(ctx, proxy,
                                                               ins, base),
                       input_slots=base.input_slots,
                       output_slots=base.output_slots,
                       no_grad_slots=base.no_grad_slots,
                       stop_gradient=base.stop_gradient,
                       auto_grad=base.auto_grad)
        self.hooks[id(op)] = (proxy, hooked)

    def _wrap(self, op, pre: Dict[Tuple[str, int], Callable] = None,
              post: Dict[Tuple[str, int], Callable] = None, attrs=None):
        """Hook ``op`` with per-input (``pre``) and per-output (``post``)
        transforms around its own lowering."""
        pre = dict(pre or {})
        post = dict(post or {})

        def lower(ctx, proxy, ins, base):
            if pre:
                ins = {s: [pre[(s, k)](v) if (s, k) in pre else v
                           for k, v in enumerate(vals)]
                       for s, vals in ins.items()}
            outs = base.lower(ctx, proxy, ins)
            if post:
                outs = {s: [post[(s, k)](v) if (s, k) in post and v is not None
                            else v for k, v in enumerate(vals)]
                        for s, vals in outs.items()}
            return outs

        self._hook(op, lower, attrs)

    # the axis's collectives in this plan's gradient convention
    def _gather_fn(self, d, ilv=1):
        g, kind = self.group, self.kind

        def fn(t):
            if kind == "tp":
                out = comm.gather_dim(t, d, g)
            else:
                out = _GatherSum.apply(t, d, g)
            return _deinterleave(out, d, self.n, ilv) if ilv > 1 else out
        return fn

    def _scatter_fn(self, d, ilv=1):
        g, n, r, kind = self.group, self.n, self.index, self.kind

        def fn(t):
            if t.shape[d] == 1:
                return t
            if ilv > 1:
                t = _interleave(t, d, n, ilv)
            if kind == "tp":
                return comm.scatter_dim(t, d, g)
            k = t.shape[d] // n
            return t.narrow(d, r * k, k)
        return fn

    def _sum_fn(self):
        g, kind = self.group, self.kind
        if kind == "tp":
            return lambda t: comm.reduce_from(t, g)
        return lambda t: comm.all_reduce_sum(t, g)

    def _gather_all(self, op, why):
        """Fallback: every split input of ``op`` gathered whole; its
        outputs replicated."""
        pre = {}
        for slot, names in op.inputs.items():
            for k, n in enumerate(names):
                d = self._dim(n)
                if d is not None:
                    pre[(slot, k)] = self._gather_fn(d, self._ilv(n))
        if pre:
            _logger.debug("%s: %s takes its split inputs whole (%s)",
                          self.axis, op.type, why)
            self._wrap(op, pre)
        for n in op.output_arg_names:
            self._set(n, None)

    def _check_opaque(self, op, name):
        if name in self.opaque:
            raise NotImplementedError(
                f"{self.axis}: op {op.type!r} reads {name!r}, {self.opaque[name]}"
                " — no rule of the sharded step covers it")

    # -- the forward rules -----------------------------------------------------
    def _forward(self, op, optimizer: bool):
        t = op.type
        split_in = [n for n in op.input_arg_names if self._dim(n) is not None]
        for n in op.input_arg_names:
            self._check_opaque(op, n)
        if not split_in:
            for n in op.output_arg_names:
                if not optimizer or n not in self.dims:
                    self._set(n, None)
            return
        if optimizer and t not in _REDUCE and t not in _UNARY \
                and t not in _BINARY and t != "sum":
            # an update op (sgd, adam, the fused ones) runs on the
            # rank's chunks: its outputs are its inputs, updated
            return
        handler = getattr(self, "_op_" + t, None)
        if handler is None:
            if t in _UNARY:
                handler = self._op_unary
            elif t in _BINARY:
                handler = self._op_binary
            elif t in _REDUCE:
                handler = self._op_reduce
            elif t in _LOOKUP:
                handler = self._op_lookup
        if handler is None:
            self._gather_all(op, "no rule")
            return
        handler(op)

    def _op_unary(self, op):
        x = op.inputs["X"][0]
        for n in op.outputs.get("Out", []):
            self._set(n, self._dim(x), self._ilv(x))

    def _op_softmax(self, op):
        x = op.inputs["X"][0]
        d = self._dim(x)
        if int(op.attrs.get("axis", -1)) % self._nd(x) == d:
            return self._gather_all(op, "softmax over the split dim")
        self._set(op.outputs["Out"][0], d, self._ilv(x))

    def _op_dropout(self, op):
        x = op.inputs["X"][0]
        d, ilv = self._dim(x), self._ilv(x)
        n, r = self.n, self.index
        p = float(op.attrs.get("dropout_prob", 0.5))
        if not (bool(op.attrs.get("is_test", False)) or p == 0.0):
            def lower(ctx, proxy, ins, base):
                xv = ins["X"][0]
                shape = list(xv.shape)
                shape[d] *= n
                keep = torch.rand(shape, generator=ctx.op_generator(proxy),
                                  device=xv.device) < (1.0 - p)
                if ilv > 1:
                    keep = _interleave(keep, d, n, ilv)
                k = xv.shape[d]
                keep = keep.narrow(d, r * k, k)
                zero = torch.zeros((), dtype=xv.dtype, device=xv.device)
                impl = proxy.attrs.get("dropout_implementation",
                                       "downgrade_in_infer")
                out = torch.where(keep, xv / (1.0 - p)
                                  if impl == "upscale_in_train" else xv, zero)
                res = {"Out": [out]}
                if ctx.wants(proxy, "Mask"):
                    res["Mask"] = [keep.to(torch.uint8)]
                return res

            self._hook(op, lower)
        for s in ("Out", "Mask"):
            for nm in op.outputs.get(s, []):
                self._set(nm, d, ilv)

    def _op_binary(self, op):
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        sx, sy = self._shape(x), self._shape(y)
        ndx, ndy = len(sx), len(sy)
        axis = int(op.attrs.get("axis", -1))
        if ndy > ndx:
            return self._gather_all(op, "Y of higher rank than X")
        off = axis if axis >= 0 else ndx - ndy
        dx, dy = self._dim(x), self._dim(y)
        ix, iy = self._ilv(x), self._ilv(y)
        out = op.outputs["Out"][0]
        if dx is not None and dy is not None:
            if dy + off != dx or ix != iy:
                return self._gather_all(op, "operands split apart")
            return self._set(out, dx, ix)
        if dx is not None:
            j = dx - off
            if 0 <= j < ndy and sy[j] != 1:
                self._wrap(op, {("Y", 0): self._scatter_fn(j, ix)})
            return self._set(out, dx, ix)
        i = dy + off
        if sx[i] != 1:
            self._wrap(op, {("X", 0): self._scatter_fn(i, iy)})
        self._set(out, i, iy)

    def _op_sum(self, op):
        names = op.inputs["X"]
        ds = {(self._dim(n), self._ilv(n)) for n in names}
        if len(ds) != 1:
            return self._gather_all(op, "addends split apart")
        d, ilv = ds.pop()
        self._set(op.outputs["Out"][0], d, ilv)

    def _op_reshape2(self, op):
        x = op.inputs["X"][0]
        d, ilv = self._dim(x), self._ilv(x)
        sx = list(self._shape(x))
        target = [int(v) for v in op.attrs.get("shape", [])]
        k = _reshape_dim(sx, d, target, self.n)
        if k is None or ilv > 1:
            return self._gather_all(op, "reshape moves the split dim")
        new = list(target)
        if new[k] > 0:
            new[k] //= self.n
        if new != target:
            self._wrap(op, attrs={"shape": new})
        self._set(op.outputs["Out"][0], k)

    def _op_transpose2(self, op):
        x = op.inputs["X"][0]
        perm = [int(p) for p in op.attrs.get("axis", [])]
        self._set(op.outputs["Out"][0], perm.index(self._dim(x)),
                  self._ilv(x))

    def _op_unsqueeze2(self, op):
        x = op.inputs["X"][0]
        nd = self._nd(x)
        axes = sorted(int(a) for a in op.attrs.get("axes", []))
        nout = nd + len(axes)
        axes = sorted(a % nout for a in axes)
        keep = [i for i in range(nout) if i not in axes]
        self._set(op.outputs["Out"][0], keep[self._dim(x)], self._ilv(x))

    def _op_squeeze2(self, op):
        x = op.inputs["X"][0]
        nd, d = self._nd(x), self._dim(x)
        axes = {int(a) % nd for a in op.attrs.get("axes", [])}
        if not axes:
            axes = {i for i, s in enumerate(self._shape(x)) if s == 1}
        if d in axes:
            return self._gather_all(op, "squeeze of the split dim")
        self._set(op.outputs["Out"][0], d - sum(1 for a in axes if a < d),
                  self._ilv(x))

    def _op_split(self, op):
        x = op.inputs["X"][0]
        d, ilv = self._dim(x), self._ilv(x)
        axis = int(op.attrs.get("axis", 0)) % self._nd(x)
        k = int(op.attrs.get("num", 0)) or len(op.attrs.get("sections", []))
        if axis != d:
            for nm in op.outputs["Out"]:
                self._set(nm, d, ilv)
            return
        secs = op.attrs.get("sections") or []
        if ilv == k and (not secs or len(set(secs)) == 1):
            if secs:
                self._wrap(op, attrs={"sections": [s // self.n
                                                   for s in secs]})
            for nm in op.outputs["Out"]:
                self._set(nm, d)
            return
        self._gather_all(op, "split along the split dim")

    def _op_layer_norm(self, op):
        x = op.inputs["X"][0]
        d = self._dim(x)
        bna = int(op.attrs.get("begin_norm_axis", 1))
        if d >= bna or any(self._dim(n) is not None
                           for s in ("Scale", "Bias")
                           for n in op.inputs.get(s, [])):
            return self._gather_all(op, "layer norm across the split dim")
        self._set(op.outputs["Y"][0], d, self._ilv(x))
        for s in ("Mean", "Variance"):
            for nm in op.outputs.get(s, []):
                self._set(nm, None)
                self.opaque[nm] = ("flattened statistics of a split layer "
                                   "norm")

    def _op_mul(self, op, ys="Y", pre=None):
        x, y = op.inputs["X"][0], op.inputs[ys][0]
        dx, dy = self._dim(x), self._dim(y)
        ndx = self._nd(x)
        xnc = int(op.attrs.get("x_num_col_dims", 1))
        ync = int(op.attrs.get("y_num_col_dims", 1))
        out = op.outputs["Out"][0]
        pre = dict(pre or {})
        if self._nd(y) != 2 or ync != 1:
            return self._gather_all(op, "weight of rank other than 2")
        if dy == 1 and dx is None:
            # column parallel
            if self.kind == "tp":
                pre[("X", 0)] = lambda t: comm.copy_to(t, self.group)
            if pre:
                self._wrap(op, pre)
            return self._set(out, xnc, self._ilv(y))
        if dy == 0 and dx == ndx - 1 and xnc == ndx - 1 \
                and self._ilv(x) == self._ilv(y):
            # row parallel
            self._wrap(op, pre, post={("Out", 0): self._sum_fn()})
            return self._set(out, None)
        if dy is None and dx is not None and dx < xnc:
            if pre:
                self._wrap(op, pre)
            return self._set(out, dx, self._ilv(x))
        self._gather_all(op, "no linear layout")

    def _op_quantized_fc(self, op):
        """The int8 / fp8 linear (K11). Column-parallel: the per-column
        scale planes are state split with the columns (interleaved as
        the weight). Row-parallel: per-column scales stay whole, and a
        block mode's scale rows are cut with the weight's rows (the
        blocks must not straddle a shard)."""
        w = op.inputs["QWeight"][0]
        sc = op.inputs.get("Scale", [])
        pre = {}
        if self._dim(w) == 0 and sc and self._dim(sc[0]) is None and \
                self._nd(sc[0]) == 2:
            rows = self._shape(sc[0])[0]
            if rows % self.n:
                raise NotImplementedError(
                    f"{self.axis}: {w!r}'s {rows} quantization blocks "
                    f"straddle its {self.n} row shards")
            k, r = rows // self.n, self.index
            pre[("Scale", 0)] = lambda t: t.narrow(0, r * k, k)
        self._op_mul(op, ys="QWeight", pre=pre)

    _op_quantized_matmul = _op_quantized_fc

    def _op_matmul(self, op):
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        dx, dy = self._dim(x), self._dim(y)
        ndx, ndy = self._nd(x), self._nd(y)
        tx = bool(op.attrs.get("transpose_X", False))
        ty = bool(op.attrs.get("transpose_Y", False))
        rx, cx = (ndx - 1, ndx - 2) if tx else (ndx - 2, ndx - 1)
        cy, ky = (ndy - 1, ndy - 2) if ty else (ndy - 2, ndy - 1)
        ndo = max(ndx, ndy)
        out = op.outputs["Out"][0]
        ix, iy = self._ilv(x), self._ilv(y)
        bx = dx is not None and dx < ndx - 2
        by = dy is not None and dy < ndy - 2
        if bx and by and ndx == ndy and dx == dy and ix == iy:
            return self._set(out, dx, ix)
        if bx and dy is None:
            j = dx - (ndx - ndy)
            if j >= 0 and self._shape(y)[j] != 1:
                self._wrap(op, {("Y", 0): self._scatter_fn(j, ix)})
            return self._set(out, dx + ndo - ndx, ix)
        if by and dx is None:
            j = dy - (ndy - ndx)
            if j >= 0 and self._shape(x)[j] != 1:
                self._wrap(op, {("X", 0): self._scatter_fn(j, iy)})
            return self._set(out, dy + ndo - ndy, iy)
        if dx == rx and dy is None:
            return self._set(out, ndo - 2, ix)
        if dy == ky and dx is None and ndy == 2:
            if self.kind == "tp":
                self._wrap(op, {("X", 0): lambda t: comm.copy_to(
                    t, self.group)})
            return self._set(out, ndo - 1, iy)
        if dx == cx and dy == cy and ix == iy == 1:
            self._wrap(op, post={("Out", 0): self._sum_fn()})
            return self._set(out, None)
        if dx == rx and dy is not None:
            # the other operand whole: the rows stay split
            self._wrap(op, {("Y", 0): self._gather_fn(dy, iy)})
            return self._set(out, ndo - 2, ix)
        self._gather_all(op, "no matmul layout")

    def _op_reduce(self, op):
        x = op.inputs["X"][0]
        d = self._dim(x)
        nd = self._nd(x)
        t = op.type
        if t == "mean" or op.attrs.get("reduce_all", False) or nd == 0:
            axes = set(range(nd))
            keep = False
        else:
            dim = op.attrs.get("dim", [0])
            dim = [dim] if isinstance(dim, int) else dim
            axes = {int(a) % nd for a in dim}
            keep = bool(op.attrs.get("keep_dim", False))
        out = op.outputs["Out"][0]
        if d not in axes:
            nd_out = d if keep else d - sum(1 for a in axes if a < d)
            return self._set(out, nd_out, self._ilv(x))
        total = self._sum_fn()
        n = float(self.n)
        if t == "reduce_sum":
            post = total
        else:
            def post(v, total=total, n=n):
                return total(v) / n
        self._wrap(op, post={("Out", 0): post})
        self._set(out, None)

    def _op_lookup(self, op):
        w, ids = op.inputs["W"][0], op.inputs["Ids"][0]
        dw, di = self._dim(w), self._dim(ids)
        out = op.outputs["Out"][0]
        if dw is None:
            nd_ids = self._nd(ids)
            squeezed = (op.type == "lookup_table" and nd_ids > 1
                        and self._shape(ids)[-1] == 1)
            if squeezed and di == nd_ids - 1:
                return self._gather_all(op, "ids split on their last dim")
            return self._set(out, di)
        if dw != 0 or di is not None:
            return self._gather_all(op, "table split off its rows")
        rows = self._shape(w)[0] // self.n
        lo = self.index * rows
        group = self.group
        kind = self.kind

        def lower(ctx, proxy, ins, base):
            table, idv = ins["W"][0], ins["Ids"][0]
            if proxy.type == "lookup_table" and idv.dim() > 1 and \
                    idv.shape[-1] == 1:
                idv = idv.squeeze(-1)
            local = idv - lo
            valid = (local >= 0) & (local < rows)
            got = table[torch.where(valid, local, torch.zeros_like(local))]
            pad = proxy.attrs.get("padding_idx", -1)
            if pad is not None and pad >= 0:
                valid = valid & (idv != pad)
            got = torch.where(valid[..., None], got,
                              torch.zeros((), dtype=got.dtype,
                                          device=got.device))
            red = comm.reduce_from if kind == "tp" else comm.all_reduce_sum
            return {"Out": [red(got, group)]}

        self._hook(op, lower)
        self._set(out, None)

    def _lookup_grad(self, op):
        w = op.inputs["W"][0]
        if self._dim(w) != 0:
            return
        rows = self._shape(w)[0] // self.n
        lo = self.index * rows

        def lower(ctx, proxy, ins, base):
            idv, og = ins["Ids"][0], ins["Out@GRAD"][0]
            local = idv - lo
            valid = (local >= 0) & (local < rows)
            pad = proxy.attrs.get("padding_idx", -1)
            if pad is not None and pad >= 0:
                valid = valid & (idv != pad)
            # out-of-shard rows land on row 0 with a zero gradient
            local = torch.where(valid, local, torch.zeros_like(local))
            vmask = valid
            if proxy.type == "lookup_table_grad" and vmask.dim() > 1 and \
                    vmask.shape[-1] == 1:
                vmask = vmask.squeeze(-1)
            og = torch.where(vmask[..., None], og,
                             torch.zeros((), dtype=og.dtype,
                                         device=og.device))
            sub = dict(ins)
            sub["Ids"] = [local]
            sub["Out@GRAD"] = [og]
            attrs_pad = _Proxy(proxy, {"padding_idx": -1})
            return base.lower(ctx, attrs_pad, sub)

        self._hook(op, lower)

    def _op_softmax_with_cross_entropy(self, op):
        lg, lb = op.inputs["Logits"][0], op.inputs["Label"][0]
        dl, db = self._dim(lg), self._dim(lb)
        nd = self._nd(lg)
        axis = int(op.attrs.get("axis", -1)) % nd
        if dl == axis or (dl is None and db is not None):
            pre = {}
            if dl is not None:
                pre[("Logits", 0)] = self._gather_fn(dl, self._ilv(lg))
            if db is not None:
                pre[("Label", 0)] = self._gather_fn(db)
            self._wrap(op, pre)
            for n in op.output_arg_names:
                self._set(n, None)
            return
        if db is None and self._shape(lb)[dl] != 1:
            self._wrap(op, {("Label", 0): self._scatter_fn(dl)})
        for n in op.output_arg_names:
            self._set(n, dl)

    def _op_flash_attention(self, op):
        q, k, v = (op.inputs[s][0] for s in ("Q", "K", "V"))
        dq, dk, dv = self._dim(q), self._dim(k), self._dim(v)
        h = int(op.attrs["num_heads"])
        out = op.outputs["Out"][0]
        if not (dq == dk == dv) or any(self._ilv(n) > 1 for n in (q, k, v)):
            return self._gather_all(op, "q, k, v split apart")
        masks = op.inputs.get("Mask", [])
        bias = op.inputs.get("BiasQK", [])
        if dq == 2 and self.kind == "tp" and not any(
                self._dim(n) is not None for n in masks + bias):
            if h % self.n:
                return self._gather_all(op, f"{h} heads over {self.n}")
            self._wrap(op, attrs={"num_heads": h // self.n})
            return self._set(out, 2)
        if dq == 1 and self.kind == "sp":
            if bias:
                _logger.warning(
                    "flash_attention: BiasQK is dense [S, S] and cannot "
                    "ride the ring; falling back to the flash kernel on "
                    "the whole sequence (K/V all-gathered across the sp "
                    "axis)")
                return self._gather_all(op, "BiasQK")
            mode = self.sp_mode
            if mode == "ulysses" and h % self.n:
                _logger.warning(
                    "flash_attention: ulysses needs heads %% sp == 0 "
                    "(H=%s, sp=%s); using ring", h, self.n)
                mode = "ring"
            mask_dim = self._dim(masks[0]) if masks else None
            self._hook(op, _sp_attention(self, mode, mask_dim))
            return self._set(out, 1)
        self._gather_all(op, "attention split off its heads")


def _sp_attention(plan: ShardPlan, mode: str, mask_dim):
    from ..kernels.flash_attention import NEG_INF

    group, n, r = plan.group, plan.n, plan.index

    def lower(ctx, proxy, ins, base):
        from ..parallel.ring_attention import ring_attention
        from ..parallel.ulysses import ulysses_attention

        q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
        h = int(proxy.attrs["num_heads"])
        causal = bool(proxy.attrs.get("causal", False))
        B, S, HD = q.shape
        D = HD // h

        def split(x):
            return x.reshape(B, S, h, D).transpose(1, 2)

        mask = ins["Mask"][0] if ins.get("Mask") else None
        if mask is not None:
            if mask.dtype == torch.bool:
                mask = torch.where(mask.reshape(B, -1),
                                   torch.zeros((), device=mask.device),
                                   torch.full((), NEG_INF,
                                              device=mask.device))
            elif proxy.attrs.get("mask_type", "binary") == "binary":
                mask = torch.where(mask.reshape(B, -1) > 0.5,
                                   torch.zeros((), device=mask.device),
                                   torch.full((), NEG_INF,
                                              device=mask.device))
            else:
                mask = mask.reshape(B, -1)
            mask = mask.detach()
            if mode == "ring" and mask_dim is None:
                mask = mask.narrow(1, r * S, S)
            elif mode == "ulysses" and mask_dim is not None:
                mask = comm.all_gather(mask.t().contiguous(), group).t()
        fn = ring_attention if mode == "ring" else ulysses_attention
        o = fn(split(q), split(k), split(v), group, causal=causal,
               mask=mask)
        return {"Out": [o.transpose(1, 2).reshape(B, S, HD)]}

    return lower


def _reshape_dim(sx: List[int], d: int, target: List[int],
                 n: int) -> Optional[int]:
    """The dim of ``reshape(x, target)`` that carries x's split dim
    ``d`` (its outer part), or None when the split does not stay one
    outer block of one output dim."""
    sym = 7919
    s = [sym if v < 0 else v for v in sx]
    out = []
    for i, v in enumerate(target):
        out.append(s[i] if v == 0 else v)
    if -1 in out:
        known = int(np.prod([v for v in out if v != -1]))
        out[out.index(-1)] = int(np.prod(s)) // max(known, 1)
    pre = int(np.prod(s[:d])) if d else 1
    e = s[d]
    acc = 1
    for k, v in enumerate(out):
        if acc == pre:
            if v % n == 0 and (e % v == 0 or v % e == 0):
                return k
            return None
        acc *= v
        if acc > pre:
            return None
    return None


def _interleave(t: torch.Tensor, d: int, n: int, groups: int):
    """Reorder dim ``d`` from ``[g0 | g1 | ...]`` (each group in n
    chunks) to the ranks' order ``[r0: g0c0 g1c0 ... | r1: ...]``."""
    sh = list(t.shape)
    v = t.reshape(sh[:d] + [groups, n, sh[d] // (groups * n)] + sh[d + 1:])
    return v.transpose(d, d + 1).reshape(sh)


def _deinterleave(t: torch.Tensor, d: int, n: int, groups: int):
    """The inverse of ``_interleave``: gathered rank chunks back in the
    whole value's order."""
    sh = list(t.shape)
    v = t.reshape(sh[:d] + [n, groups, sh[d] // (groups * n)] + sh[d + 1:])
    return v.transpose(d, d + 1).reshape(sh)


class _GatherSum(torch.autograd.Function):
    """All-gather along a dim forward; the sum of the ranks' gradient
    slices backward (reduce-scatter): the sequence-parallel gather,
    where every rank's copy of the gathered value feeds its own loss."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return comm._gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        d = ctx.dim
        out = comm.reduce_scatter(g.movedim(d, 0).contiguous(), ctx.group)
        return out.movedim(0, d).contiguous(), None, None


def unshard(t: torch.Tensor, d: int, n: int, group, ilv: int = 1):
    """The whole value of a split tensor (no gradient)."""
    out = comm._gather(t, d, group)
    return _deinterleave(out, d, n, ilv) if ilv > 1 else out
