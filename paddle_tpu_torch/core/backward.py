"""Graph-level autodiff: append_backward and
append_backward_with_recompute.

The port's copy of ``paddle_tpu/core/backward.py`` ``append_backward``
(:48) and ``append_backward_with_recompute`` (:243), line for line, so that the port appends the same grad ops under
the same names as the JAX package. Fluid's reference is
python/paddle/fluid/backward.py:1139 (append_backward).

The reverse pass is *graph-level*: grad ops are appended to the Program
(op_role=Backward) so the optimizer sees them. No op needs a
hand-written grad maker: a ``<type>_grad`` op's lowering defaults to the
autograd graph its forward op recorded on the executor's tape
(core/registry.py, core/executor.py). Explicit grad lowerings exist
only where semantics diverge.

Gradient aggregation for multi-consumer vars follows the reference's
rename-then-sum scheme (backward.py _addup_repetitive_outputs): partial
grads get @RENAME names and a `sum` op folds them into var@GRAD.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from .framework import Block, OpRole, Parameter, Program, Variable
from .registry import get_op_def, has_op


def _grad_name(name: str) -> str:
    return name + "@GRAD"


def _var_or_none(block: Block, name: str) -> Optional[Variable]:
    return block._find_var_recursive(name)


def _create_grad_var(block: Block, fwd_name: str) -> Variable:
    fwd = _var_or_none(block, fwd_name)
    gname = _grad_name(fwd_name)
    if block.has_var(gname):
        return block.var(gname)
    return block.create_var(
        name=gname,
        shape=fwd.shape if fwd is not None else None,
        dtype=fwd.dtype if fwd is not None else "float32",
        stop_gradient=True,
    )


def _error_clip(block: Block, names) -> None:
    """The reference's ``error_clip_callback``: a ``clip`` op on each
    ``<var>@GRAD`` just produced whose forward var has an
    ``error_clip`` (``clip.ErrorClipByValue``)."""
    for gname in names:
        if not gname.endswith("@GRAD"):
            continue
        fwd = _var_or_none(block, gname[: -len("@GRAD")])
        clip = getattr(fwd, "error_clip", None)
        if clip is not None:
            clip._append_clip_op(block, gname)


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
) -> List[Tuple[Variable, Variable]]:
    """Append grad ops for `loss` to its program; return
    [(param, param_grad)] for trainable parameters.

    Matches reference backward.py:1139 semantics: ops are appended in
    reverse topological (= reverse program) order, each marked
    op_role=Backward; the loss op additionally gets op_role |= Loss.
    """
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    # seed: d loss / d loss = 1
    loss_g = _create_grad_var(block, loss.name)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_g]},
        attrs={
            "shape": list(loss.shape or ()),
            "value": 1.0,
            "dtype": loss.dtype,
            "op_role": OpRole.Backward | OpRole.Loss,
        },
    )

    grad_map: Dict[str, str] = {loss.name: loss_g.name}
    fwd_ops = [
        op
        for op in block.ops
        if int(op.attrs.get("op_role", 0)) & (OpRole.Backward | OpRole.Optimize) == 0
    ]
    # drop the seed op we just appended (it carries Backward role already)

    for op in reversed(fwd_ops):
        if not has_op(op.type):
            raise NotImplementedError(f"no lowering for op {op.type!r}")
        opdef = get_op_def(op.type)
        if opdef.stop_gradient:
            continue
        # grads flowing into this op?
        out_grads: Dict[str, List[str]] = {}
        any_grad = False
        for slot, names in op.outputs.items():
            gs = []
            for n in names:
                g = grad_map.get(n)
                gs.append(g)
                if g is not None:
                    any_grad = True
            out_grads[slot] = gs
        if not any_grad:
            continue

        # which inputs need grads
        want_slots: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            if slot in opdef.no_grad_slots:
                continue
            targets = []
            for n in names:
                v = _var_or_none(block, n)
                if n in no_grad or (v is not None and v.stop_gradient):
                    continue
                targets.append(n)
            if targets:
                want_slots[slot] = targets
        if not want_slots:
            continue

        g_inputs: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            g_inputs[slot] = list(names)
        for slot, names in op.outputs.items():
            g_inputs[slot] = list(names)
            gs = out_grads[slot]
            if not any(g is not None for g in gs):
                continue
            # keep positional alignment within the slot: outputs without
            # an incoming grad get an explicit zero grad (reference
            # backward.py fills fill_zeros_like for exactly this case)
            aligned = []
            for n, g in zip(names, gs):
                if g is not None:
                    aligned.append(g)
                    continue
                zname = _grad_name(n) + "@ZERO"
                if not block.has_var(zname):
                    v = _var_or_none(block, n)
                    block.create_var(
                        name=zname,
                        shape=v.shape if v is not None else None,
                        dtype=v.dtype if v is not None else "float32",
                        stop_gradient=True,
                    )
                    block.append_op(
                        type="fill_zeros_like",
                        inputs={"X": [n]},
                        outputs={"Out": [zname]},
                        attrs={"op_role": OpRole.Backward},
                    )
                aligned.append(zname)
            g_inputs[slot + "@GRAD"] = aligned

        # in-place pattern (write_to_array & co): an op whose output name
        # is also one of its input names. The incoming grad (for the
        # post-write value) is consumed as this grad op's out-grad; the
        # produced in-grad REPLACES the map entry for earlier producers
        # — summing would double-count (SSA values share one name).
        op_out_names = {n for ns in op.outputs.values() for n in ns}

        g_outputs: Dict[str, List[str]] = {}
        pending_sums: List[Tuple[str, str, str]] = []  # (final, old, new)
        pending_replace: List[Tuple[str, str]] = []    # (name, new grad var)
        for slot, names in op.inputs.items():
            if slot not in want_slots:
                continue
            onames = []
            for n in names:
                if n not in want_slots[slot]:
                    # positional alignment matters for multi-var slots:
                    # emit to a throwaway name
                    onames.append(_grad_name(n) + "@UNUSED")
                    block.create_var(name=onames[-1], stop_gradient=True)
                    continue
                gname = _grad_name(n)
                if n in grad_map:
                    renamed = gname + f"@RENAME@{len(block.ops)}"
                    block.create_var(
                        name=renamed,
                        shape=(_var_or_none(block, n) or loss).shape,
                        dtype=(_var_or_none(block, n) or loss).dtype,
                        stop_gradient=True,
                    )
                    if n in op_out_names:
                        pending_replace.append((n, renamed))
                    else:
                        # second producer: rename + sum (reference
                        # _addup_repetitive_outputs)
                        pending_sums.append((gname, grad_map[n], renamed))
                    onames.append(renamed)
                else:
                    _create_grad_var(block, n)
                    grad_map[n] = gname
                    onames.append(gname)
            g_outputs[slot + "@GRAD"] = onames

        attrs = dict(op.attrs)
        attrs["op_role"] = OpRole.Backward
        attrs["fwd_type"] = op.type
        block.append_op(
            type=op.type + "_grad",
            inputs=g_inputs,
            outputs=g_outputs,
            attrs=attrs,
        )
        _error_clip(block, [n for ns in g_outputs.values() for n in ns])
        for final, old, new in pending_sums:
            block.append_op(
                type="sum",
                inputs={"X": [old, new]},
                outputs={"Out": [final]},
                attrs={"op_role": OpRole.Backward},
            )
            _error_clip(block, [final])
            grad_map_key = final[: -len("@GRAD")]
            grad_map[grad_map_key] = final
        for n, new in pending_replace:
            grad_map[n] = new

    program._bump()

    # collect (param, grad)
    if parameter_list is not None:
        params = [
            p if isinstance(p, Variable) else block.var(str(p))
            for p in parameter_list
        ]
    else:
        params = [
            v
            for v in program.global_block().vars.values()
            if isinstance(v, Parameter) and v.trainable
        ]
    result = []
    for p in params:
        g = grad_map.get(p.name)
        if g is None:
            continue
        result.append((p, block.var(g)))
    return result


def append_backward_with_recompute(
    loss: Variable,
    checkpoints: Sequence,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
) -> List[Tuple[Variable, Variable]]:
    """Checkpoint-aware backward (reference backward.py:618
    _append_backward_ops_with_checkpoints_), a copy of the JAX
    package's (``core/backward.py:243``) line for line.

    The forward is split into segments at the checkpoint vars. Instead
    of per-op grad ops, ONE `recompute_segment_grad` op is emitted per
    segment (reverse order); its lowering (``core/control_flow.py``)
    re-runs the segment's forward with autograd on and applies the
    incoming cotangents. No grad op consumes the first forward, so it
    records nothing and its activations are freed after their last
    forward reader: activation memory scales with the number of
    checkpoints, not the depth.
    """
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())
    ckpt_names = [v.name if isinstance(v, Variable) else str(v) for v in checkpoints]

    fwd_ops = [
        op for op in block.ops
        if int(op.attrs.get("op_role", 0)) & (OpRole.Backward | OpRole.Optimize) == 0
    ]

    # -- segment the forward at checkpoint producers ----------------------
    segments: List[List] = []
    cur: List = []
    remaining = set(ckpt_names)
    for op in fwd_ops:
        cur.append(op)
        produced_ckpt = remaining.intersection(
            n for names in op.outputs.values() for n in names
        )
        if produced_ckpt:
            remaining -= produced_ckpt
            segments.append(cur)
            cur = []
    if cur:
        segments.append(cur)
    if remaining:
        raise ValueError(f"checkpoint vars never produced: {sorted(remaining)}")

    def seg_produced(seg):
        return {n for op in seg for names in op.outputs.values() for n in names}

    def seg_inputs(seg):
        prod = seg_produced(seg)
        ins, seen = [], set()
        for op in seg:
            for names in op.inputs.values():
                for n in names:
                    if n not in prod and n not in seen:
                        seen.add(n)
                        ins.append(n)
        return ins

    # outputs of each segment that later segments (or the loss) consume
    later_consumed: List[Set[str]] = []
    for i, seg in enumerate(segments):
        consumed = set()
        for later in segments[i + 1:]:
            for op in later:
                for names in op.inputs.values():
                    consumed.update(names)
        used = seg_produced(seg) & consumed
        if loss.name in seg_produced(seg):
            used.add(loss.name)
        later_consumed.append(used)

    # -- seed dL/dL = 1 ----------------------------------------------------
    loss_g = _create_grad_var(block, loss.name)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_g]},
        attrs={
            "shape": list(loss.shape or ()),
            "value": 1.0,
            "dtype": loss.dtype,
            "op_role": OpRole.Backward | OpRole.Loss,
        },
    )
    grad_map: Dict[str, str] = {loss.name: loss_g.name}

    def differentiable(name: str) -> bool:
        v = _var_or_none(block, name)
        if name in no_grad:
            return False
        if v is None:
            return False
        if v.stop_gradient:
            return False
        return v.dtype in ("float32", "float16", "bfloat16", "float64")

    # -- one recompute_segment_grad op per segment, reverse order ----------
    for seg, used in zip(reversed(segments), reversed(later_consumed)):
        out_names = sorted(n for n in used if n in grad_map)
        if not out_names:
            continue
        ins = seg_inputs(seg)
        wanted = [n for n in ins if differentiable(n)]
        if not wanted:
            continue

        sb = program._create_block()
        for op in seg:
            sb.append_op(type=op.type, inputs={k: list(v) for k, v in op.inputs.items()},
                         outputs={k: list(v) for k, v in op.outputs.items()},
                         attrs=dict(op.attrs))
        program._rollback()

        pending_sums: List[Tuple[str, str, str]] = []
        gnames = []
        for n in wanted:
            gname = _grad_name(n)
            if n in grad_map:
                renamed = gname + f"@RENAME@{len(block.ops)}"
                block.create_var(
                    name=renamed,
                    shape=(_var_or_none(block, n) or loss).shape,
                    dtype=(_var_or_none(block, n) or loss).dtype,
                    stop_gradient=True,
                )
                pending_sums.append((gname, grad_map[n], renamed))
                gnames.append(renamed)
            else:
                _create_grad_var(block, n)
                grad_map[n] = gname
                gnames.append(gname)

        block.append_op(
            type="recompute_segment_grad",
            inputs={
                "Inputs": list(ins),
                "OutGrads": [grad_map[n] for n in out_names],
            },
            outputs={"InGrads": gnames},
            attrs={
                "sub_block": sb,
                "seg_outputs": out_names,
                "wanted": list(wanted),
                "op_role": OpRole.Backward,
            },
        )
        for final, old, new in pending_sums:
            block.append_op(
                type="sum",
                inputs={"X": [old, new]},
                outputs={"Out": [final]},
                attrs={"op_role": OpRole.Backward},
            )
            grad_map[final[: -len("@GRAD")]] = final

    program._bump()

    if parameter_list is not None:
        params = [
            p if isinstance(p, Variable) else block.var(str(p))
            for p in parameter_list
        ]
    else:
        params = [
            v for v in program.global_block().vars.values()
            if isinstance(v, Parameter) and v.trainable
        ]
    result = []
    for p in params:
        g = grad_map.get(p.name)
        if g is not None:
            result.append((p, block.var(g)))
    return result


def gradients(targets, inputs, target_gradients=None,
              no_grad_set=None) -> List[Optional[Variable]]:
    """Reference backward.py gradients(), as JAX's
    (``paddle_tpu/core/backward.py:419``): the gradient Variables of one
    target with respect to ``inputs`` (None where no gradient reaches),
    through ``append_backward`` with the inputs made to require
    gradients while it runs."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if len(targets) != 1:
        raise ValueError("gradients() takes one target: sum them first")
    t = targets[0]
    saved = [(v, v.stop_gradient) for v in inputs]
    for v in inputs:
        v.stop_gradient = False
    try:
        append_backward(t, no_grad_set=no_grad_set)
    finally:
        for v, s in saved:
            v.stop_gradient = s
    block = t.block
    return [block.var(_grad_name(v.name))
            if block.has_var(_grad_name(v.name)) else None for v in inputs]
