"""paddle_tpu_torch.quantize — post-training weight quantization for
serving (counterpart of ``paddle_tpu/quantize/__init__.py``:
``QuantizeReport`` :70, ``rewrite_for_inference`` :176).

``rewrite_for_inference`` takes either of the port's two forms of a
model:

* a Program and its Scope (``rewrite_for_inference(program, scope,
  wdtype, block, min_elements)``, the JAX function): every eligible
  weight (a 2-D float persistable consumed only as the right-hand
  operand of ``mul`` / ``matmul`` / ``matmul_v2``) is quantized once in
  the scope into ``{name}.q`` and ``{name}.qscale``
  (``kernels.quant_matmul.quantize_weight``), the float original is
  erased from the scope, and its consumers become ``quantized_fc`` /
  ``quantized_matmul`` ops (K11 on CUDA). ``scope._quantize_meta``
  records each weight's (mode, block), so a second program over the
  same scope reuses the buffers or raises on another format;
* a ``GPTLM`` module (the engine's form): every ``Dense`` (the matmul
  weights, in the order the JAX program consumes them) is replaced in
  place by a ``QuantizedDense`` holding the int8 / fp8 weight and its
  float32 scale plane. A ``Dense`` already quantized is checked for its
  mode and block. The Program Predictor of an LM directory builds its
  ``QuantizedDense``s over the scope's ``.q`` / ``.qscale`` tensors, so
  the program and the engine share one set of quantized weights.

The report follows the JAX function row for row: the quantized weights
with their shapes and bytes, and the skip reasons in the same words
(the embedding tables are "never consumed as a matmul right-hand
operand"). Decoding one format's bytes as another would be silent
garbage, so a mode or block that differs from what the scope or module
holds raises.

Opt-in is the ``quantize_weights`` flag ("off" | "int8" | "int8_block"
| "fp8"), read at Predictor construction
(``Config.enable_weight_quantization`` overrides it per instance) and by
the GenerationEngine (``quantize_weights=``). The quantized weight and
its scale plane inherit the float weight's partition tags, as the JAX
rewrite stamps them, so a tensor-parallel Predictor runs K11 on each
rank's shards.

``calibrate`` (``paddle_tpu/quantize/__init__.py:362``) puts one
``moving_average_abs_max_scale`` observer (``ops/quant.py``) on the X
input of each matmul and quantized matmul op of a clone of a Program,
drives feeds through it and returns each activation's scale, the scale
an activation-quantized (w8a8) op would consume. The JAX package has no
such op, and neither has the port.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core.framework import Program
from ..kernels.quant_matmul import (DEFAULT_BLOCK, QUANT_MODES,
                                    quantize_weight, quantized_weight_bytes,
                                    scale_shape)

__all__ = ["rewrite_for_inference", "calibrate", "QuantizeReport",
           "QUANT_MODES", "DEFAULT_BLOCK"]

_FLOATS = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _nbytes(shape, dtype: str) -> int:
    n = 1
    for d in shape or ():
        n *= max(int(d), 1)
    return n * (2 if dtype == "bfloat16" else
                torch.empty((), dtype=getattr(torch, dtype)).element_size())


class QuantizeReport:
    """What the rewrite did, per weight: quantized (with the byte
    accounting) or skipped (with the reason). ``summary()`` gives the
    headline bytes before / after and their ratio."""

    def __init__(self, mode: str, block: int):
        self.mode = mode
        self.block = block
        self.rows: List[Dict[str, Any]] = []
        # the partition tags each quantized weight and its scale plane
        # inherited (or dropped), one row a (weight, tag kind), as JAX's
        # ``tag_rows``; also on the program as ``_quant_tag_record``
        self.tag_rows: List[Dict[str, Any]] = []

    def quantized(self, name, shape, dtype, q_bytes):
        self.rows.append({
            "name": name, "action": "quantized", "shape": list(shape),
            "dtype": dtype, "bytes_before": _nbytes(shape, dtype),
            "bytes_after": int(q_bytes), "reason": None,
        })

    def skipped(self, name, shape, dtype, reason):
        self.rows.append({
            "name": name, "action": "skipped",
            "shape": list(shape) if shape else None, "dtype": dtype,
            "bytes_before": _nbytes(shape, dtype) if shape else 0,
            "bytes_after": _nbytes(shape, dtype) if shape else 0,
            "reason": reason,
        })

    @property
    def n_quantized(self) -> int:
        return sum(1 for r in self.rows if r["action"] == "quantized")

    def skip_reasons(self) -> Dict[str, str]:
        return {r["name"]: r["reason"] for r in self.rows
                if r["action"] == "skipped"}

    def summary(self) -> Dict[str, Any]:
        before = sum(r["bytes_before"] for r in self.rows)
        after = sum(r["bytes_after"] for r in self.rows)
        return {
            "mode": self.mode, "block": self.block,
            "vars_quantized": self.n_quantized,
            "vars_skipped": len(self.rows) - self.n_quantized,
            "weight_bytes_before": before,
            "weight_bytes_after": after,
            "weight_bytes_ratio": round(after / before, 4) if before else 1.0,
        }

    def tag_record(self, name, qname, sname, kind, original, inherited,
                   dropped_reason=None):
        row = {
            "name": name, "qname": qname, "sname": sname, "kind": kind,
            "original": list(original),
            "inherited": list(inherited) if inherited is not None else None,
            "dropped_reason": dropped_reason,
        }
        self.tag_rows.append(row)
        return row

    def to_dict(self) -> Dict[str, Any]:
        return {"summary": self.summary(), "vars": list(self.rows),
                "partition_tags": list(self.tag_rows)}


def _check_wdtype(wdtype: str) -> None:
    if wdtype not in QUANT_MODES:
        raise ValueError(
            f"rewrite_for_inference: wdtype must be one of {QUANT_MODES} "
            f"(or gate on the 'off' flag value before calling), "
            f"got {wdtype!r}")


def rewrite_for_inference(target, *args, **kwargs) -> QuantizeReport:
    """``rewrite_for_inference(program, scope, wdtype="int8",
    block=DEFAULT_BLOCK, min_elements=0)`` or
    ``rewrite_for_inference(model, wdtype="int8", block=DEFAULT_BLOCK,
    min_elements=0)``: see the module docstring. Returns the
    ``QuantizeReport``."""
    if isinstance(target, Program):
        return _rewrite_program(target, *args, **kwargs)
    return _rewrite_module(target, *args, **kwargs)


# op types whose right-hand ("Y") operand is a weight the rewrite can
# quantize, with the attr that would make it ineligible
_MATMUL_OPS = {"mul": None, "matmul": "transpose_Y", "matmul_v2": "trans_y"}
_QUANTIZED_OPS = {"quantized_fc", "quantized_matmul"}


def _weight_uses(program):
    """name -> [(op, role)] over every block: role "weight" (an
    eligible right-hand matmul operand), "transposed" (under a
    Y-transpose) or "<op type>:<slot>" for any other use."""
    uses: Dict[str, List] = {}
    for blk in program.blocks:
        for op in blk.ops:
            if op.type in ("feed", "fetch"):
                continue
            is_mm = op.type in _MATMUL_OPS
            tattr = _MATMUL_OPS.get(op.type)
            y = op.inputs.get("Y", []) if is_mm else []
            for slot, names in op.inputs.items():
                for n in names:
                    if is_mm and slot == "Y" and len(y) == 1:
                        role = ("transposed"
                                if tattr and op.attrs.get(tattr, False)
                                else "weight")
                    else:
                        role = f"{op.type}:{slot}"
                    uses.setdefault(n, []).append((op, role))
    return uses


def _rewrite_program(program, scope, wdtype: str = "int8",
                     block: int = DEFAULT_BLOCK,
                     min_elements: int = 0) -> QuantizeReport:
    _check_wdtype(wdtype)
    block = int(block)
    report = QuantizeReport(wdtype, block)
    gb = program.global_block()
    rewrote = False
    for name, consumers in _weight_uses(program).items():
        var = gb._find_var_recursive(name)
        if var is None or not var.persistable:
            continue
        shape, dtype = var.shape, var.dtype
        if not any(role == "weight" for _op, role in consumers):
            # a 2-D float table no matmul reads (an embedding): say why
            # it stays float; the scale planes of already-quantized ops
            # are this pass's own output and are not reported
            if (var.ndim == 2 and dtype in ("float32", "bfloat16")
                    and not all(role.split(":")[0] in _QUANTIZED_OPS
                                for _op, role in consumers)):
                kinds = sorted({role for _op, role in consumers})
                report.skipped(name, shape, dtype,
                               "never consumed as a matmul right-hand "
                               f"operand (ops: {', '.join(kinds)})")
            continue
        bad = [(op, role) for op, role in consumers if role != "weight"]
        if var.ndim != 2:
            report.skipped(name, shape, dtype, f"not 2-D (shape {shape})")
            continue
        if dtype not in ("float32", "bfloat16"):
            report.skipped(name, shape, dtype,
                           f"dtype {dtype} is not a float weight")
            continue
        if bad:
            kinds = sorted({role for _op, role in bad})
            report.skipped(name, shape, dtype,
                           "also consumed outside an eligible matmul "
                           f"right-hand operand: {', '.join(kinds)}")
            continue
        n_el = int(shape[0]) * int(shape[1])
        if n_el < min_elements:
            report.skipped(name, shape, dtype,
                           f"{n_el} elements < min_elements {min_elements}")
            continue
        qname, sname = name + ".q", name + ".qscale"
        meta = getattr(scope, "_quantize_meta", None)
        if meta is None:
            meta = scope._quantize_meta = {}
        if scope.find_var(qname) is None:
            val = scope.find_var(name)
            if val is None:
                report.skipped(name, shape, dtype,
                               "weight missing from scope (run the startup "
                               "program / load the checkpoint before "
                               "rewriting)")
                continue
            with torch.no_grad():
                q, s = quantize_weight(torch.as_tensor(val), wdtype, block)
            scope.set_var(qname, q.contiguous())
            scope.set_var(sname, s.contiguous())
            meta[name] = (wdtype, block)
        else:
            # the scope's buffer must be of THIS mode and block
            have = meta.get(name)
            if have is None:
                want_dt = (torch.float8_e4m3fn if wdtype == "fp8"
                           else torch.int8)
                sval = scope.find_var(sname)
                ok = (scope.find_var(qname).dtype == want_dt
                      and sval is not None
                      and tuple(sval.shape) == scale_shape(shape, wdtype,
                                                           block))
            else:
                ok = have == (wdtype, block)
            if not ok:
                raise ValueError(
                    f"rewrite_for_inference: scope already holds {qname!r} "
                    f"quantized as {have or 'an incompatible format'}, but "
                    f"wdtype={wdtype!r} block={block} was requested — "
                    "every program sharing one scope must quantize with "
                    "the same mode and block")
        # the memory win is real: the float original leaves the scope
        if scope.find_var(name) is not None:
            scope.erase(name)
        if not gb.has_var(qname):
            qdtype = "float8_e4m3fn" if wdtype == "fp8" else "int8"
            qv = gb.create_parameter(qname, list(shape), qdtype,
                                     trainable=False, stop_gradient=True)
            sv = gb.create_parameter(
                sname, list(scale_shape(shape, wdtype, block)), "float32",
                trainable=False, stop_gradient=True)
            # tensor parallelism composes: the quantized weight inherits
            # the float weight's partition tags, and its scale plane
            # shards with the output-channel axis (its last dim tracks
            # N), as the JAX rewrite stamps them and records each
            # inheritance or drop (:310-335)
            src = gb.var(name) if gb.has_var(name) else None
            tag_rec = getattr(program, "_quant_tag_record", None)
            if tag_rec is None:
                tag_rec = program._quant_tag_record = []
            for kind in ("logical_axes", "sharding"):
                tags = getattr(src, kind, None)
                if tags is None:
                    continue
                if len(tags) == 2:
                    setattr(qv, kind, tuple(tags))
                    setattr(sv, kind, ((None, tags[1])
                                       if wdtype == "int8_block"
                                       else (tags[1],)))
                    tag_rec.append(report.tag_record(
                        name, qname, sname, kind, tags, tuple(tags)))
                else:
                    tag_rec.append(report.tag_record(
                        name, qname, sname, kind, tags, None,
                        dropped_reason=(
                            f"{kind} arity {len(tags)} does not match the "
                            "2-D weight — tags dropped by the quantize "
                            "rewrite")))
        for op, _role in consumers:
            if op.type == "mul":
                op.type = "quantized_fc"
                op.attrs.pop("y_num_col_dims", None)
            else:
                op.type = "quantized_matmul"
                op.attrs.pop("transpose_Y", None)
                op.attrs.pop("trans_y", None)
            op.inputs = {"X": list(op.inputs["X"]), "QWeight": [qname],
                         "Scale": [sname]}
            op.attrs["quant_mode"] = wdtype
            op.attrs["quant_block"] = block
        for blk in program.blocks:
            blk.vars.pop(name, None)
        report.quantized(name, shape, dtype,
                         quantized_weight_bytes(shape, wdtype, block))
        rewrote = True
    if rewrote:
        program._bump()
    return report


def _rewrite_module(model, wdtype: str = "int8", block: int = DEFAULT_BLOCK,
                    min_elements: int = 0) -> QuantizeReport:
    _check_wdtype(wdtype)
    # imported here: the generation package imports this module
    from ..generation.model import QuantizedDense

    block = int(block)
    report = QuantizeReport(wdtype, block)
    for name, table, consumer in model.embedding_tables():
        dtype = _FLOATS.get(table.dtype)
        if table.dim() == 2 and dtype is not None:
            report.skipped(name, tuple(table.shape), dtype,
                           "never consumed as a matmul right-hand operand "
                           f"(ops: {consumer})")
    # lazily: each float weight is freed as soon as it is replaced
    for parent, attr, dense in model.dense_layers():
        name = dense.name
        if isinstance(dense, QuantizedDense):
            if (dense.mode, dense.block) != (wdtype, block):
                raise ValueError(
                    f"rewrite_for_inference: the model already holds "
                    f"{name!r} quantized as {(dense.mode, dense.block)}, "
                    f"but wdtype={wdtype!r} block={block} was requested — "
                    "every module sharing these weights must quantize "
                    "with the same mode and block")
            continue
        w = dense.w
        shape = tuple(w.shape)
        dtype = _FLOATS.get(w.dtype)
        if dtype is None:
            report.skipped(name, shape, str(w.dtype).replace("torch.", ""),
                           f"dtype {w.dtype} is not a float weight")
            continue
        n_el = int(shape[0]) * int(shape[1])
        if n_el < min_elements:
            report.skipped(name, shape, dtype,
                           f"{n_el} elements < min_elements {min_elements}")
            continue
        with torch.no_grad():
            q, s = quantize_weight(w.detach(), wdtype, block)
        setattr(parent, attr, QuantizedDense(dense, q, s, wdtype, block))
        del dense, w       # the float weight goes with the old module
        report.quantized(name, shape, dtype,
                         quantized_weight_bytes(shape, wdtype, block))
    return report


def calibrate(program, feeds, scope=None, executor=None,
              moving_rate: float = 0.9,
              max_batches: int = 8) -> Dict[str, float]:
    """{activation var name: calibrated scale}: one observer per
    distinct X input of ``mul`` / ``matmul`` / ``matmul_v2`` /
    ``quantized_fc`` / ``quantized_matmul`` in a ``for_test`` clone of
    ``program``, up to ``max_batches`` feeds of ``feeds`` run through
    it, and accum / state of each running abs-max. The observer state
    (``{x}.act_accum`` / ``{x}.act_state``) lives in ``scope`` during
    the run and is erased after; the observed program's own numbers do
    not change (the observer's Out is never read). ``executor``
    defaults to one on CUDA."""
    from ..core.executor import Executor, global_scope
    from ..core.places import CUDAPlace

    scope = scope if scope is not None else global_scope()
    inst = program.clone(for_test=True)
    blk = inst.global_block()
    targets = []
    for op in blk.ops:
        if op.type not in set(_MATMUL_OPS) | _QUANTIZED_OPS:
            continue
        xs = op.inputs.get("X", [])
        if len(xs) != 1 or xs[0] in targets:
            continue
        targets.append(xs[0])
    if not targets:
        return {}
    state = {}
    for x in targets:
        accum, st = f"{x}.act_accum", f"{x}.act_state"
        out, osc = f"{x}.act_obs_out", f"{x}.act_scale"
        for n in (accum, st):
            blk.create_var(n, shape=[1], dtype="float32", persistable=True)
            scope.set_var(n, np.zeros(1, np.float32))
        blk.create_var(out, shape=None, dtype="float32")
        blk.create_var(osc, shape=[1], dtype="float32")
        blk.append_op(
            type="moving_average_abs_max_scale",
            inputs={"X": [x], "InAccum": [accum], "InState": [st]},
            outputs={"Out": [out], "OutScale": [osc],
                     "OutAccum": [accum], "OutState": [st]},
            attrs={"moving_rate": float(moving_rate)})
        state[x] = (accum, st)
    inst._bump()
    exe = executor or Executor(CUDAPlace(0))
    n = 0
    try:
        for feed in feeds:
            if n >= max_batches:
                break
            exe.run(inst, feed=dict(feed),
                    fetch_list=[f"{targets[0]}.act_scale"], scope=scope)
            n += 1
        if n == 0:
            raise ValueError("calibrate: the feeds iterable yielded no "
                             "batches")
        scales = {}
        for x, (accum, st) in state.items():
            a = float(scope.get_numpy(accum).reshape(()))
            s = float(scope.get_numpy(st).reshape(()))
            scales[x] = a / s if s else 0.0
    finally:
        # calibration state is scratch, not model state
        for accum, st in state.values():
            scope.erase(accum)
            scope.erase(st)
    return scales
