"""One-shot LoRA rewrite of the ragged step, as a module tree or as a
Program (counterpart of ``paddle_tpu/adapters/rewrite.py``:
``LoraReport`` :60, ``lora_targets`` :99, ``rewrite_for_lora`` :176).
``rewrite_for_lora(program, store)`` and ``lora_targets(program)`` take
the Program path below; a ``RaggedStepModel`` (a ``GPTLM`` for
``lora_targets``) takes the module path.

The Program path is JAX's walk: every ``mul`` / ``matmul`` /
``matmul_v2`` whose weight is a 2-D persistable (not transposed), and
every already-quantized ``quantized_fc`` / ``quantized_matmul``, is
repointed onto ``batched_lora_fc`` / ``batched_lora_matmul`` with its
attrs kept (``base_kind`` records dense or the quant mode); its A / B /
AdapterScale slots name the store's pool Parameters (created in the
global block once, a pool pair per rank bucket) and its Slots slot the
``gen_adapter_slots`` feed ([rows, n_buckets] int32). Nothing is
erased: the base weights keep serving every other Program over the
scope. A second call finds only ``batched_lora_*`` ops and changes
nothing; ``LoraReport`` gives the reason for each op left alone. The
store's pools reach the scope through ``AdapterStore.attach(scope)``.

The JAX rewrite repoints the ragged program's ``mul`` /
``quantized_fc`` ops onto ``batched_lora_fc``. Here the step is a
``RaggedStepModel`` over the predictor's ``GPTLM``: the rewrite walks
the model's matmul weights (every ``Dense`` and ``QuantizedDense``, the
head included), records which of them take adapter deltas on the step
model, and wires the store's pools to them. The shared modules are not
changed, so the predictor keeps serving the base model untouched, and
the base product stays bitwise what it was (``base_kind`` records dense
or the quantized mode: the delta applies to the dequantized product).
Idempotent: a second call finds every target already repointed.

Run order with quantization: quantize first, then LoRA (the walk sees
the quantized weights under their logical names, ``dec0_qkv.w``, the
names uploads use).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ..core.framework import Program
from ..kernels.lora import lora_pool_shapes
from .store import SLOTS_FEED, a_var_name, b_var_name, scale_var_name

__all__ = ["rewrite_for_lora", "lora_targets", "LoraReport"]

_NEW_OP = "batched_lora_fc"
# Program op type -> (new op type, the attr that makes it ineligible)
_DENSE_OPS = {
    "mul": ("batched_lora_fc", None),
    "matmul": ("batched_lora_matmul", "transpose_Y"),
    "matmul_v2": ("batched_lora_matmul", "trans_y"),
}
_QUANT_OPS = {
    "quantized_fc": "batched_lora_fc",
    "quantized_matmul": "batched_lora_matmul",
}
_LORA_OPS = {"batched_lora_fc", "batched_lora_matmul"}


class LoraReport:
    """What the rewrite did, per weight: repointed (with target and
    base_kind) or skipped (with the reason)."""

    def __init__(self):
        self.rows: List[Dict[str, Any]] = []

    def repointed(self, op_type, new_type, target, base_kind):
        self.rows.append({"op": op_type, "action": "repointed",
                          "new_op": new_type, "target": target,
                          "base_kind": base_kind, "reason": None})

    def skipped(self, op_type, target, reason):
        self.rows.append({"op": op_type, "action": "skipped",
                          "new_op": None, "target": target,
                          "base_kind": None, "reason": reason})

    @property
    def n_repointed(self) -> int:
        return sum(1 for r in self.rows if r["action"] == "repointed")

    def targets(self) -> List[str]:
        return sorted({r["target"] for r in self.rows
                       if r["action"] == "repointed"})

    def summary(self) -> Dict[str, Any]:
        return {"ops_repointed": self.n_repointed,
                "ops_skipped": len(self.rows) - self.n_repointed,
                "targets": self.targets()}

    def to_dict(self) -> Dict[str, Any]:
        return {"summary": self.summary(), "ops": list(self.rows)}


def _weight_shape(dense) -> Tuple[int, int]:
    w = dense.w if dense.base_kind == "dense" else dense.qweight
    return int(w.shape[0]), int(w.shape[1])


def lora_targets(model) -> Dict[str, Tuple[int, int, bool]]:
    """{weight name: (K, N, quantized)} for every matmul weight of
    ``model`` (a ``GPTLM``, or a Program: its eligible consumers'
    weights by logical name, ``batched_lora_*`` ones included): the
    table an ``AdapterStore`` builds its pools against."""
    if isinstance(model, Program):
        return _program_targets(model)
    return {dense.name: (*_weight_shape(dense), dense.base_kind != "dense")
            for _parent, _attr, dense in model.dense_layers()}


def rewrite_for_lora(step, store) -> LoraReport:
    """Route ``store``'s adapter deltas into every matmul of ``step`` (a
    ``RaggedStepModel``, or a Program rewritten in place) whose weight
    the store targets; returns the ``LoraReport``."""
    if isinstance(step, Program):
        return _rewrite_program(step, store)
    step_model = step
    report = LoraReport()
    done = set(step_model.lora_targets)
    for _parent, _attr, dense in step_model.lm.dense_layers():
        name = dense.name
        op = "mul" if dense.base_kind == "dense" else "quantized_fc"
        if name in done:
            report.skipped(_NEW_OP, name, "already a batched-LoRA op")
            continue
        if store.targets.get(name) != _weight_shape(dense):
            report.skipped(op, name, "not in the store's target table "
                           "(shape mismatch or filtered)")
            continue
        done.add(name)
        report.repointed(op, _NEW_OP, name, dense.base_kind)
    step_model.lora_targets = frozenset(done)
    step_model.adapter_store = store
    return report


# -- the Program path ---------------------------------------------------------


def _logical_target(qweight_name: str) -> str:
    return qweight_name[:-2] if qweight_name.endswith(".q") \
        else qweight_name


def _classify(blk, op):
    """(new_type, logical_target, weight_var, scale_var or None,
    base_kind) of an op the rewrite cares about, None otherwise."""
    if op.type in _DENSE_OPS:
        new_type, tattr = _DENSE_OPS[op.type]
        ys = op.inputs.get("Y", [])
        if len(ys) != 1 or (tattr and op.attrs.get(tattr, False)):
            return None
        var = blk._find_var_recursive(ys[0])
        if var is None or not getattr(var, "persistable", False) \
                or var.ndim != 2:
            return None
        return new_type, ys[0], ys[0], None, "dense"
    if op.type in _QUANT_OPS:
        qs, ss = op.inputs.get("QWeight", []), op.inputs.get("Scale", [])
        if len(qs) != 1 or len(ss) != 1:
            return None
        return (_QUANT_OPS[op.type], _logical_target(qs[0]), qs[0], ss[0],
                str(op.attrs.get("quant_mode", "int8")))
    if op.type in _LORA_OPS:
        ws = op.inputs.get("W", [])
        if len(ws) != 1:
            return None
        return (op.type, _logical_target(ws[0]), ws[0],
                (op.inputs.get("WScale") or [None])[0],
                str(op.attrs.get("base_kind", "dense")))
    return None


def _program_targets(program) -> Dict[str, Tuple[int, int, bool]]:
    out: Dict[str, Tuple[int, int, bool]] = {}
    for blk in program.blocks:
        for op in blk.ops:
            info = _classify(blk, op)
            if info is None:
                continue
            var = blk._find_var_recursive(info[2])
            if var is not None:
                out[info[1]] = (int(var.shape[0]), int(var.shape[1]),
                                info[4] != "dense")
    return out


def _ensure_vars(program, store) -> None:
    """The slots feed and each bucket's pool Parameters in the global
    block, once."""
    gb = program.global_block()
    if not gb.has_var(SLOTS_FEED):
        gb.create_var(name=SLOTS_FEED, shape=[-1, store.n_buckets],
                      dtype="int32", is_data=True, stop_gradient=True)
    for bi, rb in enumerate(store.rank_buckets):
        s = store.slots[bi]
        if not gb.has_var(scale_var_name(rb)):
            gb.create_parameter(scale_var_name(rb), [s], "float32",
                                trainable=False, stop_gradient=True)
        for t, (k, n) in store.targets.items():
            if gb.has_var(a_var_name(t, rb)):
                continue
            a_shape, b_shape = lora_pool_shapes(k, n, rb, s)
            gb.create_parameter(a_var_name(t, rb), list(a_shape), "float32",
                                trainable=False, stop_gradient=True)
            gb.create_parameter(b_var_name(t, rb), list(b_shape), "float32",
                                trainable=False, stop_gradient=True)


def _skip_reason(op) -> Tuple[Any, str]:
    if op.type in _DENSE_OPS:
        _nt, tattr = _DENSE_OPS[op.type]
        ys = op.inputs.get("Y", [])
        target = ys[0] if ys else None
        if tattr and op.attrs.get(tattr, False):
            return target, f"{tattr}=True (transposed weight)"
        return target, "weight is not a 2-D persistable"
    return None, "malformed quantized op wiring"


def _rewrite_program(program, store) -> LoraReport:
    report = LoraReport()
    rewrote = vars_made = False
    for blk in program.blocks:
        for op in blk.ops:
            if op.type in _LORA_OPS:
                info = _classify(blk, op)
                report.skipped(op.type, info[1] if info else None,
                               "already a batched-LoRA op")
                continue
            if op.type not in _DENSE_OPS and op.type not in _QUANT_OPS:
                continue
            info = _classify(blk, op)
            if info is None:
                report.skipped(op.type, *_skip_reason(op))
                continue
            new_type, target, wname, sname, base_kind = info
            if target not in store.targets:
                report.skipped(op.type, target, "not in the store's target "
                               "table (shape mismatch or filtered)")
                continue
            if not vars_made:
                _ensure_vars(program, store)
                vars_made = True
            old_type = op.type
            op.type = new_type
            op.inputs = {
                "X": list(op.inputs["X"]),
                "W": [wname],
                "WScale": [sname] if sname else [],
                "A": [a_var_name(target, rb) for rb in store.rank_buckets],
                "B": [b_var_name(target, rb) for rb in store.rank_buckets],
                "AdapterScale": [scale_var_name(rb)
                                 for rb in store.rank_buckets],
                "Slots": [SLOTS_FEED],
            }
            op.attrs["base_kind"] = base_kind
            if base_kind != "dense":
                op.attrs.setdefault("quant_block", 0)
            report.repointed(old_type, new_type, target, base_kind)
            rewrote = True
    if rewrote:
        program._bump()
    return report
