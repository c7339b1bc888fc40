"""One-shot LoRA rewrite of the ragged step's module tree (counterpart
of ``paddle_tpu/adapters/rewrite.py``: ``LoraReport`` :60,
``lora_targets`` :99, ``rewrite_for_lora`` :176).

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

__all__ = ["rewrite_for_lora", "lora_targets", "LoraReport"]

_NEW_OP = "batched_lora_fc"


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


def lora_targets(lm) -> Dict[str, Tuple[int, int, bool]]:
    """{weight name: (K, N, quantized)} for every matmul weight of
    ``lm`` (a ``GPTLM``): the table an ``AdapterStore`` builds its
    pools against."""
    return {dense.name: (*_weight_shape(dense), dense.base_kind != "dense")
            for _parent, _attr, dense in lm.dense_layers()}


def rewrite_for_lora(step_model, store) -> LoraReport:
    """Route ``store``'s adapter deltas into every matmul of
    ``step_model`` (a ``RaggedStepModel``) whose weight the store
    targets; returns the ``LoraReport``."""
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
