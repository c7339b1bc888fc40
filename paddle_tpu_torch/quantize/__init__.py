"""paddle_tpu_torch.quantize — post-training weight quantization for
serving (counterpart of ``paddle_tpu/quantize/__init__.py``:
``QuantizeReport`` :70, ``rewrite_for_inference`` :176).

The port's serving path runs ``nn.Module``s, not a Program, so the
rewrite walks the module tree: every ``Dense`` of a ``GPTLM`` (the
matmul weights, in the order the JAX program consumes them) is replaced
in place by a ``QuantizedDense`` holding the int8 / fp8 weight and its
float32 scale plane (``kernels.quant_matmul.quantize_weight``), run by
the K11 kernel on CUDA. The float original is dropped, so the memory
win is real. Since the predictor and the generation engine share the
module tree, they share one set of quantized weights.

Eligibility and the report follow the JAX function row for row: the
quantized weights with their shapes and bytes, and the skip reasons in
the same words (the ``tok_emb`` / ``pos_emb`` tables are "never
consumed as a matmul right-hand operand"). A second call is a no-op
that checks the mode and block: decoding one format's bytes as another
would be silent garbage, so a mismatch raises.

Opt-in is the ``quantize_weights`` flag ("off" | "int8" | "int8_block"
| "fp8"), read at Predictor construction
(``Config.enable_weight_quantization`` overrides it per instance) and by
the GenerationEngine (``quantize_weights=``). ``calibrate`` (the w8a8
activation observers over a Program) is not ported (ROADMAP A7).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..kernels.quant_matmul import (DEFAULT_BLOCK, QUANT_MODES,
                                    quantize_weight, quantized_weight_bytes)

__all__ = ["rewrite_for_inference", "QuantizeReport", "QUANT_MODES",
           "DEFAULT_BLOCK"]

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

    def to_dict(self) -> Dict[str, Any]:
        return {"summary": self.summary(), "vars": list(self.rows)}


def rewrite_for_inference(model, wdtype: str = "int8",
                          block: int = DEFAULT_BLOCK,
                          min_elements: int = 0) -> QuantizeReport:
    """Quantize every eligible matmul weight of ``model`` (a ``GPTLM``)
    in place, on the weights' device; returns the ``QuantizeReport``.
    Idempotent; raises ValueError when the model already holds weights
    quantized with another mode or block."""
    if wdtype not in QUANT_MODES:
        raise ValueError(
            f"rewrite_for_inference: wdtype must be one of {QUANT_MODES} "
            f"(or gate on the 'off' flag value before calling), "
            f"got {wdtype!r}")
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
