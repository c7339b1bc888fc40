"""Legacy Evaluator API, in-graph accumulated metrics: the port's copy
of ``paddle_tpu/evaluator.py``.

Reference: python/paddle/fluid/evaluator.py:45 (Evaluator base, state
vars updated per batch inside the main program), :127 ChunkEvaluator,
:218 EditDistance, :299 DetectionMAP. The constructor appends the
metric op and the accumulator updates to the current main program,
``eval(exe)`` reads the state vars, ``reset(exe)`` zeroes them.
"""

from __future__ import annotations

import numpy as np

from .core.framework import Program, program_guard
from .layer_helper import LayerHelper

__all__ = ["Evaluator", "ChunkEvaluator", "EditDistance", "DetectionMAP"]


class Evaluator:
    """Base: tracks persistable state vars in the main program's scope."""

    def __init__(self, name):
        self.helper = LayerHelper(name)
        self.states = []
        self.metrics = []

    def _create_state(self, suffix, dtype="float32", shape=(1,)):
        block = self.helper.main_program.global_block()
        from .core.framework import unique_name

        var = block.create_var(
            name=unique_name.generate(f"{self.helper.name}.{suffix}"),
            dtype=dtype, shape=tuple(shape), persistable=True,
            stop_gradient=True,
        )
        # zero-init in startup so first run has a value
        sblock = self.helper.startup_program.global_block()
        sv = sblock.create_var(name=var.name, dtype=dtype,
                               shape=tuple(shape), persistable=True)
        sblock.append_op(type="fill_constant", outputs={"Out": [sv]},
                         attrs={"shape": list(shape), "dtype": dtype,
                                "value": 0.0})
        self.states.append(var)
        return var

    def _accumulate(self, state, batch_value):
        """state += batch_value, in the main program."""
        block = self.helper.main_program.current_block()
        block.append_op(
            type="elementwise_add",
            inputs={"X": [state], "Y": [batch_value]},
            outputs={"Out": [state]},
        )

    def reset(self, executor, reset_program=None):
        if reset_program is None:
            reset_program = Program()
        with program_guard(reset_program):
            block = reset_program.global_block()
            for state in self.states:
                v = block.create_var(name=state.name, dtype=state.dtype,
                                     shape=state.shape, persistable=True)
                block.append_op(
                    type="fill_constant", outputs={"Out": [v]},
                    attrs={"shape": list(state.shape or (1,)),
                           "dtype": state.dtype, "value": 0.0})
        executor.run(reset_program, fetch_list=[])

    def eval(self, executor, eval_program=None):
        raise NotImplementedError


class ChunkEvaluator(Evaluator):
    """Accumulated chunk precision/recall/F1 (reference evaluator.py:127
    over operators/chunk_eval_op)."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, seq_length=None):
        super().__init__("chunk_evaluator")
        block = self.helper.main_program.current_block()
        outs = {}
        for slot in ("Precision", "Recall", "F1-Score", "NumInferChunks",
                     "NumLabelChunks", "NumCorrectChunks"):
            outs[slot] = [block.create_var(
                name=f"{self.helper.name}.{slot.lower()}",
                stop_gradient=True)]
        inputs = {"Inference": [input], "Label": [label]}
        if seq_length is not None:
            inputs["SeqLength"] = [seq_length]
        block.append_op(
            type="chunk_eval", inputs=inputs, outputs=outs,
            attrs={"chunk_scheme": chunk_scheme,
                   "num_chunk_types": num_chunk_types,
                   "excluded_chunk_types": excluded_chunk_types or []},
        )
        self.num_infer_chunks = self._create_state("num_infer")
        self.num_label_chunks = self._create_state("num_label")
        self.num_correct_chunks = self._create_state("num_correct")
        for state, slot in ((self.num_infer_chunks, "NumInferChunks"),
                            (self.num_label_chunks, "NumLabelChunks"),
                            (self.num_correct_chunks, "NumCorrectChunks")):
            cast = block.create_var(name=f"{outs[slot][0].name}.f32",
                                    stop_gradient=True)
            block.append_op(type="cast", inputs={"X": outs[slot]},
                            outputs={"Out": [cast]},
                            attrs={"out_dtype": "float32"})
            self._accumulate(state, cast)
        self.metrics = [outs["Precision"][0], outs["Recall"][0],
                        outs["F1-Score"][0]]

    def eval(self, executor, eval_program=None):
        from .core.executor import global_scope

        sc = global_scope()
        infer = float(np.asarray(sc.get_numpy(self.num_infer_chunks.name)))
        label = float(np.asarray(sc.get_numpy(self.num_label_chunks.name)))
        correct = float(np.asarray(sc.get_numpy(self.num_correct_chunks.name)))
        precision = correct / infer if infer else 0.0
        recall = correct / label if label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return np.array(precision), np.array(recall), np.array(f1)


class EditDistance(Evaluator):
    """Accumulated average edit distance + exact-match ratio (reference
    evaluator.py:218 over operators/edit_distance_op)."""

    def __init__(self, input, label, ignored_tokens=None):
        super().__init__("edit_distance")
        block = self.helper.main_program.current_block()
        dist = block.create_var(name=f"{self.helper.name}.dist",
                                stop_gradient=True)
        seq_num = block.create_var(name=f"{self.helper.name}.seq_num",
                                   stop_gradient=True)
        block.append_op(
            type="edit_distance",
            inputs={"Hyps": [input], "Refs": [label]},
            outputs={"Out": [dist], "SequenceNum": [seq_num]},
            attrs={"normalized": False},
        )
        self.total_distance = self._create_state("total_dist")
        self.seq_num = self._create_state("total_seqs")
        self.instance_error = self._create_state("errors")

        sum_dist = block.create_var(name=f"{self.helper.name}.sum_dist",
                                    stop_gradient=True)
        block.append_op(type="reduce_sum", inputs={"X": [dist]},
                        outputs={"Out": [sum_dist]},
                        attrs={"dim": [0], "keep_dim": True})
        self._accumulate(self.total_distance, sum_dist)

        nz = block.create_var(name=f"{self.helper.name}.nonzero",
                              stop_gradient=True)
        gz = block.create_var(name=f"{self.helper.name}.gz",
                              stop_gradient=True)
        block.append_op(type="greater_than",
                        inputs={"X": [dist],
                                "Y": [_zeros_like(block, dist, self.helper)]},
                        outputs={"Out": [gz]})
        castv = block.create_var(name=f"{self.helper.name}.gzf",
                                 stop_gradient=True)
        block.append_op(type="cast", inputs={"X": [gz]},
                        outputs={"Out": [castv]},
                        attrs={"out_dtype": "float32"})
        block.append_op(type="reduce_sum", inputs={"X": [castv]},
                        outputs={"Out": [nz]},
                        attrs={"dim": [0], "keep_dim": True})
        self._accumulate(self.instance_error, nz)

        snf = block.create_var(name=f"{self.helper.name}.snf",
                               stop_gradient=True)
        block.append_op(type="cast", inputs={"X": [seq_num]},
                        outputs={"Out": [snf]},
                        attrs={"out_dtype": "float32"})
        self._accumulate(self.seq_num, snf)
        self.metrics = [dist, seq_num]

    def eval(self, executor, eval_program=None):
        from .core.executor import global_scope

        sc = global_scope()
        total = float(np.asarray(sc.get_numpy(self.total_distance.name)))
        n = float(np.asarray(sc.get_numpy(self.seq_num.name)))
        err = float(np.asarray(sc.get_numpy(self.instance_error.name)))
        avg = total / n if n else 0.0
        ratio = err / n if n else 0.0
        return np.array(avg), np.array(ratio)


def _zeros_like(block, ref, helper):
    from .core.framework import unique_name

    v = block.create_var(name=unique_name.generate(f"{helper.name}.zeros"),
                         stop_gradient=True)
    block.append_op(type="fill_zeros_like", inputs={"X": [ref]},
                    outputs={"Out": [v]})
    return v


class DetectionMAP(Evaluator):
    """Per-batch mAP through the ``detection_map`` op (reference
    evaluator.py:299), averaged over batches on the host, as JAX's: the
    op computes each batch's mAP in full, and ``eval`` returns the mean
    of the batches' values."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        super().__init__("detection_map")
        block = self.helper.main_program.current_block()
        label_parts = [gt_label, gt_box]
        if gt_difficult is not None:
            label_parts.insert(1, gt_difficult)
        label = block.create_var(name=f"{self.helper.name}.label",
                                 stop_gradient=True)
        block.append_op(type="concat", inputs={"X": label_parts},
                        outputs={"Out": [label]}, attrs={"axis": 1})
        outs = {n: [block.create_var(name=f"{self.helper.name}.{n}",
                                     stop_gradient=True)]
                for n in ("MAP", "AccumPosCount", "AccumTruePos",
                          "AccumFalsePos")}
        block.append_op(
            type="detection_map",
            inputs={"DetectRes": [input], "Label": [label]},
            outputs=outs,
            attrs={"class_num": class_num or 21,
                   "overlap_threshold": overlap_threshold,
                   "ap_type": ap_version,
                   "background_label": background_label,
                   "evaluate_difficult": bool(evaluate_difficult),
                   "has_difficult": gt_difficult is not None})
        self.cur_map = outs["MAP"][0]
        self._sum = self._create_state("map_sum")
        self._count = self._create_state("map_count")
        self._accumulate(self._sum, self.cur_map)
        one = block.create_var(name=f"{self.helper.name}.one",
                               stop_gradient=True)
        block.append_op(type="fill_constant", outputs={"Out": [one]},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": 1.0})
        self._accumulate(self._count, one)
        self.metrics = [self.cur_map]

    def eval(self, executor, eval_program=None):
        from .core.executor import global_scope

        sc = global_scope()
        s = float(np.asarray(sc.get_numpy(self._sum.name)).reshape(-1)[0])
        c = float(np.asarray(sc.get_numpy(self._count.name)).reshape(-1)[0])
        return np.array(s / c if c else 0.0)
