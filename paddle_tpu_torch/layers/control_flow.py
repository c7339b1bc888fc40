"""Control-flow layers: the port's copy of
``paddle_tpu/layers/control_flow.py`` (:1-300; Fluid's
python/paddle/fluid/layers/control_flow.py): ``increment``, the
comparisons, the dense tensor arrays, ``While``, ``Switch`` and
``cond``. ``While`` and each ``Switch`` case append a ``while`` /
``conditional_block`` op over a sub-block, which the Executor runs
through ``core/control_flow.py``; ``cond`` traces both branches and
selects with ``where``, as the JAX package does.

``StaticRNN`` and ``DynamicRNN`` (:304-654) append one ``recurrent`` op
over their step block (``ops/rnn.py``).
"""

from __future__ import annotations

import contextlib

from ..core.framework import default_main_program, unique_name
from ..layer_helper import LayerHelper

__all__ = [
    "increment", "create_array", "array_write", "array_read", "array_length",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "While", "Switch", "cond", "StaticRNN", "DynamicRNN",
]


def _compare(op_type, x, y, out=None):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype="bool", shape=x.shape, stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                        shape=x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def create_array(dtype, capacity, elem_shape):
    """A dense tensor array [capacity, *elem_shape] of zeros. Fluid's
    array grows on write; a dense one declares its capacity (the loop's
    trip count), as in JAX."""
    from .tensor import fill_constant

    helper = LayerHelper("create_array")
    # gradients flow through writes back to what was written
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(capacity,) + tuple(elem_shape),
        stop_gradient=False)
    return fill_constant([capacity] + list(elem_shape), dtype, 0.0, out=out)


def array_write(x, i, array=None, capacity=None):
    """A[i] = x (Fluid's tensor_array_read_write_op.cc write_to_array).
    ``array=None`` allocates a new array and needs ``capacity``."""
    helper = LayerHelper("array_write")
    inputs = {"X": [x], "I": [i]}
    if array is not None:
        inputs["Array"] = [array]
        out = array     # read-then-write of one name: a loop carry
    else:
        if capacity is None:
            raise ValueError(
                "array_write(array=None) needs an explicit capacity: dense "
                "tensor arrays are fixed-size (use create_array)")
        out = helper.create_variable_for_type_inference(
            dtype=x.dtype, shape=(capacity,) + tuple(x.shape or ()))
    helper.append_op(type="write_to_array", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"capacity": int(capacity or 0)})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(
        dtype="int64", shape=(1,), stop_gradient=True)
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def array_read(array, i):
    """out = A[i] (Fluid's tensor_array_read_write_op.cc)."""
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(
        dtype=array.dtype, shape=tuple((array.shape or (1,))[1:]))
    helper.append_op(type="read_from_array", inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


@contextlib.contextmanager
def _sub_block(op_type, inputs, attrs):
    """Ops appended inside go to a new block; on exit one ``op_type`` op
    over it joins the parent block."""
    prog = default_main_program()
    parent = prog.current_block()
    sub = prog._create_block()
    try:
        yield
    finally:
        prog._rollback()
        parent.append_op(type=op_type, inputs=inputs, outputs={},
                         attrs={"sub_block": sub, **attrs})
        prog._bump()


class While:
    """Fluid's While::

        loop = While(cond_var)
        with loop.block():
            ...ops...
            layers.assign(new_cond, cond_var)

    The loop's state is what the block writes of the names that exist
    before it (``core/control_flow.py``)."""

    def __init__(self, cond, is_test=False, name=None):
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)

    def block(self):
        return _sub_block("while", {"Condition": [self.cond_var]},
                          {"is_test": False})


class Switch:
    """Fluid's Switch: the FIRST case whose condition holds runs; the
    default runs only when none did. Each case is a conditional_block
    whose predicate is (cond AND NOT any earlier case)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._matched = None    # bool var: an earlier case fired

    def _effective_cond(self, condition):
        helper = LayerHelper("switch_case")
        if self._matched is None:
            self._matched = condition
            return condition

        def new_bool():
            return helper.create_variable_for_type_inference(
                dtype="bool", shape=condition.shape, stop_gradient=True)

        not_prev = new_bool()
        helper.append_op(type="logical_not", inputs={"X": [self._matched]},
                         outputs={"Out": [not_prev]})
        eff = new_bool()
        helper.append_op(type="logical_and",
                         inputs={"X": [condition], "Y": [not_prev]},
                         outputs={"Out": [eff]})
        new_matched = new_bool()
        helper.append_op(type="logical_or",
                         inputs={"X": [self._matched], "Y": [condition]},
                         outputs={"Out": [new_matched]})
        self._matched = new_matched
        return eff

    def case(self, condition):
        return _sub_block("conditional_block",
                          {"Cond": [self._effective_cond(condition)]},
                          {"is_scalar_condition": True})

    def default(self):
        from .tensor import fill_constant

        return self.case(fill_constant([1], "bool", 1.0))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Both branches are traced and ``where`` selects (the later API's
    layers.cond, as the JAX package builds it). Branches return
    Variables of one shape."""
    from .nn import cast, where

    t = true_fn() if true_fn is not None else None
    f = false_fn() if false_fn is not None else None
    if t is None or f is None:
        return t if t is not None else f
    return where(cast(pred, "bool"), t, f)


class StaticRNN:
    """User-authored recurrent block over a fixed number of steps.

    Reference: python/paddle/fluid/layers/control_flow.py StaticRNN
    (backed by operators/recurrent_op.cc). Inputs are time-major
    [T, B, ...]; the step block built inside ``with rnn.step():`` runs
    once a time step under the ``recurrent`` op (ops/rnn.py), and its
    gradient comes from autograd through the recorded loop.
    """

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self._sub_block = None
        self._step_inputs = []      # (parent seq var, in-block var)
        self._memories = []         # dicts: pre var, init var/spec, updated name
        self._outputs = []          # in-block vars
        self.seq_len = None

    def step(self):
        import contextlib

        prog = self.helper.main_program

        @contextlib.contextmanager
        def _ctx():
            self._sub_block = prog._create_block()
            self.status = StaticRNN.IN_RNN_BLOCK
            try:
                yield
            finally:
                prog._rollback()
                self.status = StaticRNN.AFTER_RNN_BLOCK
                self._complete()

        return _ctx()

    def _assert_in_rnn_block(self, method):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError(f"You must invoke {method} in rnn.step()")

    def step_input(self, x):
        self._assert_in_rnn_block("step_input")
        if self.seq_len is None:
            self.seq_len = x.shape[0]
        ipt = self._sub_block.create_var(
            name=unique_name.generate(f"{self.helper.name}.step_in"),
            shape=tuple(x.shape[1:]) if x.shape else None,
            dtype=x.dtype,
        )
        self._step_inputs.append((x, ipt))
        return ipt

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=None):
        """ref_batch_dim_idx indexes batch_ref AS THE CALLER SEES IT
        (slice-relative for a step var). Default None = auto: dim 0 of
        a sliced step var, dim 1 of a full [T, B, ...] sequence."""
        self._assert_in_rnn_block("memory")
        if init is None and (shape is None or batch_ref is None):
            raise ValueError(
                "if init is None, memory at least needs shape and batch_ref")
        if init is not None:
            mshape, mdtype = tuple(init.shape or ()), init.dtype
        else:
            # keep a placeholder batch dim: downstream layers size
            # weights from shape[1:]
            mshape = tuple(1 if (s is None or s <= 0) else s for s in shape)
            mdtype = "float32"
        pre = self._sub_block.create_var(
            name=unique_name.generate(f"{self.helper.name}.mem"),
            shape=mshape, dtype=mdtype,
        )
        self._memories.append({
            "pre": pre, "init": init, "shape": shape, "batch_ref": batch_ref,
            "value": init_value, "init_dim": init_batch_dim_idx,
            "ref_dim": ref_batch_dim_idx, "updated": None,
        })
        return pre

    def update_memory(self, mem, var):
        self._assert_in_rnn_block("update_memory")
        for m in self._memories:
            if m["pre"] is mem or m["pre"].name == mem.name:
                m["updated"] = var
                return
        raise ValueError(f"{mem.name} is not a memory of this StaticRNN")

    def step_output(self, o):
        self._assert_in_rnn_block("step_output")
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        from .tensor import fill_constant_batch_size_like

        block = self.helper.main_program.current_block()  # parent
        sub = self._sub_block
        for m in self._memories:
            if m["updated"] is None:
                raise ValueError(f"memory {m['pre'].name} was never updated "
                                 "(call rnn.update_memory)")
        # init vars (parent block): explicit init or batch-ref fill
        in_block_to_parent = {v.name: x for x, v in self._step_inputs}
        init_vars = []
        for m in self._memories:
            if m["init"] is not None:
                init_vars.append(m["init"])
            else:
                ref, ref_dim = m["batch_ref"], m["ref_dim"]
                if ref.name in in_block_to_parent:
                    # user pointed at the sliced step var; the init op
                    # runs in the parent block, so use the full [T,...]
                    # sequence and shift the batch dim past the T axis
                    ref = in_block_to_parent[ref.name]
                    ref_dim = 1 if ref_dim is None else ref_dim + 1
                elif ref_dim is None:
                    ref_dim = 1
                init_vars.append(fill_constant_batch_size_like(
                    ref,
                    [s if s and s > 0 else 1 for s in m["shape"]],
                    "float32", m["value"],
                    input_dim_idx=ref_dim, output_dim_idx=m["init_dim"],
                ))
        # externals: names read in the sub block but produced neither
        # there nor by slicing/memory links (fc weights etc.)
        produced = {n for op_ in sub.ops for ns in op_.outputs.values() for n in ns}
        bound = ({v.name for _, v in self._step_inputs}
                 | {m["pre"].name for m in self._memories})
        ext = []
        for op_ in sub.ops:
            for ns in op_.inputs.values():
                for n in ns:
                    if n not in produced and n not in bound and n not in ext:
                        ext.append(n)

        T = self.seq_len
        out_vars = []
        for o in self._outputs:
            out_vars.append(block.create_var(
                name=unique_name.generate(f"{self.helper.name}.out"),
                shape=(T,) + tuple(o.shape or ()), dtype=o.dtype,
            ))
        final_mems = [
            block.create_var(
                name=unique_name.generate(f"{self.helper.name}.final_mem"),
                shape=tuple(m["pre"].shape or ()), dtype=m["pre"].dtype,
            )
            for m in self._memories
        ]
        block.append_op(
            type="recurrent",
            inputs={
                "StepInputs": [x for x, _ in self._step_inputs],
                "InitMemories": init_vars,
                "Parameters": ext,
            },
            outputs={"StepOutputs": out_vars, "FinalMemories": final_mems},
            attrs={
                "sub_block": sub,
                "step_input_names": [v.name for _, v in self._step_inputs],
                "pre_memory_names": [m["pre"].name for m in self._memories],
                "memory_names": [m["updated"].name for m in self._memories],
                "step_output_names": [o.name for o in self._outputs],
                "parameter_names": list(ext),
                "time_major": True,
            },
        )
        self.helper.main_program._bump()
        self._out_vars = out_vars

    def __call__(self, *args, **kwargs):
        if self.status != StaticRNN.AFTER_RNN_BLOCK:
            raise ValueError("rnn output can only be retrieved after rnn.step()")
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars


class DynamicRNN:
    """Recurrent block over variable-length batch-major sequences.

    Reference: python/paddle/fluid/layers/control_flow.py DynamicRNN
    (LoD-based shrinking batches). Dense form: inputs are [B, T, ...]
    plus a per-row length; finished rows keep their memories and emit
    zeros (ops/rnn.py ``recurrent``, time_major=False). ``drnn()``
    returns [B, T, ...] outputs.
    """

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self._sub_block = None
        self._step_inputs = []
        self._static_inputs = []
        self._memories = []
        self._outputs = []
        self._lengths = None
        self.max_len = None

    def block(self):
        import contextlib

        prog = self.helper.main_program

        @contextlib.contextmanager
        def _ctx():
            self._sub_block = prog._create_block()
            self.status = DynamicRNN.IN_RNN
            try:
                yield
            finally:
                prog._rollback()
                self.status = DynamicRNN.AFTER_RNN
                self._complete()

        return _ctx()

    def step_input(self, x, length=None, level=0):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("step_input must be called in drnn.block()")
        if self.max_len is None:
            self.max_len = x.shape[1]
        if length is not None:
            self._lengths = length
        ipt = self._sub_block.create_var(
            name=unique_name.generate(f"{self.helper.name}.step_in"),
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=x.dtype,
        )
        self._step_inputs.append((x, ipt))
        return ipt

    def static_input(self, x):
        """Per-sequence constant input (reference reorders by LoD rank;
        dense batches keep row order, so it passes through)."""
        return x

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("memory must be called in drnn.block()")
        if init is not None:
            mshape, mdtype = tuple(init.shape or ()), init.dtype
        else:
            if not self._step_inputs:
                raise ValueError("call step_input before value-initialized memory")
            batch = self._step_inputs[0][0].shape[0]
            mshape = (batch,) + tuple(s for s in (shape or []) if s and s > 0)
            mdtype = dtype
        pre = self._sub_block.create_var(
            name=unique_name.generate(f"{self.helper.name}.mem"),
            shape=mshape, dtype=mdtype,
        )
        self._memories.append({"pre": pre, "init": init, "shape": shape,
                               "value": value, "updated": None})
        return pre

    def update_memory(self, mem, var):
        for m in self._memories:
            if m["pre"] is mem or m["pre"].name == mem.name:
                m["updated"] = var
                return
        raise ValueError(f"{mem.name} is not a memory of this DynamicRNN")

    def output(self, *outputs):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("output must be called in drnn.block()")
        self._outputs.extend(outputs)

    def _complete(self):
        from .tensor import fill_constant_batch_size_like

        block = self.helper.main_program.current_block()
        sub = self._sub_block
        for m in self._memories:
            if m["updated"] is None:
                raise ValueError(f"memory {m['pre'].name} never updated")
        init_vars = []
        for m in self._memories:
            if m["init"] is not None:
                init_vars.append(m["init"])
            else:
                ref = self._step_inputs[0][0]
                init_vars.append(fill_constant_batch_size_like(
                    ref, [1] + [s for s in (m["shape"] or []) if s and s > 0],
                    "float32", m["value"], input_dim_idx=0, output_dim_idx=0,
                ))
        produced = {n for op_ in sub.ops for ns in op_.outputs.values() for n in ns}
        bound = ({v.name for _, v in self._step_inputs}
                 | {m["pre"].name for m in self._memories})
        ext = []
        for op_ in sub.ops:
            for ns in op_.inputs.values():
                for n in ns:
                    if n not in produced and n not in bound and n not in ext:
                        ext.append(n)
        out_vars = []
        for o in self._outputs:
            oshape = tuple(o.shape or ())
            out_vars.append(block.create_var(
                name=unique_name.generate(f"{self.helper.name}.out"),
                shape=(oshape[0], self.max_len) + oshape[1:], dtype=o.dtype,
            ))
        final_mems = [
            block.create_var(
                name=unique_name.generate(f"{self.helper.name}.final_mem"),
                shape=tuple(m["pre"].shape or ()), dtype=m["pre"].dtype,
            )
            for m in self._memories
        ]
        inputs = {
            "StepInputs": [x for x, _ in self._step_inputs],
            "InitMemories": init_vars,
            "Parameters": ext,
        }
        if self._lengths is not None:
            inputs["SeqLengths"] = [self._lengths]
        block.append_op(
            type="recurrent",
            inputs=inputs,
            outputs={"StepOutputs": out_vars, "FinalMemories": final_mems},
            attrs={
                "sub_block": sub,
                "step_input_names": [v.name for _, v in self._step_inputs],
                "pre_memory_names": [m["pre"].name for m in self._memories],
                "memory_names": [m["updated"].name for m in self._memories],
                "step_output_names": [o.name for o in self._outputs],
                "parameter_names": list(ext),
                "time_major": False,
            },
        )
        self.helper.main_program._bump()
        self._out_vars = out_vars

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("drnn output only after drnn.block()")
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars
