"""The port's copy of ``paddle_tpu/layers/extras.py``: compositions
completing the reference's layer names (Fluid's layers/{control_flow,
detection,io,nn,loss}.py, where they are Python compositions too):
``Print``, the step counter, the select-based control-flow sugar
(``case``, ``switch_case``, ``IfElse``: both branches run over the whole
batch and ``where`` merges them) and ``while_loop`` over ``While``, the
CTC greedy decoder, ``dice_loss``, ``crop`` / ``eye`` / ``scatter_nd``,
``image_resize_short``, ``load``, ``lod_append``, the sampled softmax,
``switch_moe`` (:478-535), the reader sugar over
``reader.GeneratorLoader`` (:399-437) and the SSD layers over
``models.ssd`` (:443-475)."""

from __future__ import annotations

import contextlib

from ..core.framework import unique_name
from ..initializer import ConstantInitializer, XavierInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .nn import _out

__all__ = ["switch_moe", "py_reader", "create_py_reader_by_data",
           "double_buffer", "read_file", "sequence_first_step",
           "sequence_last_step",
           "Print", "autoincreased_step_counter", "case", "switch_case",
           "while_loop", "IfElse", "ctc_greedy_decoder", "dice_loss", "eye",
           "image_resize_short", "load", "lod_append", "scatter_nd",
           "sampled_softmax_with_cross_entropy", "rank", "crop",
           "multi_box_head", "ssd_loss", "detection_output"]


def switch_moe(input, num_experts, expert_hidden, capacity_factor=1.25,
               act="gelu", param_attr=None, bias_attr=None, name=None):
    """Switch-transformer MoE FFN (top-1 routing, capacity-bound
    dispatch; ``ops/moe.py``). Returns (out, aux_loss): add ``aux_coeff
    * aux_loss`` to the training loss for load balancing. Its five
    parameters take per-slot copies of the attrs, named ``<name>.gate``,
    ``.w1``, ``.w2`` and ``<bias name>.b1``, ``.b2``."""
    helper = LayerHelper("switch_moe", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)

    def _slot(base, suffix):
        # one shared attr would alias the five parameters once the first
        # create_parameter names it; bias_attr=False means no bias
        # elsewhere, but the op's biases are structural
        a = ParamAttr._to_attr(base if base is not False else None)
        a = ParamAttr(**a.__dict__.copy())
        if a.name is not None:
            a.name = f"{a.name}.{suffix}"
        return a

    d = int(input.shape[-1])
    e, f = int(num_experts), int(expert_hidden)
    wg = helper.create_parameter(
        _slot(helper.param_attr, "gate"), [d, e], input.dtype,
        default_initializer=XavierInitializer())
    w1 = helper.create_parameter(
        _slot(helper.param_attr, "w1"), [e, d, f], input.dtype,
        default_initializer=XavierInitializer())
    b1 = helper.create_parameter(
        _slot(helper.bias_attr, "b1"), [e, f], input.dtype, is_bias=True,
        default_initializer=ConstantInitializer(0.0))
    w2 = helper.create_parameter(
        _slot(helper.param_attr, "w2"), [e, f, d], input.dtype,
        default_initializer=XavierInitializer())
    b2 = helper.create_parameter(
        _slot(helper.bias_attr, "b2"), [e, d], input.dtype, is_bias=True,
        default_initializer=ConstantInitializer(0.0))
    # the tag expert parallelism shards by
    # (CompiledProgram.with_expert_parallel)
    for v in (w1, b1, w2, b2):
        v._moe_expert_param = True
    out = _out(helper, input, shape=input.shape)
    aux = _out(helper, input, shape=(1,))
    helper.append_op(
        type="switch_moe",
        inputs={"X": [input], "GateW": [wg], "ExpertW1": [w1],
                "ExpertB1": [b1], "ExpertW2": [w2], "ExpertB2": [b2]},
        outputs={"Out": [out], "AuxLoss": [aux]},
        attrs={"capacity_factor": float(capacity_factor), "act": act},
    )
    return out, aux


# -- io sugar over the reader machinery -----------------------------------

def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Reference layers/io.py py_reader: a queue-fed reader. Data vars
    are created from ``shapes`` / ``dtypes`` (dim 0 the batch) and
    become the feed list of a ``reader.GeneratorLoader``, whose device
    prefetch is the double buffer."""
    from ..reader import GeneratorLoader
    from .io import data as data_layer

    feed_vars = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        feed_vars.append(data_layer(
            unique_name.generate(f"{name or 'py_reader'}_slot{i}"),
            list(shape[1:]), dtype=dtype))
    return GeneratorLoader(feed_vars, capacity=capacity,
                           use_double_buffer=use_double_buffer)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    from ..reader import GeneratorLoader

    return GeneratorLoader(feed_list, capacity=capacity,
                           use_double_buffer=use_double_buffer)


def double_buffer(reader, place=None, name=None):
    """The GeneratorLoader prefetches to the device already: the reader
    itself, for API parity."""
    return reader


def read_file(reader):
    """The feed vars a py_reader batches into (reference layers/io.py
    read_file returns the reader's output vars)."""
    if hasattr(reader, "feed_list"):
        fl = reader.feed_list
        return list(fl) if len(fl) > 1 else fl[0]
    raise TypeError("read_file expects a py_reader/GeneratorLoader")


def sequence_first_step(input, length=None):
    from .sequence import sequence_pool

    return sequence_pool(input, "first", length=length)


def sequence_last_step(input, length=None):
    from .sequence import sequence_pool

    return sequence_pool(input, "last", length=length)


# -- control-flow sugar and compositions (paddle_tpu/layers/extras.py:27-397)

def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Reference layers/control_flow.py Print (the print op)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="print", inputs={"In": [input]}, outputs={"Out": [out]},
        attrs={"message": message or ""},
    )
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Reference layers/nn.py: persistable int64 counter incremented
    every step the program runs."""
    helper = LayerHelper("step_counter")
    name = counter_name or unique_name.generate("@STEP_COUNTER@")
    block = helper.main_program.global_block()
    counter = block.create_var(name=name, dtype="int64", shape=(1,),
                               persistable=True, stop_gradient=True)
    sblock = helper.startup_program.global_block()
    sv = sblock.create_var(name=name, dtype="int64", shape=(1,),
                           persistable=True)
    sblock.append_op(type="fill_constant", outputs={"Out": [sv]},
                     attrs={"shape": [1], "dtype": "int64",
                            "value": float(begin - step)})
    block.append_op(type="increment", inputs={"X": [counter]},
                    outputs={"Out": [counter]}, attrs={"step": float(step)})
    return counter


def rank(input):
    """Reference layers/nn.py rank: the (static) dimensionality as a
    0-d int constant — shapes are static here, so it is a literal."""
    from .tensor import fill_constant

    return fill_constant([1], "int32", float(len(input.shape or ())))


def _broadcast_bool(pred, template):
    helper = LayerHelper("bcast_pred")
    out = helper.create_variable_for_type_inference(
        dtype="bool", shape=template.shape, stop_gradient=True)
    helper.append_op(
        type="expand_pred_like", inputs={"X": [pred], "Y": [template]},
        outputs={"Out": [out]})
    return out


def case(pred_fn_pairs, default=None, name=None):
    """Functional exclusive cases (reference layers/control_flow.py
    case): the first true predicate's branch value wins. Every branch
    runs and ``where`` selects, as ``layers.cond`` does."""
    from .nn import where

    assert pred_fn_pairs, "case() needs at least one (pred, fn) pair"
    results = [(p, fn()) for p, fn in pred_fn_pairs]
    out = default() if default is not None else results[-1][1]
    for p, v in reversed(results):
        out = where(_broadcast_bool(p, v), v, out)
    return out


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Reference layers/control_flow.py switch_case: select a branch
    value by integer index."""
    from .tensor import fill_constant

    pairs = []
    items = (branch_fns.items() if isinstance(branch_fns, dict)
             else list(enumerate(branch_fns)))
    for idx, fn in items:
        helper = LayerHelper("switch_case")
        iv = fill_constant([1], "int64", float(idx))
        p = helper.create_variable_for_type_inference(
            dtype="bool", shape=(1,), stop_gradient=True)
        helper.append_op(type="equal",
                         inputs={"X": [branch_index], "Y": [iv]},
                         outputs={"Out": [p]})
        pairs.append((p, fn))
    return case(pairs, default=default)


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Functional while (reference layers/control_flow.py while_loop)
    over the While machinery: loop_vars are assigned in place each
    iteration; returns the final loop_vars."""
    from .control_flow import While
    from .tensor import assign

    LayerHelper("while_loop")  # takes its unique name, as in JAX
    cond_var = cond(*loop_vars)
    loop = While(cond_var)
    with loop.block():
        new_vars = body(*loop_vars)
        if not isinstance(new_vars, (list, tuple)):
            new_vars = [new_vars]
        for old, new in zip(loop_vars, new_vars):
            assign(new, old)
        assign(cond(*loop_vars), cond_var)
    return list(loop_vars)


class IfElse:
    """Reference layers/control_flow.py IfElse, dense: both branches run
    over the whole batch and ``output`` merges rows by the condition
    (the reference splits and compacts the rows instead, see
    ``split_lod_tensor``; the same numbers for row-wise programs)."""

    def __init__(self, cond, name=None):
        self._cond = cond
        self._true_outs = None
        self._false_outs = None
        self._phase = None

    def input(self, x):
        return x  # dense: both branches see the full batch

    def true_block(self):
        @contextlib.contextmanager
        def _ctx():
            self._phase = True
            yield
            self._phase = None

        return _ctx()

    def false_block(self):
        @contextlib.contextmanager
        def _ctx():
            self._phase = False
            yield
            self._phase = None

        return _ctx()

    def output(self, *outs):
        if self._phase is True:
            self._true_outs = list(outs)
        elif self._phase is False:
            self._false_outs = list(outs)
        else:
            raise ValueError("IfElse.output() must be called in a block")

    def __call__(self):
        from .nn import where

        assert self._true_outs is not None and self._false_outs is not None
        merged = [
            where(_broadcast_bool(self._cond, t), t, f)
            for t, f in zip(self._true_outs, self._false_outs)
        ]
        return merged if len(merged) > 1 else merged[0]


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """argmax -> collapse repeats -> drop blanks (reference
    layers/nn.py ctc_greedy_decoder over ctc_align). Dense output:
    [B, T] with padding_value tail."""
    helper = LayerHelper("ctc_greedy_decoder")
    # argmax over classes
    idx = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="arg_max", inputs={"X": [input]},
                     outputs={"Out": [idx]}, attrs={"axis": -1})
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    out_len = helper.create_variable_for_type_inference(
        dtype="int64", stop_gradient=True)
    ins = {"Input": [idx]}
    if input_length is not None:
        ins["InputLength"] = [input_length]
    helper.append_op(type="ctc_align", inputs=ins,
                     outputs={"Output": [out], "OutputLength": [out_len]},
                     attrs={"blank": blank, "merge_repeated": True,
                            "padding_value": padding_value})
    if input_length is not None:
        return out, out_len
    return out


def dice_loss(input, label, epsilon=1e-5):
    """Reference layers/nn.py dice_loss: PER-SAMPLE intersection/union
    over the non-batch dims, then mean over samples (pure composition
    there too)."""
    from .nn import (reduce_sum, reduce_mean, cast, elementwise_mul,
                     elementwise_add, elementwise_div, scale)

    label_f = cast(label, input.dtype)
    dims = list(range(1, len(input.shape or (1, 1))))
    inter = reduce_sum(elementwise_mul(input, label_f), dim=dims)
    union = elementwise_add(reduce_sum(input, dim=dims),
                            reduce_sum(label_f, dim=dims))
    dice = elementwise_div(scale(inter, scale=2.0),
                           scale(union, scale=1.0, bias=epsilon))
    return reduce_mean(scale(dice, scale=-1.0, bias=1.0))


def crop(x, shape=None, offsets=None, name=None):
    """Reference layers/nn.py crop: shape may be a Variable (crop to
    its extent) or a list of ints."""
    helper = LayerHelper("crop")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    ins = {"X": [x]}
    attrs = {}
    if shape is not None and not isinstance(shape, (list, tuple)):
        ins["Y"] = [shape]
    elif shape is not None:
        attrs["shape"] = [int(s) for s in shape]
    if offsets is not None:
        attrs["offsets"] = [int(o) for o in offsets]
    helper.append_op(type="crop", inputs=ins, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    helper = LayerHelper("eye")
    nc = num_columns or num_rows
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(num_rows, nc), stop_gradient=True)
    helper.append_op(type="eye", inputs={}, outputs={"Out": [out]},
                     attrs={"num_rows": num_rows, "num_columns": nc,
                            "dtype": dtype})
    if batch_shape:
        # reference: leading batch dims replicate the identity
        cur = out
        for _ in batch_shape:
            helper2 = LayerHelper("eye_expand")
            u = helper2.create_variable_for_type_inference(
                dtype=dtype, stop_gradient=True)
            helper2.append_op(type="unsqueeze", inputs={"X": [cur]},
                              outputs={"Out": [u]}, attrs={"axes": [0]})
            cur = u
        times = list(batch_shape) + [1, 1]
        helper3 = LayerHelper("eye_tile")
        t = helper3.create_variable_for_type_inference(
            dtype=dtype,
            shape=tuple(batch_shape) + (num_rows, nc),
            stop_gradient=True)
        helper3.append_op(type="expand", inputs={"X": [cur]},
                          outputs={"Out": [t]},
                          attrs={"expand_times": times})
        return t
    return out


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the SHORT side equals out_short_len (reference
    layers/nn.py image_resize_short). Static shapes: computed from the
    declared input shape."""
    from .nn import image_resize

    h, w = input.shape[2], input.shape[3]
    short, is_h = (h, True) if h <= w else (w, False)
    scale = out_short_len / float(short)
    oh = out_short_len if is_h else int(round(h * scale))
    ow = int(round(w * scale)) if is_h else out_short_len
    return image_resize(input, out_shape=[oh, ow], resample=resample)


def load(out, file_path, load_as_fp16=False):
    """Reference layers/io.py load: emit a load op restoring `out`."""
    helper = LayerHelper("load_layer")
    helper.append_op(
        type="load", inputs={}, outputs={"Out": [out]},
        attrs={"file_path": file_path,
               "shape": list(out.shape or (1,)),
               "dtype": str(out.dtype)})
    return out


def lod_append(x, level):
    """Reference layers/lod_append: add one LoD level. Dense carrier:
    identity on data (lengths live host-side in LoDTensor)."""
    helper = LayerHelper("lod_append")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="lod_reset", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"target_lod": list(level)
                            if isinstance(level, (list, tuple)) else []})
    return out


def scatter_nd(index, updates, shape, name=None):
    """scatter_nd_add onto zeros (reference layers/nn.py scatter_nd)."""
    from .tensor import fill_constant

    zeros = fill_constant(list(shape), updates.dtype, 0.0)
    zeros.stop_gradient = False
    helper = LayerHelper("scatter_nd")
    out = helper.create_variable_for_type_inference(dtype=updates.dtype)
    helper.append_op(type="scatter_nd_add",
                     inputs={"X": [zeros], "Index": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]})
    return out


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, seed=0):
    """sample_logits -> softmax CE on the sampled subset (reference
    layers/nn.py composition over the same ops)."""
    helper = LayerHelper("sampled_softmax")
    outs = {n: [helper.create_variable_for_type_inference(
        stop_gradient=(n not in ("SampledLogits",)))]
        for n in ("Samples", "Probabilities", "LogitsDim", "LabelsDim",
                  "SampledLogits", "SampledLabels")}
    helper.append_op(
        type="sample_logits",
        inputs={"Logits": [logits], "Labels": [label]},
        outputs=outs, attrs={"num_samples": num_samples, "seed": seed})
    loss = helper.create_variable_for_type_inference()
    sm = helper.create_variable_for_type_inference()
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": outs["SampledLogits"],
                "Label": outs["SampledLabels"]},
        outputs={"Loss": [loss], "Softmax": [sm]},
        attrs={"soft_label": False})
    return loss




# -- the SSD layers over models.ssd (paddle_tpu/layers/extras.py:443-475;
# imported lazily: models imports layers) -------------------------------------

def multi_box_head(inputs, image, num_classes=None, min_sizes=None,
                   max_sizes=None, aspect_ratios=None, base_size=None,
                   **kw):
    from ..models.ssd import multi_box_head as impl

    return impl(inputs, image, num_classes, min_sizes,
                max_sizes=max_sizes, aspect_ratios=aspect_ratios)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, overlap_threshold=0.5, neg_pos_ratio=3.0,
             loc_loss_weight=1.0, conf_loss_weight=1.0, **kw):
    from ..models.ssd import ssd_loss as impl

    return impl(location, confidence, gt_box, gt_label, prior_box,
                prior_box_var, overlap_threshold=overlap_threshold,
                neg_pos_ratio=neg_pos_ratio, loc_weight=loc_loss_weight,
                conf_weight=conf_loss_weight)


def detection_output(loc, scores, prior_box, prior_box_var=None,
                     background_label=0, nms_threshold=0.3,
                     nms_top_k=400, keep_top_k=200, score_threshold=0.01,
                     **kw):
    from ..models.ssd import detection_output as impl

    return impl(loc, scores, prior_box, prior_box_var,
                nms_threshold=nms_threshold,
                score_threshold=score_threshold, keep_top_k=keep_top_k,
                background_label=background_label)
