"""Automatic NCHW -> NHWC layout conversion pass: the port's copy of
``paddle_tpu/transpiler/layout.py``, with the same rules.

The reference converts layouts with IR passes and a data-layout-transfer
runtime (framework/data_layout_transform.cc, the mkldnn layout passes);
here the same idea is a program-rewriting pass: users keep NCHW model
code, ``auto_nhwc(program)`` flips every conv / pool / batch_norm region
to NHWC and inserts transposes only at region boundaries (feeds, fc /
matmul anchors; fetches of 4-D intermediates come back channels-last,
scalar losses are unchanged).

On the card this is the path to cuDNN's channels-last kernels: the
port's NHWC conv, pool and batch-norm lowerings hand cuDNN the NHWC
tensor as a channels-last-strided NCHW view (``ops/nn.py`` ``_nchw``),
so no layout transpose runs around each convolution. cuDNN's autograd
then returns filter gradients in channels-last strides; the fused
optimizer ops take them contiguous (``ops/optim.py``), as K10 / K10m
require.

Contract: run on the FORWARD program, before append_backward / minimize
(grad ops copy forward attrs at creation; the autograd of the flipped
forward then gives the gradients).
"""

from __future__ import annotations

from ..core.framework import OpRole, Program, unique_name

# op type -> layout attr name
_FLIPPABLE = {
    "conv2d": ("data_format", "Input", "Output"),
    "depthwise_conv2d": ("data_format", "Input", "Output"),
    "conv2d_transpose": ("data_format", "Input", "Output"),
    "pool2d": ("data_format", "X", "Out"),
    "batch_norm": ("data_layout", "X", "Y"),
    "sync_batch_norm": ("data_layout", "X", "Y"),
    "group_norm": ("data_layout", "X", "Y"),
}

# elementwise/unary ops that are layout-agnostic when all 4D operands
# share the region layout
_UNARY_PASS = {
    "relu", "relu6", "gelu", "sigmoid", "tanh", "leaky_relu", "elu",
    "swish", "hard_swish", "hard_sigmoid", "softplus", "dropout",
    "scale", "cast", "sqrt", "square", "abs", "exp", "pow", "clip",
}
_EW_PASS = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
}

_TO_NHWC = [0, 2, 3, 1]
_TO_NCHW = [0, 3, 1, 2]


def _is4d(block, name):
    v = block.vars.get(name)
    return v is not None and v.shape is not None and len(v.shape) == 4


def auto_nhwc(program: Program) -> int:
    """Rewrite in place; returns the number of ops flipped to NHWC.
    Raises if the program already has backward/optimize ops."""
    block = program.global_block()
    for op in block.ops:
        if int(op.attrs.get("op_role", 0)) & (OpRole.Backward | OpRole.Optimize):
            raise ValueError(
                "auto_nhwc must run on the forward program, before "
                "append_backward/minimize (grad ops copy forward attrs)")

    nhwc = set()        # var names currently holding NHWC values
    new_ops = []
    flipped = 0
    trans_cache = {}    # (name, to_nhwc) -> transposed var name

    def _permute_meta(name):
        v = block.vars.get(name)
        if v is not None and v.shape is not None and len(v.shape) == 4:
            s = list(v.shape)
            v.shape = (s[0], s[2], s[3], s[1])

    def _transpose(name, to_nhwc):
        """Emit a transpose2 of `name`; returns the new var name."""
        perm = _TO_NHWC if to_nhwc else _TO_NCHW
        src = block.vars.get(name)
        shp = None
        if src is not None and src.shape is not None and len(src.shape) == 4:
            shp = tuple(src.shape[p] for p in perm)
        suffix = "nhwc" if to_nhwc else "nchw"
        out = block.create_var(
            name=unique_name.generate(f"{name}.{suffix}"), shape=shp,
            dtype=getattr(src, "dtype", "float32"))
        xshape = block.create_var(
            name=unique_name.generate(f"{name}.{suffix}.xshape"),
            shape=(0,), dtype=getattr(src, "dtype", "float32"),
            stop_gradient=True)
        from ..core.framework import Operator

        top = Operator(block, "transpose2",
                       attrs={"axis": list(perm)})
        top.inputs = {"X": [name]}
        top.outputs = {"Out": [out.name], "XShape": [xshape.name]}
        new_ops.append(top)
        return out.name

    def _ensure(name, want_nhwc):
        """Return a var name holding `name`'s value in the wanted
        layout, inserting (and memoizing) a transpose when needed."""
        if (name in nhwc) == want_nhwc:
            return name
        key = (name, want_nhwc)
        if key not in trans_cache:
            trans_cache[key] = _transpose(name, to_nhwc=want_nhwc)
        return trans_cache[key]

    for op in block.ops:
        t = op.type
        if t in _FLIPPABLE:
            attr_name, in_slot, out_slot = _FLIPPABLE[t]
            xname = op.inputs.get(in_slot, [None])[0]
            cur = op.attrs.get(attr_name, "NCHW")
            if cur != "NCHW" or xname is None or not (
                    _is4d(block, xname) or xname in nhwc):
                new_ops.append(op)
                continue
            op.inputs[in_slot] = [_ensure(xname, True)] + \
                op.inputs[in_slot][1:]
            op.attrs[attr_name] = "NHWC"
            flipped += 1
            for oname in op.outputs.get(out_slot, []):
                nhwc.add(oname)
                _permute_meta(oname)
            new_ops.append(op)
        elif t in _UNARY_PASS:
            xname = op.inputs.get("X", [None])[0]
            if xname in nhwc:
                # unary ops preserve shape, so a channels-last input
                # makes every output channels-last at run time: mark
                # them even when shape metadata is missing (an unmarked
                # NHWC var would reach a later anchor as NCHW)
                for names in op.outputs.values():
                    for oname in names:
                        nhwc.add(oname)
                        _permute_meta(oname)
            new_ops.append(op)
        elif t in _EW_PASS:
            xs = op.inputs.get("X", [])
            ys = op.inputs.get("Y", [])
            four_d = [n for n in xs + ys
                      if _is4d(block, n) or n in nhwc]

            def _rank(n):
                v = block.vars.get(n)
                return (len(v.shape) if v is not None and v.shape is not None
                        else None)

            # only two broadcast shapes are relayout-safe: both
            # operands 4D (same layout flip) or a [C] Y at axis=1
            # (channel axis moves 1 -> 3). Anything else — [C,H,W] at
            # axis=1, [H,W] at axis=2, unknown ranks — falls through
            # to the anchor path below (restore NCHW) instead of
            # silently miscompiling the broadcast.
            y_ok = (not ys or ys[0] in four_d
                    or (_rank(ys[0]) == 1
                        and int(op.attrs.get("axis", -1)) == 1))
            if any(n in nhwc for n in four_d) and y_ok:
                op.inputs["X"] = [
                    _ensure(n, True) if (n in four_d or n in nhwc) else n
                    for n in xs]
                op.inputs["Y"] = [
                    _ensure(n, True) if (n in four_d or n in nhwc) else n
                    for n in ys]
                # [C] bias broadcast into the channel axis moves 1 -> 3
                if int(op.attrs.get("axis", -1)) == 1 and ys and \
                        not _is4d(block, ys[0]) and ys[0] not in nhwc:
                    op.attrs["axis"] = 3
                for names in op.outputs.values():
                    for oname in names:
                        nhwc.add(oname)
                        _permute_meta(oname)
                new_ops.append(op)
            else:
                for slot, names in op.inputs.items():
                    op.inputs[slot] = [
                        _ensure(n, False) if n in nhwc else n
                        for n in names]
                new_ops.append(op)
        else:
            # anchor op: restore NCHW for any region input it consumes
            for slot, names in op.inputs.items():
                op.inputs[slot] = [
                    _ensure(n, False) if n in nhwc else n for n in names]
            new_ops.append(op)

    block.ops = new_ops
    program.version += 1
    return flipped
