"""Recurrent ops: torch lowerings with the semantics of
``paddle_tpu/ops/rnn.py``.

The JAX package runs each recurrence as one ``lax.scan`` and takes its
gradient from ``jax.vjp`` through the scan. Here a recurrence is a
Python loop over time that runs torch ops eagerly, one step after the
other; the gradient comes from autograd through the recorded loop
(``core/registry.py``'s tape), as for every other automatic grad op.
The layout is the reference's dense one: ``[B, T, ...]`` tensors with
an optional ``Length`` tensor; a row past its length keeps its state
bit for bit (``torch.where`` selects the old value). Gate order is the
framework's i, f, g, o throughout (``attention_lstm`` keeps the
reference's f, i, o, g).

``recurrent`` is the op under ``layers.StaticRNN`` / ``DynamicRNN``:
its step sub-block runs once a time step through
``executor.lower_ops``, with the memories linked and the step inputs
sliced; everything the sub-block reads from outside arrives through
the ``Parameters`` slot, so that its gradient flows. Each step
launches the step block's ops eagerly: a decoder step of the
attention seq2seq is about 25 launches forward.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _opt(ins, slot):
    return ins[slot][0] if ins.get(slot) else None


def _zeros(b, h, like):
    return torch.zeros((b, h), dtype=like.dtype, device=like.device)


def _alive(t, ln, T, is_reverse):
    """[B, 1] bool: whether the step at loop index ``t`` is inside each
    row (the inputs were flipped under ``is_reverse``)."""
    step = (T - 1 - t) if is_reverse else t
    return (step < ln).reshape(-1, 1)


def _lstm_cell(gates, c, peephole=None, cell_clip=0.0):
    i, f, g, o = gates.chunk(4, dim=-1)
    if peephole is not None:
        w_ic, w_fc, w_oc = peephole
        i = i + w_ic * c
        f = f + w_fc * c
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    if cell_clip:
        c_new = torch.clamp(c_new, -cell_clip, cell_clip)
    if peephole is not None:
        o = o + peephole[2] * c_new
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


@register_op(
    "fused_lstm",
    inputs=("X", "WeightX", "WeightH", "Bias", "H0", "C0", "Length"),
    outputs=("Hidden", "Cell", "LastH", "LastC"),
    no_grad=("Length",),
)
def _fused_lstm(ctx, op, ins):
    x, wx, wh = ins["X"][0], ins["WeightX"][0], ins["WeightH"][0]
    bias = _opt(ins, "Bias")
    B, T, D = x.shape
    H = wh.shape[0]
    h = _opt(ins, "H0")
    c = _opt(ins, "C0")
    h = _zeros(B, H, x) if h is None else h
    c = _zeros(B, H, x) if c is None else c
    ln = _opt(ins, "Length")
    rev = bool(op.attrs.get("is_reverse", False))
    xs = x.transpose(0, 1)
    if rev:
        xs = xs.flip(0)
    xproj = xs.reshape(T * B, D) @ wx
    if bias is not None:
        xproj = xproj + bias
    hs, cs, h, c = _lstm_scan(xproj.reshape(T, B, 4 * H), wh, h, c,
                              lengths=ln, is_reverse=rev)
    if rev:
        hs, cs = hs.flip(0), cs.flip(0)
    return {"Hidden": [hs.transpose(0, 1)], "Cell": [cs.transpose(0, 1)],
            "LastH": [h], "LastC": [c]}


def _gru_scan(xproj, wh, h, origin_mode, ln=None, rev=False):
    """xproj [T, B, 3H] (bias folded in); returns the per-step
    (rz, r*h, h) stacks, time-major, and the last h."""
    T = xproj.shape[0]
    H = wh.shape[0]
    wh_rz, wh_c = wh[:, : 2 * H], wh[:, 2 * H:]
    rzs, rhps, hs = [], [], []
    for t in range(T):
        xp = xproj[t]
        rz = torch.sigmoid(xp[:, : 2 * H] + h @ wh_rz)
        r, z = rz.chunk(2, dim=-1)
        rhp = r * h
        c = torch.tanh(xp[:, 2 * H:] + rhp @ wh_c)
        h_new = z * h + (1 - z) * c if origin_mode else (1 - z) * h + z * c
        if ln is not None:
            h_new = torch.where(_alive(t, ln, T, rev), h_new, h)
        h = h_new
        rzs.append(rz)
        rhps.append(rhp)
        hs.append(h)
    return torch.stack(rzs), torch.stack(rhps), torch.stack(hs), h


@register_op(
    "fused_gru",
    inputs=("X", "WeightX", "WeightH", "Bias", "H0", "Length"),
    outputs=("Hidden", "LastH"),
    no_grad=("Length",),
)
def _fused_gru(ctx, op, ins):
    x, wx, wh = ins["X"][0], ins["WeightX"][0], ins["WeightH"][0]
    bias = _opt(ins, "Bias")
    B, T, D = x.shape
    H = wh.shape[0]
    h0 = _opt(ins, "H0")
    h0 = _zeros(B, H, x) if h0 is None else h0
    ln = _opt(ins, "Length")
    rev = bool(op.attrs.get("is_reverse", False))
    # origin_mode True: h = z*h_p + (1-z)*c (reference gru_unit_op.h:116)
    origin = bool(op.attrs.get("origin_mode", False))
    xs = x.transpose(0, 1)
    if rev:
        xs = xs.flip(0)
    xproj = xs.reshape(T * B, D) @ wx
    if bias is not None:
        xproj = xproj + bias
    _, _, hs, h_last = _gru_scan(xproj.reshape(T, B, 3 * H), wh, h0,
                                 origin, ln, rev)
    if rev:
        hs = hs.flip(0)
    return {"Hidden": [hs.transpose(0, 1)], "LastH": [h_last]}


@register_op("lstm_unit", inputs=("X", "C_prev"), outputs=("C", "H"))
def _lstm_unit(ctx, op, ins):
    x, c_prev = ins["X"][0], ins["C_prev"][0]
    fb = float(op.attrs.get("forget_bias", 0.0))
    i, f, g, o = x.chunk(4, dim=-1)
    c = torch.sigmoid(f + fb) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return {"C": [c], "H": [torch.sigmoid(o) * torch.tanh(c)]}


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "relu": torch.relu, "identity": lambda v: v}


@register_op(
    "gru_unit",
    inputs=("Input", "HiddenPrev", "Weight", "Bias"),
    outputs=("Gate", "ResetHiddenPrev", "Hidden"),
)
def _gru_unit(ctx, op, ins):
    act = _ACTS[str(op.attrs.get("activation", "tanh"))]
    gate_act = _ACTS[str(op.attrs.get("gate_activation", "sigmoid"))]
    xp, hp, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    H = hp.shape[-1]
    if ins.get("Bias"):
        xp = xp + ins["Bias"][0]
    rz = gate_act(xp[:, : 2 * H] + hp @ w[:, : 2 * H])
    r, z = rz.chunk(2, dim=-1)
    rhp = r * hp
    c = act(xp[:, 2 * H:] + rhp @ w[:, 2 * H:])
    h = (1 - z) * hp + z * c
    return {"Gate": [torch.cat([rz, c], dim=-1)], "ResetHiddenPrev": [rhp],
            "Hidden": [h]}


@register_op(
    "recurrent",
    inputs=("StepInputs", "InitMemories", "Parameters", "SeqLengths"),
    outputs=("StepOutputs", "FinalMemories"),
    no_grad=("SeqLengths",),
)
def _recurrent(ctx, op, ins):
    """The step sub-block, once a time step (reference
    operators/recurrent_op.cc). ``time_major`` (StaticRNN) slices
    [T, B, ...] inputs; otherwise (DynamicRNN) [B, T, ...], and with
    ``SeqLengths`` a finished row keeps its memories and emits exact
    zeros."""
    from ..core.executor import lower_ops

    sub = op.attrs["sub_block"]
    step_in = list(op.attrs.get("step_input_names", []))
    pre_names = list(op.attrs.get("pre_memory_names", []))
    mem_names = list(op.attrs.get("memory_names", []))
    out_names = list(op.attrs.get("step_output_names", []))
    params = dict(zip(op.attrs.get("parameter_names", []),
                      ins.get("Parameters", [])))
    time_major = bool(op.attrs.get("time_major", True))
    xs = list(ins.get("StepInputs", []))
    carry = list(ins.get("InitMemories", []))
    lengths = _opt(ins, "SeqLengths")
    if not time_major:
        xs = [x.transpose(0, 1) for x in xs]
    T = xs[0].shape[0] if xs else int(op.attrs["max_steps"])
    ys = [[] for _ in out_names]
    for t in range(T):
        env = dict(params)
        env.update(zip(pre_names, carry))
        env.update(zip(step_in, (x[t] for x in xs)))
        lower_ops(sub.ops, env, ctx)
        new = [env[n] for n in mem_names]
        outs = [env[n] for n in out_names]
        if lengths is not None:
            active = t < lengths

            def keep(v, old):
                a = active.reshape((-1,) + (1,) * (v.dim() - 1))
                return torch.where(a, v, old)

            new = [keep(n, o) for n, o in zip(new, carry)]
            outs = [keep(o, torch.zeros_like(o)) for o in outs]
        carry = new
        for acc, o in zip(ys, outs):
            acc.append(o)
    ys = [torch.stack(y) for y in ys]
    if not time_major:
        ys = [y.transpose(0, 1) for y in ys]
    return {"StepOutputs": ys, "FinalMemories": carry}


# -- the non-fused family: pre-projected gates over [B, T, ...] --------------


def _lstm_scan(xproj, wh, h, c, cell_clip=0.0, proj=None, proj_clip=0.0,
               peephole=None, lengths=None, is_reverse=False):
    """xproj [T, B, 4H]; wh [H, 4H] ([P, 4H] with a projection);
    returns (hs, cs, h_last, c_last), time-major."""
    T = xproj.shape[0]
    hs, cs = [], []
    for t in range(T):
        h_new, c_new = _lstm_cell(xproj[t] + h @ wh, c, peephole, cell_clip)
        if proj is not None:
            h_new = h_new @ proj
            if proj_clip:
                h_new = torch.clamp(h_new, -proj_clip, proj_clip)
        if lengths is not None:
            a = _alive(t, lengths, T, is_reverse)
            h_new = torch.where(a, h_new, h)
            c_new = torch.where(a, c_new, c)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs), h, c


def _peephole_from_bias(op, ins, H):
    """A [1, 7H] bias with ``use_peepholes`` (the default) carries the
    W_ic, W_fc, W_oc diagonals after the 4H gate bias; a 4H bias none."""
    if not ins.get("Bias"):
        return None
    b = ins["Bias"][0].reshape(-1)
    if bool(op.attrs.get("use_peepholes", True)) and b.shape[0] == 7 * H:
        return (b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:])
    return None


def _time_major_gates(op, ins, x, width):
    xs = x.transpose(0, 1)
    if bool(op.attrs.get("is_reverse", False)):
        xs = xs.flip(0)
    if ins.get("Bias"):
        xs = xs + ins["Bias"][0].reshape(1, 1, -1)[:, :, :width]
    return xs


@register_op(
    "lstm",
    inputs=("Input", "H0", "C0", "Weight", "Bias", "Length"),
    outputs=("Hidden", "Cell", "BatchGate", "BatchCellPreAct"),
    no_grad=("Length",),
)
def _lstm(ctx, op, ins):
    x, wh = ins["Input"][0], ins["Weight"][0]
    B, T, H4 = x.shape
    H = H4 // 4
    rev = bool(op.attrs.get("is_reverse", False))
    h0, c0 = _opt(ins, "H0"), _opt(ins, "C0")
    hs, cs, _, _ = _lstm_scan(
        _time_major_gates(op, ins, x, 4 * H), wh,
        _zeros(B, H, x) if h0 is None else h0,
        _zeros(B, H, x) if c0 is None else c0,
        peephole=_peephole_from_bias(op, ins, H),
        lengths=_opt(ins, "Length"), is_reverse=rev)
    if rev:
        hs, cs = hs.flip(0), cs.flip(0)
    cs = cs.transpose(0, 1)
    return {"Hidden": [hs.transpose(0, 1)], "Cell": [cs], "BatchGate": [x],
            "BatchCellPreAct": [cs]}


@register_op(
    "lstmp",
    inputs=("Input", "H0", "C0", "Weight", "ProjWeight", "Bias"),
    outputs=("Projection", "Cell", "BatchGate", "BatchCellPreAct",
             "BatchHidden"),
)
def _lstmp(ctx, op, ins):
    x, wh, wp = ins["Input"][0], ins["Weight"][0], ins["ProjWeight"][0]
    B, T, H4 = x.shape
    H = H4 // 4
    P = wp.shape[1]
    rev = bool(op.attrs.get("is_reverse", False))
    h0, c0 = _opt(ins, "H0"), _opt(ins, "C0")
    hs, cs, _, _ = _lstm_scan(
        _time_major_gates(op, ins, x, 4 * H), wh,
        _zeros(B, P, x) if h0 is None else h0,
        _zeros(B, H, x) if c0 is None else c0,
        cell_clip=float(op.attrs.get("cell_clip", 0.0)), proj=wp,
        proj_clip=float(op.attrs.get("proj_clip", 0.0)),
        peephole=_peephole_from_bias(op, ins, H), is_reverse=rev)
    if rev:
        hs, cs = hs.flip(0), cs.flip(0)
    hs, cs = hs.transpose(0, 1), cs.transpose(0, 1)
    return {"Projection": [hs], "Cell": [cs], "BatchGate": [x],
            "BatchCellPreAct": [cs], "BatchHidden": [hs]}


@register_op(
    "gru",
    inputs=("Input", "H0", "Weight", "Bias", "Length"),
    outputs=("BatchGate", "BatchResetHiddenPrev", "BatchHidden", "Hidden"),
    no_grad=("Length",),
)
def _gru(ctx, op, ins):
    x, wh = ins["Input"][0], ins["Weight"][0]
    B, T, H3 = x.shape
    H = H3 // 3
    rev = bool(op.attrs.get("is_reverse", False))
    h0 = _opt(ins, "H0")
    gates, rhps, hs, _ = _gru_scan(
        _time_major_gates(op, ins, x, 3 * H), wh,
        _zeros(B, H, x) if h0 is None else h0,
        bool(op.attrs.get("origin_mode", False)), _opt(ins, "Length"), rev)
    if rev:
        gates, rhps, hs = gates.flip(0), rhps.flip(0), hs.flip(0)
    hs = hs.transpose(0, 1)
    return {"BatchGate": [gates.transpose(0, 1)],
            "BatchResetHiddenPrev": [rhps.transpose(0, 1)],
            "BatchHidden": [hs], "Hidden": [hs]}


@register_op(
    "attention_lstm",
    inputs=("X", "C0", "H0", "AttentionWeight", "AttentionBias",
            "AttentionScalar", "AttentionScalarBias", "LSTMWeight",
            "LSTMBias"),
    outputs=("Hidden", "Cell", "AttentionedX", "AttentionFCOut", "LSTMX",
             "LSTMOUT"),
)
def _attention_lstm(ctx, op, ins):
    """Reference attention_lstm_op.cc: each step attends over X with
    scores relu(x·aw[:M] + c_prev·aw[M:] + ab) (optionally rescaled by
    the scalar pair and relu'd again), softmax over time, then an LSTM
    step whose weight [D + M, 4D] holds the hidden rows first, with the
    reference's gate order f, i, o, g."""
    x = ins["X"][0]
    B, T, M = x.shape
    aw = ins["AttentionWeight"][0].reshape(-1)
    ab = _opt(ins, "AttentionBias")
    scal = _opt(ins, "AttentionScalar")
    scal_b = _opt(ins, "AttentionScalarBias")
    lw = ins["LSTMWeight"][0]
    lb = _opt(ins, "LSTMBias")
    D = lw.shape[1] // 4
    wh, wx = lw[:D], lw[D:]
    h, c = _opt(ins, "H0"), _opt(ins, "C0")
    h = _zeros(B, D, x) if h is None else h
    c = _zeros(B, D, x) if c is None else c
    atted_x = torch.einsum("btm,m->bt", x, aw[:M])
    hs, cs = [], []
    for _ in range(T):
        scores = atted_x + (c @ aw[M:])[:, None]
        if ab is not None:
            scores = scores + ab.reshape(())
        scores = torch.relu(scores)
        if scal is not None:
            scores = scores * scal.reshape(())
            if scal_b is not None:
                scores = scores + scal_b.reshape(())
            scores = torch.relu(scores)
        probs = torch.softmax(scores, dim=-1)
        attended = torch.einsum("bt,btm->bm", probs, x)
        gates = attended @ wx + h @ wh
        if lb is not None:
            gates = gates + lb.reshape(1, -1)
        f, i, o, g = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    z = torch.zeros((B, T, 1), dtype=x.dtype, device=x.device)
    return {"Hidden": [torch.stack(hs, 1)], "Cell": [torch.stack(cs, 1)],
            "AttentionedX": [z], "AttentionFCOut": [z],
            "LSTMX": [_zeros(B, D, x)],
            "LSTMOUT": [_zeros(B, 4 * D, x)]}


@register_op(
    "cudnn_lstm",
    inputs=("Input", "InitH", "InitC", "W", "Cache"),
    outputs=("Out", "last_h", "last_c"),
    no_grad=("Cache",),
)
def _cudnn_lstm(ctx, op, ins):
    """Time-major [T, B, D] LSTM over the JAX package's flat weight
    layout, per direction [D·4H | H·4H | 4H | 4H] (not cuDNN's own);
    ``is_bidirec`` runs a reversed second direction and concatenates
    the features."""
    x = ins["Input"][0]
    w = ins["W"][0].reshape(-1)
    T, B, D = x.shape
    H = int(op.attrs.get("hidden_size", 0))
    bidi = bool(op.attrs.get("is_bidirec", False))
    init_h, init_c = _opt(ins, "InitH"), _opt(ins, "InitC")

    def unpack(off):
        wx = w[off: off + D * 4 * H].reshape(D, 4 * H)
        off += D * 4 * H
        wh = w[off: off + H * 4 * H].reshape(H, 4 * H)
        off += H * 4 * H
        b = w[off: off + 4 * H] + w[off + 4 * H: off + 8 * H]
        return wx, wh, b, off + 8 * H

    def run_dir(xs, off, d):
        wx, wh, b, off = unpack(off)
        h0 = (init_h.reshape(-1, B, H)[d] if init_h is not None
              else _zeros(B, H, x))
        c0 = (init_c.reshape(-1, B, H)[d] if init_c is not None
              else _zeros(B, H, x))
        xp = (xs.reshape(T * B, D) @ wx + b).reshape(T, B, 4 * H)
        hs, _, h_l, c_l = _lstm_scan(xp, wh, h0, c0)
        return hs, h_l, c_l, off

    hs_f, h_f, c_f, off = run_dir(x, 0, 0)
    if bidi:
        hs_b, h_b, c_b, _ = run_dir(x.flip(0), off, 1)
        return {"Out": [torch.cat([hs_f, hs_b.flip(0)], -1)],
                "last_h": [torch.stack([h_f, h_b])],
                "last_c": [torch.stack([c_f, c_b])]}
    return {"Out": [hs_f], "last_h": [h_f[None]], "last_c": [c_f[None]]}
