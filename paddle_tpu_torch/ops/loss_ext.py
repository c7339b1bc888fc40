"""Sequence losses and metrics: ``warpctc``, ``linear_chain_crf``,
``crf_decoding``, ``edit_distance`` and ``chunk_eval``, torch lowerings
with the semantics of ``paddle_tpu/ops/loss_ext.py``.

CTC is computed as the JAX package computes it (optax's ``ctc_loss``:
the forward recursion in log space with ``log_epsilon`` = -1e5 in place
of log 0, labels compared for repeats as given), and its gradient comes
from autograd through that recursion. ``F.ctc_loss`` differs where the
two definitions part: an infeasible label gives it an infinite loss
where JAX gives about 1e5, and JAX's lowering ignores
``norm_by_times``. The CRF's Transition is [C + 2, C]: the start row,
the end row, then C × C pair weights.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .math import _Abs, _maximum, _softplus

LOG_EPSILON = -1e5


def ctc_loss(logits, logit_pad, labels, label_pad, blank=0,
             log_epsilon=LOG_EPSILON):
    """optax.ctc_loss: logits [B, T, K], paddings 1.0 where padded,
    labels [B, N] right-padded; returns the per-sequence loss [B]."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = N - label_pad.sum(1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logits.dtype)
    repeat = torch.cat([repeat, repeat.new_zeros((B, 1))], dim=1)
    lp_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)      # [T, B, 1]
    lp_emit = torch.gather(
        logprobs, 2, labels.long()[:, None, :].expand(B, T, N))
    lp_emit = lp_emit.transpose(0, 1)                               # [T, B, N]
    phi = torch.full((B, N + 1), log_epsilon, dtype=logits.dtype,
                     device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, dtype=logits.dtype,
                      device=logits.device)

    def upd(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], -1)

    pads = logit_pad.transpose(0, 1).to(logits.dtype)
    for t in range(T):
        phi_orig = phi
        phi = upd(phi, emit + log_epsilon * repeat)
        e_t, p_t = lp_emit[t], lp_phi[t]
        next_emit = torch.logaddexp(phi[:, :-1] + e_t, emit + e_t)
        next_phi = upd(phi + p_t, emit + p_t + log_epsilon * (1.0 - repeat))
        pad = pads[t].reshape(B, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi_orig + (1.0 - pad) * next_phi
    last = upd(phi, emit)
    return -torch.gather(last, 1, labellens.reshape(B, 1)).reshape(B)


def _pad_from_lengths(lengths, width, device):
    if lengths is None:
        return None
    ar = torch.arange(width, device=device)[None, :]
    return (ar >= lengths.reshape(-1, 1)).to(torch.float32)


@register_op(
    "warpctc",
    inputs=("Logits", "Label", "LogitsLength", "LabelLength"),
    outputs=("Loss", "WarpCTCGrad"),
    no_grad=("Label", "LogitsLength", "LabelLength"),
)
def _warpctc(ctx, op, ins):
    logits, labels = ins["Logits"][0], ins["Label"][0]
    B, T, C = logits.shape
    lp = _pad_from_lengths(ins["LogitsLength"][0], T, logits.device) \
        if ins.get("LogitsLength") else None
    if lp is None:
        lp = torch.zeros((B, T), device=logits.device)
    bp = _pad_from_lengths(ins["LabelLength"][0], labels.shape[1],
                           logits.device) if ins.get("LabelLength") else None
    if bp is None:
        bp = torch.zeros(labels.shape, device=logits.device)
    loss = ctc_loss(logits, lp, labels, bp,
                    blank=int(op.attrs.get("blank", 0)))
    return {"Loss": [loss.reshape(B, 1)],
            "WarpCTCGrad": [torch.zeros_like(logits)]}


def _lengths(ins, slot, B, T, device):
    if ins.get(slot):
        return ins[slot][0].reshape(-1)
    return torch.full((B,), T, dtype=torch.int32, device=device)


@register_op(
    "linear_chain_crf",
    inputs=("Emission", "Transition", "Label", "Length"),
    outputs=("Alpha", "EmissionExps", "TransitionExps", "LogLikelihood"),
    no_grad=("Label", "Length"),
)
def _linear_chain_crf(ctx, op, ins):
    """The negative log-likelihood of each row's label path: log Z by
    the forward recursion, minus the path's score; steps past a row's
    length leave both unchanged."""
    em, tr = ins["Emission"][0], ins["Transition"][0]
    label = ins["Label"][0]
    if label.dim() == 3 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    label = label.long()
    B, T, C = em.shape
    ln = _lengths(ins, "Length", B, T, em.device)
    start, stop, pair = tr[0], tr[1], tr[2:]
    rows = torch.arange(B, device=em.device)
    alpha = start + em[:, 0]
    prev = label[:, 0]
    score = start[prev] + em[rows, 0, prev]
    for t in range(1, T):
        live = (t < ln)
        new = torch.logsumexp(alpha[:, :, None] + pair, dim=1) + em[:, t]
        alpha = torch.where(live[:, None], new, alpha)
        y = label[:, t]
        score = torch.where(live, score + (pair[prev, y] + em[rows, t, y]),
                            score)
        prev = torch.where(live, y, prev)
    log_z = torch.logsumexp(alpha + stop, dim=1)
    ll = score + stop[prev] - log_z
    return {"Alpha": [torch.zeros_like(em)], "EmissionExps": [torch.exp(em)],
            "TransitionExps": [torch.exp(tr)],
            "LogLikelihood": [(-ll).reshape(B, 1)]}


@register_op(
    "crf_decoding",
    inputs=("Emission", "Transition", "Label", "Length"),
    outputs=("ViterbiPath",),
    stop_gradient=True,
)
def _crf_decoding(ctx, op, ins):
    """Viterbi paths [B, T] (int64); a step past a row's length keeps
    its scores and points back to itself. Ties go to the lower tag, as
    ``jnp.argmax``'s do."""
    em, tr = ins["Emission"][0], ins["Transition"][0]
    B, T, C = em.shape
    ln = _lengths(ins, "Length", B, T, em.device)
    start, stop, pair = tr[0], tr[1], tr[2:]
    ident = torch.arange(C, device=em.device).expand(B, C)
    score = start + em[:, 0]
    backs = []
    for t in range(1, T):
        cand = score[:, :, None] + pair
        best, back = cand.max(dim=1)
        live = (t < ln)[:, None]
        score = torch.where(live, best + em[:, t], score)
        backs.append(torch.where(live, back, ident))
    cur = torch.argmax(score + stop, dim=1)
    path = [None] * T
    for t in range(T - 1, 0, -1):
        path[t] = cur
        cur = torch.gather(backs[t - 1], 1, cur[:, None]).squeeze(1)
    path[0] = cur
    return {"ViterbiPath": [torch.stack(path, 1).to(torch.int64)]}


@register_op(
    "edit_distance",
    inputs=("Hyps", "Refs", "HypsLength", "RefsLength"),
    outputs=("Out", "SequenceNum"),
    stop_gradient=True,
)
def _edit_distance(ctx, op, ins):
    """Levenshtein distance of each hypothesis row to its reference
    row, over the rows' lengths; ``normalized`` divides by the
    reference length (at least 1)."""
    hyps, refs = ins["Hyps"][0], ins["Refs"][0]
    if hyps.dim() == 3:
        hyps = hyps.squeeze(-1)
    if refs.dim() == 3:
        refs = refs.squeeze(-1)
    B, Lh = hyps.shape
    Lr = refs.shape[1]
    dev = hyps.device
    hl = _lengths(ins, "HypsLength", B, Lh, dev).to(torch.float32)
    rl = _lengths(ins, "RefsLength", B, Lr, dev)
    row = torch.arange(Lr + 1, dtype=torch.float32, device=dev).expand(
        B, Lr + 1)
    for i in range(Lh):
        left = torch.full((B,), i + 1.0, device=dev)
        new = [left]
        for j in range(Lr):
            sub = row[:, j] + (hyps[:, i] != refs[:, j]).to(torch.float32)
            left = torch.minimum(torch.minimum(left + 1, row[:, j + 1] + 1),
                                 sub)
            new.append(left)
        row = torch.where((i < hl)[:, None], torch.stack(new, 1), row)
    d = torch.gather(row, 1, rl.long().reshape(B, 1)).reshape(B)
    if bool(op.attrs.get("normalized", False)):
        d = d / torch.clamp(rl.to(torch.float32), min=1.0)
    return {"Out": [d.reshape(B, 1)],
            "SequenceNum": [torch.tensor(B, dtype=torch.int64, device=dev)]}


@register_op("chunk_eval", inputs=("Inference", "Label", "SeqLength"),
             outputs=("Precision", "Recall", "F1-Score", "NumInferChunks",
                      "NumLabelChunks", "NumCorrectChunks"),
             stop_gradient=True)
def _chunk_eval(ctx, op, ins):
    """Chunk precision, recall and F1 in the JAX package's plain
    (IOB-free) semantics: a chunk is a maximal run of one tag other
    than the background tag (``excluded_chunk_types_bg``, else
    ``num_chunk_types``); a predicted chunk is correct when a label
    chunk has its span and its tag."""
    inf, lbl = ins["Inference"][0], ins["Label"][0]
    if inf.dim() > 2:
        inf = inf.reshape(inf.shape[0], -1)
        lbl = lbl.reshape(lbl.shape[0], -1)
    B, T = inf.shape
    dev = inf.device
    bg = int(op.attrs.get("excluded_chunk_types_bg",
                          op.attrs.get("num_chunk_types", 0)))
    ln = _lengths(ins, "SeqLength", B, T, dev)
    valid = torch.arange(T, device=dev)[None, :] < ln.reshape(-1, 1)

    def edge(t, first):
        fill = torch.full((B, 1), -1, dtype=t.dtype, device=dev)
        other = torch.cat([fill, t[:, :-1]], 1) if first \
            else torch.cat([t[:, 1:], fill], 1)
        return valid & (t != bg) & (t != other)

    inf_start, lbl_start = edge(inf, True), edge(lbl, True)
    end_inf, end_lbl = edge(inf, False), edge(lbl, False)
    agree = inf == lbl
    open_ok = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_corr = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(T):
        open_ok = torch.where(lbl_start[:, t], inf_start[:, t] & agree[:, t],
                              open_ok & agree[:, t])
        n_corr = n_corr + (end_lbl[:, t] & open_ok & end_inf[:, t]).sum()
        open_ok = torch.where(end_lbl[:, t], torch.zeros_like(open_ok),
                              open_ok)
    n_inf, n_lbl = inf_start.sum(), lbl_start.sum()
    p = n_corr / torch.clamp(n_inf, min=1)
    r = n_corr / torch.clamp(n_lbl, min=1)
    f1 = 2 * p * r / torch.clamp(p + r, min=1e-6)
    f32 = lambda v: v.to(torch.float32)
    return {"Precision": [f32(p)], "Recall": [f32(r)], "F1-Score": [f32(f1)],
            "NumInferChunks": [n_inf.to(torch.int64)],
            "NumLabelChunks": [n_lbl.to(torch.int64)],
            "NumCorrectChunks": [n_corr.to(torch.int64)]}


# -- the ranking, metric-learning and CTR losses (paddle_tpu/ops/loss_ext.py
# :211-424) --------------------------------------------------------------------


@register_op("hinge_loss", inputs=("Logits", "Labels"), outputs=("Loss",),
             no_grad=("Labels",))
def _hinge_loss(ctx, op, ins):
    """:211: max(1 - (2y - 1) x, 0)."""
    x, y = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": [_maximum(1.0 - (2.0 * y - 1.0) * x, torch.zeros(
        (), dtype=x.dtype, device=x.device))]}


@register_op("rank_loss", inputs=("Label", "Left", "Right"), outputs=("Out",),
             no_grad=("Label",))
def _rank_loss(ctx, op, ins):
    """:217 (rank_loss_op.cc): sigmoid cross entropy on left - right."""
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [_softplus(d) - ins["Label"][0] * d]}


@register_op("margin_rank_loss", inputs=("Label", "X1", "X2"),
             outputs=("Out", "Activated"), no_grad=("Label",))
def _margin_rank_loss(ctx, op, ins):
    """:225: max(-label (x1 - x2) + margin, 0), and where it is
    positive."""
    lbl, x1, x2 = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    m = float(op.attrs.get("margin", 0.0))
    out = _maximum(-lbl * (x1 - x2) + m, torch.zeros((), dtype=x1.dtype,
                                                      device=x1.device))
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register_op("bpr_loss", inputs=("X", "Label"), outputs=("Y",),
             no_grad=("Label",))
def _bpr_loss(ctx, op, ins):
    """:233 (bpr_loss_op.cc): -mean over j != p of log sigmoid(x_p -
    x_j), p the row's label."""
    x = ins["X"][0]
    lbl = ins["Label"][0].reshape(-1).long()
    C = x.shape[1]
    pos = torch.gather(x, 1, lbl[:, None])
    logsig = -_softplus(-(pos - x))
    notp = torch.arange(C, device=x.device)[None, :] != lbl[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return {"Y": [-torch.sum(torch.where(notp, logsig, zero), dim=1,
                             keepdim=True) / max(C - 1, 1)]}


@register_op("modified_huber_loss", inputs=("X", "Y"),
             outputs=("Out", "IntermediateVal"), no_grad=("Y",))
def _modified_huber_loss(ctx, op, ins):
    """:248: on z = (2y - 1) x, -4z below -1, (1 - z)^2 below 1, else
    0."""
    z = (2.0 * ins["Y"][0] - 1.0) * ins["X"][0]
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    out = torch.where(z < -1.0, -4.0 * z,
                      torch.where(z < 1.0, (1.0 - z) ** 2, zero))
    return {"Out": [out], "IntermediateVal": [z]}


@register_op("teacher_student_sigmoid_loss", inputs=("X", "Label"),
             outputs=("Y",), no_grad=("Label",))
def _teacher_student_sigmoid_loss(ctx, op, ins):
    """:257 (teacher_student_sigmoid_loss_op.cc): label < -1 is a
    non-click without a teacher score, sp(x); < 0 a click without one,
    sp(x) - x; else a click bit and a teacher score, 2 sp(x) - label x.
    sp is the reference's own stable softplus, max(x, 0) + log1p(exp(-
    |x|)), as JAX writes it."""
    x = ins["X"][0].reshape(-1)
    lbl = ins["Label"][0].reshape(-1)
    sp = (_maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))
          + torch.log1p(torch.exp(-_Abs.apply(x))))
    out = torch.where(lbl < -1.0, sp,
                      torch.where(lbl < 0.0, sp - x, 2.0 * sp - x * lbl))
    return {"Y": [out.reshape(-1, 1)]}


@register_op("cos_sim", inputs=("X", "Y"), outputs=("Out", "XNorm", "YNorm"))
def _cos_sim(ctx, op, ins):
    """:276: along the last dim, the norms' product floored at 1e-12."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / _maximum(
        xn * yn, torch.full((), 1e-12, dtype=x.dtype, device=x.device))
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("center_loss", inputs=("X", "Label", "Centers",
                                    "CenterUpdateRate"),
             outputs=("Loss", "SampleCenterDiff", "CentersOut"),
             no_grad=("Label", "Centers", "CenterUpdateRate"))
def _center_loss(ctx, op, ins):
    """:285 (center_loss_op.cc): half the squared distance to the
    label's centre; with ``need_update`` (the default) CentersOut moves
    each centre by alpha * (sum of its members' diffs) / (count + 1),
    the state the next call reads (X's gradient reaches it through the
    diffs, as in JAX)."""
    x = ins["X"][0]
    lbl = ins["Label"][0].reshape(-1).long()
    centers = ins["Centers"][0]
    alpha = (ins["CenterUpdateRate"][0].reshape(())
             if ins.get("CenterUpdateRate") else 0.1)
    diff = x - centers[lbl]
    loss = 0.5 * torch.sum(diff * diff, dim=-1, keepdim=True)
    if bool(op.attrs.get("need_update", True)):
        cnt = torch.zeros((centers.shape[0],), dtype=x.dtype,
                          device=x.device).index_add(
            0, lbl, torch.ones_like(lbl, dtype=x.dtype))
        upd = torch.zeros_like(centers).index_add(0, lbl, diff)
        centers = centers + alpha * upd / (cnt[:, None] + 1.0)
    return {"Loss": [loss], "SampleCenterDiff": [diff],
            "CentersOut": [centers]}


@register_op("mean_iou", inputs=("Predictions", "Labels", "InWrongs",
                                 "InCorrects", "InMeanIou"),
             outputs=("OutMeanIou", "OutWrong", "OutCorrect"),
             stop_gradient=True)
def _mean_iou(ctx, op, ins):
    """:304: per-class correct and wrong counts, added to InCorrects /
    InWrongs (the carried state), and the mean IoU over the classes seen
    (InMeanIou is not read, as in JAX)."""
    pred = ins["Predictions"][0].reshape(-1).long()
    lbl = ins["Labels"][0].reshape(-1).long()
    C = int(op.attrs["num_classes"])
    dev = pred.device
    hit = (pred == lbl).to(torch.float32)
    miss = (pred != lbl).to(torch.float32)
    zeros = torch.zeros((C,), dtype=torch.float32, device=dev)
    correct = zeros.index_add(0, lbl, hit)
    wrong = zeros.index_add(0, pred, miss) + zeros.index_add(0, lbl, miss)
    if ins.get("InCorrects"):
        correct = correct + ins["InCorrects"][0]
    if ins.get("InWrongs"):
        wrong = wrong + ins["InWrongs"][0]
    denom = correct + wrong
    iou = torch.where(denom > 0, correct / torch.clamp(denom, min=1.0),
                      torch.zeros((), device=dev))
    miou = torch.sum(iou) / torch.clamp(torch.sum((denom > 0).to(
        torch.float32)), min=1.0)
    return {"OutMeanIou": [miou], "OutWrong": [wrong],
            "OutCorrect": [correct]}


@register_op("positive_negative_pair", inputs=("Score", "Label", "QueryID"),
             outputs=("PositivePair", "NegativePair", "NeutralPair"),
             stop_gradient=True)
def _positive_negative_pair(ctx, op, ins):
    """:392: over the pairs of one query with different labels, those
    ordered by score as by label (positive), tied in score (neutral) and
    the rest (negative); float32 [1] each."""
    s = ins["Score"][0].reshape(-1)
    lab = ins["Label"][0].reshape(-1)
    q = ins["QueryID"][0].reshape(-1)
    n = s.shape[0]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=s.device), diagonal=1)
    m = (q[:, None] == q[None, :]) & upper & (lab[:, None] != lab[None, :])
    hi_lbl = lab[:, None] > lab[None, :]
    hi_scr = s[:, None] > s[None, :]
    eq_scr = s[:, None] == s[None, :]
    pos = torch.sum(m & (hi_lbl == hi_scr) & ~eq_scr)
    neu = torch.sum(m & eq_scr)
    neg = torch.sum(m) - pos - neu
    return {"PositivePair": [pos.to(torch.float32).reshape(1)],
            "NegativePair": [neg.to(torch.float32).reshape(1)],
            "NeutralPair": [neu.to(torch.float32).reshape(1)]}


@register_op("cvm", inputs=("X", "CVM"), outputs=("Y",), no_grad=("CVM",))
def _cvm(ctx, op, ins):
    """:413 (cvm_op.cc): the show / click columns as log(show + 1) and
    log(click + 1) - log(show + 1) with ``use_cvm``, dropped without."""
    x = ins["X"][0]
    if not bool(op.attrs.get("use_cvm", True)):
        return {"Y": [x[:, 2:]]}
    show = torch.log(x[:, :1] + 1.0)
    ctr = torch.log(x[:, 1:2] + 1.0) - torch.log(x[:, :1] + 1.0)
    return {"Y": [torch.cat([show, ctr, x[:, 2:]], dim=1)]}
