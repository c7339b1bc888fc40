"""Beam search ops: torch lowerings with the semantics of
``paddle_tpu/ops/beam.py``.

Beams are a dense [batch, beam] axis: a finished beam keeps emitting
``end_id`` at its frozen score, so every step has one shape.

The top-k of ``beam_search`` is ``jax.lax.top_k``'s: descending, and
among equal scores the lower flat index first. ``torch.topk`` promises
no order among ties (on CUDA it varies), and the ``NEG_INF`` mask of
finished beams makes many ties, so the port takes a stable descending
sort instead, on the CPU and on the card alike.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op

NEG_INF = -1e9


def top_k_lower_index_first(flat, k):
    """(values, indices) of the k largest along the last axis, ties
    broken towards the lower index, as ``jax.lax.top_k`` does."""
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op(
    "beam_search",
    inputs=("pre_ids", "pre_scores", "ids", "scores"),
    outputs=("selected_ids", "selected_scores", "parent_idx"),
    stop_gradient=True,
)
def _beam_search(ctx, op, ins):
    """One expansion: scores [B, beam, V] log-probs (accumulated, or
    per step and added to pre_scores). A finished beam offers one
    candidate, end_id at its frozen score. The best beam_size of the
    beam·V candidates a row, with the parent beam of each."""
    pre_ids, pre_scores = ins["pre_ids"][0], ins["pre_scores"][0]
    scores = ins["scores"][0]
    beam_size = int(op.attrs.get("beam_size", scores.shape[1]))
    end_id = int(op.attrs.get("end_id", 0))
    squeeze = pre_ids.dim() == 1
    if squeeze:
        pre_ids, pre_scores, scores = pre_ids[None], pre_scores[None], \
            scores[None]
    B, beam, V = scores.shape
    acc = scores if bool(op.attrs.get("is_accumulated", True)) \
        else scores + pre_scores[..., None]
    finished = pre_ids == end_id
    acc = torch.where(finished[..., None], torch.full_like(acc, NEG_INF),
                      acc)
    frozen = torch.where(finished, pre_scores.to(acc.dtype), acc[..., end_id])
    acc = acc.clone()
    acc[..., end_id] = frozen
    top_scores, top_idx = top_k_lower_index_first(acc.reshape(B, beam * V),
                                                  beam_size)
    parent = torch.div(top_idx, V, rounding_mode="floor").to(torch.int32)
    sel_ids = (top_idx % V).to(pre_ids.dtype)
    if squeeze:
        top_scores, sel_ids, parent = top_scores[0], sel_ids[0], parent[0]
    return {"selected_ids": [sel_ids], "selected_scores": [top_scores],
            "parent_idx": [parent]}


def backtrack(ids, parents):
    """Tokens [T, B, beam] in forward order from the stacked step ids
    and parent pointers, walking back from each final beam."""
    T, B, beam = ids.shape
    cur = torch.arange(beam, device=ids.device).expand(B, beam)
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, cur)
        cur = torch.gather(parents[t], 1, cur).long()
    return torch.stack(toks)


@register_op(
    "beam_search_decode",
    inputs=("Ids", "Parents", "Scores"),
    outputs=("SentenceIds", "SentenceScores"),
    stop_gradient=True,
)
def _beam_search_decode(ctx, op, ins):
    """Ids, Parents [T, B, beam] -> SentenceIds [B, beam, T], every
    position after a sentence's first end_id set to end_id; Scores
    [B, beam] pass through."""
    ids, parents, scores = ins["Ids"][0], ins["Parents"][0], ins["Scores"][0]
    end_id = int(op.attrs.get("end_id", 0))
    sent = backtrack(ids, parents).permute(1, 2, 0)
    seen = torch.cumsum((sent == end_id).to(torch.int32), dim=-1) > 0
    shifted = torch.cat([torch.zeros_like(seen[..., :1]), seen[..., :-1]], -1)
    sent = torch.where(shifted, torch.full_like(sent, end_id), sent)
    return {"SentenceIds": [sent], "SentenceScores": [scores]}
