"""Draft models for speculative decoding (counterpart of
``paddle_tpu/generation/draft.py``).

The ragged engine's ``spec_tokens`` path needs a DRAFT: something that
proposes the next k tokens of every active sequence, which the target
then verifies in ONE ragged step. Correctness never depends on the
draft: the target's greedy tokens are emitted whatever it proposed (a
bad draft only lowers the accepted-token rate), so the protocol is tiny:

    propose(contexts, k) -> list of up-to-k int arrays, one per context

``HostDraft`` is the built-in one: a GPT forward over weights taken
from a predictor's model, run as one batched greedy extension over the
whole batch of contexts. ``from_predictor(pred, cfg, num_layers=n)``
keeps the first n decoder layers for a smaller draft; with every layer
the draft replicates the target and the acceptance rate approaches 1.0.

The draft runs outside the engine's step (and outside its CUDA graph),
eagerly on the engine's device, in plain PyTorch ops: the JAX draft is
jnp code and reaches no Pallas kernel. It keeps the JAX draft's design:
rows padded up to a power of two of at least ``min_rows`` (the engine
pins it to its lane count), contexts padded to a power-of-two length
bucket from 16 up to ``max_position``, one full prefill that gives the
first proposal and fills dense per-layer K/V caches, then k - 1
incremental single-position steps over those caches; -1e9 masks, exact
(erf) GELU, layer norm with population variance and eps 1e-5. One
change, allowed because the proposals are the same argmax: the prefill
takes each row's last hidden state before the final layer norm and the
head, where the JAX draft applies the head to every position and keeps
the last.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import concrete_device, resolve_device

__all__ = ["DraftModel", "HostDraft"]

_NEG = -1e9
_LN_EPS = 1e-5


class DraftModel:
    """Protocol: batched greedy proposal of up to k continuation tokens
    per context. Subclass and override ``propose``."""

    def propose(self, contexts: Sequence[np.ndarray],
                k: int) -> List[np.ndarray]:
        raise NotImplementedError


def _layer_names(n: int) -> List[str]:
    """The draft's weights under their ``__params__.npz`` names, in the
    JAX draft's order (its ``from_predictor``)."""
    names = ["gpt_tok_emb", "gpt_pos_emb", "gpt_lnf.scale", "gpt_lnf.bias",
             "gpt_head.w", "gpt_head.b"]
    for i in range(n):
        pre = f"dec{i}"
        names += [f"{pre}_ln1.scale", f"{pre}_ln1.bias",
                  f"{pre}_qkv.w", f"{pre}_qkv.b",
                  f"{pre}_proj.w", f"{pre}_proj.b",
                  f"{pre}_ln2.scale", f"{pre}_ln2.bias",
                  f"{pre}_ffn1.w", f"{pre}_ffn1.b",
                  f"{pre}_ffn2.w", f"{pre}_ffn2.b"]
    return names


class HostDraft(DraftModel):
    """GPT forward over a dict of weights as the draft, on ``device``:
    by default the device of the tensors given, else the card
    (``resolve_device``; the CPU only when asked for by name). Tensors
    already there are used as they are (no copy); the rest move there."""

    def __init__(self, params: Dict[str, Union[np.ndarray, torch.Tensor]],
                 num_layers: int, num_heads: int, max_position: int, *,
                 name: str = "host_draft",
                 device: Optional[Union[str, torch.device]] = None):
        if device is None:
            device = next((v.device for v in params.values()
                           if isinstance(v, torch.Tensor)), None)
        self.device = concrete_device(resolve_device(device))
        self.params = {k: torch.as_tensor(v).to(self.device)
                       for k, v in params.items()}
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.max_position = int(max_position)
        self.name = name
        # every propose() pads its rows up to at least min_rows (the
        # engine sets it to its lane count): one rows bucket for the
        # engine's life, as in the JAX draft
        self.min_rows = 1

    # -- construction --------------------------------------------------------
    @classmethod
    def from_predictor(cls, predictor, cfg,
                       num_layers: Optional[int] = None) -> "HostDraft":
        """The draft over a loaded predictor's float weights, shared
        with its model (``GPTLM.jax_params()``), on its device.
        ``num_layers`` keeps the first n decoder layers (a smaller
        draft); by default every layer (a replica: acceptance near 1).
        Raises ``ValueError`` when a weight is missing, as for a
        predictor whose matmul weights were quantized at load (the float
        originals are not kept)."""
        n = int(num_layers if num_layers is not None else cfg.num_layers)
        have = predictor.lm.jax_params()
        params = {}
        for name in _layer_names(n):
            if name not in have:
                raise ValueError(
                    f"draft weight {name!r} not in the predictor's float "
                    "weights — is this a GPT LM predictor with float "
                    "(unquantized) matmul weights?")
            params[name] = have[name]
        return cls(params, n, cfg.num_heads, cfg.max_position,
                   device=predictor.lm.device)

    # -- forward -------------------------------------------------------------
    def _ln(self, x: torch.Tensor, pre: str) -> torch.Tensor:
        p = self.params
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return ((x - mu) / torch.sqrt(var + _LN_EPS)) * p[f"{pre}.scale"] \
            + p[f"{pre}.bias"]

    def _fc(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x @ self.params[f"{name}.w"] + self.params[f"{name}.b"]

    def _mlp(self, x: torch.Tensor, pre: str, ctx: torch.Tensor):
        """The post-attention half of decoder layer ``pre``."""
        x = x + self._fc(ctx, f"{pre}_proj")
        h2 = self._ln(x, f"{pre}_ln2")
        return x + self._fc(F.gelu(self._fc(h2, f"{pre}_ffn1")),
                            f"{pre}_ffn2")

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Greedy token of hidden states [..., h]."""
        return torch.argmax(self._fc(self._ln(x, "gpt_lnf"), "gpt_head"),
                            dim=-1)

    def _prefill(self, toks: torch.Tensor, lens: torch.Tensor):
        """toks [R, L], lens [R] -> (the greedy token after each row's
        last true token [R], per-layer K/V caches [R, L, H*D])."""
        p, H = self.params, self.num_heads
        R, L = toks.shape
        dev = toks.device
        x = p["gpt_tok_emb"][toks] + p["gpt_pos_emb"][:L][None]
        ar = torch.arange(L, device=dev)
        keep = ((ar[None, :] <= ar[:, None])[None, None]
                & (ar[None, :] < lens[:, None])[:, None, None, :])
        caches = []
        for i in range(self.num_layers):
            pre = f"dec{i}"
            q, k, v = self._fc(self._ln(x, f"{pre}_ln1"),
                               f"{pre}_qkv").chunk(3, dim=-1)
            k, v = k.contiguous(), v.contiguous()
            caches.append((k, v))
            D = q.shape[-1] // H

            def heads(t):
                return t.reshape(R, L, H, D).transpose(1, 2)

            s = heads(q) @ heads(k).transpose(-1, -2) / self._sqrt(D, x)
            s = torch.where(keep, s, torch.full_like(s, _NEG))
            ctx = torch.softmax(s, -1) @ heads(v)
            x = self._mlp(x, pre, ctx.transpose(1, 2).reshape(R, L, -1))
        last = x[torch.arange(R, device=dev), lens - 1]           # [R, h]
        return self._head(last), caches

    def _step(self, tok: torch.Tensor, pos: torch.Tensor, caches):
        """One new token per row at position ``pos`` [R] over the caches
        (written in place at ``min(pos, L - 1)``)."""
        p, H = self.params, self.num_heads
        R = tok.shape[0]
        L = caches[0][0].shape[1]
        dev = tok.device
        idx = torch.clamp(pos, max=L - 1)
        rows = torch.arange(R, device=dev)
        x = (p["gpt_tok_emb"][tok] + p["gpt_pos_emb"][idx])[:, None]
        attend = torch.arange(L, device=dev)[None, :] <= pos[:, None]
        for i, (ck, cv) in enumerate(caches):
            pre = f"dec{i}"
            q, k, v = self._fc(self._ln(x, f"{pre}_ln1"),
                               f"{pre}_qkv").chunk(3, dim=-1)
            ck[rows, idx] = k[:, 0]
            cv[rows, idx] = v[:, 0]
            D = q.shape[-1] // H
            qh = q.reshape(R, H, 1, D)
            kh = ck.reshape(R, L, H, D).transpose(1, 2)
            vh = cv.reshape(R, L, H, D).transpose(1, 2)
            s = (qh @ kh.transpose(-1, -2))[:, :, 0] / self._sqrt(D, x)
            s = torch.where(attend[:, None, :], s, torch.full_like(s, _NEG))
            ctx = (torch.softmax(s, -1)[:, :, None] @ vh).reshape(R, 1, -1)
            x = self._mlp(x, pre, ctx)
        return self._head(x[:, 0])

    @staticmethod
    def _sqrt(D: int, like: torch.Tensor) -> torch.Tensor:
        # a tensor divisor: a division, as jnp's, not a product with the
        # reciprocal
        return torch.tensor(math.sqrt(D), dtype=like.dtype,
                            device=like.device)

    def _extend(self, toks: torch.Tensor, lens: torch.Tensor,
                k: int) -> torch.Tensor:
        """k greedy proposals per row [R, k]: a full prefill gives the
        first, then k - 1 incremental steps over the caches."""
        nxt, caches = self._prefill(toks, lens)
        out = [nxt]
        pos = lens
        for _ in range(k - 1):
            nxt = self._step(nxt, pos, caches)
            pos = pos + 1
            out.append(nxt)
        return torch.stack(out, dim=1)

    def warmup(self, k: int) -> None:
        """One proposal in every length bucket ``propose`` can reach (the
        JAX draft compiles them here; the port's first calls at each
        shape allocate their buffers and library workspaces)."""
        if k < 1:
            return
        b = 16
        seen = set()
        while True:
            cap = min(self.max_position, b)
            if cap not in seen:
                seen.add(cap)
                self.propose([np.zeros(max(1, cap - k), np.int64)], k)
            if cap >= self.max_position:
                return
            b *= 2

    def propose(self, contexts: Sequence[np.ndarray],
                k: int) -> List[np.ndarray]:
        if not contexts or k < 1:
            return [np.zeros(0, np.int64) for _ in contexts]
        rows = len(contexts)
        lens = np.array([len(c) for c in contexts], np.int64)
        # both dims bucketed as in the JAX draft: rows to a power of two
        # of at least min_rows, lengths to a power-of-two ladder from 16
        rows_b = 1 << (max(rows, self.min_rows) - 1).bit_length()
        need = int(lens.max()) + k
        max_len = min(self.max_position,
                      max(16, 1 << (need - 1).bit_length()))
        toks = np.zeros((rows_b, max_len), np.int64)
        for i, c in enumerate(contexts):
            toks[i, :len(c)] = np.asarray(c, np.int64)[:max_len]
        pad_lens = np.ones(rows_b, np.int64)
        pad_lens[:rows] = lens
        with torch.inference_mode():
            ks = self._extend(torch.from_numpy(toks).to(self.device),
                              torch.from_numpy(pad_lens).to(self.device),
                              k).cpu().numpy()
        out = []
        for i in range(rows):
            # never propose past the position window (the engine caps
            # against its own page and budget limits on top)
            room = max(0, self.max_position - int(lens[i]) - 1)
            out.append(ks[i, :min(k, room)].astype(np.int64))
        return out
