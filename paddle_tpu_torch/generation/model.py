"""The GPT modules the predictor and the generation engine run.

Counterparts of ``paddle_tpu/generation/model.py``:

* ``GPTLM`` — the loss-free causal LM, tokens [B, S] -> logits
  [B, S, V] (``build_lm_program``, :159). Its attention is plain causal
  softmax attention in torch ops, as ``nets.scaled_dot_product_attention``
  writes it (additive -1e9 upper triangle, then softmax): the predictor
  is the engine's independent oracle, so it shares no attention code
  with the engine.
* ``RaggedStepModel`` — one ragged engine step, a [lanes, chunk] mixed
  batch of prefill chunks, decode rows and idle lanes
  (``build_ragged_step_program``, :238): per layer layer_norm -> fused
  qkv -> kv_cache_write -> ragged_paged_attention -> proj/ffn, then the
  head and an argmax at every position.
* ``load_jax_params`` — carries the JAX package's weights (the names of
  ``__params__.npz``) onto a ``GPTLM``.

Numerics follow the JAX package: qkv splits q|k|v along the last dim,
heads are head-major ``[..., H, D]``, layer norm has eps 1e-5 and
population variance, the FFN uses exact erf GELU. Weights are kept in
the JAX layout, fc weights ``[in, out]`` (``x @ w + b``), so the carry
is one to one.

The step writes the page pools IN PLACE (the JAX program returns new
pools that the engine swaps in). Within a layer the chunk's K/V is
written before the attention reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import (kv_cache_write, kv_write_targets, layer_norm,
                       ragged_paged_attention)
from ..models.gpt import GPTConfig

__all__ = ["CacheGeometry", "GPTLM", "RaggedStepModel", "load_jax_params",
           "GPTConfig", "LN_EPS"]

LN_EPS = 1e-5   # layers/nn.py layer_norm default


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """The page-pool shape the step runs against."""
    num_pages: int
    page_size: int
    max_pages_per_seq: int


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` kept ``[in, out]`` as the JAX package
    stores it (``layers.fc`` with ``num_flatten_dims`` = rank - 1)."""

    def __init__(self, n_in: int, n_out: int, device, dtype):
        super().__init__()
        self.w = _param((n_in, n_out), device, dtype)
        self.b = _param((n_out,), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = torch.addmm(self.b, x.reshape(-1, x.shape[-1]), self.w)
        return y.reshape(*lead, y.shape[-1])


class LayerNorm(nn.Module):
    """Layer norm over the last dim through the ``layer_norm`` kernel
    wrapper (the plain version on CPU tensors)."""

    def __init__(self, n: int, device, dtype):
        super().__init__()
        self.scale = _param((n,), device, dtype)
        self.bias = _param((n,), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = layer_norm(x.reshape(-1, x.shape[-1]).contiguous(), self.scale,
                       self.bias, LN_EPS)
        return y.reshape(x.shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GPTConfig, device, dtype):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_size
        self.ln1 = LayerNorm(h, device, dtype)
        self.qkv = Dense(h, 3 * h, device, dtype)
        self.proj = Dense(h, h, device, dtype)
        self.ln2 = LayerNorm(h, device, dtype)
        self.ffn1 = Dense(h, f, device, dtype)
        self.ffn2 = Dense(f, h, device, dtype)

    def proj_ffn(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """The post-attention half (``_proj_ffn`` in JAX), shared by the
        LM and the ragged step so they can only differ in attention."""
        x = x + self.proj(ctx)
        return x + self.ffn2(F.gelu(self.ffn1(self.ln2(x))))


class GPTLM(nn.Module):
    """Causal LM: tokens [B, S] -> logits [B, S, V]. Parameters are
    allocated uninitialised; ``load_jax_params`` fills them."""

    def __init__(self, cfg: GPTConfig, device: Union[str, torch.device],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.moe_every:
            raise NotImplementedError("MoE GPT layers are not ported")
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError("hidden_size must be a multiple of num_heads")
        self.cfg = cfg
        h = cfg.hidden_size
        self.tok_emb = _param((cfg.vocab_size, h), device, dtype)
        self.pos_emb = _param((cfg.max_position, h), device, dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype) for _ in range(cfg.num_layers))
        self.lnf = LayerNorm(h, device, dtype)
        self.head = Dense(h, cfg.vocab_size, device, dtype)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_emb.dtype

    def jax_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter under its ``__params__.npz`` name."""
        out = {"gpt_tok_emb": self.tok_emb, "gpt_pos_emb": self.pos_emb,
               "gpt_lnf.scale": self.lnf.scale, "gpt_lnf.bias": self.lnf.bias,
               "gpt_head.w": self.head.w, "gpt_head.b": self.head.b}
        for i, lyr in enumerate(self.layers):
            pre = f"dec{i}"
            for ln in ("ln1", "ln2"):
                mod = getattr(lyr, ln)
                out[f"{pre}_{ln}.scale"] = mod.scale
                out[f"{pre}_{ln}.bias"] = mod.bias
            for fc in ("qkv", "proj", "ffn1", "ffn2"):
                mod = getattr(lyr, fc)
                out[f"{pre}_{fc}.w"] = mod.w
                out[f"{pre}_{fc}.b"] = mod.b
        return out

    def split_heads(self, t: torch.Tensor) -> torch.Tensor:
        """[..., H*D] -> [..., H, D] (head-major, as the JAX reshape)."""
        nh = self.cfg.num_heads
        return t.reshape(*t.shape[:-1], nh, t.shape[-1] // nh)

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        if S > self.cfg.max_position:
            raise ValueError(f"sequence of {S} tokens exceeds max_position "
                             f"{self.cfg.max_position}")
        tokens = tokens.to(self.device, torch.long)
        pos = torch.arange(S, device=self.device)
        x = self.tok_emb[tokens] + self.pos_emb[pos][None]
        # nets.scaled_dot_product_attention's causal mask: -1e9 added
        # above the diagonal
        mask = torch.triu(torch.full((S, S), -1e9, device=self.device,
                                     dtype=torch.float32), diagonal=1)
        h = self.cfg.hidden_size
        for lyr in self.layers:
            q, k, v = lyr.qkv(lyr.ln1(x)).split(h, dim=-1)
            q, k, v = (self.split_heads(t).transpose(1, 2) for t in (q, k, v))
            d = q.shape[-1]
            logits = (q * d ** -0.5) @ k.transpose(-1, -2)
            w = torch.softmax(logits.float() + mask, dim=-1).to(v.dtype)
            ctx = (w @ v).transpose(1, 2).reshape(B, S, h)
            x = lyr.proj_ffn(x, ctx)
        return self.head(self.lnf(x))


class RaggedStepModel(nn.Module):
    """One ragged engine step over a ``GPTLM``'s weights (shared, not
    copied). ``forward`` takes the step's feeds as device tensors and
    the per-layer pools, writes this step's K/V into the pools in
    place and returns the greedy token at every chunk position,
    [R * C] int64 (the engine reads the last valid column of a plain
    row)."""

    def __init__(self, lm: GPTLM, geom: CacheGeometry, chunk: int):
        super().__init__()
        self.lm = lm
        self.geom = geom
        self.chunk = int(chunk)

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor, pos_ids: torch.Tensor,
                positions: torch.Tensor, num_valid: torch.Tensor,
                tables: torch.Tensor, k_pages: List[torch.Tensor],
                v_pages: List[torch.Tensor]) -> torch.Tensor:
        lm, cfg = self.lm, self.lm.cfg
        R, C = tokens.shape
        h = cfg.hidden_size
        x = lm.tok_emb[tokens] + lm.pos_emb[pos_ids]              # [R, C, h]
        targets = kv_write_targets(tables, positions, num_valid, C,
                                   self.geom.page_size)
        for i, lyr in enumerate(lm.layers):
            q, k, v = lyr.qkv(lyr.ln1(x)).split(h, dim=-1)
            kv_cache_write(k_pages[i], v_pages[i], lm.split_heads(k),
                           lm.split_heads(v), tables, positions, num_valid,
                           targets=targets)
            ctx = ragged_paged_attention(
                lm.split_heads(q).contiguous(), k_pages[i], v_pages[i],
                positions, num_valid, tables)
            x = lyr.proj_ffn(x, ctx.reshape(R, C, h))
        logits = lm.head(lm.lnf(x))                               # [R, C, V]
        return torch.argmax(logits.reshape(R * C, -1), dim=-1)


def load_jax_params(module: GPTLM,
                    params: Dict[str, Union[np.ndarray, torch.Tensor]]) -> None:
    """Copy the JAX package's weights onto ``module``: every
    ``__params__.npz`` name maps one to one (fc weights are [in, out] on
    both sides). numpy arrays and tensors (on any device) are taken.
    Raises on a missing name, a name the model does not have (weights
    of a deeper or different model) or a wrong shape."""
    mine = module.jax_params()
    missing = sorted(set(mine) - set(params))
    if missing:
        raise KeyError(f"load_jax_params: missing {missing}")
    extra = sorted(set(params) - set(mine))
    if extra:
        raise KeyError(f"load_jax_params: unexpected {extra}")
    for name, dst in mine.items():
        src = params[name]
        shape = tuple(src.shape)
        if shape != tuple(dst.shape):
            raise ValueError(f"load_jax_params: {name} has shape {shape}, "
                             f"the model wants {tuple(dst.shape)}")
        t = src if isinstance(src, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(src))
        with torch.no_grad():
            dst.copy_(t.to(device=dst.device, dtype=dst.dtype))


def step_feeds(tokens: np.ndarray, pos_ids: np.ndarray, positions: np.ndarray,
               num_valid: np.ndarray, tables: np.ndarray,
               device: Optional[torch.device]):
    """Host feeds of one step -> device tensors in the dtypes the step
    takes (int64 token/position ids, int32 starts, counts and tables)."""
    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dt)
    return (dev(tokens, torch.long), dev(pos_ids, torch.long),
            dev(positions, torch.int32), dev(num_valid, torch.int32),
            dev(tables, torch.int32))
