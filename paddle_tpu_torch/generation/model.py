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
* ``PrefillStepModel`` / ``DecodeStepModel`` — the two lanes of the
  two_lane engine (``build_prefill_program``, :187, and
  ``build_decode_program``, :308). Prefill forwards a ``[n, bucket]``
  prompt window with causal attention (the LM's plain attention, as
  both JAX programs use ``nets.scaled_dot_product_attention``; the
  flash kernel K6 when the config asks for ``use_flash_attention``),
  writes the prompt rows' K/V into the pools and takes the greedy
  token at each row's last true position. Decode runs one token a
  lane: per layer ln -> qkv -> the in-place write of the new row -> the
  paged decode attention (K13) over the pool -> proj/ffn, then the
  head and the argmax. JAX runs the head over the whole ``[B, S, V]``
  window and selects the last row with a one-hot product; the port
  selects the row's hidden state first and runs the final layer norm
  and the head on it alone (the same values row by row, without the
  ``bucket x vocab`` logits).
* ``load_jax_params`` — carries the JAX package's weights (the names of
  ``__params__.npz``) onto a ``GPTLM``; ``share_params`` makes a
  ``GPTLM``'s parameters THE tensors of a scope (no copy), which is how
  the Program Predictor of an LM directory hands the engine its weights.
* ``build_lm_program`` — the loss-free LM as a Program (``:159`` there,
  with its helpers ``_ln`` ... ``_pos_embed``, :92-156): what
  ``save_inference_model`` writes for the Predictor and the engine.
* ``build_prefill_program`` / ``build_decode_program`` /
  ``build_ragged_step_program`` — the serving steps as Programs
  (:187, :308, :238), with JAX's feed names and fetch order (below).
  They run through the ``Executor`` on the scope of the LM's weights
  (the same parameter names): the ops ``kv_cache_write[_q]``,
  ``ragged_paged_attention[_q]`` and ``paged_attention`` reach K2, K2q
  and K13, the layer norms K1, and after ``adapters.rewrite_for_lora``
  the ``batched_lora_*`` ops K12 (K11 under a quantized base). Unlike
  the modules, a Program step returns NEW pools and leaves the fed ones
  as they are, as JAX's does.

  Feed names: ``gen_tokens`` [B, S] / [B, 1] / [B, chunk] int64;
  ``gen_pos_ids`` [B, chunk] int64 (ragged: each token's absolute
  position); ``gen_positions`` [B] int64 (the first new row's absolute
  slot: prefill 0, decode the length, ragged the chunk start);
  ``gen_num_valid`` [B] int32 (real rows of the window);
  ``gen_attend_lens`` [B] int32 (decode: position + 1);
  ``gen_last_index`` [B] int64 (prefill: length - 1);
  ``gen_block_tables`` [B, max_pages_per_seq] int32;
  ``gen_k_pages_{l}`` / ``gen_v_pages_{l}`` the pools, and for int8
  pools ``gen_k_scales_{l}`` / ``gen_v_scales_{l}`` [kv_heads, pages,
  page_size] float32.

Every matmul of the model is a ``Dense`` named by its JAX weight
(``dec0_qkv.w`` ...). ``quantize.rewrite_for_inference`` replaces them
in place by ``QuantizedDense`` (int8 / int8_block / fp8 weight through
the K11 kernel), so the predictor and the steps, which share the
modules, share one set of quantized weights. The step's adapter seam
(``adapters.rewrite_for_lora``, the ``batched_lora`` ops of the JAX
ragged program) is a per-step ``LoraBatch`` handed down to the dense
layers: the predictor never sees it.

Numerics follow the JAX package: qkv splits q|k|v along the last dim,
heads are head-major ``[..., H, D]``, layer norm has eps 1e-5 and
population variance, the FFN uses exact erf GELU. Weights are kept in
the JAX layout, fc weights ``[in, out]`` (``x @ w + b``), so the carry
is one to one.

The step writes the page pools IN PLACE (the JAX program returns new
pools that the engine swaps in). Within a layer the chunk's K/V is
written before the attention reads it; int8 pools
(``kv_dtype="int8"``) take ``quantized_kv_cache_write`` and the K2q
attention, with their scale planes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import layers, nets
from ..core.framework import Program, program_guard, unique_name
from ..kernels import (batched_lora_add_, flash_attention, kv_cache_write,
                       kv_write_targets, layer_norm, paged_attention,
                       quantized_kv_cache_write, quantized_matmul,
                       ragged_paged_attention)
from ..kernels.flash_attention import flash_attention_layer
from ..kernels.paged_attention import (kv_cache_write_layer,
                                       paged_attention_layer)
from ..kernels.ragged_paged_attention import (quantized_kv_cache_write_layer,
                                              ragged_paged_attention_layer)
from ..models.gpt import GPTConfig, _attr
from ..param_attr import ParamAttr

__all__ = ["CacheGeometry", "GPTLM", "RaggedStepModel", "PrefillStepModel",
           "build_prefill_program", "build_decode_program",
           "build_ragged_step_program",
           "DecodeStepModel", "load_jax_params", "share_params",
           "build_lm_program", "GPTConfig", "LN_EPS", "Dense",
           "QuantizedDense", "LoraBatch"]

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


class LoraBatch:
    """One step's adapter routing: per target, the store's pools, and
    the step's slot rows ``[R, n_buckets]`` (int32, on the device)."""

    def __init__(self, store, targets, slots: torch.Tensor):
        self.store = store
        self.targets = targets
        self.slots = slots

    def lookup(self, name: str):
        """(A pools, B pools, scales, slots) for a repointed target,
        None for any other weight."""
        if name not in self.targets:
            return None
        a, b, sc = self.store.pools(name)
        return a, b, sc, self.slots


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` kept ``[in, out]`` as the JAX package
    stores it (``layers.fc`` with ``num_flatten_dims`` = rank - 1).
    ``name`` is the weight's JAX name. With a ``LoraBatch`` that covers
    it, the product takes the rows' adapter deltas before the bias (the
    JAX ``batched_lora_fc`` then ``elementwise_add``)."""

    base_kind = "dense"

    def __init__(self, n_in: int, n_out: int, device, dtype, name: str = ""):
        super().__init__()
        self.name = name
        self.w = _param((n_in, n_out), device, dtype)
        self.b = _param((n_out,), device, dtype)

    def product(self, x2: torch.Tensor) -> torch.Tensor:
        return x2 @ self.w

    def forward(self, x: torch.Tensor,
                lora: Optional[LoraBatch] = None) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        ad = lora.lookup(self.name) if lora is not None else None
        if ad is None and self.base_kind == "dense":
            y = torch.addmm(self.b, x2, self.w)
        else:
            y = self.product(x2)
            if ad is not None:
                batched_lora_add_(y, x2.contiguous(), *ad)
            y = y + self.b
        return y.reshape(*lead, y.shape[-1])


class QuantizedDense(Dense):
    """A ``Dense`` whose weight is held quantized (``qweight`` + its
    ``scale`` plane, ``quantize_weight``'s formats) and multiplied by
    ``quantized_matmul`` (K11 on CUDA), then ``+ b`` as the JAX
    ``quantized_fc`` + ``elementwise_add``. Made by
    ``quantize.rewrite_for_inference`` from a ``Dense``, whose bias it
    keeps; the float weight is not kept."""

    def __init__(self, dense: Dense, qweight: torch.Tensor,
                 scale: torch.Tensor, mode: str, block: int):
        nn.Module.__init__(self)
        self.name = dense.name
        self.b = dense.b
        self.register_buffer("qweight", qweight)
        self.register_buffer("scale", scale)
        self.mode = mode
        self.block = int(block)

    @property
    def base_kind(self) -> str:
        return self.mode

    def product(self, x2: torch.Tensor) -> torch.Tensor:
        return quantized_matmul(x2, self.qweight, self.scale, mode=self.mode,
                                block=self.block)


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
    DENSE = ("qkv", "proj", "ffn1", "ffn2")   # in the program's order

    def __init__(self, cfg: GPTConfig, device, dtype, prefix: str):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_size
        self.ln1 = LayerNorm(h, device, dtype)
        self.qkv = Dense(h, 3 * h, device, dtype, f"{prefix}_qkv.w")
        self.proj = Dense(h, h, device, dtype, f"{prefix}_proj.w")
        self.ln2 = LayerNorm(h, device, dtype)
        self.ffn1 = Dense(h, f, device, dtype, f"{prefix}_ffn1.w")
        self.ffn2 = Dense(f, h, device, dtype, f"{prefix}_ffn2.w")

    def proj_ffn(self, x: torch.Tensor, ctx: torch.Tensor,
                 lora: Optional[LoraBatch] = None) -> torch.Tensor:
        """The post-attention half (``_proj_ffn`` in JAX), shared by the
        LM and the ragged step so they can only differ in attention."""
        x = x + self.proj(ctx, lora)
        return x + self.ffn2(F.gelu(self.ffn1(self.ln2(x), lora)), lora)


class GPTLM(nn.Module):
    """Causal LM: tokens [B, S] -> logits [B, S, V]. Parameters are
    allocated uninitialised; ``load_jax_params`` fills them."""

    def __init__(self, cfg: GPTConfig, device: Union[str, torch.device],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.moe_every:
            # the JAX generation model builds dense FFNs only
            # (paddle_tpu/generation/model.py:117-137); a MoE Program
            # serves through the Program Predictor
            raise NotImplementedError(
                "GPTLM (the generation engines' model) has dense FFNs only, "
                "as the JAX package's generation model does: serve a MoE "
                "GPT's saved Program through inference.create_predictor")
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError("hidden_size must be a multiple of num_heads")
        self.cfg = cfg
        h = cfg.hidden_size
        self.tok_emb = _param((cfg.vocab_size, h), device, dtype)
        self.pos_emb = _param((cfg.max_position, h), device, dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype, f"dec{i}")
            for i in range(cfg.num_layers))
        self.lnf = LayerNorm(h, device, dtype)
        self.head = Dense(h, cfg.vocab_size, device, dtype, "gpt_head.w")

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_emb.dtype

    def param_slots(self):
        """(``__params__.npz`` name, owner module, attribute) of every
        float parameter (a quantized weight is held as ``qweight`` +
        ``scale`` and is not listed)."""
        yield "gpt_tok_emb", self, "tok_emb"
        yield "gpt_pos_emb", self, "pos_emb"
        yield "gpt_lnf.scale", self.lnf, "scale"
        yield "gpt_lnf.bias", self.lnf, "bias"
        for i, lyr in enumerate(self.layers):
            pre = f"dec{i}"
            for ln in ("ln1", "ln2"):
                mod = getattr(lyr, ln)
                yield f"{pre}_{ln}.scale", mod, "scale"
                yield f"{pre}_{ln}.bias", mod, "bias"
            for fc in DecoderLayer.DENSE:
                mod = getattr(lyr, fc)
                if mod.base_kind == "dense":
                    yield f"{pre}_{fc}.w", mod, "w"
                yield f"{pre}_{fc}.b", mod, "b"
        if self.head.base_kind == "dense":
            yield "gpt_head.w", self.head, "w"
        yield "gpt_head.b", self.head, "b"

    def jax_params(self) -> Dict[str, torch.Tensor]:
        """Every float parameter under its ``__params__.npz`` name."""
        return {name: getattr(owner, attr)
                for name, owner, attr in self.param_slots()}

    def dense_layers(self):
        """(parent module, attribute, Dense) of every matmul weight, in
        the order the JAX program consumes them (per layer qkv, proj,
        ffn1, ffn2, then the head): what the quantize and LoRA rewrites
        walk."""
        for lyr in self.layers:
            for fc in DecoderLayer.DENSE:
                yield lyr, fc, getattr(lyr, fc)
        yield self, "head", self.head

    def embedding_tables(self):
        """The 2-D float tables no matmul consumes, with the op that
        reads them in the JAX program (the rewrite reports why they
        stay float)."""
        return (("gpt_tok_emb", self.tok_emb, "lookup_table:W"),
                ("gpt_pos_emb", self.pos_emb, "lookup_table:W"))

    def split_heads(self, t: torch.Tensor) -> torch.Tensor:
        """[..., H*D] -> [..., H, D] (head-major, as the JAX reshape)."""
        nh = self.cfg.num_heads
        return t.reshape(*t.shape[:-1], nh, t.shape[-1] // nh)

    def causal_attention(self, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
        """Plain causal softmax attention over [B, S, H*D] q, k, v, as
        ``nets.scaled_dot_product_attention`` writes it: -1e9 added above
        the diagonal, then softmax. Returns [B, S, H*D]."""
        B, S, h = q.shape
        mask = torch.triu(torch.full((S, S), -1e9, device=q.device,
                                     dtype=torch.float32), diagonal=1)
        q, k, v = (self.split_heads(t).transpose(1, 2) for t in (q, k, v))
        d = q.shape[-1]
        logits = (q * d ** -0.5) @ k.transpose(-1, -2)
        w = torch.softmax(logits.float() + mask, dim=-1).to(v.dtype)
        return (w @ v).transpose(1, 2).reshape(B, S, h)

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        if S > self.cfg.max_position:
            raise ValueError(f"sequence of {S} tokens exceeds max_position "
                             f"{self.cfg.max_position}")
        tokens = tokens.to(self.device, torch.long)
        pos = torch.arange(S, device=self.device)
        x = self.tok_emb[tokens] + self.pos_emb[pos][None]
        h = self.cfg.hidden_size
        for lyr in self.layers:
            q, k, v = lyr.qkv(lyr.ln1(x)).split(h, dim=-1)
            x = lyr.proj_ffn(x, self.causal_attention(q, k, v))
        return self.head(self.lnf(x))


class RaggedStepModel(nn.Module):
    """One ragged engine step over a ``GPTLM``'s weights (shared, not
    copied). ``forward`` takes the step's feeds as device tensors and
    the per-layer pools (and, for int8 pools, their scale planes),
    writes this step's K/V into the pools in place and returns the
    greedy token at every chunk position, [R * C] int64 (the engine
    reads the last valid column of a plain row). After
    ``adapters.rewrite_for_lora`` it also takes ``adapter_slots`` [R,
    n_buckets]: each row's adapter deltas join the repointed weights'
    products."""

    def __init__(self, lm: GPTLM, geom: CacheGeometry, chunk: int):
        super().__init__()
        self.lm = lm
        self.geom = geom
        self.chunk = int(chunk)
        # set by adapters.rewrite_for_lora: the store and the names of
        # the weights whose products take adapter deltas
        self.adapter_store = None
        self.lora_targets: frozenset = frozenset()

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor, pos_ids: torch.Tensor,
                positions: torch.Tensor, num_valid: torch.Tensor,
                tables: torch.Tensor, k_pages: List[torch.Tensor],
                v_pages: List[torch.Tensor],
                k_scales: Optional[List[torch.Tensor]] = None,
                v_scales: Optional[List[torch.Tensor]] = None,
                adapter_slots: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        lm, cfg = self.lm, self.lm.cfg
        R, C = tokens.shape
        h = cfg.hidden_size
        lora = None
        if adapter_slots is not None and self.lora_targets:
            lora = LoraBatch(self.adapter_store, self.lora_targets,
                             adapter_slots)
        x = lm.tok_emb[tokens] + lm.pos_emb[pos_ids]              # [R, C, h]
        targets = kv_write_targets(tables, positions, num_valid, C,
                                   self.geom.page_size)
        for i, lyr in enumerate(lm.layers):
            q, k, v = lyr.qkv(lyr.ln1(x), lora).split(h, dim=-1)
            k, v = lm.split_heads(k), lm.split_heads(v)
            if k_scales is not None:
                quantized_kv_cache_write(
                    k_pages[i], v_pages[i], k_scales[i], v_scales[i], k, v,
                    tables, positions, num_valid, targets=targets)
                scales = dict(k_scales=k_scales[i], v_scales=v_scales[i])
            else:
                kv_cache_write(k_pages[i], v_pages[i], k, v, tables,
                               positions, num_valid, targets=targets)
                scales = {}
            ctx = ragged_paged_attention(
                lm.split_heads(q).contiguous(), k_pages[i], v_pages[i],
                positions, num_valid, tables, **scales)
            x = lyr.proj_ffn(x, ctx.reshape(R, C, h), lora)
        logits = lm.head(lm.lnf(x), lora)                         # [R, C, V]
        return torch.argmax(logits.reshape(R * C, -1), dim=-1)


class PrefillStepModel(nn.Module):
    """The two_lane engine's prefill lane over a ``GPTLM``'s weights
    (shared). ``forward`` takes a ``[n, bucket]`` window of prompts
    (row i holds ``num_valid[i]`` true tokens from position 0, then
    padding), the rows' block tables and the per-layer pools; it writes
    every true row's K/V into the pools in place and returns the greedy
    next token of each row, [n] int64. ``use_flash`` attends with the
    flash kernel (K6 on CUDA) instead of the plain causal attention."""

    def __init__(self, lm: GPTLM, geom: CacheGeometry,
                 use_flash: bool = False):
        super().__init__()
        self.lm = lm
        self.geom = geom
        self.use_flash = bool(use_flash)

    def _attend(self, q, k, v):
        if not self.use_flash:
            return self.lm.causal_attention(q, k, v)
        n, S, h = q.shape
        q, k, v = (self.lm.split_heads(t).transpose(1, 2) for t in (q, k, v))
        return flash_attention(q, k, v, causal=True).transpose(1, 2).reshape(
            n, S, h)

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor, num_valid: torch.Tensor,
                tables: torch.Tensor, k_pages: List[torch.Tensor],
                v_pages: List[torch.Tensor]) -> torch.Tensor:
        lm, cfg = self.lm, self.lm.cfg
        n, S = tokens.shape
        h = cfg.hidden_size
        dev = tokens.device
        x = lm.tok_emb[tokens] + lm.pos_emb[:S][None]             # [n, S, h]
        positions = torch.zeros(n, dtype=torch.int32, device=dev)
        targets = kv_write_targets(tables, positions, num_valid, S,
                                   self.geom.page_size)
        for i, lyr in enumerate(lm.layers):
            q, k, v = lyr.qkv(lyr.ln1(x)).split(h, dim=-1)
            kv_cache_write(k_pages[i], v_pages[i], lm.split_heads(k),
                           lm.split_heads(v), tables, positions, num_valid,
                           targets=targets)
            x = lyr.proj_ffn(x, self._attend(q, k, v))
        last = x[torch.arange(n, device=dev), num_valid.long() - 1]  # [n, h]
        return torch.argmax(lm.head(lm.lnf(last)), dim=-1)


class DecodeStepModel(nn.Module):
    """The two_lane engine's decode lane over a ``GPTLM``'s weights
    (shared): one token a lane. ``forward`` takes the lanes' pending
    tokens [B], their positions (the current lengths) [B], ``num_valid``
    [B] (1 for an active lane, 0 for an idle one, whose write goes to
    the junk page), the lengths to attend ``lengths`` [B] (position + 1,
    0 for an idle lane: a zero row), the block tables and the pools. It
    writes each new row's K/V in place, attends through K13 and returns
    the greedy next token of every lane, [B] int64."""

    def __init__(self, lm: GPTLM, geom: CacheGeometry):
        super().__init__()
        self.lm = lm
        self.geom = geom

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                num_valid: torch.Tensor, lengths: torch.Tensor,
                tables: torch.Tensor, k_pages: List[torch.Tensor],
                v_pages: List[torch.Tensor]) -> torch.Tensor:
        lm, cfg = self.lm, self.lm.cfg
        B = tokens.shape[0]
        h = cfg.hidden_size
        x = (lm.tok_emb[tokens] + lm.pos_emb[positions.long()])[:, None]
        targets = kv_write_targets(tables, positions, num_valid, 1,
                                   self.geom.page_size)
        for i, lyr in enumerate(lm.layers):
            q, k, v = lyr.qkv(lyr.ln1(x)).split(h, dim=-1)  # [B, 1, h]
            kv_cache_write(k_pages[i], v_pages[i], lm.split_heads(k),
                           lm.split_heads(v), tables, positions, num_valid,
                           targets=targets)
            ctx = paged_attention(lm.split_heads(q[:, 0]).contiguous(),
                                  k_pages[i], v_pages[i], lengths, tables)
            x = lyr.proj_ffn(x, ctx.reshape(B, 1, h))
        return torch.argmax(lm.head(lm.lnf(x[:, 0])), dim=-1)


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


def share_params(module: GPTLM, tensors: Dict[str, torch.Tensor]) -> None:
    """Make every float parameter of ``module`` a Parameter over the
    tensor of the same ``__params__.npz`` name (storage shared, nothing
    copied): an in-place write to either side is seen by both. Raises
    like ``load_jax_params`` on a missing name or a wrong shape."""
    slots = list(module.param_slots())
    missing = sorted(n for n, _, _ in slots if n not in tensors)
    if missing:
        raise KeyError(f"share_params: missing {missing}")
    for name, owner, attr in slots:
        t = tensors[name]
        if tuple(t.shape) != tuple(getattr(owner, attr).shape):
            raise ValueError(f"share_params: {name} has shape "
                             f"{tuple(t.shape)}, the model wants "
                             f"{tuple(getattr(owner, attr).shape)}")
        setattr(owner, attr, nn.Parameter(t, requires_grad=False))


# -- the LM as a Program ------------------------------------------------------


def _ln(x, name):
    return layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{name}.scale"),
        bias_attr=ParamAttr(name=f"{name}.bias"))


def _qkv_split(x, cfg: GPTConfig, pre: str):
    qkv = layers.fc(
        x, 3 * cfg.hidden_size, num_flatten_dims=2,
        param_attr=_attr(f"{pre}_qkv.w", cfg.initializer_range),
        bias_attr=ParamAttr(name=f"{pre}_qkv.b"))
    return layers.split(qkv, 3, dim=2)


def _proj_ffn(x, ctx, cfg: GPTConfig, pre: str):
    """Post-attention half of the decoder layer."""
    h, std = cfg.hidden_size, cfg.initializer_range
    proj = layers.fc(
        ctx, h, num_flatten_dims=2,
        param_attr=_attr(f"{pre}_proj.w", std),
        bias_attr=ParamAttr(name=f"{pre}_proj.b"))
    x = layers.elementwise_add(x, proj)
    ln2 = _ln(x, f"{pre}_ln2")
    ffn1 = layers.fc(
        ln2, cfg.ffn_size, num_flatten_dims=2, act="gelu",
        param_attr=_attr(f"{pre}_ffn1.w", std),
        bias_attr=ParamAttr(name=f"{pre}_ffn1.b"))
    ffn2 = layers.fc(
        ffn1, h, num_flatten_dims=2,
        param_attr=_attr(f"{pre}_ffn2.w", std),
        bias_attr=ParamAttr(name=f"{pre}_ffn2.b"))
    return layers.elementwise_add(x, ffn2)


def _head(x, cfg: GPTConfig):
    x = _ln(x, "gpt_lnf")
    return layers.fc(
        x, cfg.vocab_size, num_flatten_dims=2,
        param_attr=_attr("gpt_head.w", cfg.initializer_range),
        bias_attr=ParamAttr(name="gpt_head.b"))


def _embed(tokens, cfg: GPTConfig):
    return layers.embedding(
        tokens, size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=_attr("gpt_tok_emb", cfg.initializer_range))


def _pos_embed(ids, cfg: GPTConfig):
    return layers.embedding(
        ids, size=[cfg.max_position, cfg.hidden_size],
        param_attr=_attr("gpt_pos_emb", cfg.initializer_range))


def _attention(q, k, v, cfg: GPTConfig):
    if cfg.use_flash_attention:
        return flash_attention_layer(q, k, v, cfg.num_heads, causal=True)
    return nets.scaled_dot_product_attention(q, k, v,
                                             num_heads=cfg.num_heads,
                                             causal=True)


def build_lm_program(cfg: GPTConfig, seq_len: int):
    """Loss-free causal LM: tokens [B, seq_len] -> logits [B, seq_len,
    V], as (main, startup, feeds, fetches). The positions are baked in
    (``assign(arange(seq_len))``), so the Program runs at its own
    sequence length; ``use_flash_attention`` emits the fused
    ``flash_attention`` op (K6 on the card)."""
    if cfg.moe_every:
        # the JAX package's build_lm_program ignores moe_every and builds
        # dense FFNs (paddle_tpu/generation/model.py:159-180), which a
        # MoE scope cannot feed; a MoE Program serves through the
        # Program Predictor
        raise NotImplementedError(
            "build_lm_program builds dense FFNs only, as the JAX package's "
            "does: save a MoE GPT's is_test Program (models.gpt."
            "build_gpt_lm) and serve it through inference.create_predictor")
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        tokens = layers.data("tokens", [seq_len], dtype="int64")
        x = layers.elementwise_add(
            _embed(tokens, cfg),
            _pos_embed(layers.assign(
                np.arange(seq_len, dtype="int64")[None, :]), cfg))
        for i in range(cfg.num_layers):
            pre = f"dec{i}"
            ln1 = _ln(x, f"{pre}_ln1")
            q, k, v = _qkv_split(ln1, cfg, pre)
            x = _proj_ffn(x, _attention(q, k, v, cfg), cfg, pre)
        logits = _head(x, cfg)
    return main, startup, {"tokens": tokens}, {"logits": logits}


def _page_feeds(cfg: GPTConfig, geom: CacheGeometry, dtype: str = "float32"):
    shape = [cfg.num_heads, geom.num_pages, geom.page_size,
             cfg.hidden_size // cfg.num_heads]
    kps = [layers.data(f"gen_k_pages_{i}", shape, append_batch_size=False,
                       dtype=dtype) for i in range(cfg.num_layers)]
    vps = [layers.data(f"gen_v_pages_{i}", shape, append_batch_size=False,
                       dtype=dtype) for i in range(cfg.num_layers)]
    return kps, vps


def _scale_feeds(cfg: GPTConfig, geom: CacheGeometry):
    shape = [cfg.num_heads, geom.num_pages, geom.page_size]
    kss = [layers.data(f"gen_k_scales_{i}", shape, append_batch_size=False)
           for i in range(cfg.num_layers)]
    vss = [layers.data(f"gen_v_scales_{i}", shape, append_batch_size=False)
           for i in range(cfg.num_layers)]
    return kss, vss


def build_prefill_program(cfg: GPTConfig, seq_len: int, geom: CacheGeometry):
    """The prefill lane: forward a [B, seq_len] prompt window, write its
    K/V into the pools, take the greedy token of each row's last true
    position (a one-hot product over the [B, S, V] logits, as JAX).
    Returns (program, fetches): [next_token, k_pages.., v_pages..]."""
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        tokens = layers.data("gen_tokens", [seq_len], dtype="int64")
        positions = layers.data("gen_positions", [], dtype="int64")
        num_valid = layers.data("gen_num_valid", [], dtype="int32")
        last_index = layers.data("gen_last_index", [], dtype="int64")
        tables = layers.data("gen_block_tables", [geom.max_pages_per_seq],
                             dtype="int32")
        kps, vps = _page_feeds(cfg, geom)
        x = layers.elementwise_add(
            _embed(tokens, cfg),
            _pos_embed(layers.assign(
                np.arange(seq_len, dtype="int64")[None, :]), cfg))
        out_pages = []
        for i in range(cfg.num_layers):
            pre = f"dec{i}"
            q, k, v = _qkv_split(_ln(x, f"{pre}_ln1"), cfg, pre)
            out_pages.append(kv_cache_write_layer(
                kps[i], vps[i], k, v, tables, positions, num_valid,
                cfg.num_heads))
            x = _proj_ffn(x, _attention(q, k, v, cfg), cfg, pre)
        logits = _head(x, cfg)                                  # [B, S, V]
        sel = layers.one_hot(layers.unsqueeze(last_index, [1]), seq_len)
        last_logits = layers.reduce_sum(
            layers.elementwise_mul(logits, layers.unsqueeze(sel, [2])),
            dim=[1])                                            # [B, V]
        next_tok = layers.argmax(last_logits, axis=-1)
    return main, ([next_tok] + [p[0] for p in out_pages]
                  + [p[1] for p in out_pages])


def build_ragged_step_program(cfg: GPTConfig, geom: CacheGeometry,
                              chunk: int, kv_dtype: str = "float32"):
    """One [lanes, chunk] mixed step (prefill chunks, decode rows, idle
    lanes): per layer the chunk's K/V into the pools (int8-quantized
    under ``kv_dtype="int8"``), then ragged paged attention over each
    row's prefix, and the argmax at every position. Returns (program,
    fetches): [next_tokens (R*C), k_pages.., v_pages.. (, k_scales..,
    v_scales..)]."""
    quantized = kv_dtype == "int8"
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        tokens = layers.data("gen_tokens", [chunk], dtype="int64")
        pos_ids = layers.data("gen_pos_ids", [chunk], dtype="int64")
        positions = layers.data("gen_positions", [], dtype="int64")
        num_valid = layers.data("gen_num_valid", [], dtype="int32")
        tables = layers.data("gen_block_tables", [geom.max_pages_per_seq],
                             dtype="int32")
        kps, vps = _page_feeds(cfg, geom, "int8" if quantized else "float32")
        kss = vss = [None] * cfg.num_layers
        if quantized:
            kss, vss = _scale_feeds(cfg, geom)
        x = layers.elementwise_add(_embed(tokens, cfg),
                                   _pos_embed(pos_ids, cfg))    # [R, C, H]
        out_pages = []
        for i in range(cfg.num_layers):
            pre = f"dec{i}"
            q, k, v = _qkv_split(_ln(x, f"{pre}_ln1"), cfg, pre)
            if quantized:
                ko, vo, kso, vso = quantized_kv_cache_write_layer(
                    kps[i], vps[i], kss[i], vss[i], k, v, tables,
                    positions, num_valid, cfg.num_heads)
            else:
                ko, vo = kv_cache_write_layer(
                    kps[i], vps[i], k, v, tables, positions, num_valid,
                    cfg.num_heads)
                kso = vso = None
            out_pages.append((ko, vo, kso, vso))
            ctx = ragged_paged_attention_layer(
                q, ko, vo, tables, positions, num_valid, cfg.num_heads,
                k_scales_var=kso, v_scales_var=vso)
            x = _proj_ffn(x, ctx, cfg, pre)
        logits = _head(x, cfg)                                  # [R, C, V]
        next_tok = layers.argmax(
            layers.reshape(logits, [-1, cfg.vocab_size]), axis=-1)
    fetches = ([next_tok] + [p[0] for p in out_pages]
               + [p[1] for p in out_pages])
    if quantized:
        fetches += [p[2] for p in out_pages] + [p[3] for p in out_pages]
    return main, fetches


def build_decode_program(cfg: GPTConfig, geom: CacheGeometry):
    """The decode lane: one new token a sequence through the paged
    cache (K13). Returns (program, fetches): [next_token, k_pages..,
    v_pages..]."""
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        tokens = layers.data("gen_tokens", [1], dtype="int64")
        positions = layers.data("gen_positions", [], dtype="int64")
        num_valid = layers.data("gen_num_valid", [], dtype="int32")
        attend = layers.data("gen_attend_lens", [], dtype="int32")
        tables = layers.data("gen_block_tables", [geom.max_pages_per_seq],
                             dtype="int32")
        kps, vps = _page_feeds(cfg, geom)
        x = layers.elementwise_add(
            layers.unsqueeze(_embed(tokens, cfg), [1]),
            layers.unsqueeze(_pos_embed(positions, cfg), [1]))  # [B, 1, H]
        out_pages = []
        for i in range(cfg.num_layers):
            pre = f"dec{i}"
            q, k, v = _qkv_split(_ln(x, f"{pre}_ln1"), cfg, pre)
            ko, vo = kv_cache_write_layer(
                kps[i], vps[i], k, v, tables, positions, num_valid,
                cfg.num_heads)
            out_pages.append((ko, vo))
            ctx = paged_attention_layer(q, ko, vo, tables, attend,
                                        cfg.num_heads)
            x = _proj_ffn(x, ctx, cfg, pre)
        logits = _head(x, cfg)                                  # [B, 1, V]
        next_tok = layers.argmax(
            layers.reshape(logits, [-1, cfg.vocab_size]), axis=-1)
    return main, ([next_tok] + [p[0] for p in out_pages]
                  + [p[1] for p in out_pages])


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
