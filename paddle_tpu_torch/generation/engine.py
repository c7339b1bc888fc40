"""GenerationEngine: continuous-batching autoregressive decode
(counterpart of ``paddle_tpu/generation/engine.py:330``), in two modes.

* ``mode="ragged"`` (the default, the ``generation_engine_mode`` flag):
  every step runs ONE [lanes, chunk] mixed batch (``RaggedStepModel``)
  in which each row is whatever its sequence needs: a prefill chunk,
  one decode token, a decode token plus k speculative draft tokens, or
  nothing (an idle lane). Prompts longer than ``chunk_tokens`` prefill
  in chunks across steps.
* ``mode="two_lane"``: the JAX package's token-identity oracle of the
  ragged engine (its :41-46). Admitted prompts prefill in one call per
  sequence bucket (``PrefillStepModel``): the prompt length rounds up
  the ladder ``prefill_buckets`` (the ``generation_prefill_buckets``
  flag; ``max_position`` is always on it), so the window shapes stay in
  a small fixed set. Then every step decodes one token a lane
  (``DecodeStepModel``, the paged decode-attention kernel K13) over the
  fixed lane count, idle lanes as length-0 rows. JAX also pads the
  prefill batch to the lane count so that one compiled executable
  serves each bucket; eager PyTorch has no executable to reuse, so the
  port's prefill batch is the admitted rows only, and padding rows
  would be pure device work. int8 KV pages, speculative decoding, the
  prefix cache and adapters stay ragged-only (the JAX package's
  ``ValueError``s); quantized weights apply to the shared modules.

Speculative decoding (``spec_tokens`` + a ``draft``, the JAX engine's
:392-406, :1211-1290, :1392-1417): each step one batched
``draft.propose`` covers every decoding row (the full spec window,
trimmed per row by ``_spec_budget``); a row ``[pending] + drafts`` at
positions ``L0...`` is verified in the same ragged step (the target's
argmax at chunk position j IS the greedy token after position L0 + j),
and the accepted prefix plus one correction token emit together, so the
stream is greedy-identical whatever the draft proposed. A draft that
raises sends no drafts that step. The draft runs eagerly outside the
step's CUDA graph; the step is the same graph whether spec is on or off.
A draft with a ``device`` other than the engine's is refused.

The radix prefix cache (``prefix_cache``, :432-458, :960-968,
:1385-1417, :1558-1574 there): admission attaches a prompt's matched
prefix pages by reference (``PagedKVCache.acquire``) and chunked
prefill starts at the fork point; full pages publish into the trie
after every prefill chunk and every decode / verify step and at
retirement, attributed to ``submit(tenant=)``. The trie keys a page by
its tokens alone, so the port refuses ``prefix_cache`` together with an
adapter store, where the JAX engine would attach one adapter's K/V to
another adapter's row.

K/V lives in a paged pool (``PagedKVCache``) written in place by the
steps. The fixed-shape step of each mode (the ragged step; the two_lane
decode step) is bound once for the engine's life
(``runtime.graphs.GraphedStep``, as the JAX engine's ``_ragged_bound``
/ ``_decode_bound``): on the card it is captured as a CUDA graph after
the warm-up and replayed every step; a capture that fails raises from
the constructor. Tokens stream out through ``GenerationStream``s; stop conditions
are max_new_tokens, EOS, deadline, cancel and close.

Backpressure and eviction as in the JAX engine: a full queue, or a
prompt that could never fit the pool, raises ``Overloaded`` at
``submit`` before any work; a pool that runs dry mid-decode evicts the
youngest sequence (its request re-queues at the head and re-prefills
prompt + generated tokens, which greedy decode continues identically).

A step that raises turns into errors on that step's requests
(``ServingError``), never a dead loop: the caller sees the failure on
its stream. The loop thread owns all device work; client threads only
read streams.

Quantized, multi-adapter serving (the JAX engine's :407-420, :493-567):

* ``kv_dtype="int8"`` (or the ``generation_kv_dtype`` flag) keeps the
  KV cache in int8 pages with per-(head, slot) scales: the step writes
  them with ``quantized_kv_cache_write`` and attends with K2q.
* ``quantize_weights`` ("int8" | "int8_block" | "fp8"; the parameter,
  else the ``quantize_weights`` flag, block ``quantize_block``)
  quantizes the shared model once (``quantize.rewrite_for_inference``)
  unless the predictor already did at load; the matmuls run K11.
* ``adapter_store=`` (or ``adapter_pool_max_bytes`` > 0, which builds
  one from the ``adapter_*`` flags) multiplexes LoRA adapters per row
  over the base, quantized or not: ``submit(..., adapter=id)`` pins a
  resident adapter (``AdapterMissing`` otherwise) until the request
  ends, each step feeds the rows' ``[lanes, n_buckets]`` slots, and the
  deltas run K12. A force-evicted adapter fails its own rows at the
  next step, never the batch.

Hot base swap (``swap_base``, the JAX engine's :799-868): a
signature-identical weight set (every name already served, same shape)
is staged on the caller's thread (moved to the device and, for a
quantized base, quantized into each layer's mode and block), then
copied by the loop thread between two steps INTO the tensors the step
reads, under the loop's own order: no step mixes old and new weights,
no request fails, and the captured CUDA graph, which replays fixed
addresses, serves the new weights with no recapture. The Program
Predictor of an LM directory shares these tensors, so it serves them
too, and so does a ``HostDraft.from_predictor`` draft, which shares the
float tensors: after a swap it proposes from the new weights. The
radix trie is not cleared, as in the JAX engine: pages published
before a swap hold the old weights' K/V.

The page-store seam (``page_store=``, ``phase=``, the JAX engine's
:360, :464-467, :1094-1175): with a store (``disagg.HostPageStore`` or a
``PageStoreClient``) and the prefix cache on, the loop thread consults
the store for queue-head prompts before a cold prefill and splices any
stored run into its pool in place (``PagedKVCache.ingest_run``);
``spill_run`` exports a prompt's finished pages to the store (any
thread, in the ``disagg_wire_encoding`` wire form) and ``close(drain=
True)`` spills the whole trie. A store that errors degrades to a cold
prefill and counts ``store_errors_total``. The store keys a page by its
tokens alone, so a page store together with an adapter store is
refused (``ValueError``), as the prefix cache with adapters is.
``phase`` ("prefill" / "decode" / "both") is the routing label
``/healthz`` and the traffic tier report.

The engine registers with the process-wide metrics registry
(``watch_generation``: ``paddle_generation_*{engine=}``) and opens the
``generation/submit`` and ``generation/ragged_step`` spans.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..adapters import AdapterMissing, AdapterStore, rewrite_for_lora
from ..device import concrete_device
from ..flags import flag
from ..kernels.ragged_paged_attention import MAX_CHUNK
from ..kernels.quant_matmul import quantize_weight
from ..observability import tracing
from ..quantize import rewrite_for_inference
from ..runtime.graphs import GraphedStep
from ..serving.engine import (DeadlineExceeded, EngineClosed, Overloaded,
                              RequestCancelled, ServingError)
from ..serving.metrics import StreamingHistogram
from .kvcache import PagedKVCache, PagePoolExhausted
from .model import (CacheGeometry, DecodeStepModel, PrefillStepModel,
                    QuantizedDense, RaggedStepModel)

__all__ = ["GenerationEngine", "GenerationStream", "GenerationMetrics"]

_DONE = object()  # stream sentinel

class GenerationStream:
    """Per-request handle: an iterator over tokens as they are sampled,
    plus future-style ``result()``/``cancel()``. One of
    ``finish_reason`` in {"eos", "length", "deadline", "cancelled",
    "closed", "capacity", "error"} is set by the time iteration ends."""

    def __init__(self, engine: "GenerationEngine", on_token=None):
        self._engine = engine
        self._q: "collections.deque" = collections.deque()
        self._cond = threading.Condition()
        self._done = threading.Event()
        self._on_token = on_token
        self._tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._cancelled = False
        self.first_token_at: Optional[float] = None
        self._callbacks: List = []
        # speculative-decoding accounting: every emitted token is
        # verified by the target; accepted_draft_tokens counts those the
        # draft proposed (0 with speculation off)
        self.verified_tokens = 0
        self.accepted_draft_tokens = 0

    def usage(self) -> Dict[str, int]:
        """The response's ``usage`` fragment."""
        return {"completion_tokens": len(self._tokens),
                "verified_tokens": int(self.verified_tokens),
                "accepted_draft_tokens": int(self.accepted_draft_tokens)}

    # -- engine side ---------------------------------------------------------
    def _push(self, token: int) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self._tokens.append(int(token))
        with self._cond:
            self._q.append(int(token))
            self._cond.notify_all()
        if self._on_token is not None:
            try:
                self._on_token(int(token))
            except Exception:  # noqa: BLE001 — a bad callback is the caller's bug
                pass

    def _finish(self, reason: str, error: Optional[BaseException] = None):
        if self._done.is_set():
            return
        self.finish_reason = reason
        self.error = error
        self._done.set()
        with self._cond:
            self._q.append(_DONE)
            self._cond.notify_all()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a bad callback is the caller's bug
                pass

    def add_done_callback(self, fn) -> None:
        """``fn(self)`` once the stream reaches a terminal state
        (immediately if it already has)."""
        with self._cond:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:  # noqa: BLE001
            pass

    # -- caller side ---------------------------------------------------------
    def __iter__(self):
        while True:
            with self._cond:
                while not self._q:
                    self._cond.wait(0.1)
                item = self._q.popleft()
            if item is _DONE:
                if self.error is not None:
                    raise self.error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finishes; the full generated token
        list (raises the terminal error of a rejected/failed request)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"generation not finished within {timeout}s")
        if self.error is not None:
            raise self.error
        return list(self._tokens)

    @property
    def tokens(self) -> List[int]:
        """Tokens sampled so far (grows while streaming)."""
        return list(self._tokens)

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Request cancellation; the step loop retires the sequence at
        the next step boundary. False if already finished."""
        if self._done.is_set():
            return False
        self._cancelled = True
        self._engine._kick()
        return True


class _GenRequest:
    __slots__ = ("prompt", "orig_prompt", "max_new", "eos_id", "deadline",
                 "stream", "enqueue_t", "slot", "pending", "n_generated",
                 "ctx", "admit_seq", "last_tok_t", "prefill_off", "drafts",
                 "tenant", "store_checked", "adapter")

    def __init__(self, prompt, max_new, eos_id, deadline, stream,
                 adapter=None, tenant=None, ctx=None):
        self.prompt = prompt            # context to prefill (grows on resume)
        self.orig_prompt = prompt       # the caller's prompt, immutable
        self.max_new = max_new
        self.eos_id = eos_id
        self.deadline = deadline        # absolute monotonic or None
        self.stream = stream
        self.enqueue_t = time.monotonic()
        self.slot: Optional[int] = None
        self.pending: Optional[int] = None   # sampled, K/V not yet cached
        self.n_generated = 0                 # across evict/resume cycles
        self.ctx = ctx                       # tracing ctx of the submit span
        self.admit_seq = 0                   # admission order (evict victim)
        self.last_tok_t: Optional[float] = None
        self.prefill_off = 0            # prompt tokens already written
        self.drafts = None              # this step's speculative proposals
        self.tenant = tenant            # identity trie publishes count to
        self.store_checked = False      # page-store consult done once
        self.adapter = adapter          # resident LoRA adapter id, or None


class GenerationMetrics:
    """Lock-protected counters + streaming histograms for the engine."""

    _COUNTERS = ("requests_total", "responses_total", "rejected_total",
                 "expired_total", "cancelled_total", "evicted_total",
                 "prefill_batches_total",
                 "decode_steps_total", "prefill_tokens_total",
                 "decode_tokens_total", "prefill_rows_total",
                 "decode_active_lane_steps_total",
                 "decode_capacity_lane_steps_total", "ragged_steps_total",
                 "prefill_chunks_total",
                 # speculative decoding
                 "spec_rounds_total", "spec_proposed_total",
                 "spec_accepted_total")

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {k: 0 for k in self._COUNTERS}
        self.ttft_ms = StreamingHistogram()
        self.itl_ms = StreamingHistogram()
        self.decode_step_ms = StreamingHistogram()
        self.prefill_ms = StreamingHistogram()
        self.queue_wait_ms = StreamingHistogram()
        self._queue_depth = 0
        self._active = 0
        self._decode_wall_s = 0.0

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def observe(self, hist: str, v: float) -> None:
        with self._lock:
            getattr(self, hist).record(v)

    def observe_decode_step(self, ms: float, active: int, lanes: int,
                            tokens: int) -> None:
        """One ragged step: ``active`` lanes did real work out of
        ``lanes`` and ``tokens`` tokens were emitted."""
        with self._lock:
            self.decode_step_ms.record(ms)
            self._decode_wall_s += ms / 1e3
            self._c["decode_steps_total"] += 1
            self._c["decode_tokens_total"] += tokens
            self._c["decode_active_lane_steps_total"] += active
            self._c["decode_capacity_lane_steps_total"] += lanes

    def set_gauges(self, queue_depth: int, active: int) -> None:
        with self._lock:
            self._queue_depth = queue_depth
            self._active = active

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._c)
            out["queue_depth"] = self._queue_depth
            out["active_seqs"] = self._active
            out["ttft_ms"] = self.ttft_ms.snapshot()
            out["itl_ms"] = self.itl_ms.snapshot()
            out["decode_step_ms"] = self.decode_step_ms.snapshot()
            out["prefill_ms"] = self.prefill_ms.snapshot()
            out["queue_wait_ms"] = self.queue_wait_ms.snapshot()
            cap = self._c["decode_capacity_lane_steps_total"]
            out["decode_occupancy"] = (
                round(self._c["decode_active_lane_steps_total"] / cap, 4)
                if cap else 0.0)
            out["decode_tokens_per_s"] = (
                round(self._c["decode_tokens_total"] / self._decode_wall_s, 2)
                if self._decode_wall_s > 0 else 0.0)
            # speculative decoding as ratios: draft acceptance, and
            # accepted draft tokens a spec round
            prop = self._c["spec_proposed_total"]
            out["spec_acceptance_rate"] = (
                round(self._c["spec_accepted_total"] / prop, 4)
                if prop else 0.0)
            rounds = self._c["spec_rounds_total"]
            out["spec_accepted_tokens_per_step"] = (
                round(self._c["spec_accepted_total"] / rounds, 4)
                if rounds else 0.0)
            return out


class GenerationEngine:
    """Continuous-batching ragged decode over a Predictor's weights.

        pred = create_predictor(Config(lm_model_dir))
        eng = GenerationEngine(pred, pred.gpt_config)
        stream = eng.submit([1, 5, 9], max_new_tokens=32, eos_id=2)
        for tok in stream: ...                         # tokens as sampled
        eng.generate([1, 5, 9])                        # sync helper
        eng.close(drain=True)
    """

    def __init__(self, predictor, config, *,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_decode_batch: Optional[int] = None,
                 queue_capacity: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 mode: Optional[str] = None,
                 chunk_tokens: Optional[int] = None,
                 spec_tokens: Optional[int] = None,
                 draft=None,
                 kv_dtype: Optional[str] = None,
                 quantize_weights: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 page_store=None, phase: Optional[str] = None,
                 adapter_store=None,
                 prefill_buckets=None, model_version: Optional[str] = None,
                 warmup: bool = False, start: bool = True):
        # precedence: parameter > flag
        mode = str(mode or flag("generation_engine_mode"))
        if mode not in ("ragged", "two_lane"):
            raise ValueError(
                f"generation_engine_mode must be 'ragged' or 'two_lane', "
                f"got {mode!r}")
        self.kv_dtype = str(kv_dtype if kv_dtype is not None
                            else flag("generation_kv_dtype"))
        if self.kv_dtype not in ("float32", "int8"):
            raise ValueError(f"kv_dtype must be 'float32' (the model's "
                             f"dtype) or 'int8'; got {self.kv_dtype!r}")
        # speculative decoding and the radix cache: parameter > flag; no
        # draft, no speculation (the JAX engine's :392-396, :432-434)
        self.spec_tokens = int(spec_tokens if spec_tokens is not None
                               else flag("generation_spec_tokens"))
        self._draft = draft
        if draft is None:
            self.spec_tokens = 0
        self.prefix_cache = bool(prefix_cache if prefix_cache is not None
                                 else flag("generation_prefix_cache"))
        # the JAX engine's ragged-only options (its :421-437, :558-561)
        if mode != "ragged":
            if self.kv_dtype == "int8":
                raise ValueError("int8 KV pages require the ragged engine "
                                 "(generation_engine_mode='ragged')")
            if self.spec_tokens:
                raise ValueError("speculative decoding requires the ragged "
                                 "engine (generation_engine_mode='ragged')")
            if self.prefix_cache:
                raise ValueError("prefix caching requires the ragged engine "
                                 "(generation_engine_mode='ragged')")
            if adapter_store is not None:
                raise ValueError(
                    "adapter multiplexing requires the ragged engine "
                    "(generation_engine_mode='ragged')")
        self.quantize_weights = str(
            quantize_weights if quantize_weights is not None
            else flag("quantize_weights")) or "off"
        self._quant_block = int(flag("quantize_block"))
        self.mode = mode
        self.config = config
        # the clone shares the weights; the engine's loop never contends
        # with the caller's predictor lock
        self._pred = predictor.clone()
        lm = self._pred.lm
        mine = self._pred.gpt_config
        shape = ("vocab_size", "hidden_size", "num_layers", "num_heads",
                 "ffn_size", "max_position")
        if any(getattr(config, f) != getattr(mine, f) for f in shape):
            raise ValueError(f"config {config} does not match the "
                             f"predictor's model {mine}")
        self.device = lm.device
        self.page_size = int(page_size or flag("generation_page_size"))
        self.num_pages = int(num_pages or flag("generation_num_pages"))
        self.lanes = int(max_decode_batch
                         or flag("generation_max_decode_batch"))
        self.queue_capacity = int(queue_capacity
                                  or flag("generation_queue_capacity"))
        self.default_max_new = int(flag("generation_max_new_tokens"))
        self.default_eos = eos_id
        draft_dev = getattr(self._draft, "device", None)
        if draft_dev is not None and (
                torch.device(draft_dev).type != self.device.type
                or concrete_device(draft_dev) != self.device):
            # the draft's forward would run where its weights lie, not
            # beside the engine's step
            raise ValueError(f"the draft is on {draft_dev}, the engine on "
                             f"{self.device}: build it on the engine's "
                             "device (HostDraft.from_predictor does)")
        if self._draft is not None and hasattr(self._draft, "min_rows"):
            # pin the draft's row bucket to the lane count: one row shape
            # for the engine's life
            self._draft.min_rows = max(int(self._draft.min_rows or 1),
                                       self.lanes)
        # a speculative row is [pending + k drafts] wide: the chunk holds
        # it
        self.chunk_tokens = max(2, int(chunk_tokens
                                       or flag("generation_chunk_tokens")),
                                self.spec_tokens + 1)
        if (mode == "ragged" and self.device.type == "cuda"
                and self.chunk_tokens > MAX_CHUNK):
            raise ValueError(f"chunk_tokens {self.chunk_tokens} exceeds the "
                             f"ragged attention kernel's {MAX_CHUNK}")
        max_seq = int(config.max_position)
        if prefill_buckets is None:
            prefill_buckets = tuple(
                int(x) for x in
                str(flag("generation_prefill_buckets")).split(",") if x)
        # the two_lane prefill ladder; max_position is always on it
        self._seq_buckets = tuple(sorted(
            {min(int(b), max_seq) for b in prefill_buckets} | {max_seq}))
        maxp = -(-max_seq // self.page_size)
        self.geom = CacheGeometry(num_pages=self.num_pages,
                                  page_size=self.page_size,
                                  max_pages_per_seq=maxp)
        self.cache = PagedKVCache(
            config.num_layers, config.num_heads,
            config.hidden_size // config.num_heads,
            num_pages=self.num_pages, page_size=self.page_size,
            max_seqs=self.lanes, max_pages_per_seq=maxp,
            device=self.device,
            dtype="int8" if self.kv_dtype == "int8" else lm.dtype,
            prefix_cache=self.prefix_cache,
            prefix_min_pages=int(flag("generation_prefix_min_pages")),
            trie_max_pages=int(flag("generation_trie_max_pages")),
            tenant_quota_pages=int(flag("generation_trie_tenant_quota")))
        # the disagg seam: a page store makes this engine a citizen of the
        # split topology (_consult_store before a cold prefill,
        # spill_run / spill_trie back); ``phase`` is its routing label
        self._page_store = page_store
        self.phase = str(phase) if phase else "both"
        self._wire_encoding = str(flag("disagg_wire_encoding"))
        self.store_lookups_total = 0
        self.store_hits_total = 0
        self.store_pages_pulled_total = 0
        self.store_pages_spilled_total = 0
        self.store_errors_total = 0
        self.metrics = GenerationMetrics()
        # ragged: THE step, one mixed prefill+decode model for the
        # engine's life; two_lane: the prefill and decode lanes. All
        # share the predictor's modules (and so its quantized weights).
        if mode == "ragged":
            self._step_model = RaggedStepModel(lm, self.geom,
                                               self.chunk_tokens)
        else:
            self._prefill_model = PrefillStepModel(
                lm, self.geom,
                use_flash=bool(getattr(config, "use_flash_attention",
                                       False)))
            self._decode_model = DecodeStepModel(lm, self.geom)
        # weight quantization: the model is shared with the caller's
        # predictor, so it is quantized once for both (a no-op check of
        # mode and block when the predictor already did at load)
        # (a Program predictor rewrites its Program and scope, and its
        # module over the scope's quantized tensors: Predictor.quantize)
        self.quantize_report = None
        if self.quantize_weights != "off":
            if self._pred.quantize_report is None:
                rep = self._pred.quantize(self.quantize_weights,
                                          self._quant_block)
                predictor.quantize_report = rep
            else:
                # a no-op that checks the mode and block
                rewrite_for_inference(lm, self.quantize_weights,
                                      block=self._quant_block)
            self.quantize_report = self._pred.quantize_report
        # batched LoRA, AFTER the quantize seam: the deltas apply to the
        # dequantized products, and only the step takes them (the
        # predictor keeps serving the base model)
        self.adapter_store = adapter_store
        self.lora_report = None
        if self.adapter_store is None \
                and int(flag("adapter_pool_max_bytes")) > 0:
            buckets = tuple(int(x) for x in
                            str(flag("adapter_rank_buckets")).split(",") if x)
            self.adapter_store = AdapterStore.for_model(
                lm, rank_buckets=buckets or (8, 16),
                max_bytes=int(flag("adapter_pool_max_bytes")),
                slots_per_bucket=(int(flag("adapter_slots_per_bucket"))
                                  or None),
                tenant_quota=int(flag("adapter_tenant_quota")))
        if self.adapter_store is not None and page_store is not None:
            # the store keys a page by its tokens alone, as the trie
            # does: one adapter's K/V would splice into another's row
            raise ValueError("page_store cannot be combined with an "
                             "adapter store: the page store is not keyed "
                             "by adapter")
        if self.adapter_store is not None and self.prefix_cache:
            # the trie keys a page by its tokens alone, and an adapter's
            # delta on qkv changes the page's K/V: a row would attend
            # over K/V that another adapter (or the base) wrote
            raise ValueError("prefix_cache cannot be combined with an "
                             "adapter store: the prefix trie is not keyed "
                             "by adapter")
        if self.adapter_store is not None:
            self.adapter_store.attach(self.device)
            self.lora_report = rewrite_for_lora(self._step_model,
                                                self.adapter_store)
        # the fixed-shape step of each kind, bound for the engine's life
        # (the JAX engine's _ragged_bound / _decode_bound): static input
        # buffers over the engine's pools, replayed as a CUDA graph on
        # the card once captured below; the two_lane prefill, whose
        # batch is the admitted rows, stays an eager call
        self._ragged_bound = self._decode_bound = None
        R, maxp = self.lanes, self.geom.max_pages_per_seq
        i32, i64 = torch.int32, torch.long
        if mode == "ragged":
            C = self.chunk_tokens
            feeds = {"tokens": ((R, C), i64), "pos_ids": ((R, C), i64),
                     "positions": ((R,), i32), "num_valid": ((R,), i32),
                     "tables": ((R, maxp), i32)}
            if self.adapter_store is not None:
                feeds["adapter_slots"] = ((R, self.adapter_store.n_buckets),
                                          i32)
            self._ragged_bound = GraphedStep(
                self._step_model, feeds,
                {"k_pages": self.cache.k_pages, "v_pages": self.cache.v_pages,
                 "k_scales": self.cache.k_scales,
                 "v_scales": self.cache.v_scales}, self.device, "ragged")
        else:
            feeds = {"tokens": ((R,), i64), "positions": ((R,), i32),
                     "num_valid": ((R,), i32), "lengths": ((R,), i32),
                     "tables": ((R, maxp), i32)}
            self._decode_bound = GraphedStep(
                self._decode_model, feeds,
                {"k_pages": self.cache.k_pages,
                 "v_pages": self.cache.v_pages}, self.device, "decode")

        # the base model's label and swap count; a staged swap waits
        # here for the loop thread (swap_base)
        self.model_version = str(model_version or "base")
        self.model_swaps = 0
        self._pending_swap = None
        self._cond = threading.Condition()
        self._queue: "collections.deque[_GenRequest]" = collections.deque()
        self._by_slot: Dict[int, _GenRequest] = {}
        self._admit_counter = 0
        self._closed = False
        self._stop = False
        self._loop_thread: Optional[threading.Thread] = None
        self._started = False
        if warmup:
            self._warmup()
        if self.device.type == "cuda":
            # after the warm-up, once: a capture that fails raises here
            # (no eager fallback)
            self._bound_step.capture()
        # this engine's counters and page-pool stats join the scrape as
        # paddle_generation_*{engine=} series
        from ..observability import watch_generation

        watch_generation(self)
        if start:
            self.start()

    @property
    def _bound_step(self) -> GraphedStep:
        """The bound step of this engine's mode."""
        return (self._ragged_bound if self.mode == "ragged"
                else self._decode_bound)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "GenerationEngine":
        with self._cond:
            if self._started:
                return self
            if self._closed:
                raise EngineClosed("generation engine already closed")
            self._started = True
        self._loop_thread = threading.Thread(
            target=self._loop, name="pt-torch-generation-loop", daemon=True)
        self._loop_thread.start()
        return self

    def close(self, drain: bool = True, timeout: Optional[float] = 60.0):
        """Stop admission. ``drain=True`` serves everything already
        submitted (running sequences AND queued requests) to its stop
        conditions, then exits; ``drain=False`` retires everything
        immediately."""
        with self._cond:
            already = self._closed and self._stop
            self._closed = True
            if not drain:
                self._stop = True
            self._cond.notify_all()
        if already:
            return
        if self._started:
            self._loop_thread.join(timeout)
        else:
            self._fail_queued(EngineClosed("engine closed before start()"))
        if drain and self._page_store is not None and self.prefix_cache:
            # the drain spill: trie pages outlive this engine in the
            # store, so a replacement (or any decode worker on the
            # store) starts warm
            self.spill_trie()
            self.cache.drop_trie()

    def __enter__(self) -> "GenerationEngine":
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)

    @property
    def closed(self) -> bool:
        return self._closed

    def _kick(self):
        with self._cond:
            self._cond.notify_all()

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = "default",  # type: ignore[assignment]
               deadline_ms: Optional[float] = None,
               on_token=None, tenant: Optional[str] = None,
               adapter: Optional[str] = None) -> GenerationStream:
        """Admit one prompt (1-D int sequence). Raises ``Overloaded``
        when the admission queue is full OR when the prompt + budget
        could never fit the page pool, both before any prefill work;
        raises ``EngineClosed`` after close(). ``on_token(token)`` is
        called on the loop thread with every token as it is emitted.
        ``tenant`` is the identity the request's trie publishes are
        attributed to (the per-tenant quota's unit). ``adapter`` names a
        resident LoRA adapter every row of this request decodes through
        (``AdapterMissing`` before any queueing when it is not); it is
        pinned until the request's terminal state."""
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.default_max_new)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        eos = self.default_eos if eos_id == "default" else eos_id
        total = int(prompt.size) + max_new
        if total > self.config.max_position:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds max_position {self.config.max_position}")
        if not self.cache.can_fit_ever(total):
            self.metrics.inc("rejected_total")
            raise Overloaded(
                f"request needs {self.cache.pages_needed(total)} pages; "
                f"pool holds {self.cache.usable_pages} "
                f"(num_pages x page_size)")
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        if adapter is not None:
            if self.adapter_store is None:
                raise ValueError(
                    f"request names adapter {adapter!r} but this engine "
                    "has no adapter store (set adapter_pool_max_bytes "
                    "or pass adapter_store=)")
            # pinned BEFORE queueing; released once, at the stream's
            # terminal state (every retirement goes through _finish)
            self.adapter_store.acquire(adapter)
        stream = GenerationStream(self, on_token=on_token)
        if adapter is not None:
            stream.add_done_callback(
                lambda _s, _a=adapter: self.adapter_store.release(_a))
        with (tracing.span("generation/submit", {"prompt": int(prompt.size),
                                                 "max_new": max_new})
              if tracing.enabled() else contextlib.nullcontext()) as ctx:
            req = _GenRequest(prompt, max_new, eos, deadline, stream,
                              adapter, tenant, ctx)
            try:
                with self._cond:
                    if self._closed:
                        raise EngineClosed("GenerationEngine is closed")
                    if len(self._queue) >= self.queue_capacity:
                        self.metrics.inc("rejected_total")
                        raise Overloaded(
                            f"generation queue full ({self.queue_capacity} "
                            "pending); retry with backoff or raise "
                            "queue_capacity")
                    self._queue.append(req)
                    self.metrics.inc("requests_total")
                    self._cond.notify_all()
            except BaseException:
                # rejected before the queue owned it: unpin here
                if adapter is not None:
                    self.adapter_store.release(adapter)
                raise
        return stream

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id="default", deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = None,
                 adapter: Optional[str] = None) -> List[int]:
        """Synchronous submit + result."""
        return self.submit(prompt, max_new_tokens, eos_id, deadline_ms,
                           adapter=adapter).result(timeout)

    # -- introspection -------------------------------------------------------
    def queue_depth(self) -> int:
        """Requests admitted but not yet prefilled. Lockless on purpose,
        as in the JAX engine: a caller may hold its own lock while this
        engine runs stream callbacks under ``self._cond``; ``len`` of a
        deque is atomic under the GIL."""
        return len(self._queue)

    def prefix_probe(self, tokens) -> int:
        """The matched-prefix token count this prompt would get now (a
        pure trie peek: no refcount, no LRU touch); 0 with the radix
        cache off."""
        if not self.prefix_cache:
            return 0
        return int(self.cache.match_len(
            np.asarray(tokens, dtype=np.int64).reshape(-1)))

    def stats(self) -> Dict[str, Any]:
        """The engine's counters and histograms, the cache's and the
        store's, and its bound step's: ``bound_step_runs`` (one an
        engine step), ``graph_captures`` (1 on the card),
        ``graph_replays`` (every step on the card, none on the CPU) and
        ``graph_launches`` (each kernel's launches a replay, counted from
        the graph's kernel nodes)."""
        out = self.metrics.snapshot()
        bound = self._bound_step
        out.update(bound_step_runs=bound.runs, graph_captures=bound.captures,
                   graph_replays=bound.replays,
                   graph_launches=dict(bound.launches))
        out["cache"] = self.cache.stats()
        out["radix"] = self.cache.radix_stats()
        if self.adapter_store is not None:
            out["adapters"] = self.adapter_store.stats_numeric()
        out["model_swaps"] = self.model_swaps
        if self._page_store is not None:
            lk = self.store_lookups_total
            # flattened into paddle_generation_store_*: this worker's
            # page-store traffic (the store's own gauges are global)
            out["store"] = {
                "lookups_total": lk,
                "hits_total": self.store_hits_total,
                "hit_rate": (round(self.store_hits_total / lk, 4)
                             if lk else 0.0),
                "pages_pulled_total": self.store_pages_pulled_total,
                "pages_spilled_total": self.store_pages_spilled_total,
                "errors_total": self.store_errors_total,
            }
        return out

    def stats_numeric(self) -> Dict[str, Any]:
        """The metrics collector's view: ``stats()``."""
        return self.stats()

    def models_fragment(self) -> Dict[str, Any]:
        """What a router places requests by: the base model's
        quantization and the resident adapters (id, rank, bucket, slot,
        refcount, bytes)."""
        return {
            "base": {"version": self.model_version,
                     "swaps": int(self.model_swaps),
                     "quantized": self.quantize_weights,
                     "kv_dtype": self.kv_dtype},
            "phase": self.phase,
            "adapters": (self.adapter_store.resident()
                         if self.adapter_store is not None else []),
        }

    # -- hot base-model swap -------------------------------------------------
    def _swap_targets(self):
        """name -> the tensor(s) the steps read for it: a float
        Parameter, or (qweight, scale, mode, block) of a quantized
        matmul."""
        lm = self._pred.lm
        targets: Dict[str, Any] = dict(lm.jax_params())
        for _parent, _attr, dense in lm.dense_layers():
            if isinstance(dense, QuantizedDense):
                targets[dense.name] = (dense.qweight, dense.scale,
                                       dense.mode, dense.block)
        return targets

    def swap_base(self, weights: Dict[str, Any], *,
                  version: Optional[str] = None,
                  timeout: Optional[float] = 60.0) -> str:
        """Zero-downtime swap to a SIGNATURE-IDENTICAL weight set (every
        name already served, with the same shape) under live traffic.
        The values are staged on this thread (onto the device and, for
        a quantized weight, quantized into its layer's mode and block);
        the loop thread copies them into the served tensors between two
        steps. Returns the new model version label."""
        targets = self._swap_targets()
        staged = []
        with torch.no_grad():
            for name, val in weights.items():
                t = torch.as_tensor(np.asarray(val) if not isinstance(
                    val, torch.Tensor) else val)
                dst = targets.get(name)
                if dst is None:
                    raise ValueError(
                        f"swap_base: {name!r} is not a served weight — a "
                        "hot swap must be signature-identical (same "
                        "architecture, same names)")
                if isinstance(dst, tuple):
                    qw, sc, mode, block = dst
                    if tuple(t.shape) != tuple(qw.shape):
                        raise ValueError(
                            f"swap_base: {name!r} shape {tuple(t.shape)} != "
                            f"serving shape {tuple(qw.shape)} — not "
                            "signature-identical; roll a new engine instead")
                    q, s = quantize_weight(t.to(self.device, torch.float32),
                                           mode, block)
                    staged += [(qw, q), (sc, s)]
                    continue
                if tuple(t.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"swap_base: {name!r} shape {tuple(t.shape)} != "
                        f"serving shape {tuple(dst.shape)} — not "
                        "signature-identical; roll a new engine instead")
                staged.append((dst, t.to(self.device, dst.dtype)))
        label = (str(version) if version is not None
                 else f"swap-{self.model_swaps + 1}")
        done = threading.Event()
        with self._cond:
            if (self._started and self._loop_thread is not None
                    and self._loop_thread.is_alive()):
                if self._pending_swap is not None:
                    raise RuntimeError(
                        "swap_base: another swap is already staged")
                self._pending_swap = (staged, label, done)
                self._cond.notify_all()
            else:
                # no loop running: apply here
                self._apply_swap(staged, label, done)
        if not done.wait(timeout if timeout is not None else 1e9):
            raise TimeoutError(f"swap_base: the step loop did not apply the "
                               f"swap within {timeout}s")
        return label

    def _apply_swap(self, staged, label: str, done: threading.Event) -> None:
        """Copy the staged values into the served tensors (the addresses
        a captured graph replays stay the same)."""
        with torch.no_grad():
            for dst, src in staged:
                dst.copy_(src)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.model_swaps += 1
        self.model_version = label
        done.set()

    # -- the step loop -------------------------------------------------------
    def _loop(self):
        try:
            with torch.inference_mode():
                while True:
                    with self._cond:
                        while (not self._queue and not self._by_slot
                               and not self._stop and not self._closed
                               and self._pending_swap is None):
                            self._cond.wait(0.05)
                        swap, self._pending_swap = self._pending_swap, None
                    if swap is not None:
                        # between two steps, on the loop thread: no step
                        # reads a half-swapped set
                        self._apply_swap(*swap)
                    with self._cond:
                        if self._stop or (self._closed and not self._queue
                                          and not self._by_slot):
                            break
                    if self.mode == "ragged":
                        self._admit_ragged()
                        if self._by_slot:
                            self._ragged_step()
                    else:
                        self._admit_and_prefill()
                        if self._by_slot:
                            self._decode_step()
                    self.metrics.set_gauges(len(self._queue),
                                            len(self._by_slot))
        finally:
            # anything still live (hard close, or the loop dying on an
            # unexpected exception) fails loudly, and later submits are
            # refused instead of queueing work nobody will serve
            with self._cond:
                self._closed = True
                swap, self._pending_swap = self._pending_swap, None
            if swap is not None:
                # a swap staged against a closing engine still lands
                self._apply_swap(*swap)
            self._fail_queued(EngineClosed(
                "engine closed before the request was served"))
            for slot, req in list(self._by_slot.items()):
                self.cache.release(slot)
                req.stream._finish("closed", EngineClosed(
                    "engine closed mid-generation"))
            self._by_slot.clear()
            self.metrics.set_gauges(0, 0)

    def _fail_queued(self, err: BaseException):
        with self._cond:
            while self._queue:
                req = self._queue.popleft()
                req.stream._finish("closed", err)

    def _pop_admissible(self) -> List[_GenRequest]:
        """FIFO admission: take queue-head requests while a lane AND
        pages for the whole prompt are available (head-of-line blocking
        is deliberate: pool pressure must never starve the oldest
        request). Expired/cancelled requests drop here."""
        admitted: List[_GenRequest] = []
        now = time.monotonic()
        with self._cond:
            while self._queue:
                req = self._queue[0]
                if req.stream._cancelled:
                    self._queue.popleft()
                    self.metrics.inc("cancelled_total")
                    req.stream._finish("cancelled", RequestCancelled(
                        "cancelled while queued"))
                    continue
                if req.deadline is not None and now > req.deadline:
                    self._queue.popleft()
                    self.metrics.inc("expired_total")
                    req.stream._finish("deadline", DeadlineExceeded(
                        f"deadline passed after "
                        f"{(now - req.enqueue_t) * 1e3:.1f}ms in queue"))
                    continue
                if (self._page_store is not None and self.prefix_cache
                        and self.mode == "ragged" and not req.store_checked):
                    # queued while this loop was fetching from the store:
                    # it is consulted at the next iteration, never cold-
                    # prefilled past the store (the JAX engine admits it
                    # here unconsulted)
                    break
                # acquire takes the slot and pages at once, so these
                # checks see earlier admissions. Only this loop thread
                # changes the trie, so acquire matches what match_len
                # saw; a match is page-aligned, so the suffix needs the
                # total pages less the matched ones
                matched = (self.cache.match_len(req.prompt)
                           if self.prefix_cache else 0)
                if (self.cache.free_slots() <= 0
                        or not self.cache.can_acquire(
                            int(req.prompt.size) - matched,
                            prompt=req.prompt)):
                    break
                admitted.append(self._queue.popleft())
                # prefill starts at the fork point of a matched prefix
                req.slot, req.prefill_off = self.cache.acquire(req.prompt)
                if req.admit_seq == 0:
                    # first admission only: a resumed request keeps its
                    # seniority, or it would be the next eviction victim
                    self._admit_counter += 1
                    req.admit_seq = self._admit_counter
                self.metrics.observe(
                    "queue_wait_ms", (now - req.enqueue_t) * 1e3)
        return admitted

    # -- two_lane: the prefill lane ------------------------------------------
    def _seq_bucket(self, n: int) -> int:
        for b in self._seq_buckets:
            if n <= b:
                return b
        return self._seq_buckets[-1]

    def _admit_and_prefill(self):
        """Admitted requests prefill in one call per sequence bucket."""
        admitted = self._pop_admissible()
        if not admitted:
            return
        groups: Dict[int, List[_GenRequest]] = {}
        for req in admitted:
            groups.setdefault(self._seq_bucket(int(req.prompt.size)),
                              []).append(req)
        for bucket, reqs in sorted(groups.items()):
            self._prefill(bucket, reqs)

    def _prefill(self, bucket: int, reqs: List[_GenRequest]):
        """One prefill call: the rows' prompts in a [n, bucket] window;
        their K/V lands in the pool, and each row's first token is
        sampled (TTFT). The rows then join the decode lanes."""
        t0 = time.monotonic()
        n = len(reqs)
        tokens = np.zeros((n, bucket), np.int64)
        num_valid = np.zeros(n, np.int32)
        tables = np.zeros((n, self.geom.max_pages_per_seq), np.int32)
        for i, req in enumerate(reqs):
            L = int(req.prompt.size)
            tokens[i, :L] = req.prompt
            num_valid[i] = L
            tables[i] = self.cache.block_tables[req.slot]
        try:
            dev = self.device
            next_tok = self._prefill_model(
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(num_valid).to(dev),
                torch.from_numpy(tables).to(dev),
                self.cache.k_pages, self.cache.v_pages).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — a bad prompt batch must not kill the loop
            for req in reqs:
                self.cache.release(req.slot)
                req.slot = None
                req.stream._finish("error", ServingError(
                    f"prefill execution failed: {e!r}"))
            return
        now = time.monotonic()
        self.metrics.inc("prefill_batches_total")
        self.metrics.inc("prefill_tokens_total", int(num_valid.sum()))
        self.metrics.inc("prefill_rows_total", n)
        self.metrics.observe("prefill_ms", (now - t0) * 1e3)
        for i, req in enumerate(reqs):
            self.cache.advance(req.slot, int(num_valid[i]))
            self._by_slot[req.slot] = req
            self._emit(req, int(next_tok[i]), now)

    # -- two_lane: the decode lane -------------------------------------------
    def _decode_step(self):
        """One token for every active lane through the paged decode
        attention; idle lanes are length-0 rows that write to the junk
        page."""
        R = self.lanes
        now = time.monotonic()
        self._retire_dead_rows(now)
        if not self._by_slot:
            return
        for slot in list(self._by_slot):
            if slot in self._by_slot:     # not evicted by an earlier row
                self._grow_or_evict(slot)
        if not self._by_slot:
            return
        tokens = np.zeros(R, np.int64)
        positions = np.zeros(R, np.int32)
        num_valid = np.zeros(R, np.int32)
        lengths = np.zeros(R, np.int32)
        for slot, req in self._by_slot.items():
            L0 = int(self.cache.lengths[slot])
            tokens[slot] = req.pending
            positions[slot] = L0
            num_valid[slot] = 1
            lengths[slot] = L0 + 1
        active = list(self._by_slot.items())
        t0 = time.monotonic()
        try:
            next_tok = self._decode_bound.run(
                tokens=tokens, positions=positions, num_valid=num_valid,
                lengths=lengths, tables=self.cache.block_tables)
        except Exception as e:  # noqa: BLE001 — a bad batch must not kill the loop
            for slot, _req in active:
                self._retire(slot, "error", ServingError(
                    f"decode execution failed: {e!r}"))
            return
        now = time.monotonic()
        self.metrics.observe_decode_step((now - t0) * 1e3, len(active), R,
                                         tokens=len(active))
        for slot, req in active:
            self.cache.advance(slot)    # the pending token's K/V is cached
            self._emit(req, int(next_tok[slot]), now)

    # -- ragged ---------------------------------------------------------------
    def _admit_ragged(self):
        """An admitted request takes a lane + pages for its whole prompt
        and starts chunked prefill on the next step, at the trie's fork
        point when the radix cache matched a prefix (``acquire`` set
        ``prefill_off`` and the cache length to the matched run)."""
        self._consult_store()
        for req in self._pop_admissible():
            req.pending = None
            req.drafts = None
            self._by_slot[req.slot] = req

    # -- the page store seam (disagg) ----------------------------------------
    def _consult_store(self) -> None:
        """Before cold-prefilling queue-head prompts, ask the page store
        for their prefixes and splice any match into the pool and the
        trie: the decode worker's half of disaggregation and the warm
        restart. On the loop thread only, between steps (``ingest_run``
        writes the pools in place); the fetch runs outside
        ``self._cond``, so submitters never wait on the wire."""
        if self._page_store is None or not self.prefix_cache:
            return
        with self._cond:
            heads = [r for r in list(self._queue)[:self.lanes]
                     if not r.store_checked]
        for req in heads:
            req.store_checked = True
            try:
                self._pull_run(req.prompt, tenant=req.tenant)
            except Exception:  # noqa: BLE001 — a dead store degrades to cold prefill
                self.store_errors_total += 1

    def _pull_run(self, tokens, tenant=None) -> int:
        """Fetch and ingest the store's longest run for ``tokens``,
        capped as the trie match is (at least one token is left to
        prefill). Returns the pages ingested; 0 when the local trie
        already covers the store's match."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        ps = self.page_size
        cap = (int(tokens.size) - 1) // ps
        local = self.cache.match_len(tokens) // ps
        if cap <= local:
            return 0
        self.store_lookups_total += 1
        blobs = self._page_store.match(tokens, max_pages=cap)
        if len(blobs) <= local:
            return 0
        from ..disagg.pagestore import run_for_pool

        n, k_run, v_run, ksc, vsc = run_for_pool(blobs, self.kv_dtype)
        if n <= local:
            return 0
        got = self.cache.ingest_run(tokens[:n * ps], k_run, v_run,
                                    ksc, vsc, tenant=tenant)
        if got:
            self.store_hits_total += 1
            self.store_pages_pulled_total += got
        return got

    def spill_run(self, tokens) -> int:
        """Export ``tokens``' trie-resident pages to the page store (the
        prefill worker's publish). Safe from any thread: full trie pages
        are never written again, and ``export_run`` orders its reads
        after the last step. The pages are encoded where they lie
        (``int8_block`` quantizes on the device) and cross to the host
        once. No-op without a store."""
        if self._page_store is None or not self.prefix_cache:
            return 0
        n, k_run, v_run, ksc, vsc = self.cache.export_run(tokens,
                                                          host=False)
        if not n:
            return 0
        from ..disagg.pagestore import encode_pages

        blobs = encode_pages(k_run, v_run, ksc, vsc,
                             encoding=self._wire_encoding)
        toks = np.asarray(tokens, np.int64).reshape(-1)[:n * self.page_size]
        self._page_store.put_run(toks, blobs)
        self.store_pages_spilled_total += n
        return n

    def spill_trie(self) -> int:
        """Spill every trie-resident page run to the store: the drain
        hook, after which a replacement worker starts warm."""
        if self._page_store is None or not self.prefix_cache:
            return 0
        total = 0
        for run in self.cache.trie_leaf_runs():
            try:
                total += self.spill_run(run)
            except Exception:  # noqa: BLE001 — spill is best-effort
                self.store_errors_total += 1
        return total

    def _retire_dead_rows(self, now: float) -> None:
        """Retire cancelled/expired sequences before spending a step on
        them."""
        for slot, req in list(self._by_slot.items()):
            if req.stream._cancelled:
                self._retire(slot, "cancelled")
                self.metrics.inc("cancelled_total")
            elif req.deadline is not None and now > req.deadline:
                self._retire(slot, "deadline")
                self.metrics.inc("expired_total")

    def _grow_or_evict(self, slot: int) -> bool:
        """Grow slot's page chain by one token; a dry pool evicts
        (youngest first) and a truly stuck row finishes early
        ("capacity"). False when the slot was retired."""
        while True:
            try:
                self.cache.ensure_capacity(
                    slot, int(self.cache.lengths[slot]) + 1)
                return True
            except PagePoolExhausted:
                if not self._make_room(slot):
                    self._retire(slot, "capacity")
                    return False

    def _make_room(self, slot: int) -> bool:
        """The pool is dry and `slot` needs one more page: evict the
        YOUNGEST other sequence holding pages (its request re-queues at
        the queue head with prompt + generated tokens as its new
        context). False when no eviction can free a page."""
        victims = sorted(
            (r for s, r in self._by_slot.items() if s != slot),
            key=lambda r: -r.admit_seq)
        victim = next((r for r in victims
                       if self.cache.reclaimable_pages(r.slot) > 0), None)
        if victim is None:
            return False
        vslot = victim.slot
        del self._by_slot[vslot]
        self.cache.evict(vslot)
        self.metrics.inc("evicted_total")
        victim.prompt = self._context(victim)
        victim.slot = None
        victim.pending = None
        victim.prefill_off = 0
        victim.drafts = None
        with self._cond:
            self._queue.appendleft(victim)
            self._cond.notify_all()
        return True

    def _spec_budget(self, slot: int, req: _GenRequest) -> int:
        """Draft tokens this row could verify this step: bounded by the
        spec window, the chunk, the request's remaining tokens and the
        position window."""
        if self._draft is None or self.spec_tokens <= 0:
            return 0
        L = int(self.cache.lengths[slot])
        return max(0, min(self.spec_tokens,
                          self.chunk_tokens - 1,
                          req.max_new - req.n_generated - 1,
                          self.config.max_position - L - 2))

    def _context(self, req: _GenRequest) -> np.ndarray:
        """The caller's prompt and every token emitted so far."""
        return np.concatenate([req.orig_prompt,
                               np.asarray(req.stream._tokens, np.int64)])

    def _ragged_step(self):
        """ONE mixed step: every active lane contributes a prefill chunk,
        a decode token, or a decode token plus speculative drafts, and
        the whole batch attends raggedly over the shared page pool."""
        R, C = self.lanes, self.chunk_tokens
        now = time.monotonic()
        self._retire_dead_rows(now)
        # page growth for decode rows (and the speculative window);
        # prefill rows were fully reserved at admission. A dry pool first
        # degrades speculation to plain decode, then evicts (youngest
        # first), then finishes the stuck row early.
        spec_rows: List = []
        for slot, req in list(self._by_slot.items()):
            if slot not in self._by_slot:
                continue
            if req.prefill_off < int(req.prompt.size):
                continue
            req.drafts = None
            k = self._spec_budget(slot, req)
            if k > 0:
                try:
                    self.cache.ensure_capacity(
                        slot, int(self.cache.lengths[slot]) + 1 + k)
                    spec_rows.append((slot, req, k))
                    continue
                except PagePoolExhausted:
                    pass
            self._grow_or_evict(slot)
        if not self._by_slot:
            return
        if self.adapter_store is not None:
            # a force-evicted adapter fails ITS rows here, before they
            # cost a step — never the whole batch
            for slot, req in list(self._by_slot.items()):
                if req.adapter is None:
                    continue
                try:
                    self.adapter_store.slots_row(req.adapter)
                except AdapterMissing as e:
                    self._retire(slot, "error", ServingError(str(e)))
            if not self._by_slot:
                return
        # ONE propose() covers every speculative row, always for the full
        # spec window, trimmed per row
        spec_rows = [(s, r, k) for s, r, k in spec_rows if s in self._by_slot]
        if spec_rows:
            ctxs = [self._context(r) for _, r, _ in spec_rows]
            try:
                props = self._draft.propose(ctxs, self.spec_tokens)
            except Exception:  # noqa: BLE001 — a broken draft must never kill decode
                props = [np.zeros(0, np.int64)] * len(spec_rows)
            self.metrics.inc("spec_rounds_total")
            for (slot, req, k), dr in zip(spec_rows, props):
                dr = np.asarray(dr, np.int64).reshape(-1)[:k]
                req.drafts = dr
                self.metrics.inc("spec_proposed_total", int(dr.size))
        tokens = np.zeros((R, C), np.int64)
        pos_ids = np.zeros((R, C), np.int64)
        positions = np.zeros(R, np.int32)
        num_valid = np.zeros(R, np.int32)
        for slot, req in self._by_slot.items():
            if req.prefill_off < int(req.prompt.size):
                off = req.prefill_off
                c = min(C, int(req.prompt.size) - off)
                tokens[slot, :c] = req.prompt[off:off + c]
                pos_ids[slot, :c] = np.arange(off, off + c)
                positions[slot] = off
                num_valid[slot] = c
            else:
                # a decode row, or a verify row [pending] + drafts from
                # the sequence's length on
                dr = (req.drafts if req.drafts is not None
                      else np.zeros(0, np.int64))
                row = np.concatenate([np.asarray([req.pending], np.int64),
                                      dr])
                L0 = int(self.cache.lengths[slot])
                tokens[slot, :row.size] = row
                pos_ids[slot, :row.size] = np.arange(L0, L0 + row.size)
                positions[slot] = L0
                num_valid[slot] = row.size
        aslots = None
        if self.adapter_store is not None:
            # per-row adapter slots, fed like a block table: zeros (the
            # zero adapter) for base-only rows and idle lanes
            aslots = np.zeros((R, self.adapter_store.n_buckets), np.int32)
            for slot, req in self._by_slot.items():
                if req.adapter is not None:
                    aslots[slot] = self.adapter_store.slots_row(req.adapter)
        active = list(self._by_slot.items())
        t0 = time.monotonic()
        host = {"tokens": tokens, "pos_ids": pos_ids, "positions": positions,
                "num_valid": num_valid, "tables": self.cache.block_tables}
        if aslots is not None:
            host["adapter_slots"] = aslots
        span_cm = contextlib.nullcontext()
        if tracing.enabled():
            flow = [r.ctx.span_id for _, r in active if r.ctx is not None]
            span_cm = tracing.span(
                f"generation/ragged_step[n={len(active)}]",
                {"lanes": R, "chunk": C,
                 "new_tokens": int(num_valid.sum()),
                 **({"flow_from": flow} if flow else {})})
        try:
            with span_cm:
                next_all = self._ragged_bound.run(**host).reshape(R, C)
            # an export on another thread reads after these writes
            self.cache.mark_written()
        except Exception as e:  # noqa: BLE001 — a bad batch must not kill the loop
            for slot, _req in active:
                self._retire(slot, "error", ServingError(
                    f"ragged step execution failed: {e!r}"))
            return
        now = time.monotonic()
        self.metrics.inc("ragged_steps_total")
        emitted = 0
        for slot, req in active:
            if slot not in self._by_slot:
                continue
            nv = int(num_valid[slot])
            if nv <= 0:
                continue
            if req.prefill_off < int(req.prompt.size):
                # a prefill chunk: its K/V is cached now; the FINAL chunk
                # also samples the first token (TTFT). Publish BEFORE
                # _emit: a request that retires on its first token still
                # leaves its prompt pages to the siblings behind it
                self.cache.advance(slot, nv)
                req.prefill_off += nv
                self.metrics.inc("prefill_chunks_total")
                self.metrics.inc("prefill_tokens_total", nv)
                if self.prefix_cache:
                    self.cache.publish(slot, req.prompt, tenant=req.tenant)
                if req.prefill_off >= int(req.prompt.size):
                    self.metrics.inc("prefill_batches_total")
                    self._emit(req, int(next_all[slot, nv - 1]), now)
                    emitted += 1
            else:
                # decode / verify: next_all[slot, j] IS the greedy token
                # after position L0 + j, so draft j is accepted iff it
                # equals the target's token at its own offset
                dr = req.drafts if req.drafts is not None else ()
                for j in range(nv):
                    if j > 0:
                        if int(dr[j - 1]) != int(next_all[slot, j - 1]):
                            break       # rejected: the tail is dead
                        self.metrics.inc("spec_accepted_total")
                        req.stream.accepted_draft_tokens += 1
                    self.cache.advance(slot)
                    emitted += 1
                    self._emit(req, int(next_all[slot, j]), now)
                    if slot not in self._by_slot:
                        break           # retired (eos/length/deadline)
                if self.prefix_cache and slot in self._by_slot:
                    # decode-made full pages join the trie too: only
                    # positions < length publish, and rejected drafts
                    # sit at positions >= length
                    self.cache.publish(slot, self._context(req),
                                       tenant=req.tenant)
        n_active = sum(1 for s, _ in active if num_valid[s] > 0)
        self.metrics.observe_decode_step((now - t0) * 1e3, n_active, R,
                                         tokens=emitted)

    # -- token emission + retirement ----------------------------------------
    def _emit(self, req: _GenRequest, token: int, now: float):
        """A token was just sampled for req: stream it, update timing
        metrics, apply stop conditions, otherwise leave it pending for
        the next step."""
        first = req.stream.first_token_at is None
        if req.last_tok_t is not None:
            self.metrics.observe("itl_ms", (now - req.last_tok_t) * 1e3)
        req.stream.verified_tokens += 1
        req.stream._push(token)
        req.last_tok_t = now
        if first:
            self.metrics.observe("ttft_ms", (now - req.enqueue_t) * 1e3)
        req.pending = token
        req.n_generated += 1
        if req.eos_id is not None and token == req.eos_id:
            self._retire(req.slot, "eos")
        elif req.n_generated >= req.max_new:
            self._retire(req.slot, "length")
        elif (int(self.cache.lengths[req.slot]) + 1
                >= self.config.max_position):
            self._retire(req.slot, "length")
        elif req.deadline is not None and now > req.deadline:
            self._retire(req.slot, "deadline")
            self.metrics.inc("expired_total")

    def _retire(self, slot: int, reason: str,
                error: Optional[BaseException] = None):
        req = self._by_slot.pop(slot, None)
        if (self.prefix_cache and req is not None and error is None
                and self.cache.is_active(slot)):
            # the last publish before the pages go back: every full page
            # below the length holds verified K/V whatever the finish
            # reason; the refcounted release keeps trie-resident pages
            self.cache.publish(slot, self._context(req), tenant=req.tenant)
        self.cache.release(slot)
        if req is not None:
            if error is None and reason in ("eos", "length", "capacity"):
                self.metrics.inc("responses_total")
            req.slot = None
            req.stream._finish(reason, error)

    # -- warmup --------------------------------------------------------------
    def _warmup(self):
        """Run a two-token request through the engine's steps before
        serving traffic (first-call costs: the kernel build and load,
        library handles), then reset the metrics. Ragged: the
        prefill-chunk and decode phases of the step; two_lane: a prefill
        in every bucket of the ladder, each followed by a decode step."""
        if self.mode == "two_lane":
            with torch.inference_mode():
                for bucket in self._seq_buckets:
                    req = _GenRequest(np.asarray([0, 0], np.int64), 2, None,
                                      None, GenerationStream(self))
                    req.slot = self.cache.allocate_slot(2)
                    slot = req.slot
                    try:
                        self._prefill(bucket, [req])
                        if slot in self._by_slot:
                            self._decode_step()
                    finally:
                        if slot in self._by_slot:
                            self._retire(slot, "length")
                        elif self.cache.is_active(slot):
                            self.cache.release(slot)
                    if req.stream.error is not None:
                        raise req.stream.error
            self.metrics = GenerationMetrics()
            self._bound_step.runs = 0
            return
        if self.spec_tokens > 0 and hasattr(self._draft, "warmup"):
            self._draft.warmup(self.spec_tokens)
        slot = self.cache.allocate_slot(2)
        req = _GenRequest(np.asarray([0, 0], np.int64), 2, None, None,
                          GenerationStream(self))
        req.slot = slot
        self._by_slot[slot] = req
        try:
            with torch.inference_mode():
                for _ in range(4):
                    if slot not in self._by_slot:
                        break
                    self._ragged_step()
        finally:
            if slot in self._by_slot:
                self._retire(slot, "length")
            elif self.cache.is_active(slot):
                self.cache.release(slot)
        if req.stream.error is not None:
            raise req.stream.error
        if self.prefix_cache:
            # the warm-up's dummy prompt must not seed the trie
            self.cache.drop_trie()
        self.metrics = GenerationMetrics()
        self._bound_step.runs = 0
