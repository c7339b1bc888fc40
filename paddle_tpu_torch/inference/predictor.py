"""Predictor API (counterpart of ``paddle_tpu/inference/predictor.py``,
:17-538): run any inference Program saved by ``save_inference_model``.

    cfg = Config(model_dir)                    # a directory of either package
    cfg.enable_shape_bucketing()               # optional: pad to buckets
    pred = create_predictor(cfg)               # on CUDA; device="cpu" for the CPU
    (out,) = pred.run([x])                     # the Program at x's shape

Loading goes through ``io.load_inference_model`` into the predictor's
own Scope; ``run`` binds the Program once per (padded) feed signature
(``Executor.bind`` -> ``runtime.dispatch.BoundStep``) and runs it. As in
the reference:

* ``Config.enable_shape_bucketing`` pads every feed's batch dim (with
  ``pad_batch``) and, for the feeds whose declared dim 1 is dynamic or
  that carry a LoD level, its dim 1 up the bucket ladders, then slices
  the outputs back to the shapes the Program gives at the TRUE request
  shapes. Those shapes come from running the plan on ``meta`` tensors
  (``runtime.dispatch.eval_shapes``, the port's ``jax.eval_shape``),
  cached per request signature: a 16-class output is never mistaken for
  a 16-long sequence. ``bucket_stats()`` reports runs, padding waste and
  the per-bucket hits.
* ``clone()`` shares the program, scope, executor, bound steps and the
  true-shape cache, with its own IO handles, lock and counters: one
  clone per thread (a ServingEngine's workers).
* ``enable_bf16`` inserts the AMP casts (``_insert_cast_ops``);
  ``enable_weight_quantization`` (or the ``quantize_weights`` flag)
  rewrites the Program at load (``quantize.rewrite_for_inference``:
  ``quantized_fc`` / ``quantized_matmul`` ops, K11 on the card) and
  ``quantize_report`` says what was quantized and why anything stayed
  float.
* ``enable_partitioning(mesh_axes={"tp": N})`` runs the Program through
  ``CompiledProgram.with_partitioning``: the ranks of a world of N (one
  process a device, started by the launcher) each hold their shards of
  the tagged weights (quantized ones included) and run every request
  tensor-parallel on the same feed (``runtime/tp_plan.py``); every rank
  gets the whole outputs.

A directory holding a ``build_lm_program`` GPT also gets ``pred.lm``
(the ``GPTLM`` module the generation engine steps and the
teacher-forced oracle runs) and ``pred.gpt_config``. ``pred.lm`` is
built over the scope's tensors themselves, quantized ones included
(``generation.model.share_params``): one copy of the weights, which a
``GenerationEngine.swap_base`` updates in place for the Program and the
module together.

``Config().set_params(gpt_config, params)`` is the port's own source (not
in the reference): GPT weights in memory, with ``pred.lm`` and no
Program. Its ``run`` raises; run its module, ``pred.lm(tokens)``.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import io
from ..core.executor import Executor, Scope, scope_guard
from ..core.places import CPUPlace, CUDAPlace
from ..device import resolve_device
from ..flags import flag
from ..generation.model import (GPTLM, QuantizedDense, load_jax_params,
                                share_params)
from ..models.gpt import GPTConfig
from ..quantize import QuantizeReport, rewrite_for_inference
from ..runtime.dispatch import eval_shapes, feed_signature, pad_to

__all__ = ["Config", "AnalysisConfig", "Predictor", "PaddlePredictor",
           "create_predictor", "create_paddle_predictor"]


class Config:
    """Where the model comes from and how to run it (reference
    AnalysisConfig): ``Config(model_dir)``, ``set_model(dir)`` or
    ``set_model(prog_file, params_file)``; ``set_params(gpt_config,
    params)`` for GPT weights in memory (the port's own)."""

    def __init__(self, model_dir: Optional[str] = None):
        self.model_dir = model_dir
        self.prog_file = None
        self.params_file = None
        self._bf16 = False
        self._aot = True
        self._memory_optimize = True
        self._bucketing = False
        self._seq_buckets = ()
        self._batch_buckets = ()
        self._pad_batch = True
        self._quantize_weights: Optional[str] = None  # None: the flag
        self._partition = None
        self.gpt_config: Optional[GPTConfig] = None
        self.params: Optional[Dict[str, object]] = None

    def set_model(self, prog_file_or_dir, params_file=None):
        if params_file is None:
            self.model_dir = prog_file_or_dir
        else:
            self.prog_file = prog_file_or_dir
            self.params_file = params_file

    def set_params(self, gpt_config: GPTConfig,
                   params: Dict[str, object]) -> "Config":
        """GPT weights in memory (numpy arrays or tensors under the
        ``__params__.npz`` names): a predictor with ``lm`` and no
        Program."""
        self.gpt_config = gpt_config
        self.params = params
        return self

    def enable_bf16(self):
        """Cast the AMP white-list ops to bfloat16."""
        self._bf16 = True

    def enable_shape_bucketing(self, seq_buckets=None, batch_buckets=None,
                               pad_batch=True):
        """Pad every feed up to a bucket: dim 0 (when ``pad_batch``) up
        the batch ladder, and dim 1 up the sequence ladder for the
        feeds whose declared dim 1 is dynamic (-1) or that carry a LoD
        level; a static dim 1 (NCHW channels, [B, F] features) is never
        padded. Outputs are sliced back to the request's true shapes.
        Padding is zeros: a model with a padding mask is exact."""
        self._bucketing = True
        self._seq_buckets = sorted(seq_buckets or
                                   (16, 32, 64, 96, 128, 192, 256,
                                    384, 512, 768, 1024, 1536, 2048))
        self._batch_buckets = sorted(batch_buckets or
                                     (1, 2, 4, 8, 16, 32, 64, 128))
        self._pad_batch = pad_batch
        return self

    def enable_partitioning(self, config=None, **kwargs) -> "Config":
        """Shard this predictor over a device mesh by the logical-axis-
        rules partitioner (``partition.PartitionConfig``): with
        ``mesh_axes={"tp": N}`` the tagged weights (heads / mlp / vocab
        axes) are held tensor-parallel over the N ranks of the world.
        ``config`` is a PartitionConfig, or pass its keyword arguments;
        defaults come from the ``partition_*`` flags."""
        from ..partition import PartitionConfig

        if config is None:
            config = PartitionConfig(**kwargs)
        elif kwargs:
            raise ValueError(
                "enable_partitioning: pass a PartitionConfig OR keyword "
                "arguments for one, not both")
        self._partition = config
        return self

    def enable_weight_quantization(self, mode: str = "int8") -> "Config":
        """Quantize every eligible matmul weight once at load: ``mode``
        in {"int8", "int8_block", "fp8", "off"} (per-instance override
        of the ``quantize_weights`` flag; the block is
        ``quantize_block``)."""
        self._quantize_weights = str(mode)
        return self

    def switch_ir_optim(self, flag=True):
        self._aot = flag

    def enable_memory_optim(self):
        self._memory_optimize = True


AnalysisConfig = Config


class _Tensor:
    """Zero-copy-style IO handle (reference ZeroCopyTensor)."""

    def __init__(self, name, static_shape=None):
        self.name = name
        self._value = None
        self._static_shape = static_shape

    def copy_from_cpu(self, arr):
        self._value = arr if isinstance(arr, torch.Tensor) else np.asarray(arr)

    def reshape(self, shape):
        pass  # shapes flow from the array itself

    def shape(self):
        """The held value's shape, or the program var's static shape
        (-1 for the batch dim) before any data is set."""
        if self._value is not None:
            return list(self._value.shape)
        return list(self._static_shape) if self._static_shape else []

    def copy_to_cpu(self):
        return self._value


def _place(device: torch.device):
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(device.index if device.index is not None
                     else torch.cuda.current_device())


def _new_bucket_stats():
    return {"runs": 0, "padded_elements": 0, "real_elements": 0,
            "shapes_seen": set(), "buckets_used": set(), "bucket_hits": {}}


class Predictor:
    def __init__(self, config: Config,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._config = config
        self.quantize_report: Optional[QuantizeReport] = None
        self.lm: Optional[GPTLM] = None
        self.gpt_config: Optional[GPTConfig] = None
        self._program = None
        self._scope = Scope()
        self._exe = Executor(_place(self.device))
        qmode = (config._quantize_weights
                 if config._quantize_weights is not None
                 else str(flag("quantize_weights")))
        block = int(flag("quantize_block"))
        if config.params is not None:
            self._load_gpt_params(config)
            self._feed_names, fetch_names = ["tokens"], ["logits"]
            self._fetch_vars = []
            static = {"tokens": None}
        else:
            self._load_program(config)
            fetch_names = [v.name for v in self._fetch_vars]
            block_ = self._program.global_block()
            static = {n: (block_.var(n).shape if block_.has_var(n) else None)
                      for n in self._feed_names}
        if qmode and qmode != "off":
            self.quantize(qmode, block)
        # the program bound: plain, or under enable_partitioning a
        # CompiledProgram carrying the mesh and the specs, so the same
        # bound-step path runs a request tensor-parallel
        self._run_program = self._program
        self.partition = None
        if config._partition is not None:
            if self._program is None:
                raise ValueError(
                    "enable_partitioning shards a saved Program; a "
                    "Config.set_params predictor has none")
            from ..core.compiler import CompiledProgram

            cp = CompiledProgram(self._program).with_partitioning(
                config._partition)
            self._run_program = cp
            self.partition = cp.partition
        self._fetch_names = fetch_names
        self._inputs = {n: _Tensor(n, static[n]) for n in self._feed_names}
        self._outputs = {n: _Tensor(n) for n in fetch_names}
        self._lock = threading.Lock()
        self._bucket_stats = _new_bucket_stats()
        self._trueshape_cache: Dict[tuple, List[tuple]] = {}
        # bound steps by padded feed signature, shared with the clones
        # (a worker pool binds each bucket once); the oldest goes first
        self._bindings: "collections.OrderedDict" = collections.OrderedDict()
        self._bindings_cap = 256
        self._bind_lock = threading.Lock()
        self.bind_tag = "predictor/run"
        # feeds whose dim 1 may be sequence-padded under bucketing, and
        # the dtypes the Program declares for its feeds (a bound step
        # casts to them: the true shapes do not depend on the width a
        # client sent, float64 from JSON or float32)
        self._seq_feed_names = set()
        self._feed_dtypes: Dict[str, str] = {}
        if self._program is not None:
            blk = self._program.global_block()
            self._feed_dtypes = {n: blk.var(n).dtype for n in self._feed_names
                                 if blk.has_var(n)}
            self._seq_feed_names = {
                n for n in self._feed_names
                if blk.has_var(n) and (
                    (len(blk.var(n).shape or ()) >= 2
                     and (blk.var(n).shape[1] or -1) < 0)
                    or getattr(blk.var(n), "lod_level", 0) > 0)}

    # -- loading ---------------------------------------------------------------
    def _load_gpt_params(self, config: Config):
        self.gpt_config = config.gpt_config
        self.lm = GPTLM(config.gpt_config, self.device)
        load_jax_params(self.lm, config.params)

    def _load_program(self, config: Config):
        if config.model_dir is not None:
            model_dir, model_file, params_file = config.model_dir, None, None
        elif config.prog_file is not None:
            model_dir = os.path.dirname(config.prog_file) or "."
            model_file = os.path.basename(config.prog_file)
            params_file = (os.path.basename(config.params_file)
                           if config.params_file else None)
        else:
            raise ValueError("Config has neither model_dir nor prog_file set")
        with scope_guard(self._scope):
            self._program, self._feed_names, self._fetch_vars = \
                io.load_inference_model(model_dir, self._exe,
                                        model_filename=model_file,
                                        params_filename=params_file)
        if config._bf16:
            from ..contrib.mixed_precision.decorator import _insert_cast_ops
            from ..contrib.mixed_precision.fp16_lists import \
                AutoMixedPrecisionLists

            _insert_cast_ops(self._program.global_block(),
                             AutoMixedPrecisionLists())
            self._program._bump()
        if self._feed_names == ["tokens"] and "gpt_tok_emb" in self._scope.vars:
            try:
                self.gpt_config = io.gpt_config_from_model(
                    self._scope.vars, {"program": self._program.to_dict()})
            except (ValueError, KeyError):
                self.gpt_config = None
            # a switch-MoE GPT runs as its Program only: the GPTLM
            # module has dense FFNs, as the JAX generation model does
            if self.gpt_config is not None and not self.gpt_config.moe_every:
                self.lm = GPTLM(self.gpt_config, "meta")
                share_params(self.lm, self._scope.vars)

    def quantize(self, mode: str, block: int) -> QuantizeReport:
        """Quantize the weights once, with ``mode`` and ``block``: the
        Program and the scope (then the LM's matmul layers over the
        scope's quantized tensors), or the in-memory LM's modules.
        Sets and returns ``quantize_report``."""
        if self._program is not None:
            rep = rewrite_for_inference(self._program, self._scope,
                                        wdtype=mode, block=block)
            if self.lm is not None:
                self._share_quantized()
        else:
            rep = rewrite_for_inference(self.lm, mode, block=block)
        self.quantize_report = rep
        return rep

    def _share_quantized(self):
        """Each LM matmul whose weight the scope holds quantized becomes
        a ``QuantizedDense`` over the scope's ``.q`` / ``.qscale``
        tensors (the same tensors, not copies)."""
        meta = getattr(self._scope, "_quantize_meta", {})
        for parent, attr, dense in self.lm.dense_layers():
            if dense.name not in meta or isinstance(dense, QuantizedDense):
                continue
            mode, blk = meta[dense.name]
            setattr(parent, attr, QuantizedDense(
                dense, self._scope.vars[dense.name + ".q"],
                self._scope.vars[dense.name + ".qscale"], mode, blk))

    # -- reference API ---------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name) -> _Tensor:
        return self._inputs[name]

    def get_output_handle(self, name) -> _Tensor:
        return self._outputs[name]

    get_input_tensor = get_input_handle
    get_output_tensor = get_output_handle

    def _bucket_of(self, x, ladder):
        for b in ladder:
            if x <= b:
                return b
        # beyond the ladder: round up to a multiple of the last step
        step = ladder[-1] if ladder else 128
        return -(-x // step) * step

    def _pad_feed(self, feed):
        """Every feed padded up to its (batch, seq) bucket, and (real
        elements, padded elements) for the stats."""
        cfg = self._config
        padded = {}
        n_real = n_pad = 0
        for n, a in feed.items():
            if getattr(a, "shape", None) is None:
                a = np.asarray(a)
            shape = tuple(a.shape)
            pads = [(0, 0)] * len(shape)
            if shape and cfg._pad_batch:
                pads[0] = (0, self._bucket_of(shape[0], cfg._batch_buckets)
                           - shape[0])
            if len(shape) >= 2 and n in self._seq_feed_names:
                pads[1] = (0, self._bucket_of(shape[1], cfg._seq_buckets)
                           - shape[1])
            padded[n] = pad_to(a, pads)
            n_real += int(np.prod(shape, dtype=np.int64))
            n_pad += int(np.prod(tuple(padded[n].shape), dtype=np.int64))
        return padded, (n_real, n_pad)

    def _true_fetch_shapes(self, feed, sig=None):
        """The fetches' shapes at the TRUE request shapes: the plan run
        on meta tensors (nothing computed), cached per signature with
        each feed at its declared dtype."""
        sig = tuple((n, shp, self._feed_dtypes.get(n, dt))
                    for n, shp, dt in (sig or feed_signature(feed)))
        hit = self._trueshape_cache.get(sig)
        if hit is not None:
            return hit
        shapes = eval_shapes(self._program, feed, self._fetch_names,
                             self._scope)
        self._trueshape_cache[sig] = shapes
        return shapes

    @staticmethod
    def _slice_to(out, shape):
        """One fetched value sliced back to its true shape (numpy or a
        tensor, which stays on its device)."""
        if getattr(out, "shape", None) is None:
            out = np.asarray(out)
        if tuple(out.shape) == tuple(shape):
            return out
        return out[tuple(slice(0, s) for s in shape)]

    def bucket_stats(self):
        """Request shapes vs bound (bucketed) shapes, the padding-waste
        fraction and the per-bucket hit histogram ("batch,seq|..." ->
        runs), read under the lock ``run`` updates them with."""
        with self._lock:
            st = dict(self._bucket_stats)
            st["bucket_hits"] = dict(st["bucket_hits"])
            shapes_seen = len(st.pop("shapes_seen"))
            buckets_used = len(st.pop("buckets_used"))
        st["request_shapes"] = shapes_seen
        st["compiled_shapes"] = buckets_used
        st["padding_waste"] = (
            round(1.0 - st["real_elements"] / st["padded_elements"], 4)
            if st["padded_elements"] else 0.0)
        return st

    def _bound_for(self, feed):
        """The ``BoundStep`` of this (padded) feed signature: bound on a
        miss, a dict hit after, shared by every clone."""
        key = (self._program.version, feed_signature(feed))
        bound = self._bindings.get(key)
        if bound is None:
            with self._bind_lock:
                bound = self._bindings.get(key)
                if bound is None:
                    bound = self._exe.bind(self._run_program, feed,
                                           self._fetch_vars,
                                           scope=self._scope,
                                           tag=self.bind_tag)
                    self._bindings[key] = bound
                    while len(self._bindings) > self._bindings_cap:
                        self._bindings.popitem(last=False)
        return bound

    def run(self, inputs: Optional[Sequence] = None,
            return_numpy: bool = True):
        """Run the Program on ``inputs`` (feed order; the handles' values
        when None) through its bound step, padded to the buckets when
        bucketing is on; returns the fetches (numpy, or tensors on the
        device with ``return_numpy=False``)."""
        if self._program is None:
            raise ValueError(
                "this predictor holds GPT weights in memory "
                "(Config.set_params) and no Program: run its module, "
                "pred.lm(tokens)")
        with self._lock:
            if inputs is not None:
                if len(inputs) != len(self._feed_names):
                    raise ValueError(
                        f"run takes {len(self._feed_names)} inputs "
                        f"({self._feed_names}), got {len(inputs)}")
                for n, a in zip(self._feed_names, inputs):
                    self._inputs[n].copy_from_cpu(a)
            feed = {n: t._value for n, t in self._inputs.items()}
            missing = [n for n, v in feed.items() if v is None]
            if missing:
                raise ValueError(f"no value set for inputs {missing}")
            true_shapes = None
            if self._config._bucketing:
                req_sig = feed_signature(feed)
                true_shapes = self._true_fetch_shapes(feed, req_sig)
                feed, counts = self._pad_feed(feed)
                st = self._bucket_stats
                st["runs"] += 1
                st["shapes_seen"].add(req_sig)
                bucket = tuple(tuple(a.shape) for a in feed.values())
                st["buckets_used"].add(bucket)
                bkey = "|".join(",".join(str(d) for d in s) for s in bucket)
                st["bucket_hits"][bkey] = st["bucket_hits"].get(bkey, 0) + 1
                st["real_elements"] += counts[0]
                st["padded_elements"] += counts[1]
            outs = self._bound_for(feed).run(feed, return_numpy)
            if true_shapes is not None:
                outs = [self._slice_to(o, s)
                        for o, s in zip(outs, true_shapes)]
            for t, o in zip(self._outputs.values(), outs):
                t._value = o
        return outs

    def zero_copy_run(self):
        """ZeroCopyRun: ``run()`` on the handles' values."""
        return self.run()

    def clone(self) -> "Predictor":
        """Shares the weights (scope, module), program, executor, bound
        steps and true-shape cache; own IO handles, lock and bucket
        counters — one clone per thread."""
        p = object.__new__(Predictor)
        p.__dict__.update(self.__dict__)
        p._inputs = {n: _Tensor(n, t._static_shape)
                     for n, t in self._inputs.items()}
        p._outputs = {n: _Tensor(n) for n in self._fetch_names}
        p._lock = threading.Lock()
        p._bucket_stats = _new_bucket_stats()
        return p


PaddlePredictor = Predictor


def create_predictor(config: Config,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Predictor:
    """A Predictor on ``device`` (CUDA when None; raises if there is no
    GPU — pass ``device="cpu"`` for the plain CPU path)."""
    return Predictor(config, device)


def create_paddle_predictor(config: Config,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> Predictor:
    return Predictor(config, device)
