"""paddle_tpu_torch: the PyTorch / CUDA (Hopper) port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package is
its counterpart in PyTorch idiom (``nn.Module``s, plain functions on
tensors, an explicit ``device``, explicit ``torch.Generator``s). It
never imports ``jax``, ``jaxlib`` or any part of ``paddle_tpu``: what
it needs from there it keeps as its own copy.

Ported so far:

* serving: the ragged ``GenerationEngine`` over a GPT ``Predictor``,
  with hand-written CUDA kernels for the ragged paged attention and the
  layer-norm forward;

      from paddle_tpu_torch.inference import Config, create_predictor
      from paddle_tpu_torch.generation import GenerationEngine
      pred = create_predictor(Config(lm_model_dir))      # CUDA by default
      eng = GenerationEngine(pred, pred.gpt_config)
      eng.generate([1, 5, 9], max_new_tokens=32)

* quantized, multi-adapter serving: int8 / int8_block / fp8 weights
  (``Config.enable_weight_quantization`` or the ``quantize_weights``
  flag; ``quantize.rewrite_for_inference``, the K11 kernel), int8 KV
  pages (``GenerationEngine(kv_dtype="int8")``, K2q) and batched LoRA
  adapters over the quantized base (``adapters.AdapterStore``,
  ``submit(..., adapter=id)``, K12);

      cfg = Config(lm_dir); cfg.enable_weight_quantization("int8")
      pred = create_predictor(cfg)
      store = AdapterStore.for_model(pred.lm, rank_buckets=(8, 16),
                                     slots_per_bucket=4)
      eng = GenerationEngine(pred, pred.gpt_config, kv_dtype="int8",
                             adapter_store=store)
      store.upload("ad0", {"dec0_ffn1.w": (A, B)}, alpha=16.0)
      eng.submit(prompt, max_new_tokens=32, adapter="ad0")

* the two_lane engine (``GenerationEngine(..., mode="two_lane")``):
  prefill on a ladder of sequence buckets, decode one token a lane
  through the paged decode-attention kernel (K13);

* training: the Program IR, ``append_backward``, ``AdamOptimizer``,
  ``MomentumOptimizer`` and ``SGDOptimizer``, gradient clipping
  (``clip``) and weight decay (``regularizer``), the bfloat16 AMP
  decorator (``contrib.mixed_precision.decorate``) and an eager
  ``Executor``, with CUDA kernels for the layer-norm backward, softmax
  cross-entropy forward and backward, flash attention forward and
  backward, and the fused Adam and momentum updates; GPT
  (``models.gpt``), BERT pretraining (``models.bert``) and ResNet-50
  (``models.resnet``, conv / batch-norm / pool through cuDNN) build on
  it;

      import paddle_tpu_torch as fluid
      main, startup = fluid.Program(), fluid.Program()
      with fluid.program_guard(main, startup):
          x = fluid.layers.data("x", [8])
          y = fluid.layers.data("y", [1], dtype="int64")
          loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
              fluid.layers.fc(x, 3), y))
          fluid.optimizer.Adam(1e-2).minimize(loss)
      exe = fluid.Executor(fluid.CUDAPlace(0))    # or fluid.CPUPlace()
      exe.run(startup)
      exe.run(main, feed={...}, fetch_list=[loss])

* saving and serving any inference Program:
  ``io.save_inference_model`` / ``load_inference_model`` (the JAX
  package's file format), the Program ``Predictor`` with shape
  bucketing and load-time weight quantization, the dynamic-batching
  ``serving.ServingEngine`` and the HTTP ``serving.ServingServer``
  (``/v1/predict``, streamed ``/v1/generate``, the adapter admin
  endpoints, ``/healthz``, ``/metrics``), and the hot base swap
  (``GenerationEngine.swap_base``);

      fluid.io.save_inference_model(d, ["image"], [prob], exe, main)
      cfg = Config(d); cfg.enable_shape_bucketing()
      srv = ServingServer(ServingEngine(create_predictor(cfg)), port=8500)

* supervised training with committed checkpoints: ``io.save_checkpoint``
  / ``load_checkpoint`` / ``latest_checkpoint`` (the JAX package's
  ``__shards__`` layout, readable by either package), the
  ``resilience.Supervisor`` (auto-resume, retry, NaN rollback, hang
  watchdog, preemption flush) with ``CheckpointPolicy`` and fault
  injection, the other optimizers (Lamb, LarsMomentum, Adagrad, Adamax,
  RMSProp, Adadelta, DecayedAdagrad, Ftrl, Dpsgd) and the learning-rate
  schedules (``layers.noam_decay`` ... ``layers.linear_lr_warmup``);

      lr = fluid.layers.linear_lr_warmup(fluid.layers.polynomial_decay(
          1e-4, decay_steps=10000, end_learning_rate=0.0), 100, 0.0, 1e-4)
      fluid.optimizer.LambOptimizer(lr).minimize(loss)
      sup = resilience.Supervisor(exe, main, "ckpts/run0",
                                  feed_fn=make_feed, fetch_list=[loss])
      sup.run_loop(num_steps=10000)      # resumes from the latest commit

* the rest of the training path: SelectedRows gradients of
  ``embedding(is_sparse=True)`` with the lazy sparse updates (DeepFM and
  wide&deep, ``models.ctr``), ``While`` / ``Switch`` / ``cond`` and the
  tensor arrays over ``core/control_flow.py``, the meta-optimizers
  (``RecomputeOptimizer``, ``GradientMergeOptimizer``,
  ``LookaheadOptimizer``, ``ExponentialMovingAverage``,
  ``ModelAverage``) and the switch-MoE GPT (``GPTConfig.moe_every``);

      opt = fluid.optimizer.RecomputeOptimizer(fluid.optimizer.Adam(1e-4))
      opt._set_checkpoints(decoder_outputs)
      fluid.optimizer.GradientMergeOptimizer(opt, k_steps=4).minimize(loss)

* the everyday layers and quantization-aware training: the
  activations, reductions, tensor and indexing layers, transposed,
  depthwise and SAME / VALID convolutions, adaptive pooling,
  ``nets.simple_img_conv_pool`` / ``img_conv_group`` / ``glu``, LeNet,
  VGG and SE-ResNeXt (``models.mnist``, ``models.vision``); the
  fake-quantize ops, ``quantize.calibrate`` and
  ``contrib.slim.QuantizationTransformPass`` /
  ``QuantizationFreezePass``;

      opt.minimize(loss)
      QuantizationTransformPass(startup_program=startup).apply(main)

* the serving host tiers: disaggregated prefill/decode through a page
  store (``disagg``: ``PrefillWorker``, ``DecodeWorker``,
  ``DisaggService``, ``HostPageStore`` and its TCP server and client),
  the traffic tier (``traffic``: token-bucket tenants, priority classes,
  deadline sheds, ``WorkerPool`` behind SO_REUSEPORT), the unified
  metrics registry, trace propagation and fleet aggregation with the
  SLO gauges (``observability``);

      svc = DisaggService(prefill=[PrefillWorker(pred, cfg, store)],
                          decode=[DecodeWorker(pred, cfg, store)])
      ctl = traffic.TrafficController(engine, generation_engine=svc)
      srv = ServingServer(engine, generation_engine=svc, traffic=ctl)

* the data tiers: ``DataLoader.from_generator`` (device prefetch on a
  side stream, rank sharding, a resumable position the Supervisor
  restores), ``DataFeeder``, ``LoDTensor``, the overlapped
  ``Executor.run_pipelined``, the file datasets (``dataset``: the native
  MultiSlot parser, ``InMemoryDataset`` shuffles) behind
  ``Executor.train_from_dataset`` (Hogwild threads with ``thread`` > 1),
  the synthetic readers of ``datasets``, ``profiler`` over
  ``torch.profiler`` with the chrome-trace ``tools_timeline``, the host
  ``metrics`` and ``average``, and the ``FLAGS_`` environment overrides;

      from paddle_tpu_torch import datasets
      loader = fluid.DataLoader.from_generator([image, label], capacity=8)
      loader.set_sample_list_generator(
          fluid.io.batch(datasets.flowers.train(), 64))
      for loss_v, in exe.run_pipelined(main, loader, [loss]):
          ...
      with fluid.profiler.profiler(profile_path="trace_dir"):
          exe.train_from_dataset(main, dataset, thread=4)

Every TPU kernel of the JAX package has its CUDA counterpart. Not
ported yet (ROADMAP A): distribution (A10: meshes, expert parallelism,
DGC and pipeline optimizers) and the long tail (A11: ``StaticRNN`` /
``DynamicRNN``, HDFS, autotune and the rest).

Entry points run on CUDA unless the caller names the CPU
(``device="cpu"``, ``CPUPlace()``); with no GPU they raise instead of
falling back.
"""

from . import (average, clip, contrib, io, layers,  # noqa: F401
               metrics, nets,
               ops,  # ops: the lowerings
               optimizer, profiler, regularizer, resilience)
from .core import framework
from .core.backward import append_backward
from .core.executor import Executor, Scope, global_scope, scope_guard
from .core.framework import (Program, Variable, default_main_program,
                             default_startup_program, program_guard,
                             unique_name)
from .core.places import CPUPlace, CUDAPlace
from .data_feeder import DataFeeder
from .device import resolve_device
from .flags import get_flags, set_flags
from .lod_tensor import (LoDTensor, create_lod_tensor,
                         create_random_int_lodtensor)
from .param_attr import ParamAttr
from .reader import DataLoader

__all__ = ["resolve_device", "clip", "contrib", "io", "layers", "nets",
           "optimizer", "regularizer", "resilience", "average", "metrics",
           "profiler", "DataLoader", "DataFeeder", "LoDTensor",
           "create_lod_tensor", "create_random_int_lodtensor",
           "framework",
           "append_backward", "Executor", "Scope", "global_scope",
           "scope_guard", "Program", "Variable", "default_main_program",
           "default_startup_program", "program_guard", "unique_name",
           "CPUPlace", "CUDAPlace", "get_flags",
           "set_flags", "ParamAttr"]
