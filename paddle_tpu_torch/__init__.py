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

* distribution over ``torch.distributed`` (one process a device,
  ``nccl`` on the card, ``gloo`` on the CPU or for ranks sharing one
  GPU): ``CompiledProgram`` with ``with_data_parallel``,
  ``with_partitioning`` (``partition``: the rules partitioner, ZeRO 1
  and 3, the bucketed and int8 gradient all-reduce of
  ``parallel.collectives``) and ``with_expert_parallel`` (the MoE's
  ``psum`` and ``alltoall`` dispatch), the collective ops and
  transpilers (``transpiler.GradAllReduce``, ``LocalSGD``), ``fleet``,
  the coordinator and the elastic launcher (``distributed``), and
  ``DGCMomentumOptimizer``;

      # python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \
      #     --backend gloo train.py
      from paddle_tpu_torch.parallel import fleet
      fleet.init(fleet.PaddleCloudRoleMaker())
      fleet.distributed_optimizer(fluid.optimizer.Adam(1e-3)).minimize(loss)
      exe.run(fleet.main_program, feed=local_batch, fetch_list=[loss])

Tensor, sequence and pipeline parallelism run on the same world:
``with_partitioning`` over a ``tp`` axis (Megatron specs, from
``models.gpt.apply_gpt_megatron_sharding`` or the logical-axis rules),
``with_sequence_parallel(sp, mode="ring" | "ulysses")`` and
``PipelineOptimizer`` + ``with_pipeline`` (GPipe or 1F1B).

Recurrence and sequences run over dense [B, T, ...] batches with a
length tensor: ``layers.StaticRNN`` / ``DynamicRNN`` (the ``recurrent``
op), ``dynamic_lstm`` / ``dynamic_gru``, the sequence, LoD, beam and
CRF / CTC ops, ``contrib.layers.basic_gru`` / ``basic_lstm``, the beam
search decoder, ``evaluator`` and ``models.seq2seq``.

The imperative mode (``dygraph``, also ``fluid.dygraph``): an eager
tracer over the same op lowerings with ``torch.autograd`` gradients,
``Layer`` and every ``dygraph.nn`` class, the eager optimizers (SGD,
Momentum, Adam, Lamb) and learning-rate schedulers, ``TracedLayer`` /
``to_static`` as CUDA graphs, ``declarative``, ``save_dygraph`` /
``load_dygraph`` and ``DataParallel``;

    with fluid.dygraph.guard(fluid.CUDAPlace(0)):
        model = fluid.dygraph.Linear(8, 3)
        loss = fluid.layers.mean(model(fluid.dygraph.to_variable(x)))
        loss.backward()
        fluid.optimizer.SGD(0.1).minimize(
            loss, parameter_list=model.parameters())

Detection: the 35 lowerings of the detection ops (box coding, priors
and anchors, multi-class NMS, ROI pooling and alignment, deformable
convolution, target assignment and mining, the proposal chain, YOLO,
``detection_map``), their layers, ``models.ssd`` (``build_ssd``, the
``ssd_loss_dense`` matching loss, ``detection_output``) and
``evaluator.DetectionMAP``.

The rest of the layer surface: every public callable of
``fluid.layers`` (the SSD layers ``multi_box_head``, ``ssd_loss`` and
``detection_output`` among them), ``layers.distributions``,
``contrib.layers``, and all 424 of the JAX package's op lowerings
(interpolation, grid sampling, instance norm, the ranking and CTR
losses, the streaming metrics, ``py_func`` and ``Print`` on the host,
the in-Program save / load ops, ``sync_batch_norm`` over a
data-parallel world, the inference fusions, the parameter server's ops,
and the serving kernels' Program forms behind
``generation.build_ragged_step_program`` and its two_lane pair).

The parameter server: ``ps/`` (the JAX package's wire, host numpy
shards and update rules), ``transpiler.DistributeTranspiler`` in
pserver mode and ``GeoSgdTranspiler``, fleet's PS lifecycle and
``distributed.launch_ps``.

The rest of the public surface: the top-level names of JAX's
``paddle_tpu/__init__.py`` (``Block``, ``Operator``, ``Parameter``,
``name_scope``, ``Place`` and the place helpers, the initializer
aliases, ``WeightNormParamAttr``, ``require_version``,
``load_op_library``, ``save`` / ``load`` and their params and
persistables forms, ``debugger``, ``install_check.run_check()`` on the
card, ``__version__``), ``transpiler.auto_nhwc`` (an NCHW Program
trained channels-last: cuDNN's NHWC kernels), ``contrib``'s
``extend_optimizer`` (decoupled weight decay), ``memory_usage``,
``summary`` and ``op_freq_statistic``, ``layers.collective``,
``incubate.data_generator``, ``incubate.fleet.utils.FleetUtil`` and
``fs.HDFSClient``;

    main, startup, feeds, fetches = models.resnet.build_resnet50()
    with fluid.program_guard(main, startup):
        fluid.transpiler.auto_nhwc(main)      # before minimize
        fluid.optimizer.Momentum(0.1, 0.9).minimize(fetches["loss"])

Every TPU kernel of the JAX package has its CUDA counterpart. Not
ported yet: ``analysis`` (ROADMAP A11h), ``contrib.slim``'s NAS, prune
and distillation (A11i), the autotune profiles of ``flags`` and the
kernel geometry table (A11k), ``capi`` and ``go`` (A11l). JAX's
TPU-only names have a CUDA counterpart or are refused by name:
``TPUPlace`` names ``CUDAPlace``, ``Place.jax_device`` is
``Place.torch_device``, ``Executor.aot_compile`` names
``Executor.bind``, ``kernels.layer_norm_pallas`` names K1's
``kernels.layer_norm``; ``is_compiled_with_tpu()`` is False.

Entry points run on CUDA unless the caller names the CPU
(``device="cpu"``, ``CPUPlace()``); with no GPU they raise instead of
falling back.
"""

from . import (average, clip, contrib, dygraph, evaluator,  # noqa: F401
               initializer, io, layers, metrics, nets,
               ops,  # ops: the lowerings
               optimizer, parallel, partition, profiler, regularizer,
               resilience, transpiler)
from .core import framework
from .core.compiler import (BuildStrategy, CompiledProgram,
                            ExecutionStrategy, ParallelExecutor)
from .core.backward import append_backward, gradients
from .core.executor import Executor, Scope, global_scope, scope_guard
from .core.framework import (Block, Operator, Parameter, Program, Variable,
                             default_main_program, default_startup_program,
                             in_dygraph_mode, name_scope, program_guard,
                             unique_name)
from .core.places import (TPU_PLACE_REFUSAL, CPUPlace, CUDAPlace, Place,
                          cpu_places, cuda_pinned_places, cuda_places,
                          device_guard, is_compiled_with_cuda,
                          is_compiled_with_tpu)
from .data_feeder import DataFeeder
from .device import resolve_device
from .flags import get_flags, set_flags
from .initializer import (Bilinear, Constant, MSRA, Normal,
                          NumpyArrayInitializer, TruncatedNormal, Uniform,
                          Xavier)
from .io import (load, load_params, load_persistables, save, save_params,
                 save_persistables)
from .lod_tensor import (LoDTensor, create_lod_tensor,
                         create_random_int_lodtensor)
from .param_attr import ParamAttr, WeightNormParamAttr
from .reader import DataLoader
from . import flags, observability, serving  # noqa: F401,E402
from .version import commit as __git_commit__  # noqa: E402
from .version import full_version as __version__  # noqa: E402

__all__ = ["resolve_device", "clip", "contrib", "io", "layers", "nets",
           "optimizer", "regularizer", "resilience", "average", "metrics",
           "profiler", "DataLoader", "DataFeeder", "LoDTensor",
           "create_lod_tensor", "create_random_int_lodtensor",
           "framework",
           "append_backward", "gradients", "Executor", "Scope", "global_scope",
           "scope_guard", "Program", "Block", "Operator", "Variable",
           "Parameter", "default_main_program",
           "default_startup_program", "program_guard", "unique_name",
           "name_scope", "Place", "CPUPlace", "CUDAPlace", "cpu_places",
           "cuda_places", "cuda_pinned_places", "device_guard",
           "is_compiled_with_cuda", "is_compiled_with_tpu", "get_flags",
           "set_flags", "ParamAttr", "WeightNormParamAttr", "parallel",
           "partition", "transpiler",
           "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "ParallelExecutor", "dygraph", "in_dygraph_mode", "initializer",
           "Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
           "MSRA", "Bilinear", "NumpyArrayInitializer", "save", "load",
           "save_params", "load_params", "save_persistables",
           "load_persistables", "require_version", "load_op_library",
           "debugger", "flags", "generation", "incubate", "install_check",
           "observability", "quantize", "serving", "traffic"]


# imported on first use, so that ``import paddle_tpu_torch`` loads no
# more modules than the names above need
_LAZY_MODULES = ("debugger", "generation", "incubate", "install_check",
                 "quantize", "traffic")


def __getattr__(name):
    if name == "TPUPlace":
        raise AttributeError(TPU_PLACE_REFUSAL)
    if name in _LAZY_MODULES:
        import importlib
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def require_version(min_version, max_version=None):
    """Reference framework.py ``require_version``, with JAX's parse: a
    version pads to three parts, so '0.1' admits any 0.1.x."""
    def parse(s):
        parts = []
        for x in str(s).split(".")[:3]:
            digits = "".join(ch for ch in x if ch.isdigit())
            parts.append(int(digits or 0))
        while len(parts) < 3:
            parts.append(0)
        return tuple(parts)

    cur = parse(__version__)
    if parse(min_version) > cur:
        raise Exception(
            f"paddle_tpu_torch version {__version__} < required {min_version}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"paddle_tpu_torch version {__version__} > allowed {max_version}")


def load_op_library(lib_path):
    """Reference framework.py ``load_op_library`` (a custom op's .so).
    A custom op of the port is a Python module that calls
    ``core.registry.register_op``: a path to a ``.py`` runs it, which
    registers its ops; any other path is loaded with ``ctypes`` (host
    code for a ``py_func``) and returned."""
    import ctypes
    import runpy

    if str(lib_path).endswith(".py"):
        runpy.run_path(str(lib_path))
        return None
    return ctypes.CDLL(str(lib_path))
