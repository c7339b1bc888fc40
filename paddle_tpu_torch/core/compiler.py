"""CompiledProgram / BuildStrategy / ExecutionStrategy: the port's
counterpart of ``paddle_tpu/core/compiler.py``.

A ``CompiledProgram`` wraps a Program with one parallel strategy over
the world (``torch.distributed``, one process a device) and hands it to
``Executor.run`` / ``bind`` / ``run_pipelined``, whose bound step runs
the world side (``runtime/dist_step.py``):

* ``with_data_parallel``: every rank runs the whole step on its own
  batch, and the parameter gradients are averaged over the world's
  ``dp`` mesh axis;
* ``with_partitioning``: the rules partitioner
  (``partition.PartitionConfig``) over a ``dp`` mesh, with ZeRO
  (``zero`` 1: sharded accumulators; 3: sharded parameters too) and the
  bucketed / int8 gradient planner;
* ``with_expert_parallel``: each rank holds ``E/ep`` experts of every
  ``switch_moe`` layer, with the ``psum`` or ``alltoall`` dispatch, over
  an (``dp``, ``ep``) mesh.

Feeds and fetches: a rank's feed is its LOCAL batch (the JAX package's
multi-process contract, ``make_global_array``): under
``with_data_parallel`` the ranks' feeds together make the global batch,
and at a world of one the feed is the whole batch. Under the ``psum``
expert dispatch the ranks of one ``dp`` index feed the same rows; under
``alltoall`` every rank feeds its own. A scalar float fetch computed
before the optimizer is the cross-replica mean (the planner's contract,
``paddle_tpu/parallel/collectives.py:29-33``); any other fetch is the
rank's own value.

* ``with_partitioning`` over a mesh with a ``tp`` axis: Megatron
  tensor parallelism from the specs (``runtime/tp_plan.py``): each rank
  holds its shards of the split parameters and accumulators, and the
  ranks of one ``dp`` index feed the same rows;
* ``with_sequence_parallel``: dim 1 of the ``[B, S, ...]`` feeds split
  over an ``sp`` axis, attention by the ring or by Ulysses; a rank
  feeds its own positions (its slice of dim 1);
* ``with_pipeline``: the stages of a ``PipelineOptimizer`` program over
  a ``pp`` axis, a rank a stage, GPipe or 1F1B
  (``core/pipeline_program.py``); every rank feeds the same batch (its
  ``dp`` shard of it with ``dp``).

Each compile takes exactly one ``with_*`` strategy. ``validate`` needs
the static analyzer (ROADMAP A11h).
"""

from __future__ import annotations

from typing import Optional

from . import framework

__all__ = ["BuildStrategy", "ExecutionStrategy", "CompiledProgram",
           "ParallelExecutor", "places_to_devices"]


class BuildStrategy:
    """Knobs accepted for parity with details/build_strategy.h:37; the
    fusion and memory knobs are advisory."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.fuse_all_reduce_ops = False
        self.fuse_all_optimizer_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """Reference details/execution_strategy.h, kept for API parity."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.allow_op_delay = False


class CompiledProgram:
    def __init__(self, program_or_graph,
                 build_strategy: Optional[BuildStrategy] = None):
        if isinstance(program_or_graph, CompiledProgram):
            program_or_graph = program_or_graph._program
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._mesh = None
        self._in_shardings = None
        # per-state-var specs of this compile only, kept here rather
        # than on the Program's vars
        self._state_shardings = None
        self._axis_env = None
        self._strategy = None
        self._partition = None
        self._frag = None

    def _dispatch_fragment(self):
        """Hashable summary of what the executor's bind key must hold
        of this compile: the mesh (its axes and world), the specs and
        the strategy. Built once after the one strategy ran."""
        frag = self._frag
        if frag is None:
            mesh = self._mesh
            frag = self._frag = (
                (tuple(mesh.shape.items()), mesh.rank,
                 id(mesh.device_mesh)) if mesh is not None else None,
                tuple(sorted((k, tuple(v))
                             for k, v in self._in_shardings.items()))
                if self._in_shardings else None,
                tuple(sorted((k, tuple(v))
                             for k, v in self._state_shardings.items()))
                if self._state_shardings else None,
                tuple(sorted(self._axis_env.items()))
                if self._axis_env else None,
                self._strategy,
            )
        return frag

    def _claim_strategy(self, name: str) -> None:
        """Each compile takes exactly ONE with_* strategy; combined
        meshes come from the strategy's own ``dp=`` argument."""
        if self._strategy is not None:
            raise ValueError(
                f"CompiledProgram: {name} after {self._strategy} — "
                f"strategies are mutually exclusive per compile; use "
                f"the dp= argument of {self._strategy} (or a fresh "
                f"CompiledProgram) for combined meshes")
        self._strategy = name
        self._frag = None

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None, places=None
                           ) -> "CompiledProgram":
        """Data parallelism over the whole world: a ``dp`` mesh of every
        rank, each rank's feed its local batch, the parameter gradients
        averaged over ``dp``. Vars carrying a ``dp`` spec
        (``parallel.sharding.shard_optimizer_states``) are held as
        chunks (ZeRO)."""
        from ..parallel.env import get_world_size
        from ..parallel.mesh import make_mesh, world_group

        self._claim_strategy("with_data_parallel")
        if build_strategy is not None:
            self._build_strategy = build_strategy
        world = get_world_size() if world_group() is not None else 1
        self._mesh = make_mesh({"dp": world})
        shardings, state = {}, {}
        for v in self._program.global_block().vars.values():
            if getattr(v, "is_data", False) and v.shape:
                shardings[v.name] = ("dp",) + (None,) * (len(v.shape) - 1)
            spec = getattr(v, "sharding", None)
            if spec is not None and v.persistable:
                flat = [a for e in spec if e is not None
                        for a in ((e,) if isinstance(e, str) else tuple(e))]
                if flat and all(a in self._mesh.shape for a in flat):
                    state[v.name] = tuple(spec)
        self._in_shardings = shardings
        self._state_shardings = state or None
        return self

    def _axis_mesh(self, axis: str, n: int, dp: int):
        from ..parallel.mesh import make_mesh

        if dp > 1:
            return make_mesh({"dp": dp, axis: n})
        return make_mesh({axis: n})

    def with_partitioning(self, config=None, devices=None,
                          **kwargs) -> "CompiledProgram":
        """The logical-axis-rules partitioner over the world: resolve
        the feeds', parameters' and accumulators' specs from the
        config's rules over its mesh and attach them to this compile:
        the ``dp`` axis with ZeRO, and a ``tp`` axis (Megatron tensor
        parallelism, ``runtime/tp_plan.py``). The resolve report is
        kept on ``self.partition`` and exported as
        ``paddle_partition_*`` gauges."""
        from ..partition import PartitionConfig

        if config is None:
            config = PartitionConfig(**kwargs)
        elif kwargs:
            raise ValueError(
                "with_partitioning: pass a PartitionConfig OR keyword "
                "arguments for one, not both")
        self._claim_strategy("with_partitioning")
        mesh = config.build_mesh(devices)
        if config.collectives_active():
            from ..parallel.collectives import ensure_planned

            ensure_planned(
                self._program,
                bucket_mb=config.effective_bucket_mb(mesh),
                quantization=config.collective_quantization,
                quant_block=config.collective_quant_block)
        resolved = config.resolve(self._program, mesh=mesh)
        self._mesh = resolved.mesh
        self._in_shardings = dict(resolved.in_shardings)
        self._state_shardings = dict(resolved.state_shardings) or None
        self._partition = resolved
        return self

    @property
    def partition(self):
        """The ResolvedPartition of with_partitioning (None otherwise)."""
        return self._partition

    def with_sequence_parallel(self, sp: int, dp: int = 1, places=None,
                               mode: str = "ring") -> "CompiledProgram":
        """Sequence (context) parallelism: dim 1 of the ``[B, S, ...]``
        data vars split over an ``sp`` axis, optionally with a ``dp``
        axis around it (the world is ``dp * sp`` ranks). The
        ``flash_attention`` op runs one of two strategies:

          mode="ring"    — K/V shards rotate around the ring
                           (parallel/ring_attention.py); any head
                           count, sp-1 K/V rotations;
          mode="ulysses" — all-to-all head<->sequence exchange
                           (parallel/ulysses.py); needs heads % sp == 0
                           (else the ring, with a warning).

        Only data vars whose dim 1 divides by ``sp`` are split; the
        rest (a ``[B, 1]`` label) stay whole on that dim. A rank feeds
        its own slice of dim 1 (of its dp shard of dim 0)."""
        if mode not in ("ring", "ulysses"):
            raise ValueError(f"with_sequence_parallel: mode must be "
                             f"'ring' or 'ulysses', got {mode!r}")
        self._claim_strategy("with_sequence_parallel")
        self._axis_env = {"sp_mode": mode}
        self._mesh = self._axis_mesh("sp", sp, dp)
        shardings = {}
        for v in self._program.global_block().vars.values():
            if not (getattr(v, "is_data", False) and v.shape):
                continue
            lead = "dp" if dp > 1 else None
            if len(v.shape) >= 2 and v.shape[1] > 0 and v.shape[1] % sp == 0:
                shardings[v.name] = ((lead, "sp")
                                     + (None,) * (len(v.shape) - 2))
            elif lead:
                shardings[v.name] = (lead,) + (None,) * (len(v.shape) - 1)
        self._in_shardings = shardings
        return self

    def with_expert_parallel(self, ep: int, dp: int = 1, places=None,
                             dispatch: str = "psum") -> "CompiledProgram":
        """Expert parallelism: every ``switch_moe`` layer's expert
        weights (vars tagged ``_moe_expert_param``) and their same-shape
        accumulators are held as each rank's ``E/ep`` experts over an
        ``ep`` axis, optionally with a ``dp`` axis around it (the world
        is ``dp * ep`` ranks, rank = dp index * ep + ep index).

          dispatch="psum"     — the ranks of one dp index feed the same
                                tokens; each computes its experts for
                                all of them and an all-reduce over ep
                                combines the outputs;
          dispatch="alltoall" — every rank feeds its own tokens; one
                                all-to-all over ep delivers each rank
                                the tokens routed to its experts, a
                                second returns the outputs.
        """
        if dispatch not in ("psum", "alltoall"):
            raise ValueError(f"with_expert_parallel: dispatch must be "
                             f"'psum' or 'alltoall', got {dispatch!r}")
        self._claim_strategy("with_expert_parallel")
        self._axis_env = {"ep_dispatch": dispatch}
        self._mesh = self._axis_mesh("ep", ep, dp)
        shardings, state = {}, {}
        batch_axes = ((("dp", "ep") if dp > 1 else ("ep",))
                      if dispatch == "alltoall"
                      else (("dp",) if dp > 1 else None))
        expert_names = set()
        block = self._program.global_block()
        for v in block.vars.values():
            if getattr(v, "_moe_expert_param", False):
                state[v.name] = ("ep",) + (None,) * (len(v.shape) - 1)
                expert_names.add(v.name)
            elif getattr(v, "is_data", False) and v.shape and batch_axes:
                shardings[v.name] = ((batch_axes,)
                                     + (None,) * (len(v.shape) - 1))
        for v in block.vars.values():
            if (getattr(v, "accumulator_owner", None) in expert_names
                    and v.shape and max(v.shape) > 1):
                owner = block.var(v.accumulator_owner)
                if tuple(v.shape) == tuple(owner.shape):
                    state[v.name] = ("ep",) + (None,) * (len(v.shape) - 1)
        if not state:
            raise ValueError(
                "with_expert_parallel: program has no switch_moe expert "
                "parameters (layers.switch_moe tags them)")
        self._in_shardings = shardings
        self._state_shardings = state
        return self

    def with_pipeline(self, places=None, dp: int = 1,
                      mp: int = 1) -> "CompiledProgram":
        """A mesh whose ``pp`` axis is the program's pipeline stages
        (``PipelineOptimizer`` cut_list), a rank a stage; the step runs
        the GPipe or 1F1B schedule (``core/pipeline_program.py``).
        ``dp`` adds a data-parallel axis around the pipeline (the world
        is ``dp * pp`` ranks, rank = dp index * pp + stage): the ranks of
        one stage average their gradients.

        ``mp`` (tensor parallelism inside a pipelined stage) is refused,
        as in the JAX package: tensor parallelism inside pipeline stages
        takes ``parallel.pipeline.pipeline_train_step_3d``, whose stage
        function runs its own collectives."""
        from ..parallel.env import get_world_size
        from ..parallel.mesh import make_mesh, world_group

        if mp > 1:
            raise NotImplementedError(
                "with_pipeline(mp=...): tensor parallelism inside "
                "pipelined stages requires manual collectives — use "
                "parallel.pipeline.pipeline_train_step_3d, or compose "
                "with_pipeline(dp=...) with megatron sharding OUTSIDE "
                "a pipeline (plain pjit path)")
        cuts = getattr(self._program, "_pipeline_cuts", None)
        if not cuts:
            raise ValueError(
                "program has no pipeline cuts — minimize with "
                "PipelineOptimizer(cut_list=...) first")
        if dp > 1:
            for v in self._program.global_block().vars.values():
                if not (getattr(v, "is_data", False) and v.shape):
                    continue
                lead = v.shape[0]
                if lead is not None and lead > 0 and lead % dp:
                    raise ValueError(
                        f"with_pipeline(dp={dp}): data var {v.name!r} has "
                        f"leading (batch) dim {lead}, not divisible by "
                        f"dp={dp} — adjust the batch size or dp")
        self._claim_strategy("with_pipeline")
        n = len(cuts) + 1
        need = n * dp
        have = get_world_size() if world_group() is not None else 1
        if have < need:
            raise ValueError(
                f"pipeline needs pp*dp={need} devices, have {have}")
        self._mesh = make_mesh({"dp": dp, "pp": n} if dp > 1 else {"pp": n})
        self._in_shardings = {}
        if dp > 1:
            for v in self._program.global_block().vars.values():
                if getattr(v, "is_data", False) and v.shape:
                    self._in_shardings[v.name] = \
                        ("dp",) + (None,) * (len(v.shape) - 1)
        return self

    def validate(self, fetch_list=None, strict: bool = False):
        raise NotImplementedError(
            "CompiledProgram.validate needs the static program analyzer "
            "(paddle_tpu/analysis), not ported to paddle_tpu_torch yet "
            "(ROADMAP A11h)")

    @property
    def program(self):
        return self._program


class ParallelExecutor:
    """Reference parallel_executor.py ParallelExecutor: the JAX
    package's shim (``paddle_tpu/__init__.py:202-225``) over
    ``CompiledProgram.with_data_parallel`` and an Executor, on the card
    (``use_cuda``) or the CPU."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from .executor import Executor
        from .places import CPUPlace, CUDAPlace

        self._program = main_program or framework.default_main_program()
        self._compiled = CompiledProgram(self._program).with_data_parallel(
            loss_name=loss_name, build_strategy=build_strategy,
            exec_strategy=exec_strategy)
        self._exe = Executor(CUDAPlace(0) if use_cuda else CPUPlace())
        self._scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(self._compiled, feed=feed,
                             fetch_list=fetch_list, scope=self._scope,
                             return_numpy=return_numpy)


def places_to_devices(places):
    """The torch devices of ``places``."""
    return [p.torch_device() for p in places]
