"""Fleet API: the distributed-training front end, the port's
counterpart of ``paddle_tpu/parallel/fleet.py`` (reference
incubate/fleet/base/fleet_base.py, role_maker.py,
collective/__init__.py).

``fleet.distributed_optimizer(opt, strategy).minimize(loss)`` runs the
normal minimize (under recompute or AMP when the strategy asks), ZeRO
through ``shard_optimizer_states`` over the world when
``strategy.sharding`` is set, and then attaches
``CompiledProgram.with_data_parallel``: ``fleet.main_program`` is that
CompiledProgram. ``fleet.init`` forms the world (``init_parallel_env``)
when the role maker counts more than one worker.

The parameter-server mode: ``distributed_optimizer`` with
``strategy.mode == "pserver"`` (or pservers named by the role maker and
a strategy that is not collective) gives a ``PSDistributedOptimizer``,
whose ``minimize`` runs the inner minimize and ``DistributeTranspiler``
in pserver mode; ``run_server`` serves this process's endpoint's
shards (blocking), ``init_worker`` returns the ``ps.PSTrainer`` that
runs the steps, ``stop_worker`` waits for every trainer (sync mode) and
has worker 0 shut the pservers down (JAX's lifecycle, :187-235;
``distributed.launch_ps`` spawns such a job). ``fleet.init`` forms no
collective world in PS mode (a non-collective role maker that names
pservers): the trainers meet at the pservers.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from ..core import framework
from ..core.compiler import BuildStrategy, CompiledProgram
from .env import ParallelEnv, get_world_size, init_parallel_env

__all__ = ["Mode", "Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "MPISymetricRoleMaker",
           "DistributedStrategy", "DistributedOptimizer",
           "PSDistributedOptimizer", "fleet"]

_log = logging.getLogger("paddle_tpu_torch.fleet")


class Mode:
    TRANSPILER = 1
    PSLIB = 2
    COLLECTIVE = 3


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._env = ParallelEnv()
        self._training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in eps.split(",") if e]

    def worker_index(self) -> int:
        return self._env.rank

    def worker_num(self) -> int:
        return self._env.world_size

    def server_num(self) -> int:
        return len(self._server_endpoints)

    def is_worker(self) -> bool:
        return self._training_role != "PSERVER"

    def is_server(self) -> bool:
        return self._training_role == "PSERVER"

    def is_first_worker(self) -> bool:
        return self.is_worker() and self.worker_index() == 0

    def get_trainer_endpoints(self):
        return self._env.trainer_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def get_current_endpoint(self):
        return self._env.current_endpoint

    def generate_role(self):
        pass


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the PADDLE_* env contract (reference role_maker.py:441)."""

    def __init__(self, is_collective: bool = True):
        super().__init__()
        self._is_collective = is_collective


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._env._rank = current_id
        self._env._world_size = worker_num
        self._role = role
        self._server_endpoints = list(server_endpoints or [])

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER


class MPISymetricRoleMaker(RoleMakerBase):
    """Reference role_maker.py:150 discovered ranks through MPI; here the
    env contract supplies them, so this is an alias."""


class DistributedStrategy:
    def __init__(self):
        self.build_strategy = BuildStrategy()
        self.use_local_sgd = False
        self.local_sgd_steps = 1
        self.forward_recompute = False
        self.recompute_checkpoints = []
        self.use_amp = False
        self.amp_loss_scale = 2.0**15
        self.nccl_comm_num = 1
        self.hierarchical_allreduce = False
        self.exec_strategy = None
        self.mode = "collective"
        # ZeRO-1: shard the optimizer accumulators over the world
        self.sharding = False


class _Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._origin_program = None
        self._compiled_program = None
        self._strategy: Optional[DistributedStrategy] = None

    def init(self, role_maker: Optional[RoleMakerBase] = None,
             is_collective: bool = True):
        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        self._compiled_program = None
        ps_mode = (self._role_maker.server_num() > 0
                   and not getattr(self._role_maker, "_is_collective", True))
        if self._role_maker.worker_num() > 1 and not ps_mode:
            init_parallel_env()
        return self

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def worker_endpoints(self):
        return self._role_maker.get_trainer_endpoints()

    def barrier_worker(self):
        """A barrier of every worker (the coordinator's, over the
        world's store, with its timeout); a no-op for one worker."""
        if self.worker_num() > 1:
            from ..distributed.coordinator import initialize

            initialize(heartbeat=False).barrier("fleet_barrier")

    @property
    def main_program(self):
        return self._compiled_program or framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy] = None):
        strategy = strategy or DistributedStrategy()
        if strategy.mode == "pserver" or (
                self._role_maker is not None
                and self._role_maker.server_num() > 0
                and strategy.mode != "collective"):
            return PSDistributedOptimizer(self, optimizer, strategy)
        return DistributedOptimizer(self, optimizer, strategy)

    # -- the parameter-server lifecycle -----------------------------------
    def init_server(self, model_dir: Optional[str] = None):
        pass

    def run_server(self, scope=None):
        """Serve this process's endpoint's shards, cut from ``scope``
        (the global scope; run the startup Program first), until a
        trainer shuts the pservers down."""
        if not self.is_server():
            raise RuntimeError("run_server() called on a non-server role")
        from ..core.executor import global_scope
        from ..ps.server import ParameterServer
        from ..ps.transpile import server_shards

        art = self._ps_artifacts
        ep = self._role_maker.get_current_endpoint()
        shards, specs = server_shards(art, scope or global_scope(), ep)
        ParameterServer(ep, shards, specs, art.trainers,
                        art.sync_mode).serve_forever()

    def init_worker(self, executor=None, scope=None):
        """The trainer's ``ps.PSTrainer`` over ``executor`` (an Executor
        on the card unless given) and ``scope`` (the global scope),
        once every pserver accepts connections."""
        from ..core.executor import Executor, global_scope
        from ..ps.client import wait_server_ready
        from ..ps.transpile import PSTrainer

        wait_server_ready(self._ps_artifacts.endpoints)
        self._ps_trainer = PSTrainer(
            self._ps_artifacts, executor or Executor(),
            scope or global_scope(), trainer_id=self.worker_index())
        return self._ps_trainer

    def stop_worker(self):
        """In sync mode with several trainers, wait for all of them
        first; then worker 0 shuts the pservers down."""
        t = getattr(self, "_ps_trainer", None)
        if t is None:
            return
        if t.art.sync_mode and t.art.trainers > 1:
            t.client.barrier()
        if self.worker_index() == 0:
            t.client.shutdown_servers()
        t.client.close()
        self._ps_trainer = None

    def save_persistables(self, executor, dirname, main_program=None):
        from .. import io

        if self.is_first_worker():
            io.save_persistables(executor, dirname, main_program)

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from .. import io

        if self.is_first_worker():
            io.save_inference_model(dirname, feeded_var_names, target_vars,
                                    executor, main_program)


class DistributedOptimizer:
    """Reference collective/__init__.py:378 CollectiveOptimizer."""

    def __init__(self, fleet_obj: _Fleet, optimizer,
                 strategy: DistributedStrategy):
        self._fleet = fleet_obj
        self._optimizer = optimizer
        self._strategy = strategy

    def backward(self, loss, **kw):
        return self._optimizer.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        inner = self._optimizer
        if self._strategy.forward_recompute:
            from ..optimizer import RecomputeOptimizer

            inner = RecomputeOptimizer(inner)
            inner._set_checkpoints(self._strategy.recompute_checkpoints)
        if self._strategy.use_amp:
            from ..contrib.mixed_precision import decorate

            inner = decorate(inner,
                             init_loss_scaling=self._strategy.amp_loss_scale)
        opt_ops, params_grads = inner.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        program = loss.block.program
        if self._strategy.sharding:
            from .sharding import shard_optimizer_states

            n = get_world_size()
            n_sharded, _ = shard_optimizer_states(program, n)
            if n_sharded == 0:
                _log.warning(
                    "DistributedStrategy.sharding=True sharded NOTHING: no "
                    "optimizer accumulator dim is divisible by the %d "
                    "workers — training stays fully replicated", n)
        self._fleet._origin_program = program
        compiled = CompiledProgram(program, self._strategy.build_strategy)
        compiled.with_data_parallel(loss_name=loss.name)
        self._fleet._compiled_program = compiled
        self._fleet._strategy = self._strategy
        return opt_ops, params_grads


fleet = _Fleet()


class PSDistributedOptimizer:
    """The PS-mode fleet optimizer (reference
    incubate/fleet/parameter_server/distribute_transpiler/__init__.py:41,
    which wraps DistributeTranspiler)."""

    def __init__(self, fleet_obj: _Fleet, optimizer,
                 strategy: DistributedStrategy):
        self._fleet = fleet_obj
        self._optimizer = optimizer
        self._strategy = strategy

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..transpiler import (DistributeTranspiler,
                                  DistributeTranspilerConfig)

        opt_ops, params_grads = self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        rm = self._fleet._role_maker
        cfg = DistributeTranspilerConfig()
        cfg.mode = "pserver"
        cfg.sync_mode = self._strategy.mode != "async"
        t = DistributeTranspiler(cfg)
        t.transpile(rm.worker_index() if rm.is_worker() else 0,
                    program=loss.block.program,
                    pservers=",".join(rm.get_pserver_endpoints()),
                    trainers=max(rm.worker_num(), 1),
                    sync_mode=cfg.sync_mode,
                    startup_program=startup_program)
        self._fleet._ps_artifacts = t._ps_artifacts
        self._fleet._origin_program = loss.block.program
        return opt_ops, params_grads
