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

The parameter-server mode (``PSDistributedOptimizer``, ``init_server``,
``run_server``, ``init_worker``, ``stop_worker``) is ROADMAP A11
(``ps/``) and raises, naming it.
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
           "DistributedStrategy", "DistributedOptimizer", "fleet"]

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


def _refuse_ps(what: str):
    raise NotImplementedError(
        f"fleet {what}: the parameter-server mode is not ported to "
        "paddle_tpu_torch yet (ROADMAP A11, ps/)")


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
        if self._role_maker.worker_num() > 1:
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
            _refuse_ps("distributed_optimizer(mode='pserver')")
        return DistributedOptimizer(self, optimizer, strategy)

    def init_server(self, model_dir: Optional[str] = None):
        _refuse_ps("init_server")

    def run_server(self):
        _refuse_ps("run_server")

    def init_worker(self):
        _refuse_ps("init_worker")

    def stop_worker(self):
        _refuse_ps("stop_worker")

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
