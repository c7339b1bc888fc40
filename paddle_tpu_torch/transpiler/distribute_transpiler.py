"""DistributeTranspiler, the port's counterpart of
``paddle_tpu/transpiler/distribute_transpiler.py`` (reference
transpiler/distribute_transpiler.py:254; config :141, transpile :540,
the nccl2 path :598-640, the pserver programs :640ff with
``slice_var_up``).

Modes:
  * "pserver" (the default): ``ps.build_ps_programs`` makes the trainer
    program (the optimizer ops stripped: forward and backward on the
    card) and the pservers' shards and update rules; a trainer runs it
    through ``ps.PSTrainer``, a pserver through ``ps.ParameterServer``
    (``launch_pservers`` on threads, ``fleet.run_server``,
    ``distributed.launch_ps``).
  * "nccl2" / "collective" (or ``collective_mode``): the port's
    collective path, ``transpiler.GradAllReduce`` over ``trainers``
    ranks (an endpoint list in nccl2 mode, or a count); the program then
    runs in a world (``distributed.launch``).
"""

from __future__ import annotations

from typing import List, Optional

from ..core import framework


class DistributeTranspilerConfig:
    """Reference distribute_transpiler.py:141."""

    slice_var_up = True
    split_method = None
    min_block_size = 8192
    enable_dc_asgd = False
    mode = "pserver"
    print_log = False
    wait_port = True
    runtime_split_send_recv = False
    sync_mode = True
    geo_sgd_mode = False
    geo_sgd_need_push_nums = 100
    collective_mode: Optional[str] = None
    nccl_comm_num = 1
    use_hierarchical_allreduce = False
    hierarchical_allreduce_inter_nranks = 0


class DistributeTranspiler:
    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._mode = None
        self._trainer_id = 0
        self._trainers = 1
        self._origin_program = None
        self._pserver_endpoints: List[str] = []
        self._trainer_endpoints: List[str] = []
        self._ps_artifacts = None

    def transpile(self, trainer_id: int, program=None,
                  pservers: str = "127.0.0.1:6174", trainers=1,
                  sync_mode: bool = True, startup_program=None,
                  current_endpoint: str = "127.0.0.1:6174"):
        program = program or framework.default_main_program()
        startup_program = startup_program or \
            framework.default_startup_program()
        self._origin_program = program
        self._trainer_id = trainer_id
        self._pserver_endpoints = [e for e in str(pservers).split(",") if e]
        if isinstance(trainers, str):
            # nccl2 mode passes the trainers' endpoints (reference :598)
            self._trainer_endpoints = [e for e in trainers.split(",") if e]
            self._trainers = len(self._trainer_endpoints)
        else:
            self._trainers = int(trainers)
            self._trainer_endpoints = [current_endpoint] * self._trainers
        self._sync_mode = sync_mode
        mode = self.config.mode
        if self.config.collective_mode or mode in ("nccl2", "collective"):
            from .collective import GradAllReduce

            self._mode = "collective"
            GradAllReduce(self.config.nccl_comm_num).transpile(
                startup_program, program, trainer_id,
                self._trainer_endpoints, current_endpoint)
            return
        self._mode = "pserver"
        from ..ps.transpile import build_ps_programs

        self._ps_artifacts = build_ps_programs(
            program, startup_program, self._pserver_endpoints, trainer_id,
            self._trainers, sync_mode, slice_var_up=self.config.slice_var_up)

    # -- reference getters ---------------------------------------------------
    def get_trainer_program(self, wait_port=True):
        if self._mode == "collective":
            return self._origin_program
        return self._ps_artifacts.trainer_program

    def get_pserver_program(self, endpoint: str):
        if self._mode != "pserver":
            raise ValueError("no pserver program in collective mode")
        return self._ps_artifacts.pserver_programs[endpoint]

    def get_pserver_programs(self, endpoint: str):
        return (self.get_pserver_program(endpoint),
                self.get_startup_program(endpoint))

    def get_startup_program(self, endpoint: str, pserver_program=None,
                            startup_program=None):
        return self._ps_artifacts.pserver_startups[endpoint]
