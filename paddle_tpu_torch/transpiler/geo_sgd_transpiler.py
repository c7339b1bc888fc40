"""GeoSgdTranspiler, the port's counterpart of
``paddle_tpu/transpiler/geo_sgd_transpiler.py`` (reference
transpiler/geo_sgd_transpiler.py): the trainers run the whole Program,
their optimizer included, and every K steps push their parameters'
change since the last sync to the pservers, which add it with SGD at
lr 1, and pull the merged result (``ps.Communicator`` in "geo" mode)."""

from __future__ import annotations

from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)


class GeoSgdTranspiler(DistributeTranspiler):
    def __init__(self, config=None):
        config = config or DistributeTranspilerConfig()
        config.geo_sgd_mode = True
        config.sync_mode = False
        super().__init__(config)

    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync_mode=False, startup_program=None,
                  current_endpoint="127.0.0.1:6174"):
        super().transpile(trainer_id, program, pservers, trainers, False,
                          startup_program, current_endpoint)
        if self._mode == "pserver":
            self._ps_artifacts.trainer_program = self._origin_program
            for k in self._ps_artifacts.optimizer_specs:
                self._ps_artifacts.optimizer_specs[k] = {"type": "sgd",
                                                         "lr": 1.0}

    def get_communicator(self, scope, need_push_nums=100):
        from ..ps.communicator import Communicator

        return Communicator(self._ps_artifacts, scope, mode="geo",
                            geo_need_push_nums=need_push_nums)
