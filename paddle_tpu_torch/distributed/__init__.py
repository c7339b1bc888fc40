"""Multi-process launchers and coordination: the port's counterpart of
``paddle_tpu/distributed`` (reference python/paddle/distributed/).

``launch.py`` is the elastic launcher (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node 2 --backend gloo
train.py``): one process a device, the ``PADDLE_*`` contract,
rank-prefixed logs, heartbeat failure detection, SIGTERM-to-SIGKILL
teardown and world restarts. ``coordinator.py`` is the in-process side:
rendezvous, barriers with timeouts over the world's store, heartbeats
and the ``paddle_dist_*`` gauges. ``launch_ps.py`` is the parameter
server's launcher (``python -m paddle_tpu_torch.distributed.launch_ps
--server_num 2 --worker_num 2 train.py``): pservers and trainers under
the ``PADDLE_*`` PS contract, for ``DistributeTranspiler`` in pserver
mode through ``fleet``.
"""

from ..parallel.env import (ParallelEnv, get_rank, get_world_size,
                            init_parallel_env)
from .coordinator import (RESTART_EXIT_CODE, BarrierTimeout, Coordinator,
                          get_coordinator, initialize, spans_processes)

__all__ = [
    "ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
    "Coordinator", "BarrierTimeout", "RESTART_EXIT_CODE",
    "initialize", "get_coordinator", "spans_processes",
]
