"""Distributed training over ``torch.distributed``: the world
(``env``), meshes and rings (``mesh``), the collective layer (``comm``),
the gradient-collective planner (``collectives``), ZeRO
(``sharding``), the fleet API (``fleet``), ring and Ulysses attention
(``ring_attention``, ``ulysses``) and the pipeline schedules
(``pipeline``). The port's counterpart of ``paddle_tpu/parallel``.
"""

from .env import ParallelEnv, get_rank, get_world_size, init_parallel_env
from .mesh import MeshContext, get_mesh, mesh_guard, ring_registry
from . import collectives, comm, fleet, sharding  # noqa: E402
