"""Process-level distributed environment: the port's counterpart of
``paddle_tpu/parallel/env.py``.

The launcher (``distributed/launch.py``) exports the reference's
contract to every worker: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT`` and ``PADDLE_RESTART_COUNT``, plus
``PADDLE_DIST_BACKEND`` for its ``--backend``. ``init_parallel_env``
maps it onto ``torch.distributed.init_process_group`` over a
``TCPStore`` at rank 0's endpoint (where the JAX package calls
``jax.distributed.initialize``). One process drives one device.

Backends: ``nccl`` when CUDA is present, ``gloo`` on the CPU, or the
one the caller (or ``--backend``) names. Two ranks can share one GPU
only over ``gloo``: NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

__all__ = ["ParallelEnv", "free_port", "init_parallel_env", "get_rank",
           "get_world_size", "default_store", "world_backend",
           "shutdown_parallel_env"]


class ParallelEnv:
    """Reference: fluid/dygraph/parallel.py ParallelEnv."""

    def __init__(self):
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = [e for e in eps.split(",") if e]

    @property
    def rank(self):
        return self._rank

    # reference aliases
    local_rank = rank

    @property
    def nranks(self):
        return self._world_size

    @property
    def world_size(self):
        return self._world_size

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    @property
    def dev_id(self):
        return int(os.environ.get("FLAGS_selected_gpus", "0").split(",")[0])

    @property
    def restart_count(self):
        """How many times the elastic launcher has restarted this world
        (``PADDLE_RESTART_COUNT``; 0 on the first incarnation)."""
        return int(os.environ.get("PADDLE_RESTART_COUNT", "0"))


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind to 0, read, release): the one
    copy of the racy assign-then-release pattern."""
    import socket

    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


_STORE = None


def default_store():
    """The ``TCPStore`` the world was formed over (None without a
    world): the coordinator's barriers and host all-reduce use it."""
    return _STORE


def world_backend() -> Optional[str]:
    """The world's backend name ("nccl", "gloo"), None without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return None


def init_parallel_env(coordinator_address: Optional[str] = None,
                      backend: Optional[str] = None,
                      timeout_s: float = 300.0,
                      world_size: Optional[int] = None,
                      rank: Optional[int] = None) -> ParallelEnv:
    """Form the world from the ``PADDLE_*`` contract: a ``TCPStore`` at
    rank 0's endpoint (``coordinator_address`` or the first trainer
    endpoint) and ``init_process_group`` over it. A world of one is
    formed only when a backend is named (``backend``, or the launcher's
    ``--backend``: an NCCL world of one on the card); otherwise one
    process stays without a world, as the JAX package's does.
    Idempotent."""
    global _STORE
    env = ParallelEnv()
    if world_size is not None:
        env._world_size = int(world_size)
    if rank is not None:
        env._rank = int(rank)
    dist = torch.distributed
    if dist.is_initialized():
        return env
    backend = backend or os.environ.get("PADDLE_DIST_BACKEND")
    if env.world_size <= 1 and backend is None:
        return env
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    addr = coordinator_address
    if addr is None and env.trainer_endpoints:
        addr = env.trainer_endpoints[0]
    if addr is None:
        addr = f"127.0.0.1:{free_port()}"
    host, port = addr.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=float(timeout_s))
    _STORE = dist.TCPStore(host, int(port), env.world_size,
                           is_master=env.rank == 0, timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(env.dev_id % torch.cuda.device_count())
    dist.init_process_group(backend, store=_STORE, rank=env.rank,
                            world_size=env.world_size, timeout=timeout)
    return env


def shutdown_parallel_env() -> None:
    """Destroy the world this process formed (its process groups, its
    meshes and its store), so that the process can run without one, or
    form another."""
    global _STORE
    from .mesh import clear_meshes

    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    clear_meshes()
    _STORE = None


def get_rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return ParallelEnv().rank


def get_world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return ParallelEnv().world_size
