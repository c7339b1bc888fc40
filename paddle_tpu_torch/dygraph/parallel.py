"""Dygraph ``DataParallel``: the port's counterpart of
``paddle_tpu/dygraph/parallel.py`` (reference fluid/dygraph/parallel.py:84).

``prepare_context`` forms the world through the port's
``parallel.env.init_parallel_env`` (a ``torch.distributed`` group, one
process a device, ``nccl`` on the card and ``gloo`` on the CPU or for
ranks sharing a card). ``DataParallel`` wraps a Layer: ``scale_loss``
multiplies the loss by 1 / nranks and ``apply_collective_grads`` sums
each parameter's gradient over the world (``parallel.comm.all_reduce``,
in place, in parameter order), so that the summed gradients of the
scaled losses are the mean gradient of the global batch.
"""

from __future__ import annotations

from ..parallel import comm
from ..parallel.env import ParallelEnv
from .layers import Layer

__all__ = ["DataParallel", "prepare_context", "ParallelEnv"]


def prepare_context(strategy=None):
    from ..parallel.env import init_parallel_env

    init_parallel_env()
    return ParallelEnv()


class DataParallel(Layer):
    def __init__(self, layers: Layer, strategy=None):
        super().__init__()
        self._layers = layers
        self._env = ParallelEnv()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @property
    def nranks(self):
        return max(self._env.world_size, 1)

    def scale_loss(self, loss):
        if self.nranks <= 1:
            return loss
        return loss * (1.0 / self.nranks)

    def apply_collective_grads(self):
        """Sum every parameter's gradient over the world, in place."""
        if self.nranks <= 1:
            return
        from ..parallel.mesh import world_group

        group = world_group()
        for p in self._layers.parameters():
            g = p.grad
            if g is not None:
                comm.all_reduce(g, "sum", group=group)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_dict(self, *a, **kw):
        return self._layers.set_dict(*a, **kw)

    load_dict = set_dict
