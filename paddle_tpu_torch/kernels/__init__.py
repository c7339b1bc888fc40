"""Kernels of the port: hand-written CUDA for Hopper, each beside its
plain PyTorch version (the CPU path and the numerics oracle).

| kernel | CUDA source | replaces (TPU Pallas) |
|---|---|---|
| ``layer_norm`` | ``csrc/layer_norm.cu`` | ``kernels/layer_norm.py`` ``_fwd_impl`` |
| ``ragged_paged_attention`` | ``csrc/ragged_paged_attention.cu`` | ``kernels/ragged_paged_attention.py`` ``_ragged_pallas`` |

``kv_cache_write`` is plain ``index_put_`` (an XLA scatter in JAX).
The library is built by ``_build`` at the first launch on a CUDA
tensor; importing this package builds nothing.
"""

from .layer_norm import layer_norm, layer_norm_plain
from .paged_attention import kv_cache_write, kv_write_targets
from .ragged_paged_attention import (ragged_paged_attention,
                                     ragged_paged_attention_plain)

__all__ = ["layer_norm", "layer_norm_plain", "ragged_paged_attention",
           "ragged_paged_attention_plain", "kv_cache_write",
           "kv_write_targets", "KERNELS", "reset_launch_counts",
           "launch_counts"]

# the launch-counted wrappers, by kernel name
KERNELS = {"layer_norm": layer_norm,
           "ragged_paged_attention": ragged_paged_attention}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
