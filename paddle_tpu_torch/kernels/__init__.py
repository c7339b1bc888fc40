"""Kernels of the port: hand-written CUDA for Hopper, each beside its
plain PyTorch version (the CPU path and the numerics oracle).

| # | kernel | CUDA source | replaces (TPU Pallas) |
|---|---|---|---|
| K1 | ``layer_norm`` / ``layer_norm_fwd`` | ``csrc/layer_norm.cu`` | ``kernels/layer_norm.py`` ``_fwd_impl`` |
| K2 | ``ragged_paged_attention`` | ``csrc/ragged_paged_attention.cu`` | ``kernels/ragged_paged_attention.py`` ``_ragged_pallas`` |
| K3 | ``layer_norm_bwd`` | ``csrc/layer_norm.cu`` | ``kernels/layer_norm.py`` ``_vjp_bwd`` |
| K4 | ``softmax_xent_fwd`` | ``csrc/softmax_xent.cu`` | ``kernels/softmax_xent.py`` ``_fwd_impl`` |
| K5 | ``softmax_xent_bwd`` | ``csrc/softmax_xent.cu`` | ``kernels/softmax_xent.py`` ``_vjp_bwd`` |
| K6/K7 | ``flash_attention_fwd`` | ``csrc/flash_attention.cu`` | ``kernels/flash_attention.py`` ``_flash_fwd_pallas``, ``_flash_fwd_stream`` |
| K8/K9 | ``flash_attention_bwd`` | ``csrc/flash_attention.cu`` | ``kernels/flash_attention.py`` ``_flash_bwd_pallas``, ``_flash_bwd_stream`` |
| K10 | ``fused_adam_update`` | ``csrc/fused_optim.cu`` | ``kernels/fused_optim.py`` ``_run_fused`` + ``_adam_kernel`` |
| K2q | ``ragged_paged_attention_q`` | ``csrc/ragged_paged_attention.cu`` | ``kernels/ragged_paged_attention.py`` ``_ragged_pallas`` (quantized) |
| K11 | ``quantized_matmul`` (tensor cores; ``quantized_matmul_fma`` for an int8_block block that is not a multiple of 16) | ``csrc/quant_matmul.cu`` | ``kernels/quant_matmul.py`` ``_quant_matmul_pallas`` |
| K12 | ``batched_lora_add_`` | ``csrc/lora.cu`` | ``kernels/lora.py`` ``_lora_delta_pallas`` |
| K10m | ``fused_momentum_update`` | ``csrc/fused_optim.cu`` | ``kernels/fused_optim.py`` ``_run_fused`` + ``_momentum_kernel`` |
| K13 | ``paged_attention`` | ``csrc/paged_attention.cu`` | ``kernels/paged_attention.py`` ``paged_attention`` (JAX's library Pallas kernel) |

Every function of the JAX package that reaches ``pl.pallas_call`` has
its kernel here.

``kv_cache_write`` and ``quantized_kv_cache_write`` are plain
``index_put_`` (XLA scatters in JAX); ``quant.py`` (blockwise int8
quantize) is plain torch, as in JAX.
The library is built by ``_build`` at the first launch on a CUDA
tensor; importing this package builds nothing.
"""

from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain, flash_attention_fwd,
                              flash_attention_fwd_plain, flash_attention_layer,
                              flash_attention_plain)
from .fused_optim import (fused_adam_update, fused_adam_update_plain,
                          fused_momentum_update, fused_momentum_update_plain)
from .layer_norm import (fused_layer_norm, layer_norm, layer_norm_bwd,
                         layer_norm_bwd_plain, layer_norm_fwd,
                         layer_norm_fwd_plain, layer_norm_plain)
from .lora import (batched_lora_add_, batched_lora_add_plain_,
                   batched_lora_delta, batched_lora_delta_plain,
                   batched_lora_matmul)
from .paged_attention import (kv_cache_write, kv_write_targets,
                              paged_attention, paged_attention_plain)
from .quant_matmul import (quantize_weight, quantized_matmul,
                           quantized_matmul_fma, quantized_matmul_plain)
from .ragged_paged_attention import (quantized_kv_cache_write,
                                     ragged_paged_attention,
                                     ragged_paged_attention_plain,
                                     ragged_paged_attention_q)
from .softmax_xent import (fused_softmax_xent, softmax_xent_bwd,
                           softmax_xent_bwd_plain, softmax_xent_fwd,
                           softmax_xent_fwd_plain)

__all__ = ["layer_norm", "layer_norm_plain", "layer_norm_fwd",
           "layer_norm_fwd_plain", "layer_norm_bwd", "layer_norm_bwd_plain",
           "fused_layer_norm", "ragged_paged_attention",
           "ragged_paged_attention_plain", "softmax_xent_fwd",
           "softmax_xent_fwd_plain", "softmax_xent_bwd",
           "softmax_xent_bwd_plain", "fused_softmax_xent",
           "fused_adam_update", "fused_adam_update_plain", "flash_attention",
           "flash_attention_plain", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_layer",
           "kv_cache_write",
           "kv_write_targets", "ragged_paged_attention_q",
           "quantized_kv_cache_write", "quantize_weight", "quantized_matmul",
           "quantized_matmul_fma", "quantized_matmul_plain", "batched_lora_add_",
           "batched_lora_add_plain_", "batched_lora_delta",
           "batched_lora_delta_plain", "batched_lora_matmul",
           "fused_momentum_update", "fused_momentum_update_plain",
           "paged_attention", "paged_attention_plain", "KERNELS",
           "GRAPH_NODES", "reset_launch_counts", "launch_counts"]

# the launch-counted wrappers, by kernel name (layer_norm_fwd counts in
# layer_norm's counter: it is the same kernel, K1, with its stats out)
KERNELS = {"layer_norm": layer_norm,
           "ragged_paged_attention": ragged_paged_attention,
           "layer_norm_bwd": layer_norm_bwd,
           "softmax_xent_fwd": softmax_xent_fwd,
           "softmax_xent_bwd": softmax_xent_bwd,
           "fused_adam_update": fused_adam_update,
           "flash_attention_fwd": flash_attention_fwd,
           "flash_attention_bwd": flash_attention_bwd,
           "ragged_paged_attention_q": ragged_paged_attention_q,
           "quantized_matmul": quantized_matmul,
           "quantized_matmul_fma": quantized_matmul_fma,
           "batched_lora_add_": batched_lora_add_,
           "fused_momentum_update": fused_momentum_update,
           "paged_attention": paged_attention}

# the kernel each wrapper of the engine's steps launches exactly once a
# call, as a CUDA graph's kernel node names it (demangled): a capture's
# launches are counted from these nodes (``runtime/graphs.py``). The
# wrappers of the training steps, which no graph captures yet (ROADMAP
# A12b), have none: a capture that counts one of them raises.
GRAPH_NODES = {
    "layer_norm": r"\blayer_norm_fwd(_looped)?_kernel<",
    "ragged_paged_attention":
        r"\bragged_split_kernel<[^,<>]+, (float|__nv_bfloat16),",
    "ragged_paged_attention_q": r"\bragged_split_kernel<[^,<>]+, signed char,",
    "quantized_matmul": r"\bquant_matmul_mma_kernel<",
    "quantized_matmul_fma": r"\bquant_matmul_fma_kernel\(",
    "batched_lora_add_": r"\blora_expand_kernel\(",
    "paged_attention": r"\bpaged_attention_kernel<",
}


def reset_launch_counts() -> None:
    """Zero every wrapper's count (and the flash backward's count of
    each of its three kernels)."""
    for fn in KERNELS.values():
        fn.launches = 0
    for name in flash_attention_bwd.kernel_launches:
        flash_attention_bwd.kernel_launches[name] = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
