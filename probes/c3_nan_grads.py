"""What JAX's gradients at a NaN input would cost ResNet-50's step on
the card, for the two ops whose repair takes more launches than the op
takes today (ROADMAP §C3):

  relu      torch's backward is one kernel (``threshold_backward``:
            g where out > 0, and g at a NaN); JAX's gives 0 at a NaN
            (``where(x > 0, g, 0)``), two kernels in eager PyTorch (the
            comparison, then the select);
  max pool  ``F.max_pool2d`` routes a window's gradient to its NaN;
            JAX's to the window's largest number: the indices taken
            over ``nan_to_num(x, nan=-inf)``, the output gathered from
            x (two kernels more a call).

Times (CUDA events, median of 21 runs of 10 calls) the backward of every
relu of ``build_resnet50(1000, 224)`` at batch 64 (49 shapes, from the
program) and the stem's max pool (forward and backward) both ways, on
the same inputs, and prints the difference a step. Needs the card:

    python3 probes/c3_nan_grads.py

Prints one JSON object, then the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 64


def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def relu_shapes():
    """The input shape of every relu of ResNet-50 (NCHW), batch 64."""
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.resnet import build_resnet50

    with fluid.unique_name.guard():
        main, _, _, _ = build_resnet50(1000, 224, None)
    block = main.global_block()
    out = []
    for op in block.ops:
        if op.type == "relu":
            shape = block._find_var_recursive(op.input("X")[0]).shape
            out.append((BATCH,) + tuple(int(d) for d in shape[1:]))
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs = smoke()
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = relu_shapes()
    pairs = [(torch.relu(torch.randn(s, device="cuda", generator=gen)),
              torch.randn(s, device="cuda", generator=gen)) for s in shapes]

    def relu_torch():
        for out, g in pairs:
            torch.ops.aten.threshold_backward(g, out, 0)

    def relu_jax():
        for out, g in pairs:
            torch.where(out > 0, g, 0.0)

    x = torch.randn((BATCH, 64, 112, 112), device="cuda", generator=gen)
    gy = torch.randn((BATCH, 64, 56, 56), device="cuda", generator=gen)

    def pool_torch():
        y, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
        torch.ops.aten.max_pool2d_with_indices_backward(
            gy, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)

    def pool_jax():
        _, idx = F.max_pool2d(torch.nan_to_num(x, nan=-float("inf")), 3, 2, 1,
                              return_indices=True)
        torch.gather(x.flatten(2), 2, idx.flatten(2))
        torch.ops.aten.max_pool2d_with_indices_backward(
            gy, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)

    row = {"relu_calls_a_step": len(shapes),
           "relu_elements_a_step": sum(int(torch.tensor(s).prod())
                                       for s in shapes)}
    for name, fn in (("relu_bwd_torch_ms", relu_torch),
                     ("relu_bwd_jax_ms", relu_jax),
                     ("stem_pool_torch_ms", pool_torch),
                     ("stem_pool_jax_ms", pool_jax)):
        row[name] = cs.device_ms(torch, fn)
    row["relu_extra_ms_a_step"] = row["relu_bwd_jax_ms"] - row[
        "relu_bwd_torch_ms"]
    row["pool_extra_ms_a_step"] = row["stem_pool_jax_ms"] - row[
        "stem_pool_torch_ms"]
    row["extra_launches_a_step"] = {"relu": len(shapes), "pool": 2}
    print(json.dumps(row), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
