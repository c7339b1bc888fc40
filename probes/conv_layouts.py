"""The device time of ResNet-50's 53 convolutions at the bench's batch,
forward and both gradients, by data type, layout and cuDNN's algorithm
choice: what phase 9 (bfloat16 AMP, NCHW) pays for its convolutions
beside phase 8 (float32, TF32 off).

For every ``conv2d`` of ``build_resnet50(1000, 224)`` (shapes from the
program, batch 64) it times one forward and one backward (input and
filter gradients, ``torch.autograd.grad``) of ``F.conv2d`` on the card
(CUDA events, median of 21 runs of 10 calls), summed over the 53, for:

  float32 NCHW           phase 8 (TF32 off)
  bfloat16 NCHW          phase 9
  bfloat16 channels_last the same tensors in NHWC memory order

each with ``torch.backends.cudnn.benchmark`` off (the port's setting)
and on. Needs the card:

    python3 probes/conv_layouts.py

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


def conv_shapes():
    """(input shape, filter shape, stride, padding) of every conv2d of
    ResNet-50, NCHW, batch 64."""
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.resnet import build_resnet50

    with fluid.unique_name.guard():
        main, _, _, _ = build_resnet50(1000, 224, None)
    block = main.global_block()
    out = []
    for op in block.ops:
        if op.type == "conv2d":
            x = block._find_var_recursive(op.input("Input")[0]).shape
            w = block._find_var_recursive(op.input("Filter")[0]).shape
            out.append(((BATCH,) + tuple(int(d) for d in x[1:]),
                        tuple(int(d) for d in w),
                        int(op.attrs["strides"][0]),
                        int(op.attrs["paddings"][0])))
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs = smoke()
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = conv_shapes()
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"convolutions": len(shapes)}
    for dtype, fmt in ((torch.float32, "nchw"), (torch.bfloat16, "nchw"),
                       (torch.bfloat16, "channels_last")):
        mem = (torch.channels_last if fmt == "channels_last"
               else torch.contiguous_format)
        cases = []
        for xs, ws, stride, pad in shapes:
            x = torch.randn(xs, device="cuda", generator=gen).to(dtype)
            w = (0.05 * torch.randn(ws, device="cuda", generator=gen)).to(
                dtype)
            x = x.contiguous(memory_format=mem).requires_grad_()
            w = w.contiguous(memory_format=mem).requires_grad_()
            y = F.conv2d(x, w, stride=stride, padding=pad)
            cases.append((x, w, stride, pad, torch.randn_like(y)))

        def fwd():
            for x, w, stride, pad, _ in cases:
                F.conv2d(x.detach(), w.detach(), stride=stride, padding=pad)

        def fwd_bwd():
            for x, w, stride, pad, gy in cases:
                y = F.conv2d(x, w, stride=stride, padding=pad)
                torch.autograd.grad(y, (x, w), gy)

        name = f"{str(dtype).split('.')[-1]}_{fmt}"
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            key = f"{name}{'_benchmark' if bench else ''}"
            row[f"{key}_fwd_ms"] = cs.device_ms(torch, fwd, reps=5, inner=2)
            row[f"{key}_fwd_bwd_ms"] = cs.device_ms(torch, fwd_bwd, reps=5,
                                                    inner=2)
        del cases
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    print(json.dumps(row), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
