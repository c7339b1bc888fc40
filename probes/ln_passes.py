"""K3 (layer norm's backward) on the card: how its time splits between
its two kernels, the main pass (``layer_norm_bwd_kernel``, a block per
run of rows) and the column pass (``layer_norm_bwd_columns_kernel``,
the ordered sum of the partial rows), at the geometry the wrapper ships.

At gpt3_1p3b training's [2048, 2048] and BERT-large's [4096, 1024], in
float32 and bfloat16: each kernel's device time from ``torch.profiler``
over 20 calls, on one input (``warm``: L2 holds x and dy after the
first call) and on rotating copies of the inputs (``rotated``, as
``chip_smoke.py`` phase 2 times K3: no call finds them in L2, as in a
training step). Needs the card and ``nvcc``:

    python3 probes/ln_passes.py

Prints one JSON object a (dtype, shape, inputs), then the card's name
and power limit.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = {"train": (2048, 2048), "bert": (4096, 1024)}
CALLS = 20


def pass_split(torch, run):
    """Device ms a call of K3's main pass and of its column pass."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            run()
        torch.cuda.synchronize()
    split = {"main_pass_ms": 0.0, "column_pass_ms": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if "layer_norm_bwd_columns" in e.key:
            split["column_pass_ms"] += us / CALLS / 1e3
        elif "layer_norm_bwd" in e.key:
            split["main_pass_ms"] += us / CALLS / 1e3
    return split


def main() -> int:
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels.layer_norm import ln_bwd_geometry

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for name, (R, C) in SHAPES.items():
            x, g, b, dy = cs.ln_case(torch, dt, gen, R, C)
            _, mean, rstd = K.layer_norm_fwd_plain(x, g, b, 1e-5)
            cs.compare(torch, K.layer_norm_bwd(x, g, dy, mean, rstd)[0],
                       K.layer_norm_bwd_plain(x, g, dy, mean, rstd)[0],
                       dt_name, f"layer_norm_bwd {dt_name} [{R}x{C}] dx")
            runs = {"warm": lambda: K.layer_norm_bwd(x, g, dy, mean, rstd),
                    "rotated": cs.rotated(torch, K.layer_norm_bwd, x, g, dy,
                                          mean, rstd)}
            for inputs, run in runs.items():
                print(json.dumps({
                    "kernel": "layer_norm_bwd", "dtype": dt_name,
                    "shape_name": name, "shape": [R, C], "inputs": inputs,
                    "geometry": ln_bwd_geometry(R, C, x.element_size())
                    ._asdict(), **pass_split(torch, run)}), flush=True)
            del runs
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
