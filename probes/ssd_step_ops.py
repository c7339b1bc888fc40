"""Where an SSD300 training step's device time goes, op by op: one step
of ``models.ssd.build_ssd(300, 21 classes, max_gt 8)`` under fused Adam
at batch 32 (chip_smoke.py phase l1 (b)'s configuration), after two
warm-up steps, traced by ``torch.profiler`` with input shapes. Prints
the 15 costliest (aten op, input shapes) rows by device time, the total
device time and kernel count, then the card's name and power limit:

    python3 probes/ssd_step_ops.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.ssd import build_ssd, synthetic_det_batch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fluid.set_flags({"optimizer_fuse": "on"})
    main_p, startup, _, fetches = build_ssd(
        image_size=300, num_classes=21, max_gt=8,
        optimizer=fluid.optimizer.AdamOptimizer(2e-3))
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    batch = synthetic_det_batch(np.random.RandomState(0), 32, image_size=300,
                                num_classes=21, max_gt=8)
    for _ in range(2):
        exe.run(main_p, feed=batch, fetch_list=[fetches["loss"]], scope=scope)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t = time.perf_counter()
        exe.run(main_p, feed=batch, fetch_list=[fetches["loss"]], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0)) / 1e3
        if dev > 0:
            rows.append({"op": e.key, "shapes": str(e.input_shapes)[:160],
                         "calls": e.count, "device_ms": round(dev, 3)})
    rows.sort(key=lambda r: -r["device_ms"])
    total = sum(r["device_ms"] for r in rows)
    print(json.dumps({"wall_ms_profiled": round(wall * 1e3, 3),
                      "device_ms_self_total": round(total, 3),
                      "top": rows[:15]}, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
