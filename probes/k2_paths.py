"""Which compute path the ragged attention kernel (K2, K2q) should give a
block: a measurement on the card.

A block of ``paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu``
serves one chunk of keys for every query row of a (row, kv head): the
row's num_valid queries times the query heads of the kv head. It takes
the tensor-core path (mma.sync: 3xTF32 for float32, bf16 products for
bfloat16) unless it has at most ``DOT_ROWS`` query rows, when it takes
the dot-product path (a thread a (row, key) score and a (row, column)
P V sum from shared memory, float32 FMA). This probe times the kernel at
``chip_smoke.py``'s main ragged shape (8 lanes x chunk 16, 16 heads x
128, pages of 16, 64 pages a row; prefill chunks of 16 and decode rows)
with ``DOT_ROWS`` at

  0    every block on the tensor cores;
  1    decode rows (one query, group 1) by dot products, prefill chunks
       on the tensor cores;
  16   every block of this shape by dot products;

in turns (0, 1, 16, 16, 1, 0) in one process, for K2 in float32 and
bfloat16 and K2q over int8 pages, timed as ``chip_smoke.py`` times
kernels and held against ``ragged_paged_attention_plain``. Needs the card
and ``nvcc``:

    python3 probes/k2_paths.py

Prints one JSON object a (kernel, dtype, DOT_ROWS) with the mean of its
two timed turns; then, at the shipped ``DOT_ROWS``, the device time of
a call's split pass and merge from ``torch.profiler``; then the card's
name and power limit.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SETTINGS = (0, 1, 16)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import kernels as K

    # the module: the package exports its function under the same name
    rpa = importlib.import_module(
        "paddle_tpu_torch.kernels.ragged_paged_attention")

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = dict(B=cs.LANES, C=cs.CHUNK, H=16, KVH=16, D=128, P=512,
                 ps=cs.PAGE, maxp=64,
                 starts=[0, 100, 767, 400, 16, 250, 700, 0],
                 nvalid=[16, 1, 1, 16, 16, 1, 1, 0])
    cases = {}
    for dt_name in ("float32", "bfloat16"):
        q, kp, vp, st, nv, tb = cs.ragged_case(
            torch, np, getattr(torch, dt_name), gen, seed=0, **shape)
        cases[("ragged_paged_attention", dt_name)] = (
            lambda q=q, kp=kp, vp=vp, st=st, nv=nv, tb=tb:
            K.ragged_paged_attention(q, kp, vp, st, nv, tb),
            K.ragged_paged_attention_plain(q, kp, vp, st, nv, tb))
    q, kf, _, st, nv, tb = cs.ragged_case(torch, np, torch.float32, gen,
                                          seed=0, **shape)
    kp, vp = (torch.randint(-127, 128, kf.shape, device="cuda", generator=gen,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (0.02 * torch.rand(kf.shape[:3], device="cuda", generator=gen)
              for _ in range(2))
    cases[("ragged_paged_attention_q", "float32")] = (
        lambda: K.ragged_paged_attention_q(q, kp, vp, ks, vs, st, nv, tb),
        K.ragged_paged_attention_plain(q, kp, vp, st, nv, tb, None, ks, vs))
    times = {}
    shipped = rpa.DOT_ROWS
    for setting in SETTINGS + SETTINGS[::-1]:
        rpa.DOT_ROWS = setting
        for key, (run, want) in cases.items():
            got = run()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            times.setdefault(key + (setting,), []).append(
                (cs.device_ms(torch, run), err))
    for (name, dt_name, setting), runs in times.items():
        print(json.dumps({"kernel": name, "dtype": dt_name,
                          "dot_rows": setting,
                          "ms": sum(t for t, _ in runs) / len(runs),
                          "ms_turns": [t for t, _ in runs],
                          "max_abs_err": max(e for _, e in runs)}),
              flush=True)
    # the shipped setting's device time by kernel: the split pass and the
    # merge of a call, from the profiler (20 calls each)
    rpa.DOT_ROWS = shipped
    from torch.profiler import ProfilerActivity, profile
    for (name, dt_name), (run, _) in cases.items():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            for part in ("split", "merge"):
                if f"ragged_{part}_kernel" in e.key:
                    split[part + "_ms"] = us / 20 / 1e3
        print(json.dumps({"kernel": name, "dtype": dt_name,
                          "dot_rows": rpa.DOT_ROWS, **split}), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
