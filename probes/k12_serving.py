"""Phase 7b's serving step on the card, with a control in the same
process, to compare two checkouts' K12 in turns.

Builds gpt3_1p3b at full width and depth with int8 weights
(``chip_smoke.quantized_predictor``, seeded) and serves phase 7's 16
requests (32 new tokens each) through two engines over int8 pages, one
after the other:

  control   no adapter store: K12 is not on the path;
  lora      phase 7b's engine: four adapters in rank buckets 8 and 16,
            12 of the 16 requests on one (4 L + 1 K12 calls a step).

Each run prints its mean engine step (the engine's own
``decode_step_ms``), tokens/s and steps. The lora run also prints the
host µs a step spent inside ``batched_lora_add_`` (a timing shim around
the engine model's reference to it: the calls and their launch count are
unchanged). With ``--profile`` both runs are traced (``torch.profiler``,
as ``chip_smoke.py --profile``): device busy ms, idle share and K12's
device ms a step.

``--root DIR`` imports ``paddle_tpu_torch`` from another checkout (an
earlier commit unpacked with ``git archive``); run this once a process,
checkouts in turns (parent, change, change, parent, ...). Needs the card
and ``nvcc``:

    python3 probes/k12_serving.py [--root DIR] [--profile]

Prints one JSON object a run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_NEW = 32


def smoke():
    """This checkout's chip_smoke.py, whatever --root puts first."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class HostTimer:
    """Wall seconds and calls spent inside ``fn``."""

    def __init__(self, fn):
        self.fn, self.s, self.calls = fn, 0.0, 0

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kw)
        finally:
            self.s += time.perf_counter() - t0
            self.calls += 1


def serve_once(torch, cs, eng, prompts, adapters, profile, tmp, name):
    from paddle_tpu_torch import kernels as K

    K.reset_launch_counts()
    prof = cs.start_profile(torch) if profile else None
    streams, wall = cs.run_clients(eng, prompts, MAX_NEW, adapters)
    if prof is not None:
        prof.__exit__(None, None, None)
    st = eng.stats()
    cs.check_streams(streams, MAX_NEW)
    steps = st["ragged_steps_total"]
    row = {"run": name, "step_ms_mean": st["decode_step_ms"]["mean"],
           "steps": steps, "wall_s": wall,
           "tokens_per_s": sum(len(s.tokens) for s in streams) / wall,
           "k12_calls_a_step":
               K.launch_counts()["batched_lora_add_"] / steps}
    if prof is not None:
        br = cs.trace_breakdown(prof, tmp, name, wall, steps)
        row.update(device_busy_ms=br["device_busy_ms"],
                   device_idle_share=br["device_idle_share"],
                   k12_device_ms_a_step=br["kernel_ms_a_step_by_group"].get(
                       "batched_lora_add_ (K12)", 0.0))
    return row, streams


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose paddle_tpu_torch is served")
    ap.add_argument("--profile", action="store_true",
                    help="trace both runs with torch.profiler")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cs = smoke()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from paddle_tpu_torch.adapters import AdapterStore
    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.generation import model as gen_model
    from paddle_tpu_torch.models.gpt import GPTConfig

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig.gpt3_1p3b()
    _, prompts = cs.serving_prompts(np, args.seed, cfg.vocab_size)
    pred, _ = cs.quantized_predictor(torch, args.seed, cfg, "int8")
    tmp = tempfile.TemporaryDirectory()

    with GenerationEngine(pred, cfg, kv_dtype="int8", warmup=True) as eng:
        row, _ = serve_once(torch, cs, eng, prompts, None, args.profile,
                            tmp.name, "control")
    print(json.dumps({"root": args.root, **row}), flush=True)

    store = AdapterStore.for_model(pred.lm, rank_buckets=(8, 16),
                                   slots_per_bucket=4)
    eng = GenerationEngine(pred, cfg, kv_dtype="int8", adapter_store=store,
                           warmup=True)
    for aid, fac, alpha in cs.adapter_factors(torch, store, args.seed):
        store.upload(aid, fac, alpha=alpha)
    # as phase 7b: requests 0, 4, 8, 12 base-only, the others ad0..ad3
    adapters = [None] * 16
    for k, i in enumerate(i for i in range(16) if i % 4):
        adapters[i] = f"ad{k % 4}"
    timer = HostTimer(gen_model.batched_lora_add_)
    gen_model.batched_lora_add_ = timer
    try:
        row, _ = serve_once(torch, cs, eng, prompts, adapters, args.profile,
                            tmp.name, "lora")
    finally:
        gen_model.batched_lora_add_ = timer.fn
        eng.close()
    row["k12_host_us_a_step"] = timer.s * 1e6 / row["steps"]
    row["k12_host_us_a_call"] = timer.s * 1e6 / max(timer.calls, 1)
    print(json.dumps({"root": args.root, **row}), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
