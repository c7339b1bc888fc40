"""Phases 3 and 7b's serving runs on the card, with a store-less control
in the same process, to compare two checkouts in turns (the engine's
steps replayed as CUDA graphs against eager steps).

Builds gpt3_1p3b at full width and depth with phase 3's seeded weights
(``chip_smoke.gpt3_predictor``) and serves phase 3's 16 requests (32
new tokens each) three times, one engine after the other:

  serve     phase 3: float32 weights and pages, the ragged engine;
  control   int8 weights, int8 pages, no adapter store;
  lora      phase 7b: int8 weights, int8 pages, four adapters in rank
            buckets 8 and 16, 12 of the 16 requests on one.

Each run prints its mean engine step (the engine's own
``decode_step_ms``), tokens/s, steps and the engine's graph replays
(absent in a checkout without them). With ``--profile`` every run is
traced (``torch.profiler``, as ``chip_smoke.py --profile``): device busy
ms and idle share.

``--root DIR`` imports ``paddle_tpu_torch`` from another checkout (an
earlier commit unpacked with ``git archive``); run this once a process,
checkouts in turns (parent, change, change, parent, ...). Needs the card
and ``nvcc``:

    python3 probes/graph_serving.py [--root DIR] [--profile]

Prints one JSON object a run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_NEW = 32


def smoke():
    """This checkout's chip_smoke.py, whatever --root puts first."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serve_once(torch, cs, eng, prompts, adapters, profile, tmp, name):
    prof = cs.start_profile(torch) if profile else None
    streams, wall = cs.run_clients(eng, prompts, MAX_NEW, adapters)
    if prof is not None:
        prof.__exit__(None, None, None)
    st = eng.stats()
    eng.close()
    cs.check_streams(streams, MAX_NEW)
    steps = st["ragged_steps_total"]
    row = {"run": name, "step_ms_mean": st["decode_step_ms"]["mean"],
           "steps": steps, "wall_s": wall,
           "tokens_per_s": sum(len(s.tokens) for s in streams) / wall,
           "graph_replays": st.get("graph_replays")}
    if prof is not None:
        br = cs.trace_breakdown(prof, tmp, name, wall, steps)
        row.update(device_busy_ms=br["device_busy_ms"],
                   device_idle_share=br["device_idle_share"],
                   kernels=br["kernels"])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose paddle_tpu_torch is served")
    ap.add_argument("--profile", action="store_true",
                    help="trace every run with torch.profiler")
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
    from paddle_tpu_torch.models.gpt import GPTConfig

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig.gpt3_1p3b()
    _, prompts = cs.serving_prompts(np, args.seed, cfg.vocab_size)
    tmp = tempfile.TemporaryDirectory()

    def report(row):
        print(json.dumps({"root": args.root, **row}), flush=True)

    _, pred = cs.gpt3_predictor(torch, args.seed)
    report(serve_once(torch, cs, GenerationEngine(pred, cfg, warmup=True),
                      prompts, None, args.profile, tmp.name, "serve"))
    del pred
    torch.cuda.empty_cache()

    pred, _ = cs.quantized_predictor(torch, args.seed, cfg, "int8")
    report(serve_once(torch, cs, GenerationEngine(pred, cfg, kv_dtype="int8",
                                                  warmup=True),
                      prompts, None, args.profile, tmp.name, "control"))
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
    report(serve_once(torch, cs, eng, prompts, adapters, args.profile,
                      tmp.name, "lora"))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
