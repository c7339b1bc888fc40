#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile  # + device time by kernel in phase 3

Phases, in order; any failure exits non-zero without the result line:

0. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 is switched off for matmuls and cuDNN so the
   float32 slice is comparable to the CPU parity tests.
1. build: every ``paddle_tpu_torch/kernels/csrc/*.cu`` with nvcc.
2. kernels against their plain PyTorch versions, float32 and bfloat16,
   at the serving slice's shapes and on edge batches; times (CUDA
   events, median of 21 runs) of the kernel, the plain version and one
   PyTorch library call computing the same function, beside the least
   time the card could take (``bound_ms``).
3. the slice: ``GPTConfig.gpt3_1p3b()`` at full width (seeded random
   weights made on the card) served by the ragged ``GenerationEngine``
   at its default geometry; 16 requests from 4 client threads. Every
   stream must finish with its 32 tokens and no error; the launch
   counters must show 24 ragged attention and 49 layer-norm launches per
   engine step; two requests are checked token by token against the
   ``Predictor`` (teacher forced).

Then one JSON line of per-kernel numbers, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

LANES, CHUNK, PAGE = 8, 16, 16     # the engine's defaults (generation_*)
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}   # (atol, rtol)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # fp32 CUDA cores / bf16 MMA
SLEEP_CYCLES = 20_000_000          # keeps the card busy while launches queue
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


# -- phase 0 -------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- timing --------------------------------------------------------------------


def device_ms(torch, fn, reps=21, inner=10) -> float:
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, between CUDA events. A sleep kernel ahead of
    each run lets the host queue the calls before the card reaches
    them, so a short kernel is timed, not its launch from Python."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, dtype, what):
    atol, rtol = TOL[dtype]
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} elements outside atol {atol} / rtol "
            f"{rtol}; max_abs_err {float(err.max()):.3e}")
    return float(err.max())


def fmt(row, dtype):
    out = f"max_err={row['max_abs_err']:.3e} tol={TOL[dtype]}"
    if "ms" in row:
        out += (f" ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
                f"library_ms={row['library_ms']:.6f} "
                f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']})")
    return out


# -- phase 2: layer norm ---------------------------------------------------------


def check_layer_norm(torch, K, dtype_name, gen):
    import torch.nn.functional as F

    dt = getattr(torch, dtype_name)
    results = {}
    # the slice's [lanes * chunk, hidden], then R not a multiple of any
    # block, a narrow row, and a row past the TPU kernel's MAX_C
    for R, C in ((LANES * CHUNK, 2048), (300, 2048), (37, 96), (5, 8192)):
        x = torch.randn(R, C, device=DEVICE, generator=gen).to(dt)
        g = (1 + 0.1 * torch.randn(C, device=DEVICE, generator=gen)).to(dt)
        b = (0.1 * torch.randn(C, device=DEVICE, generator=gen)).to(dt)
        what = f"layer_norm {dtype_name} [{R}x{C}]"
        err = compare(torch, K.layer_norm(x, g, b, 1e-5),
                      K.layer_norm_plain(x, g, b, 1e-5), dtype_name, what)
        row = {"shape": [R, C], "max_abs_err": err}
        if (R, C) == (LANES * CHUNK, 2048):
            item = x.element_size()
            nbytes = (2 * R * C + 2 * C) * item
            ops = 8 * R * C      # sum, center, square, sum, scale, shift
            bms, by = bound_ms(nbytes, ops, dtype_name)
            row.update(
                ms=device_ms(torch, lambda: K.layer_norm(x, g, b, 1e-5)),
                plain_ms=device_ms(
                    torch, lambda: K.layer_norm_plain(x, g, b, 1e-5)),
                library_ms=device_ms(
                    torch, lambda: F.layer_norm(x, (C,), g, b, 1e-5)),
                bound_ms=bms, bound_by=by)
            results["main"] = row
        log(f"  {what}: {fmt(row, dtype_name)}")
    return results["main"]


# -- phase 2: ragged paged attention -------------------------------------------


def ragged_case(torch, np, dtype, gen, *, B, C, H, KVH, D, P, ps, maxp,
                starts, nvalid, seed):
    """Pools full of random data (stale rows everywhere, the junk page
    included), distinct pages per row, tables zero past each chain."""
    rng = np.random.RandomState(seed)
    kp = torch.randn(KVH, P, ps, D, device=DEVICE, generator=gen).to(dtype)
    vp = torch.randn(KVH, P, ps, D, device=DEVICE, generator=gen).to(dtype)
    q = torch.randn(B, C, H, D, device=DEVICE, generator=gen).to(dtype)
    tables = np.zeros((B, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        n = -(-(starts[b] + nvalid[b]) // ps) if nvalid[b] else 0
        tables[b, :n] = [free.pop() for _ in range(n)]
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(DEVICE)  # noqa: E731
    return q, kp, vp, as_dev(starts), as_dev(nvalid), as_dev(tables)


def ragged_bytes_ops(q, kp, starts, nvalid, ps):
    B, C, H, D = q.shape
    KVH = kp.shape[0]
    item = q.element_size()
    pages = sum(-(-(int(s) + int(n)) // ps) for s, n in zip(starts, nvalid)
                if n)
    nbytes = (pages * ps * D * item * 2 * KVH      # K and V pages needed
              + 2 * B * C * H * D * item            # q in, out
              + 4 * (2 * B + pages))                # starts, counts, tables
    keys = sum(int(s) + j + 1 for s, n in zip(starts, nvalid)
               for j in range(int(n)))
    ops = 4 * keys * H * D                          # q.k and p.v
    return nbytes, ops


def check_ragged(torch, np, K, dtype_name, gen, seed):
    import torch.nn.functional as F

    dt = getattr(torch, dtype_name)
    results = {}
    # the slice's shapes: 8 lanes x chunk 16, 16 heads x 128, 512 pages
    # of 16, 64 pages a sequence; prefill chunks, decode rows deep in
    # long contexts, an idle lane
    main = dict(B=LANES, C=CHUNK, H=16, KVH=16, D=128, P=512, ps=PAGE,
                maxp=64, starts=[0, 100, 767, 400, 16, 250, 700, 0],
                nvalid=[16, 1, 1, 16, 16, 1, 1, 0])
    # the four row kinds of tests/test_ragged.py (prefill from 0, decode
    # over a 6-token prefix, mid-prompt chunk, idle lane) with GQA group
    # 2 and partial last pages holding stale rows
    edge = dict(B=4, C=5, H=8, KVH=4, D=64, P=24, ps=4, maxp=5,
                starts=[0, 6, 9, 0], nvalid=[5, 1, 3, 0])
    for name, case in (("main", main), ("edge", edge)):
        q, kp, vp, st, nv, tb = ragged_case(torch, np, dt, gen, seed=seed,
                                            **case)
        what = (f"ragged_paged_attention {dtype_name} {name} "
                f"B{case['B']} C{case['C']} H{case['H']}/{case['KVH']} "
                f"D{case['D']}")
        out = K.ragged_paged_attention(q, kp, vp, st, nv, tb)
        err = compare(torch, out,
                      K.ragged_paged_attention_plain(q, kp, vp, st, nv, tb),
                      dtype_name, what)
        for b, n in enumerate(case["nvalid"]):
            require(bool((out[b, n:] == 0).all()),
                    f"{what}: rows past num_valid of row {b} are not 0")
        row = {"max_abs_err": err}
        if name == "main":
            nbytes, ops = ragged_bytes_ops(q, kp, case["starts"],
                                           case["nvalid"], case["ps"])
            bms, by = bound_ms(nbytes, ops, dtype_name)
            # library yardstick: one SDPA call over the dense window
            # gathered beforehand (its masked rows are not zeroed)
            B, C, H, D = q.shape
            idx = tb.long()
            KVH = kp.shape[0]     # == H at the slice's shapes
            kd = kp[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KVH, -1, D)
            vd = vp[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KVH, -1, D)
            kpos = torch.arange(kd.shape[2], device=DEVICE)
            qpos = st.long()[:, None] + torch.arange(C, device=DEVICE)[None]
            mask = (kpos[None, None] <= qpos[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            row.update(
                ms=device_ms(torch, lambda: K.ragged_paged_attention(
                    q, kp, vp, st, nv, tb)),
                plain_ms=device_ms(torch, lambda: K.ragged_paged_attention_plain(
                    q, kp, vp, st, nv, tb)),
                library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kd, vd, attn_mask=mask)),
                bound_ms=bms, bound_by=by)
            results["main"] = row
        log(f"  {what}: {fmt(row, dtype_name)}")
    return results["main"]


# -- phase 3: the slice ------------------------------------------------------------


def make_params(torch, shapes, std, gen):
    """Seeded weights on the card under the ``__params__.npz`` names:
    Normal(0, std), layer-norm scale 1 and bias 0, fc biases 0."""
    params = {}
    for name, shape in shapes.items():
        if name.endswith(".scale"):
            params[name] = torch.ones(shape, device=DEVICE)
        elif name.endswith((".bias", ".b")):
            params[name] = torch.zeros(shape, device=DEVICE)
        else:
            params[name] = std * torch.randn(shape, device=DEVICE,
                                             generator=gen)
    return params


KERNEL_GROUPS = (("ragged_paged_attention", "ragged_paged_attention (K2)"),
                 ("layer_norm_fwd", "layer_norm (K1)"),
                 ("gemm", "matmul (cuBLAS)"), ("xmma", "matmul (cuBLAS)"),
                 ("index", "index/scatter/gather"),
                 ("scatter", "index/scatter/gather"),
                 ("gather", "index/scatter/gather"),
                 ("reduce", "reduce/argmax/softmax"),
                 ("argmax", "reduce/argmax/softmax"),
                 ("softmax", "reduce/argmax/softmax"),
                 ("elementwise", "elementwise"), ("vectorized", "elementwise"))


def kernel_breakdown(trace_path, wall_s):
    """Device time by kernel group from a torch.profiler chrome trace:
    the sum of kernel durations, the busy time (union of kernel
    intervals) and the device's idle share of the serving wall time."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = [e for e in events
               if str(e.get("cat", "")).lower() == "kernel" and "dur" in e]
    require(kernels, "the profiler trace holds no device kernel")
    groups, names = {}, {}
    for e in kernels:
        low = e["name"].lower()
        group = next((g for key, g in KERNEL_GROUPS if key in low), "other")
        groups[group] = groups.get(group, 0.0) + e["dur"] / 1e3
        names[e["name"]] = names.get(e["name"], 0.0) + e["dur"] / 1e3
    busy, end = 0.0, None
    for ts, dur in sorted((e["ts"], e["dur"]) for e in kernels):
        if end is None or ts > end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    busy_ms = busy / 1e3
    return {"kernels": len(kernels), "kernel_ms_by_group": groups,
            "top_kernels_ms": dict(sorted(names.items(),
                                          key=lambda kv: -kv[1])[:8]),
            "device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
            "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3)}


def serve(torch, np, seed, card, out_dir, profile=False):
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.generation.model import GPTLM
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    # the parameter table of a model on the meta device names the shapes
    shapes = {n: tuple(p.shape)
              for n, p in GPTLM(cfg, device="meta").jax_params().items()}
    params = make_params(torch, shapes, cfg.initializer_range, gen)
    pred = Predictor(Config().set_params(cfg, params), device=DEVICE)
    del params
    torch.cuda.empty_cache()
    eng = GenerationEngine(pred, cfg, warmup=True)
    log(f"  model + engine ready in {time.perf_counter() - t0:.1f} s "
        f"(weights {sum(p.numel() for p in pred.lm.parameters()) * 4 / 1e9:.2f}"
        f" GB, KV pool {eng.cache.pool_bytes() / 1e9:.2f} GB)")

    rng = np.random.RandomState(seed)
    lengths = rng.randint(16, 769, size=16)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int64)
               for n in lengths]
    max_new = 32
    streams = [None] * len(prompts)
    errors = []

    def client(ids):
        try:
            for i in ids:
                streams[i] = eng.submit(prompts[i], max_new_tokens=max_new)
            for i in ids:
                streams[i].result(timeout=600)
        except Exception as e:  # noqa: BLE001 — recorded, fails the phase below
            errors.append(repr(e))

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t_serve = time.perf_counter()
    threads = [threading.Thread(target=client, args=(range(c, 16, 4),))
               for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t_serve
    if prof is not None:
        prof.__exit__(None, None, None)
    counts = K.launch_counts()
    st = eng.stats()
    eng.close()
    require(not any(t.is_alive() for t in threads), "a client thread hung")
    require(not errors, f"client errors: {errors}")
    for i, s in enumerate(streams):
        require(s is not None and s.done(), f"request {i} not finished")
        require(s.error is None, f"request {i} ended in error: {s.error!r}")
        require(s.finish_reason == "length" and len(s.tokens) == max_new,
                f"request {i}: {s.finish_reason}, {len(s.tokens)} tokens")
    steps = st["ragged_steps_total"]
    L = cfg.num_layers
    log(f"  engine steps {steps}; launches {counts}")
    require(steps > 0, "no engine step ran")
    require(counts["ragged_paged_attention"] == L * steps,
            f"ragged attention launched {counts['ragged_paged_attention']} "
            f"times, want {L} x {steps}")
    require(counts["layer_norm"] == (2 * L + 1) * steps,
            f"layer_norm launched {counts['layer_norm']} times, want "
            f"{2 * L + 1} x {steps}")
    peak = torch.cuda.max_memory_allocated()
    gen_tokens = sum(len(s.tokens) for s in streams)
    perf = {"tokens_per_s": gen_tokens / wall, "wall_s": wall,
            "engine_steps": steps,
            "step_ms_mean": st["decode_step_ms"]["mean"],
            "ttft_ms_p50": st["ttft_ms"]["p50"],
            "itl_ms_p50": st["itl_ms"]["p50"],
            "max_memory_allocated_gb": peak / 1e9,
            "prompt_tokens": int(lengths.sum()), "generated_tokens": gen_tokens,
            "evicted": st["evicted_total"], "card": card}
    if prof is not None:
        # the trace of a whole serving run is tens of MB: parse it and
        # keep only the breakdown (in chip_smoke.json)
        path = os.path.join(out_dir, "serve_trace.json")
        prof.export_chrome_trace(path)
        try:
            perf["profile"] = kernel_breakdown(path, wall)
        finally:
            os.remove(path)
        log("  profile (serving times above include the profiler): "
            + json.dumps(perf["profile"]))
    log(f"  served 16 requests ({int(lengths.sum())} prompt tokens, "
        f"{gen_tokens} generated) in {wall:.3f} s: "
        f"{perf['tokens_per_s']:.2f} tokens/s, {steps} steps, "
        f"mean step {perf['step_ms_mean']} ms, TTFT p50 "
        f"{perf['ttft_ms_p50']} ms, ITL p50 {perf['itl_ms_p50']} ms, "
        f"max_memory_allocated {peak / 1e9:.2f} GB [{card}]")

    # teacher-forced oracle: the predictor's logits over prompt +
    # generated tokens must rank every generated token at the max, up to
    # 1e-3 * max|logit| (greedy up to float32 noise: random weights have
    # near-ties that exact identity would trip on)
    for i in (0, 1):
        toks = list(streams[i].tokens)
        ctx = np.concatenate([prompts[i], np.asarray(toks, np.int64)])
        (logits,) = pred.run([ctx[None, :-1]])
        n = len(prompts[i])
        worst = 0.0
        for k, tok in enumerate(toks):
            row = logits[0, n - 1 + k]
            slack = float(row.max() - row[tok])
            lim = 1e-3 * float(np.abs(row).max())
            require(slack <= lim, f"oracle: request {i} token {k} = {tok} is "
                    f"{slack:.3e} below the max (limit {lim:.3e})")
            worst = max(worst, slack / lim if lim else 0.0)
        log(f"  oracle request {i}: {len(toks)} tokens within limit "
            f"(worst slack {worst:.3f} of the limit)")
    return counts, perf


# -- main ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for the build log and chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving phase with torch.profiler and "
                    "print device time by kernel group and the idle share")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    log("phase 0: environment")
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import _build

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    log(f"  allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    log("phase 1: build")
    _build.build(verbose=True)
    info = _build.last_build()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernel_build.log"), "w") as f:
        f.write(str(info["log"]))
    _build.library()
    log(f"  built {os.path.basename(str(info['path']))} in "
        f"{info['seconds']:.2f} s (log in {args.out}/kernel_build.log)")

    log("phase 2: kernels vs plain")
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    ln, rpa = {}, {}
    for dt in ("float32", "bfloat16"):
        ln[dt] = check_layer_norm(torch, K, dt, gen)
        rpa[dt] = check_ragged(torch, np, K, dt, gen, args.seed)

    log("phase 3: gpt3_1p3b served by the ragged engine")
    counts, perf = serve(torch, np, args.seed, card, args.out,
                         profile=args.profile)

    log("summary: kernels at the slice's shapes (launches: phase 3, which "
        "serves in float32)")
    for name, rows in (("layer_norm", ln), ("ragged_paged_attention", rpa)):
        for dt, row in rows.items():
            log(f"  {name} {dt}: {fmt(row, dt)} launches="
                f"{counts[name] if dt == 'float32' else 0} [{card}]")

    def entry(name, src, replaces, row):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    kernels = [
        entry("layer_norm", "paddle_tpu_torch/kernels/csrc/layer_norm.cu",
              "paddle_tpu/kernels/layer_norm.py:117", ln["float32"]),
        entry("ragged_paged_attention",
              "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu",
              "paddle_tpu/kernels/ragged_paged_attention.py:184",
              rpa["float32"]),
    ]
    record = {"card": card, "kernels": {"layer_norm": ln,
                                        "ragged_paged_attention": rpa},
              "launches": counts, "serve": perf}
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
