#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile  # + device time by kernel group in
                                     #   phases 3, 4 and 6

Phases, in order; any failure exits non-zero without the result line:

0. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 is switched off for matmuls and cuDNN so the
   float32 slices are comparable to the CPU parity tests.
1. build: every ``paddle_tpu_torch/kernels/csrc/*.cu`` with nvcc.
2. kernels against their plain PyTorch versions, float32 and bfloat16,
   at the shapes the serving and training paths give them and on edge
   cases; times (CUDA events, median of 21 runs) of the kernel, the
   plain version and one PyTorch library call computing the same
   function, beside the least time the card could take (``bound_ms``).
   Flash attention (K6-K9) at the gpt3_1p3b and BERT-large shapes, at
   S = 4096, S = 1000, with a fully masked row and with the four bias
   shapes (dbias checked too); SDPA is its yardstick.
3. serving: ``GPTConfig.gpt3_1p3b()`` at full width (seeded random
   weights made on the card) served by the ragged ``GenerationEngine``
   at its default geometry; 16 requests from 4 client threads. Every
   stream must finish with its 32 tokens and no error; the launch
   counters must show 24 ragged attention and 49 layer-norm launches per
   engine step; two requests are checked token by token against the
   ``Predictor`` (teacher forced).
4. training: ``build_gpt_lm(GPTConfig.gpt3_1p3b(), 1024,
   AdamOptimizer(3e-4))`` (24 layers, hidden 2048, dropout 0.1) run by
   the port's ``Executor`` on the card: the startup program, then 10
   steps on one ``synthetic_lm_batch`` of 2 x 1024 tokens; then 5 steps
   with ``use_flash_attention=True``. Losses must be finite and the
   last below the first; every step must launch K1 = K3 = 49,
   K4 = K5 = 1 and K10 = 294 times, and with flash 24 forward and 24
   backward flash launches (each of the backward's 3 kernels 24 times).
   Prints the mean step ms, training tokens/s and peak memory.
5. card against CPU: 2-layer models at full width from the same
   numpy-seeded parameters (``io.load_scope_arrays``), 3 fused-Adam
   steps on CUDA (kernels) and on the CPU (plain versions): GPT
   (op-graph and flash, float32; losses within rtol 1e-3) and BERT
   (flash, bfloat16 AMP; rtol 2e-3), parameters within 2 * lr per step.
6. BERT-large pretraining: ``BertConfig.large()`` at full size, seq 512,
   batch 8 of ``synthetic_batch(min_len=128)``, flash attention with the
   key mask, ``decorate(AdamOptimizer(1e-4), init_loss_scaling=1.0,
   use_dynamic_loss_scaling=False, dest_dtype="bfloat16")``, fused Adam,
   10 steps with exact launches every step; mean step, tokens/s, peak.

Then one JSON line of per-kernel numbers, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time

LANES, CHUNK, PAGE = 8, 16, 16     # the engine's defaults (generation_*)
TRAIN_BATCH, TRAIN_SEQ = 2, 1024   # phase 4's batch of gpt3_1p3b
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
VOCAB, HIDDEN = 32000, 2048        # gpt3_1p3b's widths
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


def compare(torch, got, want, dtype, what, atol=None):
    atol, rtol = (TOL[dtype][0] if atol is None else atol), TOL[dtype][1]
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
    # the serving slice's [lanes * chunk, hidden], the training slice's
    # [batch * seq, hidden], then R not a multiple of any block, a narrow
    # row, and a row past the TPU kernel's MAX_C
    for R, C in ((LANES * CHUNK, 2048), (TRAIN_ROWS, 2048), (300, 2048),
                 (37, 96), (5, 8192)):
        x = torch.randn(R, C, device=DEVICE, generator=gen).to(dt)
        g = (1 + 0.1 * torch.randn(C, device=DEVICE, generator=gen)).to(dt)
        b = (0.1 * torch.randn(C, device=DEVICE, generator=gen)).to(dt)
        what = f"layer_norm {dtype_name} [{R}x{C}]"
        err = compare(torch, K.layer_norm(x, g, b, 1e-5),
                      K.layer_norm_plain(x, g, b, 1e-5), dtype_name, what)
        row = {"shape": [R, C], "max_abs_err": err}
        if R in (LANES * CHUNK, TRAIN_ROWS) and C == 2048:
            # the training path runs layer_norm_fwd (the stats written
            # too); the serving path layer_norm (y alone)
            fwd = K.layer_norm_fwd if R == TRAIN_ROWS else K.layer_norm
            item = x.element_size()
            nbytes = (2 * R * C + 2 * C) * item
            if R == TRAIN_ROWS:
                nbytes += 2 * R * 4
            ops = 8 * R * C      # sum, center, square, sum, scale, shift
            bms, by = bound_ms(nbytes, ops, dtype_name)
            row.update(
                ms=device_ms(torch, lambda: fwd(x, g, b, 1e-5)),
                plain_ms=device_ms(
                    torch, lambda: K.layer_norm_plain(x, g, b, 1e-5)),
                library_ms=device_ms(
                    torch, lambda: F.layer_norm(x, (C,), g, b, 1e-5)),
                bound_ms=bms, bound_by=by)
            results["train" if R == TRAIN_ROWS else "main"] = row
        log(f"  {what}: {fmt(row, dtype_name)}")
    return dict(results["main"], train_shape=results["train"])


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


# -- phase 2: the training kernels ----------------------------------------------


def check_layer_norm_bwd(torch, K, dtype_name, gen):
    """K3 against its plain version on the stats of K1's plain version."""
    dt = getattr(torch, dtype_name)
    results = {}
    for R, C in ((TRAIN_ROWS, HIDDEN), (300, 2048), (37, 96), (5, 8192)):
        x = (2 * torch.randn(R, C, device=DEVICE, generator=gen) + 0.5).to(dt)
        g = (1 + 0.1 * torch.randn(C, device=DEVICE, generator=gen)).to(dt)
        b = (0.1 * torch.randn(C, device=DEVICE, generator=gen)).to(dt)
        dy = torch.randn(R, C, device=DEVICE, generator=gen).to(dt)
        _, mean, rstd = K.layer_norm_fwd_plain(x, g, b, 1e-5)
        got = K.layer_norm_bwd(x, g, dy, mean, rstd)
        want = K.layer_norm_bwd_plain(x, g, dy, mean, rstd)
        what = f"layer_norm_bwd {dtype_name} [{R}x{C}]"
        # dgamma/dbeta sum R rows in another order than torch: a float32
        # sum's error grows with its length, so they get 2e-5 * sqrt(R)
        atols = (None, 2e-5 * R ** 0.5, 2e-5 * R ** 0.5)
        err = max(compare(torch, a, w, dtype_name, f"{what} {n}", atol=t)
                  for n, a, w, t in zip(("dx", "dgamma", "dbeta"), got, want,
                                        atols))
        row = {"shape": [R, C], "max_abs_err": err}
        if (R, C) == (TRAIN_ROWS, HIDDEN):
            item = x.element_size()
            nbytes = 3 * R * C * item + 3 * C * item + 2 * R * 4
            ops = 14 * R * C
            bms, by = bound_ms(nbytes, ops, dtype_name)
            # the library's own stats, in the dtype its backward takes
            _, m2, r2 = torch.native_layer_norm(x, [C], g, b, 1e-5)
            row.update(
                ms=device_ms(torch, lambda: K.layer_norm_bwd(
                    x, g, dy, mean, rstd)),
                plain_ms=device_ms(torch, lambda: K.layer_norm_bwd_plain(
                    x, g, dy, mean, rstd)),
                library_ms=device_ms(
                    torch, lambda: torch.ops.aten.native_layer_norm_backward(
                        dy, x, [C], m2, r2, g, b, [True, True, True])),
                bound_ms=bms, bound_by=by)
            results["main"] = row
        log(f"  {what}: {fmt(row, dtype_name)}")
    return results["main"]


def check_softmax_xent(torch, K, dtype_name, gen):
    """K4 and K5 against their plain versions: the training slice's
    [batch * seq, vocab], then rows not a multiple of any block over an
    odd C (the scalar path), and logits of magnitude 1e4; labels at 0 and
    C - 1, and ignore_index rows in the edge cases."""
    import torch.nn.functional as F

    dt = getattr(torch, dtype_name)
    fwd, bwd = {}, {}
    for name, R, C, scale in (("main", TRAIN_ROWS, VOCAB, 1.0),
                              ("odd", 37, 333, 3.0), ("1e4", 64, 4001, 1e4)):
        logits = (scale * torch.randn(R, C, device=DEVICE,
                                      generator=gen)).to(dt)
        labels = torch.randint(0, C, (R,), device=DEVICE, generator=gen)
        labels[0], labels[-1] = 0, C - 1
        if name != "main":
            labels[1::7] = -100
        dloss = torch.rand(R, device=DEVICE, generator=gen) + 0.5
        what = f"softmax_xent {dtype_name} {name} [{R}x{C}]"
        loss, lse = K.softmax_xent_fwd(logits, labels)
        ploss, plse = K.softmax_xent_fwd_plain(logits, labels)
        errf = max(compare(torch, loss, ploss, "float32", f"{what} loss"),
                   compare(torch, lse, plse, "float32", f"{what} lse"))
        if name != "main":
            require(bool((loss[1::7] == 0).all()),
                    f"{what}: ignore_index rows have a non-zero loss")
        ds = K.softmax_xent_bwd(logits, labels, lse, dloss)
        errb = compare(torch, ds, K.softmax_xent_bwd_plain(
            logits, labels, lse, dloss), dtype_name, f"{what} dlogits")
        rowf, rowb = {"max_abs_err": errf}, {"max_abs_err": errb}
        if name == "main":
            item = logits.element_size()
            bf = bound_ms(R * C * item + R * 8 + 2 * R * 4, 4 * R * C,
                          "float32")
            bb = bound_ms(2 * R * C * item + R * 16, 5 * R * C, "float32")
            lg = logits.detach().requires_grad_()
            ce = F.cross_entropy(lg, labels, reduction="none")
            dl = dloss.to(ce.dtype)
            rowf.update(
                ms=device_ms(torch, lambda: K.softmax_xent_fwd(
                    logits, labels)),
                plain_ms=device_ms(torch, lambda: K.softmax_xent_fwd_plain(
                    logits, labels)),
                library_ms=device_ms(torch, lambda: F.cross_entropy(
                    logits, labels, reduction="none")),
                bound_ms=bf[0], bound_by=bf[1])
            rowb.update(
                ms=device_ms(torch, lambda: K.softmax_xent_bwd(
                    logits, labels, lse, dloss)),
                plain_ms=device_ms(torch, lambda: K.softmax_xent_bwd_plain(
                    logits, labels, lse, dloss)),
                library_ms=device_ms(torch, lambda: torch.autograd.grad(
                    ce, lg, dl, retain_graph=True)),
                bound_ms=bb[0], bound_by=bb[1])
            fwd["main"], bwd["main"] = rowf, rowb
        log(f"  {what} fwd: {fmt(rowf, 'float32')}")
        log(f"  {what} bwd: {fmt(rowb, dtype_name)}")
    return fwd["main"], bwd["main"]


def check_fused_adam(torch, K, dtype_name, gen):
    """K10 against its plain version (both in place, on clones): an
    embedding-sized [32000, 2048] parameter, a [2048] bias, an odd size
    with a clip scale and AdamW decay, and a view 4 bytes off 16-byte
    alignment (the scalar path)."""
    dt = getattr(torch, dtype_name)
    f32 = lambda v: torch.tensor([v], device=DEVICE)  # noqa: E731
    lr, b1p, b2p = f32(3e-4), f32(0.9 ** 3), f32(0.999 ** 3)
    results = {}
    for name, n, clip, coeff in (("main", VOCAB * HIDDEN, None, 0.0),
                                 ("bias", HIDDEN, None, 0.0),
                                 ("clip_adamw", 4097, 0.37, 0.01),
                                 ("unaligned", 8191, 2.5, 0.01)):
        off = 1 if name == "unaligned" else 0

        def make(std):
            t = std * torch.randn(n + off, device=DEVICE, generator=gen)
            return t.to(dt)[off:]

        p, g, m = make(1.0), make(0.1), make(0.01)
        v = make(1e-2).square()
        cs = None if clip is None else f32(clip)
        kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, clip_scale=cs,
                  weight_decay=coeff)
        got = [t.clone() for t in (p, g, m, v)]
        want = [t.clone() for t in (p, g, m, v)]
        if off:   # keep the clones 4 bytes off alignment too
            got = [torch.cat([t[:1], t])[1:] for t in got]
        K.fused_adam_update(*got, lr, b1p, b2p, **kw)
        K.fused_adam_update_plain(*want, lr, b1p, b2p, **kw)
        what = f"fused_adam {dtype_name} {name} [{n}]"
        err = max(compare(torch, a, w, dtype_name, f"{what} {s}") for s, a, w
                  in zip(("p", "m1", "m2"), (got[0], got[2], got[3]),
                         (want[0], want[2], want[3])))
        row = {"max_abs_err": err}
        if name == "main":
            item = p.element_size()
            bms, by = bound_ms(7 * n * item, 16 * n, "float32")
            step = torch.zeros((), device=DEVICE)
            row.update(
                ms=device_ms(torch, lambda: K.fused_adam_update(
                    *got, lr, b1p, b2p, **kw)),
                plain_ms=device_ms(torch, lambda: K.fused_adam_update_plain(
                    *want, lr, b1p, b2p, **kw)),
                library_ms=device_ms(torch, lambda: torch._fused_adam_(
                    [want[0]], [want[1]], [want[2]], [want[3]], [], [step],
                    lr=3e-4, beta1=0.9, beta2=0.999, weight_decay=0.0,
                    eps=1e-8, amsgrad=False, maximize=False)),
                bound_ms=bms, bound_by=by)
            results["main"] = row
        log(f"  {what}: {fmt(row, dtype_name)}")
    return results["main"]


# -- phase 2: flash attention -----------------------------------------------------

# (name, [B, H, S, D], causal, mask, dtypes, timed): the gpt3_1p3b and
# BERT-large shapes of phases 4 and 6 (phase 6 feeds float32 q, k, v: its
# qkv projection's bfloat16 output meets a float32 bias), the K7/K9
# regime of the TPU (S > 2048), a ragged S, a fully masked row
FLASH_CASES = (
    ("gpt3_1p3b", (2, 16, 1024, 128), True, None,
     ("float32", "bfloat16"), True),
    ("bert_large", (8, 16, 512, 64), False, "batch",
     ("float32", "bfloat16"), True),
    ("long", (1, 16, 4096, 128), True, None, ("bfloat16",), True),
    ("ragged", (2, 8, 1000, 64), False, "random", ("float32",), False),
    ("fully_masked", (2, 4, 256, 64), False, "dead_row", ("float32",), False),
)
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # sums over S keys
FLASH_BIAS = ((2, 4, 384, 64), ((2, 4), (1, 4), (2, 1), (1, 1)))


def flash_bytes_ops(q, causal, bwd):
    """Bytes (q, k, v, o and lse; dO, dq, dk, dv too for the backward)
    and flops (4 B H S^2 D forward, 10 B H S^2 D backward, half causal)."""
    B, H, S, D = q.shape
    item = q.element_size()
    nbytes = (8 if bwd else 4) * B * H * S * D * item + 4 * B * H * S
    ops = (10 if bwd else 4) * B * H * S * S * D
    return nbytes, ops / 2 if causal else ops


def flash_mask(torch, np, kind, B, S, seed):
    if kind is None:
        return None
    if kind == "batch":    # phase 6's padded batch: lengths 128..512
        from paddle_tpu_torch.models.bert import synthetic_batch

        keep = synthetic_batch(np.random.RandomState(seed), B, S, 30522,
                               min_len=128)["input_mask"] > 0.5
    else:
        keep = np.random.RandomState(seed).rand(B, S) > 0.3
        keep[:, 0] = True
        if kind == "dead_row":
            keep[1] = False
    return torch.as_tensor(np.where(keep, 0.0, -1e30).astype(np.float32)
                           ).to(DEVICE)


def check_flash(torch, np, K, gen, seed):
    """K6-K9: the forward and backward kernels against their plain
    versions (o, lse, dq, dk, dv, dbias), timed beside the plain
    versions and SDPA with the same mask or causal setting."""
    import torch.nn.functional as F

    rows = {"flash_attention_fwd": {}, "flash_attention_bwd": {}}
    for name, shape, causal, mkind, dtypes, timed in FLASH_CASES:
        B, H, S, D = shape
        mask = flash_mask(torch, np, mkind, B, S, seed)
        for dt_name in dtypes:
            dt = getattr(torch, dt_name)
            q, k, v, do = (torch.randn(*shape, device=DEVICE, generator=gen)
                           .to(dt) for _ in range(4))
            scale = D ** -0.5
            what = f"flash_attention {dt_name} {name} {list(shape)}"
            o, lse = K.flash_attention_fwd(q, k, v, mask, None, scale, causal)
            po, plse = K.flash_attention_fwd_plain(q, k, v, mask, None, scale,
                                                   causal)
            errf = max(compare(torch, o, po, dt_name, f"{what} o"),
                       compare(torch, lse, plse, "float32", f"{what} lse",
                               atol=1e-4))
            if mkind == "dead_row":
                mean_v = v[1].float().mean(dim=1, keepdim=True).expand(
                    H, S, D)
                compare(torch, o[1], mean_v, dt_name, f"{what} uniform row")
            got = K.flash_attention_bwd(q, k, v, mask, None, o, lse, do,
                                        scale, causal)
            want = K.flash_attention_bwd_plain(q, k, v, mask, None, o, lse,
                                               do, scale, causal)
            errb = max(compare(torch, a, w, dt_name, f"{what} {n}",
                               atol=FLASH_BWD_TOL[dt_name])
                       for n, a, w in zip(("dq", "dk", "dv"), got, want))
            rowf, rowb = {"max_abs_err": errf}, {"max_abs_err": errb}
            if timed:
                reps = 5 if name == "long" else 21
                am = None if mask is None else mask[:, None, None, :].to(dt)
                lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
                lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=am,
                                                    is_causal=causal)
                for row, bwd, kern, plain, lib in (
                        (rowf, False,
                         lambda: K.flash_attention_fwd(q, k, v, mask, None,
                                                       scale, causal),
                         lambda: K.flash_attention_fwd_plain(
                             q, k, v, mask, None, scale, causal),
                         lambda: F.scaled_dot_product_attention(
                             q, k, v, attn_mask=am, is_causal=causal)),
                        (rowb, True,
                         lambda: K.flash_attention_bwd(
                             q, k, v, mask, None, o, lse, do, scale, causal),
                         lambda: K.flash_attention_bwd_plain(
                             q, k, v, mask, None, o, lse, do, scale, causal),
                         lambda: torch.autograd.grad(
                             lo, (lq, lk, lv), do, retain_graph=True))):
                    bms, by = bound_ms(*flash_bytes_ops(q, causal, bwd),
                                       dt_name)
                    row.update(ms=device_ms(torch, kern, reps=reps),
                               plain_ms=device_ms(torch, plain, reps=reps),
                               library_ms=device_ms(torch, lib, reps=reps),
                               bound_ms=bms, bound_by=by)
                del lo
                key = name if dt_name == "float32" else f"{name}_{dt_name}"
                rows["flash_attention_fwd"][key] = rowf
                rows["flash_attention_bwd"][key] = rowb
            log(f"  {what} fwd: {fmt(rowf, dt_name)}")
            log(f"  {what} bwd: {fmt(rowb, dt_name)}")
    # the four bias shapes, each with its dbias (a sum over the
    # broadcast dims: its tolerance grows with their count)
    shape, bshapes = FLASH_BIAS
    B, H, S, D = shape
    q, k, v, do = (torch.randn(*shape, device=DEVICE, generator=gen)
                   for _ in range(4))
    mask = flash_mask(torch, np, "random", B, S, seed)
    for bs in bshapes:
        bias = torch.randn(*bs, S, S, device=DEVICE, generator=gen)
        what = f"flash_attention float32 bias {list(bs) + [S, S]}"
        o, lse = K.flash_attention_fwd(q, k, v, mask, bias, D ** -0.5, False)
        po, _ = K.flash_attention_fwd_plain(q, k, v, mask, bias, D ** -0.5,
                                            False)
        err = compare(torch, o, po, "float32", f"{what} o")
        got = K.flash_attention_bwd(q, k, v, mask, bias, o, lse, do,
                                    D ** -0.5, False)
        want = K.flash_attention_bwd_plain(q, k, v, mask, bias, o, lse, do,
                                           D ** -0.5, False)
        summed = (B // bs[0]) * (H // bs[1])
        for n, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
            require(tuple(a.shape) == tuple(w.shape), f"{what} {n} shape")
            atol = 1e-4 * (summed if n == "dbias" else 1)
            err = max(err, compare(torch, a, w, "float32", f"{what} {n}",
                                   atol=atol))
        log(f"  {what}: max_err={err:.3e} (dbias atol 1e-4 x {summed})")
    return rows


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
                 ("layer_norm_bwd", "layer_norm_bwd (K3)"),
                 ("column_sum", "layer_norm_bwd (K3)"),
                 ("softmax_xent_fwd", "softmax_xent_fwd (K4)"),
                 ("softmax_xent_bwd", "softmax_xent_bwd (K5)"),
                 ("adam_kernel", "fused_adam (K10)"),
                 ("flash_fwd", "flash_attention_fwd (K6/K7)"),
                 ("flash_d", "flash_attention_bwd (K8/K9)"),
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


def trace_breakdown(prof, out_dir, name, wall):
    """Export the profiler's chrome trace, parse it into the breakdown
    and delete it (a whole phase's trace is tens of MB; the breakdown
    goes to chip_smoke.json)."""
    path = os.path.join(out_dir, f"{name}_trace.json")
    prof.export_chrome_trace(path)
    try:
        out = kernel_breakdown(path, wall)
    finally:
        os.remove(path)
    log(f"  profile ({name} times above include the profiler): "
        + json.dumps(out))
    return out


def start_profile(torch):
    from torch.profiler import ProfilerActivity

    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


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

    prof = start_profile(torch) if profile else None
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
        perf["profile"] = trace_breakdown(prof, out_dir, "serve", wall)
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


# -- phase 4: training -------------------------------------------------------------


def run_steps(torch, np, K, exe, main, scope, batch, loss, want, steps,
              tokens, card, out_dir, name, profile=False):
    """``steps`` Executor runs of ``main`` on one fixed batch: every step
    must launch exactly ``want`` (per kernel; the flash backward's delta,
    dq and dk/dv kernels each as often as the backward); losses finite
    and falling. Returns the path's launch totals and its numbers."""
    totals = {n: 0 for n in K.KERNELS}
    want_bwd = {n: want["flash_attention_bwd"]
                for n in K.flash_attention_bwd.kernel_launches}
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()

    # host-side events a slow step may owe its time to: full (gen 2)
    # Python GC passes and cudaMalloc calls of the caching allocator
    def host_events():
        return (gc.get_stats()[2]["collections"],
                torch.cuda.memory_stats().get("num_device_alloc", 0))

    for s in range(steps):
        K.reset_launch_counts()
        ev0 = host_events()
        t = time.perf_counter()
        (lv,) = exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        ev = [b - a for a, b in zip(ev0, host_events())]
        counts = K.launch_counts()
        require(counts == want, f"step {s}: launches {counts}, want {want}")
        bwd = dict(K.flash_attention_bwd.kernel_launches)
        require(bwd == want_bwd, f"step {s}: flash backward kernels {bwd}, "
                f"want {want_bwd}")
        for n, c in counts.items():
            totals[n] += c
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        log(f"  step {s}: loss {losses[-1]:.6f} in {step_ms[-1]:.3f} ms "
            f"(gen-2 GC passes {ev[0]}, cudaMalloc calls {ev[1]})")
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    log(f"  launches, exactly, every step: "
        f"{ {n: c for n, c in want.items() if c} }; flash backward kernels "
        f"{want_bwd}")
    mean_ms = statistics.mean(step_ms[1:])
    perf = {"losses": losses, "step_ms": step_ms, "first_step_ms": step_ms[0],
            "step_ms_mean": mean_ms, "tokens_per_s": tokens / (mean_ms / 1e3),
            "max_memory_allocated_gb": peak / 1e9, "steps": steps,
            "tokens_per_step": tokens, "launches_per_step": want,
            "card": card}
    log(f"  trained {steps} steps of {tokens} tokens: mean step "
        f"{mean_ms:.3f} ms over steps 1..{steps - 1} (first "
        f"{step_ms[0]:.3f} ms), {perf['tokens_per_s']:.2f} tokens/s, "
        f"max_memory_allocated {peak / 1e9:.2f} GB [{card}]")
    if profile:
        prof = start_profile(torch)
        t = time.perf_counter()
        for _ in range(2):
            exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        prof.__exit__(None, None, None)
        perf["profile"] = trace_breakdown(prof, out_dir, name, wall)
    return totals, perf


def startup_on_card(torch, np, fluid, main, startup, seed):
    main.random_seed = startup.random_seed = seed
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    log(f"  {len(main.global_block().ops)} ops, {n_params} parameters; "
        f"startup run in {time.perf_counter() - t0:.1f} s")
    return exe, scope, n_params


def train(torch, np, seed, card, out_dir, profile=False, steps=10,
          flash=False):
    """gpt3_1p3b trained by the port's Executor through the K1, K3, K4,
    K5 and K10 kernels (and K6-K9 with ``flash``); exact launch counts
    every step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.gpt import (GPTConfig, build_gpt_lm,
                                             synthetic_lm_batch)

    cfg = GPTConfig.gpt3_1p3b()
    cfg.use_flash_attention = flash
    L = cfg.num_layers
    fluid.set_flags({"optimizer_fuse": "auto"})   # on: a CUDA device exists
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_gpt_lm(
            cfg, TRAIN_SEQ, fluid.optimizer.AdamOptimizer(3e-4))
    types = [op.type for op in main.global_block().ops]
    require(types.count("fused_adam") == 12 * L + 6 and "adam" not in types,
            f"the program holds {types.count('fused_adam')} fused_adam ops")
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    batch = synthetic_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               TRAIN_SEQ, cfg.vocab_size)
    want = {name: 0 for name in K.KERNELS}
    want.update(layer_norm=2 * L + 1, layer_norm_bwd=2 * L + 1,
                softmax_xent_fwd=1, softmax_xent_bwd=1,
                fused_adam_update=12 * L + 6)
    if flash:
        want.update(flash_attention_fwd=L, flash_attention_bwd=L)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"], want, steps, TRAIN_ROWS, card,
                             out_dir, "train_flash" if flash else "train",
                             profile)
    perf.update(parameters=n_params, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                flash=flash)
    return totals, perf


# -- phase 6: BERT-large pretraining under bfloat16 AMP ------------------------------


BERT_BATCH, BERT_SEQ = 8, 512


def train_bert(torch, np, seed, card, out_dir, profile=False, steps=10):
    """BertConfig.large() at full width and depth, flash attention with
    the padded batch's key mask, bfloat16 AMP as the JAX bench runs it
    (bench.py:248-250), fused Adam; exact launch counts every step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.bert import (BertConfig, build_bert_pretrain,
                                              synthetic_batch)

    cfg = BertConfig.large()
    cfg.use_flash_attention = True
    L = cfg.num_layers
    fluid.set_flags({"optimizer_fuse": "auto"})
    opt = decorate(fluid.optimizer.AdamOptimizer(1e-4), init_loss_scaling=1.0,
                   use_dynamic_loss_scaling=False, dest_dtype="bfloat16")
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_bert_pretrain(cfg, BERT_SEQ, opt)
    types = [op.type for op in main.global_block().ops]
    n_adam = types.count("fused_adam")
    require(n_adam == len(main.all_parameters()) and "adam" not in types,
            f"{n_adam} fused_adam ops for {len(main.all_parameters())} "
            "parameters")
    require(types.count("flash_attention") == L, "flash ops")
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    batch = synthetic_batch(np.random.RandomState(seed), BERT_BATCH,
                            BERT_SEQ, cfg.vocab_size, min_len=128)
    want = {name: 0 for name in K.KERNELS}
    want.update(layer_norm=2 * L + 1, layer_norm_bwd=2 * L + 1,
                softmax_xent_fwd=1, softmax_xent_bwd=1,
                fused_adam_update=n_adam, flash_attention_fwd=L,
                flash_attention_bwd=L)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"], want, steps,
                             BERT_BATCH * BERT_SEQ, card, out_dir, "bert",
                             profile)
    perf.update(parameters=n_params, batch=BERT_BATCH, seq_len=BERT_SEQ,
                real_tokens=int(batch["input_mask"].sum()))
    return totals, perf


# -- phase 5: card against CPU -------------------------------------------------------


# card-vs-CPU bound on the losses: float32 differs by summation order
# only (1e-3, as phase 5 has always held it); under bfloat16 AMP cuBLAS
# and the CPU's GEMM round a product to bfloat16 after sums in another
# order, so an activation can be one bfloat16 step (2^-8) apart, and the
# loss, a mean over 256 tokens of such values, gets 2e-3
CARD_VS_CPU_RTOL = {"gpt": 1e-3, "gpt_flash": 1e-3, "bert_amp_flash": 2e-3}


def card_vs_cpu(torch, np, seed, model="gpt", steps=3, lr=3e-4):
    """A 2-layer model at full width trained from the same numpy-seeded
    parameters on the card (kernels) and on the CPU (plain versions):
    gpt3_1p3b's widths with op-graph or flash attention (float32), or
    BERT-large's widths with flash attention under bfloat16 AMP."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.core.framework import Parameter
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.bert import (BertConfig, build_bert_pretrain,
                                              synthetic_batch)
    from paddle_tpu_torch.models.gpt import (GPTConfig, build_gpt_lm,
                                             synthetic_lm_batch)

    seq = 128
    fluid.set_flags({"optimizer_fuse": "on"})
    opt = fluid.optimizer.AdamOptimizer(lr)
    with fluid.unique_name.guard():
        if model.startswith("gpt"):
            cfg = GPTConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                            num_layers=2, num_heads=16, ffn_size=8192,
                            max_position=1024, hidden_dropout=0.0,
                            attention_dropout=0.0,
                            use_flash_attention=model == "gpt_flash")
            main, startup, _, fetches = build_gpt_lm(cfg, seq, opt)
            batch = synthetic_lm_batch(np.random.RandomState(seed), 2, seq,
                                       VOCAB)
        else:
            cfg = BertConfig.large()
            cfg.num_layers, cfg.use_flash_attention = 2, True
            cfg.hidden_dropout = cfg.attention_dropout = 0.0
            opt = decorate(opt, init_loss_scaling=1.0,
                           use_dynamic_loss_scaling=False,
                           dest_dtype="bfloat16")
            main, startup, _, fetches = build_bert_pretrain(cfg, seq, opt)
            batch = synthetic_batch(np.random.RandomState(seed), 2, seq,
                                    cfg.vocab_size, min_len=64)
    n_adam = [op.type for op in main.global_block().ops].count("fused_adam")
    cpu, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    cpu.run(startup, scope=cpu_scope)      # moments, beta pows, lr
    rng = np.random.default_rng(seed)
    arrays = {}
    for v in main.list_vars():
        if not v.persistable or v.is_data:
            continue
        if not isinstance(v, Parameter):
            arrays[v.name] = cpu_scope.get_numpy(v.name)
        elif v.name.endswith(".scale"):
            arrays[v.name] = np.ones(v.shape, np.float32)
        elif v.name.endswith((".bias", ".b")):
            arrays[v.name] = np.zeros(v.shape, np.float32)
        else:
            arrays[v.name] = cfg.initializer_range * rng.standard_normal(
                v.shape, dtype=np.float32)
    gpu, gpu_scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    load_scope_arrays(cpu_scope, arrays, main, "cpu")
    load_scope_arrays(gpu_scope, arrays, main, DEVICE)
    losses = {}
    for name, exe, scope in (("cuda", gpu, gpu_scope), ("cpu", cpu, cpu_scope)):
        K.reset_launch_counts()
        t = time.perf_counter()
        losses[name] = [float(np.asarray(exe.run(
            main, feed=batch, fetch_list=[fetches["loss"]],
            scope=scope)[0]).reshape(-1)[0]) for _ in range(steps)]
        log(f"  {name}: losses {losses[name]} in "
            f"{time.perf_counter() - t:.1f} s; launches {K.launch_counts()}")
        if name == "cuda":
            counts = K.launch_counts()
            flash = "flash" in model
            require(counts["fused_adam_update"] == n_adam * steps
                    and counts["flash_attention_bwd"]
                    == (cfg.num_layers * steps if flash else 0),
                    "the card's run did not go through the kernels")
    rtol = CARD_VS_CPU_RTOL[model]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    require(rel <= rtol, f"card vs CPU losses differ by {rel:.3e} > {rtol}")
    limit = 2 * lr * steps
    worst, worst_name = 0.0, ""
    for p in main.all_parameters():
        d = float(np.abs(gpu_scope.get_numpy(p.name)
                         - cpu_scope.get_numpy(p.name)).max())
        if d > worst:
            worst, worst_name = d, p.name
    require(worst <= limit, f"card vs CPU parameter {worst_name} differs by "
            f"{worst:.3e} > 2 * lr * steps = {limit:.1e}")
    log(f"  losses agree within {rel:.3e} (rtol {rtol}); parameters within "
        f"{worst:.3e} ({worst_name}; limit 2 * lr * steps = {limit:.1e})")
    return {"losses": losses, "loss_rel_err": rel, "loss_rtol": rtol,
            "param_max_abs_err": worst, "param_limit": limit}


# -- main ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for the build log and chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving run and two training steps "
                    "with torch.profiler and print device time by kernel "
                    "group and the idle share")
    ap.add_argument("--phases", default="23456",
                    help="phases to run after the build (a debugging aid: "
                    "only a run of all of them prints the result line)")
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

    record = {"card": card}
    rows = {}
    if "2" in args.phases:
        log("phase 2: kernels vs plain")
        gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
        checks = (("layer_norm", check_layer_norm),
                  ("ragged_paged_attention",
                   lambda torch_, K_, dt_, gen_: check_ragged(
                       torch_, np, K_, dt_, gen_, args.seed)),
                  ("layer_norm_bwd", check_layer_norm_bwd),
                  ("softmax_xent", check_softmax_xent),
                  ("fused_adam_update", check_fused_adam))
        for dt in ("float32", "bfloat16"):
            for name, check in checks:
                out = check(torch, K, dt, gen)
                if name == "softmax_xent":
                    rows.setdefault("softmax_xent_fwd", {})[dt] = out[0]
                    rows.setdefault("softmax_xent_bwd", {})[dt] = out[1]
                else:
                    rows.setdefault(name, {})[dt] = out
        rows.update(check_flash(torch, np, K, gen, args.seed))
        record["kernels"] = rows
    # launches of each kernel on the main paths, read just after each
    paths = {}
    if "3" in args.phases:
        log("phase 3: gpt3_1p3b served by the ragged engine")
        paths["serve"], record["serve"] = serve(
            torch, np, args.seed, card, args.out, profile=args.profile)
        torch.cuda.empty_cache()
    if "4" in args.phases:
        log("phase 4: gpt3_1p3b trained by the Executor")
        paths["train"], record["train"] = train(
            torch, np, args.seed, card, args.out, profile=args.profile)
        torch.cuda.empty_cache()
        log("phase 4: gpt3_1p3b with flash attention trained by the Executor")
        paths["train_flash"], record["train_flash"] = train(
            torch, np, args.seed, card, args.out, profile=args.profile,
            steps=5, flash=True)
        torch.cuda.empty_cache()
    if "5" in args.phases:
        record["card_vs_cpu"] = {}
        for model, what in (("gpt", "gpt3_1p3b-width GPT"),
                            ("gpt_flash", "gpt3_1p3b-width GPT, flash"),
                            ("bert_amp_flash",
                             "BERT-large-width BERT, flash, bfloat16 AMP")):
            log(f"phase 5: a 2-layer {what}, card against CPU")
            record["card_vs_cpu"][model] = card_vs_cpu(torch, np, args.seed,
                                                       model)
        torch.cuda.empty_cache()
    if "6" in args.phases:
        log("phase 6: BERT-large pretrained under bfloat16 AMP with flash "
            "attention")
        paths["bert"], record["bert"] = train_bert(
            torch, np, args.seed, card, args.out, profile=args.profile)
        torch.cuda.empty_cache()
    launches = {name: {p: c[name] for p, c in paths.items()}
                for name in K.KERNELS}
    record["launches"] = launches
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)

    log("summary: kernels at the main paths' shapes (launches: phases 3, "
        "4 and 6)")
    for name, by_dt in rows.items():
        for key, row in by_dt.items():
            dt = "bfloat16" if "bfloat16" in key else "float32"
            log(f"  {name} {key}: {fmt(row, dt)} launches={launches[name]} "
                f"[{card}]")
    if args.phases != "23456":
        log(f"phases {args.phases} only: no result line")
        return 0

    def entry(name, src, replaces, key="float32"):
        row = rows[name][key]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": sum(launches[name].values()),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    csrc = "paddle_tpu_torch/kernels/csrc/"
    kernels = [
        entry("layer_norm", csrc + "layer_norm.cu",
              "paddle_tpu/kernels/layer_norm.py:117"),
        entry("ragged_paged_attention", csrc + "ragged_paged_attention.cu",
              "paddle_tpu/kernels/ragged_paged_attention.py:184"),
        entry("layer_norm_bwd", csrc + "layer_norm.cu",
              "paddle_tpu/kernels/layer_norm.py:155"),
        entry("softmax_xent_fwd", csrc + "softmax_xent.cu",
              "paddle_tpu/kernels/softmax_xent.py:94"),
        entry("softmax_xent_bwd", csrc + "softmax_xent.cu",
              "paddle_tpu/kernels/softmax_xent.py:127"),
        entry("fused_adam_update", csrc + "fused_optim.cu",
              "paddle_tpu/kernels/fused_optim.py:134"),
        # the gpt3_1p3b float32 row (phase 4's shape); the BERT-large row
        # and the bfloat16 rows are in chip_smoke.json and the log
        entry("flash_attention_fwd", csrc + "flash_attention.cu",
              "paddle_tpu/kernels/flash_attention.py:169", "gpt3_1p3b"),
        entry("flash_attention_bwd", csrc + "flash_attention.cu",
              "paddle_tpu/kernels/flash_attention.py:641", "gpt3_1p3b"),
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never launched on a main path")
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
