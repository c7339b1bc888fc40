"""K12 (batched LoRA) on the card: its two kernels' device time, the
call's time on one input and on rotated inputs, and the wrapper's host
time a call, at the five LoRA targets of the serving step.

At gpt3_1p3b's targets (qkv 2048 -> 6144, proj 2048 -> 2048, ffn1 2048
-> 8192, ffn2 8192 -> 2048, head 2048 -> 32000), on the ragged step's
8 lanes x 16 rows with ``chip_smoke.py`` phase 2's slot mix (rank
buckets 8 and 16, 6 of 8 lanes on an adapter):

  ms_warm, ms_rotated   the call, timed as ``chip_smoke.py`` times
                        kernels (CUDA events behind a sleep kernel), on
                        one input and on rotating copies of x, out and
                        the pools (``rotated``: no call finds them in L2);
  shrink_ms, expand_ms  each kernel's device time (``torch.profiler``,
                        20 rotated calls);
  host_us               wall time of 200 calls queued without a
                        synchronise, a call; host_us_profiled the same
                        inside ``torch.profiler`` (CPU and CUDA
                        activities, as ``chip_smoke.py --profile``);
                        (a package with ``lora_geometry``) its parts:
                        host_us_pool_set the wrapper's pool-set lookup,
                        host_us_entry the library entry with its
                        arguments made ahead (the two cluster and
                        dependent launches), host_us_entry_no_pdl the
                        same with the expand in stream order;
  ms_no_pdl             (a package with ``lora_geometry``) the rotated
                        call through a copy of ``csrc/lora.cu`` built
                        with the expand launched after the shrink in
                        stream order instead of as its programmatic
                        dependent, and each kernel's device time so
                        (``shrink_ms_no_pdl``, ``expand_ms_no_pdl``: the
                        two kernels uncontended).

``--sweep`` also times the rotated call at each cap of SWEEP on the
slices of K a cluster (the shipped cap is ``lora.MAX_SLICES``), calling
the library's entry with the geometry so cut; each result is checked
against the plain version first.

``--trace`` builds a copy of ``csrc/lora.cu`` with ``%globaltimer``
stamps patched in (thread 0 of every block, at the stages of TRACE) and
prints, a target, each stage's time after the first shrink block
started: the median and the latest over the blocks that reached it, on
one rotated call (the median of TRACE_CALLS calls). The shipped kernel
has no stamps.

``--root DIR`` imports ``paddle_tpu_torch`` from another checkout (an
earlier commit unpacked with ``git archive``), so one call on the card
can time both designs in turns. Needs the card and ``nvcc``:

    python3 probes/k12_passes.py [--root DIR] [--sweep] [--trace]

Prints one JSON object a target, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = (("qkv", 2048, 6144), ("proj", 2048, 2048), ("ffn1", 2048, 8192),
           ("ffn2", 8192, 2048), ("head", 2048, 32000))
CALLS = 20
HOST_CALLS = 200
SWEEP = (4, 8, 16)
TRACE_CALLS = 9
# the copy of csrc/lora.cu that launches the expand in stream order
NO_PDL = ("attr[0].val.programmaticStreamSerializationAllowed = 1;",
          "attr[0].val.programmaticStreamSerializationAllowed = 0;")
MAX_BLOCKS = 4096   # blocks a kernel the trace holds
# (kernel, stage): the whole lines of csrc/lora.cu the stamp goes after,
# matched once (stage 0 of each kernel is its first statement)
TRACE = {
    ("shrink", "start"):
        'asm volatile("griddepcontrol.launch_dependents;");',
    ("shrink", "slots_known"):
        "  if (first < 0) return;   // the whole cluster: every bucket on "
        "slot 0",
    ("shrink", "staged"):
        "      stage_a(kb, q0, rc);\n      __syncthreads();",
    ("shrink", "partial_kept"):
        "      if (c < rc) part_s[(roff + q0 + c) * kRows + m] = mine;",
    ("shrink", "clustered"):
        "  cluster.sync();   // every slice's partials are in its block",
    ("shrink", "u_written"):
        "          if (mm < rows) scratch[bk.u[j] + int64_t(m0 + mm) * r + "
        "q] = u;\n        }",
    ("expand", "start"): "  extern __shared__ __align__(16) float dyn[];",
    ("expand", "loads_issued"): "          min(kRankChunk, bk.r[first]));",
    ("expand", "waited"):
        'asm volatile("griddepcontrol.wait;" ::: "memory");',
    ("expand", "u_staged"):
        "  pt::mma::cp_async_wait<0>();\n  __syncthreads();",
    ("expand", "computed"): "    roff += r;\n  }\n  if (n < N) {",
}
TRACE_HEAD = """
__device__ unsigned long long g_lora_trace[2][%d][8];
__device__ __forceinline__ void lora_stamp(int kernel, int stage) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                            blockIdx.z);
    if (b < %d) g_lora_trace[kernel][b][stage] = t;
  }
}
extern "C" int pt_lora_trace(void* dst, int clear) {
  if (clear) {
    static unsigned long long zero[2][%d][8];
    return cudaMemcpyToSymbol(g_lora_trace, zero, sizeof(zero));
  }
  return cudaMemcpyFromSymbol(dst, g_lora_trace, sizeof(g_lora_trace));
}
""" % (MAX_BLOCKS, MAX_BLOCKS, MAX_BLOCKS)


def smoke():
    """This checkout's chip_smoke.py, whatever --root puts first."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_split(torch, run):
    """Device ms a call of the shrink and of the expand kernel."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            run()
        torch.cuda.synchronize()
    split = {"shrink_ms": 0.0, "expand_ms": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        for name in ("shrink", "expand"):
            if f"lora_{name}" in e.key:
                split[f"{name}_ms"] += us / CALLS / 1e3
    return split


def geometry_at(lora, K, N, r, max_slices):
    """``lora_geometry`` with at most ``max_slices`` slices of K a
    cluster in place of ``lora.MAX_SLICES``."""
    need = -(-K // max_slices)
    stage = next((s for s in lora.STAGE_ROWS if s >= need),
                 lora.STAGE_ROWS[-1])
    slice_rows = stage * -(-need // stage)
    return lora.LoraGeometry(slice_rows, stage, -(-K // slice_rows),
                             -(-r // lora.RANK_CHUNK),
                             -(-N // lora.CHUNK_COLS))


def entry_call(torch, lib, lora, geo, sl, inputs):
    """The library entry's launch on ``inputs`` at geometry ``geo``, its
    arguments made ahead: what a call costs the host below the
    wrapper."""
    from paddle_tpu_torch.kernels import _build

    base, x, a0, a1, b0, b1, s0, s1 = inputs
    a_t, b_t, s_t, ranks, nslots, rsum, _ = lora._pool_set(
        x, base, [a0, a1], [b0, b1], [s0, s1], 2)
    M, K = x.shape
    scratch = torch.empty(M * rsum, device=x.device)
    args = (x.data_ptr(), base.data_ptr(), sl.data_ptr(), scratch.data_ptr(),
            a_t, b_t, s_t, ranks, nslots, 2, int(sl.shape[1]), M, K,
            base.shape[1], M // sl.shape[0], geo.slice_rows, geo.stage_rows,
            geo.splits, geo.tiles, torch.cuda.current_stream().cuda_stream)
    fn = lib.pt_batched_lora_add

    def run():
        _build.check(fn(*args), "batched_lora_add_ (probe)")

    return run


def call_at(torch, lora, geo, sl):
    """``batched_lora_add_``'s launch at geometry ``geo``, with the
    signature of ``main``'s ``call``."""
    from paddle_tpu_torch.kernels import _build

    def run(*inputs):
        entry_call(torch, _build.library(), lora, geo, sl, inputs)()
        return inputs[0]

    return run


def sweep(torch, cs, lora, base, inputs, want, tol, sl):
    """{cap: rotated ms} over SWEEP, each geometry's result on ``base``
    (the timed calls have added into ``inputs[0]``) checked against the
    plain version's ``want`` within ``tol`` first."""
    x = inputs[1]
    out = {}
    for cap in SWEEP:
        geo = geometry_at(lora, x.shape[1], base.shape[1], 16, cap)
        run = call_at(torch, lora, geo, sl)
        got = run(base.clone(), *inputs[1:])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= tol:
            raise SystemExit(f"sweep {cap}: max_abs_err {err:.3e} > "
                             f"{tol:.3e}")
        out[cap] = cs.device_ms(torch, cs.rotated(torch, run, *inputs))
    return out


def patched_library(tmp, name, patches, head=""):
    """A copy of csrc/lora.cu with each (anchor, replacement) of
    ``patches`` applied (each anchor must match once) and ``head`` after
    its includes, built alone and loaded."""
    from paddle_tpu_torch.kernels import _build

    src = open(os.path.join(_build.CSRC_DIR, "lora.cu")).read()
    src = src.replace('#include "common.cuh"\n',
                      '#include "common.cuh"\n' + head, 1)
    for anchor, new in patches:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} does not match "
                               "csrc/lora.cu once")
        src = src.replace(anchor, new)
    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib_path = os.path.join(tmp, f"{name}.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    f"-I{_build.CSRC_DIR}", "-o", lib_path, path], check=True)
    lib = ctypes.CDLL(lib_path)
    # the wrapper reaches the library through this entry alone
    lib.pt_batched_lora_add.argtypes = _build.SIGNATURES["pt_batched_lora_add"]
    lib.pt_batched_lora_add.restype = ctypes.c_int
    return lib


def traced_library(tmp):
    """csrc/lora.cu with the stamps: (library, the stage names of each
    kernel in stamp order)."""
    stages = {"shrink": [], "expand": []}
    patches = []
    for (kernel, stage), anchor in TRACE.items():
        k = 0 if kernel == "shrink" else 1
        patches.append((anchor, anchor + f"\n  lora_stamp({k}, "
                        f"{len(stages[kernel])});"))
        stages[kernel].append(stage)
    lib = patched_library(tmp, "traced", patches, TRACE_HEAD)
    lib.pt_lora_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib, stages


def with_library(lib, fn):
    """fn() with the wrapper launching through ``lib``."""
    from paddle_tpu_torch.kernels import _build

    shipped = _build.library()
    _build._lib = lib
    try:
        return fn()
    finally:
        _build._lib = shipped


def trace(torch, lib, stages, run):
    """{kernel: {stage: [median, latest] us after the first shrink
    block's start}} over the blocks that reached each stage, the median
    over TRACE_CALLS rotated calls."""
    import numpy as np

    per_call = []
    buf = np.zeros((2, MAX_BLOCKS, 8), np.uint64)
    for _ in range(TRACE_CALLS):
        torch.cuda.synchronize()
        lib.pt_lora_trace(None, 1)
        run()
        torch.cuda.synchronize()
        lib.pt_lora_trace(buf.ctypes.data, 0)
        t0 = buf[0, :, 0][buf[0, :, 0] > 0].min()
        call = {}
        for k, kernel in enumerate(("shrink", "expand")):
            for i, stage in enumerate(stages[kernel]):
                t = buf[k, :, i]
                t = (t[t > 0].astype(np.int64) - int(t0)) / 1e3
                if t.size:
                    call[(kernel, stage)] = (float(np.median(t)),
                                             float(t.max()))
        per_call.append(call)
    out = {"shrink": {}, "expand": {}}
    for key in per_call[0]:
        vals = [c[key] for c in per_call if key in c]
        out[key[0]][key[1]] = [statistics.median(v[0] for v in vals),
                               statistics.median(v[1] for v in vals)]
    return out


def host_us_profiled(torch, run):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        return host_us(torch, run)


def host_us(torch, run):
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--sweep", action="store_true",
                    help="time the rotated call at the geometries of SWEEP")
    ap.add_argument("--trace", action="store_true",
                    help="stage times inside the kernels (a stamped build)")
    args = ap.parse_args(argv)
    cs = smoke()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import _build, lora

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    ours = hasattr(lora, "lora_geometry")   # not PR 4's design
    tmp = tempfile.TemporaryDirectory()
    no_pdl = patched_library(tmp.name, "no_pdl", [NO_PDL]) if ours else None
    if args.trace:
        traced, stages = traced_library(tmp.name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    R, rep = cs.LANES, cs.CHUNK
    M = R * rep
    sl = torch.tensor(cs.LORA_SLOTS, dtype=torch.int32, device="cuda")
    for name, Kd, N in TARGETS:
        x = torch.randn(M, Kd, device="cuda", generator=gen)
        base = torch.randn(M, N, device="cuda", generator=gen)
        a_p, b_p, s_p = [], [], []
        for r in (8, 16):
            a = 0.02 * torch.randn(3, Kd, r, device="cuda", generator=gen)
            b = 0.02 * torch.randn(3, r, N, device="cuda", generator=gen)
            a[0], b[0] = 0.0, 0.0
            a_p.append(a)
            b_p.append(b)
            s_p.append(torch.tensor([0.0, 2.0, 2.0], device="cuda"))
        got = K.batched_lora_add_(base.clone(), x, a_p, b_p, s_p, sl)
        want = K.batched_lora_add_plain_(base.clone(), x, a_p, b_p, s_p, sl)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = cs.sum_tol(Kd, want)
        if not err <= tol:
            raise SystemExit(f"{name}: max_abs_err {err:.3e} > {tol:.3e}")

        def call(out, x, a0, a1, b0, b1, s0, s1):
            return K.batched_lora_add_(out, x, [a0, a1], [b0, b1], [s0, s1],
                                       sl)

        inputs = (base.clone(), x, *a_p, *b_p, *s_p)
        warm = lambda: call(*inputs)  # noqa: E731
        rot = cs.rotated(torch, call, *inputs)
        row = {"target": name, "K": Kd, "N": N, "root": args.root,
               "max_abs_err": err, "tol": tol,
               "ms_warm": cs.device_ms(torch, warm),
               "ms_rotated": cs.device_ms(torch, rot),
               **kernel_split(torch, rot), "host_us": host_us(torch, warm),
               "host_us_profiled": host_us_profiled(torch, warm)}
        if ours:
            geo = lora.lora_geometry(Kd, N, 16)
            row["geometry"] = geo._asdict()
            row["host_us_pool_set"] = host_us(torch, lambda: lora._pool_set(
                x, inputs[0], a_p, b_p, s_p, 2))
            row["host_us_entry"] = host_us(torch, entry_call(
                torch, _build.library(), lora, geo, sl, inputs))
            row["host_us_entry_no_pdl"] = host_us(torch, entry_call(
                torch, no_pdl, lora, geo, sl, inputs))
            row["ms_no_pdl"] = with_library(
                no_pdl, lambda: cs.device_ms(torch, rot))
            row.update({f"{k}_no_pdl": v for k, v in with_library(
                no_pdl, lambda: kernel_split(torch, rot)).items()})
        if args.sweep and ours:
            row["sweep"] = sweep(torch, cs, lora, base, inputs, want, tol,
                                 sl)
        if args.trace and ours:
            row["trace_us"] = with_library(
                traced, lambda: trace(torch, traced, stages, rot))
        print(json.dumps(row), flush=True)
        del rot
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
