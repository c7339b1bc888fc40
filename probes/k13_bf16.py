"""Why the earlier design of K13 (paged decode attention) was slower in
bfloat16 than in float32: a measurement on the card.

That design (one block per (row, head), each warp walking single keys
with the next key's K and V rows loaded into registers while the current
key is reduced), which the split kernel of
``paddle_tpu_torch/kernels/csrc/paged_attention.cu`` replaced, is taken
from git history (commit cbc9833) and built in three variants by text
patches of that source:

  convert_at_load  as it shipped: a prefetched row is converted to
                   float32 as it is loaded;
  convert_at_use   the prefetched row is kept in its storage type and
                   converted where it is used, a key later;
  no_prefetch      a key's rows are loaded where they are used.

Each runs at ``chip_smoke.py``'s two_lane decode shape (8 lanes, q [8,
16, 128] over [16, 512, 16, 128] pools) in float32 and bfloat16, beside
the current split kernel, timed as ``chip_smoke.py`` times kernels and
held against ``paged_attention_plain``. Needs the card and ``nvcc``.
Where the checkout has no git history, write the earlier source out
first and pass it:

    git show cbc9833:paddle_tpu_torch/kernels/csrc/paged_attention.cu \\
        > paddle_tpu_torch/kernels/build/paged_attention_earlier.cu
    python3 probes/k13_bf16.py \\
        --earlier paddle_tpu_torch/kernels/build/paged_attention_earlier.cu

Prints one JSON object a (variant, dtype) and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

EARLIER = "cbc9833:paddle_tpu_torch/kernels/csrc/paged_attention.cu"
# (old, new) text patches of the earlier source, each matched once
PATCHES = {
    "convert_at_load": [],
    "convert_at_use": [
        ("  float kn[DPL], vn[DPL];\n", "  T kn[DPL], vn[DPL];\n"),
        ("pt::to_float(k_pages[row + d]) : 0.f;",
         "k_pages[row + d] : static_cast<T>(0.f);"),
        ("pt::to_float(v_pages[row + d]) : 0.f;",
         "v_pages[row + d] : static_cast<T>(0.f);"),
        ("      kc[i] = kn[i];\n      vc[i] = vn[i];\n",
         "      kc[i] = pt::to_float(kn[i]);\n"
         "      vc[i] = pt::to_float(vn[i]);\n"),
    ],
    "no_prefetch": [
        ("  if (warp < len) load_rows(warp);\n", ""),
        ("    float kc[DPL], vc[DPL];\n",
         "    float kc[DPL], vc[DPL];\n    load_rows(t);\n"),
        ("    if (t + kWarps < len) load_rows(t + kWarps);\n", ""),
    ],
}


def earlier_source(path):
    if path:
        with open(path) as f:
            return f.read()
    return subprocess.run(["git", "show", EARLIER], cwd=ROOT, check=True,
                          capture_output=True, text=True).stdout


def build(tmp, source):
    from paddle_tpu_torch.kernels import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for variant, patches in PATCHES.items():
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{variant}: the patch {old!r} does not "
                                   "match the earlier source once")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"{variant}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(tmp, f"{variant}.so")
        procs[variant] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC_DIR}",
             "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for variant, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {variant}:\n{out}")
        fn = ctypes.CDLL(lib).pt_paged_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[variant] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", default=None,
                    help=f"the earlier kernel's source (default: git show "
                         f"{EARLIER})")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import kernels as K

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    source = earlier_source(args.earlier)
    card = cs.card_line()
    build_dir = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        fns = build(tmp, source)
        gen = torch.Generator(device="cuda").manual_seed(0)
        lens = [int(n) + 16 for n in cs.serving_prompts(np, 0, cs.VOCAB)[0][
            :cs.LANES]]
        shape = dict(B=cs.LANES, H=16, KVH=16, D=128, P=512, ps=cs.PAGE,
                     maxp=64, lengths=lens)
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            q, kp, vp, ln, tb = cs.paged_case(torch, np, dt, gen, seed=0,
                                              **shape)
            want = K.paged_attention_plain(q, kp, vp, ln, tb)
            B, H, D = q.shape
            runs = {"split_kernel": lambda: K.paged_attention(q, kp, vp, ln,
                                                              tb)}
            for variant, fn in fns.items():
                out = torch.empty_like(q)

                def run(fn=fn, out=out):
                    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                             ln.data_ptr(), tb.data_ptr(), out.data_ptr(), B,
                             H, D, 16, 512, cs.PAGE, 64, 1 / math.sqrt(D),
                             0 if dt_name == "float32" else 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"probe launch: cudaError {err}")
                    return out
                runs[variant] = run
            for name, run in runs.items():
                got = run()
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                print(json.dumps({"variant": name, "dtype": dt_name,
                                  "ms": cs.device_ms(torch, run),
                                  "max_abs_err": err}), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
