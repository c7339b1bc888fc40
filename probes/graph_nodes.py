"""What a CUDA graph capture makes of the port's launches, on the card.

1. K12 (``batched_lora_add_``) launches its shrink as thread-block
   clusters and its expand as a programmatic dependent launch
   (``cudaLaunchKernelEx``, ``lora.cu``). One call at ffn1's and at
   ffn2's shape ([128, K] -> N, ranks 8 and 16, phase 2's slot mix; at
   K = 8192 a cluster holds 16 blocks) is captured into a graph kept
   for inspection (``CUDAGraph(keep_graph=True)``); the CUDA driver
   lists its kernel nodes with their names and cluster dimensions and
   its edges with their types (``cuGraphGetEdges_v2``: 1 is a
   programmatic edge), and writes its DOT dump (``cuGraphDebugDotPrint``,
   verbose) to ``OUT/k12_<target>_graph.dot``. The replay must equal
   the eager call bit for bit.
2. ``cudaFuncSetAttribute`` under capture: each launcher sets its
   kernel's shared-memory limit once (a static guard), so in the engine
   the side-stream warm-up sets it before the capture. Here the first
   K13 (``paged_attention``) and K2q calls of the process happen inside
   a capture in PyTorch's default ("global") mode: the capture must
   succeed and the replay equal a later eager call.

Needs the card:

    python3 probes/graph_nodes.py [--out DIR]

Prints one JSON object, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import struct
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture(torch, fn, keep=False):
    g = torch.cuda.CUDAGraph(keep_graph=keep)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(g, stream=side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    if keep:
        g.instantiate()
    return g, out


class EdgeData(ctypes.Structure):
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


def describe_graph(cu, graph, dot_path):
    """Kernel nodes (name, grid, cluster dims) and edges (types) of a
    captured CUgraph, through the driver API; errors are reported, not
    raised."""
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    out = {"errors": []}

    def call(name, *args):
        rc = getattr(cu, name)(*args)
        if rc:
            out["errors"].append(f"{name} -> {rc}")
        return rc == 0

    g = vp(graph)
    call("cuGraphDebugDotPrint", g, dot_path.encode(), ctypes.c_uint(1))
    n = sz(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (vp * n.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    index = {nodes[i]: i for i in range(n.value)}
    kernels = []
    for i in range(n.value):
        t = ctypes.c_int(-1)
        call("cuGraphNodeGetType", vp(nodes[i]), ctypes.byref(t))
        if t.value != 0:                       # CU_GRAPH_NODE_TYPE_KERNEL
            kernels.append({"node": i, "type": t.value})
            continue
        params = (ctypes.c_ubyte * 128)()      # CUDA_KERNEL_NODE_PARAMS_v2
        call("cuGraphKernelNodeGetParams_v2", vp(nodes[i]), params)
        func = ctypes.c_void_p.from_buffer(params, 0).value
        grid = struct.unpack_from("3I", bytes(params), 8)
        name = ctypes.c_char_p()
        if func:
            call("cuFuncGetName", ctypes.byref(name), vp(func))
        attr = (ctypes.c_ubyte * 64)()         # CUkernelNodeAttrValue
        call("cuGraphKernelNodeGetAttribute", vp(nodes[i]), ctypes.c_int(4),
             attr)                              # the cluster dimension
        kernels.append({"node": i, "name": (name.value or b"?").decode()[:80],
                        "grid": grid,
                        "cluster": struct.unpack_from("3I", bytes(attr), 0)})
    m = sz(0)
    call("cuGraphGetEdges_v2", g, None, None, None, ctypes.byref(m))
    src, dst = (vp * m.value)(), (vp * m.value)()
    data = (EdgeData * m.value)()
    call("cuGraphGetEdges_v2", g, src, dst, data, ctypes.byref(m))
    out["kernels"] = kernels
    out["edges"] = [{"from": index.get(src[k]), "to": index.get(dst[k]),
                     "type": data[k].type, "from_port": data[k].from_port}
                    for k in range(m.value)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for the graphs' DOT dumps")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs = smoke()
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.runtime.graphs import cuda_driver

    card = cs.card_line()
    os.makedirs(args.out, exist_ok=True)
    _build.library()
    cu = cuda_driver()
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {}

    # 1. K12's cluster and programmatic launches in a graph
    for name, Kd, N in (("ffn1", 2048, 8192), ("ffn2", 8192, 2048)):
        M = cs.LANES * cs.CHUNK
        sl = torch.tensor(cs.LORA_SLOTS, dtype=torch.int32, device="cuda")
        x = torch.randn(M, Kd, device="cuda", generator=gen)
        base = torch.randn(M, N, device="cuda", generator=gen)
        pools = ([], [], [])
        for r in (8, 16):
            a = 0.02 * torch.randn(3, Kd, r, device="cuda", generator=gen)
            b = 0.02 * torch.randn(3, r, N, device="cuda", generator=gen)
            for lst, t in zip(pools, (a, b, torch.tensor([0.0, 2.0, 2.0],
                                                          device="cuda"))):
                lst.append(t)
        want = K.batched_lora_add_(base.clone(), x, *pools, sl)
        out = base.clone()
        g, _ = capture(torch, lambda: K.batched_lora_add_(out, x, *pools, sl),
                       keep=True)
        out.copy_(base)
        g.replay()
        torch.cuda.synchronize()
        info = describe_graph(cu, g.raw_cuda_graph(), os.path.join(
            args.out, f"k12_{name}_graph.dot"))
        info["replay_equals_eager"] = bool(torch.equal(out, want))
        row[f"k12_{name}"] = info

    # 2. first launches (cudaFuncSetAttribute) inside a capture
    def k13():
        B, H, D, KVH, P, ps, maxp = 8, 16, 128, 16, 512, 16, 64
        q = torch.randn(B, H, D, device="cuda", generator=gen)
        kp = torch.randn(KVH, P, ps, D, device="cuda", generator=gen)
        vp = torch.randn(KVH, P, ps, D, device="cuda", generator=gen)
        lengths = torch.tensor([41, 755, 1, 300, 0, 16, 512, 99],
                               dtype=torch.int32, device="cuda")
        tables = torch.randint(1, P, (B, maxp), dtype=torch.int32,
                               device="cuda", generator=gen)
        return lambda: K.paged_attention(q, kp, vp, lengths, tables)

    def k2q():
        B, C, H, D, KVH, P, ps, maxp = 8, 16, 16, 128, 16, 512, 16, 64
        q = torch.randn(B, C, H, D, device="cuda", generator=gen)
        kp = torch.randint(-127, 128, (KVH, P, ps, D), dtype=torch.int8,
                           device="cuda", generator=gen)
        vp = torch.randint(-127, 128, (KVH, P, ps, D), dtype=torch.int8,
                           device="cuda", generator=gen)
        ks = torch.rand(KVH, P, ps, device="cuda", generator=gen) * 0.02
        vs = torch.rand(KVH, P, ps, device="cuda", generator=gen) * 0.02
        starts = torch.tensor([0, 100, 767, 400, 16, 250, 700, 0],
                              dtype=torch.int32, device="cuda")
        nv = torch.tensor([16, 1, 1, 16, 16, 1, 1, 0], dtype=torch.int32,
                          device="cuda")
        tables = torch.randint(1, P, (B, maxp), dtype=torch.int32,
                               device="cuda", generator=gen)
        return lambda: K.ragged_paged_attention_q(q, kp, vp, ks, vs, starts,
                                                  nv, tables)

    for name, make in (("k13", k13), ("k2q", k2q)):
        fn = make()
        try:
            g, got = capture(torch, fn)
            g.replay()
            want = fn()
            torch.cuda.synchronize()
            row[f"{name}_first_launch_in_capture"] = {
                "captured": True, "replay_equals_eager": bool(
                    torch.equal(got, want))}
        except RuntimeError as e:
            row[f"{name}_first_launch_in_capture"] = {
                "captured": False, "error": str(e)[:300]}
    print(json.dumps(row), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
