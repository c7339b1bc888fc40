"""Which of gloo's collectives take CUDA tensors on this machine, and
what a copy through host memory would cost instead: a measurement on
the card.

PyTorch documents gloo's CUDA support as ``broadcast`` and
``all_reduce``. This probe starts a world of 2 on one card (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node 2 --backend
gloo``, both ranks on cuda:0) and calls each of gloo's own collectives
on CUDA tensors (float32, and int8 for the two the int8 gradient
exchange calls), recording which run and agree with the host
computation and which raise. It then times the port's comm layer
(``paddle_tpu_torch/parallel/comm.py``, which calls gloo's own
collectives on CUDA tensors) at 256 MB for all_reduce and 64 MB for
all_gather, reduce_scatter and all_to_all, beside a host carry of the
last three (a copy to the CPU, gloo's CPU collective, a copy back) on
the same tensors. Point to point: the comm layer's ring ``permute``
(one ``all_to_all_single`` with uneven splits) timed at 16 and 64 MB
beside ``isend`` / ``irecv`` of host copies (a copy to the CPU, gloo's
CPU point to point, a copy back); then, in a second world of 2 (last,
as a failure breaks gloo's pair for good), ``send`` / ``recv``,
``isend`` / ``irecv`` and ``batch_isend_irecv`` on CUDA tensors.
Needs the card:

    python3 probes/gloo_cuda.py

Prints one JSON object of rank 0's findings, then the card's name and
power limit.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(out):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.env import init_parallel_env

    env = init_parallel_env()
    r, n = env.rank, env.world_size
    g = dist.group.WORLD
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * r
    want_sum = sum(torch.arange(8.0) + 10 * k for k in range(n))
    native = {}

    def probe(name, fn, check):
        try:
            got = fn()
            torch.cuda.synchronize()
            native[name] = "ok" if check(got) else "wrong values"
        except Exception as e:  # noqa: BLE001 — the probe records it
            native[name] = f"{type(e).__name__}: {str(e)[:120]}"

    def ar():
        y = x.clone()
        dist.all_reduce(y, group=g)
        return y

    def bc():
        y = x.clone()
        dist.broadcast(y, 0, group=g)
        return y

    def ag():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=g)
        return torch.cat(parts)

    def agt():
        y = x.new_empty(8 * n)
        dist.all_gather_into_tensor(y, x, group=g)
        return y

    def rst():
        y = x.new_empty(8 // n)
        dist.reduce_scatter_tensor(y, x, group=g)
        return y

    def a2a():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=g)
        return y

    def a2a_int8():
        y = torch.empty(8, dtype=torch.int8, device=dev)
        dist.all_to_all_single(y, x.to(torch.int8), group=g)
        return y

    def agt_int8():
        y = torch.empty(8 * n, dtype=torch.int8, device=dev)
        dist.all_gather_into_tensor(y, x.to(torch.int8), group=g)
        return y

    full = torch.cat([torch.arange(8.0) + 10 * k for k in range(n)])
    probe("all_reduce", ar, lambda y: torch.equal(y.cpu(), want_sum))
    probe("broadcast", bc, lambda y: torch.equal(y.cpu(), torch.arange(8.0)))
    probe("all_gather", ag, lambda y: torch.equal(y.cpu(), full))
    probe("all_gather_into_tensor", agt,
          lambda y: torch.equal(y.cpu(), full))
    probe("reduce_scatter_tensor", rst, lambda y: torch.equal(
        y.cpu(), want_sum.chunk(n)[r]))
    probe("all_to_all_single", a2a, lambda y: torch.equal(
        y.cpu(), torch.cat([(torch.arange(8.0) + 10 * k).chunk(n)[r]
                            for k in range(n)])))
    probe("all_to_all_single int8", a2a_int8, lambda y: torch.equal(
        y.cpu(), torch.cat([(torch.arange(8.0) + 10 * k).chunk(n)[r]
                            for k in range(n)]).to(torch.int8)))
    probe("all_gather_into_tensor int8", agt_int8,
          lambda y: torch.equal(y.cpu(), full.to(torch.int8)))
    peer = 1 - r

    def host_p2p(t):
        h = t.cpu()
        y = torch.empty_like(h)
        for w in [dist.isend(h, peer), dist.irecv(y, peer)]:
            w.wait()
        return y.to(dev)

    def host_ag(t):
        h = t.cpu()
        out_ = h.new_empty(n * h.numel())
        dist.all_gather_into_tensor(out_, h, group=g)
        return out_.to(dev)

    def host_rs(t):
        h = t.cpu()
        out_ = h.new_empty(h.numel() // n)
        dist.reduce_scatter_tensor(out_, h, group=g)
        return out_.to(dev)

    def host_a2a(t):
        h = t.cpu()
        out_ = torch.empty_like(h)
        dist.all_to_all_single(out_, h, group=g)
        return out_.to(dev)

    timed = {}
    for name, mb, fn in (
            ("all_reduce", 256, lambda t: comm.all_reduce(t, group=g)),
            ("all_gather", 64, lambda t: comm.all_gather(t, g)),
            ("reduce_scatter", 64, lambda t: comm.reduce_scatter(t, g)),
            ("all_to_all", 64, lambda t: comm.all_to_all(t, g)),
            ("host_carried_all_gather", 64, host_ag),
            ("host_carried_reduce_scatter", 64, host_rs),
            ("host_carried_all_to_all", 64, host_a2a),
            ("permute_16", 16, lambda t: comm.permute(t, g)),
            ("host_carried_p2p_16", 16, host_p2p),
            ("permute_64", 64, lambda t: comm.permute(t, g)),
            ("host_carried_p2p_64", 64, host_p2p)):
        t = torch.randn(mb << 18, device=dev)
        fn(t)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(t)
        torch.cuda.synchronize()
        timed[name] = {"mb": mb, "ms": (time.perf_counter() - t0) / 3 * 1e3}
        if name.startswith(("permute", "host_carried_p2p")):
            y = fn(t)
            back = fn(y)    # n == 2: two steps bring a tensor home
            torch.cuda.synchronize()
            timed[name]["round_trip_equal"] = bool(torch.equal(back, t))
    if r == 0:
        with open(out, "w") as f:
            json.dump({"backend": dist.get_backend(), "native_cuda": native,
                       "timed": timed}, f)
    dist.barrier()


def p2p_child(out):
    """gloo's point-to-point calls on CUDA tensors, each recorded."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel.env import init_parallel_env

    env = init_parallel_env()
    r = env.rank
    peer = 1 - r
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * r
    other = torch.arange(8.0) + 10 * peer
    found = {}

    def sr():
        y = torch.empty_like(x)
        if r == 0:
            dist.send(x, peer)
            dist.recv(y, peer)
        else:
            dist.recv(y, peer)
            dist.send(x, peer)
        return y

    def bisr():
        y = torch.empty_like(x)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                         dist.P2POp(dist.irecv, y, peer)]):
            w.wait()
        return y

    for name, fn in (("batch_isend_irecv", bisr), ("send/recv", sr)):
        try:
            y = fn()
            torch.cuda.synchronize()
            found[name] = ("ok" if torch.equal(y.cpu(), other)
                           else "wrong values")
        except Exception as e:  # noqa: BLE001 — the probe records it
            found[name] = f"{type(e).__name__}: {str(e)[:160]}"
        with open(f"{out}.rank{r}", "w") as f:
            json.dump(found, f)


def main():
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--p2p-child"]:
        p2p_child(sys.argv[2])
        return 0
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.parallel.env import free_port

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "probe.json")
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node=2", "--backend=gloo",
             f"--started_port={free_port()}", f"--run_dir={d}/run",
             os.path.abspath(__file__), "--child", out],
            capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        result = json.load(open(out))
        # p2p on CUDA tensors last, in a world of its own: a failed
        # send leaves gloo's pair broken, so its exit code is recorded,
        # not required to be 0
        p2p = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node=2", "--backend=gloo", "--max_restarts=0",
             f"--started_port={free_port()}", f"--run_dir={d}/run2",
             os.path.abspath(__file__), "--p2p-child", out],
            capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
        found = {}
        for rk in (0, 1):
            try:
                found[f"rank{rk}"] = json.load(open(f"{out}.rank{rk}"))
            except (OSError, ValueError):
                found[f"rank{rk}"] = "no record"
        err = [ln for ln in p2p.stderr.splitlines() if "Error" in ln]
        result["p2p_cuda"] = {"exit": p2p.returncode, "calls": found,
                              "first_error": err[0][-240:] if err else None}
        print(json.dumps(result))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
