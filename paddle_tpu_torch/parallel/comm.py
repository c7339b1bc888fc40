"""The port's collective layer: every collective the distribution
code calls goes through here, over a ``torch.distributed`` process
group (None: no world, and the collective is an identity).

Every backend runs each collective as it is: ``all_reduce``,
``broadcast``, ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single``, on NCCL (tensors on the card) and on gloo (CPU
tensors, or CUDA tensors of ranks that share a card). PyTorch documents
gloo's CUDA support as ``broadcast`` and ``all_reduce`` only; on the
card's PyTorch 2.11 gloo took CUDA tensors in all five and ran the
three others faster than a copy through host memory would
(``probes/gloo_cuda.py``, PERF.md §6), so the layer has no second
transport.

The counters (calls, bytes handed to collectives, seconds spent
blocked in a collective or its ``wait``) export as the
``paddle_collective_*{plan=}`` series of one more plan (``STATS``).

``permute`` moves one tensor a rank along a group's ring (``lax.
ppermute``): rank r sends to r + shift and receives from r - shift; with
``ring=False`` the ranks off the ends send or receive nothing. It is
one ``all_to_all_single`` with uneven splits (the tensor in the peer's
slot, empty slots elsewhere), so every rank of the group calls it
together, and its bytes count in the same counters. Point-to-point
``send`` / ``recv`` would be the natural form, but gloo writes a CUDA
tensor's device address to its socket (``writev``: Bad address, which
breaks the pair for every later collective) where its collectives copy
through host memory themselves (``probes/gloo_cuda.py``, PERF.md §6).

The autograd forms carry gradients through the distributed layers:
``reduce_from`` / ``copy_to`` (Megatron's g / f pair: the tensor-
parallel row and column linears, the expert-parallel MoE),
``all_reduce_sum``, ``all_to_all_autograd`` (the MoE's dispatch,
Ulysses' head/sequence exchange), ``permute_autograd`` (its backward
permutes the other way: ring attention, the pipeline's activations),
``gather_dim`` (all-gather along a dim, the rank's slice backward: the
vocabulary-parallel head) and ``scatter_dim`` (the rank's slice
forward, all-gather backward: a replicated value entering a split
computation)."""

from __future__ import annotations

import threading
import time

import torch

__all__ = ["group_size", "group_rank", "all_reduce", "wait", "broadcast",
           "all_gather", "reduce_scatter", "all_to_all", "STATS",
           "reduce_from", "copy_to", "all_reduce_sum",
           "all_to_all_autograd", "permute", "permute_autograd",
           "gather_dim", "scatter_dim"]


class _Stats:
    """The comm layer's counters, exported as one collective plan."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.calls_total = 0
            self.bytes_total = 0
            self.blocked_seconds_total = 0.0

    def add(self, nbytes: int, seconds: float = 0.0):
        with self._lock:
            self.calls_total += 1
            self.bytes_total += int(nbytes)
            self.blocked_seconds_total += float(seconds)

    def add_wait(self, seconds: float):
        with self._lock:
            self.blocked_seconds_total += float(seconds)

    def snapshot(self):
        with self._lock:
            return {"comm_calls_total": self.calls_total,
                    "comm_bytes_total": self.bytes_total,
                    "comm_blocked_seconds_total":
                        round(self.blocked_seconds_total, 6)}


STATS = _Stats()


def _register_stats():
    from ..observability import watch_collectives

    watch_collectives(STATS)


_register_stats()


def _dist():
    return torch.distributed


def group_size(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else _dist().get_rank(group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(t: torch.Tensor, op: str = "sum", group=None,
               async_op: bool = False):
    """In place over ``group``; returns the work handle when
    ``async_op`` (None with no group: an identity)."""
    if group is None:
        return None
    dist = _dist()
    red = getattr(dist.ReduceOp, _OPS[op])
    t0 = time.perf_counter()
    work = dist.all_reduce(t, op=red, group=group, async_op=async_op)
    STATS.add(_nbytes(t), seconds=0.0 if async_op
              else time.perf_counter() - t0)
    return work


def wait(work) -> None:
    """Wait on an async collective's handle, timing the host block."""
    if work is None:
        return
    t0 = time.perf_counter()
    work.wait()
    STATS.add_wait(time.perf_counter() - t0)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place from the group's rank ``src``."""
    if group is None:
        return t
    dist = _dist()
    t0 = time.perf_counter()
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    STATS.add(_nbytes(t), seconds=time.perf_counter() - t0)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' tensors concatenated on dim 0, in group-rank order."""
    if group is None:
        return t
    n = group_size(group)
    src = t.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    t0 = time.perf_counter()
    _dist().all_gather_into_tensor(out, src, group=group)
    STATS.add(_nbytes(src) * n, time.perf_counter() - t0)
    return out


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's chunk (dim 0, ``1/n`` of it) of the ranks' sum."""
    if group is None:
        return t
    n = group_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({t.shape[0]}) is not a "
                         f"multiple of the group's {n} ranks")
    src = t.contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    t0 = time.perf_counter()
    _dist().reduce_scatter_tensor(out, src, group=group)
    STATS.add(_nbytes(src), time.perf_counter() - t0)
    return out


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """Dim 0 split into one equal chunk a rank; chunk r goes to rank r,
    and the result holds the chunks received, in rank order."""
    if group is None:
        return t
    src = t.contiguous()
    out = torch.empty_like(src)
    t0 = time.perf_counter()
    _dist().all_to_all_single(out, src, group=group)
    STATS.add(_nbytes(src), time.perf_counter() - t0)
    return out


def permute(t: torch.Tensor, group=None, shift: int = 1,
            ring: bool = True) -> torch.Tensor:
    """Rank r of ``group`` sends ``t`` to rank r + ``shift`` and returns
    what rank r - ``shift`` sent (every rank's ``t`` has one shape and
    dtype). ``ring``: the ranks wrap around; otherwise a rank whose
    peer would lie off the ends sends nothing, or receives zeros.
    Every rank of the group calls it together."""
    if group is None:
        return t if ring else torch.zeros_like(t)
    n, r = group_size(group), group_rank(group)
    dst, src = r + shift, r - shift
    if ring:
        dst, src = dst % n, src % n
    flat = t.contiguous().reshape(-1)
    k = flat.numel()
    ins, outs = [0] * n, [0] * n
    if 0 <= dst < n:
        ins[dst] = k
    if 0 <= src < n:
        outs[src] = k
    out = flat.new_empty(sum(outs))
    t0 = time.perf_counter()
    _dist().all_to_all_single(out, flat if sum(ins) else flat[:0], outs,
                              ins, group=group)
    STATS.add(_nbytes(flat) if sum(ins) else 0, time.perf_counter() - t0)
    if not sum(outs):
        return torch.zeros_like(t)
    return out.reshape(t.shape)


# -- autograd forms -------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, fwd, bwd):
        ctx.group, ctx.bwd = group, bwd
        if not fwd:
            return x.view_as(x)
        y = x.clone()
        all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if not ctx.bwd:
            return g, None, None, None
        g = g.clone()
        all_reduce(g, group=ctx.group)
        return g, None, None, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward, identity backward: the combine of
    partial results every rank of the group then uses alike."""
    return x if group is None else _AllReduce.apply(x, group, True, False)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, sum over ``group`` backward: a value every rank
    holds alike feeding a computation split over the group."""
    return x if group is None else _AllReduce.apply(x, group, False, True)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` both ways: a statistic each rank's loss reads
    through the sum of every rank's part."""
    return x if group is None else _AllReduce.apply(x, group, True, True)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def all_to_all_autograd(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, group)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift, ring):
        ctx.group, ctx.shift, ctx.ring = group, shift, ring
        return permute(x, group, shift, ring)

    @staticmethod
    def backward(ctx, g):
        return permute(g, ctx.group, -ctx.shift, ctx.ring), None, None, None


def permute_autograd(x: torch.Tensor, group, shift: int = 1,
                     ring: bool = True) -> torch.Tensor:
    """``permute`` whose backward sends the gradient back the other
    way."""
    return _Permute.apply(x, group, shift, ring)


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    if dim == 0:
        return all_gather(t, group)
    return all_gather(t.movedim(dim, 0), group).movedim(0, dim).contiguous()


def _slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = group_size(group), group_rank(group)
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k).contiguous()


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` forward; this
    rank's slice of the gradient backward (every rank then computes
    alike on the whole value)."""
    return x if group is None else _GatherDim.apply(x, dim, group)


def scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``dim`` of a value every rank holds alike;
    backward, the ranks' gradient slices concatenated."""
    return x if group is None else _ScatterDim.apply(x, dim, group)
