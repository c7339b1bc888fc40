"""The order of the batched-LoRA kernel (K12) against the JAX package, on
the CPU.

``paddle_tpu_torch/kernels/csrc/lora.cu`` runs only on the card; what it
sums in another order than the plain version is mirrored here in torch,
from the wrapper's own ``lora_geometry``, and held against the JAX
package's ``_reference_lora_delta`` and ``_lora_delta_pallas`` run in
interpret mode:

(a) ``lora_geometry(K, N, r)`` gives every (row, rank) product over K to
    exactly one (slice, k-lane, step) of one rank pass and every output
    column to exactly one (tile, vector, element), and it reads
    (K, N, r) alone: never the card, and its slices (the order of every
    sum) depend on K alone;
(b) a torch mirror of the kernels' order (the shrink: thread c of a row
    adds x[k] * A[k][q] over k = k0 + c + 16 t in t order with a fused
    multiply-add, the 16 threads of a row meet in a butterfly; the
    expand: the slice partials summed in slice order, d = sum over q in
    rank order of u[q] * B[q] with fused multiply-adds, then (d * scale)
    and out + that, two roundings, bucket after bucket; slot-0 rows
    untouched) equals ``_reference_lora_delta`` within 1e-5 of the scale
    (float32 sums in another order), ``_lora_delta_pallas(interpret=
    True)`` within JAX's own 1e-4 bound, and ``batched_lora_add_plain_``
    within the card's ``sum_tol`` (2e-6 * sqrt(K) of the scale): at
    ranks 1, 8, 16 and 24, K not a multiple of the slice and K = 8192, N
    not a multiple of the 16-byte vector, rep 1 and 16, and two buckets
    with lanes on slot 0 in both;
(c) a row's mirrored bits do not change with M, its lane, its
    neighbours' slots, the pool's slot count or the slot index that
    holds its factors.
The mirror's fused multiply-add takes the exact float64 product and
rounds the sum to float64, then float32: in rare ties one float32 step
from the card's single rounding, far inside every bound here.
Inputs come from a numpy seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu_torch.kernels.lora import (CHUNK_COLS, K_LANES, MAX_SLICES,
                                           RANK_CHUNK, batched_lora_add_plain_,
                                           lora_geometry)

jax_lora = importlib.import_module("paddle_tpu.kernels.lora")

VEC = 4   # floats of the expand's 16-byte column vectors


def fma(a, b, c):
    """float32 a * b + c, the product exact in float64, rounded once to
    float64 and then to float32."""
    return (a.double() * b.double() + c.double()).float()


def butterfly(v):
    """The xor-shuffle sum over the last axis (16 k-lanes): lane i adds
    lane i + o for o = 8, 4, 2, 1 (every lane ends with lane 0's bits)."""
    o = v.shape[-1] // 2
    while o >= 1:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def shrink_partials(x, a_rows, geo):
    """[M, splits, r]: each slice's partial x @ A in the shrink's order.
    ``a_rows`` [M, K, r] is each row's slot's A."""
    M, K = x.shape
    r = a_rows.shape[2]
    ks, steps = geo.slice_rows, geo.slice_rows // K_LANES
    pad = geo.splits * ks - K
    # k = slice * ks + t * K_LANES + c; zeros past K, as the kernel stages
    xp = torch.nn.functional.pad(x, (0, pad)).view(M, geo.splits, steps,
                                                   K_LANES)
    ap = torch.nn.functional.pad(a_rows, (0, 0, 0, pad)).view(
        M, geo.splits, steps, K_LANES, r)
    acc = torch.zeros(M, geo.splits, K_LANES, r)
    for t in range(steps):
        acc = fma(xp[:, :, t, :, None], ap[:, :, t], acc)
    return butterfly(acc.transpose(-1, -2))


def k12_mirror(out, x, a_pools, b_pools, scales, slots):
    """K12's arithmetic in K12's order: ``out`` updated in place."""
    M, K = x.shape
    N = out.shape[1]
    slots = slots.to(torch.int32).reshape(slots.shape[0], -1)
    rep = M // slots.shape[0]
    row_slots = slots.repeat_interleave(rep, dim=0)
    rmax = max(int(a.shape[2]) for a in a_pools)
    geo = lora_geometry(K, N, rmax)
    for j, (a, b, sc) in enumerate(zip(a_pools, b_pools, scales)):
        s = row_slots[:, j].long()
        s = torch.where((s > 0) & (s < a.shape[0]), s, torch.zeros_like(s))
        live = s != 0
        if not bool(live.any()):
            continue
        xs, sl = x[live], s[live]
        part = shrink_partials(xs, a[sl], geo)
        u = torch.zeros(xs.shape[0], a.shape[2])
        for sp in range(geo.splits):          # slice order
            u = u + part[:, sp]
        d = torch.zeros(xs.shape[0], N)
        bs = b[sl]
        for q in range(a.shape[2]):           # rank order
            d = fma(u[:, q:q + 1], bs[:, q, :], d)
        out[live] = out[live] + d * sc[sl][:, None]
    return out


def lora_inputs(seed, R, rep, K, N, ranks, slots, S=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(R * rep, K).astype(np.float32)
    base = rng.randn(R * rep, N).astype(np.float32)
    pools = ([], [], [])
    for r in ranks:
        a = (0.1 * rng.randn(S, K, r)).astype(np.float32)
        b = (0.1 * rng.randn(S, r, N)).astype(np.float32)
        sc = (0.5 + rng.rand(S)).astype(np.float32)
        a[0], b[0], sc[0] = 0.0, 0.0, 0.0
        for lst, v in zip(pools, (a, b, sc)):
            lst.append(v)
    return x, base, pools, np.asarray(slots, np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (R, rep, K, N, ranks, slots [R, n_buckets])
CASES = {
    # rank 1, rep 1 (a slot a row), N not a multiple of the vector
    "rank1_rep1": (6, 1, 96, 97, (1,), [[1], [0], [2], [2], [0], [1]]),
    # a partial last slice (K not a multiple of the slice), rep 16 (the
    # ragged chunk)
    "rank8_rep16": (3, 16, 300, 130, (8,), [[1], [0], [2]]),
    "rank16": (2, 16, 2048, 256, (16,), [[2], [1]]),
    # two rank passes of 16 and 8
    "rank24": (2, 5, 300, 130, (24,), [[1], [2]]),
    # K = 8192: slices of two stages each
    "k8192": (2, 3, 8192, 64, (8,), [[1], [2]]),
    # two buckets, lanes on slot 0 in both, one lane in both
    "two_buckets": (4, 4, 200, 72, (8, 16), [[0, 0], [1, 0], [0, 2],
                                             [2, 1]]),
}


@pytest.mark.parametrize("K,N,r", [(2048, 8192, 16), (2048, 32000, 8),
                                   (2048, 6144, 16), (2048, 2048, 8),
                                   (8192, 2048, 16), (96, 97, 1),
                                   (300, 130, 24), (1, 1, 1), (2000, 4, 40),
                                   (70000, 129, 3)])
def test_geometry_owns_every_product_and_column_once(K, N, r):
    geo = lora_geometry(K, N, r)
    assert geo.slice_rows % geo.stage_rows == 0
    assert geo.stage_rows % K_LANES == 0
    assert geo.splits == -(-K // geo.slice_rows) <= MAX_SLICES
    # the shrink: k = slice * slice_rows + c + K_LANES * t (t running on
    # across the slice's stages)
    steps = geo.slice_rows // K_LANES
    ks = (np.arange(geo.splits)[:, None, None] * geo.slice_rows
          + np.arange(steps)[None, :, None] * K_LANES
          + np.arange(K_LANES)[None, None, :]).ravel()
    owned = np.sort(ks[ks < K])
    assert owned.tolist() == list(range(K))
    # rank passes of RANK_CHUNK: q = pass * RANK_CHUNK + i
    qs = [p * RANK_CHUNK + i for p in range(geo.rank_chunks)
          for i in range(RANK_CHUNK) if p * RANK_CHUNK + i < r]
    assert qs == list(range(r))
    assert (geo.rank_chunks - 1) * RANK_CHUNK < r
    # the expand: n = tile * CHUNK_COLS + VEC * v + e, v < CHUNK_COLS / VEC
    cols = [n for tile in range(geo.tiles)
            for n in range(tile * CHUNK_COLS, (tile + 1) * CHUNK_COLS)
            if n < N]
    assert cols == list(range(N))
    assert (geo.tiles - 1) * CHUNK_COLS < N
    assert CHUNK_COLS % VEC == 0


def test_geometry_reads_the_shape_alone(monkeypatch):
    """Nothing of the card is asked; the slices (every sum's order)
    depend on K alone, whatever N and r are."""
    def refuse(*args, **kwargs):
        raise AssertionError("the geometry asked the card")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for K in (1, 96, 300, 2048, 8192, 70000):
        slices = {lora_geometry(K, N, r)[:3]
                  for N in (1, 97, 2048, 32000) for r in (1, 8, 16, 24)}
        assert len(slices) == 1
        assert lora_geometry(K, 2048, 8) == lora_geometry(K, 2048, 8)


def _jax_deltas(x, pools, slots, rep, interpret):
    """Sum over buckets of JAX's per-row delta, in bucket order."""
    row_slots = np.repeat(slots, rep, axis=0)
    total = np.zeros((x.shape[0], pools[1][0].shape[2]), np.float32)
    for j, (a, b, sc) in enumerate(zip(*pools)):
        args = [jnp.asarray(v) for v in (x, a, b, sc, row_slots[:, j])]
        if interpret:
            d = jax_lora._lora_delta_pallas(*args, interpret=True)
        else:
            d = jax_lora._reference_lora_delta(*args)
        total = total + np.asarray(d)
    return total


@pytest.mark.parametrize("case", sorted(CASES))
def test_k12_mirror_matches_jax_and_plain(case):
    R, rep, K, N, ranks, slots = CASES[case]
    x, base, pools, sl = lora_inputs(len(case) + K + N, R, rep, K, N, ranks,
                                     slots)
    tp = [[_t(v) for v in lst] for lst in pools]
    # from a zero base the mirror's out is the sum of the deltas
    got = k12_mirror(torch.zeros(R * rep, N), _t(x), *tp, _t(sl)).numpy()
    ref = _jax_deltas(x, pools, sl, rep, interpret=False)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(got - ref).max() <= 1e-5 * scale
    pal = _jax_deltas(x, pools, sl, rep, interpret=True)
    assert np.abs(got - pal).max() <= 1e-4 * scale
    # onto a base product, against the plain version (the card's bound)
    mirror = k12_mirror(_t(base.copy()), _t(x), *tp, _t(sl))
    plain = batched_lora_add_plain_(_t(base.copy()), _t(x), *tp, _t(sl))
    tol = 2e-6 * K ** 0.5 * max(1.0, float(plain.abs().max()))
    assert float((mirror - plain).abs().max()) <= tol
    # rows on slot 0 in every bucket are the base, bit for bit
    zero = np.repeat((sl == 0).all(axis=1), rep)
    assert torch.equal(mirror[torch.from_numpy(zero)],
                       _t(base)[torch.from_numpy(zero)])


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 16), K=st.sampled_from([7, 64, 300, 2048]),
       N=st.sampled_from([5, 64, 130]), r=st.sampled_from([1, 8, 16, 24]),
       rep=st.sampled_from([1, 3, 16]), R=st.integers(1, 5),
       S=st.integers(2, 6), data=st.data())
def test_row_bits_do_not_depend_on_the_batch(seed, K, N, r, rep, R, S,
                                             data):
    """A row's mirrored result, alone in a batch of one lane on slot 1 of
    a 2-slot pool, equals the same row at any lane of a batch of R lanes
    whose neighbours carry other slots, in a pool of S slots with its
    factors at any nonzero slot index."""
    rng = np.random.RandomState(seed)
    x_row = rng.randn(rep, K).astype(np.float32)
    base_row = rng.randn(rep, N).astype(np.float32)
    a1 = (0.1 * rng.randn(K, r)).astype(np.float32)
    b1 = (0.1 * rng.randn(r, N)).astype(np.float32)
    sc1 = np.float32(0.5 + rng.rand())

    def pool(S, at):
        a = (0.1 * rng.randn(S, K, r)).astype(np.float32)
        b = (0.1 * rng.randn(S, r, N)).astype(np.float32)
        sc = (0.5 + rng.rand(S)).astype(np.float32)
        a[0], b[0], sc[0] = 0.0, 0.0, 0.0
        a[at], b[at], sc[at] = a1, b1, sc1
        return [_t(a)], [_t(b)], [_t(sc)]

    alone = k12_mirror(_t(base_row.copy()), _t(x_row), *pool(2, 1),
                       torch.ones(1, 1, dtype=torch.int32))
    at = data.draw(st.integers(1, S - 1), label="slot index")
    lane = data.draw(st.integers(0, R - 1), label="lane")
    x = rng.randn(R * rep, K).astype(np.float32)
    base = rng.randn(R * rep, N).astype(np.float32)
    rows = slice(lane * rep, (lane + 1) * rep)
    x[rows], base[rows] = x_row, base_row
    slots = rng.randint(0, S, (R, 1)).astype(np.int32)
    slots[lane] = at
    batch = k12_mirror(_t(base), _t(x), *pool(S, at), _t(slots))
    assert torch.equal(alone, batch[rows])
    assert not torch.equal(alone, _t(base_row))
