"""The arithmetic of the split ragged attention kernel (K2, K2q) against
the JAX package, on the CPU.

``paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu`` runs only on
the card; what it computes in another order than the plain version is
mirrored here in torch and held against the JAX package's own functions:

(a) the split page walk: a block per (chunk of ``split_geometry``, kv
    head, row) stages the chunk's keys below ``start + num_valid``, and
    each query j sees the prefix of them up to its diagonal; over the
    splits the merge reads, every key ``0 .. start + j`` falls in
    exactly one, and the plan depends on the table's shape and the row's
    own start and count alone;
(b) a torch mirror of the kernel's partition (a float32 partial (m, l,
    acc) per (row, query, head, split), for every query head of a kv
    head; l = 0 where a query sees none of a chunk) and of its merge in
    split order equals ``_reference_ragged`` and ``_ragged_pallas`` run
    in interpret mode, within 2e-5 (float32): prefill from 0, a prefill
    chunk across a chunk edge, decode deep in the context, an idle lane,
    stale rows in a partial last page, grouped-query heads, int8 pages
    with scales, pages of 3 and 7 keys;
(c) the bfloat16 mma path's roundings (S from the raw bf16 q and K then
    scaled, P rounded to bf16 for P V, l from the unrounded P) stay
    within 2e-2 of JAX's bfloat16 result;
(d) a row run alone equals the same row of a full batch, bit for bit.
Inputs come from a numpy seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.paged_attention import (CHUNK_KEYS,
                                                       split_geometry)
from paddle_tpu_torch.kernels.ragged_paged_attention import DOT_ROWS

# the module: the package namespace exports the function under its name
jax_ragged = importlib.import_module(
    "paddle_tpu.kernels.ragged_paged_attention")

NEG_INF = -1e30


def block_keys(start, nv, maxp, ps, split):
    """The keys [k0, k0 + nk) the block of ``split`` stages for a row,
    or None where it exits at once (the kernel's ``total``, ``nk``)."""
    chunk, _ = split_geometry(maxp, ps)
    total = min(start + nv, maxp * ps)
    k0 = split * chunk
    if nv <= 0 or k0 >= total:
        return None
    return k0, min(chunk, total - k0)


def merged_splits(start, j, maxp, ps):
    """The splits the merge reads for query j, in order (the kernel's
    ``used``)."""
    chunk, nsplit = split_geometry(maxp, ps)
    n = min(start + j + 1, maxp * ps)
    return range(min(nsplit, -(-n // chunk)) if n > 0 else 0)


# (maxp, ps) of the engines' tables, a page longer than a chunk, odd sizes
GEOMETRIES = [(64, 16), (8, 16), (16, 8), (5, 4), (2, 100), (30, 3), (12, 7)]


@pytest.mark.parametrize("maxp,ps", GEOMETRIES)
def test_every_query_key_falls_in_exactly_one_split(maxp, ps):
    chunk, nsplit = split_geometry(maxp, ps)
    assert 0 < chunk <= CHUNK_KEYS
    full = maxp * ps
    rng = np.random.RandomState(maxp * ps)
    rows = [(0, 16), (chunk - 4, 16), (chunk, 1), (full - 1, 1),
            (full - 16, 16), (0, 0), (full - 5, 64)]
    rows += [(int(s), int(n)) for s, n in
             zip(rng.randint(0, full, 6), rng.randint(0, 65, 6))]
    for start, nv in rows:
        live = {s for s in range(nsplit)
                if block_keys(start, nv, maxp, ps, s) is not None}
        for j in range(nv):
            seen = np.zeros(full, np.int64)
            for s in merged_splits(start, j, maxp, ps):
                assert s in live               # the block wrote its partial
                k0, nk = block_keys(start, nv, maxp, ps, s)
                lim = min(nk, start + j - k0 + 1)
                assert lim > 0                 # a merged partial has l > 0
                seen[k0:k0 + lim] += 1
            n = min(start + j + 1, full)
            np.testing.assert_array_equal(seen[:n], 1)
            np.testing.assert_array_equal(seen[n:], 0)


def test_the_split_plan_depends_on_the_table_shape_alone():
    """A row's blocks and merged splits are those it has alone, whatever
    rows run beside it: they read (maxp, ps) and the row's own start and
    count only."""
    rng = np.random.RandomState(0)
    for maxp, ps in GEOMETRIES:
        _, nsplit = split_geometry(maxp, ps)
        starts = rng.randint(0, maxp * ps, size=7)
        counts = rng.randint(0, 17, size=7)

        def plan(start, nv):
            return ([block_keys(start, nv, maxp, ps, s)
                     for s in range(nsplit)],
                    [list(merged_splits(start, j, maxp, ps))
                     for j in range(nv)])

        batch = [plan(int(s), int(n)) for s, n in zip(starts, counts)]
        for (s, n), p in zip(zip(starts, counts), batch):
            assert p == plan(int(s), int(n))


def ragged_split_mirror(q, k_pages, v_pages, starts, nvalid, tables,
                        sm_scale, k_scales=None, v_scales=None,
                        bf16_rows=None):
    """The kernel's arithmetic in torch, float32: per (row, kv head,
    split) a partial over the chunk's keys for every query and query
    head; the partials merged in split order. ``bf16_rows``: blocks of
    more query rows than this take the bf16 mma path's roundings (None:
    every block in float32)."""
    B, C, H, D = q.shape
    KVH, P, ps, _ = k_pages.shape
    maxp = tables.shape[1]
    G = H // KVH
    chunk, nsplit = split_geometry(maxp, ps)
    m = torch.full((B, C, H, nsplit), NEG_INF)
    l = torch.zeros(B, C, H, nsplit)
    acc = torch.zeros(B, C, H, nsplit, D)
    for b in range(B):
        start, nv = int(starts[b]), min(int(nvalid[b]), C)
        bf16 = bf16_rows is not None and nv * G > bf16_rows
        for s in range(nsplit):
            blk = block_keys(start, nv, maxp, ps, s)
            if blk is None:
                continue                      # the block exits at once
            k0, nk = blk
            keys = torch.arange(k0, k0 + nk)
            page = tables[b, keys // ps].long()
            page = torch.where((page < 0) | (page >= P),
                               torch.zeros_like(page), page)
            for kvh in range(KVH):
                kr = k_pages[kvh, page, keys % ps].float()     # [nk, D]
                vr = v_pages[kvh, page, keys % ps].float()
                if k_scales is not None:
                    kr = kr * k_scales[kvh, page, keys % ps][:, None]
                    vr = vr * v_scales[kvh, page, keys % ps][:, None]
                hs = slice(kvh * G, (kvh + 1) * G)
                for j in range(nv):
                    lim = min(nk, start + j - k0 + 1)
                    if lim <= 0:
                        continue              # sees none: l = 0
                    if bf16:                  # raw bf16 product, scaled
                        sc = (q[b, j, hs].float() @ kr[:lim].T) * sm_scale
                    else:                     # q scaled in float32 first
                        sc = (q[b, j, hs].float() * sm_scale) @ kr[:lim].T
                    mx = sc.max(dim=1).values
                    p = torch.exp(sc - mx[:, None])
                    m[b, j, hs, s] = mx
                    l[b, j, hs, s] = p.sum(dim=1)
                    if bf16:
                        p = p.to(torch.bfloat16).float()
                    acc[b, j, hs, s] = p @ vr[:lim]
    out = torch.zeros(B, C, H, D)
    for b in range(B):
        for j in range(min(int(nvalid[b]), C)):
            for h in range(H):
                live = [s for s in merged_splits(int(starts[b]), j, maxp, ps)
                        if l[b, j, h, s] > 0]
                if not live:
                    continue
                mm = max(float(m[b, j, h, s]) for s in live)
                ll = torch.zeros(())
                o = torch.zeros(D)
                for s in live:                # split order
                    w = torch.exp(m[b, j, h, s] - mm)
                    ll = ll + l[b, j, h, s] * w
                    o = o + acc[b, j, h, s] * w
                out[b, j, h] = o / ll
    return out.to(q.dtype)


# (B, C, H, KVH, D, P, ps, maxp, starts, num_valid): prefill from 0, a
# prefill chunk across the chunk edge at 64, decode deep in the context,
# an idle lane, a chunk ending in a partial page (stale rows after it);
# grouped-query heads; pages of 3 and 7 keys (chunks of 63)
RAGGED = {
    "rows": (5, 16, 4, 2, 32, 24, 16, 8, [0, 60, 100, 0, 37],
             [16, 16, 1, 0, 3]),
    "pages_of_3": (3, 8, 2, 2, 16, 60, 3, 30, [58, 0, 80], [8, 5, 1]),
    "pages_of_7": (3, 8, 4, 2, 16, 40, 7, 12, [60, 10, 77], [6, 8, 1]),
    "decode_deep": (2, 4, 2, 1, 8, 48, 4, 40, [150, 3], [1, 4]),
}


def ragged_inputs(case, quant=False, seed=0):
    """numpy q, pools (random everywhere: stale rows, the junk page),
    scales when ``quant`` (int8 pools), distinct pages per row, tables
    zero past each chain."""
    B, C, H, KVH, D, P, ps, maxp, starts, nvalid = RAGGED[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, C, H, D).astype(np.float32)
    if quant:
        kp, vp = (rng.randint(-127, 128, (KVH, P, ps, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (0.02 * rng.rand(KVH, P, ps).astype(np.float32)
                  for _ in range(2))
    else:
        kp, vp = (rng.randn(KVH, P, ps, D).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    tables = np.zeros((B, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        n = -(-(starts[b] + nvalid[b]) // ps) if nvalid[b] else 0
        tables[b, :n] = [free.pop() for _ in range(n)]
    ints = [np.asarray(a, np.int32) for a in (starts, nvalid)] + [tables]
    return q, kp, vp, ks, vs, ints


def _jax(fn, q, kp, vp, ks, vs, ints, scale, **kw):
    j = [None if a is None else jnp.asarray(a)
         for a in (q, kp, vp, *ints, ks, vs)]
    return np.asarray(fn(*j[:6], scale, j[6], j[7], **kw), np.float32)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_split_and_ordered_merge_match_jax(case, quant):
    q, kp, vp, ks, vs, ints = ragged_inputs(case, quant, seed=len(case))
    scale = 1.0 / np.sqrt(q.shape[-1])
    t = [None if a is None else torch.tensor(a)
         for a in (q, kp, vp, *ints, ks, vs)]
    got = ragged_split_mirror(*t[:6], scale, t[6], t[7]).numpy()
    want = _jax(jax_ragged._reference_ragged, q, kp, vp, ks, vs, ints, scale)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    pallas = _jax(jax_ragged._ragged_pallas, q, kp, vp, ks, vs, ints, scale,
                  interpret=True)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    nvalid = ints[1]
    for b, n in enumerate(nvalid):
        assert not got[b, n:].any()


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_bf16_path_rounding_matches_jax(case):
    q, kp, vp, _, _, ints = ragged_inputs(case, seed=3)
    scale = 1.0 / np.sqrt(q.shape[-1])
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, kp, vp))
    ti = [torch.tensor(a) for a in ints]
    got = ragged_split_mirror(tq, tk, tv, *ti, scale,
                              bf16_rows=DOT_ROWS).float().numpy()
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, kp, vp))
    want = np.asarray(jax_ragged._reference_ragged(
        jq, jk, jv, *[jnp.asarray(a) for a in ints], scale, None, None),
        np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_a_row_alone_equals_the_row_in_the_batch(quant):
    q, kp, vp, ks, vs, ints = ragged_inputs("rows", quant, seed=5)
    scale = 1.0 / np.sqrt(q.shape[-1])
    t = [None if a is None else torch.tensor(a)
         for a in (q, kp, vp, *ints, ks, vs)]
    batch = ragged_split_mirror(*t[:6], scale, t[6], t[7])
    for b in range(q.shape[0]):
        alone = ragged_split_mirror(t[0][b:b + 1], t[1], t[2],
                                    *[x[b:b + 1] for x in t[3:6]], scale,
                                    t[6], t[7])
        assert torch.equal(alone[0], batch[b]), f"row {b}"
