"""The arithmetic of the redesigned K13 and K6/K7 kernels against the JAX
package, on the CPU.

The CUDA kernels run only on the card; what they compute in another
order than the plain versions is mirrored here in torch and held
against the JAX package's own functions:

(a) K13's split key walk: ``split_geometry`` / ``split_key_ranges`` of
    ``paddle_tpu_torch/kernels/paged_attention.py`` (the geometry the
    launcher passes to the kernel) cover every key below a row's length
    exactly once and depend on the block table's shape alone;
(b) a torch mirror of the kernel's partition (a float32 partial (m, l,
    acc) per split of a row and kv head, every query head of that kv
    head) and of its merge in split order equals
    ``_reference_paged_attention`` within 2e-5 (float32), grouped-query
    heads, length-0 rows and empty splits included;
(c) a torch mirror of the bfloat16 flash forward's one rounding the
    reference does not make (P rounded to bfloat16 before P V, l and lse
    summed from the unrounded P) stays within the bfloat16 tolerance
    2e-2 of JAX's bfloat16 flash forward, the Pallas kernels in
    interpret mode (``PADDLE_TPU_FLASH_INTERPRET=1``, as
    tests/test_torch_flash_attention.py runs them), and its lse within
    1e-4 of the plain forward's.
Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jax_flash
from paddle_tpu.kernels.paged_attention import (
    _reference_paged_attention as jax_paged_reference)

from paddle_tpu_torch.kernels import flash_attention_fwd_plain
from paddle_tpu_torch.kernels.paged_attention import (CHUNK_KEYS,
                                                       split_geometry,
                                                       split_key_ranges)

NEG_INF = -1e30

# (maxp, ps) of the engines' tables: the default 16-token pages, the
# tests' 4- and 8-token pages, a page longer than a chunk, an odd size
GEOMETRIES = [(64, 16), (8, 16), (16, 8), (5, 4), (2, 100), (7, 3), (1, 64)]


@pytest.mark.parametrize("maxp,ps", GEOMETRIES)
def test_every_key_below_the_length_falls_in_exactly_one_split(maxp, ps):
    chunk, nsplit = split_geometry(maxp, ps)
    assert 0 < chunk <= CHUNK_KEYS
    assert nsplit * chunk >= maxp * ps > (nsplit - 1) * chunk
    if ps <= CHUNK_KEYS:
        assert chunk % ps == 0          # whole pages
    full = maxp * ps
    for length in sorted({0, 1, chunk - 1, chunk, chunk + 1, full - 1, full,
                          full + 1, 3 * full}):
        ranges = split_key_ranges(length, maxp, ps)
        assert len(ranges) == nsplit
        seen = np.zeros(full, np.int64)
        for j, (start, end) in enumerate(ranges):
            assert start <= end
            assert end - start <= chunk
            if end > start:
                assert start == j * chunk   # split j holds chunk j
            seen[start:end] += 1
        n = max(0, min(length, full))
        np.testing.assert_array_equal(seen[:n], 1)
        np.testing.assert_array_equal(seen[n:], 0)


def test_split_geometry_depends_on_the_table_shape_alone():
    """A row's splits are those it has alone, whatever rows run beside
    it: the geometry reads (maxp, ps) and the row's own length only."""
    rng = np.random.RandomState(0)
    for maxp, ps in GEOMETRIES:
        lengths = rng.randint(0, 2 * maxp * ps + 2, size=9)
        batch = [split_key_ranges(n, maxp, ps) for n in lengths]
        for n, ranges in zip(lengths, batch):
            assert ranges == split_key_ranges(int(n), maxp, ps)
        assert {split_geometry(maxp, ps)} == {
            split_geometry(maxp, ps) for _ in lengths}


def split_decode_mirror(q, k_pages, v_pages, lengths, tables, sm_scale):
    """The K13 kernel's arithmetic in torch, float32: per (row, kv head,
    split) a partial over the split's keys for every query head of the
    kv head, then the partials merged in split order."""
    B, H, D = q.shape
    KVH, P, ps, _ = k_pages.shape
    maxp = tables.shape[1]
    G = H // KVH
    chunk, nsplit = split_geometry(maxp, ps)
    m = torch.full((B, H, nsplit), NEG_INF)
    l = torch.zeros(B, H, nsplit)
    acc = torch.zeros(B, H, nsplit, D)
    for b in range(B):
        for j, (start, end) in enumerate(
                split_key_ranges(int(lengths[b]), maxp, ps)):
            if end <= start:
                continue                    # an empty partial, l = 0
            keys = torch.arange(start, end)
            page = tables[b, keys // ps].long()
            page = torch.where((page < 0) | (page >= P),
                               torch.zeros_like(page), page)
            for kvh in range(KVH):
                kr = k_pages[kvh, page, keys % ps].float()   # [n, D]
                vr = v_pages[kvh, page, keys % ps].float()
                hs = slice(kvh * G, (kvh + 1) * G)
                s = (q[b, hs].float() * sm_scale) @ kr.T       # [G, n]
                mx = s.max(dim=1).values
                p = torch.exp(s - mx[:, None])
                m[b, hs, j] = mx
                l[b, hs, j] = p.sum(dim=1)
                acc[b, hs, j] = p @ vr
    out = torch.zeros(B, H, D)
    for b in range(B):
        for h in range(H):
            live = [j for j in range(nsplit) if l[b, h, j] > 0]
            if not live:
                continue                    # a length-0 row stays 0
            mm = max(float(m[b, h, j]) for j in live)
            ll = torch.zeros(())
            o = torch.zeros(D)
            for j in live:                  # split order
                w = torch.exp(m[b, h, j] - mm)
                ll = ll + l[b, h, j] * w
                o = o + acc[b, h, j] * w
            out[b, h] = o / ll
    return out


# (B, H, KVH, D, ps, P, maxp, lengths): the GPU tests' PAGED cases, and
# one whose splits are empty past a short row and whose table runs past
# the pool (page indices out of range read page 0)
PAGED = {
    "decode_8_lanes": (8, 16, 16, 128, 16, 512, 64,
                       [49, 0, 800, 17, 1, 768, 33, 256]),
    "gqa_4_of_16": (4, 16, 4, 128, 16, 64, 8, [1, 16, 127, 128]),
    "odd_dims": (3, 6, 3, 40, 8, 30, 5, [0, 13, 40]),
    "chunk_edges": (5, 4, 2, 32, 4, 64, 40, [64, 65, 0, 160, 1000]),
}


@pytest.mark.parametrize("case", sorted(PAGED))
def test_split_and_ordered_merge_match_the_jax_reference(case):
    B, H, KVH, D, ps, P, maxp, lengths = PAGED[case]
    rng = np.random.RandomState(len(case))
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(KVH, P, ps, D).astype(np.float32)
    vp = rng.randn(KVH, P, ps, D).astype(np.float32)
    tables = rng.randint(1, P, size=(B, maxp)).astype(np.int32)
    if case == "chunk_edges":
        tables[4, -3:] = P + 5              # out of the pool: page 0
    lens = np.asarray(lengths, np.int32)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jax_paged_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(np.clip(tables, 0, P - 1) * (tables < P)), scale))
    got = split_decode_mirror(torch.tensor(q), torch.tensor(kp),
                              torch.tensor(vp), torch.tensor(lens),
                              torch.tensor(tables), scale).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert not got[lens == 0].any()


def flash_fwd_bf16_mirror(q, k, v, mask, sm_scale, causal, block=64):
    """The bfloat16 forward kernel's arithmetic in torch: the online
    softmax over key tiles in float32, P rounded to bfloat16 for P V
    (V is bfloat16 already), l and lse from the unrounded P."""
    B, H, S, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, S), NEG_INF)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, D)
    rows = torch.arange(S)
    for k0 in range(0, S, block):
        cols = torch.arange(k0, min(k0 + block, S))
        s = qf @ kf[:, :, cols].transpose(-1, -2) * sm_scale
        if mask is not None:
            s = s + mask[:, None, None, cols]
        if causal:
            s = torch.where(cols[None, :] > rows[:, None],
                            torch.full((), NEG_INF), s)
        m_new = torch.maximum(m, s.max(dim=-1).values)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pb = p.to(torch.bfloat16).float()   # the one new rounding
        acc = acc * corr[..., None] + pb @ vf[:, :, cols]
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16), m + torch.log(l)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_INTERPRET", "1")


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_bf16_forward_rounding_matches_jax(interpret, causal, masked):
    B, H, S, D = 2, 2, 200, 64
    rng = np.random.RandomState(3 + 2 * causal + masked)
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    keep = None
    if masked:
        keep = rng.rand(B, S) > 0.3
        keep[:, 0] = True                   # no fully masked causal row
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_flash(
        jq, jk, jv, causal, None,
        mask=None if keep is None else jnp.asarray(keep)), np.float32)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    add = (None if keep is None else
           torch.tensor(np.where(keep, 0.0, NEG_INF).astype(np.float32)))
    o, lse = flash_fwd_bf16_mirror(tq, tk, tv, add, D ** -0.5, causal)
    np.testing.assert_allclose(o.float().numpy(), want, atol=2e-2, rtol=2e-2)
    _, plse = flash_attention_fwd_plain(tq, tk, tv, add, None, D ** -0.5,
                                        causal)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
