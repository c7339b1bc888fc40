"""The order of the layer-norm kernels (K1, K3) against the JAX package,
on the CPU.

``paddle_tpu_torch/kernels/csrc/layer_norm.cu`` runs only on the card;
what it sums in another order than the plain version is mirrored here in
torch, from the wrapper's own geometry functions, and held against the
JAX package's ``_fwd_impl`` and ``_vjp_bwd`` run in interpret mode:

(a) ``ln_bwd_geometry`` gives every row to exactly one block and every
    partial row to exactly one warp of the column pass, every column of
    a row to exactly one (thread, vector, element), and it reads (R, C)
    and the element size alone: never the card, and a row's threads and
    vectors depend on C alone, as ``ln_fwd_geometry``'s do;
(b) a torch mirror of K3 (per-thread sums of its own vectors in (vector,
    element) order, a butterfly in each warp and over the warps' sums,
    float32 per-block partials of dy*xhat and dy in row order, then the
    column pass: each warp its fixed slice of the partial rows in row
    order, the warps in warp order) equals ``_vjp_bwd`` and
    ``layer_norm_bwd_plain`` within dx's tolerance and 2e-5 * sqrt(R)
    for dgamma and dbeta, and the mirror of K1 equals ``_fwd_impl`` and
    ``layer_norm_fwd_plain``: at the training shape, R not a multiple of
    a block, a narrow row, C past the TPU kernel's MAX_C, one element,
    rows that are not whole vectors, and C past the old 29056 cap;
(c) a row's statistics in the mirror (K1's mean and rstd, K3's m1 and
    m2) are the same bits whatever rows run beside it.
Inputs come from a numpy seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.layer_norm import (VEC_BYTES, ln_bwd_geometry,
                                                 ln_fwd_geometry,
                                                 layer_norm_bwd_plain,
                                                 layer_norm_fwd_plain)

jax_ln = importlib.import_module("paddle_tpu.kernels.layer_norm")

EPS = 1e-5
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def owned_columns(C, itemsize, threads, nvec):
    """[nvec, threads, V]: the column a thread holds at (vector k, element
    i), vector ``t + k * threads`` of the row; -1 past C."""
    V = VEC_BYTES // itemsize
    j = torch.arange(nvec)[:, None] * threads + torch.arange(threads)
    cols = j[..., None] * V + torch.arange(V)
    return torch.where(cols < C, cols, torch.full_like(cols, -1))


def vectors_a_thread(C, itemsize, threads, nvec):
    """nvec, or for the looped kernels the vectors each thread walks."""
    nv = -(-C // (VEC_BYTES // itemsize))
    return nvec or -(-nv // threads)


def thread_sums(vals, cols):
    """[R, T] float32: each thread's sum of its own elements of ``vals``
    [R, C], in (vector, element) order from 0."""
    nvec, T, V = cols.shape
    s = torch.zeros(vals.shape[0], T)
    for k in range(nvec):
        for i in range(V):
            c = cols[k, :, i]
            v = vals[:, c.clamp(min=0)]
            s = s + torch.where(c >= 0, v, torch.zeros_like(v))
    return s


def butterfly(v):
    """The xor-shuffle sum over the last axis (32 lanes): lane i adds
    lane i + o for o = 16, 8, 4, 2, 1."""
    o = v.shape[-1] // 2
    while o >= 1:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def row_sum(s):
    """[R, T] per-thread sums to [R]: ``row_sum`` of layer_norm.cu, a
    butterfly in each warp, then one over the warps' sums padded to 32."""
    R, T = s.shape
    w = butterfly(s.view(R, T // 32, 32))
    if T == 32:
        return w[:, 0]
    return butterfly(torch.nn.functional.pad(w, (0, 32 - w.shape[1])))


def k1_mirror(x, gamma, beta):
    """K1's arithmetic in K1's order: (y, mean, rstd)."""
    R, C = x.shape
    it = x.element_size()
    geo = ln_fwd_geometry(C, it)
    cols = owned_columns(C, it, geo.row_threads,
                         vectors_a_thread(C, it, geo.row_threads, geo.nvec))
    xf = x.float()
    mean = row_sum(thread_sums(xf, cols)) / C
    d = xf - mean[:, None]
    var = row_sum(thread_sums(d * d, cols)) / C
    rstd = torch.rsqrt(var + EPS)
    y = d * rstd[:, None] * gamma.float() + beta.float()
    return y.to(x.dtype), mean, rstd


def k3_row_means(x, gamma, dy, mean, rstd):
    """K3's (xhat, dy*g, m1, m2) per row, in K3's order."""
    R, C = x.shape
    it = x.element_size()
    geo = ln_bwd_geometry(R, C, it)
    cols = owned_columns(C, it, geo.threads,
                         vectors_a_thread(C, it, geo.threads, geo.nvec))
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    dyg = dy.float() * gamma.float()
    inv_c = torch.tensor(1.0) / C
    m1 = row_sum(thread_sums(dyg, cols)) * inv_c
    m2 = row_sum(thread_sums(dyg * xhat, cols)) * inv_c
    return xhat, dyg, m1, m2


def k3_mirror(x, gamma, dy, mean, rstd):
    """K3's arithmetic in K3's order: (dx, dgamma, dbeta)."""
    R, C = x.shape
    geo = ln_bwd_geometry(R, C, x.element_size())
    xhat, dyg, m1, m2 = k3_row_means(x, gamma, dy, mean, rstd)
    dx = rstd[:, None] * (dyg - m1[:, None] - xhat * m2[:, None])
    dyf = dy.float()
    G, rpb = geo.blocks, geo.rows_per_block
    parts = []
    for term in (dyf * xhat, dyf):
        # block b adds its rows b * rpb + i in row order
        part = torch.zeros(G, C)
        for i in range(rpb):
            rows = torch.arange(G) * rpb + i
            live = (rows < R)[:, None]
            part = part + torch.where(live, term[rows.clamp(max=R - 1)],
                                      torch.zeros(G, C))
        # the column pass: warp w adds partial rows w * rpw + i in row
        # order, then the warps' sums are added in warp order
        W = geo.column_warps
        rpw = -(-G // W)
        acc = torch.zeros(W, C)
        for i in range(rpw):
            g = torch.arange(W) * rpw + i
            live = (g < G)[:, None]
            acc = acc + torch.where(live, part[g.clamp(max=max(G - 1, 0))],
                                    torch.zeros(W, C))
        total = torch.zeros(C)
        for w in range(W):
            total = total + acc[w]
        parts.append(total.to(gamma.dtype))
    return (dx.to(x.dtype), *parts)


def ln_inputs(R, C, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = (2 * rng.randn(R, C) + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    dy = rng.randn(R, C).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in (x, g, b, dy)]


# the training shape, R not a multiple of a block, a narrow row, a row
# past the TPU kernel's MAX_C (K3's looped kernel), one element, rows
# that are not whole vectors, and C past the earlier design's 29056 cap
SHAPES = [(2048, 2048), (300, 2048), (37, 96), (5, 8192), (1, 1), (7, 33),
          (16, 2050), (3, 32768)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("R,C", SHAPES + [(0, 8), (4096, 1024), (100000, 7)])
def test_geometry_covers_every_row_and_column_once(R, C, itemsize):
    geo = ln_bwd_geometry(R, C, itemsize)
    rows = [r for b in range(geo.blocks)
            for r in range(b * geo.rows_per_block,
                           min((b + 1) * geo.rows_per_block, R))]
    assert rows == list(range(R))
    assert all(b * geo.rows_per_block < R for b in range(geo.blocks))
    rpw = -(-geo.blocks // geo.column_warps)
    slices = [g for w in range(geo.column_warps)
              for g in range(min(w * rpw, geo.blocks),
                             min((w + 1) * rpw, geo.blocks))]
    assert slices == list(range(geo.blocks))
    fwd = ln_fwd_geometry(C, itemsize)
    for threads, nvec in ((geo.threads, geo.nvec),
                          (fwd.row_threads, fwd.nvec)):
        assert threads % 32 == 0 and 32 <= threads <= 512
        cols = owned_columns(C, itemsize, threads,
                             vectors_a_thread(C, itemsize, threads, nvec))
        held = cols[cols >= 0]
        assert sorted(held.tolist()) == list(range(C))
    assert fwd.rows_per_block == 1 or fwd.row_threads == 32
    assert fwd.row_threads * fwd.rows_per_block <= 512


def test_geometry_reads_the_shape_alone(monkeypatch):
    """Nothing of the card is asked, and a row's threads and vectors in
    K3 are the same whatever R is."""
    def refuse(*args, **kwargs):
        raise AssertionError("the geometry asked the card")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for C in (1, 96, 2048, 2050, 8192, 32768):
        for it in (4, 2):
            per_row = {ln_bwd_geometry(R, C, it)[:2]
                       for R in (1, 37, 300, 2048, 4096, 100000)}
            assert len(per_row) == 1
            assert ln_fwd_geometry(C, it) == ln_fwd_geometry(C, it)


def _jax_bwd(x, g, dy, mean, rstd):
    jdt = jnp.float32 if x.dtype == torch.float32 else jnp.bfloat16
    res = (jnp.asarray(x.float().numpy(), jdt),
           jnp.asarray(g.float().numpy(), jdt),
           jnp.asarray(mean.numpy()), jnp.asarray(rstd.numpy()))
    out = jax_ln._vjp_bwd(EPS, res, jnp.asarray(dy.float().numpy(), jdt))
    return [torch.from_numpy(np.array(o, np.float32)) for o in out]


def _close(got, want, dtype, R):
    """dx at TOL; dgamma, dbeta at 2e-5 * sqrt(R) (float32 sums of R
    rows in another order), as on the card."""
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    tol = dict(TOL[dtype], atol=max(TOL[dtype]["atol"], 2e-5 * R ** 0.5))
    for a, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(a.float(), w.float(), **tol)


@pytest.mark.parametrize("R,C", SHAPES)
def test_k3_mirror_matches_jax_and_plain(R, C, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    x, g, b, dy = ln_inputs(R, C, seed=R + C)
    _, mean, rstd = layer_norm_fwd_plain(x, g, b, EPS)
    got = k3_mirror(x, g, dy, mean, rstd)
    assert [t.dtype for t in got] == [torch.float32] * 3
    _close(got, _jax_bwd(x, g, dy, mean, rstd), torch.float32, R)
    _close(got, layer_norm_bwd_plain(x, g, dy, mean, rstd), torch.float32, R)


@pytest.mark.parametrize("R,C", [(300, 2048), (16, 2050)])
def test_k3_mirror_bf16_matches_jax_and_plain(R, C, monkeypatch):
    """bfloat16 rows: 8 values a vector, so other threads own the
    columns; sums stay float32 and round once."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    x, g, b, dy = ln_inputs(R, C, seed=R * C, dtype=torch.bfloat16)
    _, mean, rstd = layer_norm_fwd_plain(x, g, b, EPS)
    got = k3_mirror(x, g, dy, mean, rstd)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    _close(got, _jax_bwd(x, g, dy, mean, rstd), torch.bfloat16, R)
    _close(got, layer_norm_bwd_plain(x, g, dy, mean, rstd), torch.bfloat16,
           R)


@pytest.mark.parametrize("R,C", SHAPES)
def test_k1_mirror_matches_jax_and_plain(R, C, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    x, g, b, _ = ln_inputs(R, C, seed=R * 3 + C)
    y, mean, rstd = k1_mirror(x, g, b)
    jy, jmean, jrstd = jax_ln._fwd_impl(
        *(jnp.asarray(t.numpy()) for t in (x, g, b)), EPS)
    for want in ((np.asarray(jy), np.asarray(jmean)[:, 0],
                  np.asarray(jrstd)[:, 0]), layer_norm_fwd_plain(x, g, b,
                                                                 EPS)):
        wy, wm, wr = (torch.as_tensor(np.array(w)) for w in want)
        torch.testing.assert_close(y, wy, **TOL[torch.float32])
        torch.testing.assert_close(mean, wm, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(rstd, wr, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("C", [96, 2048, 2050, 8192])
def test_row_statistics_do_not_depend_on_the_batch(C):
    """K1's mean and rstd and K3's m1 and m2 of one row, alone and at
    several places in batches of several sizes: the same bits."""
    x, g, b, dy = ln_inputs(1, C, seed=C)
    _, mean, rstd = k1_mirror(x, g, b)
    _, _, m1, m2 = k3_row_means(x, g, dy, mean, rstd)
    for R, at in ((2, 1), (37, 20), (300, 299), (2048, 1000)):
        bx, _, _, bdy = ln_inputs(R, C, seed=R)
        bx[at], bdy[at] = x[0], dy[0]
        _, bmean, brstd = k1_mirror(bx, g, b)
        _, _, bm1, bm2 = k3_row_means(bx, g, bdy, bmean, brstd)
        for alone, batch in ((mean, bmean), (rstd, brstd), (m1, bm1),
                             (m2, bm2)):
            assert torch.equal(alone[0], batch[at]), (R, at)
