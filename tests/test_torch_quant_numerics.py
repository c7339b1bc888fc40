"""The arithmetic of K11's tensor-core kernel, held on the CPU.

``csrc/quant_matmul.cu`` takes bf16 products on the tensor cores. These
tests hold what its numerics rest on, with a PyTorch emulation that
lives here and not in the package:

(a) float32 x splits into three bf16 terms, hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), that sum back to x exactly
    for every |x| in [2^-109, 3.3895e38] (random bits over the whole
    range, tiny and huge values). The two exceptions, named: below
    about 2^-110 the last term falls under bf16's normal range and
    loses bits (the error stays under 2^-133, bf16's subnormal step);
    above 3.3961e38 hi rounds to infinity. Activations never come near
    either;
(b) q * term is exact in float32 for |q| <= 127;
(c) the e4m3 decode of the kernel (exponent bits moved, subnormals
    m * 2^-9) equals torch's float8_e4m3fn for every finite code;
(d) the int8 scale-after-sum (the sum of the three products, times
    scale[n]) and the int8_block per-block partial sums (each block's
    sum times its scale, added in block order), both over the kernel's K
    split, are within ``sum_tol`` = 2e-6 sqrt(K) max|out| of
    ``quantized_matmul_plain`` at qkv (K 2048), ffn2 (K 8192) and
    k_tail (K 2000), as ``chip_smoke.py`` holds the kernel;
(e) ``split_count`` depends on K and N only and fills the 132 SMs.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.quant_matmul import (
    MMA_DEPTH, quantize_weight, quantized_matmul, quantized_matmul_plain,
    split_count)


def sum_tol(K, ref):
    """chip_smoke.py's K11 tolerance: 2e-6 sqrt(K) of the output's scale."""
    return 2e-6 * K ** 0.5 * max(1.0, float(ref.abs().max()))


def split3(x):
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _random_floats(rng, n, e_lo, e_hi):
    """float32 with uniform random mantissa bits, sign and biased
    exponent in [e_lo, e_hi)."""
    bits = ((rng.randint(0, 2, n).astype(np.uint32) << 31)
            | (rng.randint(e_lo, e_hi, n).astype(np.uint32) << 23)
            | rng.randint(0, 2 ** 23, n).astype(np.uint32))
    return torch.from_numpy(bits.view(np.float32))


@pytest.mark.parametrize("e_lo,e_hi", [(127 - 109, 127 - 90),   # tiny
                                       (127 - 90, 127 + 90),    # typical
                                       (127 + 90, 127 + 128)])  # huge
def test_three_bf16_terms_reconstruct_float32_exactly(e_lo, e_hi):
    x = _random_floats(np.random.RandomState(e_lo), 200_000, e_lo, e_hi)
    x = x[x.abs() <= 3.3895e38]      # the largest finite bf16 rounds up
    hi, mid, lo = split3(x)
    assert torch.isfinite(hi.float()).all()
    rec = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(rec, x)
    # also exact in the order the tensor cores add them (lo first)
    assert torch.equal((lo.float() + mid.float()) + hi.float(), x)


def test_named_exceptions_of_the_split():
    # subnormal-adjacent: bits are lost, by less than bf16's subnormal step
    x = _random_floats(np.random.RandomState(1), 100_000, 1, 127 - 110)
    hi, mid, lo = split3(x)
    err = ((hi.float() + mid.float()) + lo.float() - x).abs()
    assert (err > 0).any() and float(err.max()) <= 2.0 ** -133
    # huge: hi rounds to infinity
    assert torch.isinf(split3(torch.tensor([3.3962e38]))[0].float()).all()


def test_int8_times_bf16_term_is_exact_in_float32():
    q = torch.arange(-127, 128, dtype=torch.float32)
    x = _random_floats(np.random.RandomState(2), 4096, 127 - 60, 127 + 60)
    for term in split3(x):
        t = term.float()[:, None]
        prod32 = (t * q[None, :])
        prod64 = t.double() * q.double()[None, :]
        assert torch.equal(prod32.double(), prod64)


def e4m3_decode(codes):
    """The kernel's decode: exponent bits moved into float32, m * 2^-9
    at exponent 0."""
    u = codes.astype(np.uint32)
    e, m = (u >> 3) & 0xF, u & 7
    normal = (((e + 120) << 23) | (m << 20)).astype(np.uint32).view(np.float32)
    mag = np.where(e > 0, normal, m.astype(np.float32) * np.float32(2 ** -9))
    return np.where(u & 0x80, -mag, mag).astype(np.float32)


def test_e4m3_decode_matches_torch_for_every_finite_code():
    codes = np.array([c for c in range(256) if c & 0x7F != 0x7F], np.uint8)
    want = torch.from_numpy(codes).view(torch.float8_e4m3fn).float().numpy()
    got = e4m3_decode(codes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def _split_ranges(K, N):
    steps = -(-K // 32)
    splits = split_count(K, N)
    per = -(-steps // splits) * 32
    return [(s * per, min(K, (s + 1) * per)) for s in range(splits)]


def emulate_kernel(x, qw, scales, mode, block):
    """The kernel's sums in PyTorch: per K range, the three exact bf16
    products in float32; int8 scales the finished sum, int8_block each
    block's partial sum; the ranges are added in order."""
    K, N = qw.shape
    q = qw.float()
    terms = [t.float() for t in split3(x)]
    out = None
    for k0, k1 in _split_ranges(K, N):
        acc = torch.zeros(x.shape[0], N)
        if mode == "int8":
            for t in reversed(terms):
                acc = acc + t[:, k0:k1] @ q[k0:k1]
        else:
            b = k0
            while b < k1:
                e = min(k1, (b // block + 1) * block)
                part = torch.zeros_like(acc)
                for t in reversed(terms):
                    part = part + t[:, b:e] @ q[b:e]
                acc = acc + part * scales[b // block][None, :]
                b = e
        out = acc if out is None else out + acc
    return out * scales[None, :] if mode == "int8" else out


@pytest.mark.parametrize("mode", ["int8", "int8_block"])
@pytest.mark.parametrize("name,K", [("qkv", 2048), ("ffn2", 8192),
                                    ("k_tail", 2000)])
def test_emulated_kernel_sums_within_sum_tol_of_plain(mode, name, K):
    g = torch.Generator().manual_seed(K)
    M, N = 8, 48
    w = 0.02 * torch.randn(K, N, generator=g)
    x = torch.randn(M, K, generator=g)
    qw, qs = quantize_weight(w, mode, 256)
    ref = quantized_matmul_plain(x, qw, qs, mode, 256)
    got = emulate_kernel(x, qw, qs, mode, 256)
    err = float((got - ref).abs().max())
    assert err <= sum_tol(K, ref), (name, err, sum_tol(K, ref))
    # the CPU wrapper is the plain version
    assert torch.equal(quantized_matmul(x, qw, qs, mode=mode, block=256), ref)


def test_split_count_depends_on_k_and_n_only():
    # qkv, ffn1, ffn2, attention out, head of gpt3_1p3b
    assert [split_count(K, N) for K, N in ((2048, 6144), (2048, 8192),
                                            (8192, 2048), (2048, 2048),
                                            (2048, 32000))] == [2, 2, 8, 8, 1]
    for K, N in ((2000, 2048), (2048, 2050), (8192, 2048), (64, 100)):
        s = split_count(K, N)
        blocks = -(-N // 128) * s
        assert 1 <= s and (s == 1 or blocks <= 132)
        ranges = _split_ranges(K, N)
        assert len(ranges) == s and ranges[-1][1] == K
        assert all(a < b and a % 32 == 0 for a, b in ranges)
    assert 256 % MMA_DEPTH == 0 and 100 % MMA_DEPTH != 0
