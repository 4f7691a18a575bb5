"""The integer steps of K5's small-M route (``src/repro_torch/csrc/
apmm_packed.cu``, ``packed_to_xq_kernel``, then the weight-streaming GEMM
of ``csrc/small_m.cuh`` that K1 shares), emulated in numpy against
``ref.apmm_packed``'s raw int32 product on the CPU.

The card runs the design; the CPU cannot.  So this file carries out its
steps in numpy: the prologue turns A's packed planes (n_a, M, Kw) into
each element's unsigned field u = sum_i b_i << i, then each <= 7-bit plane
group's int8 value 2 ((u >> lo) & mask) - mask, 0 at every pad column k
>= K, in the bit-sliced order (byte b of int32 j of a 32-element word
holds element 8 b + j); the GEMM takes each bit slice j of a weight plane
word as int8x4 of u = sum_i ((p_i >> j) & 0x01010101) << (i - lo) (one
group of n_b bits, or two of 4 at 8 bits), runs the __dp4a of the 8
slices of a word against the 8 int32 of X, shifts each sum by lo_a + lo_b
+ 1 (v = 2 u - maxv), and subtracts once per output the correction
(maxv_b * sum x) << (lo_a + lo_b) from each row's sum of its group values,
all modulo 2^32.  No K-pad preload: the pad columns' activations are 0.
Every (n_a, n_b) in 1..8 at odd K (pad columns in the last word), and a
weight packed wider than the activations (``ops._normalize_packed_kw``'s
extra words): bit-exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

U32 = np.uint32
BIT0 = U32(0x01010101)
M, N, K = 3, 5, 77


def _words(t):
    return t.packed.numpy().view(U32)


def prologue(ap, k):
    """xq (nga, M, Kw, 8, 4): int8 group values, X's int32 j of word w
    holding elements 32 w + 8 b + j in its bytes b; pad columns 0."""
    n_a, m, kw = ap.shape
    bits = (ap[..., None] >> np.arange(32, dtype=U32)) & U32(1)
    u = np.zeros((m, kw, 32), np.int64)
    for i in range(n_a):
        u += bits[i].astype(np.int64) << i
    live = (np.arange(kw)[:, None] * 32 + np.arange(32)[None, :]) < k
    out = []
    for lo, sz in ref.plane_groups(n_a):
        mask = (1 << sz) - 1
        v = np.where(live, ((u >> lo) & mask) * 2 - mask, 0)
        # element 8 b + j to int32 j, byte b
        out.append(v.reshape(m, kw, 4, 8).transpose(0, 1, 3, 2))
    return np.stack(out).astype(np.int8)


def weight_groups(n_b):
    """The route's weight groups: all n_b planes in one, or two of 4."""
    return [(0, 4), (4, 4)] if n_b == 8 else [(0, n_b)]


def slices(bp, lo, sz):
    """(N, Kw, 8, 4) int8x4 of u: slice j of each word, byte b the u of
    element 8 b + j."""
    w = np.zeros((8,) + bp.shape[1:], U32)
    for j in range(8):
        for i in range(lo, lo + sz):
            w[j] |= ((bp[i] >> U32(j)) & BIT0) << U32(i - lo)
    w = np.ascontiguousarray(np.moveaxis(w, 0, -1))[..., None]
    return w.view(np.uint8).astype(np.int64)


def small_m_gemm(ap, bp, k):
    """The route's int32 product of packed A (pad bit 0) and B (pad bit
    1) of one word width."""
    xq = prologue(ap, k).astype(np.int64)
    sum_x = xq.sum(axis=(2, 3, 4))                    # (nga, M)
    n_b = bp.shape[0]
    y = np.zeros((ap.shape[1], bp.shape[1]), np.int64)
    for ga, (lo_a, _) in enumerate(ref.plane_groups(ap.shape[0])):
        for lo_b, sz_b in weight_groups(n_b):
            dot = np.einsum("mwjb,nwjb->mn", xq[ga], slices(bp, lo_b, sz_b))
            y += dot << (lo_a + lo_b + 1)
            y -= (((1 << sz_b) - 1) * sum_x[ga])[:, None] << (lo_a + lo_b)
    return (y & 0xFFFFFFFF).astype(U32).view(np.int32)


def _operands(seed, n_a, n_b, extra_b_words=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32))
    a = ops.quantize_rows(x, n_a, pad_bit=0)
    b = ops.pack_weight(w, n_b)
    if extra_b_words:
        b = dataclasses.replace(b, packed=torch.cat([b.packed, torch.full(
            (n_b, N, extra_b_words), -1, dtype=torch.int32)], -1))
    return ops._normalize_packed_kw(a, b)


@pytest.mark.parametrize("n_a", range(1, 9))
@pytest.mark.parametrize("n_b", range(1, 9))
def test_small_m_route_equals_raw_core(n_a, n_b):
    a, b = _operands(n_a * 10 + n_b, n_a, n_b)
    got = small_m_gemm(_words(a), _words(b), K)
    np.testing.assert_array_equal(got, ref.apmm_packed(a, b).numpy())


@pytest.mark.parametrize("n_a,n_b", [(8, 2), (3, 5)])
def test_small_m_route_with_wider_weight_words(n_a, n_b):
    a, b = _operands(7, n_a, n_b, extra_b_words=2)
    assert a.packed.shape[-1] == b.packed.shape[-1] == -(-K // 32) + 2
    got = small_m_gemm(_words(a), _words(b), K)
    np.testing.assert_array_equal(got, ref.apmm_packed(a, b).numpy())


def test_prologue_pad_columns_are_zero():
    a, _ = _operands(1, 8, 2)
    xq = prologue(_words(a), K)
    # element e of word w sits at int32 e % 8, byte e // 8
    kw = a.packed.shape[-1]
    e = np.arange(32 * kw)
    flat = xq[:, :, e // 32, e % 8, e % 32 // 8]
    assert np.all(flat[..., K:] == 0) and np.any(flat[..., :K] != 0)
