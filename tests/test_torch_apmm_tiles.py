"""The integer schedule of the dense chunk route of K1 and K5 (the int8
tensor-core GEMM of ``src/repro_torch/csrc/int8_mma.cuh``, launched by
``apmm_fused_linear.cu`` and ``apmm_packed.cu`` above their small-M
routes), emulated in numpy step by step, against the reference package's
``ops.ap_linear_fused`` and ``ops.ap_matmul`` on the CPU.

The card runs the design; the CPU cannot.  So this file carries out its
integer steps in numpy: the prologues' int8 plane-group values in the
bit-sliced order (byte b of int32 j of a 32-element word holds element
8 b + j) -- K1's from quantizing X, K5's from A's packed planes -- with
pad columns 0; the weights' spread of each bit slice of the plane words
into int8 group values with the per-byte subtract
``((w | 0x80..) - maxv) ^ (~w & 0x80..)``; tiles of 128 MMA rows, the two
4-bit groups of an 8-bit row in MMA rows r and r + 8 of a fragment, zero
past M; K stages of 128 elements and K steps of 32, zero-filled past K
and Kw; the int32 sums per (activation group, weight group) and their
recombination ``lo + (hi << 4)`` modulo 2^32; split-K's partial sums of
each block's stage range added modulo 2^32 in any order; and the
epilogue, ``(acc * a_s) * b_s`` in f32.  The reference is the JAX
package's ops (their ``reference`` impl, jitted; one case each in
``interpret`` mode, the Pallas kernels' bodies), on the same activations
and the same packed weights.  Every comparison is bit-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro_torch.core import bipolar
from repro_torch.kernels import ref

from _torch_parity import jax_bipolar_to_torch, n

U32 = np.uint32
BIT0, BIT7 = U32(0x01010101), U32(0x80808080)
BM, BK, BROWS = 128, 128, 128    # MMA rows, K elements a stage, spread rows
MIN_SPLIT_STAGES = 8
H100_SMS = 132
# byte p of a 32-byte word holds element PERM[p] (int32 p // 4, byte p % 4)
PERM = np.array([8 * (p % 4) + p // 4 for p in range(32)])


def quantize_u(x, scale, n_a):
    """u = (q + maxA) / 2 of q = clip(round_to_odd(x / s)) in f32 steps."""
    max_a = (1 << n_a) - 1
    tt = (x / scale - np.float32(1.0)) * np.float32(0.5)
    q = np.clip(np.float32(2.0) * np.rint(tt) + np.float32(1.0), -max_a,
                max_a).astype(np.int64)
    return (q + max_a) >> 1


def group_values(u, live, n_a, kw):
    """u ``(M, Kp)`` -> xq ``(nga, M, Kp)`` int8: each group's values
    ((u >> lo) & mask) * 2 - mask, 0 where not live, bit-sliced."""
    m, kp = u.shape
    groups = ref.plane_groups(n_a)
    xq = np.zeros((len(groups), m, kp), np.int8)
    for ga, (lo, sz) in enumerate(groups):
        mask = (1 << sz) - 1
        v = np.where(live, (((u >> lo) & mask) << 1) - mask, 0)
        xq[ga] = v.reshape(m, kw, 32)[..., PERM].reshape(m, kp)
    return xq


def xq_from_x(x, a_s, n_a, kw):
    """K1's prologue (quantize_x_kernel): X quantized once."""
    m, k = x.shape
    u = np.zeros((m, 32 * kw), np.int64)
    u[:, :k] = quantize_u(x, a_s.reshape(m, 1), n_a)
    return group_values(u, np.arange(32 * kw)[None, :] < k, n_a, kw)


def xq_from_planes(planes, k, n_a):
    """K5's prologue (packed_to_xq_kernel): u = sum_i b_i << i of each
    element from A's plane words ``(n_a, M, Kw)``."""
    _, m, kw = planes.shape
    bits = (planes[..., None] >> np.arange(32, dtype=U32)) & U32(1)
    u = sum(bits[i].astype(np.int64) << i for i in range(n_a))
    return group_values(u.reshape(m, 32 * kw),
                        np.arange(32 * kw)[None, :] < k, n_a, kw)


def slice_u(planes, n_b):
    """``(n_b, N, Kw)`` plane words -> ``(ngb, N, Kw, 8)`` uint32: bit
    slice j of each word as int8x4 of u (byte b: element 8 b + j)."""
    ngb = 2 if n_b == 8 else 1
    nn, kw = planes.shape[1:]
    out = np.zeros((ngb, nn, kw, 8), U32)
    for gb in range(ngb):
        lo, sz = (4 * gb, 4) if ngb == 2 else (0, n_b)
        for j in range(8):
            for i in range(lo, lo + sz):
                out[gb, :, :, j] |= ((planes[i] >> U32(j)) & BIT0) \
                    << U32(i - lo)
    return out


def spread(planes, n_b):
    """``(n_b, N, Kw)`` plane words -> ``(ngb, N, Kp)`` int8 group values
    v = 2 u - maxv, bit-sliced, through the per-byte subtract
    (``spread_slice``)."""
    u = slice_u(planes, n_b)
    out = np.zeros_like(u)
    maxvs = [15, 15] if n_b == 8 else [(1 << n_b) - 1]
    for gb, maxv in enumerate(maxvs):
        w = u[gb] << U32(1)
        out[gb] = ((w | BIT7) - U32(maxv) * BIT0) ^ (~w & BIT7)
    return out.view(np.int8).reshape(u.shape[0], u.shape[1], -1)


def _dot_i32(a, b):
    """int8 ``(R, 32) x (N, 32) -> (R, N)``: one MMA step's s32 sums."""
    y = a.astype(np.int64) @ b.astype(np.int64).T
    assert np.abs(y).max(initial=0) < 2 ** 31
    return y.astype(np.int32)


def dense_splits(m, n_out, kw, n_a, n_b, nw, n_sm=H100_SMS):
    """The C entry's K splits (``int8mma::dense_splits``): 1 where the grid
    fills the card, else enough for two blocks an SM, at most n_st /
    MIN_SPLIT_STAGES, none empty."""
    nga, ngb = (2 if n_a == 8 else 1), (2 if n_b == 8 else 1)
    tr, bn = BM // nga, BROWS // (nw * ngb)
    blocks = -(-m // tr) * -(-n_out // bn)
    if blocks >= n_sm:
        return 1
    n_st = -(-kw // (BK // 32))
    splits = min(-(-2 * n_sm // blocks), n_st // MIN_SPLIT_STAGES)
    if splits < 1:
        return 1
    per = -(-n_st // splits)
    return -(-n_st // per)


def chunk_gemm(xq, wsp, m, splits, order=None):
    """The dense route's int32 results ``(M, N)`` of one weight's spread
    values ``wsp (ngb, N, Kp)``: row tiles of 128 MMA rows, each split's
    stage range multiplied in K steps of 32 and recombined in uint32, the
    partials added modulo 2^32 (``order``: the splits' order of arrival)."""
    nga, ngb, kp = xq.shape[0], wsp.shape[0], xq.shape[2]
    tr = BM // nga
    n_st = -(-kp // BK)
    per = -(-n_st // splits)
    out = np.zeros((m, wsp.shape[1]), U32)
    for m0 in range(0, m, tr):
        n_live = min(tr, m - m0)
        a = np.zeros((BM, kp), np.int8)          # staged MMA rows
        for r in range(BM):
            wr = (r >> 4) * 8 + (r & 7) if nga == 2 else r
            ga = (r >> 3) & 1 if nga == 2 else 0
            if wr < n_live:
                a[r] = xq[ga, m0 + wr]
        total = np.zeros((n_live, wsp.shape[1]), U32)
        for z in (order or range(splits)):
            acc = np.zeros((ngb, BM, wsp.shape[1]), np.int32)
            for st in range(z * per, min(n_st, (z + 1) * per)):
                for ks in range(st * BK, min(st * BK + BK, kp), 32):
                    for gb in range(ngb):
                        acc[gb] += _dot_i32(a[:, ks:ks + 32],
                                            wsp[gb][:, ks:ks + 32])
            accu = acc.view(U32)
            for wr in range(n_live):
                if nga == 2:
                    f, h = divmod(wr, 8)
                    v = accu[:, 16 * f + h] + (accu[:, 16 * f + h + 8]
                                               << U32(4))
                else:
                    v = accu[:, wr]
                y = v[0] if ngb == 1 else v[0] + (v[1] << U32(4))
                total[wr] += y                    # atomicAdd, modulo 2^32
        out[m0:m0 + n_live] = total
    return out.view(np.int32)


def dequant(acc, a_s, b_s):
    """``(acc * a_s) * b_s`` in f32, two roundings."""
    return (acc.astype(np.float32) * a_s.reshape(-1, 1).astype(np.float32)) \
        * b_s.reshape(1, -1).astype(np.float32)


def _weight(rng, n_out, k, w_bits):
    w = rng.standard_normal((n_out, k)).astype(np.float32)
    jw = JO.pack_weight(jnp.asarray(w), w_bits)
    tw = jax_bipolar_to_torch(jw)
    return jw, tw.packed.numpy().view(U32), n(tw.scale).reshape(-1)


def _k1_case(m, n_out, k, a_bits, w_bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    a_s = n(bipolar.absmax_scale(torch.from_numpy(x), a_bits, axis=-1))
    jw, planes, b_s = _weight(rng, n_out, k, w_bits)
    return x, a_s, jw, planes, b_s


def _k1_reference(x, jw, a_bits, impl="reference", jit=True, **kw):
    """The reference's f32 output; ``jit=False`` runs it op by op, where
    XLA cannot contract a multiply and an add into an FMA."""
    def fn(xx):
        return JO.ap_linear_fused(xx, jw, a_bits=a_bits, impl=impl,
                                  out_dtype=jnp.float32, **kw)
    return np.asarray((jax.jit(fn) if jit else fn)(jnp.asarray(x)))


def _k1_route(x, a_s, planes, b_s, a_bits, w_bits, splits=None):
    m = x.shape[0]
    kw = planes.shape[-1]
    xq = xq_from_x(x, a_s, a_bits, kw)
    if splits is None:
        splits = dense_splits(m, planes.shape[1], kw, a_bits, w_bits, 1)
    acc = chunk_gemm(xq, spread(planes, w_bits), m, splits)
    return acc, dequant(acc, a_s, b_s)


PAIRS = [(8, 2), (8, 8), (4, 3), (3, 5), (2, 8), (1, 1)]


@pytest.mark.parametrize("a_bits,w_bits", PAIRS)
@pytest.mark.parametrize("m", [65, 129])
def test_k1_chunk_route_bit_exact_vs_reference(a_bits, w_bits, m):
    """K1's chunk route at every width pair: M 65 (one a8 tile and a
    one-row tile; half an a <= 7 tile) and 129 (a tile's first row past
    128), K = 200 (Kw = 7: a K tail in the last word, a stage past Kw),
    N = 19; f32 out equal to the reference's."""
    x, a_s, jw, planes, b_s = _k1_case(m, 19, 200, a_bits, w_bits,
                                       m * 100 + a_bits * 10 + w_bits)
    _, got = _k1_route(x, a_s, planes, b_s, a_bits, w_bits)
    np.testing.assert_array_equal(got, _k1_reference(x, jw, a_bits))


def test_k1_chunk_route_dual_bias_residual_vs_reference():
    """The dual gate/up (act none: act(Y1) * Y2 with f32 casts), a bias and
    a residual on the chunk route's two int32 sums, f32 out (the reference
    op by op: the kernel's epilogue contracts no FMA)."""
    m, n_out, k = 70, 21, 300
    x, a_s, jw, planes, b_s = _k1_case(m, n_out, k, 8, 2, 3)
    rng = np.random.default_rng(4)
    jw2, planes2, b2_s = _weight(rng, n_out, k, 2)
    bias = rng.standard_normal(n_out).astype(np.float32)
    res = rng.standard_normal((m, n_out)).astype(np.float32)
    acc1, _ = _k1_route(x, a_s, planes, b_s, 8, 2)
    acc2, _ = _k1_route(x, a_s, planes2, b2_s, 8, 2)
    y1 = dequant(acc1, a_s, b_s) + bias[None, :]
    got = y1 * dequant(acc2, a_s, b2_s) + res
    want = _k1_reference(x, jw, 8, jit=False, w2=jw2,
                         bias=jnp.asarray(bias), residual=jnp.asarray(res))
    np.testing.assert_array_equal(got, want)


def test_k1_chunk_route_bit_exact_vs_interpret_kernel():
    """K = 37 (one word, 27 pad columns), M 70: equal to the reference's
    Pallas kernel run in interpret mode."""
    x, a_s, jw, planes, b_s = _k1_case(70, 19, 37, 8, 2, 37)
    _, got = _k1_route(x, a_s, planes, b_s, 8, 2)
    np.testing.assert_array_equal(
        got, _k1_reference(x, jw, 8, impl="interpret"))


def _k5_case(m, n_out, k, a_bits, w_bits, seed, extra_words=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ja = JO.quantize_rows(jnp.asarray(x), a_bits, pad_bit=0)
    jb, planes, _ = _weight(rng, n_out, k, w_bits)
    if extra_words:                    # a weight packed wider than A
        kw = jb.packed.shape[-1] + extra_words
        jb = dataclasses.replace(
            jb, packed=JO._pad_dim(jb.packed, 2, kw, 0xFFFFFFFF))
    ja, jb = JO._normalize_packed_kw(ja, jb)
    ta, tb = jax_bipolar_to_torch(ja), jax_bipolar_to_torch(jb)
    return (ja, jb, ta.packed.numpy().view(U32), tb.packed.numpy().view(U32),
            n(ta.scale).reshape(-1), n(tb.scale).reshape(-1))


def _k5_route(a_planes, b_planes, k, a_bits, w_bits, splits=None):
    m = a_planes.shape[1]
    if splits is None:
        splits = dense_splits(m, b_planes.shape[1], b_planes.shape[-1],
                              a_bits, w_bits, 1)
    return chunk_gemm(xq_from_planes(a_planes, k, a_bits),
                      spread(b_planes, w_bits), m, splits)


@pytest.mark.parametrize("a_bits,w_bits", PAIRS)
def test_k5_chunk_route_bit_exact_vs_reference(a_bits, w_bits):
    """K5's chunk route at every width pair, M 129, K 200, a weight packed
    two words wider than A (A normalized to its Kw): the raw int32 product
    and the f32 dequant equal to the reference's."""
    m, n_out, k = 129, 19, 200
    ja, jb, ap, bp, a_s, b_s = _k5_case(m, n_out, k, a_bits, w_bits,
                                        a_bits * 10 + w_bits, extra_words=2)
    acc = _k5_route(ap, bp, k, a_bits, w_bits)
    raw = jax.jit(lambda a, b: JO.ap_matmul(a, b, raw=True,
                                            impl="reference"))(ja, jb)
    np.testing.assert_array_equal(acc, np.asarray(raw))
    deq = jax.jit(lambda a, b: JO.ap_matmul(a, b, impl="reference",
                                            out_dtype=jnp.float32))(ja, jb)
    np.testing.assert_array_equal(dequant(acc, a_s, b_s), np.asarray(deq))


def test_k5_chunk_route_bit_exact_vs_interpret_kernel():
    """K5 at K = 1000 (Kw = 32, the 16-byte copies' case), M 70: the raw
    product equal to the reference's Pallas kernel in interpret mode."""
    m, n_out, k = 70, 19, 1000
    ja, jb, ap, bp, _, _ = _k5_case(m, n_out, k, 8, 2, 1000)
    acc = _k5_route(ap, bp, k, 8, 2)
    raw = JO.ap_matmul(ja, jb, raw=True, impl="interpret")
    np.testing.assert_array_equal(acc, np.asarray(raw))


@pytest.mark.parametrize("a_bits", range(1, 9))
def test_prologues_give_the_activations_group_values(a_bits):
    """K1's quantize and K5's conversion of A's planes write the same
    bit-sliced int8 values, and un-permuted they are each element's group
    values 2 ((u >> lo) & mask) - mask of the reference's quantized
    activation (pad columns 0)."""
    m, k = 9, 100
    rng = np.random.default_rng(a_bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ja = JO.quantize_rows(jnp.asarray(x), a_bits, pad_bit=0)
    ta = jax_bipolar_to_torch(ja)
    kw = ta.packed.shape[-1]
    a_s = n(bipolar.absmax_scale(torch.from_numpy(x), a_bits, axis=-1))
    from_x = xq_from_x(x, a_s, a_bits, kw)
    from_planes = xq_from_planes(ta.packed.numpy().view(U32), k, a_bits)
    np.testing.assert_array_equal(from_x, from_planes)
    vals = bipolar.recover(bipolar.unpack_planes(ta.packed, -1, 32 * kw),
                           a_bits).numpy().astype(np.int64)
    u = (vals + (1 << a_bits) - 1) >> 1
    got = from_x.reshape(-1, m, kw, 32)[..., np.argsort(PERM)].reshape(
        -1, m, 32 * kw)
    for ga, (lo, sz) in enumerate(ref.plane_groups(a_bits)):
        mask = (1 << sz) - 1
        want = np.where(np.arange(32 * kw) < k,
                        2 * ((u >> lo) & mask) - mask, 0)
        np.testing.assert_array_equal(got[ga], want)


@pytest.mark.parametrize("w_bits", range(1, 9))
def test_spread_gives_the_weights_group_values(w_bits):
    """The spread's bytes, un-permuted, are each weight's group values
    2 u - (2^size - 1) of the recovered bipolar values (pad bits 1)."""
    rng = np.random.default_rng(w_bits)
    _, planes, _ = _weight(rng, 9, 100, w_bits)
    kw = planes.shape[-1]
    wsp = spread(planes, w_bits).reshape(-1, 9, kw, 32)
    got = wsp[..., np.argsort(PERM)].reshape(-1, 9, 32 * kw)
    vals = bipolar.recover(bipolar.unpack_planes(
        torch.from_numpy(planes.view(np.int32)), -1, 32 * kw),
        w_bits).numpy().astype(np.int64)
    u = (vals + (1 << w_bits) - 1) >> 1
    for gb, (lo, sz) in enumerate(ref.plane_groups(w_bits)):
        mask = (1 << sz) - 1
        np.testing.assert_array_equal(got[gb], 2 * ((u >> lo) & mask)
                                      - mask)


@pytest.mark.parametrize("splits,order", [(1, None), (2, None), (3, (2, 0, 1)),
                                          (7, (6, 3, 0, 5, 1, 4, 2))])
def test_split_k_partial_sums_add_modulo_2_32(splits, order):
    """w8 x a8 at K = 4096 (32 stages), M 70: each split's int32 partial
    sums, recombined in uint32 and added in any order modulo 2^32, equal
    the unsplit result, the true integer sum modulo 2^32 and, dequantized,
    the reference."""
    m, n_out, k = 70, 16, 4096
    x, a_s, jw, planes, b_s = _k1_case(m, n_out, k, 8, 8, 11)
    xq = xq_from_x(x, a_s, 8, planes.shape[-1])
    wsp = spread(planes, 8)
    acc = chunk_gemm(xq, wsp, m, splits, order)
    true = sum((xq[ga].astype(np.int64) @ wsp[gb].astype(np.int64).T)
               << (4 * ga + 4 * gb) for ga in range(2) for gb in range(2))
    np.testing.assert_array_equal(
        acc, true.astype(np.uint64).astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(acc, chunk_gemm(xq, wsp, m, 1))
    np.testing.assert_array_equal(dequant(acc, a_s, b_s),
                                  _k1_reference(x, jw, 8))


@pytest.mark.parametrize("shape,splits", [
    ((256, 2048, 342, 8, 3, 1), 5),      # deepseek's chunk dense down
    ((256, 3584, 592, 8, 2, 1), 3),      # qwen2-vl's chunk down
    ((256, 3352, 24, 8, 4, 1), 1),       # mamba2's in_proj: K too short
    ((1024, 14336, 128, 8, 2, 2), 1),    # llama's chunk gate/up
    ((65, 70, 342, 8, 2, 1), 10),        # K1's first chunk M, a thin N
])
def test_dense_splits_cover_every_stage_once(shape, splits):
    """The split plan at the path shapes: thin grids split K, each split a
    nonempty range of stages (all but the last at least
    MIN_SPLIT_STAGES), together every stage of K exactly once."""
    m, n_out, kw, n_a, n_b, nw = shape
    got = dense_splits(m, n_out, kw, n_a, n_b, nw)
    assert got == splits
    n_st = -(-kw // 4)
    per = -(-n_st // got)
    ranges = [range(z * per, min(n_st, (z + 1) * per)) for z in range(got)]
    assert all(len(r) > 0 for r in ranges)
    assert got == 1 or min(len(r) for r in ranges[:-1]) >= MIN_SPLIT_STAGES
    assert [s for r in ranges for s in r] == list(range(n_st))


def test_rows_past_m_and_k_past_kw_are_zero_filled():
    """A row tile past M stages zero rows, columns past K are 0 in the
    prologue's values and a stage past Kp is zero-filled: they add nothing
    to any sum (M 3 of a 64-row tile; K 37: Kw 2, 27 pad columns, the only
    stage 64 bytes past Kp)."""
    m, n_out, k = 3, 19, 37
    x, a_s, jw, planes, b_s = _k1_case(m, n_out, k, 8, 2, 5)
    kw = planes.shape[-1]
    xq = xq_from_x(x, a_s, 8, kw)
    by_col = xq.reshape(2, m, kw, 32)[..., np.argsort(PERM)].reshape(
        2, m, 32 * kw)
    assert (by_col[..., k:] == 0).all() and (by_col[..., :k] != 0).any()
    wsp = spread(planes, 2)
    acc = chunk_gemm(xq, wsp, m, 1)
    true = (xq[0].astype(np.int64) @ wsp[0].astype(np.int64).T) \
        + ((xq[1].astype(np.int64) @ wsp[0].astype(np.int64).T) << 4)
    np.testing.assert_array_equal(acc, true.astype(np.int32))
    np.testing.assert_array_equal(dequant(acc, a_s, b_s),
                                  _k1_reference(x, jw, 8))
