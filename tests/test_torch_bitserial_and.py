"""The integer arithmetic of the bit-serial core's ``.and.popc`` design
(``src/repro_torch/csrc/bitserial_core.cuh``), emulated in numpy word by
word, against the reference package's bitserial integer core.

The card runs the design; the CPU cannot.  So this file carries out its
integer steps in numpy on the packed words: the prologue's packing (one
bit of each element per plane word, pad bit 0) and SU, the per-pair
``popc(u_i & w_j)`` of each 256-bit K step, SW from the weight words,
the constant ``C0 = (2 Kp - K) maxA maxB``, both routes' recovery -- the
rows route's per-K-step diagonal chaining and the stacked route's
(plane, row) stacking with K slices summed and shift-added after the K
loop -- and the wrap modulo 2^32, then
``Y = C0 + 4 P - 2 maxB SU - 2 maxA SW``.  The reference is the JAX
package's bitserial GEMM on the same packed operands
(``ops.ap_matmul(raw=True, variant="bitserial")``, its jnp path as
``tests/test_torch_bitserial.py`` runs it with ``impl="reference"``,
jitted), and its packer for the prologue's words.  Every comparison is bit-exact.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.kernels import ops as JO

PAIRS = [(1, 1), (2, 8), (8, 2), (8, 8), (3, 5)]
KSTEP = 8                      # words of a 256-bit MMA K step
U32 = np.uint32


def _popc(a):
    return np.bitwise_count(a).astype(U32)


def _pair_popc(a, b):
    """``(R, W) x (N, W) -> (R, N)``: sum over words of popc(a & b), the
    b1 MMA's .and.popc."""
    return _popc(a[:, None, :] & b[None, :, :]).sum(-1, dtype=U32)


def _steps(planes):
    """``(n, R, Kw)`` words -> K steps ``(n, R, n_steps, 8)``; the last
    step's words past Kw are zero (the staging's zero fill)."""
    kw = planes.shape[-1]
    pad = -kw % KSTEP
    p = np.pad(planes, ((0, 0), (0, 0), (0, pad)))
    return p.reshape(p.shape[0], p.shape[1], -1, KSTEP)


def _recover(p, su, sw, k, kw, n_a, n_b):
    """Y = C0 + 4 P - 2 maxB SU - 2 maxA SW, modulo 2^32, as int32."""
    max_a, max_b = (1 << n_a) - 1, (1 << n_b) - 1
    c0 = U32(((2 * 32 * kw - k) * max_a * max_b) % (1 << 32))
    y = (c0 + (p << U32(2)) - ((U32(max_b) * su[:, None]) << U32(1))
         - ((U32(max_a) * sw[None, :]) << U32(1)))
    return y.astype(U32).view(np.int32)


def _sw(b):
    """SW of each output channel: sum_j 2^j popc(w_j) over its words."""
    return sum(_popc(b[j]).sum(-1, dtype=U32) << U32(j)
               for j in range(b.shape[0]))


def rows_route(a, b, su, k):
    """The rows route: per K step and diagonal s = i + j the pairs'
    popcounts chained, acc += d << s; SW from the weight words."""
    n_a, n_b, kw = a.shape[0], b.shape[0], a.shape[-1]
    sa, sb = _steps(a), _steps(b)
    acc = np.zeros((a.shape[1], b.shape[1]), U32)
    for ks in range(sa.shape[2]):
        for s in range(n_a + n_b - 1):
            d = np.zeros_like(acc)
            for i in range(max(0, s - n_b + 1), min(s, n_a - 1) + 1):
                d += _pair_popc(sa[i, :, ks], sb[s - i, :, ks])
            acc += d << U32(s)
    return _recover(acc, su, _sw(b), k, kw, n_a, n_b)


def stacked_route(a, b, su, k, *, mr, ksplit):
    """The stacked route: rows in groups of ``mr``; a group's (plane i,
    row m) pairs fill staged row i * mr + m (padded to whole 16-row
    fragments), each K slice (the K steps ks % ksplit == kq) sums
    ``popc << j`` per weight plane j, the slices add, and each output is
    recovered once: P = sum_i 2^i acc[i * mr + m]."""
    n_a, n_b, kw = a.shape[0], b.shape[0], a.shape[-1]
    m_rows, n = a.shape[1], b.shape[1]
    sb = _steps(b)
    p = np.zeros((m_rows, n), U32)
    for m0 in range(0, m_rows, mr):
        rows = min(mr, m_rows - m0)
        sr = 16 * -(-(n_a * mr) // 16)
        stacked = np.zeros((sr, kw), U32)
        for i in range(n_a):
            stacked[i * mr:i * mr + rows] = a[i, m0:m0 + rows]
        ss = _steps(stacked[None])[0]
        acc = np.zeros((sr, n), U32)
        for kq in range(ksplit):
            part = np.zeros_like(acc)
            for ks in range(kq, ss.shape[1], ksplit):
                for j in range(n_b):
                    part += _pair_popc(ss[:, ks], sb[j, :, ks]) << U32(j)
            acc += part
        for i in range(n_a):
            p[m0:m0 + rows] += acc[i * mr:i * mr + rows] << U32(i)
    return _recover(p, su, _sw(b), k, kw, n_a, n_b)


def prologue(x, scale, n_a, kw):
    """The prologue: per element u = (q + maxA) / 2 of its bipolar value
    (0, that is -maxA, past K); plane i's word w holds bit i of elements
    32 w .. 32 w + 31 at bits 0 .. 31 (one lane each, a ballot); SU the
    row's sum of u."""
    m, k = x.shape
    max_a = (1 << n_a) - 1
    t = (x / scale - np.float32(1.0)) * np.float32(0.5)
    q = np.clip(np.float32(2.0) * np.rint(t) + np.float32(1.0), -max_a,
                max_a).astype(np.int64)
    u = np.zeros((m, 32 * kw), np.int64)
    u[:, :k] = (q + max_a) >> 1
    lanes = u.reshape(m, kw, 32)
    shifts = np.arange(32, dtype=np.uint64)
    planes = np.stack([(((lanes >> i) & 1).astype(np.uint64) << shifts)
                       .sum(-1).astype(U32) for i in range(n_a)])
    return planes, u.sum(-1).astype(U32)


@functools.cache
def _case(a_bits, w_bits, k):
    """Seeded operands at M = 17, N = 23 and the reference's raw
    bitserial product; smaller M are their leading rows (each row of the
    product depends on its own row alone)."""
    rng = np.random.default_rng(a_bits * 100 + w_bits * 10 + k)
    x = (rng.standard_normal((17, k)) * 2).astype(np.float32)
    w = rng.standard_normal((23, k)).astype(np.float32)

    @jax.jit
    def ref(x, w):
        ja = JO.quantize_rows(x, a_bits, pad_bit=0, impl="reference")
        jb = JO.quantize_rows(w, w_bits, pad_bit=1, impl="reference")
        return ja.scale, ja.packed, jb.packed, JO.ap_matmul(
            ja, jb, raw=True, variant="bitserial", impl="reference")

    scale, pa, pb, want = ref(jnp.asarray(x), jnp.asarray(w))
    return (x, np.asarray(scale), np.asarray(pa).view(U32),
            np.asarray(pb).view(U32), np.asarray(want))


@pytest.mark.parametrize("m", [1, 4, 5, 17])
@pytest.mark.parametrize("k", [1000, 4096])
@pytest.mark.parametrize("a_bits,w_bits", PAIRS)
def test_and_popc_core_bit_exact_vs_reference(a_bits, w_bits, k, m):
    x, scale, a, b, want = _case(a_bits, w_bits, k)
    kw = a.shape[-1]
    x, scale, a, want = x[:m], scale[:m], a[:, :m], want[:m]
    # the prologue packs the reference's words and sums U
    planes, su = prologue(x, scale, a_bits, kw)
    np.testing.assert_array_equal(planes, a)
    # SU is also sum_i 2^i popc(u_i) (K5's all-ones B fragment)
    su_words = sum(_popc(a[i]).sum(-1, dtype=U32) << U32(i)
                   for i in range(a_bits))
    np.testing.assert_array_equal(su, su_words)
    np.testing.assert_array_equal(rows_route(a, b, su, k), want)
    mr = min(m, 64 // a_bits)          # the C entry's rows per block
    for ksplit in (1, 4, 8):
        np.testing.assert_array_equal(
            stacked_route(a, b, su, k, mr=mr, ksplit=ksplit), want)


@pytest.mark.parametrize("m", [4, 5, 17])
@pytest.mark.parametrize("a_bits,w_bits", PAIRS)
def test_and_popc_core_dead_rows_leave_live_rows_exact(a_bits, w_bits, m):
    """K4's segments: the prologue skips rows at or past the count (their
    words are staged as zeros and their SU is 0), so they share the
    stacked fragments with live rows; the live rows stay bit-exact and
    the dead rows' recovered values are discarded (the epilogue writes
    zeros)."""
    x, scale, a, b, want = _case(a_bits, w_bits, 1000)
    count = m - 2
    a = a[:, :m].copy()
    a[:, count:] = 0
    _, su = prologue(x[:m], scale[:m], a_bits, a.shape[-1])
    su[count:] = 0
    mr = min(m, 64 // a_bits)
    for y in (rows_route(a, b, su, 1000),
              stacked_route(a, b, su, 1000, mr=mr, ksplit=4)):
        np.testing.assert_array_equal(y[:count], want[:count])


def test_modulo_2_32_wrap_matches_int32():
    """w8 x a8 at K = 4096: the recovery's uint32 arithmetic wraps below
    zero wherever Y is negative, and it still equals the reference's
    int32 (which wraps the same way) at every output."""
    x, scale, a, b, want = _case(8, 8, 4096)
    _, su = prologue(x, scale, 8, a.shape[-1])
    p = sum(_pair_popc(a[i], b[j]).astype(np.int64) << (i + j)
            for i in range(8) for j in range(8))
    c0 = (2 * 32 * a.shape[-1] - 4096) * 255 * 255
    y = (c0 + 4 * p - 2 * 255 * su.astype(np.int64)[:, None]
         - 2 * 255 * _sw(b).astype(np.int64)[None, :])
    assert y.min() < 0 < y.max()
    np.testing.assert_array_equal(y, want)
    np.testing.assert_array_equal(rows_route(a, b, su, 4096), want)
