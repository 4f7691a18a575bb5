"""The integer schedule of fused K4 (``src/repro_torch/csrc/
moe_expert_linear.cu``), emulated in numpy step by step, against the
reference package's ``moe_expert_linear`` on the CPU.

The card runs the design; the CPU cannot.  So this file carries out its
integer steps in numpy: the prologue's work list (each expert's live rows,
segment after segment, from ``counts``) and its int8 plane-group values
in the bit-sliced order (byte b of int32 j of a 32-element word holds
element 8 b + j); the weights' spread of each bit slice of the plane
words into int8 group values with the per-byte subtract
``((w | 0x80..) - maxv) ^ (~w & 0x80..)``; the chunk route's tiles of 128
MMA rows over the work list, with the two 4-bit groups of an 8-bit row in
MMA rows r and r + 8 of a fragment, its K stages of 128 elements and K
steps of 32 (zero-filled past the live rows, past K and past Kw), the
int32 sums per (activation group, weight group) and their recombination
``lo + (hi << 4)`` modulo 2^32; the decode route's per-thread quads of
plane words, its __dp4a against u (the slices before the subtract) and
its exact reduction modulo 2^32, then ``y = 2 acc - maxv sum x`` from the
prologue's per-row sums of the group values; the scatter back to the
(segment, row) places, the dead rows' zeros and the live map; and the f32
epilogue ``(acc * a_s) * b_s``.  The reference is the JAX package's
``ops.ap_moe_expert_linear`` (its ``reference`` impl, jitted; one case in
``interpret`` mode, the Pallas kernel's body), on the same activations
and the same packed weights.  Every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as JO
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro_torch.core import bipolar
from repro_torch.kernels import ref

from _torch_parity import jax_bipolar_to_torch, n, t

U32 = np.uint32
BIT0, BIT7 = U32(0x01010101), U32(0x80808080)
CH_BM, CH_BK = 128, 128          # the chunk route's MMA rows, K a stage
DEC_MR = 4                       # the decode route's work rows an item
# byte p of a 32-byte word holds element PERM[p] (int32 p // 4, byte p % 4)
PERM = np.array([8 * (p % 4) + p // 4 for p in range(32)])


def work_list(counts, seg):
    """Each expert's live capacity rows, segment after segment."""
    e, g = counts.shape
    return [[(ei * g + gi) * seg + r for gi in range(g)
             for r in range(min(max(int(counts[ei, gi]), 0), seg))]
            for ei in range(e)]


def quantize_u(x, scale, n_a):
    """u = (q + maxA) / 2 of q = clip(round_to_odd(x / s)) in f32 steps."""
    max_a = (1 << n_a) - 1
    tt = (x / scale - np.float32(1.0)) * np.float32(0.5)
    q = np.clip(np.float32(2.0) * np.rint(tt) + np.float32(1.0), -max_a,
                max_a).astype(np.int64)
    return (q + max_a) >> 1


def prologue(x, a_s, counts, n_a, kw):
    """xq (nga, E*C, Kp) int8 in the work-list order (rows never written
    hold 0x55, which no route may read) and each row's sum of its group
    values xs (nga, E*C)."""
    e, c, k = x.shape
    g = counts.shape[1]
    seg = c // g
    kp = 32 * kw
    groups = ref.plane_groups(n_a)
    xq = np.full((len(groups), e * c, kp), 0x55, np.int8)
    xs = np.zeros((len(groups), e * c), np.int32)
    xf, sf = x.reshape(e * c, k), a_s.reshape(e * c, 1)
    for ei, rows in enumerate(work_list(counts, seg)):
        for li, row in enumerate(rows):
            u = np.zeros(kp, np.int64)
            u[:k] = quantize_u(xf[row], sf[row], n_a)
            live = np.arange(kp) < k
            for ga, (lo, sz) in enumerate(groups):
                mask = (1 << sz) - 1
                v = np.where(live, (((u >> lo) & mask) << 1) - mask, 0)
                words = v.reshape(kw, 32)[:, PERM].reshape(kp)
                xq[ga, ei * c + li] = words.astype(np.int8)
                xs[ga, ei * c + li] = v.sum()
    return xq, xs


def slice_u(planes, n_b):
    """``(n_b, N, Kw)`` plane words -> ``(ngb, N, Kw, 8)`` uint32: bit
    slice j of each word as int8x4 of u (byte b: element 8 b + j), one
    shift and one mask a plane, as the kernel's ``slice_u``."""
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


def maxv_of(n_b):
    return [15, 15] if n_b == 8 else [(1 << n_b) - 1]


def spread(planes, n_b):
    """``(n_b, N, Kw)`` plane words -> ``(ngb, N, Kp)`` int8 group values
    v = 2 u - maxv, bit-sliced, through the per-byte subtract."""
    u = slice_u(planes, n_b)
    out = np.zeros_like(u)
    for gb, maxv in enumerate(maxv_of(n_b)):
        w = u[gb] << U32(1)
        out[gb] = ((w | BIT7) - U32(maxv) * BIT0) ^ (~w & BIT7)
    return out.view(np.int8).reshape(u.shape[0], u.shape[1], -1)


def _dot_i32(a, b):
    """int8 ``(R, K) x (N, K) -> (R, N)``: the s32 sums of the MMA (no
    .satfinite), each within int32."""
    y = a.astype(np.int64) @ b.astype(np.int64).T
    assert np.abs(y).max(initial=0) < 2 ** 31
    return y.astype(np.int32)


def chunk_route(xq, wsp, counts, seg, c, n_a, kp):
    """The chunk route's int32 results ``{capacity row: (N,) int32}`` of
    one expert weight's spread values ``wsp (ngb, N, Kp)``."""
    nga, ngb = xq.shape[0], wsp.shape[0]
    tr = CH_BM // nga
    out = {}
    for ei, rows in enumerate(work_list(counts, seg)):
        for t0 in range(0, len(rows), tr):
            n_live = min(tr, len(rows) - t0)
            # staged MMA rows: zero past the live rows
            a = np.zeros((CH_BM, kp), np.int8)
            for r in range(CH_BM):
                wr = (r >> 4) * 8 + (r & 7) if nga == 2 else r
                ga = (r >> 3) & 1 if nga == 2 else 0
                if wr < n_live:
                    a[r] = xq[ga, ei * c + t0 + wr]
            acc = np.zeros((ngb, CH_BM, wsp.shape[1]), np.int32)
            for k0 in range(0, kp, CH_BK):           # stages
                for ks in range(k0, min(k0 + CH_BK, kp), 32):   # MMAs
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
                out[rows[t0 + wr]] = y.view(np.int32)
    return out


def decode_route(xq, xs, planes, n_b, counts, seg, c, n_a, kw):
    """The decode route's int32 results: items of up to 4 work rows, each
    thread a quad of 4 words (128 elements), __dp4a of the X values
    against u, shifted by (lo_a + lo_b) and summed over the block modulo
    2^32; then y = 2 acc - sum maxv X << (lo_a + lo_b), the prologue's
    sums ``xs``."""
    nga = xq.shape[0]
    u = slice_u(planes, n_b).view(np.int8).reshape(-1, planes.shape[1],
                                                    32 * kw)
    lo_a = [lo for lo, _ in ref.plane_groups(n_a)]
    out = {}
    for ei, rows in enumerate(work_list(counts, seg)):
        for r0 in range(0, len(rows), DEC_MR):
            for r in range(min(DEC_MR, len(rows) - r0)):
                xrow = ei * c + r0 + r
                y = np.zeros(planes.shape[1], U32)
                corr = np.zeros(1, U32)
                for ga in range(nga):
                    for gb, maxv in enumerate(maxv_of(n_b)):
                        sh = U32(lo_a[ga] + 4 * gb)
                        for q0 in range(0, 32 * kw, 128):   # a quad
                            part = _dot_i32(xq[ga, xrow, q0:q0 + 128][None],
                                            u[gb][:, q0:q0 + 128])[0]
                            y += part.view(U32) << sh
                        corr += (np.full(1, maxv, U32)
                                 * xs[ga, xrow:xrow + 1].view(U32)) << sh
                out[rows[r0 + r]] = ((y << U32(1)) - corr).view(np.int32)
    return out


def scatter(results, a_s, w_scale, counts, seg, c, n_out):
    """The epilogue and the scatter: (acc * a_s) * b_s in f32 at each
    live row's (segment, row) place; the prologue's zeros elsewhere (an
    unwritten output would stay NaN)."""
    e = counts.shape[0]
    y = np.full((e * c, n_out), np.nan, np.float32)
    sf = a_s.reshape(e * c)
    for row, acc in results.items():
        ei = row // c
        y[row] = (acc.astype(np.float32) * sf[row]) * w_scale[ei]
    rows = np.arange(c)
    live = (rows % seg)[None, :] < counts[:, rows // seg]
    y[~live.reshape(-1)] = 0.0
    return y.reshape(e, c, n_out)


def live_map(counts, seg):
    bc = min(256, -(-seg // 8) * 8)
    n_ci = -(-seg // bc)
    return (counts.reshape(-1, 1) > bc * np.arange(n_ci)[None, :]) \
        .astype(np.int32)


def _case(e, g, seg, k, n_out, a_bits, w_bits, counts, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((e, n_out, k)) / np.sqrt(k)).astype(np.float32)
    jw = JM._quantize_leaf(jnp.asarray(w), JQ(w_bits=w_bits), stacked=False)
    tw = jax_bipolar_to_torch(jw)
    x = rng.standard_normal((e, g * seg, k)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    xb = n(t(np.asarray(jx)))                       # the bf16 values, f32
    a_s = n(bipolar.absmax_scale(torch.from_numpy(xb), a_bits, axis=-1))
    planes = tw.packed.numpy().view(U32)             # (n_b, E, N, Kw)
    return jx, jw, xb, a_s, planes, n(tw.scale)[..., 0]


def _reference(jx, jw, counts, a_bits, impl="reference"):
    y, live = JO.ap_moe_expert_linear(
        jx, jw, counts=jnp.asarray(counts), a_bits=a_bits, impl=impl,
        out_dtype=jnp.float32, with_stats=True)
    return np.asarray(y), np.asarray(live)


def _run_routes(xb, a_s, planes, w_scale, counts, a_bits, w_bits):
    e, c, k = xb.shape
    seg = c // counts.shape[1]
    kw = planes.shape[-1]
    xq, xs = prologue(xb, a_s, counts, a_bits, kw)
    outs = {}
    for name in ("chunk", "decode"):
        res = {}
        for ei in range(e):
            one = np.zeros_like(counts)
            one[ei] = counts[ei]
            if name == "chunk":
                res.update(chunk_route(xq, spread(planes[:, ei], w_bits),
                                       one, seg, c, a_bits, 32 * kw))
            else:
                res.update(decode_route(xq, xs, planes[:, ei], w_bits, one,
                                        seg, c, a_bits, kw))
        outs[name] = scatter(res, a_s, w_scale, counts, seg, c,
                             planes.shape[2])
    return outs


PAIRS = [(8, 2), (2, 8), (7, 7), (8, 8), (1, 1), (3, 5)]


@pytest.mark.parametrize("a_bits,w_bits", PAIRS)
def test_routes_bit_exact_vs_reference(a_bits, w_bits):
    """Both routes at every width pair, K = 200 (Kw = 7: a K tail in the
    last word and a last stage past Kw), segments of 70 rows (taller than
    the a8 tile of 64 work rows, so a tile runs across segments), an
    empty expert, an empty segment and a full one."""
    e, g, seg, k, n_out = 3, 2, 70, 200, 19
    counts = np.array([[70, 3], [0, 0], [41, 70]], np.int32)
    jx, jw, xb, a_s, planes, w_scale = _case(e, g, seg, k, n_out, a_bits,
                                             w_bits, counts, a_bits * 10
                                             + w_bits)
    want, live = _reference(jx, jw, counts, a_bits)
    np.testing.assert_array_equal(live, live_map(counts, seg))
    for name, got in _run_routes(xb, a_s, planes, w_scale, counts, a_bits,
                                 w_bits).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k", [37, 1000])
def test_k_tails_bit_exact_vs_interpret_kernel(k):
    """K = 37 (one word, 27 pad columns) and 1000 (Kw = 32, the 16-byte
    copies' case): both routes equal to the reference's Pallas kernel run
    in interpret mode, the live map to the one it reports."""
    e, g, seg, n_out = 3, 2, 5, 19
    counts = np.array([[5, 2], [3, 0], [1, 4]], np.int32)
    jx, jw, xb, a_s, planes, w_scale = _case(e, g, seg, k, n_out, 8, 2,
                                             counts, k)
    want, live = _reference(jx, jw, counts, 8, impl="interpret")
    np.testing.assert_array_equal(live, live_map(counts, seg))
    for name, got in _run_routes(xb, a_s, planes, w_scale, counts, 8,
                                 2).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("seg,counts", [
    (40, [[40] * 32, [0] * 32, [7, 0, 40] + [39] * 29]),   # G = 32
    (70, [[70, 70], [0, 70], [13, 0]]),                     # tall segments
    (130, [[130, 1], [0, 0], [129, 130]]),                  # > a7 tile
])
def test_work_list_tiles_cover_every_live_row_once(seg, counts):
    """The work list and its tiles: every live (segment, row) in exactly
    one tile row of its expert, in segment order; the tiles' live rows a
    prefix of each tile; empty experts and segments add no row."""
    counts = np.array(counts, np.int32)
    e, g = counts.shape
    lists = work_list(counts, seg)
    for tr in (64, 128):                      # a8 and a <= 7 work rows
        seen = []
        for ei, rows in enumerate(lists):
            n_tiles = -(-g * seg // tr)      # the grid's static tiles
            for t0 in range(0, n_tiles * tr, tr):
                tile = rows[t0:t0 + tr]
                seen += tile
                assert all(r // (g * seg) == ei for r in tile)
        want = [(ei * g + gi) * seg + r for ei in range(e)
                for gi in range(g) for r in range(counts[ei, gi])]
        assert seen == want


def test_group_recombination_wraps_modulo_2_32():
    """w8 x a8 at K = 2048: the uint32 recombination
    lo + (hi << 4) and the weight groups' << 4 leave the same int32 as
    the true integer sum modulo 2^32, and equal the reference."""
    e, g, seg, k, n_out = 2, 1, 20, 2048, 16
    counts = np.array([[20], [11]], np.int32)
    jx, jw, xb, a_s, planes, w_scale = _case(e, g, seg, k, n_out, 8, 8,
                                             counts, 7)
    xq, _ = prologue(xb, a_s, counts, 8, planes.shape[-1])
    wsp = spread(planes[:, 0], 8)
    res = chunk_route(xq, wsp, np.array([[20], [0]], np.int32), seg,
                      g * seg, 8, 32 * planes.shape[-1])
    # the true sums, in int64, from the group values
    true = sum((xq[ga, :20].astype(np.int64) @ wsp[gb].astype(np.int64).T)
               << (4 * ga + 4 * gb) for ga in range(2) for gb in range(2))
    got = np.stack([res[r] for r in range(20)])
    np.testing.assert_array_equal(got, true.astype(np.int64)
                                  .astype(np.uint64).astype(np.uint32)
                                  .view(np.int32))
    assert got.min() < 0 < got.max()
    want, _ = _reference(jx, jw, counts, 8)
    y = scatter(res, a_s, w_scale, np.array([[20], [0]], np.int32), seg,
                g * seg, n_out)
    np.testing.assert_array_equal(y[0], want[0])


def test_spread_gives_the_weights_group_values():
    """The spread's bytes, un-permuted, are each weight's group values
    2 u - (2^size - 1) of the recovered bipolar values (pad bits 1)."""
    for w_bits in (2, 7, 8):
        _, _, _, _, planes, _ = _case(1, 1, 1, 100, 9, 8, w_bits,
                                      np.ones((1, 1), np.int32), w_bits)
        p = planes[:, 0]
        wsp = spread(p, w_bits).reshape(-1, 9, p.shape[-1], 32)
        got = wsp[..., np.argsort(PERM)].reshape(-1, 9, 32 * p.shape[-1])
        vals = bipolar.recover(bipolar.unpack_planes(
            torch.from_numpy(p.view(np.int32)), -1, 32 * p.shape[-1]),
            w_bits).numpy().astype(np.int64)
        u = (vals + (1 << w_bits) - 1) >> 1
        for gb, (lo, sz) in enumerate(ref.plane_groups(w_bits)):
            mask = (1 << sz) - 1
            np.testing.assert_array_equal(got[gb], 2 * ((u >> lo) & mask)
                                          - mask)
