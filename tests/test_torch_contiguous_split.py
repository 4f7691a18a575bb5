"""The plain version of K6's split plan: ``ref.kv_cache_attention_split``
cuts the contiguous ring's tiles of 32 slots into ranges of ``ceil(tiles /
splits)`` tiles, computes each range's f32 partials ``(m, l, acc)`` and
combines them as the kernel's combine does (``csrc/split_kv.cuh``).

It is held against the unsplit plain version ``ref.kv_cache_attention``
at 2e-6 absolute on f32 outputs of magnitude ~1 (only the f32 summation
order differs), and with bf16 queries within one bf16 ulp (2^-7
relative: the same f32 values, rounded once to bf16, may land on either
side of a rounding boundary) or 2e-6; and against the reference JAX
``flash_attention_quantized`` (``ops.kv_cache_attention`` in
``interpret`` mode, the Pallas body itself) at the unsplit comparison's
2e-6 (``test_torch_unfused.py``).  With one range it gives the unsplit
version's bits.

The ring (T = 232: 8 tiles, the last one 8 slots long) holds in row 0
positions 0..149 in slots 0..149 and empty slots after (ranges of empty
slots); in row 1 positions 300..531 at slot pos % T (a ring that
wrapped: slot order is not position order); in row 2 positions 0..199 of
a prompt while its queries sit at 40..42 (ranges in the causal future),
and a padded query row (fully masked: exactly 0).  Split counts 1, 2, 7
and T / 32 (one tile a range), with and without a 50-token window.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as JO
from repro_torch.kernels import flash_attention, ref

from _torch_parity import n, t

B, T, H, SQ, D = 3, 232, 2, 4, 40
TILES = -(-T // 32)


def _inputs(rng, bits=8, dtype=np.float32):
    """Ring inputs in K6's own layout: q (B, H, Sq, D), planes (B, T, H,
    n_bits, Dw), scales (B, T, H, 1), q_pos (B, Sq), kv_pos (B, T)."""
    kv = jnp.asarray(rng.standard_normal((2, B, T, H, D)), jnp.float32)
    kq, ks = JO.quantize_kv(kv[0], bits)
    vq, vs = JO.quantize_kv(kv[1], bits)
    kv_pos = np.full((B, T), -1, np.int32)
    kv_pos[0, :150] = np.arange(150)
    pos = np.arange(300, 300 + T)
    kv_pos[1, pos % T] = pos
    kv_pos[2, :200] = np.arange(200)
    q_pos = np.stack([np.arange(146, 150), np.arange(528, 532),
                      np.array([-1, 40, 41, 42])]).astype(np.int32)
    q = rng.standard_normal((B, H, SQ, D)).astype(dtype)
    return (q, np.asarray(kq), np.asarray(ks), np.asarray(vq),
            np.asarray(vs), q_pos, kv_pos)


def _torch(args, dtype=None):
    q, *rest = args
    return [t(q, dtype)] + [t(a) for a in rest]


def _close(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-6)
    else:
        np.testing.assert_allclose(n(got.float()), n(want.float()),
                                   rtol=2 ** -7, atol=2e-6)


@pytest.mark.parametrize("splits", [1, 2, 7, TILES])
@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_matches_unsplit(splits, window, dtype):
    rng = np.random.default_rng(splits + (window or 0))
    args = _torch(_inputs(rng), dtype)
    before = flash_attention.QUANTIZED_LAUNCHES
    got = ref.kv_cache_attention_split(*args, splits=splits, d=D,
                                       window=window)
    want = ref.kv_cache_attention(*args, d=D, window=window)
    assert got.dtype == dtype and got.shape == (B, H, SQ, D)
    _close(got, want, dtype)
    assert torch.all(got[2, :, 0] == 0)          # the padded query row
    assert flash_attention.QUANTIZED_LAUNCHES == before


@pytest.mark.parametrize("splits", [2, 7])
@pytest.mark.parametrize("window", [None, 50])
def test_split_matches_reference_pallas_kernel_interpret(splits, window):
    """The reference kernel runs in the folded layout (heads in the
    batch): the same cache folded."""
    rng = np.random.default_rng(20 + splits)
    args = _inputs(rng)
    q, kq, ks, vq, vs, q_pos, kv_pos = args
    fold = [np.asarray(ref.fold_kv_heads(t(a))) for a in (kq, ks, vq, vs)]
    want = JO.kv_cache_attention(
        jnp.asarray(q.reshape(B * H, SQ, D)), *map(jnp.asarray, fold),
        jnp.asarray(np.repeat(q_pos, H, 0)),
        jnp.asarray(np.repeat(kv_pos, H, 0)), d=D, window=window,
        impl="interpret")
    got = ref.kv_cache_attention_split(*_torch(args), splits=splits, d=D,
                                       window=window)
    np.testing.assert_allclose(n(got).reshape(B * H, SQ, D),
                               np.asarray(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_range_gives_unsplit_bits(window, dtype):
    rng = np.random.default_rng(4)
    args = _torch(_inputs(rng), dtype)
    got = ref.kv_cache_attention_split(*args, splits=1, d=D, window=window)
    want = ref.kv_cache_attention(*args, d=D, window=window)
    assert torch.equal(got, want)


@pytest.mark.parametrize("splits", [2, 7, TILES])
def test_ranges_no_row_sees_contribute_nothing(splits):
    """Row 0's tiles past position 149 are empty, row 2's tiles 2..7 hold
    positions past its queries (causal future), and row 1's window (50)
    leaves its tiles before position 482 unseen: K/V planes and scales
    replaced by other values there leave the split output bit for bit
    as it was."""
    rng = np.random.default_rng(6)
    args = _inputs(rng)
    q, kq, ks, vq, vs, q_pos, kv_pos = args
    seen = np.zeros((B, T), bool)
    for row in range(B):
        qp = q_pos[row][q_pos[row] >= 0]
        ok = (kv_pos[row] >= 0) & (kv_pos[row] <= qp.max()) & \
            (kv_pos[row] > qp.min() - 50)
        for tile in range(TILES):
            seen[row, tile * 32:(tile + 1) * 32] = ok[tile * 32:
                                                      (tile + 1) * 32].any()
    assert not seen.all() and seen.any()
    other = _inputs(np.random.default_rng(7))
    mixed = [np.where(seen.reshape(B, T, *([1] * (a.ndim - 2))), a, b)
             for a, b in zip((kq, ks, vq, vs), other[1:5])]
    base = ref.kv_cache_attention_split(*_torch(args), splits=splits, d=D,
                                        window=50)
    swapped = ref.kv_cache_attention_split(
        *_torch((q, *mixed, q_pos, kv_pos)), splits=splits, d=D, window=50)
    assert torch.equal(base, swapped)


def test_every_range_empty_gives_zeros():
    rng = np.random.default_rng(8)
    args = list(_inputs(rng))
    args[6] = np.full_like(args[6], -1)          # every ring slot empty
    for splits in (1, 2, 7, TILES):
        got = ref.kv_cache_attention_split(*_torch(args), splits=splits,
                                           d=D)
        assert np.all(n(got) == 0)


def test_ring_wrapper_on_cpu_runs_the_unsplit_plain_version():
    rng = np.random.default_rng(9)
    args = _torch(_inputs(rng), torch.bfloat16)
    before = flash_attention.QUANTIZED_LAUNCHES
    got = flash_attention.flash_attention_quantized(*args, d=D, window=50)
    assert torch.equal(got, ref.kv_cache_attention(*args, d=D, window=50))
    assert flash_attention.QUANTIZED_LAUNCHES == before
