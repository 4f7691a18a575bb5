"""The plain version of K7's split-KV decomposition (flash-decoding):
``ref.flash_attention_split`` computes each range of T's f32 partials
``(m, l, acc)`` and combines them.  It is held against the port's plain
float attention (``ref.flash_attention``) at 2e-6 absolute on f32
outputs of magnitude ~1 (the split changes only the f32 summation
order), and against the reference JAX ``flash_attention`` kernel in
interpret mode at the tolerance of the unsplit comparison in
``test_torch_unfused.py`` (2e-6 in f32; 1.6e-2, 1 bf16 ulp, in bf16,
where the reference rounds p to bf16 before P.V and the port keeps f32).

Cases: split counts 1, 2, 7 and T / 32; a range that no query row may see
(empty ring slots, and the causal future); a fully masked row (exactly
0); a sliding window; a ring that wrapped.  The kernel's own ranges
(``tile=ref.FLOAT_TILE``: whole 64-slot tiles a range, the card's exact
decomposition at ``float_splits``' count) at a decode shape whose last
tile is short (T 200, Sq 4, d 40), against both, f32, at 2e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention as JF
from repro_torch.kernels import flash_attention, ref

from _torch_parity import n, t

T = 128


def _inputs(rng, *, t_len=T, sq=6, d=40):
    """Row 0 a full cache, row 1 a ring whose second half is empty (every
    range past it is seen by no row), row 2 an empty cache (every query
    row fully masked), row 3 a ring that wrapped; query row 1 of row 0 is
    a pad (fully masked)."""
    q = rng.standard_normal((4, sq, d)).astype(np.float32)
    kv = rng.standard_normal((2, 4, t_len, d)).astype(np.float32)
    kv_pos = np.tile(np.arange(t_len, dtype=np.int32), (4, 1))
    kv_pos[1, t_len // 2:] = -1
    kv_pos[2] = -1
    kv_pos[3] = np.roll(np.arange(t_len, dtype=np.int32) + 7, 13)
    q_pos = np.stack([np.arange(t_len - sq, t_len), np.arange(sq) + 3,
                      np.arange(sq), np.arange(t_len + 7 - sq, t_len + 7)]
                     ).astype(np.int32)
    q_pos[0, 1] = -1
    return q, kv[0], kv[1], q_pos, kv_pos


def _splits(case):
    return T // 32 if case == "T/32" else case


@pytest.mark.parametrize("splits", [1, 2, 7, "T/32"])
@pytest.mark.parametrize("window", [None, 9, 70])
def test_split_equals_plain_attention(splits, window):
    rng = np.random.default_rng(3 + (window or 0))
    args = [t(a) for a in _inputs(rng)]
    got = ref.flash_attention_split(*args, splits=_splits(splits),
                                    window=window)
    want = ref.flash_attention(*args, window=window)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-6)
    assert np.all(n(got)[2] == 0) and np.all(n(got)[0, 1] == 0)


@pytest.mark.parametrize("splits", [1, 2, 7, "T/32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_matches_reference_kernel(splits, dtype):
    rng = np.random.default_rng(11)
    q, k, v, q_pos, kv_pos = _inputs(rng)
    jd = getattr(jnp, dtype)
    qj, kj, vj = (jnp.asarray(a, jd) for a in (q, k, v))
    want = JF.flash_attention(qj, kj, vj, jnp.asarray(q_pos),
                              jnp.asarray(kv_pos), window=None,
                              block=(8, 8), interpret=True)
    before = flash_attention.FLOAT_LAUNCHES
    got = ref.flash_attention_split(t(qj), t(kj), t(vj), t(q_pos),
                                    t(kv_pos), splits=_splits(splits))
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-6 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(n(got), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert np.all(n(got)[2] == 0) and np.all(n(got)[0, 1] == 0)
    assert flash_attention.FLOAT_LAUNCHES == before


@pytest.mark.parametrize("causal", [True, False])
def test_range_seen_by_no_row_contributes_nothing(causal):
    """Decode rows at positions 20..23 of a 128-slot ring holding 0..63:
    with 4 splits, ranges 2 and 3 (empty slots) and, causally, most of
    range 0's neighbours' future are seen by no row; the result equals
    attention over the seen slots alone, split or not."""
    rng = np.random.default_rng(5)
    q, k, v = (a[:2] for a in _inputs(rng, sq=4)[:3])
    kv_pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    kv_pos[:, 64:] = -1
    q_pos = np.tile(np.arange(20, 24, dtype=np.int32), (2, 1))
    args = [t(a) for a in (q, k, v, q_pos, kv_pos)]
    got = ref.flash_attention_split(*args, splits=4, causal=causal)
    cut = [t(a) for a in (q, k[:, :64], v[:, :64], q_pos, kv_pos[:, :64])]
    want = ref.flash_attention(*cut, causal=causal)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-6)


def test_fully_masked_rows_are_zero_with_every_range_empty():
    rng = np.random.default_rng(9)
    q, k, v, q_pos, kv_pos = _inputs(rng)
    kv_pos[:] = -1
    args = [t(a) for a in (q, k, v, q_pos, kv_pos)]
    for splits in (1, 2, 7, T // 32):
        got = ref.flash_attention_split(*args, splits=splits)
        assert np.all(n(got) == 0)


T_TILED = 200       # three whole 64-slot tiles and one of 8 slots


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("window", [None, 9, 70])
def test_tile_ranges_equal_plain_attention(splits, window):
    """Ranges of whole tiles (splits 2 and 3: two tiles a range, the last
    one 72 slots; 4: a tile a range), each range's partials, the
    combine: the plain attention within 2e-6; the empty cache's rows and
    the padded query row exactly 0."""
    rng = np.random.default_rng(17 + (window or 0))
    args = [t(a) for a in _inputs(rng, t_len=T_TILED, sq=4)]
    got = ref.flash_attention_split(*args, splits=splits,
                                    tile=ref.FLOAT_TILE, window=window)
    want = ref.flash_attention(*args, window=window)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-6)
    assert np.all(n(got)[2] == 0) and np.all(n(got)[0, 1] == 0)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 70])
def test_tile_ranges_match_reference_kernel(splits, window):
    rng = np.random.default_rng(23 + (window or 0))
    q, k, v, q_pos, kv_pos = _inputs(rng, t_len=T_TILED, sq=4)
    want = JF.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(q_pos), jnp.asarray(kv_pos),
                              window=window, block=(8, 8), interpret=True)
    got = ref.flash_attention_split(*(t(a) for a in (q, k, v, q_pos,
                                                     kv_pos)),
                                    splits=splits, tile=ref.FLOAT_TILE,
                                    window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-6,
                               atol=2e-6)
    assert np.all(n(got)[2] == 0) and np.all(n(got)[0, 1] == 0)
