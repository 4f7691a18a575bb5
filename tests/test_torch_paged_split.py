"""The plain version of K2's split plan: ``ref.paged_attention_split``
cuts a request's block table into ranges of ``ceil(NB / splits)`` entries,
computes each range's f32 partials ``(m, l, acc)`` over the slots of its
pool blocks and combines them as the kernel's combine does.  It is held
against the reference JAX ``paged_kv_cache_attention`` (its ``reference``
impl, and one case through the Pallas kernel in ``interpret`` mode) at
the tolerance of ``test_torch_kernels.py``'s K2 comparison: 2e-6 absolute
on f32 outputs of magnitude ~1 (only the f32 summation order differs).
With one range it gives ``ref.paged_attention``'s bits.

Cases: split counts 1, 2, 3 and NB over a table of NB = 11 entries
(uneven ranges); a sliding window that leaves the first ranges of the
long lane unseen; a pad lane on an all-null table and a padded query row
(fully masked: exactly 0); 3 and 8 bits, a head dim of 40 (two words).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from repro.kernels import ops as JO
from repro_torch.kernels import flash_attention, ref

from _torch_parity import n, t

NB, BS, H, D = 11, 4, 2, 40


def _inputs(rng, bits, lens=(37, 6, 0, 15)):
    """Lane i holds ``lens[i]`` tokens in blocks of its own (its table
    padded with the null block 0); lane 2 owns nothing (a pad lane).
    Queries: 2 GQA heads x the last 2 positions of each lane; lane 3's
    first query row is a pad (-1)."""
    dw = -(-D // 32)
    n_blocks = 1 + sum(-(-ln // BS) for ln in lens)
    k_pool = np.zeros((n_blocks, BS, H, bits, dw), np.uint32)
    v_pool = np.zeros_like(k_pool)
    k_sc = np.zeros((n_blocks, BS, H, 1), np.float32)
    v_sc = np.zeros_like(k_sc)
    pool_pos = np.full((n_blocks, BS), -1, np.int32)
    tables = np.zeros((len(lens), NB), np.int32)
    q_pos = np.full((len(lens), 4), -1, np.int32)
    nxt = 1
    for row, ln in enumerate(lens):
        if not ln:
            continue
        kq, ks = JO.quantize_kv(jnp.asarray(
            rng.standard_normal((ln, H, D)), jnp.float32), bits)
        vq, vs = JO.quantize_kv(jnp.asarray(
            rng.standard_normal((ln, H, D)), jnp.float32), bits)
        for j in range(-(-ln // BS)):
            tables[row, j] = nxt
            lo, hi = j * BS, min(ln, (j + 1) * BS)
            k_pool[nxt, :hi - lo] = np.asarray(kq[lo:hi])
            v_pool[nxt, :hi - lo] = np.asarray(vq[lo:hi])
            k_sc[nxt, :hi - lo] = np.asarray(ks[lo:hi])
            v_sc[nxt, :hi - lo] = np.asarray(vs[lo:hi])
            pool_pos[nxt, :hi - lo] = np.arange(lo, hi)
            nxt += 1
        q_pos[row] = [ln - 2, ln - 2, ln - 1, ln - 1]
    q_pos[3, 0] = -1
    q = rng.standard_normal((len(lens), H, 4, D)).astype(np.float32)
    return q, k_pool, k_sc, v_pool, v_sc, pool_pos, tables, q_pos


def _masked_rows_zero(out):
    return np.all(out[2] == 0) and np.all(out[3, :, 0] == 0)


@pytest.mark.parametrize("splits", [1, 2, 3, NB])
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("bits", [3, 8])
def test_split_matches_reference_k2(splits, window, bits):
    rng = np.random.default_rng(bits * 7 + (window or 0))
    args = _inputs(rng, bits)
    want = JO.paged_kv_cache_attention(*[jnp.asarray(a) for a in args],
                                       d=D, window=window, impl="reference")
    before = flash_attention.LAUNCHES
    got = ref.paged_attention_split(*[t(a) for a in args], splits=splits,
                                    d=D, window=window)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=2e-6)
    assert _masked_rows_zero(n(got))
    assert flash_attention.LAUNCHES == before


def test_split_matches_reference_pallas_kernel_interpret():
    rng = np.random.default_rng(2)
    args = _inputs(rng, 8)
    want = JO.paged_kv_cache_attention(*[jnp.asarray(a) for a in args],
                                       d=D, window=9, impl="interpret")
    got = ref.paged_attention_split(*[t(a) for a in args], splits=3, d=D,
                                    window=9)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=2e-6)


@pytest.mark.parametrize("window", [None, 9])
def test_one_range_gives_paged_attention_bits(window):
    rng = np.random.default_rng(4)
    args = [t(a) for a in _inputs(rng, 8)]
    got = ref.paged_attention_split(*args, splits=1, d=D, window=window)
    want = ref.paged_attention(*args, d=D, window=window)
    assert (got == want).all()


@pytest.mark.parametrize("splits", [2, 3, NB])
def test_ranges_no_row_sees_contribute_nothing(splits):
    """The window (9) leaves lane 0's first 6 entries unseen (37 tokens,
    queries at 35 and 36 see positions 27..36: entries 6..9), and every
    range past a lane's last entry holds only null entries: the split
    result equals unsplit attention with lane 0's table cut to its seen
    entries."""
    rng = np.random.default_rng(6)
    args = _inputs(rng, 8)
    tables = args[6]
    seen = tables.copy()
    seen[0] = 0
    seen[0, :4] = tables[0, 6:10]
    cut = [t(a) for a in args[:6] + (seen,) + args[7:]]
    want = ref.paged_attention(*cut, d=D, window=9)
    got = ref.paged_attention_split(*[t(a) for a in args], splits=splits,
                                    d=D, window=9)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-6)


def test_every_range_empty_gives_zeros():
    rng = np.random.default_rng(8)
    args = list(_inputs(rng, 8))
    args[5] = np.full_like(args[5], -1)     # every pool slot empty
    for splits in (1, 2, 3, NB):
        got = ref.paged_attention_split(*[t(a) for a in args],
                                        splits=splits, d=D)
        assert np.all(n(got) == 0)
