"""Parity of the plain torch versions of the port's kernels (what a CPU
tensor runs) with the reference JAX ops, on the same inputs and the same
packed weights.

Tolerances:
* K3 packed words and the K1 integer core (``act="none"``, f32 output,
  dual, residual, bias and nested ``w_bits`` slicing): bit-exact.
* K1 with SiLU: exp is computed by different libraries, so 1e-6
  relative on f32 outputs (2 bf16 ulps, 1.6e-2, on bf16 outputs).
* K2 (paged attention): 2e-6 absolute on f32 outputs of magnitude ~1
  (the f32 summation order of Q.K^T, softmax and P.V differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bipolar as JB
from repro.kernels import ops as JO
from repro_torch.kernels import apmm, flash_attention, ops as TO, pack

from _torch_parity import jax_bipolar_to_torch, n, t


def _words(x):
    return np.asarray(x).view(np.int32)


# ---------------------------------------------------------------------------
# K3: quantize + pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bits", [1, 2, 5, 8])
@pytest.mark.parametrize("pad_bit", [0, 1])
def test_k3_plain_words_equal_reference_kernel(n_bits, pad_bit):
    """The plain pack equals the reference Pallas kernel (interpret) and
    the reference jnp path, word for word."""
    rng = np.random.default_rng(n_bits + 10 * pad_bit)
    x = (rng.standard_normal((12, 70)) * 3.0).astype(np.float32)
    got = TO.quantize_rows(t(x), n_bits, pad_bit=pad_bit)
    for impl in ("interpret", "reference"):
        want = JO.quantize_rows(jnp.asarray(x), n_bits, pad_bit=pad_bit,
                                impl=impl)
        np.testing.assert_array_equal(_words(want.packed), got.packed.numpy())
        np.testing.assert_array_equal(np.asarray(want.scale), n(got.scale))


def test_k3_wrapper_on_cpu_runs_the_plain_version():
    before = pack.LAUNCHES
    x = t(np.ones((4, 40), np.float32))
    TO.quantize_rows(x, 2, pad_bit=1)
    assert pack.LAUNCHES == before     # no kernel launch for a CPU tensor


# ---------------------------------------------------------------------------
# K1: fused quantized linear
# ---------------------------------------------------------------------------

def _weights(rng, n_out, k, bits):
    w = rng.standard_normal((n_out, k)).astype(np.float32)
    jw = JO.pack_weight(jnp.asarray(w), bits, impl="reference")
    return jw, jax_bipolar_to_torch(jw)


@pytest.mark.parametrize("a_bits,w_bits,nested", [
    (8, 2, None), (8, 8, None), (8, 8, 3), (4, 3, 1), (7, 4, 2)])
@pytest.mark.parametrize("mode", ["plain", "dual", "residual", "bias"])
def test_k1_integer_core_bit_exact(a_bits, w_bits, nested, mode):
    """act="none", f32 out: the port equals the reference op bit for bit
    (odd M/N/K, K padded to the word boundary)."""
    rng = np.random.default_rng(a_bits * 100 + w_bits * 10 + len(mode))
    m, n_out, k = 5, 23, 45
    jw, tw = _weights(rng, n_out, k, w_bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if mode == "dual":
        jw2, tw2 = _weights(rng, n_out, k, w_bits)
        kw_j["w2"], kw_t["w2"] = jw2, tw2
    if mode == "residual":
        r = rng.standard_normal((m, n_out)).astype(np.float32)
        kw_j["residual"], kw_t["residual"] = jnp.asarray(r), t(r)
    if mode == "bias":
        b = rng.standard_normal((n_out,)).astype(np.float32)
        kw_j["bias"], kw_t["bias"] = jnp.asarray(b), t(b)
    want = JO.ap_linear_fused(jnp.asarray(x), jw, a_bits=a_bits,
                              out_dtype=jnp.float32, impl="reference",
                              w_bits=nested, **kw_j)
    got = TO.ap_linear_fused(t(x), tw, a_bits=a_bits, w_bits=nested,
                             **kw_t)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_k1_matches_reference_pallas_kernel_interpret():
    """Against the reference Pallas kernel body itself (interpret mode)
    at a tiny shape: same bits."""
    rng = np.random.default_rng(3)
    jw, tw = _weights(rng, 16, 40, 2)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    want = JO.ap_linear_fused(jnp.asarray(x), jw, a_bits=8,
                              out_dtype=jnp.float32, impl="interpret")
    got = TO.ap_linear_fused(t(x), tw, a_bits=8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_silu_dual_within_tolerance(dtype):
    rng = np.random.default_rng(7)
    before = apmm.LAUNCHES
    jw, tw = _weights(rng, 30, 64, 2)
    jw2, tw2 = _weights(rng, 30, 64, 2)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    r = rng.standard_normal((6, 30)).astype(np.float32)
    jd = getattr(jnp, dtype)
    xj, rj = jnp.asarray(x, jd), jnp.asarray(r, jd)
    want = JO.ap_linear_fused(xj, jw, w2=jw2, a_bits=8, act="silu",
                              residual=rj, impl="reference")
    got = TO.ap_linear_fused(t(xj), tw, w2=tw2, a_bits=8, act="silu",
                             residual=t(rj))
    tol = 1e-6 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(n(got), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # the plain version ran: CPU tensors never launch
    assert apmm.LAUNCHES == before


def test_k1_bf16_activation_scale_is_taken_in_bf16():
    """The activation scale is the absmax in the input dtype, then cast
    to f32 -- a bf16 integer core matches the reference bit for bit."""
    rng = np.random.default_rng(11)
    jw, tw = _weights(rng, 17, 96, 2)
    x = jnp.asarray(rng.standard_normal((4, 96)) * 5, jnp.bfloat16)
    want = JO.ap_linear_fused(x, jw, a_bits=8, out_dtype=jnp.float32,
                              impl="reference")
    got = TO.ap_linear_fused(t(x), tw, a_bits=8, out_dtype=torch.float32)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# K2: paged attention over the bipolar pool
# ---------------------------------------------------------------------------

def _paged_inputs(rng, bits, *, b=3, h=2, gq=4, d=16, bs=8, n_blocks=12,
                  nb=4, lens=(19, 7, 0)):
    """Random K/V quantized and scattered into pool blocks; row 2 owns no
    block (its table is all null-block pads: a dead table)."""
    dw = JB.packed_words(d)
    k_pool = np.zeros((n_blocks, bs, h, bits, dw), np.uint32)
    v_pool = np.zeros_like(k_pool)
    k_sc = np.zeros((n_blocks, bs, h, 1), np.float32)
    v_sc = np.zeros_like(k_sc)
    pool_pos = np.full((n_blocks, bs), -1, np.int32)
    tables = np.zeros((b, nb), np.int32)
    free = list(range(1, n_blocks))
    for row, ln in enumerate(lens):
        if not ln:
            continue
        kq, ks = JO.quantize_kv(jnp.asarray(
            rng.standard_normal((ln, h, d)), jnp.float32), bits)
        vq, vs = JO.quantize_kv(jnp.asarray(
            rng.standard_normal((ln, h, d)), jnp.float32), bits)
        for j in range(-(-ln // bs)):
            bid = free.pop()
            tables[row, j] = bid
            lo, hi = j * bs, min(ln, (j + 1) * bs)
            k_pool[bid, :hi - lo] = np.asarray(kq[lo:hi])
            v_pool[bid, :hi - lo] = np.asarray(vq[lo:hi])
            k_sc[bid, :hi - lo] = np.asarray(ks[lo:hi])
            v_sc[bid, :hi - lo] = np.asarray(vs[lo:hi])
            pool_pos[bid, :hi - lo] = np.arange(lo, hi)
    q = rng.standard_normal((b, h, gq, d)).astype(np.float32)
    q_pos = np.array([[max(ln - 1 - g // 2, -1) for g in range(gq)]
                      for ln in lens], np.int32)
    q_pos[0, 1] = -1                     # a padded query row
    return q, k_pool, k_sc, v_pool, v_sc, pool_pos, tables, q_pos


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("d", [16, 40])
def test_k2_plain_matches_reference(bits, window, d):
    rng = np.random.default_rng(bits * 10 + d + (window or 0))
    before = flash_attention.LAUNCHES
    args = _paged_inputs(rng, bits, d=d)
    want = JO.paged_kv_cache_attention(*[jnp.asarray(a) for a in args],
                                       d=d, window=window,
                                       impl="reference")
    got = TO.paged_kv_cache_attention(*[t(a) for a in args], d=d,
                                      window=window)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=2e-6)
    # fully masked rows (padded query, dead table) return exactly 0
    assert np.all(n(got)[2] == 0) and np.all(n(got)[0, :, 1] == 0)
    assert flash_attention.LAUNCHES == before


def test_k2_plain_matches_reference_pallas_kernel_interpret():
    rng = np.random.default_rng(5)
    args = _paged_inputs(rng, 8, gq=8)
    want = JO.paged_kv_cache_attention(*[jnp.asarray(a) for a in args],
                                       d=16, impl="interpret")
    got = TO.paged_kv_cache_attention(*[t(a) for a in args], d=16)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=2e-6)


def test_quantize_kv_planes_bit_identical():
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((2, 5, 3, 40)), jnp.bfloat16)
    jq, js = JO.quantize_kv(x, 8)
    tq, ts = TO.quantize_kv(t(x), 8)
    np.testing.assert_array_equal(_words(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), n(ts))
    np.testing.assert_array_equal(
        np.asarray(JO.dequantize_kv(jq, js, 40)),
        n(TO.dequantize_kv(tq, ts, 40)))
