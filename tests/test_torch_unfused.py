"""Parity of the port's unfused quantized linear and contiguous-cache
attention (the plain versions of K5, K6 and K7, which CPU tensors run)
with the reference JAX ops, on the same packed operands.

Tolerances:
* K5 (``ap_matmul``): the raw int32 product is bit-exact against the
  reference Pallas kernel in interpret mode, for every pair of widths
  1..8, odd K, operands packed to different word widths and nested
  ``b_bits``; the f32/bf16 dequantized product is bit-exact too.
* ``ap_linear`` (K3 + K5) is bit-exact against the reference at
  ``act="none"``, and equal bit for bit to the port's fused linear
  (K1's plain version) with a residual and through the SwiGLU.
* K6 / K7 (``kv_cache_attention`` / ``flash_attention``): 2e-6 absolute
  on f32 outputs of magnitude ~1 against the reference kernels in
  interpret mode (the f32 summation order of Q.K^T, softmax and P.V
  differs); fully masked rows are exactly 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention as JF
from repro.kernels import ops as JO
from repro_torch.configs import get_config
from repro_torch.kernels import apmm, flash_attention, ops as TO
from repro_torch.models import layers as L
from repro_torch.models.config import QuantConfig

from _torch_parity import jax_bipolar_to_torch, n, t


def _packed(rng, rows, k, bits, pad_bit, extra_words=0):
    """A reference-packed operand (optionally carrying extra alignment
    words of its pad bit) and its port twin."""
    x = (rng.standard_normal((rows, k)) * 2.0).astype(np.float32)
    jt = JO.quantize_rows(jnp.asarray(x), bits, pad_bit=pad_bit,
                          impl="reference")
    if extra_words:
        fill = np.uint32(0xFFFFFFFF if pad_bit else 0)
        jt = dataclasses.replace(jt, packed=jnp.pad(
            jt.packed, ((0, 0), (0, 0), (0, extra_words)),
            constant_values=fill))
    return jt, jax_bipolar_to_torch(jt)


# ---------------------------------------------------------------------------
# K5: packed x packed GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_a", range(1, 9))
@pytest.mark.parametrize("n_b", range(1, 9))
def test_ap_matmul_raw_bit_exact_vs_reference_kernel(n_a, n_b):
    rng = np.random.default_rng(n_a * 10 + n_b)
    ja, ta = _packed(rng, 5, 45, n_a, 0)
    jb, tb = _packed(rng, 9, 45, n_b, 1)
    before = apmm.PACKED_LAUNCHES
    want = JO.ap_matmul(ja, jb, raw=True, impl="interpret")
    got = TO.ap_matmul(ta, tb, raw=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert apmm.PACKED_LAUNCHES == before   # a CPU tensor never launches


@pytest.mark.parametrize("extra_a,extra_b", [(0, 1), (2, 0), (1, 3)])
def test_ap_matmul_unequal_word_widths_odd_k(extra_a, extra_b):
    """Operands packed to different word widths pad to the common one
    (A with zero words, B with all-one words) and the product is
    unchanged; K = 67 leaves a ragged last word."""
    rng = np.random.default_rng(extra_a * 7 + extra_b)
    ja, ta = _packed(rng, 7, 67, 8, 0, extra_a)
    jb, tb = _packed(rng, 11, 67, 3, 1, extra_b)
    for raw in (True, False):
        want = JO.ap_matmul(ja, jb, raw=raw, impl="reference")
        np.testing.assert_array_equal(np.asarray(want),
                                      TO.ap_matmul(ta, tb, raw=raw).numpy())


@pytest.fixture(scope="module")
def nested_weight():
    """A 6-bit weight with nested per-width scales (the clip search is
    slow in eager JAX: made once)."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((20, 70)).astype(np.float32)
    jw = JO.pack_weight(jnp.asarray(w), 6, impl="reference")
    return jw, jax_bipolar_to_torch(jw)


@pytest.mark.parametrize("b_bits", [1, 3, 5])
def test_ap_matmul_nested_b_bits(nested_weight, b_bits):
    """A nested weight served at ``b_bits`` ships its top planes only:
    the raw core and the dequant (the per-width scale) match."""
    rng = np.random.default_rng(b_bits)
    jw, tw = nested_weight
    ja, ta = _packed(rng, 6, 70, 8, 0)
    for raw in (True, False):
        want = JO.ap_matmul(ja, jw, raw=raw, b_bits=b_bits,
                            impl="reference")
        got = TO.ap_matmul(ta, tw, raw=raw, b_bits=b_bits)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_ap_matmul_dequant_bit_exact(out_dtype):
    rng = np.random.default_rng(3)
    ja, ta = _packed(rng, 12, 100, 8, 0)
    jb, tb = _packed(rng, 30, 100, 2, 1)
    want = JO.ap_matmul(ja, jb, out_dtype=getattr(jnp, out_dtype),
                        impl="reference")
    got = TO.ap_matmul(ta, tb, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  n(got))


# ---------------------------------------------------------------------------
# ap_linear: K3 pack + K5 GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits,k", [(2, 64), (8, 77)])
def test_ap_linear_bit_exact_vs_reference(dtype, w_bits, k):
    rng = np.random.default_rng(w_bits + k)
    w = rng.standard_normal((24, k)).astype(np.float32)
    jw = JO.pack_weight(jnp.asarray(w), w_bits, impl="reference")
    tw = jax_bipolar_to_torch(jw)
    x = jnp.asarray(rng.standard_normal((2, 3, k)) * 3, getattr(jnp, dtype))
    # the reference's kernels (interpret) once; its jnp path everywhere
    impls = ("interpret", "reference") if (w_bits, dtype) == (2, "bfloat16") \
        else ("reference",)
    for impl in impls:
        want = JO.ap_linear(x, jw, a_bits=8, impl=impl)
        got = TO.ap_linear(t(x), tw, a_bits=8)
        assert got.shape == (2, 3, 24) and got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                      n(got))


@pytest.mark.parametrize("w_bits", [2, 8])
def test_ap_linear_equals_fused_linear(w_bits):
    """The unfused linear (K3 + K5) and the fused one (K1) give the same
    bits: at act="none", with a residual, and through the SwiGLU of
    ``mlp_apply`` (one SiLU form on both sides)."""
    rng = np.random.default_rng(w_bits)
    k, f = 96, 40
    ws = [TO.pack_weight(torch.from_numpy(rng.standard_normal((f, k))
                                          .astype(np.float32)), w_bits)
          for _ in range(2)]
    x = torch.from_numpy(rng.standard_normal((5, k)).astype(np.float32)
                         * 2).to(torch.bfloat16)
    res = torch.from_numpy(rng.standard_normal((5, f)).astype(np.float32)
                           ).to(torch.bfloat16)
    assert torch.equal(TO.ap_linear(x, ws[0], a_bits=8),
                       TO.ap_linear_fused(x, ws[0], a_bits=8))
    assert torch.equal(TO.ap_linear(x, ws[0], a_bits=8) + res,
                       TO.ap_linear_fused(x, ws[0], a_bits=8, residual=res))
    cfg = get_config("llama3-8b").reduced(n_layers=1)
    mlp = {"w_gate": {"w": ws[0]}, "w_up": {"w": ws[1]},
           "w_down": {"w": TO.pack_weight(torch.from_numpy(
               rng.standard_normal((k, f)).astype(np.float32)), w_bits)}}
    outs = [L.mlp_apply(mlp, x, cfg, quant=QuantConfig(
        w_bits=w_bits, a_bits=8, fused_linear=fused), residual=x)
        for fused in (True, False)]
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# K6 / K7: attention over a contiguous cache
# ---------------------------------------------------------------------------

def _cache_inputs(rng, bits, *, bh=4, t=40, sq=6, d=40):
    """Folded inputs: row 0 a full cache, row 1 a half-empty ring, row 2
    an empty cache (every row masked), row 3 a ring that wrapped (slot
    order is not position order); query row 1 of row 0 is a pad."""
    kv = jnp.asarray(rng.standard_normal((2, bh, t, d)), jnp.float32)
    kq, ks = JO.quantize_kv(kv[0], bits)
    vq, vs = JO.quantize_kv(kv[1], bits)
    kv_pos = np.tile(np.arange(t, dtype=np.int32), (bh, 1))
    kv_pos[1, t // 2:] = -1
    kv_pos[2] = -1
    kv_pos[3] = np.roll(np.arange(t, dtype=np.int32) + 7, 13)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    q_pos = np.stack([np.arange(t - sq, t), np.arange(sq) + 3,
                      np.arange(sq), np.arange(t + 7 - sq, t + 7)]
                     ).astype(np.int32)
    q_pos[0, 1] = -1
    return q, kq, ks, vq, vs, q_pos, kv_pos, kv


@pytest.mark.parametrize("bits,window,causal", [(8, None, True),
                                                (2, 9, True),
                                                (8, 9, False)])
def test_kv_cache_attention_matches_reference_kernel(bits, window, causal):
    rng = np.random.default_rng(bits + (window or 0) + 100 * causal)
    q, kq, ks, vq, vs, q_pos, kv_pos, _ = _cache_inputs(rng, bits)
    args = (q, kq, ks, vq, vs, q_pos, kv_pos)
    before = flash_attention.QUANTIZED_LAUNCHES
    want = JO.kv_cache_attention(*[jnp.asarray(a) for a in args], d=40,
                                 causal=causal, window=window,
                                 impl="interpret")
    got = TO.kv_cache_attention(*[t(a) for a in args], d=40, causal=causal,
                                window=window)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=2e-6)
    assert np.all(n(got)[2] == 0)                   # empty cache
    if causal:
        assert np.all(n(got)[0, 1] == 0)            # padded query row
    assert flash_attention.QUANTIZED_LAUNCHES == before


def test_ring_attention_equals_folded_attention():
    """The ring layout op (what the serving path calls) computes the
    folded op on the same cache, bit for bit, for grouped queries."""
    rng = np.random.default_rng(1)
    b, t_, h, g, d = 2, 24, 3, 4, 32
    kv = torch.from_numpy(rng.standard_normal((2, b, t_, h, d))
                          .astype(np.float32))
    kq, ks = TO.quantize_kv(kv[0], 8)
    vq, vs = TO.quantize_kv(kv[1], 8)
    qg = torch.from_numpy(rng.standard_normal((b, h, g, d))
                          .astype(np.float32)).to(torch.bfloat16)
    qp = torch.tensor([[20, 21, 22, 23], [5, 6, -1, 7]], dtype=torch.int32)
    kp = torch.arange(t_, dtype=torch.int32).repeat(b, 1)
    kp[1, 10:] = -1
    got = TO.ring_kv_cache_attention(qg, kq, ks, vq, vs, qp, kp, d=d,
                                     window=6)
    want = TO.kv_cache_attention(
        qg.reshape(b * h, g, d), TO.fold_kv_heads(kq), TO.fold_kv_heads(ks),
        TO.fold_kv_heads(vq), TO.fold_kv_heads(vs),
        qp.repeat_interleave(h, 0), kp.repeat_interleave(h, 0), d=d,
        window=6)
    assert torch.equal(got, want.reshape(b, h, g, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 9])
def test_flash_attention_matches_reference_kernel(dtype, window):
    rng = np.random.default_rng(7 + (window or 0))
    q, *_, q_pos, kv_pos, kv = _cache_inputs(rng, 8)
    jd = getattr(jnp, dtype)
    qj, kj, vj = (jnp.asarray(a, jd) for a in (q, kv[0], kv[1]))
    before = flash_attention.FLOAT_LAUNCHES
    want = JF.flash_attention(qj, kj, vj, jnp.asarray(q_pos),
                              jnp.asarray(kv_pos), window=window,
                              block=(8, 8), interpret=True)
    got = flash_attention.flash_attention(t(qj), t(kj), t(vj), t(q_pos),
                                          t(kv_pos), window=window)
    assert got.dtype == getattr(torch, dtype)
    # the reference kernel rounds p to v's dtype before P.V; the port's
    # plain version keeps it in f32: 1 bf16 ulp of slack on bf16 inputs
    tol = 2e-6 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(n(got), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert np.all(n(got)[2] == 0) and np.all(n(got)[0, 1] == 0)
    assert flash_attention.FLOAT_LAUNCHES == before


def test_attn_core_chunked_equals_direct_and_reference():
    """The float ``_attn_core`` in its direct and KV-chunked forms agree
    with each other and with the reference's jnp core (2e-6)."""
    from repro.models import layers as JL
    rng = np.random.default_rng(2)
    b, hk, sq, t_, d = 2, 2, 6, 2600, 16
    q = rng.standard_normal((b, hk, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, t_, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, t_, d)).astype(np.float32)
    q_pos = np.tile(np.arange(t_ - sq, t_, dtype=np.int32), (b, 1))
    kv_pos = np.tile(np.arange(t_, dtype=np.int32), (b, 1))
    kv_pos[1, 2000:] = -1
    q_pos[1, 0] = -1
    outs = {}
    for chunked in (False, True):
        outs[chunked] = n(L._attn_core(t(q), t(k), t(v), t(q_pos),
                                       t(kv_pos), causal=True, window=700,
                                       chunked=chunked))
        want = JL._attn_core(*[jnp.asarray(a) for a in
                               (q, k, v, q_pos, kv_pos)], causal=True,
                             window=700, chunked=chunked)
        np.testing.assert_allclose(outs[chunked], np.asarray(want), rtol=0,
                                   atol=2e-6)
    np.testing.assert_allclose(outs[True], outs[False], rtol=0, atol=2e-6)
    assert np.all(outs[True][1, :, 0] == 0)          # fully masked row
