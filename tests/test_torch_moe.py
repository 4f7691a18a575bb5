"""Parity of the port's grouped MoE expert linear (K4's plain version on
the CPU) and MoE layer with the reference ``repro`` package, on the same
inputs (numpy seeds) and the same packed expert weights.

Tolerances:
* ``ap_moe_expert_linear`` at ``act="none"`` (single and dual, bf16 and
  f32 out, every bit pair, nested ``w_bits``, odd K/N, ``G > 1``, empty
  experts and all-dropped groups): live rows bit-exact against the
  reference's ``reference`` and ``interpret`` impls, dead rows exact
  zeros, the live map equal.
* With SiLU the f32 ``exp`` of torch and XLA differ by an ulp now and
  then: 1e-6 relative on f32 outputs, 1 ulp on bf16 outputs.
* ``moe_apply`` on reduced mixtral and deepseek-moe (shared expert):
  ``y`` bit-identical, stats equal, the grouped op and the legacy
  batched expert path (kept here as the oracle) equal; with
  unquantized experts (bf16 einsums, summed in another order than XLA's)
  within 1 bf16 ulp of the output's scale.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.kernels import ops as JO
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import bipolar
from repro_torch.kernels import moe as moe_kernel
from repro_torch.kernels import ops as TO
from repro_torch.kernels.ref import silu_f32
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import QuantConfig

from _torch_parity import jax_bipolar_to_torch, n, t, to_numpy_tree

# deliberately odd: SEG not a multiple of 8, K not a multiple of 32, N
# not a multiple of 128 -- every pad path of the op
E, G, SEG, K, N = 3, 2, 5, 37, 19
C = G * SEG
COUNTS = np.array([[5, 2], [3, 0], [1, 4]], np.int32)   # mixed fills
EMPTY = np.array([[0, 0], [5, 0], [0, 3]], np.int32)    # empty expert 0,
#                                                          dropped groups


def _weights(nb, seed, n_out=N, k=K):
    w = (np.random.default_rng(seed).standard_normal((E, n_out, k))
         / np.sqrt(k)).astype(np.float32)
    jw = JM._quantize_leaf(jnp.asarray(w), JQ(w_bits=nb), stacked=False)
    return jw, jax_bipolar_to_torch(jw)


def _acts(seed, dtype, k=K):
    x = np.random.default_rng(seed).standard_normal((E, C, k)) \
        .astype(np.float32)
    return jnp.asarray(x, dtype), t(np.asarray(jnp.asarray(x, dtype)))


def _live(counts):
    rows = np.arange(C)
    return counts[:, rows // SEG] > (rows % SEG)[None, :]


def _check(got, want, counts, exact=True, dtype=jnp.bfloat16):
    got, want = n(got), np.asarray(want, np.float32)
    live = _live(counts)
    assert not got[~live].any(), "dead capacity rows must be exact zeros"
    if exact:
        np.testing.assert_array_equal(got[live], want[live])
    elif dtype == jnp.float32:
        np.testing.assert_allclose(got[live], want[live], rtol=1e-6,
                                   atol=1e-7)
    else:
        # one bf16 ulp: relative 2^-7 of the larger magnitude
        tol = np.maximum(np.abs(got[live]), np.abs(want[live])) * 2 ** -7
        assert np.all(np.abs(got[live] - want[live]) <= tol)


BITS = [(a, w) for w in (1, 2, 3, 4, 8) for a in (4, 8)]


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", ["single", "dual", "dual_silu"])
@pytest.mark.parametrize("bits", BITS, ids=[f"a{a}w{w}" for a, w in BITS])
def test_op_matches_reference_impl(bits, mode, dtype):
    a_bits, w_bits = bits
    jw, tw = _weights(w_bits, seed=w_bits)
    jx, tx = _acts(a_bits * 10 + w_bits, dtype)
    kw_j, kw_t = {}, {}
    if mode != "single":
        jw2, tw2 = _weights(w_bits, seed=50 + w_bits)
        kw_j["w2"], kw_t["w2"] = jw2, tw2
    if mode == "dual_silu":
        kw_j["act"] = kw_t["act"] = "silu"
    want, live_j = JO.ap_moe_expert_linear(
        jx, jw, counts=jnp.asarray(COUNTS), a_bits=a_bits, impl="reference",
        with_stats=True, **kw_j)
    got, live_t = TO.ap_moe_expert_linear(
        tx, tw, counts=t(COUNTS), a_bits=a_bits, with_stats=True, **kw_t)
    assert got.dtype == tx.dtype and tuple(got.shape) == (E, C, N)
    _check(got, want, COUNTS, exact=mode != "dual_silu", dtype=dtype)
    np.testing.assert_array_equal(np.asarray(live_j), live_t.numpy())


INTERP = [(1, 1, "fused"), (3, 4, "fused"), (8, 8, "fused"),
          (3, 4, "bitserial"), (8, 2, "bitserial"), (2, 8, "bitserial")]


@pytest.mark.parametrize("a_bits,w_bits,variant", INTERP)
def test_op_matches_interpret_kernel_and_its_live_map(a_bits, w_bits,
                                                      variant):
    """The reference's Pallas kernel in interpret mode (its own tests'
    bit pairs): live rows, exact zeros and the kernel-reported live map."""
    jw, tw = _weights(w_bits, seed=10 + w_bits)
    jx, tx = _acts(7, jnp.bfloat16)
    want, live_j = JO.ap_moe_expert_linear(
        jx, jw, counts=jnp.asarray(COUNTS), a_bits=a_bits, variant=variant,
        impl="interpret", with_stats=True)
    got, live_t = TO.ap_moe_expert_linear(
        tx, tw, counts=t(COUNTS), a_bits=a_bits, variant=variant,
        with_stats=True)
    _check(got, want, COUNTS)
    np.testing.assert_array_equal(np.asarray(live_j), live_t.numpy())
    assert int(live_t.numel() - live_t.sum()) == int((COUNTS == 0).sum())


@pytest.mark.parametrize("case", ["empty_expert", "nested_w_bits",
                                  "dual_interpret"])
def test_op_edge_cases(case):
    """An empty expert and all-dropped groups; nested ``w_bits`` slices of
    a 4-bit checkpoint (both weights of the dual path); the dual path
    against the interpret kernel."""
    jw, tw = _weights(4, seed=3)
    jw2, tw2 = _weights(4, seed=4)
    jx, tx = _acts(11, jnp.bfloat16)
    counts = COUNTS
    if case == "empty_expert":
        counts = EMPTY
        calls = [dict(impl="reference")]
    elif case == "nested_w_bits":
        calls = [dict(impl="reference", w_bits=b) for b in (1, 2, 3)]
    else:
        calls = [dict(impl="interpret")]
    for kw in calls:
        impl = kw.pop("impl")
        want, live_j = JO.ap_moe_expert_linear(
            jx, jw, w2=jw2, counts=jnp.asarray(counts), a_bits=8,
            impl=impl, with_stats=True, **kw)
        got, live_t = TO.ap_moe_expert_linear(
            tx, tw, w2=tw2, counts=t(counts), a_bits=8, with_stats=True,
            **kw)
        _check(got, want, counts)
        np.testing.assert_array_equal(np.asarray(live_j), live_t.numpy())
    if case == "empty_expert":
        assert not got[0].any() and live_t[0:2].sum() == 0


def test_cpu_tensors_run_the_plain_version():
    before = moe_kernel.LAUNCHES
    _, tw = _weights(2, seed=1)
    _, tx = _acts(1, jnp.bfloat16)
    TO.ap_moe_expert_linear(tx, tw, counts=t(COUNTS), a_bits=8)
    assert moe_kernel.LAUNCHES == before


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

# (arch, reduced overrides, tokens (B, S)): dropless decode-sized and
# chunk-sized dispatches, a capacity that drops assignments, and a
# dispatch of 4096 tokens (G = 32 groups)
LAYER_CASES = [
    ("mixtral-8x7b", {}, (2, 9)),
    ("mixtral-8x7b", dict(capacity_factor=1.0), (3, 40)),
    ("mixtral-8x7b", {}, (1, 4096)),
    ("deepseek-moe-16b", {}, (2, 9)),
    ("deepseek-moe-16b", dict(capacity_factor=1.0), (3, 40)),
]


def _moe_params(name, red, seed):
    cfg_j = jget(name).reduced(n_layers=2, **red)
    cfg_t = get_config(name).reduced(n_layers=2, **red)
    qj = cfg_j.quant
    qt = QuantConfig(w_bits=qj.w_bits, a_bits=qj.a_bits)
    pj = JM.quantize_params(JL.moe_init(jax.random.PRNGKey(seed), cfg_j),
                            qj)
    pt = bridge.from_numpy_tree(to_numpy_tree(pj), "cpu")
    return cfg_j, cfg_t, qj, qt, pj, pt


def _legacy_matmul(w, xq, sx, a_bits, out_dtype):
    """Batched per-expert NT GEMM ``(E, C, K) x (E, N, K) -> (E, C, N)``
    over every capacity row: unpack the planes to bipolar integers, one
    exact integer product (float64 of small integers), the closed-form
    K-pad correction, and the f32 dequant ``(int * a_s) * w_s``."""
    kp = w.packed.shape[-1] * bipolar.PACK_WIDTH
    k = w.shape[-1]
    vals = bipolar.recover(bipolar.unpack_planes(w.packed, -1, kp),
                           w.n_bits)                         # (E, N, Kp)
    if kp > k:    # activation pad columns: all-zero bits = -maxa
        xq = F.pad(xq, (0, kp - k), value=-bipolar.max_value(a_bits))
    bound = bipolar.max_value(a_bits) * bipolar.max_value(w.n_bits)
    assert kp * bound < 2 ** 53, (kp, bound)
    y = torch.matmul(xq.to(torch.float64),
                     vals.to(torch.float64).transpose(1, 2))
    y = y.to(torch.int64).to(torch.int32) + (kp - k) * bound
    return (y.float() * sx * w.scale[:, None, :, 0]).to(out_dtype)


def _legacy_expert_linear(x, w, *, w2=None, counts, a_bits, act="none",
                          variant="fused", out_dtype=None, w_bits=None):
    """The legacy batched expert path in ``ops.ap_moe_expert_linear``'s
    place: the activations quantized once per (expert, row) in f32 and
    shared by both weights, every capacity row computed (``moe_apply``
    never reads the dead ones), ``silu(Y1) * Y2`` in f32, one cast."""
    del counts, variant
    if w_bits is not None:
        w = bipolar.nested_slice(w, w_bits)
        w2 = None if w2 is None else bipolar.nested_slice(w2, w_bits)
    xf = x.float()
    sx = bipolar.absmax_scale(xf, a_bits, axis=-1)
    xq = bipolar.quantize_values(xf, a_bits, sx)
    y = _legacy_matmul(w, xq, sx, a_bits, torch.float32)
    if w2 is not None:
        assert act == "silu"
        y = silu_f32(y) * _legacy_matmul(w2, xq, sx, a_bits, torch.float32)
    return y.to(out_dtype or x.dtype)


@pytest.mark.parametrize("name,red,shape", LAYER_CASES,
                         ids=["mixtral", "mixtral-drops", "mixtral-G32",
                              "deepseek", "deepseek-drops"])
def test_moe_apply_bit_identical_grouped_and_legacy(name, red, shape,
                                                    monkeypatch):
    cfg_j, cfg_t, qj, qt, pj, pt = _moe_params(name, red, len(shape))
    x = np.asarray(jnp.asarray(
        np.random.default_rng(5).standard_normal(
            shape + (cfg_j.d_model,)).astype(np.float32), jnp.bfloat16))
    yj, auxj, stj = JL.moe_apply(pj, jnp.asarray(x), cfg_j, quant=qj)
    yt, auxt, stt = TL.moe_apply(pt, t(x), cfg_t, quant=qt, with_aux=True,
                                 with_stats=True)
    np.testing.assert_array_equal(np.asarray(yj, np.float32), n(yt))
    for key in ("load", "dropped", "capacity"):
        np.testing.assert_array_equal(np.asarray(stj[key]),
                                      stt[key].numpy())
    np.testing.assert_allclose(float(auxj), float(auxt), rtol=1e-6)
    if "capacity_factor" in red:
        assert int(stt["dropped"]) > 0
    # serving asks for neither the loss nor the telemetry
    yd, auxd, std = TL.moe_apply(pt, t(x), cfg_t, quant=qt)
    assert torch.equal(yd, yt) and auxd is None and std is None
    monkeypatch.setattr(TO, "ap_moe_expert_linear", _legacy_expert_linear)
    yl, _, stl = TL.moe_apply(pt, t(x), cfg_t, quant=qt, with_stats=True)
    assert torch.equal(yl, yt)
    assert torch.equal(stl["load"], stt["load"])


@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-moe-16b"])
def test_moe_apply_float_experts_match_reference(name):
    """Unquantized experts (``quant=None``): the bf16 batched einsum
    path.  Its bf16 products sum in another order than XLA's dot: 1 bf16
    ulp of the output's scale."""
    cfg_j = jget(name).reduced(n_layers=2)
    cfg_t = get_config(name).reduced(n_layers=2)
    pj = JL.moe_init(jax.random.PRNGKey(3), cfg_j)
    pt = bridge.from_numpy_tree(to_numpy_tree(pj), "cpu")
    x = np.asarray(jnp.asarray(
        np.random.default_rng(6).standard_normal(
            (2, 7, cfg_j.d_model)).astype(np.float32), jnp.bfloat16))
    yj, _, stj = JL.moe_apply(pj, jnp.asarray(x), cfg_j)
    yt, _, stt = TL.moe_apply(pt, t(x), cfg_t, with_stats=True)
    a, b = np.asarray(yj, np.float32), n(yt)
    assert np.abs(a - b).max() <= 2 ** -7 * np.abs(a).max()
    np.testing.assert_array_equal(np.asarray(stj["load"]),
                                  stt["load"].numpy())


def test_quantize_experts_one_at_a_time_bit_identical():
    """The port packs a stacked expert leaf expert by expert; the
    reference packs the (E*N, K) leaf at once: same words and scales."""
    cfg_j, cfg_t, qj, qt, pj, pt = _moe_params("mixtral-8x7b", {}, 0)
    raw = JL.moe_init(jax.random.PRNGKey(0), cfg_j)
    got = TM.quantize_params(
        bridge.from_numpy_tree(to_numpy_tree(raw), "cpu"), qt)
    for key in ("w_up", "w_gate", "w_down"):
        a, b = pt[key], got[key]
        assert a.packed.shape == b.packed.shape == (
            2, cfg_t.n_experts) + tuple(a.packed.shape[2:])
        assert torch.equal(a.packed, b.packed), key
        assert torch.equal(a.scale, b.scale), key
        assert torch.equal(a.width_scales, b.width_scales), key
    assert torch.equal(got["router"]["w"], pt["router"]["w"])
