"""The ``bitserial`` variant of the port's quantized GEMMs (K1, K5, K4:
one +-1 GEMM per bit pair, shift-added) against the reference package,
whose Pallas kernels run as its own tests run them (``impl="interpret"``).

Tolerances, as in tests/test_torch_kernels.py: the integer cores and f32
outputs without exp (``act="none"``, bias, residual, nested ``w_bits``,
K5's raw int32 and dequantized products) are bit-exact; with SiLU, exp is
computed by different libraries, so 1e-6 relative on f32 outputs and 2
bf16 ulps (1.6e-2) on bf16 outputs.  The integer core of either variant
is the exact product, so the port's bitserial outputs also equal its
fused ones bit for bit.  The slice as a whole: reduced llama3-8b and
mixtral-8x7b served bit-serially by ``Engine(paged=True,
chunk_tokens=8)`` with XLA's excess precision off (a subprocess) emit
the reference's greedy tokens, and the port's own fused tokens.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as JO
from repro_torch.kernels import apmm
from repro_torch.kernels import ops as TO

from _torch_parity import jax_bipolar_to_torch, n, t

PAIRS = [(8, 2), (2, 8), (8, 8), (1, 1), (3, 5)]


def _weights(rng, n_out, k, bits):
    w = rng.standard_normal((n_out, k)).astype(np.float32)
    jw = JO.pack_weight(jnp.asarray(w), bits, impl="reference")
    return jw, jax_bipolar_to_torch(jw)


# ---------------------------------------------------------------------------
# K1: the fused quantized linear, bitserial
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_bits,w_bits", PAIRS)
@pytest.mark.parametrize("mode", ["plain", "dual", "bias_residual",
                                  "nested"])
def test_k1_bitserial_bit_exact_vs_interpret_kernel(a_bits, w_bits, mode):
    """act="none", f32 out, odd M/N/K (K = 45: one word and a pad tail):
    the port's plain bitserial linear equals the reference's bitserial
    Pallas kernel in interpret mode (single and dual), and the port's
    fused linear.  With a bias, a residual or a nested width the
    reference is its bitserial jnp path (``impl="reference"``), as in
    tests/test_torch_kernels.py; with a bias or a residual the interpret
    kernel, jitted whole on the CPU, contracts the dequant multiply and
    the add into one FMA (1 ulp in ~24% of outputs, in either variant),
    which the port's kernels, built with -fmad=false, do not."""
    rng = np.random.default_rng(a_bits * 100 + w_bits * 10 + len(mode))
    m, n_out, k = 5, 23, 45
    jw, tw = _weights(rng, n_out, k, w_bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if mode == "dual":
        jw2, tw2 = _weights(rng, n_out, k, w_bits)
        kw_j["w2"], kw_t["w2"] = jw2, tw2
    if mode == "bias_residual":
        r = rng.standard_normal((m, n_out)).astype(np.float32)
        b = rng.standard_normal((n_out,)).astype(np.float32)
        kw_j.update(residual=jnp.asarray(r), bias=jnp.asarray(b))
        kw_t.update(residual=t(r), bias=t(b))
    if mode == "nested":
        kw_j["w_bits"] = kw_t["w_bits"] = max(1, w_bits - 1)
    impl = "interpret" if mode in ("plain", "dual") else "reference"
    want = JO.ap_linear_fused(jnp.asarray(x), jw, a_bits=a_bits,
                              out_dtype=jnp.float32, variant="bitserial",
                              impl=impl, **kw_j)
    before = apmm.BITSERIAL_LAUNCHES
    got = TO.ap_linear_fused(t(x), tw, a_bits=a_bits, variant="bitserial",
                             **kw_t)
    assert apmm.BITSERIAL_LAUNCHES == before     # CPU: the plain version
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    fused = TO.ap_linear_fused(t(x), tw, a_bits=a_bits, **kw_t)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_bitserial_dual_silu_residual_within_tolerance(dtype):
    rng = np.random.default_rng(7)
    jw, tw = _weights(rng, 30, 70, 2)
    jw2, tw2 = _weights(rng, 30, 70, 2)
    x = rng.standard_normal((6, 70)).astype(np.float32)
    r = rng.standard_normal((6, 30)).astype(np.float32)
    jd = getattr(jnp, dtype)
    xj, rj = jnp.asarray(x, jd), jnp.asarray(r, jd)
    want = JO.ap_linear_fused(xj, jw, w2=jw2, a_bits=8, act="silu",
                              residual=rj, variant="bitserial",
                              impl="reference")
    got = TO.ap_linear_fused(t(xj), tw, w2=tw2, a_bits=8, act="silu",
                             residual=t(rj), variant="bitserial")
    tol = 1e-6 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(n(got), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    fused = TO.ap_linear_fused(t(xj), tw, w2=tw2, a_bits=8, act="silu",
                               residual=t(rj))
    assert torch.equal(fused, got)


# ---------------------------------------------------------------------------
# K5: the packed x packed GEMM, bitserial
# ---------------------------------------------------------------------------

def _packed(rng, rows, k, bits, pad_bit):
    x = (rng.standard_normal((rows, k)) * 2).astype(np.float32)
    jx = JO.quantize_rows(jnp.asarray(x), bits, pad_bit=pad_bit,
                          impl="reference")
    return jx, jax_bipolar_to_torch(jx)


@pytest.mark.parametrize("a_bits,w_bits", PAIRS)
def test_k5_bitserial_bit_exact_vs_interpret_kernel(a_bits, w_bits):
    """The raw int32 product at odd M/N/K equals the reference's bitserial
    Pallas kernel in interpret mode and the port's fused product; the
    dequantized (f32, bf16) products equal the reference's bitserial jnp
    path."""
    rng = np.random.default_rng(a_bits * 10 + w_bits)
    ja, ta = _packed(rng, 7, 77, a_bits, 0)
    jb, tb = _packed(rng, 19, 77, w_bits, 1)
    want = JO.ap_matmul(ja, jb, raw=True, variant="bitserial",
                        impl="interpret")
    got = TO.ap_matmul(ta, tb, raw=True, variant="bitserial")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want).astype(np.int32),
                                  got.numpy())
    assert torch.equal(got, TO.ap_matmul(ta, tb, raw=True))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = JO.ap_matmul(ja, jb, variant="bitserial", out_dtype=jd,
                            impl="reference")
        got = TO.ap_matmul(ta, tb, variant="bitserial", out_dtype=td)
        np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                      n(got))


@pytest.mark.parametrize("b_bits", [None, 3])
def test_k5_bitserial_unequal_word_widths_and_nested(b_bits):
    """A packed to fewer words than B (padded with all-zero words, B's
    all-one words), and a nested 4-bit B served at fewer planes."""
    rng = np.random.default_rng(17)
    ja, ta = _packed(rng, 5, 40, 8, 0)
    jb, tb = _packed(rng, 9, 40, 4, 1)
    ones = torch.full(tuple(tb.packed.shape[:-1]) + (2,), -1,
                      dtype=torch.int32)
    tb_wide = dataclasses.replace(tb, packed=torch.cat([tb.packed, ones], -1))
    want = JO.ap_matmul(ja, jb, raw=True, variant="bitserial",
                        impl="interpret", b_bits=b_bits)
    got = TO.ap_matmul(ta, tb_wide, raw=True, variant="bitserial",
                       b_bits=b_bits)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int32),
                                  got.numpy())


# ---------------------------------------------------------------------------
# The slice: bit-serial serving, token for token
# ---------------------------------------------------------------------------

_ENGINES = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, jax
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro.serving import engine as JE
from repro_torch.configs import get_config
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as TE
from _torch_parity import torch_params

out = {}
for name in ("llama3-8b", "mixtral-8x7b"):
    red = dict(n_layers=2, d_head=32, vocab=256)
    cfg_j, cfg_t = jget(name).reduced(**red), get_config(name).reduced(**red)
    qj = JQ(w_bits=2, a_bits=8, kv_bits=8, variant="bitserial")
    pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(2)), qj)
    pt = torch_params(pj, cfg_t)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, (13,), dtype=np.int32)]
    res = {}
    for tag, E, p, cfg, q in (
            ("ref", JE, pj, cfg_j, qj),
            ("port", TE, pt, cfg_t,
             QuantConfig(w_bits=2, a_bits=8, kv_bits=8, variant="bitserial")),
            ("port_fused", TE, pt, cfg_t,
             QuantConfig(w_bits=2, a_bits=8, kv_bits=8))):
        eng = E.Engine(p, cfg, n_slots=1, max_len=32, quant=q, paged=True,
                       block_size=8, chunk_tokens=8)
        reqs = [E.Request(prompt=pr.copy(), max_new_tokens=5)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        res[tag] = [[int(v) for v in r.out] for r in reqs]
    out[name] = res
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def served():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    proc = subprocess.run([sys.executable, "-c", _ENGINES, here], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=here)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.split("RESULT", 1)[1])


@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x7b"])
def test_bitserial_engine_tokens_equal_reference_and_fused(served, name):
    res = served[name]
    assert all(len(o) == 5 for o in res["port"])
    assert res["port"] == res["ref"]
    assert res["port"] == res["port_fused"]
