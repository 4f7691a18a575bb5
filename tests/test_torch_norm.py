"""The port's norm against the reference's, bit for bit.

``repro_torch.models.layers.norm_apply`` reproduces the f32 steps of the
reference's jitted norm on the CPU (XLA's reduce-window tree of serial
32-element sums, the reciprocal multiply, the rsqrt estimate with two
Newton-Raphson steps, FMA contraction).  With torch's own mean and rsqrt,
~3% of bf16 rows at d = 4096 differed from the reference, and a reduced
llama3-8b served nested at 4 bits emitted another token.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import layers as JL
from repro_torch.models import layers as TL


class _Cfg:
    norm_eps = 1e-5

    def __init__(self, norm_type):
        self.norm_type = norm_type


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 4096, 100, 2560])
def test_norm_bits_equal_reference(norm_type, dtype, d):
    cfg = _Cfg(norm_type)
    rng = np.random.default_rng(d)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, d).astype(np.float32)
    x = (rng.standard_normal((256, d)) * 3 + 0.3).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    yj = jax.jit(lambda v: JL.norm_apply(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, v,
        cfg))(xj)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    yt = TL.norm_apply({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)}, xt, cfg)
    assert yt.dtype == xt.dtype
    a = np.asarray(yj.astype(jnp.float32)).view(np.int32)
    b = yt.float().numpy().view(np.int32)
    assert np.array_equal(a, b), f"{np.mean(np.any(a != b, -1)):.2%} rows"


def test_rsqrt_bits_equal_xla():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.random(50000) * 4 + 1e-6,
                        np.exp(rng.uniform(-60, 60, 50000)),
                        [1.0, 2.0, 4.0, 1e-5, 3.4e38, 1.2e-38]]
                       ).astype(np.float32)      # positive normal numbers
    ref = np.asarray(jax.jit(jax.lax.rsqrt)(v))
    out = TL._rsqrt(torch.from_numpy(v)).numpy()
    assert np.array_equal(ref.view(np.int32), out.view(np.int32))


_NESTED = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, jax, jax.numpy as jnp, torch
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro.serving import engine as JE
from repro.serving.paged_cache import PagedKVPool as JPool
from repro_torch.configs import get_config
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as TE
from repro_torch.serving.paged_cache import PagedKVPool as TPool
from _torch_parity import torch_params
red = dict(n_layers=2, d_head=32, vocab=256)
cfg_j, cfg_t = jget("llama3-8b").reduced(**red), \
    get_config("llama3-8b").reduced(**red)
qj = JQ(w_bits=8, a_bits=8, kv_bits=8, nested_bits=4)
qt = QuantConfig(w_bits=8, a_bits=8, kv_bits=8, nested_bits=4)
pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(1)), qj)
pt = torch_params(pj, cfg_t)
jpool, tpool = JPool(cfg_j, 9, 16, quant=qj), \
    TPool(cfg_t, 9, 16, quant=qt, device="cpu")
rng = np.random.default_rng(7)
prompt = [rng.integers(0, 256, (6,)) for _ in range(3)][2]
toks = np.zeros((1, 16), np.int32)
toks[0, :6] = prompt
pos = np.full((1, 16), -1, np.int32)
pos[0, :6] = np.arange(6)
tables, lens = np.array([[1]], np.int32), np.zeros(1, np.int32)
last = np.array([5], np.int32)
lj, _ = JE.prefill_step_bucketed(
    pj, dict(tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
             last_idx=jnp.asarray(last)),
    jpool.step_caches(tables, lens), cfg_j, qj)
lt, _ = TE.prefill_step_bucketed(
    pt, dict(tokens=torch.as_tensor(toks), positions=torch.as_tensor(pos),
             last_idx=torch.as_tensor(last)),
    tpool.step_caches(tables, lens), cfg_t, qt)
d = np.abs(np.asarray(lj, np.float32) - lt.float().numpy()).max()
print("MAXDIFF", d)
"""


def test_nested_w4_logits_bit_identical_without_xla_excess_precision():
    """The case that showed the fault: a w8 checkpoint served at 4 bits,
    whose second layer's first norm differed from the reference's (its
    logits by up to 0.0342)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    out = subprocess.run([sys.executable, "-c", _NESTED, here], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    diff = float(out.stdout.split("MAXDIFF")[1].split()[0])
    assert diff == 0.0, out.stdout
