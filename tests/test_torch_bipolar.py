"""Parity of the port's bipolar-INT format (``repro_torch.core.bipolar``)
with the reference ``repro.core.bipolar``, and the port's import
isolation.

The contract is bit identity: packed words, quantized values, scales
(absmax, the MSE clip search) and the nested per-width scales are equal
bit for bit for every width 1..8, odd K, both pad bits and every nested
slice width, on the same inputs made from a numpy seed.
"""

import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import bipolar as JB
from repro.kernels import ops as JO
from repro_torch.core import bipolar as TB
from repro_torch.kernels import ops as TO

from _torch_parity import n, t


def _words(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("n_bits", range(1, 9))
@pytest.mark.parametrize("k", [37, 64])
@pytest.mark.parametrize("pad_bit", [0, 1])
def test_pack_values_scales_and_nested_slices_bit_identical(n_bits, k,
                                                            pad_bit):
    rng = np.random.default_rng(100 * n_bits + k + pad_bit)
    x = (rng.standard_normal((9, k)) * 2.0).astype(np.float32)
    xt = t(x)
    # scales: absmax (reciprocal-multiply form) and the MSE clip search
    js = JB.absmax_scale(jnp.asarray(x), n_bits, axis=-1, keepdims=True)
    ts = TB.absmax_scale(xt, n_bits, axis=-1)
    np.testing.assert_array_equal(np.asarray(js), n(ts))
    # values, planes and packed words through the generic pipeline
    jq = JB.quantize_values(jnp.asarray(x), n_bits, js)
    tq = TB.quantize_values(xt, n_bits, ts)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    jpk = JB.pack_planes(JB.pad_for_packing(JB.decompose(jq, n_bits), -1,
                                            pad_bit), -1)
    tpk = TB.pack_planes(TB.pad_for_packing(TB.decompose(tq, n_bits), -1,
                                            pad_bit), -1)
    np.testing.assert_array_equal(_words(jpk), tpk.numpy())
    np.testing.assert_array_equal(
        np.asarray(JB.recover(JB.unpack_planes(jpk, -1, k), n_bits)),
        TB.recover(TB.unpack_planes(tpk, -1, k), n_bits).numpy())
    # the weight path: MSE scales + nested per-width scales + pack
    jw = JO.quantize_rows(jnp.asarray(x), n_bits, pad_bit=pad_bit,
                          impl="reference", scale_search=True)
    tw = TO.quantize_rows(xt, n_bits, pad_bit=pad_bit, scale_search=True)
    np.testing.assert_array_equal(_words(jw.packed), tw.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jw.scale), n(tw.scale))
    if n_bits > 1:
        np.testing.assert_array_equal(np.asarray(jw.width_scales),
                                      n(tw.width_scales))
    # every nested slice: planes, scales, and the dequantized tensor
    for kk in range(1, n_bits + 1):
        js_, ts_ = JB.nested_slice(jw, kk), TB.nested_slice(tw, kk)
        assert ts_.n_bits == js_.n_bits == kk
        np.testing.assert_array_equal(_words(js_.packed), ts_.packed.numpy())
        np.testing.assert_array_equal(np.asarray(js_.scale), n(ts_.scale))
        np.testing.assert_array_equal(
            np.asarray(JB.truncate_values(jq, n_bits, kk)),
            TB.truncate_values(tq, n_bits, kk).numpy())
        np.testing.assert_array_equal(np.asarray(JB.dequantize(js_)),
                                      n(TB.dequantize(ts_)))


@pytest.mark.parametrize("n_bits", [1, 3, 8])
def test_encode_decode_round_to_odd_match_reference(n_bits):
    """Half-way cases round half to even in both packages."""
    x = np.array([-4.0, -3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0, 4.0, 2.5,
                  -2.5, 0.5], np.float32)
    np.testing.assert_array_equal(np.asarray(JB.round_to_odd(jnp.asarray(x))),
                                  n(TB.round_to_odd(t(x))))
    v = np.arange(-(2 ** n_bits - 1), 2 ** n_bits, 2, dtype=np.int32)
    ju = JB.encode(jnp.asarray(v), n_bits)
    tu = TB.encode(t(v), n_bits)
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(np.asarray(JB.decode(ju, n_bits)),
                                  TB.decode(tu, n_bits).numpy())


def test_bit31_survives_packing():
    """Words with bit 31 set are negative int32 in the port and equal
    the reference's uint32 bits."""
    planes = np.ones((1, 2, 32), np.uint8)
    planes[0, 1, :31] = 0
    jw = JB.pack_planes(jnp.asarray(planes), -1)
    tw = TB.pack_planes(t(planes), -1)
    np.testing.assert_array_equal(_words(jw), tw.numpy())
    assert tw.numpy().ravel().tolist() == [-1, -(2 ** 31)]


_ISOLATION = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.configs import get_config
for arch in ("mixtral-8x7b", "deepseek-moe-16b"):
    assert get_config(arch).family == "moe", arch
for arch in ("glm4-9b", "stablelm-3b", "minicpm-2b"):
    assert get_config(arch).family == "dense", arch
assert get_config("mamba2-130m").family == "ssm"
assert get_config("jamba-1.5-large-398b").family == "hybrid"
assert get_config("qwen2-vl-7b").family == "vlm"
assert get_config("seamless-m4t-medium").family == "audio"
assert {"repro_torch.kernels.moe", "repro_torch.configs.mixtral_8x7b",
        "repro_torch.configs.deepseek_moe_16b", "repro_torch.configs.glm4_9b",
        "repro_torch.configs.stablelm_3b",
        "repro_torch.configs.minicpm_2b", "repro_torch.models.ssm",
        "repro_torch.configs.mamba2_130m",
        "repro_torch.configs.jamba_1_5_large_398b",
        "repro_torch.configs.qwen2_vl_7b",
        "repro_torch.configs.seamless_m4t_medium",
        "repro_torch.launch.specs", "repro_torch.data.pipeline",
        "repro_torch.optim.optimizer", "repro_torch.checkpoint.manager",
        "repro_torch.train.trainer", "repro_torch.core.tree",
        "repro_torch.launch.mesh", "repro_torch.distributed",
        "repro_torch.distributed.sharding",
        "repro_torch.distributed.compress",
        "repro_torch.distributed.pipeline"} <= set(names), names
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.")
             or (m == "jax" or m.startswith("jax.")) and sys.modules[m])
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_without_jax_or_reference_package():
    """Every module of repro_torch (the MoE kernel wrapper, the SSM
    mixer, the launch specs and meshes, the configs, the training stack
    and the distributed layer among them) imports with jax
    unimportable, and neither jax nor the reference package is loaded
    afterwards.  The walk reaches every module file of the package: one
    it skipped would fail the count."""
    import os
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src
    out = subprocess.run([sys.executable, "-c", _ISOLATION], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    count = int(out.stdout.split()[0])
    files = sum(name.endswith(".py") for _, _, names in os.walk(
        os.path.join(src, "repro_torch")) for name in names)
    assert count == files - 1 >= 52, (count, files, out.stdout)
