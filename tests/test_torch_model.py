"""Parity of the port's dense model (``repro_torch.models``) with the
reference ``repro.models`` on the same bridged parameters, through the
paged step caches (a bucketed chunk prefill, then a decode step).

Tolerance: the reference runs its forward under XLA, which by default
keeps bf16 intermediates at f32 precision across fused ops (the norm
output feeding the activation quantizer, the epilogue casts); the port
rounds at every cast point.  In process, logits therefore agree to 6% of
the largest logit with w2 weights (a one-ulp change of a quantizer input
moves an 8-bit activation code) and to 1.5% with bf16 weights.  With
XLA's excess precision disabled (a subprocess, since the flag must be
set before JAX starts) the w2/a8/kv8 logits are bit-identical -- the
in-process gap is XLA's, not the port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro.serving import engine as JE
from repro.serving.paged_cache import PagedKVPool as JPool
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as TE
from repro_torch.serving.paged_cache import PagedKVPool as TPool

from _torch_parity import n, to_numpy_tree, torch_params

REDUCED = [dict(n_layers=2, d_head=32, vocab=256), dict(n_layers=2)]


def _configs(red):
    return jget("llama3-8b").reduced(**red), \
        get_config("llama3-8b").reduced(**red)


@pytest.fixture(scope="module", params=range(len(REDUCED)),
                ids=["dhead32", "dhead16"])
def model_pair(request):
    red = REDUCED[request.param]
    cfg_j, cfg_t = _configs(red)
    params = JM.init_params(cfg_j, jax.random.PRNGKey(request.param))
    return cfg_j, cfg_t, params


@pytest.mark.parametrize("w_bits,rel_tol", [(None, 0.015), (2, 0.06)])
def test_logits_match_reference_through_paged_caches(model_pair, w_bits,
                                                      rel_tol):
    cfg_j, cfg_t, params = model_pair
    qj = JQ(w_bits=w_bits, a_bits=8, kv_bits=8)
    qt = QuantConfig(w_bits=w_bits, a_bits=8, kv_bits=8)
    pj = JM.quantize_params(params, qj)
    pt = torch_params(pj, cfg_t)
    jpool = JPool(cfg_j, 9, 8, quant=qj)
    tpool = TPool(cfg_t, 9, 8, quant=qt, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab, (2, 16), dtype=np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    pos[1, 12:] = -1                              # a bucketed pad tail
    tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    last = np.array([15, 11], np.int32)
    lens0 = np.zeros(2, np.int32)
    lj, cj = JE.prefill_step_bucketed(
        pj, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
             "last_idx": jnp.asarray(last)},
        jpool.step_caches(tables, lens0), cfg_j, qj)
    jpool.absorb(cj)
    lt, ct = TE.prefill_step_bucketed(
        pt, {"tokens": torch.as_tensor(toks),
             "positions": torch.as_tensor(pos),
             "last_idx": torch.as_tensor(last)},
        tpool.step_caches(tables, lens0), cfg_t, qt)
    tpool.absorb(ct)
    a, b = np.asarray(lj, np.float32), n(lt)
    scale = np.abs(a).max()
    assert np.abs(a - b).max() <= rel_tol * scale, np.abs(a - b).max()
    # pool contents: same positions; planes agree where K/V agree
    np.testing.assert_array_equal(
        np.asarray(jpool.caches["blocks"][0]["pos"][0]),
        tpool.caches["layers"][0]["pos"].numpy())
    # one decode step on top of the prefilled pool
    dt = np.array([[5], [7]], np.int32)
    dp = np.array([[16], [12]], np.int32)
    dl = np.array([16, 12], np.int32)
    lj, cj = JE.serve_step(pj, {"tokens": jnp.asarray(dt),
                                "positions": jnp.asarray(dp)},
                           jpool.step_caches(tables, dl), cfg_j, qj)
    lt, ct = TE.serve_step(pt, {"tokens": torch.as_tensor(dt),
                                "positions": torch.as_tensor(dp)},
                           tpool.step_caches(tables, dl), cfg_t, qt)
    a, b = np.asarray(lj, np.float32), n(lt)
    assert np.abs(a - b).max() <= rel_tol * np.abs(a).max()


_EXACT = r"""
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
qj, qt = JQ(w_bits=2, a_bits=8, kv_bits=8), \
    QuantConfig(w_bits=2, a_bits=8, kv_bits=8)
pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(0)), qj)
pt = torch_params(pj, cfg_t)
jpool, tpool = JPool(cfg_j, 9, 8, quant=qj), \
    TPool(cfg_t, 9, 8, quant=qt, device="cpu")
rng = np.random.default_rng(0)
toks = rng.integers(0, 256, (2, 16), dtype=np.int32)
pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
pos[1, 12:] = -1
tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
lens, last = np.zeros(2, np.int32), np.array([15, 11], np.int32)
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


def test_w2_logits_bit_identical_without_xla_excess_precision():
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    out = subprocess.run([sys.executable, "-c", _EXACT, here], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    diff = float(out.stdout.split("MAXDIFF")[1].split()[0])
    assert diff == 0.0, out.stdout


def test_load_path_quantization_bit_identical(model_pair):
    """The port's quantize_params (MSE clip search, nested scales, the
    pack -- K3's plain version on the CPU) gives the reference's packed
    weights bit for bit from the same bf16 weights."""
    cfg_j, cfg_t, params = model_pair
    qj = JQ(w_bits=2, a_bits=8, kv_bits=8)
    qt = QuantConfig(w_bits=2, a_bits=8, kv_bits=8)
    want = torch_params(JM.quantize_params(params, qj), cfg_t)
    got = TM.quantize_params(torch_params(params, cfg_t), qt)
    for lw, lg in zip(want["layers"] + [want], got["layers"] + [got]):
        keys = [("mixer", k) for k in ("wq", "wk", "wv", "wo")] + \
            [("ffn", k) for k in ("w_up", "w_gate", "w_down")]
        if lw is want:
            keys = [(None, "lm_head")]
        for sect, key in keys:
            a = (lw[sect] if sect else lw)[key]["w"]
            b = (lg[sect] if sect else lg)[key]["w"]
            assert torch.equal(a.packed, b.packed), key
            assert torch.equal(a.scale, b.scale), key
            assert torch.equal(a.width_scales, b.width_scales), key


def test_bridge_unstacks_layers_and_keeps_bits(model_pair):
    cfg_j, cfg_t, params = model_pair
    tree = to_numpy_tree(JM.quantize_params(params, JQ(w_bits=2)))
    tp = torch_params(JM.quantize_params(params, JQ(w_bits=2)), cfg_t)
    assert len(tp["layers"]) == cfg_t.n_layers
    for i, layer in enumerate(tp["layers"]):
        w = layer["mixer"]["wq"]["w"]
        np.testing.assert_array_equal(
            tree["blocks"][0]["mixer"]["wq"]["w"]["packed"][i].view(np.int32),
            w.packed.numpy())
        assert w.shape == (cfg_t.n_heads * cfg_t.head_dim, cfg_t.d_model)
    emb = np.asarray(params["embed"]["w"].astype(jnp.float32))
    np.testing.assert_array_equal(emb, n(tp["embed"]["w"]))
    assert tp["embed"]["w"].dtype == torch.bfloat16


def test_init_params_seeded_and_quantized_layer_by_layer():
    cfg = get_config("llama3-8b").reduced(n_layers=2)
    q = QuantConfig(w_bits=2, a_bits=8, kv_bits=8)
    a = TM.init_params(cfg, seed=3, device="cpu", quant=q)
    b = TM.init_params(cfg, seed=3, device="cpu", quant=q)
    wa, wb = a["layers"][1]["ffn"]["w_down"]["w"], \
        b["layers"][1]["ffn"]["w_down"]["w"]
    assert wa.n_bits == 2 and torch.equal(wa.packed, wb.packed)
    assert a["lm_head"]["w"].packed.shape == (2, cfg.vocab_padded, 2)
    c = TM.init_params(cfg, seed=4, device="cpu")
    assert c["layers"][0]["mixer"]["wq"]["w"].dtype == torch.bfloat16


def test_entry_points_default_to_the_card(monkeypatch):
    """No CPU fallback: without a card the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b").reduced(n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_caches(cfg, batch=4, max_len=8, quant=QuantConfig(kv_bits=8))


def test_unported_configs_and_paths_raise():
    from repro_torch.configs import ARCHS
    assert len(ARCHS) == 10
    for arch in ARCHS:            # every reference arch is ported
        TM.check_supported(get_config(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")
    cfg = get_config("llama3-8b").reduced(n_layers=1)
    p = TM.init_params(cfg, device="cpu")
    # backpressure and the pool watchdog are ported: the engine builds,
    # a submit past a full queue is shed, and the watchdog validates
    for paged in (False, True):
        eng = TE.Engine(p, cfg, quant=QuantConfig(kv_bits=8), paged=paged,
                        max_len=32, block_size=8, max_queue=1)
        reqs = [TE.Request(prompt=np.arange(3, dtype=np.int32),
                           max_new_tokens=2) for _ in range(2)]
        for r in reqs:
            eng.submit(r)
        assert reqs[1].finish_reason == "rejected" and reqs[1].retry_after > 0
        eng.run()
        assert reqs[0].finish_reason == "length"
    eng = TE.Engine(p, cfg, quant=QuantConfig(kv_bits=8), paged=True,
                    max_len=32, block_size=8, validate_every=1)
    req = TE.Request(prompt=np.arange(3, dtype=np.int32), max_new_tokens=3)
    eng.submit(req)
    eng.run()
    assert req.finish_reason == "length" and eng.steps >= 2
    assert eng.pool.metrics.value(
        "repro_engine_fault_watchdog_violations") == 0
    eng = TE.Engine(p, cfg, quant=QuantConfig(kv_bits=8), max_len=32,
                    block_size=8, paged=True)
    assert eng.pool.n_usable == 4 * 32 // 8
    assert not TE.Engine(p, cfg, max_len=32).paged   # the default
