"""The port's contiguous engine (``Engine(paged=False)``) against the
reference's, and its ring cache, bucketed prefill and request API on
their own.

Token identity with the reference is checked with XLA's excess
precision off (a subprocess: the flag must be set before JAX starts),
where the reference's logits equal the port's bit for bit -- in
process, XLA keeps some bf16 intermediates at f32 precision (see
tests/test_torch_model.py).  Three setups: reduced llama3-8b at
w2/a8/kv8 with the unfused linear (K3 + K5, K6's plain version),
reduced llama3-8b at w2/a8 with a float cache (``_attn_core``), and
reduced mixtral-8x7b at w2/a8/kv8 with prompts longer than its
64-token window (the tail store and the ring rewind).  The cache
contents after a prefill are compared through ``repro_torch.bridge``,
bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as E

from _torch_parity import to_numpy_tree

SETUPS = {
    "llama-w2a8kv8-unfused": ("llama3-8b", 8, False, [5, 13, 21], 48),
    "llama-w2a8-float-kv": ("llama3-8b", None, True, [5, 13, 21], 48),
    "mixtral-w2a8kv8-past-window": ("mixtral-8x7b", 8, True, [70, 20, 90],
                                    128),
}

_EXACT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, jax, torch
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro.serving import engine as JE
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as TE
from _torch_parity import to_numpy_tree, torch_params
setups = json.loads(sys.argv[2])
out = {}
for name, (arch, kvb, fused, lens, max_len) in setups.items():
    red = dict(n_layers=2, d_head=32)
    if arch == "llama3-8b":
        red["vocab"] = 256
    cfg_j, cfg_t = jget(arch).reduced(**red), get_config(arch).reduced(**red)
    qj = JQ(w_bits=2, a_bits=8, kv_bits=kvb, fused_linear=fused)
    qt = QuantConfig(w_bits=2, a_bits=8, kv_bits=kvb, fused_linear=fused)
    pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(0)), qj)
    pt = torch_params(pj, cfg_t)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg_j.vocab, (n,), dtype=np.int32)
               for n in lens]
    toks, prefills = {}, {}
    for side, E_, p, c, q in (("ref", JE, pj, cfg_j, qj),
                              ("port", TE, pt, cfg_t, qt)):
        eng = E_.Engine(p, c, n_slots=2, max_len=max_len, quant=q,
                        paged=False)
        prefills[side] = eng._bucketed_prefill(prompts[-1])[1]
        reqs = [E_.Request(prompt=x.copy(), max_new_tokens=8)
                for x in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        toks[side] = [[int(t) for t in r.out] for r in reqs]
    want = bridge.caches_from_numpy(to_numpy_tree(prefills["ref"]), cfg_t,
                                    device="cpu")
    got = prefills["port"]
    equal = all(torch.equal(a[k], b[k])
                for a, b in zip(want["layers"], got["layers"]) for k in a)
    back = bridge.caches_to_numpy(want, cfg_t)
    ref_np = to_numpy_tree(prefills["ref"])
    round_trip = all(
        np.array_equal(np.asarray(back["blocks"][i][k], np.float32),
                       np.asarray(ref_np["blocks"][i][k], np.float32))
        for i in range(len(back["blocks"])) for k in back["blocks"][i])
    out[name] = dict(ref=toks["ref"], port=toks["port"], caches=equal,
                     round_trip=round_trip,
                     keys=sorted(got["layers"][0]))
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def exact_runs():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    out = subprocess.run([sys.executable, "-c", _EXACT, here,
                          json.dumps(SETUPS)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT", 1)[1])


@pytest.mark.parametrize("setup", list(SETUPS))
def test_contiguous_engine_tokens_identical_to_reference(exact_runs, setup):
    r = exact_runs[setup]
    assert r["port"] == r["ref"], r
    assert all(len(o) == 8 for o in r["port"])


@pytest.mark.parametrize("setup", list(SETUPS))
def test_prefill_cache_contents_bit_exact_through_bridge(exact_runs, setup):
    r = exact_runs[setup]
    assert r["caches"] and r["round_trip"], r
    want = {"index", "k", "pos", "v"}
    if SETUPS[setup][1]:
        want |= {"k_scale", "v_scale"}
    assert set(r["keys"]) == want


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _cfg(**red):
    return get_config("llama3-8b").reduced(**(dict(n_layers=2, d_head=32,
                                                   vocab=256) | red))


def _serve(eng, prompts, max_new=8):
    reqs = [E.Request(prompt=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.finish_reason == "length" for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("fused", [True, False])
def test_contiguous_tokens_equal_paged_tokens(fused):
    """At equal kv_bits, the contiguous ring and the paged pool serve the
    same tokens (paging changes memory management, not math), whole
    prompt and chunked."""
    cfg = _cfg()
    q = QuantConfig(w_bits=2, a_bits=8, kv_bits=8, fused_linear=fused)
    params = M.init_params(cfg, seed=5, device="cpu", quant=q)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, (n,), dtype=np.int32)
               for n in (6, 17, 30)]
    contiguous = _serve(E.Engine(params, cfg, n_slots=2, max_len=48,
                                 quant=q), prompts)
    for kw in (dict(), dict(chunk_tokens=8)):
        paged = _serve(E.Engine(params, cfg, n_slots=2, max_len=48, quant=q,
                                paged=True, block_size=8, **kw), prompts)
        assert paged == contiguous, kw


def _direct_greedy(params, cfg, prompt, n_new, max_len=32):
    """Oracle: exact-length prefill + greedy decode, no engine."""
    caches = M.init_caches(cfg, 1, max_len, device="cpu")
    s = len(prompt)
    logits, caches = E.prefill_step(
        params, {"tokens": torch.as_tensor(prompt)[None],
                 "positions": torch.arange(s, dtype=torch.int32)[None]},
        caches, cfg)
    out = [int(logits[0].float().argmax())]
    for i in range(n_new - 1):
        logits, caches = E.serve_step(
            params, {"tokens": torch.tensor([[out[-1]]], dtype=torch.int32),
                     "positions": torch.tensor([[s + i]],
                                               dtype=torch.int32)},
            caches, cfg)
        out.append(int(logits[0].float().argmax()))
    return out


def test_bucketed_prefill_ring_index_rewinds_to_real_length():
    """A prompt whose bucket reaches max_len must NOT wrap the ring and
    overwrite live prompt KV: the write index is rewound to the real
    length so decode consumes the pad slots first."""
    cfg = _cfg()
    params = M.init_params(cfg, seed=1, device="cpu")
    prompt = np.arange(17, dtype=np.int32) % cfg.vocab   # buckets to 32
    eng = E.Engine(params, cfg, n_slots=1, max_len=32)
    _, one = eng._bucketed_prefill(prompt)
    assert all(int(c["index"][0]) == 17 for c in one["layers"])
    req = E.Request(prompt=prompt.copy(), max_new_tokens=6)
    eng.submit(req)
    eng.run()
    assert req.out == _direct_greedy(params, cfg, prompt, 6), req.out


def test_contiguous_engine_serves_prompt_longer_than_ring():
    """Prompts past the ring take the exact-length tail-store prefill:
    the request completes and other requests are not stranded."""
    cfg = _cfg()
    params = M.init_params(cfg, seed=1, device="cpu")
    eng = E.Engine(params, cfg, n_slots=2, max_len=32)
    rng = np.random.default_rng(4)
    long_req = E.Request(prompt=rng.integers(0, cfg.vocab, (40,),
                                             dtype=np.int32),
                         max_new_tokens=4)
    short = E.Request(prompt=rng.integers(0, cfg.vocab, (6,),
                                          dtype=np.int32),
                      max_new_tokens=4)
    eng.submit(long_req)
    eng.submit(short)
    eng.run()
    assert long_req.done and short.done
    assert len(short.out) == 4


def test_async_api_on_the_contiguous_engine():
    """The same request-level API (cancel from the queue, deadline
    expiry on a lane) works on the contiguous engine -- it is a Request
    contract, not a paged feature."""
    cfg = _cfg()
    params = M.init_params(cfg, seed=1, device="cpu")
    t = [0.0]
    eng = E.Engine(params, cfg, n_slots=2, max_len=32, clock=lambda: t[0],
                   metrics=True)
    rng = np.random.default_rng(12)

    def mk(n, **kw):
        return E.Request(prompt=rng.integers(0, cfg.vocab, (4,),
                                             dtype=np.int32),
                         max_new_tokens=n, **kw)

    a, b, c = mk(6), mk(8, timeout=5.0), mk(2)
    ha, hb, hc = eng.submit(a), eng.submit(b), eng.submit(c)
    assert hc.cancel()                 # straight out of the queue
    assert c.done and c.finish_reason == "cancelled" and c.out == []
    eng.step()                         # a + b occupy the two lanes
    t[0] = 10.0
    eng.step()                         # b's lane expires
    assert b.done and b.finish_reason == "timeout"
    n_b = len(b.out)
    eng.run()
    assert a.done and a.finish_reason == "length" and len(a.out) == 6
    assert len(b.out) == n_b, "expired lane kept emitting"
    rep = eng.report()
    assert rep["running"] == 0 and rep["waiting"] == 0
    eng.obs.tracer.validate_all()        # every span tree balanced
    assert 'repro_requests_finished_total{reason="timeout"} 1' in \
        eng.obs.registry.render()


def test_engine_defaults_to_contiguous_and_rejects_chunking_without_pages():
    cfg = _cfg(n_layers=1)
    params = M.init_params(cfg, device="cpu")
    eng = E.Engine(params, cfg, n_slots=3, max_len=16)
    assert not eng.paged and eng.report()["n_slots"] == 3
    with pytest.raises(ValueError, match="chunk_tokens requires paged"):
        E.Engine(params, cfg, chunk_tokens=8)


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_make_kv_cache_layout_matches_reference(kv_bits):
    """One cache function for both layouts: the ring is min(max_len,
    window) slots with a per-row index, planes or float K/V -- the
    reference's tree, leaf for leaf, through the bridge; the paged pool
    calls it with (n_blocks, block_size)."""
    for arch, red in (("llama3-8b", {}), ("mixtral-8x7b", {})):
        cfg_j = jget(arch).reduced(n_layers=2, d_head=32, **red)
        cfg_t = get_config(arch).reduced(n_layers=2, d_head=32, **red)
        from repro.models.config import QuantConfig as JQ
        want = JM.init_caches(cfg_j, 3, 100, quant=JQ(kv_bits=kv_bits))
        got = M.init_caches(cfg_t, 3, 100, quant=QuantConfig(
            kv_bits=kv_bits), device="cpu")
        back = bridge.caches_to_numpy(got, cfg_t)
        ref = to_numpy_tree(want)
        assert back.keys() == ref.keys()
        for bw, bg in zip(ref["blocks"], back["blocks"]):
            assert bw.keys() == bg.keys()
            for k in bw:
                assert bg[k].shape == bw[k].shape, (arch, k)
                np.testing.assert_array_equal(
                    np.asarray(bg[k], np.float32),
                    np.asarray(bw[k], np.float32))
        ring = min(100, cfg_t.window) if cfg_t.window else 100
        assert got["layers"][0]["pos"].shape == (3, ring)
    if kv_bits:
        from repro_torch.serving.paged_cache import PagedKVPool
        pool = PagedKVPool(cfg_t, 5, 8, quant=QuantConfig(kv_bits=8),
                           device="cpu")
        assert pool.caches["layers"][0]["k"].shape[:2] == (5, 8)


def test_float_cache_prefill_then_decode_matches_full_forward():
    """A float ring: prefill t tokens then decode token t gives the
    logits of a cache-free forward over t+1 tokens (2e-2 of the largest
    logit: bf16 K/V rounded at the cache write)."""
    cfg = _cfg()
    params = M.init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, 256, (2, 12), dtype=np.int32))
    pos = torch.arange(12, dtype=torch.int32).repeat(2, 1)
    x, _ = M.forward(params, toks, cfg, positions=pos,
                     caches={"layers": [None] * cfg.n_layers})
    want = M._logits(params, x[:, -1:], cfg)[:, 0].float()
    caches = M.init_caches(cfg, 2, 32, device="cpu")
    _, caches = E.prefill_step(params, {"tokens": toks[:, :11],
                                        "positions": pos[:, :11]},
                               caches, cfg)
    got, _ = E.serve_step(params, {"tokens": toks[:, 11:],
                                   "positions": pos[:, 11:]}, caches, cfg)
    err = (got.float() - want).abs().max()
    assert err <= 2e-2 * want.abs().max(), err
    assert L.make_kv_cache(cfg, 1, 8, device="cpu")["k"].dtype == \
        torch.bfloat16
