"""The port's MoE decoders (reduced mixtral-8x7b: every FFN a top-2 MoE,
sliding window 64; reduced deepseek-moe-16b: a dense ``first_dense``
prelude layer, then MoE with a shared expert) against the reference
package, on the same bridged w2/w3, a8, kv8 parameters.

* In process, logits through the paged caches (a bucketed chunk
  prefill, then a decode step) agree to ``test_torch_model.py``'s 6% of
  the largest logit (XLA's excess precision; see there).
* With XLA's excess precision off (a subprocess, since the flag must be
  set before JAX starts): every token's top-k experts are the same in
  every MoE layer -- checked first, so that a router near-tie shows up
  as a routing flip -- and the logits are bit-identical; then
  ``Engine(paged=True, chunk_tokens=8, metrics=True)`` of both packages
  serves the same prompts (mixtral's longer than its window, so
  out-of-window blocks are reclaimed): greedy tokens, the reclaim count
  and every ``repro_moe_*`` metric are equal.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving.paged_cache import PagedKVPool as JPool
from repro_torch.configs import get_config
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as TE
from repro_torch.serving.paged_cache import PagedKVPool as TPool

from _torch_parity import n, torch_params

ARCHS = ["mixtral-8x7b", "deepseek-moe-16b"]
RED = dict(n_layers=2, d_head=32)


def _setup(name):
    cfg_j, cfg_t = jget(name).reduced(**RED), get_config(name).reduced(**RED)
    qj = dataclasses.replace(cfg_j.quant, kv_bits=8)
    qt = QuantConfig(w_bits=qj.w_bits, a_bits=qj.a_bits, kv_bits=8)
    pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(1)), qj)
    return cfg_j, cfg_t, qj, qt, pj, torch_params(pj, cfg_t)


def _prefill_batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 16), dtype=np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    pos[1, 12:] = -1                              # a bucketed pad tail
    return (toks, pos, np.array([[1, 2, 3], [4, 5, 0]], np.int32),
            np.array([15, 11], np.int32))


@pytest.mark.parametrize("name", ARCHS)
def test_logits_match_reference_through_paged_caches(name):
    cfg_j, cfg_t, qj, qt, pj, pt = _setup(name)
    assert len(pt["layers"]) == 2 and \
        ("shared" in pt["layers"][1]["ffn"]) == (name != "mixtral-8x7b")
    jpool, tpool = JPool(cfg_j, 9, 8, quant=qj), \
        TPool(cfg_t, 9, 8, quant=qt, device="cpu")
    toks, pos, tables, last = _prefill_batch()
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
    assert np.abs(a - b).max() <= 0.06 * np.abs(a).max()
    dt = np.array([[5], [7]], np.int32)
    dp = np.array([[16], [12]], np.int32)
    dl = np.array([16, 12], np.int32)
    lj, _ = JE.serve_step(pj, {"tokens": jnp.asarray(dt),
                               "positions": jnp.asarray(dp)},
                          jpool.step_caches(tables, dl), cfg_j, qj)
    lt, _ = TE.serve_step(pt, {"tokens": torch.as_tensor(dt),
                               "positions": torch.as_tensor(dp)},
                          tpool.step_caches(tables, dl), cfg_t, qt)
    a, b = np.asarray(lj, np.float32), n(lt)
    assert np.abs(a - b).max() <= 0.06 * np.abs(a).max()


_EXACT = r"""
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, jax, jax.numpy as jnp, torch
from repro.models import layers as JL
from repro.serving import engine as JE
from repro.serving.paged_cache import PagedKVPool as JPool
from repro_torch.models import layers as TL
from repro_torch.serving import engine as TE
from repro_torch.serving.paged_cache import PagedKVPool as TPool
from test_torch_moe_engine import ARCHS, _prefill_batch, _setup

routes = {"j": [], "t": []}
orig_j, orig_t = JL.moe_apply, TL.moe_apply


def rec_j(params, x, cfg, quant=None, **kw):   # each token's top-k experts
    lg = jnp.einsum("btd,ed->bte", x.astype(jnp.float32),
                    params["router"]["w"])
    _, te = jax.lax.top_k(jax.nn.softmax(lg, -1), cfg.top_k)
    jax.debug.callback(lambda a: routes["j"].append(np.asarray(a)), te)
    return orig_j(params, x, cfg, quant, **kw)


def rec_t(params, x, cfg, quant=None, **kw):
    lg = torch.einsum("btd,ed->bte", x.float(), params["router"]["w"])
    routes["t"].append(torch.topk(torch.softmax(lg, -1), cfg.top_k,
                                  -1)[1].numpy())
    return orig_t(params, x, cfg, quant, **kw)


out = {}
for name in ARCHS:
    cfg_j, cfg_t, qj, qt, pj, pt = _setup(name)
    toks, pos, tables, last = _prefill_batch()
    lens = np.zeros(2, np.int32)
    JL.moe_apply, TL.moe_apply = rec_j, rec_t
    routes["j"].clear()
    routes["t"].clear()
    lj, _ = JE.prefill_step_bucketed(
        pj, dict(tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                 last_idx=jnp.asarray(last)),
        JPool(cfg_j, 9, 8, quant=qj).step_caches(tables, lens), cfg_j, qj)
    lj = np.asarray(lj, np.float32)
    lt, _ = TE.prefill_step_bucketed(
        pt, dict(tokens=torch.as_tensor(toks), positions=torch.as_tensor(pos),
                 last_idx=torch.as_tensor(last)),
        TPool(cfg_t, 9, 8, quant=qt, device="cpu").step_caches(tables, lens),
        cfg_t, qt)
    JL.moe_apply, TL.moe_apply = orig_j, orig_t
    rj, rt = np.stack(routes["j"]), np.stack(routes["t"])
    res = dict(routes=int(rj.size), route_agree=float((rj == rt).mean()),
               maxdiff=float(np.abs(lj - lt.float().numpy()).max()))
    rng = np.random.default_rng(3)
    base = 70 if cfg_t.window else 9        # mixtral: beyond the window
    prompts = [rng.integers(0, 256, (base + 5 * i,), dtype=np.int32)
               for i in range(2)]
    for tag, E, p, cfg, q in (("ref", JE, pj, cfg_j, qj),
                              ("port", TE, pt, cfg_t, qt)):
        eng = E.Engine(p, cfg, n_slots=2, max_len=96, quant=q, paged=True,
                       block_size=8, chunk_tokens=8, metrics=True)
        reqs = [E.Request(prompt=pr.copy(), max_new_tokens=6)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        res[tag] = dict(
            out=[[int(v) for v in r.out] for r in reqs],
            reasons=[r.finish_reason for r in reqs],
            reclaimed=int(eng.report()["window_reclaimed"]),
            moe=sorted(ln for ln in eng.obs.registry.render().splitlines()
                       if ln.startswith("repro_moe")))
    out[name] = res
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def exact():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    proc = subprocess.run([sys.executable, "-c", _EXACT, here], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=here)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.split("RESULT", 1)[1])


@pytest.mark.parametrize("name", ARCHS)
def test_routing_then_logits_bit_identical_without_xla_excess_precision(
        exact, name):
    res = exact[name]
    assert res["routes"] > 0
    assert res["route_agree"] == 1.0, res        # a router flip, if any
    assert res["maxdiff"] == 0.0, res


@pytest.mark.parametrize("name", ARCHS)
def test_engine_tokens_and_window_reclaim_match_reference(exact, name):
    ref, port = exact[name]["ref"], exact[name]["port"]
    assert port["reasons"] == ["length", "length"]
    assert port["out"] == ref["out"]
    assert port["reclaimed"] == ref["reclaimed"]
    if name == "mixtral-8x7b":                  # prompts exceed window 64
        assert port["reclaimed"] >= 1


@pytest.mark.parametrize("name", ARCHS)
def test_moe_metrics_match_reference(exact, name):
    ref, port = exact[name]["ref"], exact[name]["port"]
    assert any(ln.startswith("repro_moe_expert_load_count") for ln in
               port["moe"])
    assert port["moe"] == ref["moe"]
