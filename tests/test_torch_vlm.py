"""The port's VLM path (qwen2-vl-7b: M-RoPE, the stub patch frontend)
against the reference package on the same bridged parameters.

A subprocess with XLA's excess precision off (see
tests/test_torch_model.py) runs both packages:

* ``apply_rope`` with M-RoPE, bit for bit, at the reduced sections (2,
  3, 3) over head dim 16 and at the published (16, 24, 24) over head dim
  128, on ``(3, B, S)`` positions whose three axes differ;
* ``attention_apply`` over the paged pool with such positions, bit for
  bit: the mask and the pool's position tags follow axis 1 (the height
  axis, the reference's ``positions[ndim - 2]``, two tokens a row here,
  so a token sees its row's next one); the same call with axes 0 and 1
  swapped gives other outputs, so the check can tell;
* reduced qwen2-vl-7b logits through the paged kv8 pool with random
  ``patch_embeds`` and distinct axes, at bf16 weights and at the
  config's own w2/a8.  At ``d_head=32`` (the head dim the other parity
  tests use; sections (4, 6, 6) to fill its rotary half) they equal the
  reference's bit for bit.  At the reduced default, head dim 16, the
  plain paged attention's f32 dot products (``torch.einsum``) sum in
  another order than XLA:CPU's, which picks its order by shape; a score
  then moves by an f32 ulp and a bf16 output by one ulp, so those
  logits are held to ``LOGIT_RTOL`` of the largest;
* both engines serve three prompts at w2/a8/kv8: the port's contiguous
  and paged engines (given ``chunk_tokens``, dropped for VLMs) give the
  reference contiguous engine's greedy tokens, the paged pool drains,
  and its prefix cache is off (the same tokens need not carry the same
  patch embeddings).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as E

ARCH = "qwen2-vl-7b"
# two bf16 ulps of the largest logit (see the module docstring)
LOGIT_RTOL = 2.0 ** -7
LOGIT_CASES = [f"{h}-{w}" for h in ("d32", "d16") for w in ("bf16", "w2")]

_RUN = r"""
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, jax, jax.numpy as jnp, torch
from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro.serving import engine as JE
from repro.serving.paged_cache import PagedKVPool as JPool
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models.config import QuantConfig as TQ
from repro_torch.serving import engine as TE
from repro_torch.serving.paged_cache import PagedKVPool as TPool
from _torch_parity import n, torch_params

ARCH = "qwen2-vl-7b"
rng = np.random.default_rng(0)
pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
pos[1, 12:] = -1
# three distinct axes (pads -1 on every axis); the height axis gives two
# tokens each row, so masking by it lets a token see its row's next one
p3 = np.stack([pos, np.where(pos >= 0, pos // 2, -1),
               np.where(pos >= 0, 2 * pos, -1)]).astype(np.int32)
tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
zeros = np.zeros(2, np.int32)


def diff(a, b):
    a = np.asarray(a, np.float32)
    b = n(b)
    return dict(maxdiff=float(np.abs(a - b).max()),
                scale=float(np.abs(a).max()), shape=list(b.shape))


out = {"rope": {}, "attn": {}, "logits": {}, "engine": {}}
red = {"d16": {}, "d32": dict(d_head=32, mrope_sections=(4, 6, 6))}
# M-RoPE alone: the reduced sections and the published ones
for name, over in (("reduced (2, 3, 3) d16", {}),
                   ("published (16, 24, 24) d128",
                    dict(d_head=128, mrope_sections=(16, 24, 24)))):
    cj, ct = jget(ARCH).reduced(**over), get_config(ARCH).reduced(**over)
    x = rng.standard_normal((2, 16, 3, ct.head_dim)).astype(np.float32)
    rj = jax.jit(lambda x: JL.apply_rope(x, jnp.asarray(p3), cj))(
        jnp.asarray(x, jnp.bfloat16))
    rt = TL.apply_rope(torch.as_tensor(x).bfloat16(), torch.as_tensor(p3), ct)
    out["rope"][name] = diff(rj, rt)

# attention over the paged pool at distinct axes, and with axes 0 and 1
# swapped (which must change the result)
cfg_j, cfg_t = jget(ARCH).reduced(n_layers=1), get_config(ARCH).reduced(
    n_layers=1)
qj, qt = JQ(w_bits=2, a_bits=8, kv_bits=8), TQ(w_bits=2, a_bits=8, kv_bits=8)
pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(3)), qj)
pt = torch_params(pj, cfg_t)
mix_j = jax.tree.map(lambda a: a[0], pj["blocks"][0]["mixer"])
mix_t = pt["layers"][0]["mixer"]
x = rng.standard_normal((2, 16, cfg_j.d_model)).astype(np.float32)
for name, pp in (("distinct axes", p3), ("axes 0 and 1 swapped",
                                         p3[[1, 0, 2]])):
    cj = jax.tree.map(lambda a: a[0], JPool(cfg_j, 9, 8, quant=qj)
                      .step_caches(tables, zeros)["blocks"][0])
    ct = TPool(cfg_t, 9, 8, quant=qt, device="cpu").step_caches(
        tables, zeros)["layers"][0]
    oj, cj = jax.jit(lambda p, h, c: JL.attention_apply(
        p, h, cfg_j, positions=jnp.asarray(pp), cache=c, quant=qj))(
            mix_j, jnp.asarray(x, jnp.bfloat16), cj)
    ot, ct = TL.attention_apply(mix_t, torch.as_tensor(x).bfloat16(), cfg_t,
                                positions=torch.as_tensor(pp), cache=ct,
                                quant=qt)
    r = diff(oj, ot)
    r["pos_tags_equal"] = bool(np.array_equal(np.asarray(cj["pos"]),
                                              ct["pos"].numpy()))
    r["pos_tags_lane0"] = ct["pos"][1:3].reshape(-1).tolist()
    r["out"] = n(ot).ravel().tolist()[:64]
    out["attn"][name] = r

# logits: patch embeds, distinct axes, the paged kv8 pool
for h, over in red.items():
    cfg_j = jget(ARCH).reduced(n_layers=2, **over)
    cfg_t = get_config(ARCH).reduced(n_layers=2, **over)
    raw = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    toks = rng.integers(0, cfg_j.vocab, (2, 16), dtype=np.int32)
    pe = rng.standard_normal((2, 8, cfg_j.d_model)).astype(np.float32)
    for w in ("bf16", "w2"):
        wb = None if w == "bf16" else 2
        qj = JQ(w_bits=wb, a_bits=8, kv_bits=8)
        qt = TQ(w_bits=wb, a_bits=8, kv_bits=8)
        pj = JM.quantize_params(raw, qj) if wb else raw
        pt = torch_params(pj, cfg_t)
        last = np.array([15, 11], np.int32)
        lj, _ = JE.prefill_step_bucketed(
            pj, dict(tokens=jnp.asarray(toks), positions=jnp.asarray(p3),
                     last_idx=jnp.asarray(last),
                     patch_embeds=jnp.asarray(pe, jnp.bfloat16)),
            JPool(cfg_j, 9, 8, quant=qj).step_caches(tables, zeros),
            cfg_j, qj)
        lt, _ = TE.prefill_step_bucketed(
            pt, dict(tokens=torch.as_tensor(toks),
                     positions=torch.as_tensor(p3),
                     last_idx=torch.as_tensor(last),
                     patch_embeds=torch.as_tensor(pe).bfloat16()),
            TPool(cfg_t, 9, 8, quant=qt, device="cpu").step_caches(
                tables, zeros), cfg_t, qt)
        out["logits"][f"{h}-{w}"] = diff(lj, lt)

# the engines at w2/a8/kv8
cfg_j, cfg_t = jget(ARCH).reduced(n_layers=2), get_config(ARCH).reduced(
    n_layers=2)
qj, qt = JQ(w_bits=2, a_bits=8, kv_bits=8), TQ(w_bits=2, a_bits=8, kv_bits=8)
pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(1)), qj)
pt = torch_params(pj, cfg_t)
prompts = [rng.integers(0, cfg_j.vocab, (k,), dtype=np.int32)
           for k in (5, 9, 14)]
prompts[2][:5] = prompts[0]          # a shared head: no prefix hit for vlm


def serve(E_, params, cfg, q, **kw):
    eng = E_.Engine(params, cfg, n_slots=2, max_len=32, quant=q, **kw)
    reqs = [E_.Request(prompt=p.copy(), max_new_tokens=5) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [[int(t) for t in r.out] for r in reqs], \
        [r.finish_reason for r in reqs], eng


ref, ref_reasons, _ = serve(JE, pj, cfg_j, qj)
for regime, kw in (("contiguous", {}),
                   ("paged", dict(paged=True, block_size=4,
                                  chunk_tokens=8))):
    got, reasons, eng = serve(TE, pt, cfg_t, qt, **kw)
    r = dict(ref=ref, ref_reasons=ref_reasons, port=got, reasons=reasons)
    if kw:
        eng.pool.validate(check_contents=True)
        rep = eng.report()
        r.update(chunk_tokens=eng.chunk_tokens,
                 prefix_cache=eng.pool.prefix_cache,
                 prefix_hits=rep["prefix_hits"],
                 free_blocks=rep["free_blocks"], n_usable=rep["n_usable"])
    out["engine"][regime] = r
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def exact():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    out = subprocess.run([sys.executable, "-c", _RUN, here], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT", 1)[1])


@pytest.mark.parametrize("case", ["reduced (2, 3, 3) d16",
                                  "published (16, 24, 24) d128"])
def test_mrope_bit_identical_to_reference(exact, case):
    r = exact["rope"][case]
    assert r["scale"] > 0 and r["maxdiff"] == 0.0, r


def test_attention_masks_and_tags_by_axis_1(exact):
    r, swapped = exact["attn"]["distinct axes"], \
        exact["attn"]["axes 0 and 1 swapped"]
    for x in (r, swapped):
        assert x["maxdiff"] == 0.0 and x["pos_tags_equal"], x
    # lane 0's blocks 1 and 2 hold its 16 tokens tagged with axis 1
    assert r["pos_tags_lane0"] == [i // 2 for i in range(16)], r
    assert swapped["pos_tags_lane0"] == list(range(16)), swapped
    assert r["out"] != swapped["out"]


@pytest.mark.parametrize("case", LOGIT_CASES)
def test_logits_match_reference(exact, case):
    r = exact["logits"][case]
    assert r["shape"] == [2, 256] and r["scale"] > 0, r
    if case.startswith("d32"):
        assert r["maxdiff"] == 0.0, r
    else:
        assert r["maxdiff"] <= LOGIT_RTOL * r["scale"], r


@pytest.mark.parametrize("regime", ["contiguous", "paged"])
def test_engine_tokens_equal_reference(exact, regime):
    r = exact["engine"][regime]
    assert r["ref_reasons"] == ["length"] * 3 == r["reasons"], r
    assert r["port"] == r["ref"], r
    if regime == "paged":
        assert r["chunk_tokens"] is None and not r["prefix_cache"], r
        assert r["prefix_hits"] == 0, r
        assert r["free_blocks"] == r["n_usable"], r


def test_engine_drops_chunk_tokens_and_prefix_cache_for_vlm():
    """In process, the port alone: M-RoPE positions on every dispatch."""
    cfg = get_config(ARCH).reduced(n_layers=1)
    q = QuantConfig(w_bits=2, a_bits=8, kv_bits=8)
    params = M.init_params(cfg, seed=0, device="cpu", quant=q)
    eng = E.Engine(params, cfg, n_slots=2, max_len=32, quant=q, paged=True,
                   block_size=4, chunk_tokens=8)
    assert eng.chunk_tokens is None and not eng.pool.prefix_cache
    assert eng.pool.slots is None            # no state: blocks only
    seen = []
    forward = M.forward

    def spy(params, tokens, cfg_, *, positions, **kw):
        seen.append((tuple(positions.shape), kw.get("patch_embeds") is not None))
        return forward(params, tokens, cfg_, positions=positions, **kw)

    M.forward = spy
    try:
        req = E.Request(prompt=np.arange(6, dtype=np.int32), max_new_tokens=3)
        eng.submit(req)
        eng.run()
    finally:
        M.forward = forward
    assert req.finish_reason == "length" and len(req.out) == 3
    # the prefill (bucketed to 8, with zero patch embeds), then decodes at
    # (3, B, 1) with the batch bucketed to 1
    assert seen[0] == ((3, 1, 8), True), seen
    assert all(s == ((3, 1, 1), False) for s in seen[1:]), seen
