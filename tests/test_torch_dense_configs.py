"""The port's remaining dense configs -- glm4-9b (GQA group 8 reduced,
partial rotary 0.5), stablelm-3b (layernorm with bias, partial rotary
0.25, MHA, w3) and minicpm-2b (embedding scale, depth-scaled residuals,
scaled and tied logits) -- against the reference package on the same
bridged parameters, reduced to ``n_layers=2, d_head=32, vocab=256``.

With XLA's excess precision off (a subprocess: the flag must be set
before JAX starts; see tests/test_torch_model.py) the port's logits
through a paged ``(9, 8)`` kv8 pool equal the reference's bit for bit:

* each config at bf16 weights and at w2 (the config's own a8), with the
  fused and the unfused linear;
* stablelm at its own head dim 80 (three packed KV words) and its own
  w3, fused and unfused.

Then both packages' engines serve the same prompts at each config's own
quantization, paged (``chunk_tokens=8``) with a ``kv_bits=8`` override
-- none of the three configs sets ``kv_bits``, and the paged pool stores
packed KV only -- and contiguous with a float ring: the greedy tokens
are equal.
"""

import json
import os
import subprocess
import sys

import pytest

ARCHS = ["glm4-9b", "stablelm-3b", "minicpm-2b"]

# (case name, arch, reduction overrides, w_bits, fused_linear)
LOGIT_CASES = [(f"{a}-{'bf16' if w is None else f'w{w}'}-"
                f"{'fused' if f else 'unfused'}", a, {}, w, f)
               for a in ARCHS for w in (None, 2) for f in (True, False)]
LOGIT_CASES += [(f"stablelm-3b-dhead80-w3-{'fused' if f else 'unfused'}",
                 "stablelm-3b", dict(d_head=80), 3, f) for f in (True, False)]
ENGINE_CASES = [f"{a}-{kind}" for a in ARCHS for kind in ("paged-kv8",
                                                          "contiguous-float")]

_EXACT = r"""
import dataclasses, json, sys
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
logit_cases, archs = json.loads(sys.argv[2]), json.loads(sys.argv[3])
RED = dict(n_layers=2, d_head=32, vocab=256)


def configs(arch, over):
    red = dict(RED, **over)
    return jget(arch).reduced(**red), get_config(arch).reduced(**red)


rng = np.random.default_rng(0)
toks = rng.integers(0, 256, (2, 16), dtype=np.int32)
pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
pos[1, 12:] = -1
tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
lens, last = np.zeros(2, np.int32), np.array([15, 11], np.int32)
out = {"logits": {}, "engine": {}}
raw = {}
for name, arch, over, w_bits, fused in logit_cases:
    cfg_j, cfg_t = configs(arch, over)
    key = (arch, json.dumps(over))
    if key not in raw:
        raw[key] = JM.init_params(cfg_j, jax.random.PRNGKey(len(raw)))
    qj = JQ(w_bits=w_bits, a_bits=8, kv_bits=8, fused_linear=fused)
    qt = QuantConfig(w_bits=w_bits, a_bits=8, kv_bits=8, fused_linear=fused)
    pj = JM.quantize_params(raw[key], qj)
    pt = torch_params(pj, cfg_t)
    jpool = JPool(cfg_j, 9, 8, quant=qj)
    tpool = TPool(cfg_t, 9, 8, quant=qt, device="cpu")
    lj, _ = JE.prefill_step_bucketed(
        pj, dict(tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                 last_idx=jnp.asarray(last)),
        jpool.step_caches(tables, lens), cfg_j, qj)
    lt, _ = TE.prefill_step_bucketed(
        pt, dict(tokens=torch.as_tensor(toks), positions=torch.as_tensor(pos),
                 last_idx=torch.as_tensor(last)),
        tpool.step_caches(tables, lens), cfg_t, qt)
    a, b = np.asarray(lj, np.float32), lt.float().numpy()
    out["logits"][name] = dict(maxdiff=float(np.abs(a - b).max()),
                               scale=float(np.abs(a).max()),
                               finite=bool(np.isfinite(b).all()),
                               shape=list(b.shape), vocab=cfg_t.vocab_padded)

prompts = [rng.integers(0, 256, (n,), dtype=np.int32) for n in (5, 12)]
for arch in archs:
    cfg_j, cfg_t = configs(arch, {})
    own = cfg_j.quant
    # the packed weights depend on w_bits only: one set serves both caches
    pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(7)), own)
    pt = torch_params(pj, cfg_t)
    for kind, kv in (("paged-kv8", 8), ("contiguous-float", None)):
        qj = dataclasses.replace(own, kv_bits=kv)
        qt = QuantConfig(w_bits=own.w_bits, a_bits=own.a_bits, kv_bits=kv)
        kw = dict(paged=True, block_size=8, chunk_tokens=8) \
            if kind == "paged-kv8" else dict(paged=False)
        toks_out = {}
        for side, E_, p, c, q in (("ref", JE, pj, cfg_j, qj),
                                  ("port", TE, pt, cfg_t, qt)):
            eng = E_.Engine(p, c, n_slots=2, max_len=48, quant=q, **kw)
            reqs = [E_.Request(prompt=x.copy(), max_new_tokens=6)
                    for x in prompts]
            for r in reqs:
                eng.submit(r)
            eng.run()
            toks_out[side] = [[int(t) for t in r.out] for r in reqs]
            toks_out[side + "_reasons"] = [r.finish_reason for r in reqs]
        out["engine"][f"{arch}-{kind}"] = toks_out
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def exact():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    out = subprocess.run([sys.executable, "-c", _EXACT, here,
                          json.dumps(LOGIT_CASES), json.dumps(ARCHS)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT", 1)[1])


@pytest.mark.parametrize("case", [c[0] for c in LOGIT_CASES])
def test_logits_bit_identical_without_xla_excess_precision(exact, case):
    r = exact["logits"][case]
    assert r["finite"] and r["shape"] == [2, r["vocab"]], r
    assert r["scale"] > 0, r
    assert r["maxdiff"] == 0.0, r


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_greedy_tokens_equal_reference(exact, case):
    r = exact["engine"][case]
    assert r["port"] == r["ref"], r
    assert r["port_reasons"] == ["length"] * 2 == r["ref_reasons"], r
    assert all(len(o) == 6 for o in r["port"])


def test_configs_copy_the_reference_fields():
    """Every field of the port's config equals the reference's (the port
    keeps its own copies; minicpm's residual scale is numpy's
    ``1.4 / sqrt(40)``)."""
    import dataclasses

    from repro.configs import get_config as jget
    from repro_torch.configs import ARCHS as PORTED
    from repro_torch.configs import get_config
    assert PORTED == ("minicpm-2b", "stablelm-3b", "glm4-9b", "llama3-8b",
                      "mamba2-130m", "jamba-1.5-large-398b", "qwen2-vl-7b",
                      "deepseek-moe-16b", "mixtral-8x7b",
                      "seamless-m4t-medium")
    for arch in PORTED:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget(arch)), arch
    assert get_config("stablelm-3b").head_dim == 80
    assert get_config("glm4-9b").n_heads // get_config("glm4-9b").n_kv_heads \
        == 16
