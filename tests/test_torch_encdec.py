"""The port's enc-dec path (reduced seamless-m4t-medium: 2 encoder and 2
decoder layers, d 64, 4 heads of 16, GELU, layernorm) against the
reference package on the same bridged parameters.

A subprocess with XLA's excess precision off (see
tests/test_torch_model.py) runs both packages:

* ``encode_frames`` on seeded random frames.  Its self-attention core
  is plain f32 math in both packages (jnp in the reference, torch here),
  and XLA:CPU's f32 dot products sum in an order that depends on the
  shape (the port's ``torch.einsum`` sums otherwise at these shapes), so
  the memory is held to ``MEMORY_RTOL`` of its largest value, not bit
  for bit.  Two witnesses tie that tolerance to the dot order: at w4/a8,
  with the reference's core answering the port's calls, the memory is
  the reference's bit for bit; and the port's core alone is within
  ``CORE_RTOL`` of the reference's, where a core with bf16 scores is
  not;
* given the reference's encoder memory, the decoder's logits through the
  paged pool (self-attention KV in blocks, the cross-K/V in state slots
  1 and 2) equal the reference's bit for bit, at bf16 weights and at the
  config's own w4/a8 with a kv8 pool, after the prefill and after a
  decode step that replays the slot-resident cross caches;
* ``cross_attention_apply`` alone -- prefill and decode, packed (kv8)
  and float, slotted (a pad lane on the null slot) and contiguous --
  against the reference's, bit for bit on the packed reads (K6's plain
  version) and within ``MEMORY_RTOL`` on the float ones (the f32 dot
  order again);
* both engines serve three prompts at w4/a8: the port's contiguous
  engine (kv8 and a float cache) and its paged engine (kv8; given
  ``chunk_tokens``, which the engine drops for audio) give the
  reference contiguous engine's greedy tokens, and the paged pool
  drains;
* the GELU epilogue's plain version gives ``jax.nn.gelu``'s f32 bits,
  and the bridge carries a prefilled reference cache's stacked ``cross``
  to the port's per-layer list and back.

In process, the port alone: ``make_cross_cache`` and
``_write_cross_slots`` (a pad lane's write dropped, rows past the
encoder length at position -1), the pool's cross tenant (``alloc_slot``
resets a reused slot's cross ``pos`` to -1 and ``validate`` expects -1
in the null row), a prefill then a decode step equal to the whole
prompt's prefill, and the engine dropping ``chunk_tokens``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as E
from repro_torch.serving.paged_cache import PagedKVPool

ARCH = "seamless-m4t-medium"
# the encoder memory (f32 attention inside) of the largest magnitude
MEMORY_RTOL = 2.0 ** -7
# the f32 attention core alone, of its largest output: 8 f32 ulps
CORE_RTOL = 2.0 ** -20
QUANTS = ["bf16", "w4a8kv8"]

_RUN = r"""
import json, sys
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
from repro_torch.models import model as TM
from repro_torch.models.config import QuantConfig as TQ
from repro_torch.serving import engine as TE
from repro_torch.serving.paged_cache import PagedKVPool as TPool
from _torch_parity import n, torch_params

ARCH = "seamless-m4t-medium"
cfg_j = jget(ARCH).reduced(n_layers=2)
cfg_t = get_config(ARCH).reduced(n_layers=2)
raw = JM.init_params(cfg_j, jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
frames = rng.standard_normal((2, 64, cfg_j.frontend_dim)).astype(np.float32)
fr_j = jnp.asarray(frames, jnp.bfloat16)
fr_t = torch.as_tensor(frames).to(torch.bfloat16)
toks = rng.integers(0, cfg_j.vocab, (2, 16), dtype=np.int32)
pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
pos[1, 12:] = -1
tables = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
slots = np.array([1, 2], np.int32)
last = np.array([15, 11], np.int32)


def diff(a, b):
    a = np.asarray(a, np.float32)
    b = n(b)
    return dict(maxdiff=float(np.abs(a - b).max()),
                scale=float(np.abs(a).max()),
                equal=float((a == b).mean()), shape=list(b.shape))


def quant(kind, kv=8):
    w = None if kind == "bf16" else 4
    return JQ(w_bits=w, a_bits=8, kv_bits=kv), TQ(w_bits=w, a_bits=8,
                                                   kv_bits=kv)


out = {"encode": {}, "encode_ref_core": {}, "prefill": {}, "decode": {},
       "cross": {}, "engine": {}}
port_core = TL._attn_core
ref_core = jax.jit(JL._attn_core,
                   static_argnames=("causal", "window", "chunked",
                                    "score_bf16"))


def with_ref_core(q, k, v, q_pos, kv_pos, **kw):
    # the port's attention core's call, answered by the reference's
    j = [jnp.asarray(n(a), jnp.bfloat16 if a.dtype == torch.bfloat16
                     else jnp.float32) for a in (q, k, v)] + \
        [jnp.asarray(q_pos.numpy()), jnp.asarray(kv_pos.numpy())]
    return torch.as_tensor(np.asarray(ref_core(*j, **kw)))


# the attention core alone at the encoder's shape (B 2, 4 heads, 64
# frames, d 16, not causal) on identical bf16 q/k/v: the port's f32
# output against the reference's, and a core whose scores are rounded
# to bf16 against the same bound
cg = np.random.default_rng(5)
qkv = [cg.standard_normal((2, 4, 64, 16)).astype(np.float32) * 2
       for _ in range(3)]
pos64 = np.tile(np.arange(64, dtype=np.int32), (2, 1))
core_j = np.asarray(ref_core(*[jnp.asarray(a, jnp.bfloat16) for a in qkv],
                             jnp.asarray(pos64), jnp.asarray(pos64),
                             causal=False, window=None, chunked=False))
tq, tk, tv = [torch.as_tensor(a).bfloat16() for a in qkv]
tpos = torch.as_tensor(pos64)
core_t = TL._attn_core(tq, tk, tv, tpos, tpos, causal=False, window=None,
                       chunked=False)
s16 = torch.einsum("bhqd,bhtd->bhqt", tq.float() * 0.25,
                   tk.float()).bfloat16().float()
p16 = torch.exp(s16 - s16.amax(-1, keepdim=True))
core_bf16 = torch.einsum("bhqt,bhtd->bhqd", p16, tv.float()) \
    / p16.sum(-1, keepdim=True)
out["core"] = dict(port=diff(core_j, core_t),
                   bf16_scores=diff(core_j, core_bf16))

for kind in ("bf16", "w4a8kv8"):
    qj, qt = quant(kind)
    pj = JM.quantize_params(raw, qj) if qj.enabled else raw
    pt = torch_params(pj, cfg_t)
    mem_j = jax.jit(lambda p, f: JM.encode_frames(
        p, f, cfg_j, quant=qj, remat=False))(pj, fr_j)
    mem_t = TM.encode_frames(pt, fr_t, cfg_t, quant=qt)
    out["encode"][kind] = diff(mem_j, mem_t)
    # the same encoder with only its attention core's arithmetic the
    # reference's: at w4/a8 every other step must then give the
    # reference's bits (at bf16 the linears are f32-accumulated bf16
    # dots, whose order differs too)
    if kind != "bf16":
        TL._attn_core = with_ref_core
        try:
            out["encode_ref_core"][kind] = diff(
                mem_j, TM.encode_frames(pt, fr_t, cfg_t, quant=qt))
        finally:
            TL._attn_core = port_core
    # the decoder, through the pool, given the reference's memory
    jpool = JPool(cfg_j, 9, 8, quant=qj, n_state_slots=2, enc_len=64)
    tpool = TPool(cfg_t, 9, 8, quant=qt, n_state_slots=2, enc_len=64,
                  device="cpu")
    lj, cj = JE.prefill_step_bucketed(
        pj, dict(tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                 last_idx=jnp.asarray(last), frames=fr_j),
        jpool.step_caches(tables, np.zeros(2, np.int32), slots=slots),
        cfg_j, qj)
    jpool.absorb(cj)
    ref_mem = torch.as_tensor(np.asarray(mem_j, np.float32)).to(
        torch.bfloat16)
    encode = TM.encode_frames
    TM.encode_frames = lambda *a, **k: ref_mem
    try:
        tc = tpool.step_caches(tables, np.zeros(2, np.int32), slots=slots)
        lt, tc = TE.prefill_step_bucketed(
            pt, dict(tokens=torch.as_tensor(toks),
                     positions=torch.as_tensor(pos),
                     last_idx=torch.as_tensor(last), frames=fr_t),
            tc, cfg_t, qt)
    finally:
        TM.encode_frames = encode
    tpool.absorb(tc)
    out["prefill"][kind] = diff(lj, lt)
    nxt = np.array([[3], [7]], np.int32)
    npos = np.array([[16], [12]], np.int32)
    lens = np.array([16, 12], np.int32)
    lj, _ = JE.serve_step(pj, dict(tokens=jnp.asarray(nxt),
                                   positions=jnp.asarray(npos)),
                          jpool.step_caches(tables, lens, slots=slots),
                          cfg_j, qj)
    lt, _ = TE.serve_step(pt, dict(tokens=torch.as_tensor(nxt),
                                   positions=torch.as_tensor(npos)),
                          tpool.step_caches(tables, lens, slots=slots),
                          cfg_t, qt)
    out["decode"][kind] = diff(lj, lt)

# cross_attention_apply alone: packed (kv8) and float, contiguous and
# slotted (lane 1 a pad lane on the null slot), prefill then decode
qj, qt = quant("w4a8kv8")
pj = JM.quantize_params(raw, qj)
pt = torch_params(pj, cfg_t)
xp_j = jax.tree.map(lambda a: a[0], pj["cross"]["attn"])
xp_t = pt["cross"][0]["attn"]
x = rng.standard_normal((2, 5, cfg_j.d_model)).astype(np.float32)
mem = rng.standard_normal((2, 64, cfg_j.d_model)).astype(np.float32)
x_j, x_t = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
m_j, m_t = jnp.asarray(mem, jnp.bfloat16), torch.as_tensor(mem).bfloat16()
xd_j, xd_t = x_j[:, :1], x_t[:, :1]
for kv in (8, None):
    for slotted in (False, True):
        name = f"{'kv8' if kv else 'float'}-{'slotted' if slotted else 'contiguous'}"
        if slotted and not kv:
            continue
        rows = 4 if slotted else 2
        cj = JL.make_cross_cache(cfg_j, rows, 64, jnp.bfloat16, kv_bits=kv)
        ct = TL.make_cross_cache(cfg_t, rows, 64, kv, "cpu")
        sl = np.array([2, -1], np.int32)
        if slotted:
            cj = dict(cj, slots=jnp.asarray(sl))
            ct = dict(ct, slots=torch.as_tensor(sl))
        f = jax.jit(lambda p, h, m, c: JL.cross_attention_apply(
            p, h, cfg_j, memory=m, cache=c, quant=qj))
        oj, cj = f(xp_j, x_j, m_j, cj)
        ot, ct = TL.cross_attention_apply(xp_t, x_t, cfg_t, memory=m_t,
                                          cache=ct, quant=qt)
        r = {"prefill": diff(oj, ot)}
        keys = ("k", "k_scale", "v", "v_scale", "pos") if kv \
            else ("k", "v", "pos")
        r["cache_equal"] = all(
            np.array_equal(np.asarray(cj[k]).view(np.int32)
                           if np.asarray(cj[k]).dtype == np.uint32
                           else np.asarray(cj[k], np.float32),
                           ct[k].numpy() if ct[k].dtype != torch.bfloat16
                           else ct[k].float().numpy()) for k in keys)
        g = jax.jit(lambda p, h, c: JL.cross_attention_apply(
            p, h, cfg_j, cache=c, quant=qj))
        oj, _ = g(xp_j, xd_j, cj)
        ot, _ = TL.cross_attention_apply(xp_t, xd_t, cfg_t, cache=ct,
                                         quant=qt)
        r["decode"] = diff(oj, ot)
        r["pad_lane_zero_attention"] = bool(
            not slotted or np.array_equal(
                n(ot[1]), n(TL.linear_apply(
                    xp_t["wo"], torch.zeros_like(xd_t[1:]), quant=qt)[0])))
        out["cross"][name] = r

# the engines: three prompts, greedy, the reference contiguous engine's
# tokens against the port's contiguous and paged engines
prompts = [rng.integers(0, cfg_j.vocab, (k,), dtype=np.int32)
           for k in (5, 9, 14)]


def serve(E_, params, cfg, q, **kw):
    eng = E_.Engine(params, cfg, n_slots=2, max_len=32, quant=q, **kw)
    reqs = [E_.Request(prompt=p.copy(), max_new_tokens=5) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [[int(t) for t in r.out] for r in reqs], \
        [r.finish_reason for r in reqs], eng


for kv in (8, None):
    qj = JQ(w_bits=4, a_bits=8, kv_bits=kv)
    qt = TQ(w_bits=4, a_bits=8, kv_bits=kv)
    pj = JM.quantize_params(raw, qj)
    pt = torch_params(pj, cfg_t)
    ref, ref_reasons, _ = serve(JE, pj, cfg_j, qj)
    regimes = {"contiguous": {}}
    if kv:
        regimes["paged"] = dict(paged=True, block_size=4, chunk_tokens=8)
    for regime, kw in regimes.items():
        got, reasons, eng = serve(TE, pt, cfg_t, qt, **kw)
        r = dict(ref=ref, ref_reasons=ref_reasons, port=got,
                 reasons=reasons)
        if kw:
            eng.pool.validate(check_contents=True)
            rep = eng.report()
            r.update(chunk_tokens=eng.chunk_tokens,
                     used_state_slots=rep["used_state_slots"],
                     free_blocks=rep["free_blocks"],
                     n_usable=rep["n_usable"],
                     prefix_cache=eng.pool.prefix_cache)
        out["engine"][f"{regime}-{'kv8' if kv else 'float'}"] = r

# the GELU epilogue's plain version against jax.nn.gelu, bit for bit
from repro_torch.kernels import ref as TR
g = np.random.default_rng(7).standard_normal(200000).astype(np.float32) * 4
gj = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(g)))
gt = torch.as_tensor(g)
out["gelu"] = dict(
    port=int((TR.apply_act(gt, "gelu").numpy() != gj).sum()),
    torch=int((torch.nn.functional.gelu(gt, approximate="tanh").numpy()
               != gj).sum()))

# the bridge: a reference contiguous cache after a prefill, to the port's
# layout (cross[j] = the reference's stacked cross[0][j]) and back
from repro_torch import bridge
from _torch_parity import to_numpy_tree
qj = JQ(w_bits=4, a_bits=8, kv_bits=8)
pj = JM.quantize_params(raw, qj)
cj = JM.init_caches(cfg_j, 2, 32, enc_len=64, quant=qj)
_, cj = JE.prefill_step(pj, dict(tokens=jnp.asarray(toks[:, :8]),
                                 frames=fr_j), cj, cfg_j, qj)
ref_np = to_numpy_tree(cj)
port = bridge.caches_from_numpy(ref_np, cfg_t, device="cpu")
back = bridge.caches_to_numpy(port, cfg_t)
out["bridge"] = dict(
    n_cross=len(port["cross"]),
    layout=all(np.array_equal(port["cross"][j][k].numpy().view(np.uint32)
                              if k in ("k", "v") else port["cross"][j][k].numpy(),
                              np.asarray(ref_np["cross"][0][k])[j])
               for j in range(cfg_t.n_layers)
               for k in ("k", "k_scale", "v", "v_scale", "pos")),
    round_trip=all(np.array_equal(back["cross"][0][k],
                                  np.asarray(ref_np["cross"][0][k]))
                   for k in ref_np["cross"][0]),
    filled=bool((np.asarray(ref_np["cross"][0]["pos"]) >= 0).all()))
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


@pytest.mark.parametrize("kind", QUANTS)
def test_encode_frames_matches_reference(exact, kind):
    r = exact["encode"][kind]
    assert r["shape"] == [2, 64, 64] and r["scale"] > 0, r
    assert r["maxdiff"] <= MEMORY_RTOL * r["scale"], r


def test_encode_frames_bit_identical_given_the_attention_core(exact):
    """At the config's w4/a8, with the reference's attention core
    answering the port's calls, the encoder's memory is the reference's
    bit for bit: the f32 core is the only step whose arithmetic differs.
    (At bf16 weights the linears are f32-accumulated bf16 dots, whose
    order differs as well: the value projection in 2 of 8,192 outputs.)"""
    r = exact["encode_ref_core"]["w4a8kv8"]
    assert r["shape"] == [2, 64, 64] and r["scale"] > 0, r
    assert r["maxdiff"] == 0.0, r


def test_attention_core_within_f32_ulps_of_the_reference(exact):
    """The port's f32 attention core on the reference's inputs is within
    a few f32 ulps of the largest output (the dot order); a core whose
    scores are rounded to bf16 is not."""
    r = exact["core"]
    d = r["port"]
    assert d["shape"] == [2, 4, 64, 16] and d["scale"] > 0, r
    assert d["maxdiff"] <= CORE_RTOL * d["scale"], r
    assert r["bf16_scores"]["maxdiff"] > CORE_RTOL * d["scale"], r


@pytest.mark.parametrize("kind", QUANTS)
def test_decoder_logits_bit_identical_given_the_memory(exact, kind):
    """Prefill through the paged pool (cross-K/V in state slots), then a
    decode step replaying the slot-resident cross caches."""
    for step in ("prefill", "decode"):
        r = exact[step][kind]
        assert r["shape"] == [2, 256] and r["scale"] > 0, (step, r)
        assert r["maxdiff"] == 0.0, (step, r)


@pytest.mark.parametrize("case", ["kv8-contiguous", "kv8-slotted",
                                  "float-contiguous"])
def test_cross_attention_apply_matches_reference(exact, case):
    r = exact["cross"][case]
    assert r["cache_equal"], r
    for step in ("prefill", "decode"):
        d = r[step]
        if case.startswith("kv8"):
            assert d["maxdiff"] == 0.0, (step, d)
        else:
            assert d["maxdiff"] <= MEMORY_RTOL * d["scale"], (step, d)
    assert r["pad_lane_zero_attention"], r


@pytest.mark.parametrize("case", ["contiguous-kv8", "paged-kv8",
                                  "contiguous-float"])
def test_engine_tokens_equal_reference(exact, case):
    r = exact["engine"][case]
    assert r["ref_reasons"] == ["length"] * 3 == r["reasons"], r
    assert all(len(o) == 5 for o in r["ref"])
    assert r["port"] == r["ref"], r
    if case.startswith("paged"):
        assert r["chunk_tokens"] is None and not r["prefix_cache"], r
        assert r["used_state_slots"] == 0, r
        assert r["free_blocks"] == r["n_usable"], r


def test_gelu_plain_version_bit_identical_to_jax(exact):
    """``ref.apply_act(..., "gelu")`` (K1's plain epilogue and the bf16
    linear's) gives ``jax.nn.gelu``'s f32 bits on 200k values; ``F.gelu``
    does not."""
    r = exact["gelu"]
    assert r["port"] == 0 and r["torch"] > 0, r


def test_bridge_carries_cross_caches(exact):
    r = exact["bridge"]
    assert r["n_cross"] == 2 and r["filled"], r
    assert r["layout"] and r["round_trip"], r


# ---------------------------------------------------------------------------
# In process: the port alone
# ---------------------------------------------------------------------------

def _cfg():
    return get_config(ARCH).reduced(n_layers=2)


def test_write_cross_slots_drops_pad_lane_and_masks_the_tail():
    cfg = _cfg()
    cache = L.make_cross_cache(cfg, 4, 6, 8, "cpu")
    assert cache["k"].shape == (4, 6, 4, 8, 1)
    assert cache["k_scale"].shape == (4, 6, 4, 1)
    assert cache["pos"].eq(-1).all()
    cache["pos"][3] = 9                   # a freed request's rows
    g = torch.Generator().manual_seed(0)
    k = torch.randn((2, 4, 4, 16), generator=g).bfloat16()
    ck, cks = L.ops.quantize_kv(k, 8)
    kv_pos = torch.arange(4, dtype=torch.int32)[None].repeat(2, 1)
    before = {key: v.clone() for key, v in cache.items()}
    cache["slots"] = torch.tensor([3, -1], dtype=torch.int32)
    out = L._write_cross_slots(cache, ck, cks, ck, cks, kv_pos)
    assert out["k"] is cache["k"]                       # in place
    assert out["pos"][3].tolist() == [0, 1, 2, 3, -1, -1]
    assert torch.equal(out["k"][3, :4], ck[0])
    assert not out["k"][3, 4:].any()
    for key in ("k", "k_scale", "v", "v_scale", "pos"):
        # the pad lane's write is dropped: rows 0-2 untouched
        assert torch.equal(out[key][:3], before[key][:3]), key


def test_alloc_slot_resets_cross_pos_and_validate_expects_it():
    cfg = _cfg()
    q = QuantConfig(w_bits=4, a_bits=8, kv_bits=8)
    with pytest.raises(ValueError, match="enc_len"):
        PagedKVPool(cfg, 5, 4, quant=q, n_state_slots=2, device="cpu")
    pool = PagedKVPool(cfg, 5, 4, quant=q, n_state_slots=2, enc_len=64,
                       device="cpu")
    cross = pool.caches["cross"]
    assert len(cross) == cfg.n_layers
    assert cross[0]["k"].shape == (3, 64, 4, 8, 1)
    assert pool.caches["layers"][0]["k"].shape[0] == 5    # blocks
    for c in cross:                      # a freed request's rows
        c["pos"][1:] = 7
        c["k"][1:] = 5
    pool.validate(check_contents=True)   # the null row is at rest
    slot = pool.alloc_slot()
    assert slot == 1
    for c in cross:
        assert c["pos"][1].eq(-1).all() and not c["k"][1].any()
        assert c["pos"][2].eq(7).all()   # other rows kept
    pool.validate(check_contents=True)
    step = pool.step_caches(np.zeros((2, 1), np.int32), np.zeros(2, np.int32),
                            slots=np.array([1, -1], np.int32))
    assert step["cross"][0]["slots"].tolist() == [1, -1]
    pool.absorb(step)
    assert "slots" not in pool.caches["cross"][0]
    cross[1]["pos"][0, 3] = 0            # the null row's position written
    with pytest.raises(AssertionError, match="null slot pos"):
        pool.validate(check_contents=True)
    cross[1]["pos"][0, 3] = -1
    pool.free_slot(slot)
    assert pool.report()["free_state_slots"] == 2


@pytest.mark.parametrize("kv", [8, None])
def test_prefill_then_decode_equals_the_whole_prefill(kv):
    """The port's counterpart of the reference's
    ``test_encdec_cross_cache_decode_exact``: a decode step over the
    cached cross-K/V (the encoder not run again) gives the logits of a
    prefill of the whole prompt, bit for bit."""
    cfg = _cfg()
    q = QuantConfig(w_bits=4, a_bits=8, kv_bits=kv)
    params = M.init_params(cfg, seed=1, device="cpu", quant=q)
    g = torch.Generator().manual_seed(2)
    b, s = 2, 12
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g,
                         dtype=torch.int32)
    frames = (torch.randn((b, 16, cfg.frontend_dim), generator=g)
              * 0.5).bfloat16()
    pos = torch.arange(s, dtype=torch.int32)[None].repeat(b, 1)
    full = M.init_caches(cfg, b, 32, quant=q, device="cpu", enc_len=16)
    want, _ = E.prefill_step(params, dict(tokens=toks, positions=pos,
                                          frames=frames), full, cfg, q)
    caches = M.init_caches(cfg, b, 32, quant=q, device="cpu", enc_len=16)
    _, caches = E.prefill_step(params, dict(tokens=toks[:, :-1],
                                            positions=pos[:, :-1],
                                            frames=frames), caches, cfg, q)
    assert caches["cross"][0]["pos"].tolist() == [list(range(16))] * 2
    got, _ = E.serve_step(params, dict(tokens=toks[:, -1:],
                                       positions=pos[:, -1:]), caches, cfg, q)
    assert torch.isfinite(got).all() and got.shape == (b, cfg.vocab_padded)
    assert torch.equal(got, want)


def test_engine_drops_chunk_tokens_and_prefix_cache_for_audio():
    cfg = _cfg()
    q = QuantConfig(w_bits=4, a_bits=8, kv_bits=8)
    params = M.init_params(cfg, seed=0, device="cpu", quant=q)
    eng = E.Engine(params, cfg, n_slots=2, max_len=32, quant=q, paged=True,
                   block_size=4, chunk_tokens=8)
    assert eng.chunk_tokens is None and eng.scheduler.chunk_tokens is None
    assert not eng.pool.prefix_cache and eng.pool.slots.n_slots == 4
    assert eng.pool.caches["cross"][0]["pos"].shape == (5, 64)
    with pytest.raises(ValueError, match="chunk_tokens requires paged"):
        E.Engine(params, cfg, max_len=32, quant=q, chunk_tokens=8)


@pytest.mark.parametrize("regime", ["contiguous-kv8", "contiguous-float",
                                    "paged-kv8"])
def test_reused_lane_does_not_leak_the_previous_cross_memory(regime,
                                                            monkeypatch):
    """One lane serves a 600-token prompt (bucketed to 1024, 128 encoder
    rows) and then a 100-token one (bucketed to 128, 64 rows): the
    second request's tokens equal a fresh engine's, and the lane's cross
    rows past 64 hold position -1, not the first request's.  The stub
    frontend's zero frames give encoder memory rows that are all alike,
    so a leaked row could not move the tokens; here the frames are
    random, seeded by the padded prompt."""
    stub = E.Engine._prefill_batch

    def random_frames(self, toks, pos, s):
        batch = stub(self, toks, pos, s)
        g = torch.Generator().manual_seed(int(toks.sum()))
        batch["frames"] = torch.randn(batch["frames"].shape,
                                      generator=g).bfloat16()
        return batch

    monkeypatch.setattr(E.Engine, "_prefill_batch", random_frames)
    cfg = _cfg()
    kv = None if regime.endswith("float") else 8
    q = QuantConfig(w_bits=4, a_bits=8, kv_bits=kv)
    params = M.init_params(cfg, seed=3, device="cpu", quant=q)
    rng = np.random.default_rng(4)
    long_p = rng.integers(0, cfg.vocab, (600,), dtype=np.int32)
    short_p = rng.integers(0, cfg.vocab, (100,), dtype=np.int32)
    kw = {}                              # one lane, reused
    if regime.startswith("paged"):
        kw = dict(paged=True, block_size=16, max_batch=1)

    def serve(prompts):
        eng = E.Engine(params, cfg, n_slots=1, max_len=1024, quant=q, **kw)
        reqs = [E.Request(prompt=p.copy(), max_new_tokens=6)
                for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return eng, [list(map(int, r.out)) for r in reqs]

    eng, (first, second) = serve([long_p, short_p])
    _, (fresh,) = serve([short_p])
    assert len(first) == len(second) == 6
    assert second == fresh
    # the lane's rows: the contiguous cache's row 0, the pool's slot 1
    # (freed, but not yet reset by another alloc)
    rows = eng.pool.caches["cross"] if kw else eng.caches["cross"]
    lane = 1 if kw else 0
    for c in rows:
        assert c["pos"].shape == ((2, 128) if kw else (1, 128))
        assert c["pos"][lane, :64].tolist() == list(range(64))
        assert c["pos"][lane, 64:].eq(-1).all()
