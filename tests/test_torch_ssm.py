"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) and the SSM and
hybrid stacks built on it, against the reference package on the same
numpy inputs and bridged parameters.

Module level (in process, reduced mamba2-130m: d_inner 128, 8 heads of
16, state 16, chunk 16): ``_segsum``, ``_ssd_chunked`` (with and without
``init_state``), ``softplus`` and ``ssm_apply`` -- whole prefill, a
chunked continuation, decode, and slot rows with a pad lane.  The f32
steps are held to a relative tolerance, not bit for bit: XLA:CPU's
``cumsum`` is an associative scan and its ``exp``/``log1p`` and f32 dot
products round otherwise than torch's (``softplus`` differs by 1 ulp in
~10% of values, the SSD outputs and states in most elements by a few
ulps: 1.6e-7 of the largest).  The tolerances: ``F32_RTOL`` of the
largest magnitude for f32 results, ``BF16_RTOL`` (one bf16 ulp) for the
mixer's bf16 output.

Model level (a subprocess with XLA's excess precision off, see
tests/test_torch_model.py): reduced mamba2-130m at its own w4/a8 and
reduced jamba-1.5-large-398b (``n_layers=2, attn_every=2``: one mamba +
MoE layer, one attention + dense layer) at w2/a8/kv8, a prefill through
the paged pool's state slots and KV blocks, then a decode step: the
logits equal the reference's bit for bit, and jamba's top-2 experts
agree for every token.  The SSD's f32 differences above stay in the
slot state (``STATE_ATOL``: 2.7e-7 measured on mamba2's, 7.5e-8 on
jamba's, states of magnitude ~1); they vanish at the mixer's bf16
output and never moved an 8-bit activation code here.
"""

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
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import ssm as TS

from _torch_parity import n, t, torch_params

F32_RTOL = 1e-5          # f32 SSD / state results, of the largest magnitude
BF16_RTOL = 2.0 ** -8    # one bf16 ulp of the largest output
STATE_ATOL = 1e-5        # the slot-resident f32 SSD state after a prefill


def _close(want, got, rtol):
    a = np.asarray(want, np.float32)
    b = n(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(a).max()
    assert scale > 0
    assert np.abs(a - b).max() <= rtol * scale, (np.abs(a - b).max(), scale)


@pytest.fixture(scope="module")
def mixer():
    cfg_j = jget("mamba2-130m").reduced(n_layers=1)
    cfg_t = get_config("mamba2-130m").reduced(n_layers=1)
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    pj = jax.tree.map(lambda a: a[0], params["blocks"][0]["mixer"])
    pt = torch_params(params, cfg_t)["layers"][0]["mixer"]
    return cfg_j, cfg_t, pj, pt


def _x(rng, b, s, d=64):
    x = jnp.asarray(rng.standard_normal((b, s, d)), jnp.bfloat16)
    return x, t(np.asarray(x))


def test_configs_copy_the_reference_fields():
    import dataclasses
    for arch in ("mamba2-130m", "jamba-1.5-large-398b"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget(arch)), arch
        for red in ({}, dict(n_layers=2, attn_every=2)):
            ct, cj = get_config(arch).reduced(**red), jget(arch).reduced(**red)
            assert (ct.ssm_d_inner, ct.ssm_n_heads) == \
                (cj.ssm_d_inner, cj.ssm_n_heads)
            assert [(ct.layer_kind(i), ct.ffn_kind(i))
                    for i in range(ct.n_layers)] == \
                [(cj.layer_kind(i), cj.ffn_kind(i))
                 for i in range(cj.n_layers)]
    cfg = get_config("jamba-1.5-large-398b")
    assert [cfg.layer_kind(i) for i in range(8)].count("attn") == 1
    assert cfg.ssm_n_heads == 128 and cfg.ssm_d_inner == 16384


@pytest.mark.parametrize("length", [1, 7, 16])
def test_segsum_matches_reference(length):
    rng = np.random.default_rng(length)
    a = (rng.standard_normal((2, 3, length)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(JS._segsum)(a))
    got = TS._segsum(torch.as_tensor(a)).numpy()
    assert np.array_equal(np.isneginf(want), np.isneginf(got))
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=F32_RTOL * np.abs(want[fin]).max())


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "init_state"])
@pytest.mark.parametrize("s,chunk", [(32, 16), (48, 16), (16, 8)])
def test_ssd_chunked_matches_reference(with_state, s, chunk):
    rng = np.random.default_rng(s + chunk + with_state)
    b, h, p, g, nn = 2, 8, 16, 2, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, h))) * 0.05).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bb = rng.standard_normal((b, s, g, nn)).astype(np.float32)
    cc = rng.standard_normal((b, s, g, nn)).astype(np.float32)
    st = (rng.standard_normal((b, h, p, nn)).astype(np.float32)
          if with_state else None)
    yj, sj = jax.jit(lambda *v: JS._ssd_chunked(*v, chunk, init_state=st))(
        x, dt, a, bb, cc)
    yt, stt = TS._ssd_chunked(
        *(torch.as_tensor(v) for v in (x, dt, a, bb, cc)), chunk,
        init_state=None if st is None else torch.as_tensor(st))
    _close(yj, yt, F32_RTOL)
    _close(sj, stt, F32_RTOL)


def test_softplus_is_logaddexp():
    v = np.concatenate([np.linspace(-40, 40, 801),
                        [0.0, 20.0, 20.5, 88.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(v))
    got = TS.softplus(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0)
    # above F.softplus's threshold the form still matters: 20.5 -> 20.5 +
    # log1p(exp(-20.5)), not 20.5
    assert got[-2] == np.float32(20.5) + np.float32(np.log1p(np.exp(-20.5)))


def test_ssm_apply_whole_prefill(mixer):
    cfg_j, cfg_t, pj, pt = mixer
    xj, xt = _x(np.random.default_rng(1), 2, 20)
    yj, _ = jax.jit(lambda p, x: JS.ssm_apply(p, x, cfg_j))(pj, xj)
    yt, none = TS.ssm_apply(pt, xt, cfg_t)
    assert none is None and yt.dtype == torch.bfloat16
    _close(yj, yt, BF16_RTOL)
    # through a zeroed cache: the same output, and the cache filled
    cj = JS.make_ssm_cache(cfg_j, 2, jnp.bfloat16)
    ct = TS.make_ssm_cache(cfg_t, 2, torch.bfloat16, "cpu")
    yj2, ncj = jax.jit(lambda p, x, c: JS.ssm_apply(p, x, cfg_j, cache=c))(
        pj, xj, cj)
    yt2, nct = TS.ssm_apply(pt, xt, cfg_t, cache=ct)
    assert torch.equal(yt2, yt)
    _close(yj2, yt2, BF16_RTOL)
    _close(ncj["state"], nct["state"], F32_RTOL)
    np.testing.assert_array_equal(np.asarray(ncj["conv"], np.float32),
                                  n(nct["conv"]))


def test_ssm_apply_chunked_continuation_equals_whole(mixer):
    """Three chunks (5, 1 -- the decode branch -- and 14 tokens) continue
    the cached conv rows and SSD state: the outputs equal one whole
    prefill's, and the reference's own chunked run."""
    cfg_j, cfg_t, pj, pt = mixer
    xj, xt = _x(np.random.default_rng(2), 2, 20)
    fj = jax.jit(lambda p, x, c: JS.ssm_apply(p, x, cfg_j, cache=c))
    cj = JS.make_ssm_cache(cfg_j, 2, jnp.bfloat16)
    ct = TS.make_ssm_cache(cfg_t, 2, torch.bfloat16, "cpu")
    whole, _ = TS.ssm_apply(pt, xt, cfg_t,
                            cache=TS.make_ssm_cache(cfg_t, 2, torch.bfloat16,
                                                    "cpu"))
    outs_j, outs_t = [], []
    for lo, hi in ((0, 5), (5, 6), (6, 20)):
        yj, cj = fj(pj, xj[:, lo:hi], cj)
        yt, ct = TS.ssm_apply(pt, xt[:, lo:hi], cfg_t, cache=ct)
        outs_j.append(np.asarray(yj, np.float32))
        outs_t.append(yt)
    got = torch.cat(outs_t, 1)
    _close(np.concatenate(outs_j, 1), got, BF16_RTOL)
    _close(n(whole), got, BF16_RTOL)
    _close(cj["state"], ct["state"], F32_RTOL)


def test_ssm_apply_decode(mixer):
    cfg_j, cfg_t, pj, pt = mixer
    rng = np.random.default_rng(3)
    conv = jnp.asarray(rng.standard_normal((3, 3, 160)), jnp.bfloat16)
    state = rng.standard_normal((3, 8, 16, 16)).astype(np.float32)
    xj, xt = _x(rng, 3, 1)
    yj, cj = jax.jit(lambda p, x, c: JS.ssm_apply(p, x, cfg_j, cache=c))(
        pj, xj, {"conv": conv, "state": jnp.asarray(state)})
    ct = {"conv": t(np.asarray(conv)), "state": torch.as_tensor(state)}
    yt, nct = TS.ssm_apply(pt, xt, cfg_t, cache=ct)
    _close(yj, yt, BF16_RTOL)
    _close(cj["state"], nct["state"], F32_RTOL)
    np.testing.assert_array_equal(np.asarray(cj["conv"], np.float32),
                                  n(nct["conv"]))


@pytest.mark.parametrize("s", [1, 6], ids=["decode", "prefill"])
def test_ssm_apply_slot_rows_drop_the_pad_lane(mixer, s):
    """Slot-pool rows (4 slots + the null row 0): lanes at slots 3 and 1
    and a pad lane (-1).  The lanes' rows advance as the reference's do,
    in place; the pad lane reads the null row, its write is dropped, and
    the null row and the unused slots keep their contents."""
    cfg_j, cfg_t, pj, pt = mixer
    rng = np.random.default_rng(4 + s)
    conv = np.asarray(jnp.asarray(rng.standard_normal((5, 3, 160)),
                                  jnp.bfloat16), np.float32)
    state = rng.standard_normal((5, 8, 16, 16)).astype(np.float32)
    conv[0], state[0] = 0, 0                  # the null slot
    slots = np.array([3, -1, 1], np.int32)
    xj, xt = _x(rng, 3, s)
    yj, cj = jax.jit(lambda p, x, c: JS.ssm_apply(p, x, cfg_j, cache=c))(
        pj, xj, {"conv": jnp.asarray(conv, jnp.bfloat16),
                 "state": jnp.asarray(state), "slots": jnp.asarray(slots)})
    ct = {"conv": torch.as_tensor(conv).to(torch.bfloat16),
          "state": torch.as_tensor(state), "slots": torch.as_tensor(slots)}
    conv_buf, state_buf = ct["conv"], ct["state"]
    yt, nct = TS.ssm_apply(pt, xt, cfg_t, cache=ct)
    assert nct["conv"] is conv_buf and nct["state"] is state_buf  # in place
    keep = [0, 2]
    _close(np.asarray(yj, np.float32)[keep], yt[keep], BF16_RTOL)
    _close(cj["state"], state_buf, F32_RTOL)
    np.testing.assert_array_equal(np.asarray(cj["conv"], np.float32),
                                  n(conv_buf))
    assert not conv_buf[0].any() and not state_buf[0].any()
    for row in (2, 4):                        # owned by no lane
        assert torch.equal(state_buf[row], torch.as_tensor(state[row]))
    # the pad lane computed on the null row: the same as a lane at a
    # zeroed cache
    yz, _ = TS.ssm_apply(pt, xt[1:2], cfg_t,
                         cache=TS.make_ssm_cache(cfg_t, 1, torch.bfloat16,
                                                 "cpu"))
    assert torch.equal(yt[1:2], yz)


def test_bridge_carries_ssm_leaves_and_caches():
    """The hybrid unit's parameters (mamba: f32 A_log/D/dt_bias, bf16
    conv, quantized in/out projections) and the conv/state cache leaves
    cross both ways bit for bit."""
    from repro.models.config import QuantConfig as JQ
    from repro_torch import bridge
    from _torch_parity import to_numpy_tree
    red = dict(n_layers=4, attn_every=2)
    cfg_j = jget("jamba-1.5-large-398b").reduced(**red)
    cfg_t = get_config("jamba-1.5-large-398b").reduced(**red)
    _, unit, n_units = JM.plan_split(cfg_j)
    assert (len(unit), n_units) == (2, 2)
    pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(5)),
                            JQ(w_bits=2))
    pt = torch_params(pj, cfg_t)
    tree = to_numpy_tree(pj)
    for li in range(4):
        u, i = divmod(li, 2)
        mix_t = pt["layers"][li]["mixer"]
        mix_j = tree["blocks"][i]["mixer"]
        if cfg_t.layer_kind(li) == "mamba":
            for key in ("A_log", "D", "dt_bias", "norm_scale"):
                assert mix_t[key].dtype == torch.float32
                np.testing.assert_array_equal(mix_j[key][u], n(mix_t[key]))
            for key in ("conv_w", "conv_b"):
                assert mix_t[key].dtype == torch.bfloat16
            for key in ("in_proj", "out_proj"):
                w = mix_t[key]["w"]
                np.testing.assert_array_equal(
                    mix_j[key]["w"]["packed"][u].view(np.int32),
                    w.packed.numpy())
                assert w.n_bits == 2
        else:
            assert "wq" in mix_t
    assert pt["layers"][0]["mixer"]["in_proj"]["w"].shape == \
        (2 * 128 + 2 * 16 + 8, 64)
    caches_j = JM.init_caches(cfg_j, 2, 16, quant=JQ(kv_bits=8))
    rng = np.random.default_rng(6)
    caches_j = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        if a.dtype in (jnp.bfloat16, jnp.float32) else a, caches_j)
    ct = bridge.caches_from_numpy(to_numpy_tree(caches_j), cfg_t, "cpu")
    assert set(ct["layers"][0]) == {"conv", "state"}
    assert ct["layers"][0]["conv"].dtype == torch.bfloat16
    back = bridge.caches_to_numpy(ct, cfg_t)
    for i in range(2):
        for key, leaf in caches_j["blocks"][i].items():
            np.testing.assert_array_equal(
                np.asarray(leaf).astype(np.float32)
                if leaf.dtype == jnp.bfloat16 else np.asarray(leaf),
                back["blocks"][i][key], err_msg=key)


_MODEL = r"""
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
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as TE
from repro_torch.serving.paged_cache import PagedKVPool as TPool
from _torch_parity import torch_params
CASES = {"mamba2-130m": ({}, dict(w_bits=4, a_bits=8)),
         "jamba-1.5-large-398b": (dict(n_layers=2, attn_every=2),
                                  dict(w_bits=2, a_bits=8, kv_bits=8))}
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


JL.moe_apply, TL.moe_apply = rec_j, rec_t
rng = np.random.default_rng(0)
toks = rng.integers(0, 256, (2, 16), dtype=np.int32)
pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
slots = np.array([2, 1], np.int32)
last = np.array([15, 15], np.int32)


def compare(a, b, vocab):
    a, b = np.asarray(a, np.float32), b.float().numpy()
    return dict(maxdiff=float(np.abs(a - b).max()),
                scale=float(np.abs(a).max()),
                argmax_equal=bool((a.argmax(-1) == b.argmax(-1)).all()),
                shape=list(b.shape), vocab=vocab)


out = {}
for arch, (red, q) in CASES.items():
    cfg_j, cfg_t = jget(arch).reduced(**red), get_config(arch).reduced(**red)
    qj, qt = JQ(**q), QuantConfig(**q)
    pj = JM.quantize_params(JM.init_params(cfg_j, jax.random.PRNGKey(3)), qj)
    pt = torch_params(pj, cfg_t)
    jpool = JPool(cfg_j, 9, 4, quant=qj, n_state_slots=3)
    tpool = TPool(cfg_t, 9, 4, quant=qt, n_state_slots=3, device="cpu")
    routes["j"].clear()
    routes["t"].clear()
    res = {}
    lens0 = np.zeros(2, np.int32)
    lj, cj = JE.prefill_step_bucketed(
        pj, dict(tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                 last_idx=jnp.asarray(last)),
        jpool.step_caches(tables, lens0, slots=slots), cfg_j, qj)
    jpool.absorb(cj)
    lt, ct = TE.prefill_step_bucketed(
        pt, dict(tokens=torch.as_tensor(toks), positions=torch.as_tensor(pos),
                 last_idx=torch.as_tensor(last)),
        tpool.step_caches(tables, lens0, slots=slots), cfg_t, qt)
    tpool.absorb(ct)
    res["prefill"] = compare(lj, lt, cfg_t.vocab_padded)
    st_j = [np.asarray(c["state"])[0] for c in jpool.caches["blocks"]
            if "state" in c]
    st_t = [c["state"].numpy() for c in tpool.caches["layers"]
            if "state" in c]
    res["state_maxdiff"] = max(float(np.abs(a - b).max())
                               for a, b in zip(st_j, st_t))
    res["null_row_zero"] = all(not c["state"][0].any() and
                               not c["conv"][0].any()
                               for c in tpool.caches["layers"]
                               if "state" in c)
    dtk = np.array([[5], [7]], np.int32)
    dp = np.array([[16], [16]], np.int32)
    dl = np.array([16, 16], np.int32)
    lj, _ = JE.serve_step(pj, dict(tokens=jnp.asarray(dtk),
                                   positions=jnp.asarray(dp)),
                          jpool.step_caches(tables, dl, slots=slots),
                          cfg_j, qj)
    lt, _ = TE.serve_step(pt, dict(tokens=torch.as_tensor(dtk),
                                   positions=torch.as_tensor(dp)),
                          tpool.step_caches(tables, dl, slots=slots),
                          cfg_t, qt)
    res["decode"] = compare(lj, lt, cfg_t.vocab_padded)
    if routes["t"]:
        rj = np.concatenate([r.reshape(-1, cfg_t.top_k) for r in routes["j"]])
        rt = np.concatenate([r.reshape(-1, cfg_t.top_k) for r in routes["t"]])
        res["routes"] = int(rj.shape[0])
        res["route_agree"] = float((rj == rt).all(-1).mean())
    out[arch] = res
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def model_run():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    out = subprocess.run([sys.executable, "-c", _MODEL, here], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT", 1)[1])


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_logits_bit_identical_without_xla_excess_precision(model_run,
                                                           arch, step):
    r = model_run[arch][step]
    assert r["shape"] == [2, r["vocab"]] and r["scale"] > 0, r
    assert r["maxdiff"] == 0.0, r
    assert r["argmax_equal"], r


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_slot_state_matches_reference_and_null_row_stays_zero(model_run,
                                                              arch):
    r = model_run[arch]
    assert r["state_maxdiff"] <= STATE_ATOL, r
    assert r["null_row_zero"], r


def test_jamba_topk_experts_equal_reference(model_run):
    """Every token's top-2 experts at the MoE layer, prefill (32 tokens)
    and decode (2), are the reference's."""
    r = model_run["jamba-1.5-large-398b"]
    assert r["routes"] == 34 and r["route_agree"] == 1.0, r
