"""Nested-precision ("any-precision") serving of the port against the
reference: one checkpoint packed once at w8 with per-width scales, each
request served at its own width by streaming only the top k bit planes.

* ``nested_slice`` of a w8 ``pack_weight`` at every k in 1..7 is a view:
  its planes share the full stack's storage, contiguous, offset by
  ``8 - k`` planes; the plain K1 on the view equals the plain K1 on a
  copy bit for bit.
* K1's integer core on views at k = 8, 4, 2 (act none, f32 out, at the
  decode and a chunk's row counts) equals the reference's nested
  ``ap_linear_fused`` bit for bit, through its plain path and through its
  Pallas kernel in interpret mode.
* chip_smoke.py's nested path in small (reduced llama3-8b, 2 layers,
  ``d_head=32``, w8/a8/kv8, paged, ``block_size=8``, ``chunk_tokens=8``):
  prompts at 8, 4 and 2 bits, the first with a shared prefix, then two
  late prefix-sharing requests at 8 and 4 bits.  Tokens, finish reasons,
  granted widths, prefix hits by salt (the index is salted by width: the
  8-bit late request alone hits; ``chip_smoke.prefix_hits`` records
  them in both packages) and ``repro_engine_precision_total`` by width
  equal the reference's.
* Load-adaptive grants: ``precision_floor=2``, eight requests with no
  precision submitted at once, ``max_batch=2``: the frozen grants (7, 6,
  ... as the queue drains) and the tokens equal the reference's.

The two engine scenarios run once in each package in one subprocess with
XLA's excess precision off (the flag must be set before JAX starts; see
tests/test_torch_model.py), where the logits are bit-identical.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as JO
from repro_torch.core import bipolar
from repro_torch.kernels import apmm, ops as TO

from _torch_parity import jax_bipolar_to_torch, t

TOP = 8                       # the checkpoint's stored width

_RUN = r"""
import dataclasses, json, os, sys
sys.path[:0] = [sys.argv[1], os.path.dirname(sys.argv[1])]
import numpy as np, jax
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro.serving import engine as JE
from repro_torch.configs import get_config as tget
from repro_torch.models.config import QuantConfig as TQ
from repro_torch.serving import engine as TE
from _torch_parity import torch_params
from chip_smoke import prefix_hits

RED = dict(n_layers=2, d_head=32)
_PARAMS = {}


def setup(side, q):
    key = json.dumps(dataclasses.asdict(q), sort_keys=True)
    if key not in _PARAMS:
        pj = JM.quantize_params(
            JM.init_params(jget("llama3-8b").reduced(**RED),
                           jax.random.PRNGKey(3)), q)
        _PARAMS[key] = (pj, torch_params(pj, tget("llama3-8b").reduced(
            **RED)))
    pj, pt = _PARAMS[key]
    if side == "ref":
        return jget("llama3-8b").reduced(**RED), pj, q, JE
    return tget("llama3-8b").reduced(**RED), pt, \
        TQ(**dataclasses.asdict(q)), TE


def toks(reqs):
    return [[int(t) for t in r.out] for r in reqs]


def mixed_prefix(side):
    cfg, params, q, E = setup(side, JQ(w_bits=8, a_bits=8, kv_bits=8))
    eng = E.Engine(params, cfg, quant=q, paged=True, n_slots=4, max_len=96,
                   block_size=8, chunk_tokens=8, metrics=True)
    rng = np.random.default_rng(21)
    shared = rng.integers(0, cfg.vocab, (16,), dtype=np.int32)

    def request(n, bits, with_prefix):
        body = rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
        prompt = np.concatenate([shared, body[16:]]) if with_prefix else body
        return E.Request(prompt=prompt, max_new_tokens=5, precision=bits)

    reqs = [request(n, b, i == 0)
            for i, (n, b) in enumerate(((40, 8), (10, 4), (20, 2)))]
    late = [request(24, 8, True), request(24, 4, True)]
    for r in reqs:
        eng.submit(r)
    submitted = False
    with prefix_hits(eng.pool) as hits:
        while eng._has_work() or not submitted:
            if reqs[0].out and not submitted:
                for r in late:      # after the shared prefix is indexed
                    eng.submit(r)
                submitted = True
            if not eng.step() and submitted:
                break
    reqs += late
    counts = {}
    for line in eng.pool.metrics.render().splitlines():
        if line.startswith("repro_engine_precision_total{"):
            label, val = line.split("}")
            counts[label.split('"')[1]] = int(float(val))
    return dict(out=toks(reqs), reasons=[r.finish_reason for r in reqs],
                grants=[r._tier_bits for r in reqs], hits=hits,
                prefix_hits=int(eng.report()["prefix_hits"]), counts=counts)


def load_adaptive(side):
    cfg, params, q, E = setup(side, JQ(w_bits=8, a_bits=8, kv_bits=8,
                                       precision_floor=2))
    eng = E.Engine(params, cfg, quant=q, paged=True, n_slots=2, max_len=64,
                   block_size=8, chunk_tokens=8, max_batch=2)
    rng = np.random.default_rng(23)
    reqs = [E.Request(prompt=rng.integers(0, cfg.vocab, (7,),
                                          dtype=np.int32),
                      max_new_tokens=3) for _ in range(8)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return dict(out=toks(reqs), reasons=[r.finish_reason for r in reqs],
                grants=[r._tier_bits for r in reqs])


out = {name: {side: fn(side) for side in ("ref", "port")}
       for name, fn in (("mixed_prefix", mixed_prefix),
                        ("load_adaptive", load_adaptive))}
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    out = subprocess.run([sys.executable, "-c", _RUN, here], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT", 1)[1])


def _weight(rng, n_out, k, bits=TOP):
    w = rng.standard_normal((n_out, k)).astype(np.float32)
    jw = JO.pack_weight(jnp.asarray(w), bits, impl="reference")
    return jw, jax_bipolar_to_torch(jw)


@pytest.mark.parametrize("k", range(1, TOP))
def test_nested_slice_is_a_view_and_k1_streams_it(k):
    rng = np.random.default_rng(k)
    n_out, kdim = 24, 70
    full = TO.pack_weight(t(rng.standard_normal((n_out, kdim))
                            .astype(np.float32)), TOP)
    view = bipolar.nested_slice(full, k)
    kw = full.packed.shape[-1]
    assert view.n_bits == k and tuple(view.packed.shape) == (k, n_out, kw)
    assert view.packed.is_contiguous()
    assert view.packed.untyped_storage().data_ptr() == \
        full.packed.untyped_storage().data_ptr()
    assert view.packed.storage_offset() == (TOP - k) * n_out * kw
    assert view.packed.data_ptr() == \
        full.packed.data_ptr() + (TOP - k) * n_out * kw * 4
    # the wrapper's .contiguous() is then the view itself: no copy
    assert view.packed.contiguous().data_ptr() == view.packed.data_ptr()
    assert torch.equal(view.scale, full.width_scales[k - 1])
    copy = bipolar.BipolarTensor(
        packed=view.packed.clone(), scale=view.scale.clone(), n_bits=k,
        shape=view.shape, pack_axis=view.pack_axis)
    x = t(rng.standard_normal((5, kdim)).astype(np.float32))
    a_s = bipolar.absmax_scale(x, 8, axis=-1).float()
    for m in (1, 5):
        got = apmm.apmm_fused_linear(x[:m], a_s[:m], view, a_bits=8)
        want = apmm.apmm_fused_linear(x[:m], a_s[:m], copy, a_bits=8)
        assert torch.equal(got, want), m


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("impl", ["reference", "interpret"])
def test_k1_integer_core_on_nested_views_equals_reference(bits, impl):
    """chip_smoke.py phase 3's nested K1 cases in small: a dual pair of
    w8 weights served at ``bits`` through views, at a decode's 4 rows
    and a chunk's 24, each weight's integer core (act none, f32 out)."""
    rng = np.random.default_rng(bits * 10 + len(impl))
    n_out, kdim = 40, 100
    for _ in range(2):                   # gate and up
        jw, tw = _weight(rng, n_out, kdim)
        view = bipolar.nested_slice(tw, bits)
        for m in (4, 24):
            x = rng.standard_normal((m, kdim)).astype(np.float32)
            want = JO.ap_linear_fused(jnp.asarray(x), jw, a_bits=8,
                                      out_dtype=jnp.float32, impl=impl,
                                      w_bits=bits)
            got = TO.ap_linear_fused(t(x), view, a_bits=8)
            np.testing.assert_array_equal(np.asarray(want), got.numpy())
            # the served width through the ops entry slices the same view
            got = TO.ap_linear_fused(t(x), tw, a_bits=8, w_bits=bits)
            np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("key", ["out", "reasons", "grants", "hits",
                                 "counts"])
def test_mixed_widths_with_prefix_equal_reference(runs, key):
    ref, port = runs["mixed_prefix"]["ref"], runs["mixed_prefix"]["port"]
    assert port[key] == ref[key]
    if key == "reasons":
        assert port[key] == ["length"] * 5
    if key == "grants":
        assert port[key] == [8, 4, 2, 8, 4]
    if key == "hits":
        # one hit: the 8-bit late request on the shared prefix's 2
        # blocks; the 4-bit one shares the prompt but not the salt
        assert [h for h in port["hits"] if h[2]] == [[8, 24, 2, 16]]
        assert port["prefix_hits"] == ref["prefix_hits"] == 1
    if key == "counts":
        emitted = {}
        for bits, out in zip(port["grants"], port["out"]):
            emitted[str(bits)] = emitted.get(str(bits), 0) + len(out)
        assert port["counts"] == emitted


@pytest.mark.parametrize("key", ["out", "grants"])
def test_load_adaptive_grants_equal_reference(runs, key):
    ref, port = runs["load_adaptive"]["ref"], runs["load_adaptive"]["port"]
    assert port[key] == ref[key]
    assert port["reasons"] == ref["reasons"] == ["length"] * 8
    if key == "grants":
        # the queue's depth sheds a bit per 4 waiting requests, down to
        # the floor: odd widths among the grants, none below 2
        assert min(port["grants"]) >= 2
        assert {7, 6} <= set(port["grants"])
