"""The port's engines serving the SSM and hybrid stacks through the state
slot pool, against the reference engine on identical parameters.

The port's counterparts of the reference's
``test_paged_engine_serves_ssm_through_slot_pool`` and
``..._hybrid_blocks_plus_slots`` (tests/test_paged_serving.py) and of
``test_chunked_identity_mamba2`` and ``..._jamba_hybrid``
(tests/test_continuous_batching.py): reduced mamba2-130m and reduced
jamba-1.5-large-398b (``n_layers=2, attn_every=2``) serve three prompts
(5, 9 and 14 tokens) contiguous, paged whole-prompt (``block_size=4``)
and paged chunked (mamba2 at chunks 3 and 5, jamba at 3 and 8: a chunk
lane runs its own exact-length B=1 forward beside the bucketed decode
dispatch), each at the reference tests' quantization (bf16 weights;
jamba with a kv8 override) and at the config's own (mamba2 w4/a8, jamba
w2/a8/kv8).  Every run's greedy tokens equal the reference contiguous
engine's (the reference's own tests hold its regimes equal to each
other); afterwards no state slot or block is in use and the pool
validates, contents included.  With XLA's excess precision off (a
subprocess, see tests/test_torch_model.py).

In process: :class:`StateSlotPool` (alloc order, free, double free, the
null slot, exhaustion, ``validate``) against the reference's, and the
pool's slot plumbing (``needs_blocks``, rows zeroed at alloc, the
``slots`` step key, the prefix cache kept off for stateful stacks).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ARCHS = {"mamba2-130m": dict(red={}, chunks=[3, 5]),
         "jamba-1.5-large-398b": dict(red=dict(n_layers=2, attn_every=2),
                                      chunks=[3, 8])}
QUANTS = ["reference-tests", "own"]

_RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, jax
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro.serving import engine as JE
from repro_torch.configs import get_config as tget
from repro_torch.models.config import QuantConfig as TQ
from repro_torch.serving import engine as TE
from _torch_parity import torch_params
archs, quants = json.loads(sys.argv[2]), json.loads(sys.argv[3])


def quant_kw(arch, kind):
    own = jget(arch).quant
    if kind == "own":
        return dict(w_bits=own.w_bits, a_bits=own.a_bits,
                    kv_bits=8 if arch.startswith("jamba") else None)
    return None if arch.startswith("mamba") else dict(kv_bits=8)


def run(E, params, cfg, q, prompts, **kw):
    eng = E.Engine(params, cfg, n_slots=2, max_len=32, quant=q, **kw)
    reqs = [E.Request(prompt=p.copy(), max_new_tokens=5) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [[int(t) for t in r.out] for r in reqs], \
        [r.finish_reason for r in reqs], eng


out = {}
for arch, spec in archs.items():
    cfg_j = jget(arch).reduced(**spec["red"])
    cfg_t = tget(arch).reduced(**spec["red"])
    raw = JM.init_params(cfg_j, jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg_j.vocab, (n,), dtype=np.int32)
               for n in (5, 9, 14)]
    for kind in quants:
        qk = quant_kw(arch, kind)
        qj = None if qk is None else JQ(**qk)
        qt = None if qk is None else TQ(**qk)
        pj = JM.quantize_params(raw, qj) if qj is not None and qj.enabled \
            else raw
        pt = torch_params(pj, cfg_t)
        ref, ref_reasons, _ = run(JE, pj, cfg_j, qj, prompts)
        res = {"ref": ref, "ref_reasons": ref_reasons, "port": {}}
        regimes = {"contiguous": {},
                   "paged": dict(paged=True, block_size=4)}
        for ck in spec["chunks"]:
            regimes[f"chunked{ck}"] = dict(paged=True, block_size=4,
                                           chunk_tokens=ck)
        for name, kw in regimes.items():
            toks, reasons, eng = run(TE, pt, cfg_t, qt, prompts, **kw)
            r = dict(out=toks, reasons=reasons)
            if kw:
                eng.pool.validate(check_contents=True)
                rep = eng.report()
                r.update(used_state_slots=rep["used_state_slots"],
                         free_state_slots=rep["free_state_slots"],
                         state_slots=rep["state_slots"],
                         free_blocks=eng.pool.free_blocks,
                         n_usable=eng.pool.n_usable,
                         needs_blocks=eng.pool.needs_blocks,
                         prefix_cache=eng.pool.prefix_cache,
                         chunk_processed=rep["chunk_tokens_processed"])
            res["port"][name] = r
        out[f"{arch}-{kind}"] = res
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def served():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    out = subprocess.run([sys.executable, "-c", _RUN, here,
                          json.dumps(ARCHS), json.dumps(QUANTS)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("RESULT", 1)[1])


def _case(served, arch, kind, regime):
    r = served[f"{arch}-{kind}"]
    assert r["ref_reasons"] == ["length"] * 3
    assert all(len(o) == 5 for o in r["ref"])
    got = r["port"][regime]
    assert got["out"] == r["ref"], (regime, got["out"], r["ref"])
    assert got["reasons"] == ["length"] * 3
    return got


@pytest.mark.parametrize("kind", QUANTS)
def test_contiguous_engine_tokens_equal_reference(served, kind):
    for arch in ARCHS:
        _case(served, arch, kind, "contiguous")


@pytest.mark.parametrize("kind", QUANTS)
def test_paged_engine_serves_ssm_through_slot_pool(served, kind):
    """Pure SSM: no blocks at all, each request's conv + state rows in
    the slot pool; greedy tokens equal the reference's."""
    r = _case(served, "mamba2-130m", kind, "paged")
    assert not r["needs_blocks"] and not r["prefix_cache"]
    assert r["used_state_slots"] == 0 and r["free_state_slots"] == 4 \
        == r["state_slots"]
    assert r["free_blocks"] == r["n_usable"]          # untouched


@pytest.mark.parametrize("kind", QUANTS)
def test_paged_engine_serves_hybrid_blocks_plus_slots(served, kind):
    """Hybrid (attn_every=2): the attention layer pages KV blocks, the
    mamba layer rides the slot pool, one scheduler owns both."""
    r = _case(served, "jamba-1.5-large-398b", kind, "paged")
    assert r["needs_blocks"] and not r["prefix_cache"]
    assert r["used_state_slots"] == 0 and r["free_state_slots"] == 4
    assert r["free_blocks"] == r["n_usable"]


@pytest.mark.parametrize("kind", QUANTS)
@pytest.mark.parametrize("chunk", ARCHS["mamba2-130m"]["chunks"])
def test_chunked_identity_mamba2(served, kind, chunk):
    """Chunks continue the slot-resident conv tail + SSD state exactly
    where the previous chunk stopped (no pad token touches the
    recurrence)."""
    r = _case(served, "mamba2-130m", kind, f"chunked{chunk}")
    assert r["chunk_processed"] > 0
    assert r["used_state_slots"] == 0 and r["free_blocks"] == r["n_usable"]


@pytest.mark.parametrize("kind", QUANTS)
@pytest.mark.parametrize("chunk", ARCHS["jamba-1.5-large-398b"]["chunks"])
def test_chunked_identity_jamba_hybrid(served, kind, chunk):
    """The attention layer writes paged KV through the chunk's block
    table while the mamba layer continues its state: the split (not
    fused) mixed step."""
    r = _case(served, "jamba-1.5-large-398b", kind, f"chunked{chunk}")
    assert r["chunk_processed"] > 0
    assert r["used_state_slots"] == 0 and r["free_blocks"] == r["n_usable"]


# ---------------------------------------------------------------------------
# In process: the slot pool itself
# ---------------------------------------------------------------------------

def _ops(pool_cls):
    """One fixed sequence of slot-pool calls -> what each returned or
    raised, and the counts after it."""
    pool = pool_cls(3)
    log = []

    def call(fn, *a):
        try:
            log.append(("ok", fn(*a)))
        except (RuntimeError, ValueError) as e:
            log.append((type(e).__name__, str(e)))
        log.append((pool.free_slots, pool.used_slots))

    for _ in range(4):                  # the fourth is exhausted
        call(pool.alloc)
    call(pool.free, 2)
    call(pool.free, 2)                  # double free
    call(pool.free, 0)                  # the null slot
    call(pool.alloc)                    # LIFO: 2 again
    call(pool.free, 1)
    call(pool.validate)
    return log


def test_state_slot_pool_matches_reference():
    from repro.serving.paged_cache import StateSlotPool as JSlots
    from repro_torch.serving.paged_cache import StateSlotPool
    got, want = _ops(StateSlotPool), _ops(JSlots)
    assert got == want
    assert [x for x in got if x[0] == "ok"][:3] == [("ok", 1), ("ok", 2),
                                                   ("ok", 3)]
    assert ("ValueError", "free(): double free of slot 2") in got
    assert ("ValueError", "free(): slot 0 is the reserved null slot") in got
    pool = StateSlotPool(2)
    pool.alloc()
    pool._free.append(1)                # corrupt: a used slot on the list
    with pytest.raises(AssertionError):
        pool.validate()
    with pytest.raises(AssertionError):
        StateSlotPool(0)


def test_pool_slot_rows_zeroed_at_alloc_and_step_keys():
    from repro_torch.configs import get_config
    from repro_torch.models.config import QuantConfig
    from repro_torch.serving.paged_cache import PagedKVPool, needs_blocks
    cfg = get_config("jamba-1.5-large-398b").reduced(n_layers=2,
                                                     attn_every=2)
    with pytest.raises(ValueError, match="n_state_slots"):
        PagedKVPool(cfg, 5, 4, quant=QuantConfig(kv_bits=8), device="cpu")
    pool = PagedKVPool(cfg, 5, 4, quant=QuantConfig(kv_bits=8),
                       n_state_slots=2, device="cpu")
    assert needs_blocks(cfg) and pool.needs_blocks
    assert not needs_blocks(get_config("mamba2-130m").reduced())
    ssm, attn = pool.caches["layers"]
    assert ssm["conv"].shape == (3, 3, 160) and "pos" in attn
    assert ssm["state"].shape == (3, 8, 16, 16)
    assert attn["k"].shape[0] == 5                    # blocks, not slots
    ssm["state"][1:] = 1.0
    ssm["conv"][1:] = 1.0
    buf = ssm["state"]
    slot = pool.alloc_slot()
    assert slot == 1 and ssm["state"] is buf          # in place
    assert not ssm["state"][1].any() and not ssm["conv"][1].any()
    assert ssm["state"][2].eq(1.0).all()              # other rows kept
    pool.validate(check_contents=True)
    step = pool.step_caches(np.zeros((2, 1), np.int32),
                            np.zeros(2, np.int32),
                            slots=np.array([1, -1], np.int32))
    assert step["layers"][0]["slots"].tolist() == [1, -1]
    assert "slots" not in step["layers"][1]
    assert "block_tables" not in step["layers"][0]
    pool.absorb(step)
    assert set(pool.caches["layers"][0]) == {"conv", "state"}
    with pytest.raises(AssertionError, match="slot ids"):
        pool.step_caches(np.zeros((2, 1), np.int32), np.zeros(2, np.int32))
    ssm["conv"][0, 0, 0] = 1.0                        # a null row written
    with pytest.raises(AssertionError, match="null slot"):
        pool.validate(check_contents=True)
    ssm["conv"][0] = 0
    pool.free_slot(slot)
    with pytest.raises(ValueError, match="double free"):
        pool.free_slot(slot)
    assert pool.report()["free_state_slots"] == 2


def test_stateful_engines_share_no_prefix_and_prefill_exact_length():
    """A shared-prefix request on mamba2 gets no prefix hit (the cache
    is off for stateful stacks), and its prompt runs at its exact
    length: the SSM stack is not ``_bucketable``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.serving import engine as TE
    cfg = get_config("mamba2-130m").reduced(n_layers=1)
    params = TM.init_params(cfg, seed=0, device="cpu")
    eng = TE.Engine(params, cfg, n_slots=2, max_len=32, paged=True,
                    block_size=4)
    assert not eng._bucketable and not eng.pool.prefix_cache
    seen = []
    orig = TE.prefill_step_bucketed

    def spy(p, batch, *a, **kw):
        seen.append(tuple(batch["tokens"].shape))
        return orig(p, batch, *a, **kw)

    TE.prefill_step_bucketed = spy
    try:
        base = np.arange(3, 12, dtype=np.int32)
        reqs = [TE.Request(prompt=base.copy(), max_new_tokens=2),
                TE.Request(prompt=np.concatenate([base, [1, 2]]),
                           max_new_tokens=2)]
        for r in reqs:
            eng.submit(r)
        eng.run()
    finally:
        TE.prefill_step_bucketed = orig
    assert seen == [(1, 9), (1, 11)], seen
    assert eng.report()["prefix_hits"] == 0
    assert all(r.finish_reason == "length" for r in reqs)
    llama = get_config("llama3-8b").reduced(n_layers=1)
    assert TE.Engine(TM.init_params(llama, device="cpu"), llama,
                     max_len=32)._bucketable
    assert torch.equal(eng.pool.caches["layers"][0]["state"][0],
                       torch.zeros_like(
                           eng.pool.caches["layers"][0]["state"][0]))
