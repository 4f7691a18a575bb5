"""The port's serving policy against the reference engine, on identical
parameters: backpressure (``max_queue``, the ``retry_after`` hint,
``StreamHandle.resubmit``), the pool watchdog (``validate_every``),
nested precision tiers, sampling at temperature > 0, and greedy tokens
at w4 and w8.

The reference's own backpressure and request-lifecycle tests
(tests/test_chaos.py: shed and resubmit, the shed rate under overload,
double submit, cancel after finish) serve reduced mamba2-130m through
the state slot pool, and so do their scenarios here (``*_ssm``,
checking ``pool.slots.free_slots`` as the reference does), with a
watchdog case that corrupts a request's slot id.  The same backpressure
cases also serve reduced llama3-8b (paged: kv8 with ``free_blocks``;
and the contiguous engine), the block-table watchdog cases reduced
mixtral-8x7b with an 8-token window, the tier cases reduced llama3-8b
at w8.  Each scenario
runs once in each package, with XLA's excess precision off (a
subprocess: the flag must be set before JAX starts; see
tests/test_torch_model.py), where the logits are bit-identical; every
token, finish reason, error, retry hint, backoff delay, precision grant
and counter value must then be equal.
"""

import json
import os
import subprocess
import sys

import pytest

SCENARIOS = ["watchdog_repair", "watchdog_quarantine", "shed_paged",
             "shed_contiguous", "shed_rate", "tier_frozen", "tier_mixed",
             "temperature_paged", "temperature_contiguous", "greedy_w4",
             "greedy_w8", "shed_ssm", "shed_rate_ssm", "double_submit_ssm",
             "cancel_after_finish_ssm", "watchdog_slot_ssm"]

_RUN = r"""
import dataclasses, json, sys
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

_PARAMS = {}


class Side:
    def __init__(self, name):
        self.name = name
        self.E = JE if name == "ref" else TE
        self.Q = JQ if name == "ref" else TQ

    def setup(self, arch, q, seed=1, **red):
        key = (arch, json.dumps(red, sort_keys=True), seed,
               json.dumps(dataclasses.asdict(q), sort_keys=True))
        if key not in _PARAMS:
            cfg_j = jget(arch).reduced(**red)
            qj = JQ(**dataclasses.asdict(q))
            pj = JM.init_params(cfg_j, jax.random.PRNGKey(seed))
            if qj.enabled:
                pj = JM.quantize_params(pj, qj)
            _PARAMS[key] = (pj, torch_params(pj, tget(arch).reduced(**red)))
        pj, pt = _PARAMS[key]
        cfg = (jget if self.name == "ref" else tget)(arch).reduced(**red)
        return cfg, (pj if self.name == "ref" else pt), \
            self.Q(**dataclasses.asdict(q))


def toks(reqs):
    return [[int(t) for t in r.out] for r in reqs]


def watchdog(S, corrupt_table):
    cfg, params, kv8 = S.setup("mixtral-8x7b", JQ(kv_bits=8), n_layers=2,
                               window=8)
    rng = np.random.default_rng(13 if corrupt_table else 7)
    lens = (5, 9)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
               for n in lens]

    def engine(**kw):
        return S.E.Engine(params, cfg, n_slots=2, max_len=32, quant=kv8,
                          paged=True, block_size=4, chunk_tokens=3, **kw)

    base = engine()
    breqs = [S.E.Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    for r in breqs:
        base.submit(r)
    base.run()
    eng = engine(validate_every=1)
    reqs = [S.E.Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    for r in reqs:
        eng.submit(r)
    for _ in range(4):                 # get both requests decoding
        assert eng.step()
    if corrupt_table:
        seq_b = next(s for s in eng.scheduler.running if s.req is reqs[1])
        seq_b.blocks[0] = 9999         # corrupt b's table, then un-balance
        eng.pool._free.append(1)       # the pool so validate() trips
    else:
        live = next(int(b) for s in eng.scheduler.running for b in s.blocks)
        eng.pool._free.append(live)    # corrupt: live id on the free list
    eng.run()
    eng.pool.validate()
    reg = eng.pool.metrics
    return dict(
        base=toks(breqs), out=toks(reqs),
        reasons=[r.finish_reason for r in reqs],
        errors=[r.error for r in reqs],
        violations=reg.value("repro_engine_fault_watchdog_violations"),
        quarantined=reg.value("repro_engine_fault_requests", kind="watchdog"),
        drained=eng.pool.free_blocks == eng.pool.n_usable)


def shed(S, paged):
    cfg, params, q = S.setup("llama3-8b", JQ(kv_bits=8), n_layers=2)
    rng = np.random.default_rng(6)
    p_a = rng.integers(0, cfg.vocab, (5,), dtype=np.int32)
    p_b = rng.integers(0, cfg.vocab, (7,), dtype=np.int32)
    kw = dict(paged=True, block_size=4, chunk_tokens=3) if paged \
        else dict(paged=False)

    def engine(**more):
        return S.E.Engine(params, cfg, n_slots=1 if not paged else 2,
                          max_len=32, quant=q, **kw, **more)

    base_eng = engine()
    base = S.E.Request(prompt=p_b.copy(), max_new_tokens=4)
    base_eng.submit(base)
    base_eng.run()
    eng = engine(max_queue=1)
    a = S.E.Request(prompt=p_a.copy(), max_new_tokens=4)
    b = S.E.Request(prompt=p_b.copy(), max_new_tokens=4)
    ha = eng.submit(a)                 # fills the one queue seat
    hb = eng.submit(b)                 # shed: queue is at max_queue
    reg = eng.pool.metrics if paged else None
    shed_state = dict(done=b.done, reason=b.finish_reason, error=b.error,
                      handle_error=hb.error, hint=hb.retry_after,
                      out=list(b.out))
    if reg is not None:
        shed_state["counter"] = reg.value("repro_sched_shed_requests")
        shed_state["gauge"] = reg.value("repro_sched_shed_retry_after")
    ha.result()                        # drain the queue
    delays = []
    hb.resubmit(sleep=delays.append)   # injectable backoff clock
    requeued = not b.done
    out = hb.result()
    return dict(shed=shed_state, a_reason=a.finish_reason, a_out=list(a.out),
                delays=delays, requeued=requeued, b_reason=out.finish_reason,
                b_error=out.error, b_out=toks([b])[0], base=toks([base])[0],
                drained=(eng.pool.free_blocks == eng.pool.n_usable)
                if paged else not any(eng.slot_req))


def shed_rate(S):
    cfg, params, q = S.setup("llama3-8b", JQ(kv_bits=8), n_layers=2)
    rng = np.random.default_rng(10)
    eng = S.E.Engine(params, cfg, n_slots=2, max_len=32, quant=q,
                     paged=True, block_size=4, chunk_tokens=3, max_queue=2)
    reqs = [S.E.Request(prompt=rng.integers(0, cfg.vocab, (5,),
                                            dtype=np.int32),
                        max_new_tokens=2) for _ in range(8)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return dict(reasons=[r.finish_reason for r in reqs],
                hints=[r.retry_after for r in reqs], out=toks(reqs),
                shed=eng.pool.metrics.value("repro_sched_shed_requests"),
                drained=eng.pool.free_blocks == eng.pool.n_usable)


def tier_frozen(S):
    cfg, params, q = S.setup("llama3-8b", JQ(w_bits=8, a_bits=8, kv_bits=8,
                                             precision_floor=2), n_layers=2)
    eng = S.E.Engine(params, cfg, quant=q, paged=True, n_slots=4,
                     max_len=64, block_size=4, n_blocks=6, max_batch=4)
    grants = {}
    inner = eng.scheduler.precision_policy

    def recording(req):
        bits = inner(req)
        grants.setdefault(id(req), []).append(bits)
        return bits

    eng.scheduler.precision_policy = recording
    rng = np.random.default_rng(5)
    reqs = [S.E.Request(prompt=rng.integers(0, cfg.vocab, (6,),
                                            dtype=np.int32),
                        max_new_tokens=8) for _ in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return dict(grants=[grants[id(r)] for r in reqs],
                frozen=[r._tier_bits for r in reqs], out=toks(reqs),
                reasons=[r.finish_reason for r in reqs],
                preemptions=eng.scheduler.n_preemptions)


def tier_mixed(S):
    cfg, params, q = S.setup("llama3-8b", JQ(w_bits=8, a_bits=8, kv_bits=8),
                             n_layers=2)
    eng = S.E.Engine(params, cfg, quant=q, paged=True, n_slots=4,
                     max_len=64, block_size=16, metrics=True)
    rng = np.random.default_rng(7)
    reqs = [S.E.Request(prompt=rng.integers(0, cfg.vocab, (6,),
                                            dtype=np.int32),
                        max_new_tokens=3, precision=b) for b in (8, 8, 4, 2)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    counts = {}
    for line in eng.pool.metrics.render().splitlines():
        if line.startswith("repro_engine_precision_total{"):
            label, val = line.split("}")
            counts[label.split('"')[1]] = int(float(val))
    return dict(counts=counts, out=toks(reqs),
                reasons=[r.finish_reason for r in reqs])


def serve(S, q, *, paged, temperature=0.0):
    cfg, params, q = S.setup("llama3-8b", q, seed=2, n_layers=2, d_head=32)
    kw = dict(paged=True, block_size=8, chunk_tokens=8) if paged \
        else dict(paged=False)
    eng = S.E.Engine(params, cfg, n_slots=2, max_len=48, quant=q, **kw)
    rng = np.random.default_rng(11)
    reqs = [S.E.Request(prompt=rng.integers(0, cfg.vocab, (n,),
                                            dtype=np.int32),
                        max_new_tokens=8, temperature=temperature,
                        seed=None if i else 1234)
            for i, n in enumerate((5, 14, 9))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return dict(out=toks(reqs), reasons=[r.finish_reason for r in reqs],
                seeds=[r.seed for r in reqs])


def mamba(S):
    return S.setup("mamba2-130m", JQ())[:2]


def slots_drained(eng):
    return eng.pool.slots.free_slots == eng.pool.slots.n_slots


def shed_ssm(S):
    cfg, params = mamba(S)
    rng = np.random.default_rng(6)
    p_a = rng.integers(0, cfg.vocab, (5,), dtype=np.int32)
    p_b = rng.integers(0, cfg.vocab, (7,), dtype=np.int32)
    base_eng = S.E.Engine(params, cfg, n_slots=2, max_len=32)
    base = S.E.Request(prompt=p_b.copy(), max_new_tokens=4)
    base_eng.submit(base)
    base_eng.run()
    eng = S.E.Engine(params, cfg, n_slots=2, max_len=32, paged=True,
                     block_size=4, chunk_tokens=3, max_queue=1)
    a = S.E.Request(prompt=p_a.copy(), max_new_tokens=4)
    b = S.E.Request(prompt=p_b.copy(), max_new_tokens=4)
    ha = eng.submit(a)                 # fills the one queue seat
    hb = eng.submit(b)                 # shed: queue is at max_queue
    reg = eng.pool.metrics
    shed_state = dict(done=b.done, reason=b.finish_reason, error=b.error,
                      handle_error=hb.error, hint=hb.retry_after,
                      out=list(b.out),
                      counter=reg.value("repro_sched_shed_requests"),
                      gauge=reg.value("repro_sched_shed_retry_after"))
    ha.result()                        # drain the queue
    delays = []
    hb.resubmit(sleep=delays.append)   # injectable backoff clock
    requeued = not b.done
    out = hb.result()
    return dict(shed=shed_state, a_reason=a.finish_reason, a_out=list(a.out),
                delays=delays, requeued=requeued, b_reason=out.finish_reason,
                b_error=out.error, b_out=toks([b])[0], base=toks([base])[0],
                drained=slots_drained(eng))


def shed_rate_ssm(S):
    cfg, params = mamba(S)
    rng = np.random.default_rng(10)
    eng = S.E.Engine(params, cfg, n_slots=2, max_len=32, paged=True,
                     block_size=4, chunk_tokens=3, max_queue=2)
    reqs = [S.E.Request(prompt=rng.integers(0, cfg.vocab, (5,),
                                            dtype=np.int32),
                        max_new_tokens=2) for _ in range(8)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return dict(reasons=[r.finish_reason for r in reqs],
                hints=[r.retry_after for r in reqs], out=toks(reqs),
                shed=eng.pool.metrics.value("repro_sched_shed_requests"),
                drained=slots_drained(eng))


def double_submit_ssm(S):
    cfg, params = mamba(S)
    rng = np.random.default_rng(14)
    eng = S.E.Engine(params, cfg, n_slots=2, max_len=32, paged=True,
                     block_size=4, chunk_tokens=3)
    r = S.E.Request(prompt=rng.integers(0, cfg.vocab, (5,), dtype=np.int32),
                    max_new_tokens=4)
    h1 = eng.submit(r)
    h2 = eng.submit(r)                 # same engine, in flight: no-op
    waiting = list(eng.scheduler.waiting).count(r)
    eng.step()                         # r admitted
    eng.submit(r)                      # still in flight: no-op again
    requeued = r in eng.scheduler.waiting
    h1.result()
    eng2 = S.E.Engine(params, cfg, n_slots=2, max_len=32)
    q = S.E.Request(prompt=rng.integers(0, cfg.vocab, (4,), dtype=np.int32),
                    max_new_tokens=2)
    eng2.submit(q), eng2.submit(q)
    queued = eng2.queue.count(q)
    eng2.run()
    return dict(same_req=h2.req is r, waiting=waiting, requeued=requeued,
                reason=r.finish_reason, out=toks([r])[0], drained=
                slots_drained(eng), queued=queued, q_done=q.done,
                q_out=toks([q])[0])


def cancel_after_finish_ssm(S):
    cfg, params = mamba(S)
    rng = np.random.default_rng(15)
    eng = S.E.Engine(params, cfg, n_slots=2, max_len=32, paged=True,
                     block_size=4, chunk_tokens=3)
    r = S.E.Request(prompt=rng.integers(0, cfg.vocab, (5,), dtype=np.int32),
                    max_new_tokens=3)
    h = eng.submit(r)
    h.result()
    reason, n_out = r.finish_reason, len(r.out)
    cancels = [h.cancel(), h.cancel()]   # already finished: clean noes
    eng.pool.validate()                  # no double release happened
    return dict(reason=reason, n_out=n_out, cancels=cancels,
                after=(r.finish_reason, len(r.out)), out=toks([r])[0],
                drained=slots_drained(eng))


def watchdog_slot_ssm(S):
    cfg, params = mamba(S)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
               for n in (5, 9)]

    def engine(**kw):
        return S.E.Engine(params, cfg, n_slots=2, max_len=32, paged=True,
                          block_size=4, chunk_tokens=3, **kw)

    base = engine()
    breqs = [S.E.Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    for r in breqs:
        base.submit(r)
    base.run()
    eng = engine(validate_every=1)
    reqs = [S.E.Request(prompt=p.copy(), max_new_tokens=6) for p in prompts]
    for r in reqs:
        eng.submit(r)
    for _ in range(5):                 # get both requests decoding
        assert eng.step()
    seq_b = next(s for s in eng.scheduler.running if s.req is reqs[1])
    eng.pool.slots._used.discard(seq_b.slot)   # un-balance the slot pool
    seq_b.slot = 99                    # and give b an impossible slot
    eng.run()
    eng.pool.validate()
    reg = eng.pool.metrics
    return dict(
        base=toks(breqs), out=toks(reqs),
        reasons=[r.finish_reason for r in reqs],
        errors=[r.error for r in reqs],
        violations=reg.value("repro_engine_fault_watchdog_violations"),
        quarantined=reg.value("repro_engine_fault_requests", kind="watchdog"),
        drained=slots_drained(eng))


W2 = JQ(w_bits=2, a_bits=8, kv_bits=8)
RUNS = {
    "watchdog_repair": lambda S: watchdog(S, False),
    "watchdog_quarantine": lambda S: watchdog(S, True),
    "shed_paged": lambda S: shed(S, True),
    "shed_contiguous": lambda S: shed(S, False),
    "shed_rate": shed_rate,
    "tier_frozen": tier_frozen,
    "tier_mixed": tier_mixed,
    "temperature_paged": lambda S: serve(S, W2, paged=True, temperature=0.8),
    "temperature_contiguous": lambda S: serve(S, W2, paged=False,
                                              temperature=0.8),
    "greedy_w4": lambda S: serve(S, JQ(w_bits=4, a_bits=8, kv_bits=8),
                                 paged=True),
    "greedy_w8": lambda S: serve(S, JQ(w_bits=8, a_bits=8, kv_bits=8),
                                 paged=True),
    "shed_ssm": shed_ssm,
    "shed_rate_ssm": shed_rate_ssm,
    "double_submit_ssm": double_submit_ssm,
    "cancel_after_finish_ssm": cancel_after_finish_ssm,
    "watchdog_slot_ssm": watchdog_slot_ssm,
}
out = {name: {side: fn(Side(side)) for side in ("ref", "port")}
       for name, fn in RUNS.items()}
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
    res = json.loads(out.stdout.split("RESULT", 1)[1])
    assert sorted(res) == sorted(SCENARIOS)
    return res


def _same(runs, name):
    r = runs[name]
    assert r["port"] == r["ref"], r
    return r["port"]


@pytest.mark.parametrize("name", ["watchdog_repair", "watchdog_quarantine"])
def test_watchdog_recovers_like_the_reference(runs, name):
    r = _same(runs, name)
    assert r["violations"] == 1 and r["drained"], r
    if name == "watchdog_repair":
        # a live id on the free list: the free list is rebuilt from the
        # intact tables and every request keeps its fault-free tokens
        assert r["reasons"] == ["length"] * 2 and r["errors"] == [None] * 2
        assert r["out"] == r["base"]
        assert r["quarantined"] == 0
    else:
        # an impossible id in b's table: b is quarantined, a unharmed
        assert r["reasons"] == ["length", "error"]
        assert "integrity" in r["errors"][1] and r["errors"][0] is None
        assert r["out"][0] == r["base"][0]
        assert r["quarantined"] == 1


@pytest.mark.parametrize("name", ["shed_paged", "shed_contiguous", "shed_ssm"])
def test_max_queue_sheds_with_retry_after_and_resubmit_recovers(runs, name):
    r = _same(runs, name)
    s = r["shed"]
    assert s["done"] and s["reason"] == "rejected" and s["out"] == []
    assert "queue full" in s["error"] and s["handle_error"] == s["error"]
    assert s["hint"] is not None and s["hint"] > 0
    if name != "shed_contiguous":
        assert s["counter"] == 1 and s["gauge"] == s["hint"]
    assert r["a_reason"] == "length"
    assert r["delays"] and r["delays"][0] >= min(2.0, max(s["hint"],
                                                          0.05)) - 1e-9
    assert r["requeued"], "resubmit must have re-queued the request"
    assert r["b_reason"] == "length" and r["b_error"] is None
    assert r["b_out"] == r["base"], "a shed/resubmit cycle changed tokens"
    assert r["drained"]


@pytest.mark.parametrize("name", ["shed_rate", "shed_rate_ssm"])
def test_shed_rate_bounded_under_overload(runs, name):
    r = _same(runs, name)
    shed = [i for i, x in enumerate(r["reasons"]) if x == "rejected"]
    served = [i for i, x in enumerate(r["reasons"]) if x == "length"]
    assert len(shed) + len(served) == 8 and shed and served, r
    assert r["shed"] == len(shed)
    for i in shed:
        assert r["hints"][i] > 0 and r["out"][i] == []
    assert r["drained"]


def test_tier_bits_pinned_equals_reference():
    from repro.serving.engine import tier_bits as ref_tier_bits
    from repro_torch.serving.engine import tier_bits
    for requested in (None, 1, 2, 4, 8, 12):
        for max_bits in (2, 4, 8):
            for floor in (None, 2, 4, 8):
                for depth in (0, 1, 4, 7, 8, 40, 200):
                    for pressure in (1, 4, 16):
                        kw = dict(max_bits=max_bits, floor=floor,
                                  queue_depth=depth, pressure=pressure)
                        assert tier_bits(requested, **kw) == \
                            ref_tier_bits(requested, **kw), (requested, kw)
    assert tier_bits(8, max_bits=8, floor=4, queue_depth=8) == 6
    assert tier_bits(2, max_bits=8, floor=4, queue_depth=999) == 2


def test_precision_frozen_across_preemption(runs):
    r = _same(runs, "tier_frozen")
    assert r["preemptions"] > 0, "the pool must force preemption"
    assert r["reasons"] == ["length"] * 3
    for seen, frozen in zip(r["grants"], r["frozen"]):
        assert len(set(seen)) == 1 and seen[0] == frozen, r


def test_mixed_tier_lanes_complete_and_count(runs):
    r = _same(runs, "tier_mixed")
    assert r["counts"] == {"8": 6, "4": 3, "2": 3}, r
    assert r["reasons"] == ["length"] * 4


@pytest.mark.parametrize("name", ["temperature_paged",
                                  "temperature_contiguous"])
def test_engine_tokens_at_temperature_equal_reference(runs, name):
    r = _same(runs, name)
    assert r["reasons"] == ["length"] * 3 and r["seeds"][0] == 1234
    assert all(len(o) == 8 for o in r["out"])


@pytest.mark.parametrize("name", ["greedy_w4", "greedy_w8"])
def test_greedy_engine_tokens_at_w4_and_w8_equal_reference(runs, name):
    r = _same(runs, name)
    assert r["reasons"] == ["length"] * 3
    assert all(len(o) == 8 for o in r["out"])


def test_double_submit_is_idempotent(runs):
    r = _same(runs, "double_submit_ssm")
    assert r["same_req"] and r["waiting"] == 1 and not r["requeued"], r
    assert r["reason"] == "length" and len(r["out"]) == 4
    assert r["queued"] == 1 and r["q_done"] and len(r["q_out"]) == 2
    assert r["drained"]


def test_cancel_after_finish_is_a_clean_no(runs):
    r = _same(runs, "cancel_after_finish_ssm")
    assert r["reason"] == "length" and r["cancels"] == [False, False]
    assert r["after"] == ["length", r["n_out"]] and r["drained"]


def test_watchdog_quarantines_a_corrupt_slot_like_the_reference(runs):
    """An impossible slot id on b, with the slot pool un-balanced: the
    watchdog quarantines b, rebuilds the slot pool from the surviving
    slots, and a keeps its fault-free tokens."""
    r = _same(runs, "watchdog_slot_ssm")
    assert r["violations"] == 1 and r["quarantined"] == 1, r
    assert r["reasons"] == ["length", "error"]
    assert "integrity" in r["errors"][1] and r["errors"][0] is None
    assert r["out"][0] == r["base"][0]
    assert r["drained"]
