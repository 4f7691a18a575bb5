"""The port's paged serving engine against the reference engine, and its
pool/scheduler behaviour on its own.

``Engine(paged=True, chunk_tokens=8)`` of both packages serves the same
briefly trained llama3-8b (reduced) with the same w2/a8/kv8 packed
weights.  Greedy tokens must be identical wherever the reference's
top-1/top-2 logit margin exceeds ``MARGIN``: the first divergence of a
request is allowed only at a near-tie, after which its continuations
differ legitimately.  ``MARGIN`` = 0.15: in process, XLA keeps some bf16
intermediates at f32 precision, which moves the reference's logits by up
to 6% of the largest logit (about 2.5 on this model; see
tests/test_torch_model.py, where the logits are bit-identical once XLA's
excess precision is off).
"""

import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.data.pipeline import DataSpec
from repro.models import model as JM
from repro.models.config import QuantConfig as JQ
from repro.serving import engine as JE
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.configs import get_config
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as TE

from _torch_parity import torch_params

MARGIN = 0.15
RED = dict(n_layers=2, d_head=32, vocab=256)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg_j = jget("llama3-8b").reduced(**RED)
    cfg_t = get_config("llama3-8b").reduced(**RED)
    spec = DataSpec(vocab=cfg_j.vocab, seq_len=32, global_batch=4, seed=5)
    tcfg = TrainConfig(num_steps=30, peak_lr=1e-3, warmup_steps=5,
                       ckpt_dir=str(tmp_path_factory.mktemp("ckpt")),
                       ckpt_every=100)
    state, _ = Trainer(cfg_j, tcfg, spec, async_ckpt=False).run(resume=False)
    qj = JQ(w_bits=2, a_bits=8, kv_bits=8)
    pj = JM.quantize_params(state["params"], qj)
    return cfg_j, cfg_t, qj, pj, torch_params(pj, cfg_t)


QT = QuantConfig(w_bits=2, a_bits=8, kv_bits=8)


class _RecordingEngine(JE.Engine):
    """The reference engine, recording every logits row it samples from
    (keyed by request and output index) -- test-side only."""

    def _sample_checked(self, row, seq):
        self.rows = getattr(self, "rows", {})
        self.rows[(id(seq.req), len(seq.req.out))] = np.array(row,
                                                             np.float32)
        return super()._sample_checked(row, seq)


def _prompts(n=4, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (5 + 4 * i,), dtype=np.int32)
            for i in range(n)]


def _serve(engine_cls, request_cls, params, cfg, quant, prompts, *,
           max_new=10, **kw):
    kw.setdefault("block_size", 8)
    eng = engine_cls(params, cfg, n_slots=2, max_len=48, quant=quant,
                     paged=True, **kw)
    reqs = [request_cls(prompt=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.finish_reason == "length" for r in reqs)
    return reqs, eng


def test_chunked_engine_tokens_match_reference(served):
    cfg_j, cfg_t, qj, pj, pt = served
    prompts = _prompts()
    rj, ej = _serve(_RecordingEngine, JE.Request, pj, cfg_j, qj, prompts,
                    chunk_tokens=8)
    rt, et = _serve(TE.Engine, TE.Request, pt, cfg_t, QT, prompts,
                    chunk_tokens=8)
    compared = 0
    for a, b in zip(rj, rt):
        k = next((i for i, (x, y) in enumerate(zip(a.out, b.out))
                  if x != y), None)
        compared += len(a.out) if k is None else k + 1
        if k is not None:
            top = np.sort(ej.rows[(id(a), k)])
            assert top[-1] - top[-2] < MARGIN, (k, a.out, b.out, top[-2:])
    assert compared >= 20, compared
    rep = et.report()
    assert rep["free_blocks"] == rep["n_usable"]
    assert rep["chunk_tokens_processed"] == sum(len(p) for p in prompts)


def _drained(eng):
    rep = eng.report()
    assert rep["free_blocks"] == rep["n_usable"] and rep["used_blocks"] == 0
    assert rep["running"] == 0 and rep["waiting"] == 0
    eng.pool.validate(check_contents=True)
    return rep


def test_prefix_cache_hit_serves_identical_tokens(served):
    _, cfg_t, _, _, pt = served
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 256, (16,), dtype=np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, (3 + i,),
                                                    dtype=np.int32)])
               for i in range(2)]
    warm = TE.Engine(pt, cfg_t, n_slots=2, max_len=48, quant=QT,
                     paged=True, block_size=8, chunk_tokens=8)
    outs = []
    for p in prompts:                       # sequential: the 2nd hits
        r = TE.Request(prompt=p.copy(), max_new_tokens=6)
        warm.submit(r)
        warm.run()
        outs.append(r.out)
    rep = _drained(warm)
    assert rep["prefix_hits"] >= 1 and rep["prefix_hit_tokens"] >= 8
    cold, _ = _serve(TE.Engine, TE.Request, pt, cfg_t, QT, prompts,
                     max_new=6, chunk_tokens=8, prefix_cache=False)
    assert [r.out for r in cold] == outs


def test_preemption_warm_restart_and_drain(served):
    _, cfg_t, _, _, pt = served
    prompts = [p[:6] for p in _prompts(3, seed=7)] + _prompts(1, seed=7)
    small, es = _serve(TE.Engine, TE.Request, pt, cfg_t, QT, prompts,
                       max_new=8, block_size=4, n_blocks=7, max_batch=4,
                       chunk_tokens=4)
    assert es.scheduler.n_preemptions > 0
    big, eb = _serve(TE.Engine, TE.Request, pt, cfg_t, QT, prompts,
                     max_new=8, block_size=4, n_blocks=60, max_batch=4,
                     chunk_tokens=4)
    assert eb.scheduler.n_preemptions == 0
    assert [r.out for r in small] == [r.out for r in big]
    _drained(es)
    _drained(eb)


def test_whole_prompt_mode_stream_and_cancel(served):
    """``chunk_tokens=None`` prefills at admission; a streamed request
    can be cancelled mid-decode and its blocks return to the pool."""
    _, cfg_t, _, _, pt = served
    eng = TE.Engine(pt, cfg_t, n_slots=2, max_len=48, quant=QT, paged=True,
                    block_size=8, metrics=True)
    keep = TE.Request(prompt=_prompts(1)[0], max_new_tokens=5)
    drop = TE.Request(prompt=_prompts(2)[1], max_new_tokens=20)
    eng.submit(keep)
    handle = eng.submit(drop)
    got = []
    for tok in handle.tokens():
        got.append(tok)
        if len(got) == 3:
            assert handle.cancel()
            break
    eng.run()
    assert drop.finish_reason == "cancelled" and len(drop.out) == 3
    assert keep.finish_reason == "length" and len(keep.out) == 5
    _drained(eng)
    eng.obs.tracer.validate_all()        # every span tree balanced
    assert "repro_pool_prefix_lookups" in eng.obs.registry.render()
