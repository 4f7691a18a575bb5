"""End-to-end demo: serve a small LLM with batched requests, on the
port (the paper is an inference-acceleration paper, so serving is the
primary end-to-end demo).

The PyTorch counterpart of ``examples/serve_llm.py``, with the same
model shape, seeds, prompts and steps: a 3.3M-param llama-family model
(random weights from seed 0), its weights quantized to the paper's W2A8
packed bipolar format (K3 on the card), serves a mixed queue of requests
through the continuous-batching engine (K1 for every linear) -- then the
same in bf16, comparing tokens/s and greedy outputs.

``--paged`` switches the quantized run to the paged block-pool engine
(kv_bits=8 packed KV planes shared through block tables, read by K2; a
scheduler with FCFS admission and preemption) and prints the pool
report.  The prompts share a system-style prefix, so the paged run also
exercises the refcounted copy-on-write prefix cache.

``--chunk-tokens N`` (with ``--paged``) turns on chunked prefill:
prompts stream through the step loop N tokens at a time, fused with the
decode batch.  The paged demo streams one request live through the
async API (a ``StreamHandle`` with an ``on_token`` callback).

``--metrics`` turns on the port's observability (:mod:`repro_torch.obs`)
for the quantized run: the engine is stepped by hand with a live
one-line stats bar read off the registry, the Prometheus snapshot is
summarized at the end, and the per-request Perfetto timeline is written
to ``--trace-out``.

Run:  PYTHONPATH=src python examples/torch_serve_llm.py [--new-tokens 12]
      [--paged] [--block-size 16] [--chunk-tokens 8] [--metrics]
      [--trace-out t.json] [--device cpu]
(``--device`` defaults to ``cuda`` and raises without a card).
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as E


def _stats_bar(eng, t0):
    """One line of live serving stats, read straight off the registry."""
    reg = eng.obs.registry
    toks = reg.value("repro_engine_tokens")
    dt = max(time.perf_counter() - t0, 1e-9)
    itl = reg.get("repro_request_intertoken_seconds")
    return (f"\r  [obs] {toks:4.0f} tok @ {toks / dt:6.1f} tok/s | "
            f"run {reg.value('repro_engine_running'):2.0f} "
            f"wait {reg.value('repro_engine_waiting'):2.0f} | "
            f"pool {reg.value('repro_pool_occupancy') * 100:3.0f}% | "
            f"itl p50 {itl.percentile(50) * 1e3:6.2f} ms "
            f"p95 {itl.percentile(95) * 1e3:6.2f} ms")


def serve(params, cfg, prompts, quant, new_tokens, *, paged=False,
          block_size=16, chunk_tokens=None, stream_one=False,
          metrics=False):
    eng = E.Engine(params, cfg, n_slots=4, max_len=128, quant=quant,
                   paged=paged, block_size=block_size,
                   chunk_tokens=chunk_tokens,
                   metrics=True if metrics else None)
    reqs = [E.Request(prompt=p, max_new_tokens=new_tokens) for p in prompts]
    if stream_one:
        # the async API: request 0's tokens arrive live while the whole
        # queue decodes around it
        reqs[0].on_token = lambda t: print(f"  stream req0 -> {t}",
                                           flush=True)
    handles = [eng.submit(r) for r in reqs]
    t0 = time.perf_counter()
    if metrics:
        # a step loop by hand, so the stats bar refreshes every step
        while eng.step():
            print(_stats_bar(eng, t0), end="", flush=True)
        print()
    else:
        if stream_one:
            for _ in handles[0].tokens():   # drive through the handle...
                pass
        eng.run()                           # ...then drain the rest
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in reqs)
    return reqs, total / dt, eng


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--paged", action="store_true",
                    help="serve the quantized run on the paged block-pool "
                         "engine (kv_bits=8 KV planes + block tables)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per pool block (--paged)")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunked prefill budget per step (--paged): "
                         "prompts stream in fused with the decode batch")
    ap.add_argument("--metrics", action="store_true",
                    help="instrument the quantized run: live stats bar, "
                         "Prometheus summary, Perfetto trace on exit")
    ap.add_argument("--trace-out", default="serve_trace.json",
                    help="Perfetto trace path (--metrics)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = M.resolve_device(args.device)

    cfg = get_config("llama3-8b").reduced(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2, d_head=32,
        d_ff=512, vocab=2048)
    params = M.init_params(cfg, seed=0, device=dev)
    print(f"model: llama-family reduced, "
          f"{cfg.param_count() / 1e6:.1f}M params")

    rng = np.random.default_rng(0)
    # a shared "system prompt" head + unique tails: the paged engine's
    # prefix cache serves the head from residency for requests 2..8
    system = rng.integers(0, cfg.vocab, (24,), dtype=np.int32)
    prompts = [np.concatenate([
        system, rng.integers(0, cfg.vocab, (6 + i,), dtype=np.int32)
    ]).astype(np.int32) for i in range(8)]

    print("— serving bf16 …")
    reqs_bf, tps_bf, _ = serve(params, cfg, prompts, None, args.new_tokens)

    kv_bits = 8 if args.paged else None
    qcfg = QuantConfig(w_bits=2, a_bits=8, kv_bits=kv_bits)
    qparams = M.quantize_params(params, qcfg)
    label = "W2A8+paged-KV8" if args.paged else "W2A8"
    print(f"— serving {label} (paper technique: packed bipolar "
          f"{'weights + paged KV pool' if args.paged else 'weights'}) …")
    reqs_q, tps_q, eng_q = serve(qparams, cfg, prompts, qcfg,
                                 args.new_tokens, paged=args.paged,
                                 block_size=args.block_size,
                                 chunk_tokens=args.chunk_tokens,
                                 stream_one=args.paged
                                 and not args.metrics,
                                 metrics=args.metrics)

    agree = np.mean([
        np.mean(np.asarray(a.out[:4]) == np.asarray(b.out[:4]))
        for a, b in zip(reqs_bf, reqs_q)])
    print(f"bf16   : {tps_bf:6.1f} tok/s")
    print(f"{label:7s}: {tps_q:6.1f} tok/s   (on {dev.type}: "
          f"{'the kernels' if dev.type == 'cuda' else 'their plain versions'}"
          f"; the W2 weights are 8x fewer bytes than bf16)")
    print(f"greedy agreement on first 4 tokens: {agree * 100:.0f}% "
          f"(W2 is aggressive; this is a random-weight toy)")
    if args.paged:
        rep = eng_q.report()
        print(f"pool: {rep['n_usable']} blocks x {rep['block_size']} tok "
              f"@ kv_bits={rep['kv_bits']}, "
              f"{rep['pool_bytes'] / 1024:.0f} KiB, "
              f"{rep['preemptions']} preemptions, "
              f"{rep['rejections']} rejections")
        print(f"prefix cache: {rep['prefix_hits']} hits / "
              f"{rep['prefix_lookups']} lookups, "
              f"{rep['prefix_hit_tokens']} prompt tokens served from "
              f"residency, {rep['cow_copies']} copy-on-writes, "
              f"{rep['evictions']} evictions")
        if rep["chunk_tokens"]:
            print(f"chunked prefill: {rep['chunk_tokens']} tokens/step "
                  f"budget, {rep['chunk_tokens_processed']} prompt tokens "
                  f"streamed through the step loop")
    if args.metrics:
        reg = eng_q.obs.registry
        ttft = reg.get("repro_request_ttft_seconds")
        eng_q.obs.tracer.validate_all()
        eng_q.obs.tracer.export_json(args.trace_out)
        print(f"metrics: {reg.value('repro_requests_submitted'):.0f} "
              f"submitted, "
              f"{reg.value('repro_requests_finished', reason='length'):.0f}"
              f" finished(length), ttft p50 "
              f"{ttft.percentile(50) * 1e3:.2f} ms p95 "
              f"{ttft.percentile(95) * 1e3:.2f} ms over {ttft.count} "
              f"requests")
        n_ev = len(eng_q.obs.tracer.export()["traceEvents"])
        print(f"perfetto timeline: {n_ev} events -> {args.trace_out} "
              f"(open in ui.perfetto.dev)")
    assert all(r.done for r in reqs_bf + reqs_q)
    print("done.")


if __name__ == "__main__":
    main()
