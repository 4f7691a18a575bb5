#!/usr/bin/env python3
"""Chip smoke test of the ``repro_torch`` port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines; any failure ends the run with a nonzero
exit and no result line):

1. device  -- the card's name and power limit (``nvidia-smi``);
2. build   -- every kernel of ``src/repro_torch/csrc`` compiled with
   ``nvcc`` for sm_90a, one process per source, and the ``-Xptxas -v``
   summary;
3. kernels -- each hand-written kernel against its plain torch version on
   the card, at the shapes of llama3-8b's serving path (K3 words and the
   K1 integer core of every weight bit-exact; K1 SiLU outputs within 1
   bf16 ulp of the plain version, K2 outputs within 1 bf16 ulp or 1e-5),
   with its time (CUDA events, L2 flushed before every launch), its
   bound on this card, the plain version's time and the yardsticks;
4. full width, depth 2 -- one forward on the card, then the same forward
   with the parameters moved to the CPU (the plain versions run there
   because the device decides), logits compared;
5. end to end -- the full 32-layer llama3-8b (random weights from
   ``--seed``) quantized on the card to w2 (K3 at load) and served by
   ``Engine(paged=True, block_size=16, chunk_tokens=256)`` at w2/a8/kv8:
   the launch counters are zeroed just before and read just after;
6. the ``kernels:`` line, the JSON kernels line, the ``nvidia-smi`` line
   and, last, the JSON device line.

It imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# published H100 SXM peaks (NVIDIA data sheet, dense), used for bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of ``fn`` with L2 flushed before each
    launch (the serving path reads every weight cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in units in the last place:
    the ordinal distance of their bit patterns (+0 and -0 coincide)."""
    import torch

    def ordinal(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordinal(a) - ordinal(b)).abs()


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / ops_rate
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def k3_phase(torch, timer, rng_seed, results):
    from repro_torch.core import bipolar
    from repro_torch.kernels import pack, ref
    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    r, k, n_bits = 14336, 4096, 2
    x = torch.randn((r, k), generator=g, device="cuda")
    scale = bipolar.absmax_scale(x, n_bits, axis=-1)
    got = pack.quantize_pack_rows(x, scale, n_bits=n_bits, pad_bit=1)
    torch.cuda.synchronize()
    want = ref.quantize_pack_rows(x, scale, n_bits=n_bits, pad_bit=1)
    err = float((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("K3 words differ from the plain version")
    ms = timer(lambda: pack.quantize_pack_rows(x, scale, n_bits=n_bits,
                                               pad_bit=1), iters=20)
    plain = timer(lambda: ref.quantize_pack_rows(x, scale, n_bits=n_bits,
                                                 pad_bit=1), iters=3, warmup=1)
    kw = bipolar.packed_words(k)
    b_ms, b_by = bound_ms(r * k * 4 + r * 4 + n_bits * r * kw * 4, 0,
                          INT8_OPS_PER_S)
    print(f"K3 quantize_pack_rows {r}x{k} w{n_bits}: words equal; "
          f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
          f"{100 * b_ms / ms:.1f}% of bound), plain {plain:.4f} ms",
          flush=True)
    results["quantize_pack_rows"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)


def _k1_case(torch, timer, g, name, m, n, k, *, dual=False, residual=False,
             act="none", w_bits=2, a_bits=8, cache=None):
    from repro_torch.core import bipolar
    from repro_torch.kernels import apmm, ops, ref
    key = (n, k, dual)
    if cache is not None and key in cache:
        w, w2 = cache[key]
    else:
        w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                            w_bits)
        w2 = ops.pack_weight(torch.randn((n, k), generator=g,
                                         device="cuda"), w_bits) \
            if dual else None
        if cache is not None:
            cache[key] = (w, w2)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    res = torch.randn((m, n), generator=g, device="cuda").to(
        torch.bfloat16) if residual else None
    a_s = bipolar.absmax_scale(x, a_bits, axis=-1).float()
    # the integer core of each weight: act=none, f32 out -- bit-exact
    for wt in (w, w2) if dual else (w,):
        core = apmm.apmm_fused_linear(x, a_s, wt, a_bits=a_bits,
                                      out_dtype=torch.float32)
        torch.cuda.synchronize()
        core_ref = ref.ap_linear_fused_ref(x, a_s, wt, a_bits=a_bits,
                                           out_dtype=torch.float32)
        if not torch.equal(core, core_ref):
            raise AssertionError(f"K1 {name}: integer core differs from "
                                 f"plain")
        del core, core_ref

    def run():
        return apmm.apmm_fused_linear(x, a_s, w, w2=w2, residual=res,
                                      a_bits=a_bits, act=act,
                                      out_dtype=torch.bfloat16)

    def run_plain():
        return ref.ap_linear_fused_ref(x, a_s, w, w2=w2, residual=res,
                                       a_bits=a_bits, act=act,
                                       out_dtype=torch.bfloat16)

    got, want = run(), run_plain()
    err = (got.float() - want.float()).abs().max().item()
    ulps = int(bf16_ulps(got, want).max())
    # act=none is bit-exact; SiLU differs only by expf, rounded once to
    # bf16 at the end: at most 1 ulp per element
    if ulps > (0 if act == "none" else 1):
        raise AssertionError(f"K1 {name} act={act}: bf16 output {ulps} "
                             f"ulps from plain (max |err| {err})")
    ms = timer(run, iters=10)
    plain = timer(run_plain, iters=2, warmup=1)
    nw = 2 if dual else 1
    kw = w.packed.shape[-1]
    groups = len(ref.plane_groups(a_bits)) * len(ref.plane_groups(w_bits))
    n_bytes = m * k * 2 + m * 4 + nw * (w_bits * n * kw * 4 + n * 4) \
        + (m * n * 2 if residual else 0) + m * n * 2
    n_ops = nw * groups * 2 * m * n * k
    b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
    # yardsticks (not the same function; the port never calls them)
    wb = torch.randn((nw * n, k), generator=g, device="cuda").to(
        torch.bfloat16)
    mm = timer(lambda: torch.matmul(x, wb.T), iters=10)
    mi = max(m, 32)               # torch._int_mm takes M > 16 on the card
    xi = torch.randint(-127, 128, (mi, k), device="cuda", dtype=torch.int8)
    wi = torch.randint(-127, 128, (nw * n, k), device="cuda",
                       dtype=torch.int8)
    im = timer(lambda: torch._int_mm(xi, wi.t()), iters=10)
    del wb, xi, wi
    print(f"K1 apmm_fused_linear {name} M={m} N={n} K={k}"
          f"{' dual' if dual else ''}{' +res' if residual else ''}"
          f" act={act}: core bit-exact, out max|err| {err:.3g}, {ulps} "
          f"bf16 ulps (tol {0 if act == 'none' else 1}); {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
          f"{100 * b_ms / ms:.1f}% of bound), plain {plain:.4f} ms; "
          f"yardsticks (paper's cuBLAS/CUTLASS class, not the same "
          f"function): torch.matmul bf16 {mm:.4f} ms, torch._int_mm int8 "
          f"M={mi} {im:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def k1_phase(torch, timer, seed, results):
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cache: dict = {}
    cases = [
        ("decode q", 4, 4096, 4096, {}),
        ("decode gate/up", 4, 14336, 4096, dict(dual=True, act="silu")),
        ("decode down", 4, 4096, 14336, dict(residual=True)),
        ("decode lm_head", 4, 128256, 4096, {}),
        ("chunk q", 1024, 4096, 4096, {}),
        ("chunk gate/up", 1024, 14336, 4096, dict(dual=True, act="silu")),
        ("chunk down", 1024, 4096, 14336, dict(residual=True)),
        ("odd", 5, 1000, 1000, {}),
    ]
    for name, m, n, k, kw in cases:
        r = _k1_case(torch, timer, g, name, m, n, k, cache=cache, **kw)
        if name == "decode gate/up":
            results["apmm_fused_linear"] = r
        if name == "decode lm_head":
            cache.pop((n, k, False), None)
    cache.clear()
    torch.cuda.empty_cache()


def _k2_inputs(torch, g, *, b, ctx, s_q, h=8, group=4, d=128, n_bits=8,
               bs=16):
    from repro_torch.kernels import ops
    n_per = -(-ctx // bs)
    nb = 1
    while nb < n_per:
        nb *= 2
    n_blocks = 1 + b * n_per
    dw = d // 32
    k_pool = torch.zeros((n_blocks, bs, h, n_bits, dw), dtype=torch.int32,
                         device="cuda")
    v_pool = torch.zeros_like(k_pool)
    k_sc = torch.zeros((n_blocks, bs, h, 1), device="cuda")
    v_sc = torch.zeros_like(k_sc)
    pos = torch.full((n_blocks, bs), -1, dtype=torch.int32, device="cuda")
    tables = torch.zeros((b, nb), dtype=torch.int32, device="cuda")
    for row in range(b):
        kv = torch.randn((2, n_per * bs, h, d), generator=g,
                         device="cuda").to(torch.bfloat16)
        kq, ks = ops.quantize_kv(kv[0], n_bits)
        vq, vs = ops.quantize_kv(kv[1], n_bits)
        ids = torch.arange(1 + row * n_per, 1 + (row + 1) * n_per,
                           device="cuda")
        tables[row, :n_per] = ids.to(torch.int32)
        k_pool[ids] = kq.reshape(n_per, bs, h, n_bits, dw)
        v_pool[ids] = vq.reshape(n_per, bs, h, n_bits, dw)
        k_sc[ids] = ks.reshape(n_per, bs, h, 1)
        v_sc[ids] = vs.reshape(n_per, bs, h, 1)
        p = torch.arange(n_per * bs, dtype=torch.int32, device="cuda")
        pos[ids] = torch.where(p < ctx, p, -1).reshape(n_per, bs)
    q = torch.randn((b, h, group * s_q, d), generator=g,
                    device="cuda").to(torch.bfloat16)
    qp = torch.arange(ctx - s_q, ctx, dtype=torch.int32, device="cuda")
    q_pos = qp[None, None, :].expand(b, group, s_q).reshape(b, group * s_q)
    return (q, k_pool, k_sc, v_pool, v_sc, pos, tables,
            q_pos.contiguous()), n_per


def k2_phase(torch, timer, seed, results):
    from repro_torch.kernels import flash_attention, ref
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    for name, b, ctx, s_q in (("decode", 4, 600, 1),
                              ("chunk", 1, 600, 256)):
        args, n_per = _k2_inputs(torch, g, b=b, ctx=ctx, s_q=s_q)
        d, h, gq = 128, 8, args[0].shape[2]

        def run():
            return flash_attention.flash_attention_paged_quantized(
                *args, d=d)

        def run_plain():
            return ref.paged_attention(*args, d=d)

        got, want = run(), run_plain()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        ulps = bf16_ulps(got, want)
        # both sides run in f32 and round once to bf16: each element is
        # within 1 ulp, or 1e-5 where f32 sum order shows near zero
        n_bad = int(((ulps > 1) & (diff > 1e-5)).sum())
        if n_bad:
            raise AssertionError(f"K2 {name}: {n_bad} elements beyond 1 "
                                 f"bf16 ulp and 1e-5 (max |err| {err})")
        ms = timer(run, iters=20)
        plain = timer(run_plain, iters=3, warmup=1)
        kv_bytes = b * n_per * 16 * 2116            # planes+scales+pos
        io_bytes = 2 * b * h * gq * d * 2 + b * gq * 4 + args[6].numel() * 4
        q_pos = args[7]
        kpos = torch.arange(ctx, device="cuda")
        pairs = int((kpos[None, None, :] <= q_pos[:, :, None]).sum()) * h
        b_ms, b_by = bound_ms(kv_bytes + io_bytes, 4 * d * pairs,
                              F32_FLOPS_PER_S)
        print(f"K2 paged attention {name} B={b} ctx={ctx} Gq={gq} H={h} "
              f"d={d} kv8 bs=16: max|err| {err:.3g}, max "
              f"{int(ulps.max())} bf16 ulps (tol 1 ulp or 1e-5); "
              f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"{100 * b_ms / ms:.1f}% of bound), plain {plain:.4f} ms",
              flush=True)
        if name == "decode":
            results["paged_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
        del args, got, want
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: full width, depth 2, card vs CPU
# ---------------------------------------------------------------------------

def _to_cpu(tree):
    from repro_torch.core.bipolar import BipolarTensor
    if isinstance(tree, BipolarTensor):
        return tree.to("cpu")
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def shallow_phase(torch, seed):
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import QuantConfig
    from repro_torch.serving import engine as E
    from repro_torch.serving.paged_cache import PagedKVPool
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    quant = QuantConfig(w_bits=2, a_bits=8, kv_bits=8)
    params = M.init_params(cfg, seed=seed, device="cuda", quant=quant)
    rng = np.random.default_rng(seed)
    s = 24
    toks = rng.integers(0, cfg.vocab, (1, s), dtype=np.int32)
    batch_np = dict(tokens=toks, positions=np.arange(s, dtype=np.int32)[None],
                    last_idx=np.array([s - 1], np.int32))
    tables, lens = np.array([[1, 2]], np.int32), np.zeros(1, np.int32)
    out = {}
    for dev, p in (("cuda", params), ("cpu", None)):
        if p is None:
            p = _to_cpu(params)
            del params
            torch.cuda.empty_cache()
        pool = PagedKVPool(cfg, 3, 16, quant=quant, device=dev)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch_np.items()}
        t0 = time.time()
        logits, _ = E.prefill_step_bucketed(
            p, batch, pool.step_caches(tables, lens), cfg, quant)
        out[dev] = logits.float().cpu()
        print(f"full width depth 2: forward on {dev} in "
              f"{time.time() - t0:.2f} s", flush=True)
        del p, pool
    a, b = out["cuda"], out["cpu"]
    if not (torch.isfinite(a).all() and a.shape == (1, cfg.vocab_padded)):
        raise AssertionError("card logits not finite / wrong shape")
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    if err > 0.05 * scale:
        raise AssertionError(f"card vs CPU logits: max|err| {err} > "
                             f"5% of {scale}")
    print(f"full width depth 2 (d_model 4096, vocab {cfg.vocab}): card vs "
          f"CPU logits max|err| {err:.4g} (tol 5% of max|logit| {scale:.4g}"
          f"), argmax card {int(a.argmax())} cpu {int(b.argmax())}",
          flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: end to end
# ---------------------------------------------------------------------------

def profile_steps(torch, eng, n_steps: int) -> str:
    """``torch.profiler`` over ``n_steps`` engine steps: device time by
    kernel name and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    rows = []
    busy = 0.0
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev, ev.count, ev.key))
            busy += dev
    rows.sort(reverse=True)
    print(f"profile of {n_steps} decode steps: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, "
          f"idle {100 - 100 * busy / wall_us:.1f}%)", flush=True)
    for dev, cnt, key in rows[:12]:
        print(f"  {dev / 1e3:9.3f} ms  {cnt:6d} x  {key[:90]}", flush=True)
    return prof


def e2e_phase(torch, seed):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import apmm, flash_attention, pack
    from repro_torch.models import model as M
    from repro_torch.models.config import QuantConfig
    from repro_torch.serving import engine as E
    cfg = get_config("llama3-8b")
    quant = QuantConfig(w_bits=2, a_bits=8, kv_bits=8)
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: counters zeroed just before, read just after ---
    pack.LAUNCHES = apmm.LAUNCHES = flash_attention.LAUNCHES = 0
    t0 = time.time()
    params = M.init_params(cfg, seed=seed, device="cuda", quant=quant)
    torch.cuda.synchronize()
    t_load = time.time() - t0
    eng = E.Engine(params, cfg, n_slots=4, max_len=1024, quant=quant,
                   paged=True, block_size=16, n_blocks=257,
                   chunk_tokens=256)
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, (128,), dtype=np.int32)

    def prompt(n, prefix=False):
        body = rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
        return np.concatenate([shared, body[128:]]) if prefix else body

    first = [E.Request(prompt=prompt(600, prefix=True), max_new_tokens=32),
             E.Request(prompt=prompt(100), max_new_tokens=32),
             E.Request(prompt=prompt(300), max_new_tokens=32)]
    late = E.Request(prompt=prompt(200, prefix=True), max_new_tokens=32)
    reqs = first + [late]
    for r in first:
        eng.submit(r)
    step_ms = {"prefill": [], "decode": []}
    prof, t_prof, tok_prof = None, 0.0, 0
    t_serve = time.time()
    while eng._has_work() or not late.done:
        if first[0].out and getattr(late, "_engine", None) is None:
            eng.submit(late)          # after the shared prefix is indexed
        kind = "prefill" if (eng.scheduler.waiting or any(
            s.prefilling for s in eng.scheduler.running)) else "decode"
        # trace three decode steps in the middle of the run (their times
        # are left out of the step statistics)
        traced = kind == "decode" and prof is None \
            and len(step_ms["decode"]) == 8
        if traced:
            n0, tp = sum(len(r.out) for r in reqs), time.time()
            prof = profile_steps(torch, eng, 3)
            t_prof = time.time() - tp
            tok_prof = sum(len(r.out) for r in reqs) - n0
            continue
        ts = time.time()
        if not eng.step():
            break
        torch.cuda.synchronize()
        step_ms[kind].append((time.time() - ts) * 1e3)
    t_serve = time.time() - t_serve - t_prof     # traced steps left out
    counts = {"quantize_pack_rows": pack.LAUNCHES,
              "apmm_fused_linear": apmm.LAUNCHES,
              "paged_attention": flash_attention.LAUNCHES}
    # --- end of the main path ---
    rep = eng.report()
    for r in reqs:
        if r.finish_reason != "length" or len(r.out) != 32:
            raise AssertionError(f"request finished {r.finish_reason!r} "
                                 f"with {len(r.out)} tokens")
        if not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError("token outside the vocab")
    if rep["free_blocks"] != rep["n_usable"] or rep["used_blocks"]:
        raise AssertionError(f"pool did not drain: {rep}")
    eng.pool.validate(check_contents=True)
    if rep["prefix_hits"] < 1:
        raise AssertionError("the shared 128-token prefix never hit")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    n_tok = sum(len(r.out) for r in reqs) - tok_prof
    pre, dec = step_ms["prefill"], step_ms["decode"]
    print(f"end to end llama3-8b 32L w2/a8/kv8 paged bs=16 chunk=256: "
          f"load+quantize {t_load:.2f} s; {len(reqs)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}, prefix hit tokens "
          f"{rep['prefix_hit_tokens']}), {n_tok} tokens outside the traced "
          f"steps in {t_serve:.2f} s "
          f"= {n_tok / t_serve:.2f} tok/s; {len(pre)} prefill steps "
          f"mean {np.mean(pre):.1f} ms, {len(dec)} decode steps mean "
          f"{np.mean(dec):.1f} ms (median {np.median(dec):.1f} ms); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        return fail("src/repro_torch is missing: run from the repository")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, SRC)
    t_start = time.time()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    from repro_torch.kernels import _build
    t0 = time.time()
    _build.build_all()
    for src, rep in sorted(_build.ptxas_reports.items()):
        lines = [ln.split("ptxas info    : ")[-1] for ln in rep.splitlines()
                 if "registers" in ln]
        print(f"build {src}: {'; '.join(sorted(set(lines)))}", flush=True)
    print(f"build: {len(_build.sources())} sources in "
          f"{time.time() - t0:.1f} s", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(torch)
    results: dict = {}
    k3_phase(torch, timer, args.seed, results)
    k1_phase(torch, timer, args.seed, results)
    k2_phase(torch, timer, args.seed, results)
    del timer
    torch.cuda.empty_cache()
    shallow_phase(torch, args.seed)
    counts = e2e_phase(torch, args.seed)

    print("kernels: " + ", ".join(f"{k}={v}" for k, v in counts.items()),
          flush=True)
    meta = {
        "quantize_pack_rows": ("src/repro_torch/csrc/pack.cu",
                               "src/repro/kernels/pack.py:69"),
        "apmm_fused_linear": ("src/repro_torch/csrc/apmm_fused_linear.cu",
                              "src/repro/kernels/apmm.py:355"),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/flash_attention.py:400"),
    }
    kernels = []
    for k, (source, replaces) in meta.items():
        r = results[k]
        kernels.append(dict(name=k, route="cuda", source=source,
                            replaces=replaces, launches=counts[k],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
