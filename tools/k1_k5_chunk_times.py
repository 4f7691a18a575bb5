"""K1's and fused K5's chunk cases of ``chip_smoke.py``'s phase 3 through
one checkout's port, on the card: times and digests of the outputs; or
the comparison of two such runs.

    python3 tools/k1_k5_chunk_times.py [--root DIR] --out FILE.json
    python3 tools/k1_k5_chunk_times.py --compare A.json B.json

``DIR`` (default: this checkout) is the checkout whose ``src/repro_torch``
is built and timed: this one, or another commit of this repository
unpacked (``git archive <commit> | tar -x -C build/parent``).  The cases
are this checkout's (``chip_smoke.K1_CASES`` above K1's small-M route of
this checkout, 64 rows, and ``chip_smoke.K5_CASES``' chunk cases), each
made from ``--seed`` and its index by phase 3's builders, so two
checkouts run the same work on the same inputs.  Each case: the median
CUDA-event time of ``chip_smoke.Timer`` at bf16 out (L2 flushed before
each launch), the device time of the kernels the call launched
(``chip_smoke.device_split``, the profiler) and their names, and the
SHA-1 of the integer core's output (K1: f32 out, act none; K5: the raw
int32 product) and of the timed call's output.  To compare two
checkouts, run both in one chip call in turns (other, this, this,
other); ``--compare`` prints, per case, whether the two runs' outputs are
equal bit for bit and the first run's time over the second's.  Timing
needs one CUDA card and ``nvcc``; comparing needs neither.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHUNK_M = 64          # K1's cases above this M (its small-M route's, PR 15)


def _sha(t) -> str:
    """SHA-1 of a tensor's bytes."""
    import torch
    return hashlib.sha1(t.contiguous().view(-1).view(torch.uint8).cpu()
                        .numpy().tobytes()).hexdigest()


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    print(f"A {a['root']} ({a['device']}); B {b['root']} ({b['device']})")
    bad = 0
    for key, ra in a["cases"].items():
        rb = b["cases"].get(key)
        if rb is None:
            print(f"{key}: not in B")
            continue
        same = (ra["core_sha"], ra["out_sha"]) == (rb["core_sha"],
                                                   rb["out_sha"])
        bad += not same
        print(f"{key}: {'equal' if same else 'DIFFERS'}; A {ra['ms']:.4f} "
              f"ms (device {ra['device_ms']:.4f}), B {rb['ms']:.4f} ms "
              f"(device {rb['device_ms']:.4f}): A / B "
              f"{ra['ms'] / rb['ms']:.2f}x")
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not args.out:
        ap.error("--out or --compare")
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import bipolar
    from repro_torch.kernels import apmm, ops
    print(cs.smi_line(), flush=True)
    print(f"timing {os.path.dirname(apmm.__file__)}", flush=True)
    timer = cs.Timer(torch)
    cases = {}

    def record(key, core, fn):
        out = fn()
        torch.cuda.synchronize()
        ms = timer(fn, iters=10)
        split = cs.device_split(torch, timer, fn)
        cases[key] = dict(ms=ms, device_ms=sum(split.values()),
                          kernels=cs.kernel_names(split),
                          core_sha=_sha(core), out_sha=_sha(out))
        print(f"{key}: {ms:.4f} ms, device {cases[key]['device_ms']:.4f} ms "
              f"({cs.split_line(split)}); core {cases[key]['core_sha'][:12]}"
              f", out {cases[key]['out_sha'][:12]}", flush=True)

    for i, (name, m, n, k, kw) in enumerate(cs.K1_CASES):
        if m <= CHUNK_M:
            continue
        g = torch.Generator(device="cuda").manual_seed(args.seed * 100 + i)
        w_bits, a_bits = kw.get("w_bits", 2), kw.get("a_bits", 8)
        w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                            w_bits)
        w2 = ops.pack_weight(torch.randn((n, k), generator=g,
                                         device="cuda"), w_bits) \
            if kw.get("dual") else None
        x = torch.randn((m, k), generator=g, device="cuda").to(
            torch.bfloat16)
        res = torch.randn((m, n), generator=g, device="cuda").to(
            torch.bfloat16) if kw.get("residual") else None
        a_s = bipolar.absmax_scale(x, a_bits, axis=-1).float()
        core = apmm.apmm_fused_linear(x, a_s, w, a_bits=a_bits,
                                      out_dtype=torch.float32)
        record(f"K1 {name}", core, lambda: apmm.apmm_fused_linear(
            x, a_s, w, w2=w2, residual=res, a_bits=a_bits,
            act=kw.get("act", "none"), out_dtype=torch.bfloat16))
        del w, w2, x, res, core
        torch.cuda.empty_cache()
    for i, (name, m, n, k, kw) in enumerate(cs.K5_CASES):
        if not name.startswith("chunk"):
            continue
        g = torch.Generator(device="cuda").manual_seed(args.seed * 100 + 50
                                                       + i)
        _, a, w = cs._k5_operands(torch, g, m, n, k, **kw)
        core = apmm.apmm_packed(a, w)
        record(f"K5 {name}", core, lambda: apmm.apmm_packed(
            a, w, out_dtype=torch.bfloat16))
        del a, w, core
        torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        json.dump({"root": root, "device": cs.smi_line(), "cases": cases},
                  f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
