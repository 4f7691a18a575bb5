"""K2's and fused K5's times at ``chip_smoke.py``'s phase-3 cases, through
one checkout's port, on the card.

    python3 tools/k2_k5_times.py [--root DIR]

``DIR`` (default: this checkout) is the checkout whose ``src/repro_torch``
is built and timed: this one, or another commit of this repository
unpacked (``git archive <commit> | tar -x -C build/parent``).  The cases
and their inputs are this checkout's (``chip_smoke.K2_CASES`` and
``K5_CASES``, made by phase 3's builders from ``--seed``), so a run per
checkout times the same work; to compare two, run both in one
chip call in turns (other, this, this, other).  Each case: the median
CUDA-event time of ``chip_smoke.Timer`` (L2 flushed before each launch;
it takes in the wrapper's host time, which a short kernel does not
hide), and the device time of the kernels the call launched
(``chip_smoke.device_split``, the profiler), K5 at bf16 out as phase 3
times it.  Prints the card, one line per case and one JSON line.  Run it from the repository root on a machine with one
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import apmm, flash_attention
    print(cs.smi_line(), flush=True)
    print(f"timing {os.path.dirname(apmm.__file__)}", flush=True)
    timer = cs.Timer(torch)
    ms, dev = {}, {}

    def time_case(key, fn, iters):
        ms[key] = timer(fn, iters=iters)
        split = cs.device_split(torch, timer, fn)
        dev[key] = sum(split.values())
        print(f"{key}: {ms[key]:.4f} ms, device {dev[key]:.4f} ms ("
              f"{cs.split_line(split)})", flush=True)

    g = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    for name, lanes, s_q, nb, window, (h, group, d) in cs.K2_CASES:
        a = cs._k2_inputs(torch, g, lanes, s_q=s_q, nb=nb, window=window,
                          h=h, group=group, d=d)
        time_case(f"K2 {name}",
                  lambda: flash_attention.flash_attention_paged_quantized(
                      *a, d=d, window=window), 20)
        del a
    g = torch.Generator(device="cuda").manual_seed(args.seed + 4)
    for name, m, n, k, kw in cs.K5_CASES:
        _, a, w = cs._k5_operands(torch, g, m, n, k, **kw)
        time_case(f"K5 {name}",
                  lambda: apmm.apmm_packed(a, w, out_dtype=torch.bfloat16),
                  10)
        del a, w
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "device": cs.smi_line(), "ms": ms,
                      "device_ms": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
