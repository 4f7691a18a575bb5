"""The card checks that ``chip_smoke.py``'s phases 6 and 7 add for the
VLM, the enc-dec model and the distributed layer, run alone: the probe
that ``chip_smoke.FAMILY_*_TOL`` are set from, and a quick way to run
those phases without the kernels' build and the serving paths.

For qwen2-vl-7b and seamless-m4t-medium (``chip_smoke.FAMILY_TRAIN``):
one gradient step at 2 layers (seamless: 2 + 2) on the card against the
CPU from the same parameters and ``make_batch`` batch, with a
bf16-logsumexp control (``chip_smoke.family_gaps``, bars not held), then
the few training steps at the phase's depth (``family_train``); then the
world-size-1 NCCL phase (``chip_smoke.dist_phase``).

It prints the card's name and power limit first and one JSON line last.
Run it from the repository root on a machine with one CUDA card::

    python3 tools/train_dist_probe.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as C
    print(C.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"gaps": {}, "train": {}}
    t_start = time.time()
    for arch in C.FAMILY_TRAIN:
        t0 = time.time()
        out["gaps"][arch] = C.family_gaps(torch, args.seed, arch, bars=False)
        out["train"][arch] = C.family_train(torch, args.seed, arch)
        print(f"{arch} took {time.time() - t0:.1f} s", flush=True)
    out["dist_seconds"] = C.dist_phase(torch, args.seed)
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"train_dist_probe": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
