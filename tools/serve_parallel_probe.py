"""The card checks that ``chip_smoke.py`` adds for the sharded serve
step, run alone after the kernels' build: K2's, K6's and K7's phase-3
cases (their C entries gained K6's lse output pointer), K6's lse route
(``chip_smoke.k6_lse_phase``), the row product's card route at
llama3-8b's ``w_down`` shape (``row_product_phase``) and the sharded
serve step at world size 1 over NCCL (``serve_dist_phase``).

It prints the card's name and power limit first and one JSON line last.
Run it from the repository root on a machine with one CUDA card::

    python3 tools/serve_parallel_probe.py
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
    from repro_torch.kernels import _build
    print(C.smi_line(), flush=True)
    t0 = time.time()
    _build.build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    timer = C.Timer(torch)
    results: dict = {}
    C.k2_phase(torch, timer, args.seed, results)
    C.k6_k7_phase(torch, timer, args.seed, results)
    C.k6_lse_phase(torch, timer, args.seed, results)
    C.row_product_phase(torch, timer, args.seed)
    del timer
    torch.cuda.empty_cache()
    launched = C.serve_dist_phase(torch, args.seed)
    lse = results["flash_attention_quantized", "decode lse"]
    print(C.smi_line(), flush=True)
    print(json.dumps({"ok": True, "seconds": round(time.time() - t0, 1),
                      "k6_lse": lse, "sharded_serve_launches": launched}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
