"""The card checks that ``chip_smoke.py`` adds for nested-precision
serving, run alone after the kernels' build: K5-bs's decode gate case
(its ``device_split`` with the Timer's flush left out), K3's nested
load case, K1 and K1-bs on a w8 checkpoint's views at 8, 4 and 2 bits
(``k1_nested_phase``), the card against the CPU at ``nested_bits`` 8, 4
and 2 (``shallow_phase``), and the llama3-8b-nested path and its
bit-serial twin (``serve_phase`` with ``NESTED_PATH``).

It prints the card's name and power limit first and one JSON line last.
Run it from the repository root on a machine with one CUDA card::

    python3 tools/nested_probe.py
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
    g = torch.Generator(device="cuda").manual_seed(args.seed + 4)
    C._k5_case(torch, timer, g, "decode gate", 4, 14336, 4096)
    C.K3_CASES = [c for c in C.K3_CASES if c[0] == "nested load"]
    C.k3_phase(torch, timer, args.seed, results)
    C.k1_nested_phase(torch, timer, args.seed, results)
    del timer
    torch.cuda.empty_cache()
    t1 = time.time()
    C.shallow_phase(torch, args.seed, "llama3-8b", n_layers=2, s=24,
                    w_bits=8, nested=C.NESTED_BITS)
    print(f"shallow nested: {time.time() - t1:.1f} s", flush=True)
    t1 = time.time()
    path = dict(C.NESTED_PATH)
    counts, tokens, params = C.serve_phase(torch, args.seed, "llama3-8b",
                                           **path)
    twin = {k + "_bitserial" if k in C.GEMMS else k: v
            for k, v in path.pop("per_dispatch").items()}
    twin, _, _ = C.serve_phase(torch, args.seed, "llama3-8b",
                               variant="bitserial", params=params,
                               twin_tokens=tokens, per_dispatch=twin,
                               **dict(path, n_pack=0))
    print(f"nested pair: {time.time() - t1:.1f} s", flush=True)
    print(f"events the profiler lost: {C.PROFILER_DROPS}", flush=True)
    print(C.smi_line(), flush=True)
    print(json.dumps({"ok": True, "seconds": round(time.time() - t0, 1),
                      "launches": counts, "twin_launches": twin}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
