"""The greedy tokens of ``chip_smoke.py``'s llama3-8b paged fused and
contiguous unfused paths, through one checkout's port, on the card; or
the first index where two such runs differ.

    python3 tools/phase5_tokens.py [--root DIR] --out FILE.json
    python3 tools/phase5_tokens.py --compare A.json B.json

``DIR`` (default: this checkout) is the checkout whose ``src/repro_torch``
serves; the paths, prompts and seed are this checkout's phase 5
(``chip_smoke.serve_phase`` and ``serve_contiguous_phase``, 32 layers,
random weights from ``--seed``), so two runs serve the same requests.
``--out`` writes ``{"paged": [...], "contiguous": [...]}``, one token
list per request.  ``--compare`` prints, per path and request, "equal"
or the first index where the two runs' tokens differ.  Serving needs one
CUDA card and ``nvcc``; comparing needs neither.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    for path in ("paged", "contiguous"):
        for i, (x, y) in enumerate(zip(a[path], b[path])):
            first = next((j for j, (u, v) in enumerate(zip(x, y))
                          if u != v), None)
            print(f"{path} request {i}: " + ("equal" if x == y else
                  f"first differs at token {first} of {len(x)}"))
    return 0


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
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention
    if not hasattr(flash_attention, "quantized_splits"):
        # a checkout from before K6's split plan: no ranges to print
        cs._k6_step_shapes = lambda *a, **kw: None
    print(cs.smi_line(), flush=True)
    _, paged, _ = cs.serve_phase(
        torch, args.seed, "llama3-8b",
        per_dispatch={"apmm_fused_linear": 193, "paged_attention": 32},
        prompt_lens=(600, 100, 300), prefix=128, max_len=1024,
        n_blocks=257, n_pack=225)
    _, contiguous = cs.serve_contiguous_phase(
        torch, args.seed, n_layers=32, n_pack=225,
        per_dispatch={"apmm_packed": 225, "flash_attention_quantized": 32,
                      "quantize_pack_rows": 225})
    with open(args.out, "w") as f:
        json.dump({"paged": paged, "contiguous": contiguous}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
