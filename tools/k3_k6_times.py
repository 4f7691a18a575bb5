"""K3's and K6's times at ``chip_smoke.py``'s phase-3 cases, through one
checkout's port, on the card.

    python3 tools/k3_k6_times.py [--root DIR] [--seed N]

``DIR`` (default: this checkout) is the checkout whose ``src/repro_torch``
is built and timed: this one, or another commit of this repository
unpacked (``git archive <commit> | tar -x -C build/parent``).  The cases
and their inputs are this checkout's (``chip_smoke.K3_CASES`` and
``K6_CASES``, made from ``--seed`` as phase 3 makes them), so a run per
checkout times the same work; to compare two, run both in one chip call
in turns (other, this, this, other).  Each case: the median CUDA-event
time of ``chip_smoke.Timer`` (L2 flushed before each launch), the device
time of the kernels the call launched (``chip_smoke.device_split``), and
a SHA-256 digest of the output's bytes, so that two checkouts' outputs
can be seen to be equal bit for bit (K3's words always; K6's where both
sum in one order, as at the unsplit prefill).  Prints the card, one line
per case and one JSON line.  Run it from the repository root on a
machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def digest(t) -> str:
    import torch
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


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
    from repro_torch.core import bipolar
    from repro_torch.kernels import flash_attention, pack
    print(cs.smi_line(), flush=True)
    print(f"timing {os.path.dirname(pack.__file__)}", flush=True)
    timer = cs.Timer(torch)
    ms, dev, dig = {}, {}, {}

    def time_case(key, fn, iters):
        dig[key] = digest(fn())
        ms[key] = timer(fn, iters=iters)
        split = cs.device_split(torch, timer, fn)
        dev[key] = sum(split.values())
        print(f"{key}: {ms[key]:.4f} ms, device {dev[key]:.4f} ms ("
              f"{cs.split_line(split)}), output {dig[key]}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    for name, r, k, n_bits, pad_bit in cs.K3_CASES:
        x = torch.randn((r, k), generator=g, device="cuda")
        scale = bipolar.absmax_scale(x, n_bits, axis=-1)
        time_case(f"K3 {name}", lambda: pack.quantize_pack_rows(
            x, scale, n_bits=n_bits, pad_bit=pad_bit), 20)
        del x
    g = torch.Generator(device="cuda").manual_seed(args.seed + 5)
    for name, ring, window in cs.K6_CASES:
        q, _, planes, pos, q_pos = cs._ring_case(torch, g, h=8, d=128,
                                                 n_bits=8, **ring)
        if name == "decode":
            q_pos = q_pos.clone()
            q_pos[3, 0] = -1                  # phase 3's fully masked row
        a = (q, *planes, q_pos, pos)
        time_case(f"K6 {name}",
                  lambda: flash_attention.flash_attention_quantized(
                      *a, d=128, window=window), 20)
        del q, planes, a
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "device": cs.smi_line(), "ms": ms,
                      "device_ms": dev, "digest": dig}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
