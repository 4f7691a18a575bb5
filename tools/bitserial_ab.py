"""The bitserial kernels of this checkout against another checkout's, on
the card, in one process.

    python3 tools/bitserial_ab.py OTHER_DIR [--rounds N]

``OTHER_DIR`` is another commit of this repository, unpacked (for
example ``git archive <commit> | tar -x -C build/other``).  The script
builds that checkout's K1 and K5 sources (``apmm_fused_linear.cu``,
``apmm_packed.cu``: their C entries must take the same arguments in
both commits -- K5's took its small-M workspace pointer with its small-M
route, so an older checkout's K5 does not match) with this checkout's
nvcc flags into ``build/kernels/ab/``, then times each case through this checkout's wrappers on both libraries
in turns -- other, this, this, other, ``--rounds`` times -- with the L2
flushed before each launch (``chip_smoke.Timer``), checks that both give
the same bits, and prints each side's median and one JSON line.  Cases:
llama3-8b's decode linears at M = 4 (w2 a8), bitserial.  Run it from the
repository root on a machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# (kernel, case, N, K, dual)
CASES = (("K1-bs", "decode gate/up", 14336, 4096, True),
         ("K1-bs", "decode lm_head", 128256, 4096, False),
         ("K5-bs", "decode q", 4096, 4096, False),
         ("K5-bs", "decode gate", 14336, 4096, False),
         ("K5-bs", "decode down", 4096, 14336, False),
         ("K5-bs", "decode lm_head", 128256, 4096, False))
ENTRIES = {"apmm_fused_linear": ("repro_apmm_fused_linear", 10, 10),
           "apmm_packed": ("repro_apmm_packed", 6, 8)}


def build(other: str):
    """The other checkout's K1 and K5 libraries: name -> ctypes entry."""
    from repro_torch.kernels import _build
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(other, "src", "repro_torch", "csrc")
    procs = {}
    for name in ENTRIES:
        so = os.path.join(out_dir, f"{name}.so")
        flags = _build.NVCC_FLAGS + _build.EXTRA_FLAGS[name]
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *flags, "-o", so,
             os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}:\n{out}")
        entry, n_ptr, n_int = ENTRIES[name]
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import Timer, smi_line
    from repro_torch.core import bipolar
    from repro_torch.kernels import apmm, ops
    other = build(os.path.abspath(args.other))
    mine = {"apmm_fused_linear": apmm._lib(),
            "apmm_packed": apmm._packed_lib()}
    print(smi_line(), flush=True)
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kernel, case, n, k, dual in CASES:
        w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                            2)
        w2 = ops.pack_weight(torch.randn((n, k), generator=g,
                                         device="cuda"), 2) if dual else None
        x = torch.randn((4, k), generator=g, device="cuda").to(
            torch.bfloat16)
        if kernel == "K1-bs":
            a_s = bipolar.absmax_scale(x, 8, axis=-1).float()

            def run():
                return apmm.apmm_fused_linear(
                    x, a_s, w, w2=w2, a_bits=8, variant="bitserial",
                    act="silu" if dual else "none",
                    out_dtype=torch.bfloat16)
            lib = "apmm_fused_linear"
        else:
            a, wk = ops._normalize_packed_kw(
                ops.quantize_rows(x, 8, pad_bit=0), w)

            def run():
                return apmm.apmm_packed(a, wk, variant="bitserial",
                                        out_dtype=torch.bfloat16)
            lib = "apmm_packed"

        def use(fns):
            apmm._lib = lambda f=fns["apmm_fused_linear"]: f
            apmm._packed_lib = lambda f=fns["apmm_packed"]: f

        times = {"other": [], "this": []}
        outs = {}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                use(other if side == "other" else mine)
                outs[side] = run()
                times[side].append(timer(run, iters=20))
        if not torch.equal(outs["other"], outs["this"]):
            raise AssertionError(f"{kernel} {case}: the checkouts differ")
        row = dict(kernel=kernel, case=case, lib=lib,
                   other_ms=statistics.median(times["other"]),
                   this_ms=statistics.median(times["this"]),
                   other_all=times["other"], this_all=times["this"])
        rows.append(row)
        print(f"{kernel} {case} N={n} K={k}: other {row['other_ms']:.4f} ms, "
              f"this {row['this_ms']:.4f} ms (medians of "
              f"{len(times['this'])} turns each; same bits)", flush=True)
        use(mine)
        del w, w2
    print(json.dumps({"bitserial_ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
