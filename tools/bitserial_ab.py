"""The bitserial kernels of this checkout against another checkout's, on
the card, in one process.

    python3 tools/bitserial_ab.py OTHER_DIR [--rounds N] [--kernel K5-bs]

``OTHER_DIR`` is another commit of this repository, unpacked (for
example ``git archive <commit> | tar -x -C build/other``).  The script
builds that checkout's K1 and K5 sources (``apmm_fused_linear.cu``,
``apmm_packed.cu``: their C entries must take the same arguments in
both commits -- K5's took its small-M workspace pointer with its small-M
route, so an older checkout's K5 does not match) with this checkout's
nvcc flags into ``build/kernels/ab/``, then times each case through this
checkout's wrappers on both libraries in turns -- other, this, this,
other, ``--rounds`` times -- with the L2 flushed before each launch
(``chip_smoke.Timer``), checks that both give the same bits, and prints
each side's median and one JSON line.  Cases: K1-bs at llama3-8b's
decode gate/up and lm_head (M = 4, w2 a8); K5-bs at every phase-3 K5
case of ``chip_smoke.py`` (``K5_CASES``: llama3-8b's decode and chunk
linears and the odd width pairs) and at its route edges, the decode
gate's shape at M = this checkout's ``packed_bitserial_stack_max()`` and
one more.  ``--kernel`` keeps one kernel's cases.  Run it from the
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

# K1-bs's cases: (case, N, K, dual), at M = 4
K1_CASES = (("decode gate/up", 14336, 4096, True),
            ("decode lm_head", 128256, 4096, False))
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


def k5_cases(stack_max: int):
    """K5-bs's cases: chip_smoke's phase-3 ``K5_CASES`` and the two route
    edges, as (case, M, N, K, options of ``chip_smoke._k5_operands``)."""
    from chip_smoke import K5_CASES
    return list(K5_CASES) + [
        ("stack edge gate", stack_max, 14336, 4096, {}),
        ("rows edge gate", stack_max + 1, 14336, 4096, {})]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernel", choices=("K1-bs", "K5-bs"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import Timer, _k5_operands, smi_line
    from repro_torch.core import bipolar
    from repro_torch.kernels import apmm, ops
    other = build(os.path.abspath(args.other))
    mine = {"apmm_fused_linear": apmm._lib(),
            "apmm_packed": apmm._packed_lib()}
    print(smi_line(), flush=True)
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    if args.kernel in (None, "K1-bs"):
        cases += [("K1-bs", case, 4, n, k, dict(dual=dual))
                  for case, n, k, dual in K1_CASES]
    if args.kernel in (None, "K5-bs"):
        cases += [("K5-bs", *c)
                  for c in k5_cases(apmm.packed_bitserial_stack_max())]
    rows = []
    for kernel, case, m, n, k, opts in cases:
        if kernel == "K1-bs":
            dual = opts["dual"]
            w = ops.pack_weight(torch.randn((n, k), generator=g,
                                            device="cuda"), 2)
            w2 = ops.pack_weight(torch.randn((n, k), generator=g,
                                             device="cuda"), 2) \
                if dual else None
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            a_s = bipolar.absmax_scale(x, 8, axis=-1).float()

            def run():
                return apmm.apmm_fused_linear(
                    x, a_s, w, w2=w2, a_bits=8, variant="bitserial",
                    act="silu" if dual else "none",
                    out_dtype=torch.bfloat16)
            lib = "apmm_fused_linear"
        else:
            _, a, wk = _k5_operands(torch, g, m, n, k, **opts)

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
        row = dict(kernel=kernel, case=case, lib=lib, m=m, n=n, k=k,
                   other_ms=statistics.median(times["other"]),
                   this_ms=statistics.median(times["this"]),
                   other_all=times["other"], this_all=times["this"])
        rows.append(row)
        print(f"{kernel} {case} M={m} N={n} K={k}: other "
              f"{row['other_ms']:.4f} ms, this {row['this_ms']:.4f} ms "
              f"(medians of {len(times['this'])} turns each; same bits)",
              flush=True)
        use(mine)
        if kernel == "K1-bs":
            del w, w2
        else:
            del a, wk
        torch.cuda.empty_cache()
    print(json.dumps({"bitserial_ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
