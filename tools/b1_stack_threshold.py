"""Where the bit-serial core's stacked route stops beating its rows route,
on the card.

The bitserial variants of K1 (``src/repro_torch/csrc/apmm_fused_linear.cu``),
K4 (``moe_expert_linear.cu``) and K5 (``apmm_packed.cu``) send every M
(K4: every segment height) up to ``STACK_MAX`` to the b1 core's stacked
route -- the (activation plane, row) pairs stacked into the MMA's 16 rows
-- and every larger one to its rows route (64 x 64 tiles, diagonal
chaining).  This script builds two copies of each source, one with the
threshold at 0 (every shape on the rows route) and one at 256 (every
shape measured here on the stacked route), times both through the port's
own wrappers at llama3-8b's linears (K1, M rows; K5 on K3-packed
activations: q, gate, down and lm_head) and mixtral-8x7b's expert linears
(K4: 8 experts, 1 dispatch group, ``seg`` rows each, every row live), w2
a8, L2 flushed before each launch as ``chip_smoke.py`` times, checks that
the routes give the same bits, and prints for each shape the times and
the fastest route, then one JSON line.  K5 also times a third copy whose
rows route runs the 16 x 64 tile (``ROWS_WM = ROWS_NJ = 1``) that K5 ran
up to M = 32 before its stacked route.  Run it from the repository root
on a machine with one CUDA card and ``nvcc``::

    python3 tools/b1_stack_threshold.py                # K1 and K4
    python3 tools/b1_stack_threshold.py --kernel K5
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

ROWS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64)
STACKED = 256         # the threshold of the all-stacked copy
# llama3-8b linears (name, N, K, dual gate/up) and mixtral-8x7b experts
K1_SHAPES = (("q", 4096, 4096, False), ("gate/up", 14336, 4096, True),
             ("down", 4096, 14336, False), ("lm_head", 128256, 4096, False))
K4_SHAPES = (("gate/up", 14336, 4096, True), ("down", 4096, 14336, False))
K5_SHAPES = (("q", 4096, 4096), ("gate", 14336, 4096), ("down", 4096, 14336),
             ("lm_head", 128256, 4096))
LIBS = {"K1": ("apmm_fused_linear", "repro_apmm_fused_linear", 10, 10),
        "K4": ("moe_expert_linear", "repro_moe_expert_linear", 10, 15),
        "K5": ("apmm_packed", "repro_apmm_packed", 6, 8)}
# the copies built of each source: route -> (STACK_MAX, 16 x 64 rows tile)
COPIES = {"rows": (0, False), "stacked": (STACKED, False)}
K5_COPIES = dict(COPIES, tile16=(0, True))


def build_variant(name: str, threshold: int, tile16: bool = False):
    """``csrc/<name>.cu`` with ``STACK_MAX`` set to ``threshold`` (and,
    with ``tile16``, K5's rows route on the 16 x 64 tile), built with the
    port's own flags under ``build/kernels/stack_threshold/``."""
    from repro_torch.kernels import _build
    with open(os.path.join(_build._CSRC, f"{name}.cu")) as f:
        src, n = re.subn(r"constexpr int STACK_MAX = \d+;",
                         f"constexpr int STACK_MAX = {threshold};", f.read())
    if n != 1:
        raise RuntimeError(f"STACK_MAX not found in {name}.cu")
    if tile16:
        src, n = re.subn(r"constexpr int ROWS_WM = \d+, ROWS_NJ = \d+;",
                         "constexpr int ROWS_WM = 1, ROWS_NJ = 1;", src)
        if n != 1:
            raise RuntimeError(f"ROWS_WM not found in {name}.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "stack_threshold")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{name}_{threshold}{'_t16' * tile16}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    flags = _build.NVCC_FLAGS + _build.EXTRA_FLAGS[name]
    return subprocess.Popen([_build._nvcc(), *flags, "-I", _build._CSRC,
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def load(so: str, kernel: str):
    _, entry, n_ptr, n_int = LIBS[kernel]
    fn = getattr(ctypes.CDLL(so), entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def crossover(rows, key, heights):
    """The largest row count up to which the stacked route beats the rows
    route at every shape."""
    cross = 0
    for m in heights:
        if all(r["stacked_ms"] < r["rows_ms"] for r in rows if r[key] == m):
            cross = m
        else:
            break
    return cross


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", action="append", choices=sorted(LIBS),
                    help="the kernels to sweep (repeatable; default K1 "
                         "and K4)")
    ap.add_argument("--rows", type=int, nargs="+", default=ROWS,
                    help=f"the row counts (K4: segment heights) to time "
                         f"(default {' '.join(map(str, ROWS))})")
    args = ap.parse_args()
    kernels, heights = args.kernel or ["K1", "K4"], sorted(args.rows)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import Timer, routed_counts, smi_line
    from repro_torch.core import bipolar
    from repro_torch.kernels import apmm, moe, ops
    from repro_torch.models.config import QuantConfig
    from repro_torch.models.model import _quantize_experts
    copies = {kern: K5_COPIES if kern == "K5" else COPIES
              for kern in kernels}
    started = {(kern, route): build_variant(LIBS[kern][0], *copy)
               for kern in kernels for route, copy in copies[kern].items()}
    libs = {}
    for key, (proc, so) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            return 1
        libs[key] = load(so, key[0])
    print(smi_line(), flush=True)
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    found = {kern: [] for kern in kernels}

    def compare(kern, label, run, setter, rec):
        ms, outs = {}, {}
        for route in copies[kern]:
            setter(libs[kern, route])
            outs[route] = run()
            ms[route] = timer(run, iters=20)
        if any(not torch.equal(outs["rows"], o) for o in outs.values()):
            raise AssertionError(f"{label}: the routes differ")
        rec.update({f"{r}_ms": t for r, t in ms.items()},
                   faster=min(ms, key=ms.get))
        print(f"{label}: " + ", ".join(f"{r} {t:.4f} ms"
                                       for r, t in ms.items())
              + f" -> {rec['faster']}", flush=True)
        found[kern].append(rec)

    def k1_setter(fn):
        apmm._lib = lambda: fn

    def k4_setter(fn):
        moe._lib = lambda: fn

    def k5_setter(fn):
        apmm._packed_lib = lambda: fn

    for name, n, k, dual in K1_SHAPES if "K1" in kernels else ():
        w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                            2)
        w2 = ops.pack_weight(torch.randn((n, k), generator=g,
                                         device="cuda"), 2) if dual else None
        for m in heights:
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            a_s = bipolar.absmax_scale(x, 8, axis=-1).float()

            def run():
                return apmm.apmm_fused_linear(
                    x, a_s, w, w2=w2, a_bits=8, variant="bitserial",
                    act="silu" if dual else "none",
                    out_dtype=torch.bfloat16)

            compare("K1", f"K1-bs {name} N={n} K={k} M={m}", run, k1_setter,
                    dict(shape=name, m=m, n=n, k=k))
        del w, w2

    q = QuantConfig(w_bits=2)
    for name, n, k, dual in K4_SHAPES if "K4" in kernels else ():
        w = _quantize_experts(torch.randn((8, n, k), generator=g,
                                          device="cuda"), q)
        w2 = _quantize_experts(torch.randn((8, n, k), generator=g,
                                           device="cuda"), q) \
            if dual else None
        for seg in heights:
            counts = routed_counts(torch, g, e=8, g=1, tg=4 * seg,
                                   cap=seg)
            x = torch.randn((8, seg, k), generator=g, device="cuda").to(
                torch.bfloat16)
            a_s = bipolar.absmax_scale(x.float(), 8, axis=-1)
            bc = ops.moe_row_tile(seg)

            def run():
                return moe.moe_expert_linear(
                    x, a_s, counts, w, w2=w2, a_bits=8, variant="bitserial",
                    act="silu" if dual else "none",
                    out_dtype=torch.bfloat16, bc=bc)[0]

            compare("K4", f"K4-bs {name} E=8 seg={seg} N={n} K={k} "
                    f"({int(counts.sum())} live rows)", run, k4_setter,
                    dict(shape=name, seg=seg, n=n, k=k,
                         live=int(counts.sum())))
        del w, w2

    for name, n, k in K5_SHAPES if "K5" in kernels else ():
        w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                            2)
        for m in heights:
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            a, wk = ops._normalize_packed_kw(
                ops.quantize_rows(x, 8, pad_bit=0), w)

            def run():
                return apmm.apmm_packed(a, wk, variant="bitserial",
                                        out_dtype=torch.bfloat16)

            compare("K5", f"K5-bs {name} N={n} K={k} M={m}", run, k5_setter,
                    dict(shape=name, m=m, n=n, k=k))
        del w
    line = {kern.lower(): found[kern] for kern in kernels}
    for kern in kernels:
        cross = crossover(found[kern], "seg" if kern == "K4" else "m",
                          heights)
        line[f"{kern.lower()}_stacked_up_to"] = cross
        print(f"{kern}: stacked route faster than the rows route at every "
              f"shape up to "
              f"{'seg' if kern == 'K4' else 'M'} = {cross}", flush=True)
    if "K5" in kernels:
        wins = [r for r in found["K5"] if r["faster"] == "tile16"]
        print(f"K5: the 16 x 64 tile fastest at {len(wins)} of "
              f"{len(found['K5'])} shapes"
              + "".join(f"; {r['shape']} M={r['m']}" for r in wins),
              flush=True)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
