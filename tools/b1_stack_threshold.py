"""Where the bit-serial core's stacked route stops beating its rows route,
on the card.

The bitserial variants of K1 (``src/repro_torch/csrc/apmm_fused_linear.cu``)
and K4 (``moe_expert_linear.cu``) send every M (K4: every segment height)
up to ``STACK_MAX`` to the b1 core's stacked route -- the (activation
plane, row) pairs stacked into the MMA's 16 rows -- and every larger one
to its rows route (64 x 64 tiles, diagonal chaining).  This script builds
two copies of each source, one with the threshold at 0 (every shape on the
rows route) and one at 256 (every shape measured here on the stacked
route), times both through the port's own wrappers at llama3-8b's
linears (K1, M rows) and mixtral-8x7b's expert linears (K4: 8 experts, 1
dispatch group, ``seg`` rows each, every row live), w2 a8, L2 flushed
before each launch as ``chip_smoke.py`` times, checks that the two routes
give the same bits, and prints for each shape both times and the faster
route, then one JSON line.  Run it from the repository root on a machine
with one CUDA card and ``nvcc``::

    python3 tools/b1_stack_threshold.py
"""

from __future__ import annotations

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
LIBS = {"apmm_fused_linear": ("repro_apmm_fused_linear", 10, 10),
        "moe_expert_linear": ("repro_moe_expert_linear", 10, 15)}


def build_variant(name: str, threshold: int):
    """``csrc/<name>.cu`` with ``STACK_MAX`` set to ``threshold``, built
    with the port's own flags under ``build/kernels/stack_threshold/``."""
    from repro_torch.kernels import _build
    with open(os.path.join(_build._CSRC, f"{name}.cu")) as f:
        src, n = re.subn(r"constexpr int STACK_MAX = \d+;",
                         f"constexpr int STACK_MAX = {threshold};", f.read())
    if n != 1:
        raise RuntimeError(f"STACK_MAX not found in {name}.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "stack_threshold")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{name}_{threshold}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    flags = _build.NVCC_FLAGS + _build.EXTRA_FLAGS[name]
    return subprocess.Popen([_build._nvcc(), *flags, "-I", _build._CSRC,
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def load(so: str, name: str):
    entry, n_ptr, n_int = LIBS[name]
    fn = getattr(ctypes.CDLL(so), entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def crossover(rows, key):
    """The largest row count up to which the stacked route wins at every
    shape."""
    cross = 0
    for m in ROWS:
        if all(r["faster"] == "stacked" for r in rows if r[key] == m):
            cross = m
        else:
            break
    return cross


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import Timer, routed_counts, smi_line
    from repro_torch.core import bipolar
    from repro_torch.kernels import apmm, moe, ops
    from repro_torch.models.config import QuantConfig
    from repro_torch.models.model import _quantize_experts
    started = {(name, thr): build_variant(name, thr)
               for name in LIBS for thr in (0, STACKED)}
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
    k1_rows, k4_rows = [], []

    def compare(label, run, setter, rec):
        ms, outs = {}, {}
        for thr in (0, STACKED):
            setter(thr)
            outs[thr] = run()
            ms[thr] = timer(run, iters=20)
        if not torch.equal(outs[0], outs[STACKED]):
            raise AssertionError(f"{label}: the routes differ")
        rec.update(rows_ms=ms[0], stacked_ms=ms[STACKED],
                   faster="stacked" if ms[STACKED] < ms[0] else "rows")
        print(f"{label}: rows {ms[0]:.4f} ms, stacked {ms[STACKED]:.4f} ms "
              f"-> {rec['faster']}", flush=True)
        return rec

    def k1_setter(thr):
        apmm._lib = lambda fn=libs[("apmm_fused_linear", thr)]: fn

    for name, n, k, dual in K1_SHAPES:
        w = ops.pack_weight(torch.randn((n, k), generator=g, device="cuda"),
                            2)
        w2 = ops.pack_weight(torch.randn((n, k), generator=g,
                                         device="cuda"), 2) if dual else None
        for m in ROWS:
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            a_s = bipolar.absmax_scale(x, 8, axis=-1).float()

            def run():
                return apmm.apmm_fused_linear(
                    x, a_s, w, w2=w2, a_bits=8, variant="bitserial",
                    act="silu" if dual else "none",
                    out_dtype=torch.bfloat16)

            k1_rows.append(compare(f"K1-bs {name} N={n} K={k} M={m}", run,
                                   k1_setter,
                                   dict(shape=name, m=m, n=n, k=k)))
        del w, w2

    def k4_setter(thr):
        moe._lib = lambda fn=libs[("moe_expert_linear", thr)]: fn

    q = QuantConfig(w_bits=2)
    for name, n, k, dual in K4_SHAPES:
        w = _quantize_experts(torch.randn((8, n, k), generator=g,
                                          device="cuda"), q)
        w2 = _quantize_experts(torch.randn((8, n, k), generator=g,
                                           device="cuda"), q) \
            if dual else None
        for seg in ROWS:
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

            k4_rows.append(compare(
                f"K4-bs {name} E=8 seg={seg} N={n} K={k} "
                f"({int(counts.sum())} live rows)", run, k4_setter,
                dict(shape=name, seg=seg, n=n, k=k,
                     live=int(counts.sum()))))
        del w, w2
    c1, c4 = crossover(k1_rows, "m"), crossover(k4_rows, "seg")
    print(f"stacked route faster at every shape up to K1 M = {c1}, "
          f"K4 seg = {c4}")
    print(json.dumps({"k1": k1_rows, "k4": k4_rows, "k1_stacked_up_to": c1,
                      "k4_stacked_up_to": c4}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
