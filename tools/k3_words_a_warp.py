"""How many words a warp K3's wide route should pack, on the card.

K3's C entry (``src/repro_torch/csrc/pack.cu``) gives each warp
``WPW_WIDE`` consecutive words of a row when the grid has enough such
warps, else 4.  This script builds copies of ``pack.cu`` with
``WPW_WIDE`` at 8, 16 and 32 (the port's own flags, ``-I csrc`` for
``pack_core.cuh``, under ``build/kernels/wpw/``), calls each through
its C entry at ``chip_smoke.K3_CASES`` (inputs made from ``--seed`` as
phase 3 makes them), checks its words against the plain version, and
prints the median CUDA-event time (``chip_smoke.Timer``, L2 flushed
before each launch) and the device time (``chip_smoke.device_split``)
of each copy, twice in turns, then one JSON line.  Run it from the
repository root on a machine with one CUDA card and ``nvcc``::

    python3 tools/k3_words_a_warp.py
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

WIDTHS = (8, 16, 32)


def build_variant(wpw: int):
    from repro_torch.kernels import _build
    with open(os.path.join(_build._CSRC, "pack.cu")) as f:
        src, n = re.subn(r"constexpr int WPW_WIDE = \d+;",
                         f"constexpr int WPW_WIDE = {wpw};", f.read())
    if n != 1:
        raise RuntimeError("WPW_WIDE not found in pack.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "wpw")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"pack_{wpw}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    flags = _build.NVCC_FLAGS + _build.EXTRA_FLAGS["pack"]
    return subprocess.Popen([_build._nvcc(), *flags, "-I", _build._CSRC,
                             "-o", so, cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import bipolar
    from repro_torch.kernels import ref
    print(cs.smi_line(), flush=True)
    fns = {}
    started = {w: build_variant(w) for w in WIDTHS}
    for w, (proc, so) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for WPW_WIDE={w}:\n{out}")
        fn = ctypes.CDLL(so).repro_quantize_pack_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[w] = fn
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    res: dict = {}
    for name, r, k, n_bits, pad_bit in cs.K3_CASES:
        x = torch.randn((r, k), generator=g, device="cuda")
        scale = bipolar.absmax_scale(x, n_bits, axis=-1)
        sc = scale.reshape(r).float().contiguous()
        kw = bipolar.packed_words(k)
        want = ref.quantize_pack_rows(x, scale, n_bits=n_bits,
                                      pad_bit=pad_bit)
        out = torch.empty_like(want)
        for rep in range(2):
            for w, fn in fns.items():
                def run():
                    err = fn(x.data_ptr(), sc.data_ptr(), out.data_ptr(), r,
                             k, kw, n_bits, pad_bit,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"cudaError_t {err}")
                run()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"WPW_WIDE={w} {name}: words differ")
                ms = timer(run, iters=20)
                dev = sum(cs.device_split(torch, timer, run).values())
                res.setdefault(f"{name} WPW_WIDE={w}", []).append(
                    {"ms": ms, "device_ms": dev})
                print(f"K3 {name} WPW_WIDE={w} run {rep + 1}: words equal; "
                      f"{ms:.4f} ms, device {dev:.4f} ms", flush=True)
        del x, want, out
    print(json.dumps({"device": cs.smi_line(), "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
