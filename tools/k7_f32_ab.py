"""K7's f32 route of this checkout against another checkout's, on the
card, in one process.

    python3 tools/k7_f32_ab.py OTHER_DIR [--rounds N]

``OTHER_DIR`` is another commit of this repository, unpacked (for
example ``git archive <commit> | tar -x -C build/parent``).  The script
builds that checkout's ``csrc/flash_attention.cu`` with this checkout's
nvcc flags into ``build/kernels/ab/`` (its C entries must take the same
arguments in both commits), then, at each case of ``chip_smoke.py``'s
``K6_CASES`` (llama3-8b's decode, its bucketed prefill and a 256-slot
window; the ring's K/V folded to ``(B * H, T, d)``), runs K7's f32 route
through both libraries -- each library's own split plan
(``repro_flash_attention_splits``), a workspace of that size, its C
entry, as the wrapper calls it -- and times both in turns, other, this,
this, other, ``--rounds`` times, with the L2 flushed before each launch
(``chip_smoke.Timer``), then each side's device time by kernel
(``chip_smoke.device_split``).  Both sides' f32 outputs must lie within
1e-5 absolute or 1e-6 relative of the plain version; the same inputs in
bf16 through K7's bf16 route, and the case's packed ring through K6 (its
output and its lse), must give the same bits from both libraries.  K6
runs in a child process per library (``--k6 LIB``, printing digests):
its launcher is a template of ``bipolar_attention.cuh`` whose
once-a-process flag (``static bool configured``) one process's two
libraries would share, so the second library's kernel would launch
without its shared-memory attribute.  It also says which of K2's
sources (``paged_attention.cu`` and the headers it includes) differ
between the checkouts.  Prints each side's median and one JSON line.
Run it from the repository root on a machine with one CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CSRC = os.path.join("src", "repro_torch", "csrc")


def build(other: str) -> ctypes.CDLL:
    """The other checkout's ``flash_attention`` library."""
    from repro_torch.kernels import _build
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "flash_attention.so")
    flags = _build.NVCC_FLAGS + _build.EXTRA_FLAGS.get("flash_attention", ())
    proc = subprocess.run(
        [_build._nvcc(), *flags, "-o", so,
         os.path.join(other, CSRC, "flash_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the other flash_attention.cu:"
                           f"\n{proc.stdout}")
    return ctypes.CDLL(so)


def entries(lib: ctypes.CDLL):
    """K7's C entry and split plan, and K6's C entry, of one library."""
    k7 = lib.repro_flash_attention
    k7.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    k7.restype = ctypes.c_int
    plan = lib.repro_flash_attention_splits
    plan.argtypes = [ctypes.c_int] * 5
    plan.restype = ctypes.c_int
    k6 = lib.repro_flash_attention_quantized
    k6.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    k6.restype = ctypes.c_int
    return k7, plan, k6


def k2_sources_differ(other: str) -> list:
    """K2's library sources (``paged_attention.cu`` and the ``csrc``
    headers it includes) whose bytes differ between the checkouts."""
    from repro_torch.kernels import _build
    here = _build._sources_of(os.path.join(ROOT, CSRC,
                                           "paged_attention.cu"))
    differ = []
    for path in here:
        name = os.path.basename(path)
        there = os.path.join(other, CSRC, name)
        digest = [hashlib.sha256(open(p, "rb").read()).hexdigest()
                  if os.path.exists(p) else None for p in (path, there)]
        if digest[0] != digest[1]:
            differ.append(name)
    return differ


H, D, N_BITS = 8, 128, 8       # llama3-8b's kv heads, head dim, kv8


def case_inputs(torch, index: int):
    """``K6_CASES[index]``'s ring and queries (``chip_smoke._ring_case``),
    made from seed ``index``: the same in every process."""
    from chip_smoke import K6_CASES, _ring_case
    name, kw, window = K6_CASES[index]
    g = torch.Generator(device="cuda").manual_seed(index)
    return name, window, _ring_case(torch, g, h=H, d=D, n_bits=N_BITS, **kw)


def digest(torch, t) -> str:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def k6_digests(so: str) -> int:
    """Child: K6 through one library (``so``, or ``this``: this
    checkout's) at every case; prints its outputs' and lses' digests as
    one JSON line."""
    import torch
    from chip_smoke import K6_CASES
    from repro_torch.kernels import _build, flash_attention
    lib = _build.load("flash_attention") if so == "this" else \
        ctypes.CDLL(so)
    fn = entries(lib)[2]
    flash_attention._contiguous_lib = lambda name: fn
    out = []
    for index in range(len(K6_CASES)):
        _, window, (q, _, planes, pos, q_pos) = case_inputs(torch, index)
        o, lse = flash_attention.flash_attention_quantized(
            q, *planes, q_pos, pos, d=D, window=window, return_lse=True)
        out.append([digest(torch, o), digest(torch, lse)])
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--k6", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    if args.k6:
        return k6_digests(args.k6)
    from chip_smoke import (K6_CASES, Timer, _k7_within, device_split,
                            smi_line, split_line)
    from repro_torch.kernels import _build, ref
    other_dir = os.path.abspath(args.other)
    libs = {"other": build(other_dir),
            "this": _build.load("flash_attention")}
    fns = {side: entries(lib) for side, lib in libs.items()}
    print(smi_line(), flush=True)
    differ = k2_sources_differ(other_dir)
    print(f"K2's sources that differ between the checkouts: "
          f"{differ or 'none (the same library)'}", flush=True)
    k6, k6_same = {}, []
    for side in ("other", "this"):
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.other, "--k6",
             libs["other"]._name if side == "other" else "this"],
            capture_output=True, text=True)
        if child.returncode != 0:
            raise RuntimeError(f"K6 through the {side} library failed:\n"
                               f"{child.stderr}")
        k6[side] = json.loads(child.stdout.splitlines()[-1])
    for index, (name, _, _) in enumerate(K6_CASES):
        k6_same.append(k6["other"][index] == k6["this"][index])
        print(f"K6 {name}: output and lse digests {k6['other'][index]} / "
              f"{k6['this'][index]}: "
              f"{'equal' if k6_same[-1] else 'DIFFER'}", flush=True)
    if not all(k6_same):
        raise AssertionError("K6's bits differ between the checkouts")
    timer = Timer(torch)
    d = D
    stream = torch.cuda.current_stream().cuda_stream

    def k7(side, qf, kf, vf, qpf, kpf, window):
        fn, plan, _ = fns[side]
        bh, sq, _ = qf.shape
        t = kf.shape[1]
        code = 0 if qf.dtype == torch.float32 else 1
        n_split = plan(bh, 1, sq, t, code)
        out = torch.empty_like(qf)
        ws = torch.empty(n_split * bh * sq * (d + 2), dtype=torch.float32,
                         device="cuda") if n_split > 1 else None
        err = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                 qpf.data_ptr(), kpf.data_ptr(), out.data_ptr(),
                 0 if ws is None else ws.data_ptr(), bh, 1, sq, t, d, 1,
                 window or 0, 1.0 / math.sqrt(d), code, stream)
        _build.check(err, f"{side} flash_attention")
        return out, n_split

    rows = []
    for index in range(len(K6_CASES)):
        name, window, (q, kv, _, pos, q_pos) = case_inputs(torch, index)
        b, sq = q.shape[0], q.shape[2]
        fold = [q.reshape(b * H, sq, d),
                *(ref.fold_kv_heads(x) for x in (kv[0], kv[1]))]
        qpf = q_pos.repeat_interleave(H, 0)
        kpf = pos.repeat_interleave(H, 0)
        # the unchanged bf16 route, bit for bit
        bf = [x.to(torch.bfloat16).contiguous() for x in fold]
        if not torch.equal(k7("other", *bf, qpf, kpf, window)[0],
                           k7("this", *bf, qpf, kpf, window)[0]):
            raise AssertionError(f"{name}: K7 bf16 differs between the "
                                 f"checkouts")
        # K7's f32 route, each side against the plain version
        qf, kf, vf = (x.float().contiguous() for x in fold)
        want = ref.flash_attention(qf, kf, vf, qpf, kpf, window=window)
        splits, errs, times, dev = {}, {}, {"other": [], "this": []}, {}
        for side in ("other", "this"):
            got, splits[side] = k7(side, qf, kf, vf, qpf, kpf, window)
            ok, errs[side], _ = _k7_within(torch, got, want)
            if not ok:
                raise AssertionError(f"{name}: the {side} f32 route is "
                                     f"beyond 1e-5 / 1e-6 of plain (max "
                                     f"|err| {errs[side]})")
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                times[side].append(timer(
                    lambda s=side: k7(s, qf, kf, vf, qpf, kpf, window),
                    iters=20))
        for side in ("other", "this"):
            dev[side] = device_split(
                torch, timer, lambda s=side: k7(s, qf, kf, vf, qpf, kpf,
                                                window))
        row = dict(case=name, bh=b * H, sq=sq, t=kf.shape[1], d=d,
                   window=window, other_splits=splits["other"],
                   this_splits=splits["this"],
                   other_ms=statistics.median(times["other"]),
                   this_ms=statistics.median(times["this"]),
                   other_device_ms=sum(dev["other"].values()),
                   this_device_ms=sum(dev["this"].values()),
                   other_err=errs["other"], this_err=errs["this"],
                   other_all=times["other"], this_all=times["this"])
        rows.append(row)
        print(f"K7 f32 {name} BH={b * H} Sq={sq} T={kf.shape[1]} d={d}: "
              f"other {row['other_ms']:.4f} ms ({splits['other']} T "
              f"range(s); device {split_line(dev['other'])}), this "
              f"{row['this_ms']:.4f} ms ({splits['this']} T range(s); "
              f"device {split_line(dev['this'])}); "
              f"{row['other_ms'] / row['this_ms']:.2f}x (medians of "
              f"{len(times['this'])} turns each); max|err| vs plain "
              f"{errs['other']:.3g} / {errs['this']:.3g}; K7 bf16 the "
              f"same bits from both", flush=True)
        del q, kv, fold, bf, qf, kf, vf, want
        torch.cuda.empty_cache()
    print(json.dumps({"k7_f32_ab": rows, "k6_same": k6_same,
                      "k2_sources_differ": differ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
