"""The numbers behind ``tests/test_torch_distributed.py``'s sharded cases,
printed: each case's loss against the single process's (relative), its
worst gradient leaf (relative L2), a rank's product FLOPs a token and the
most gathered weight bytes it held, then the MoE witness, the drop count
and the FLOPs ratio of the (4, 2) mesh to the (8, 1) one.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/dist_cases.py

It runs the test module's 8 gloo ranks and its reference subprocess (the
ranks wait for the reference's checkpoint) in a temporary directory, on
the CPU, about as long as the test file.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
sys.path.insert(0, TESTS)

import test_torch_distributed as T  # noqa: E402


def main() -> int:
    src = os.path.join(ROOT, "src")
    with tempfile.TemporaryDirectory() as out:
        ckpt = os.path.join(out, "ref_ckpt")
        ref = subprocess.Popen(
            [sys.executable, "-c", T._REFERENCE,
             os.path.join(out, "ref.pkl"), ckpt, TESTS],
            env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=src),
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
        ranks = [subprocess.Popen(
            [sys.executable, T.__file__, str(r), out, ckpt], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
            for r in range(T.WORLD)]
        rcs = [p.wait(timeout=600) for p in ranks] + [ref.wait(timeout=600)]
        if any(rcs):
            print(f"a process failed: {rcs}", file=sys.stderr)
            return 1
        with open(os.path.join(out, "rank0.pkl"), "rb") as f:
            got = pickle.load(f)
        single = {}
        for r in range(T.WORLD):
            with open(os.path.join(out, f"single{r}.pkl"), "rb") as f:
                single.update(pickle.load(f))
    for name in T.CASES:
        g, w = got[name]["loss"], single[name]["loss"]
        worst = max(T._rel(a, b) for a, b in zip(got[name]["grads"],
                                                 single[name]["grads"]))
        print(f"{name}: loss {abs(g - w) / abs(w):.3g}, worst leaf "
              f"{worst:.3g}, FLOPs a token {got[name]['flops_per_token']:.4g},"
              f" gathered {got[name]['gathered_bytes']} B (bound "
              f"{got[name]['gathered_bound']:.0f})")
    m = single["mixtral-8x7b"]
    print(f"mixtral's DP-mean aux loss: "
          f"{abs(m['dp_mean_aux_loss'] - m['loss']) / abs(m['loss']):.3g}; "
          f"dropped assignments: {single['mixtral-8x7b drops']['dropped']};"
          f" FLOPs a token (4, 2) / (8, 1): "
          f"{got['llama3-8b']['flops_per_token'] / got['llama3-8b data mesh']['flops_per_token']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
