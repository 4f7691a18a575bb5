"""The port's examples (``examples/torch_*.py``) on the CPU at small
arguments, each in a subprocess with ``--device cpu``.

``torch_quickstart.py`` runs the reference's data through the port: its
packed bytes, its W3A2 checksum and its accuracy lines must equal those
of ``examples/quickstart.py``, run as it is in a subprocess (step 3
differs by design: the reference checks its Pallas kernel in interpret
mode, the port its CUDA kernels on a card and nothing on the CPU).  The
other three must exit 0 and print what their reference prints: the
serving demo finishes every request (``--paged --chunk-tokens
--metrics`` writes a Perfetto trace), the WSD run resumes after its
simulated preemption with a falling loss, the sweep prints a CE for
every width.  No example imports ``jax`` or anything of ``repro``.
"""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _start(script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, os.path.join(EXAMPLES, script)]
                            + list(args), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)


def _lines_of(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out.splitlines()


def _run(script, *args):
    return _lines_of(_start(script, *args))


def _lines(out, *prefixes):
    return [ln for ln in out if ln.strip().startswith(prefixes)]


def test_quickstart_prints_the_references_numbers():
    runs = [_start("torch_quickstart.py", "--device", "cpu"),
            _start("quickstart.py")]
    port, ref = (_lines_of(r) for r in runs)
    for prefixes in (("W1:", "W2:", "W3:", "W4:"), ("W3A2",),
                     ("W1A2", "W2A2", "W3A4", "W4A8", "W8A8")):
        got, want = _lines(port, *prefixes), _lines(ref, *prefixes)
        assert got == want and len(want) >= 1, (got, want)
    assert "  on cpu tensors the ops ran the kernels' plain torch versions; "\
        "the kernels run on CUDA tensors only" in port
    assert port[-1] == "done."


@pytest.mark.parametrize("paged", [False, True])
def test_serve_llm(tmp_path, paged):
    args = ["--device", "cpu", "--new-tokens", "4"]
    if paged:
        trace = tmp_path / "trace.json"
        args += ["--paged", "--chunk-tokens", "8", "--metrics",
                 "--trace-out", str(trace)]
    out = _run("torch_serve_llm.py", *args)
    assert out[-1] == "done."
    assert _lines(out, "greedy agreement on first 4 tokens:")
    if paged:
        assert _lines(out, "pool: ") and _lines(out, "chunked prefill: ")
        assert _lines(out, "metrics: 8 submitted, 8 finished(length)")
        with open(trace) as f:
            assert json.load(f)["traceEvents"]


def test_train_wsd_resumes_and_converges(tmp_path):
    out = _run("torch_train_wsd.py", "--device", "cpu", "--steps", "40",
               "--ckpt-dir", str(tmp_path / "ck"))
    assert _lines(out, "!! preempted after step 20 -- restarting")
    assert _lines(out, "loss: ") and "over 40 steps" in _lines(
        out, "loss: ")[0]
    assert out[-1] == "done."
    assert not (tmp_path / "ck").exists()


def test_quantize_sweep_every_width():
    out = _run("torch_quantize_sweep.py", "--device", "cpu", "--steps", "10")
    assert _lines(out, "bf16 ceiling: CE")
    assert [ln.split("|")[0].strip() for ln in _lines(out, "W")] == \
        ["W8", "W6", "W5", "W4", "W3", "W2", "W1"]
    assert out[-1].startswith("done.")


def test_examples_import_neither_jax_nor_the_reference():
    scripts = glob.glob(os.path.join(EXAMPLES, "torch_*.py"))
    assert len(scripts) == 4
    for path in scripts:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro", "flax",
                                    "benchmarks"), (path, n)


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_serve_llm.py",
                                    "torch_train_wsd.py",
                                    "torch_quantize_sweep.py"])
def test_examples_need_a_card_by_default(monkeypatch, script):
    """Without ``--device`` an example asks for the card and raises here,
    where there is none, before it does any work."""
    import runpy
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = os.path.join(EXAMPLES, script)
    monkeypatch.setattr(sys, "argv", [path])
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        runpy.run_path(path, run_name="__main__")
