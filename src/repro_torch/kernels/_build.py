"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use, by ``nvcc`` alone, into its own shared library under
``build/kernels/`` at the repository root, then loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries are cached by
a hash of their source, the ``csrc/*.cuh`` headers it includes (the
shared b1 core, ``bitserial_core.cuh``) and the flags: an unchanged
source is never rebuilt, and an edited header rebuilds every source that
includes it.
:func:`build_all` starts one ``nvcc`` per source at once.  A failed
build raises with the compiler's output; the ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is printed once per build
and kept beside the library (``<name>-<hash>.ptxas.txt``), so
:data:`ptxas_reports` holds it on a cached load too.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_CSRC)))
BUILD_DIR = os.path.join(_ROOT, "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source extra flags: the GEMM epilogues and the pack must not
# contract multiply-adds into FMAs (their f32 bits are held bit-exact
# against the plain versions); intrinsics pin them too
EXTRA_FLAGS = {"apmm_fused_linear": ("-fmad=false",),
               "apmm_packed": ("-fmad=false",),
               "moe_expert_linear": ("-fmad=false",),
               "pack": ("-fmad=false",)}

_libs: dict = {}
_lock = threading.Lock()
ptxas_reports: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built from csrc/ on a machine with the CUDA "
                       "toolkit (set $NVCC or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources_of(src: str) -> list:
    """``src`` and every ``csrc/`` header it includes, directly or through
    another header, in the order they are first met."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                todo.append(os.path.join(_CSRC, inc.decode()))
    return seen


def _target(name: str):
    src = os.path.join(_CSRC, f"{name}.cu")
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in _sources_of(src):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    so = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    return src, flags, so


def _report_path(so: str) -> str:
    return so[:-len(".so")] + ".ptxas.txt"


def _start(name: str):
    """Start ``nvcc`` for one source; returns None when already built
    (its saved ``-Xptxas -v`` report then goes into ``ptxas_reports``)."""
    src, flags, so = _target(name)
    if os.path.exists(so):
        if os.path.exists(_report_path(so)):
            with open(_report_path(so)) as f:
                ptxas_reports[name] = f.read()
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, cmd


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, so, cmd = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{' '.join(cmd)}\n{out}")
    report = "\n".join(line for line in out.splitlines()
                       if "ptxas" in line)
    with open(_report_path(so), "w") as f:
        f.write(report)
    os.replace(tmp, so)
    ptxas_reports[name] = report
    print(f"[repro_torch build] csrc/{name}.cu -> {os.path.relpath(so, _ROOT)}"
          f"\n{report}", flush=True)


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(_CSRC) if f.endswith(".cu"))


def build_all() -> None:
    """Compile every kernel source in parallel (one ``nvcc`` each)."""
    with _lock:
        started = {n: _start(n) for n in sources()}
        for n, s in started.items():
            _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_target(name)[2])
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {err}")
