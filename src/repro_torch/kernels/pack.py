"""K3 wrapper: per-row bipolar quantize + bit-plane pack (``csrc/pack.cu``).

Port of the TPU kernel ``repro/kernels/pack.py::quantize_pack_rows``.
The device decides: a CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.quantize_pack_rows`), a CUDA tensor
launches the kernel or raises, a meta tensor takes
:mod:`repro_torch.kernels.meta` (the planes' shape, no launch).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bipolar
from repro_torch.kernels import _build, meta, ref

LAUNCHES = 0          # kernel launches since the last reset (chip_smoke)

quantize_pack_rows_plain = ref.quantize_pack_rows


def _lib():
    lib = _build.load("pack")
    fn = lib.repro_quantize_pack_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def quantize_pack_rows(x: torch.Tensor, scale: torch.Tensor, *, n_bits: int,
                       pad_bit: int) -> torch.Tensor:
    """Quantize ``x (R, K)`` per row with ``scale (R, 1)`` and pack along
    K: returns ``(n_bits, R, ceil(K/32))`` int32 words (uint32 bits),
    columns past K filled with ``pad_bit``."""
    if x.device.type == "cpu":
        return quantize_pack_rows_plain(x, scale, n_bits=n_bits,
                                        pad_bit=pad_bit)
    if x.device.type == "meta":
        return meta.quantize_pack_rows(x, scale, n_bits=n_bits,
                                       pad_bit=pad_bit)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_pack_rows: unsupported device {x.device}")
    global LAUNCHES
    r, k = x.shape
    if not 1 <= n_bits <= 8 or pad_bit not in (0, 1):
        raise ValueError(f"n_bits={n_bits}, pad_bit={pad_bit}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_pack_rows kernel takes float32, got "
                        f"{x.dtype}")
    xs = x.contiguous()
    sc = scale.reshape(r).to(torch.float32).contiguous()
    if sc.device != xs.device:
        raise ValueError("x and scale must lie on the same device")
    kw = bipolar.packed_words(k)
    out = torch.empty((n_bits, r, kw), dtype=torch.int32, device=x.device)
    fn = _lib()
    err = fn(xs.data_ptr(), sc.data_ptr(), out.data_ptr(), r, k, kw, n_bits,
             pad_bit, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "quantize_pack_rows")
    LAUNCHES += 1
    return out
