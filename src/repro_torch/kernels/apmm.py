"""K1 wrapper: one-kernel fused quantized linear
(``csrc/apmm_fused_linear.cu``).

Port of the TPU kernel ``repro/kernels/apmm.py::apmm_fused_linear``
(``fused`` variant).  The device decides: CPU tensors run the plain
version (:func:`repro_torch.kernels.ref.ap_linear_fused_ref`), CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bipolar import BipolarTensor
from repro_torch.kernels import _build, ref

LAUNCHES = 0          # kernel launches since the last reset (chip_smoke)

apmm_fused_linear_plain = ref.ap_linear_fused_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"none": 0, "silu": 1, "gelu": 2}


def _lib():
    lib = _build.load("apmm_fused_linear")
    fn = lib.repro_apmm_fused_linear
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def apmm_fused_linear(x2: torch.Tensor, a_scale: torch.Tensor,
                      w: BipolarTensor, *, w2: BipolarTensor | None = None,
                      bias: torch.Tensor | None = None,
                      residual: torch.Tensor | None = None, a_bits: int,
                      variant: str = "fused", act: str = "none",
                      out_dtype=torch.float32) -> torch.Tensor:
    """``Y (M, N) = epi(Q(x2 (M, K)) @ W (N, K)^T)`` with per-row
    activation scales ``a_scale (M, 1)`` f32 (see
    :func:`repro_torch.kernels.ref.ap_linear_fused_ref` for the epilogue
    contract)."""
    if x2.device.type == "cpu":
        return apmm_fused_linear_plain(
            x2, a_scale, w, w2=w2, bias=bias, residual=residual,
            a_bits=a_bits, variant=variant, act=act, out_dtype=out_dtype)
    if x2.device.type != "cuda":
        raise ValueError(f"apmm_fused_linear: unsupported device {x2.device}")
    if variant != "fused":
        raise NotImplementedError(
            "apmm_fused_linear: the bitserial variant has no CUDA kernel "
            "yet (ROADMAP queue 2, K1 follow-up: the b1 XOR-popc mma "
            "kernel)")
    global LAUNCHES
    m, k = x2.shape
    n_b, n, kw = w.packed.shape
    if w.shape != (n, k) or n_b != w.n_bits:
        raise ValueError(f"weight {w.shape}/{tuple(w.packed.shape)} does "
                         f"not match x {tuple(x2.shape)}")
    if kw * 32 < k:
        raise ValueError(f"weight packs {kw} words for K={k}")
    if w2 is not None and (tuple(w2.packed.shape) != tuple(w.packed.shape)
                           or w2.shape != w.shape):
        raise ValueError("dual-GEMM weights must match in shape")
    if x2.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"apmm_fused_linear: dtypes {x2.dtype} -> "
                        f"{out_dtype} not supported")
    if act not in _ACTS or not 1 <= a_bits <= 8:
        raise ValueError(f"act={act!r}, a_bits={a_bits}")
    dev = x2.device
    tensors = [x2, a_scale, w.packed, w.scale]
    if w2 is not None:
        tensors += [w2.packed, w2.scale]
    for extra in (bias, residual):
        if extra is not None:
            tensors.append(extra)
    if any(t.device != dev for t in tensors):
        raise ValueError("apmm_fused_linear: all operands must lie on "
                         f"{dev}")
    xs = x2.contiguous()
    a_s = a_scale.reshape(m).to(torch.float32).contiguous()
    wp = w.packed.contiguous()
    ws = w.scale.reshape(n).to(torch.float32).contiguous()
    w2p = w2.packed.contiguous() if w2 is not None else None
    w2s = (w2.scale.reshape(n).to(torch.float32).contiguous()
           if w2 is not None else None)
    bs_ = bias.reshape(n).to(torch.float32).contiguous() \
        if bias is not None else None
    res = residual.reshape(m, n).to(out_dtype).contiguous() \
        if residual is not None else None
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _lib()
    err = fn(xs.data_ptr(), a_s.data_ptr(), wp.data_ptr(), ws.data_ptr(),
             _ptr(w2p), _ptr(w2s), _ptr(bs_), _ptr(res), out.data_ptr(),
             m, n, k, kw, a_bits, w.n_bits, _ACTS[act], _DTYPES[x2.dtype],
             _DTYPES[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "apmm_fused_linear")
    LAUNCHES += 1
    return out
