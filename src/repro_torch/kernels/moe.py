"""K4 wrapper: grouped quantized MoE expert GEMM, one launch for all
experts (``csrc/moe_expert_linear.cu``).

Port of the TPU kernel ``repro/kernels/moe.py::moe_expert_linear``, both
variants: ``fused`` (int8 plane groups) and ``bitserial`` (the b1
tensor-core core of ``csrc/bitserial_core.cuh``).  The device decides:
CPU tensors run the plain version
(:func:`repro_torch.kernels.ref.ap_moe_expert_linear_ref` and the
analytic live map), CUDA tensors launch the kernel or raise, meta
tensors take :mod:`repro_torch.kernels.meta` (the output's and the live
map's shapes, no launch).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bipolar import BipolarTensor
from repro_torch.kernels import _build, apmm, meta, ref

LAUNCHES = 0            # `fused` launches since the last reset (chip_smoke)
BITSERIAL_LAUNCHES = 0  # `bitserial` launches

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"none": 0, "silu": 1, "gelu": 2}
_VARIANTS = {"fused": 0, "bitserial": 1}


def _lib():
    lib = _build.load("moe_expert_linear")
    fn = lib.repro_moe_expert_linear
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.cache
def fused_route_max() -> int:
    """The largest segment that K4's C entry sends to the fused variant's
    decode (weight-streaming) route; taller segments take its int8
    tensor-core chunk route (the library's own threshold)."""
    return int(_build.load("moe_expert_linear").repro_moe_fused_route_max())


@functools.cache
def bitserial_stack_max() -> int:
    """The largest segment that K4's C entry sends to the bitserial
    variant's stacked route (the library's own threshold)."""
    return int(_build.load("moe_expert_linear")
               .repro_moe_bitserial_stack_max())


def bitserial_pack_x(x: torch.Tensor, a_scale: torch.Tensor,
                     counts: torch.Tensor, *, a_bits: int, kw: int):
    """K4's bitserial prologue alone, on the card: the live rows of ``x
    (E, C, K)`` (``counts (E, G)``, segments of ``C / G`` rows) quantized
    with ``a_scale (E, C, 1)`` into their packed planes ``(a_bits, E*C,
    kw)`` int32 (K3's words, pad bit 0) and ``SU (E*C,)`` int32; dead
    rows' words are left unwritten and their SU is 0.  Not counted as a
    K4 launch."""
    e, c, k = x.shape
    g = counts.shape[1]
    if x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise ValueError("bitserial_pack_x: a CUDA f32 or bf16 tensor")
    ws = apmm._bitserial_workspace(a_bits, e * c, kw, x.device)
    fn = _build.load("moe_expert_linear").repro_moe_bitserial_pack_x
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(x.contiguous().data_ptr(),
                    a_scale.to(torch.float32).contiguous().data_ptr(),
                    counts.to(torch.int32).contiguous().data_ptr(),
                    ws.data_ptr(), e * g, c // g, k, kw, a_bits,
                    _DTYPES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "bitserial pack_x (moe)")
    n = a_bits * e * c * kw
    return ws[:n].view(a_bits, e * c, kw), ws[n:]


def moe_expert_linear_plain(x, a_scale, counts, w, *, w2=None, a_bits: int,
                            variant: str = "fused", act: str = "none",
                            out_dtype=torch.bfloat16, bc: int):
    """The plain version: ``(y, live_map)``."""
    y = ref.ap_moe_expert_linear_ref(x, a_scale, counts, w, w2=w2,
                                     a_bits=a_bits, variant=variant,
                                     act=act, out_dtype=out_dtype)
    seg = x.shape[1] // counts.shape[1]
    return y, ref.moe_live_map(counts, seg, bc)


def moe_expert_linear(x: torch.Tensor, a_scale: torch.Tensor,
                      counts: torch.Tensor, w: BipolarTensor, *,
                      w2: BipolarTensor | None = None, a_bits: int,
                      variant: str = "fused", act: str = "none",
                      out_dtype=torch.bfloat16, bc: int):
    """``y (E, C, N) = epi(Q(x (E, C, K)) @ W (E, N, K)^T)`` over ``G``
    segments of ``seg = C / G`` rows per expert, with per-row f32 scales
    ``a_scale (E, C, 1)`` and live-row counts ``counts (E, G)`` int32.
    Returns ``(y, live_map)``: rows at or beyond a segment's count are
    exact zeros, and ``live_map (E*G, ceil(seg / bc))`` int32 marks the
    ``bc``-row tiles whose first row is live (the kernel writes it for
    the tiles it ran)."""
    if x.device.type == "cpu":
        return moe_expert_linear_plain(
            x, a_scale, counts, w, w2=w2, a_bits=a_bits, variant=variant,
            act=act, out_dtype=out_dtype, bc=bc)
    if x.device.type == "meta":
        return meta.moe_expert_linear(
            x, a_scale, counts, w, w2=w2, a_bits=a_bits, variant=variant,
            act=act, out_dtype=out_dtype, bc=bc)
    if x.device.type != "cuda":
        raise ValueError(f"moe_expert_linear: unsupported device {x.device}")
    if variant not in _VARIANTS:
        raise ValueError(f"moe_expert_linear: variant {variant!r}")
    global LAUNCHES, BITSERIAL_LAUNCHES
    e, c, k = x.shape
    n_b, e_w, n, kw = w.packed.shape
    g = counts.shape[1]
    if w.shape != (e, n, k) or n_b != w.n_bits or e_w != e:
        raise ValueError(f"expert weight {w.shape}/{tuple(w.packed.shape)} "
                         f"does not match x {tuple(x.shape)}")
    if kw * 32 < k:
        raise ValueError(f"expert weight packs {kw} words for K={k}")
    if tuple(counts.shape) != (e, g) or c % g:
        raise ValueError(f"counts {tuple(counts.shape)} for x "
                         f"{tuple(x.shape)}")
    if tuple(a_scale.shape) != (e, c, 1):
        raise ValueError(f"a_scale {tuple(a_scale.shape)} for x "
                         f"{tuple(x.shape)}")
    if w2 is not None and (tuple(w2.packed.shape) != tuple(w.packed.shape)
                           or w2.shape != w.shape):
        raise ValueError("dual-GEMM expert weights must match in shape")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"moe_expert_linear: dtypes {x.dtype} -> "
                        f"{out_dtype} not supported")
    if a_scale.dtype != torch.float32 or counts.dtype != torch.int32:
        raise TypeError("moe_expert_linear: a_scale must be float32 and "
                        "counts int32")
    if act not in _ACTS or not 1 <= a_bits <= 8 or bc < 1:
        raise ValueError(f"act={act!r}, a_bits={a_bits}, bc={bc}")
    dev = x.device
    tensors = [x, a_scale, counts, w.packed, w.scale]
    if w2 is not None:
        tensors += [w2.packed, w2.scale]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"moe_expert_linear: all operands must lie on {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("moe_expert_linear: operands must be contiguous")
    ws = w.scale.reshape(e, n).to(torch.float32)
    w2s = w2.scale.reshape(e, n).to(torch.float32) if w2 is not None \
        else None
    seg = c // g
    n_ci = -(-seg // bc)
    out = torch.empty((e, c, n), dtype=out_dtype, device=dev)
    live = torch.empty((e * g, n_ci), dtype=torch.int32, device=dev)
    # the prologue's workspace -- fused: the live rows' int8 plane-group
    # values, then their sums; bitserial: X's planes, then SU
    if variant == "bitserial":
        xp = apmm._bitserial_workspace(a_bits, e * c, kw, dev)
    else:
        xp = torch.empty(len(ref.plane_groups(a_bits)) * e * c
                         * (kw * 32 + 4), dtype=torch.int8, device=dev)
    fn = _lib()
    err = fn(x.data_ptr(), a_scale.data_ptr(), counts.data_ptr(),
             w.packed.data_ptr(), ws.data_ptr(),
             0 if w2 is None else w2.packed.data_ptr(),
             0 if w2s is None else w2s.data_ptr(), out.data_ptr(),
             live.data_ptr(), xp.data_ptr(), e * g, e,
             g, seg, n, k, kw, a_bits, w.n_bits,
             _ACTS[act], bc, n_ci, _DTYPES[x.dtype], _DTYPES[out_dtype],
             _VARIANTS[variant], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"moe_expert_linear ({variant})")
    if variant == "fused":
        LAUNCHES += 1
    else:
        BITSERIAL_LAUNCHES += 1
    return out, live
