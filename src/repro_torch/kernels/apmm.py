"""K1 and K5 wrappers: the one-kernel fused quantized linear
(``csrc/apmm_fused_linear.cu``) and the packed x packed GEMM of the
unfused linear (``csrc/apmm_packed.cu``).

Ports of the TPU kernels ``repro/kernels/apmm.py::apmm_fused_linear``
and ``::apmm_packed``, both variants: ``fused`` (int8 plane groups) and
``bitserial`` (one b1 tensor-core GEMM per bit pair, the shared core of
``csrc/bitserial_core.cuh``).  The device decides: CPU tensors run the
plain versions
(:func:`repro_torch.kernels.ref.ap_linear_fused_ref`,
:func:`~repro_torch.kernels.ref.apmm_packed` and
:func:`~repro_torch.kernels.ref.apmm_dequant`), CUDA tensors launch the
kernel or raise, meta tensors take :mod:`repro_torch.kernels.meta` (the
outputs' shapes, no launch).  Both fused C entries write their
activations once per launch as int8 plane-group values into a workspace
the wrapper allocates (its size from the library, :func:`_fused_ws`),
then take the one weight-streaming GEMM of ``csrc/small_m.cuh`` at small
M (:func:`small_m_max`, :func:`packed_small_m_max`) and the one int8
tensor-core chunk GEMM of ``csrc/int8_mma.cuh`` (K4's chunk route too)
above.  The bitserial variants take the b1 core's stacked route up to
:func:`bitserial_stack_max` (K1) and :func:`packed_bitserial_stack_max`
(K5) rows and its rows route above.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bipolar import BipolarTensor
from repro_torch.kernels import _build, meta, ref

LAUNCHES = 0          # K1 `fused` launches since the last reset (chip_smoke)
SMALL_M_LAUNCHES = 0  # of those, on the small-M route (M <= small_m_max())
PACKED_LAUNCHES = 0   # K5 `fused` launches since the last reset
PACKED_SMALL_M_LAUNCHES = 0   # of those, on the small-M route
BITSERIAL_LAUNCHES = 0         # K1 `bitserial` launches
PACKED_BITSERIAL_LAUNCHES = 0  # K5 `bitserial` launches

apmm_fused_linear_plain = ref.ap_linear_fused_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RAW = 2              # K5's out dtype code for the raw int32 product
_ACTS = {"none": 0, "silu": 1, "gelu": 2}
_VARIANTS = {"fused": 0, "bitserial": 1}


def _k1_so():
    """K1's library (its C entry and its workspace size)."""
    return _build.load("apmm_fused_linear")


def _k5_so():
    """K5's library (its C entry and its workspace size)."""
    return _build.load("apmm_packed")


def _lib():
    fn = _k1_so().repro_apmm_fused_linear
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.cache
def small_m_max() -> int:
    """The largest M that K1's C entry routes to its small-M kernel (the
    library's own threshold; builds the library)."""
    return int(_build.load("apmm_fused_linear").repro_apmm_small_m_max())


@functools.cache
def bitserial_stack_max() -> int:
    """The largest M that K1's C entry sends to the bitserial variant's
    stacked route (the library's own threshold; builds the library)."""
    return int(_build.load("apmm_fused_linear")
               .repro_apmm_bitserial_stack_max())


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _fused_ws(lib, entry: str, dev, *args) -> torch.Tensor:
    """The fused variant's workspace, as many bytes as the library's
    ``entry`` asks at this shape (the activations' int8 plane-group
    values, and the chunk route's split-K partial sums where it splits)."""
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_longlong
    n_bytes = fn(*args)
    if n_bytes < 0:
        raise RuntimeError(f"{entry}: the card's SM count could not be read")
    return torch.empty(n_bytes, dtype=torch.uint8, device=dev)


def _bitserial_workspace(a_bits: int, rows: int, kw: int, dev):
    """The bitserial prologue's workspace: the packed activation planes
    ``(a_bits, rows, kw)`` words, then SU ``(rows,)`` int32."""
    return torch.empty(a_bits * rows * kw + rows, dtype=torch.int32,
                       device=dev)


def bitserial_pack_x(x2: torch.Tensor, a_scale: torch.Tensor, *,
                     a_bits: int, kw: int):
    """K1's bitserial prologue alone, on the card: ``x2 (M, K)`` quantized
    with ``a_scale (M, 1)`` into its packed planes ``(a_bits, M, kw)``
    int32 (K3's words, pad bit 0) and ``SU (M,)`` int32, the sum of each
    row's unsigned bipolar fields.  Not counted as a K1 launch."""
    m, k = x2.shape
    if x2.device.type != "cuda" or x2.dtype not in _DTYPES:
        raise ValueError("bitserial_pack_x: a CUDA f32 or bf16 tensor")
    xs = x2.contiguous()
    a_s = a_scale.reshape(m).to(torch.float32).contiguous()
    ws = _bitserial_workspace(a_bits, m, kw, x2.device)
    fn = _build.load("apmm_fused_linear").repro_apmm_bitserial_pack_x
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(xs.data_ptr(), a_s.data_ptr(), ws.data_ptr(), m, k, kw,
                    a_bits, _DTYPES[x2.dtype],
                    torch.cuda.current_stream(x2.device).cuda_stream),
                 "bitserial pack_x")
    n = a_bits * m * kw
    return ws[:n].view(a_bits, m, kw), ws[n:]


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
    if x2.device.type == "meta":
        return meta.apmm_fused_linear(
            x2, a_scale, w, w2=w2, bias=bias, residual=residual,
            a_bits=a_bits, variant=variant, act=act, out_dtype=out_dtype)
    if x2.device.type != "cuda":
        raise ValueError(f"apmm_fused_linear: unsupported device {x2.device}")
    if variant not in _VARIANTS:
        raise ValueError(f"apmm_fused_linear: variant {variant!r}")
    global LAUNCHES, SMALL_M_LAUNCHES, BITSERIAL_LAUNCHES
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
    fused = variant == "fused"
    small = fused and m <= small_m_max()
    if fused:     # X quantized once, int8 per group (+ split-K's sums)
        xq = _fused_ws(_k1_so(), "repro_apmm_fused_ws_bytes", dev, m, n, kw,
                       a_bits, w.n_bits, 1 if w2 is None else 2)
    else:         # the bitserial prologue's: X's planes, then SU
        xq = _bitserial_workspace(a_bits, m, kw, dev)
    err = fn(xs.data_ptr(), a_s.data_ptr(), wp.data_ptr(), ws.data_ptr(),
             _ptr(w2p), _ptr(w2s), _ptr(bs_), _ptr(res), out.data_ptr(),
             _ptr(xq), m, n, k, kw, a_bits, w.n_bits, _ACTS[act],
             _DTYPES[x2.dtype], _DTYPES[out_dtype], _VARIANTS[variant],
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"apmm_fused_linear ({variant})")
    if fused:
        LAUNCHES += 1
        SMALL_M_LAUNCHES += small
    else:
        BITSERIAL_LAUNCHES += 1
    return out


def _packed_lib():
    fn = _k5_so().repro_apmm_packed
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.cache
def packed_small_m_max() -> int:
    """The largest M that K5's C entry routes to the small-M route (K1's
    weight-streaming GEMM; the library's own threshold; builds the
    library)."""
    return int(_build.load("apmm_packed").repro_apmm_packed_small_m_max())


@functools.cache
def packed_bitserial_stack_max() -> int:
    """The largest M that K5's C entry sends to the bitserial variant's
    stacked route (the b1 core's, with SU from A's staged words; the
    library's own threshold; builds the library)."""
    return int(_build.load("apmm_packed")
               .repro_apmm_packed_bitserial_stack_max())


def apmm_packed_plain(a: BipolarTensor, b: BipolarTensor, *,
                      variant: str = "fused", out_dtype=None):
    """Plain version of :func:`apmm_packed`."""
    if out_dtype is None:
        return ref.apmm_packed(a, b, variant=variant)
    return ref.apmm_dequant(a, b, variant=variant, out_dtype=out_dtype)


def apmm_packed(a: BipolarTensor, b: BipolarTensor, *,
                variant: str = "fused", out_dtype=None) -> torch.Tensor:
    """``Y (M, N) = A (M, K) @ B (N, K)^T`` of two packed operands of one
    word width (A pad bit 0, B pad bit 1): the exact int32 product when
    ``out_dtype`` is None, else ``(y * a_scale) * b_scale`` in f32 cast
    to ``out_dtype`` (f32 or bf16)."""
    if a.packed.device.type == "cpu":
        return apmm_packed_plain(a, b, variant=variant, out_dtype=out_dtype)
    if a.packed.device.type == "meta":
        return meta.apmm_packed(a, b, variant=variant, out_dtype=out_dtype)
    if a.packed.device.type != "cuda":
        raise ValueError(f"apmm_packed: unsupported device {a.device}")
    if variant not in _VARIANTS:
        raise ValueError(f"apmm_packed: variant {variant!r}")
    global PACKED_LAUNCHES, PACKED_SMALL_M_LAUNCHES, PACKED_BITSERIAL_LAUNCHES
    (m, k), (n, k2) = a.shape, b.shape
    n_a, m_, kw = a.packed.shape
    n_b, n_, kw2 = b.packed.shape
    if k != k2 or (m_, n_) != (m, n) or (n_a, n_b) != (a.n_bits, b.n_bits):
        raise ValueError(f"apmm_packed: A {a.shape}/{tuple(a.packed.shape)}"
                         f" does not match B {b.shape}/"
                         f"{tuple(b.packed.shape)}")
    if kw != kw2 or kw * 32 < k:
        raise ValueError(f"apmm_packed: word widths {kw}, {kw2} for K={k} "
                         f"(pad to a common width first)")
    if out_dtype is not None and out_dtype not in _DTYPES:
        raise TypeError(f"apmm_packed: out dtype {out_dtype}")
    if a.packed.dtype != torch.int32 or b.packed.dtype != torch.int32:
        raise TypeError("apmm_packed: packed planes must be int32 words")
    if b.packed.device != a.packed.device:
        raise ValueError("apmm_packed: operands on different devices")
    dev = a.packed.device
    ap, bp = a.packed.contiguous(), b.packed.contiguous()
    a_s = b_s = None
    if out_dtype is not None:
        a_s = a.scale.reshape(m).to(torch.float32).contiguous()
        b_s = b.scale.reshape(n).to(torch.float32).contiguous()
        if a_s.device != dev or b_s.device != dev:
            raise ValueError("apmm_packed: scales on another device")
    out = torch.empty((m, n), device=dev,
                      dtype=torch.int32 if out_dtype is None else out_dtype)
    small = variant == "fused" and m <= packed_small_m_max()
    # A's values once, int8 per plane group (+ split-K's sums)
    xq = _fused_ws(_k5_so(), "repro_apmm_packed_ws_bytes", dev, m, n, kw,
                   n_a, n_b) if variant == "fused" else None
    err = _packed_lib()(
        ap.data_ptr(), bp.data_ptr(), _ptr(a_s), _ptr(b_s), out.data_ptr(),
        _ptr(xq), m, n, k, kw, n_a, n_b,
        _RAW if out_dtype is None else _DTYPES[out_dtype],
        _VARIANTS[variant], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"apmm_packed ({variant})")
    if variant == "fused":
        PACKED_LAUNCHES += 1
        PACKED_SMALL_M_LAUNCHES += small
    else:
        PACKED_BITSERIAL_LAUNCHES += 1
    return out
