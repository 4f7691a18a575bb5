"""K2, K6 and K7 wrappers: online-softmax attention over the paged
bipolar KV pool (``csrc/paged_attention.cu``), over a contiguous packed
bipolar KV cache and over float K/V (both ``csrc/flash_attention.cu``).

Ports of the TPU kernels
``repro/kernels/flash_attention.py::flash_attention_paged_quantized``,
``::flash_attention_quantized`` and ``::flash_attention``.  The device
decides: CPU tensors run the plain versions
(:func:`repro_torch.kernels.ref.paged_attention`,
:func:`~repro_torch.kernels.ref.kv_cache_attention`,
:func:`~repro_torch.kernels.ref.flash_attention`), CUDA tensors launch
the kernel or raise.  K2's C entry splits each request's block table
across blocks, K6's splits the ring's tiles, and K7's splits T for bf16
inputs, when the grid would not fill the card; :func:`paged_splits`,
:func:`quantized_splits` and :func:`float_splits` report their choice,
and the wrappers allocate the partials' workspace.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = 0            # K2 launches since the last reset (chip_smoke)
QUANTIZED_LAUNCHES = 0  # K6 launches since the last reset
FLOAT_LAUNCHES = 0      # K7 launches since the last reset

flash_attention_paged_quantized_plain = ref.paged_attention
flash_attention_quantized_plain = ref.kv_cache_attention
flash_attention_plain = ref.flash_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.repro_paged_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _dense(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype`` (itself when it is one:
    no dispatch on the decode path's hot call)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


@functools.cache
def paged_splits(b: int, h: int, gq: int, nb: int) -> int:
    """How many ranges of the ``NB`` table entries K2's C entry splits
    this shape into (its own choice, from its grid and ``NB``; builds
    the library)."""
    fn = _build.load("paged_attention").repro_paged_attention_splits
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = int(fn(b, h, gq, nb))
    if n < 1:
        raise RuntimeError(f"paged attention split plan: cudaError_t {-n}")
    return n


def flash_attention_paged_quantized(q, k_pool, k_scale, v_pool, v_scale,
                                    pool_pos, block_tables, q_pos, *,
                                    d: int, causal: bool = True,
                                    window=None) -> torch.Tensor:
    """Attention of ``q (B, H, Gq, d)`` over the pool through
    ``block_tables (B, NB)``: pools ``(n_blocks, bs, H, n_bits, Dw)``
    int32 words, scales ``(n_blocks, bs, H, 1)`` f32, ``pool_pos
    (n_blocks, bs)`` and ``q_pos (B, Gq)`` int32.  Returns ``(B, H, Gq,
    d)`` in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_paged_quantized_plain(
            q, k_pool, k_scale, v_pool, v_scale, pool_pos, block_tables,
            q_pos, d=d, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: unsupported device {q.device}")
    global LAUNCHES
    b, h, gq, dq = q.shape
    n_blocks, bs, hp, n_bits, dw = k_pool.shape
    nb = block_tables.shape[1]
    if (hp, dq) != (h, d) or d > dw * 32 or tuple(v_pool.shape) != \
            tuple(k_pool.shape):
        raise ValueError(f"q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}")
    if tuple(pool_pos.shape) != (n_blocks, bs) or \
            tuple(q_pos.shape) != (b, gq) or block_tables.shape[0] != b:
        raise ValueError("pool_pos/q_pos/block_tables shapes do not match")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged attention: q dtype {q.dtype}")
    if bs > 32 or 32 % bs or dw > 8 or not 1 <= n_bits <= 8:
        raise ValueError(f"paged attention kernel takes block_size | 32, "
                         f"head dim <= 256, 1..8 bits; got bs={bs}, "
                         f"Dw={dw}, n_bits={n_bits}")
    ops = [q, k_pool, k_scale, v_pool, v_scale, pool_pos, block_tables,
           q_pos]
    if any(t.device != q.device for t in ops):
        raise ValueError("paged attention: all operands on one device")
    if k_scale.numel() != n_blocks * bs * h or \
            v_scale.numel() != n_blocks * bs * h:
        raise ValueError("paged attention: scales do not match the pool")
    # the kernel reads each operand as a dense array of its own dtype:
    # (n_blocks, bs, H, 1) scales as (n_blocks, bs, H)
    qs, kp, vp = _dense(q, q.dtype), _dense(k_pool, torch.int32), \
        _dense(v_pool, torch.int32)
    ks, vs = _dense(k_scale, torch.float32), _dense(v_scale, torch.float32)
    pp, bt, qp = (_dense(t, torch.int32)
                  for t in (pool_pos, block_tables, q_pos))
    out = torch.empty((b, h, gq, d), dtype=q.dtype, device=q.device)
    n_split = paged_splits(b, h, gq, nb)
    # split-KV partials: (m, l) and acc of every row, per range of entries
    ws = torch.empty(n_split * b * h * gq * (d + 2), dtype=torch.float32,
                     device=q.device) if n_split > 1 else None
    fn = _lib()
    err = fn(qs.data_ptr(), kp.data_ptr(), ks.data_ptr(), vp.data_ptr(),
             vs.data_ptr(), pp.data_ptr(), bt.data_ptr(), qp.data_ptr(),
             out.data_ptr(), 0 if ws is None else ws.data_ptr(), b, h, gq,
             d, dw, n_bits, bs, nb, int(causal),
             int(window) if window is not None else 0,
             float(1.0 / math.sqrt(d)), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    LAUNCHES += 1
    return out


def _contiguous_lib(name: str):
    lib = _build.load("flash_attention")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptr = 9 if name == "repro_flash_attention_quantized" else 7
        n_int = 9 if name == "repro_flash_attention_quantized" else 7
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.cache
def quantized_splits(b: int, h: int, sq: int, t: int) -> int:
    """How many ranges of the ring's 32-slot tiles K6's C entry splits
    this shape into (its own choice, from its grid and T; builds the
    library)."""
    fn = _build.load("flash_attention").repro_flash_attention_quantized_splits
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = int(fn(b, h, sq, t))
    if n < 1:
        raise RuntimeError(f"ring attention split plan: cudaError_t {-n}")
    return n


def float_splits(bh: int, sq: int, t: int, dtype) -> int:
    """How many ranges of T K7's C entry splits this shape into (its own
    choice, from BH and T; 1 for f32 inputs)."""
    fn = _build.load("flash_attention").repro_flash_attention_splits
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    return int(fn(bh, 1, sq, t, _DTYPES[dtype]))


def _check_positions(q_pos, kv_pos, b, sq, t, dev):
    if tuple(q_pos.shape) != (b, sq) or tuple(kv_pos.shape) != (b, t):
        raise ValueError(f"positions {tuple(q_pos.shape)}/"
                         f"{tuple(kv_pos.shape)} do not match B={b}, "
                         f"Sq={sq}, T={t}")
    if q_pos.device != dev or kv_pos.device != dev:
        raise ValueError("attention: all operands on one device")
    return (q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


def flash_attention_quantized(q, k_packed, k_scale, v_packed, v_scale,
                              q_pos, kv_pos, *, d: int, causal: bool = True,
                              window=None) -> torch.Tensor:
    """Attention of ``q (B, H, Sq, d)`` over a contiguous packed KV cache
    in its own layout: planes ``(B, T, H, n_bits, Dw)`` int32 words,
    scales ``(B, T, H, 1)`` f32, ``q_pos (B, Sq)``, ``kv_pos (B, T)``
    int32 (-1 = empty slot).  The reference's folded ``(BH, ...)``
    layout is ``H = 1``.  Returns ``(B, H, Sq, d)`` in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_quantized_plain(
            q, k_packed, k_scale, v_packed, v_scale, q_pos, kv_pos, d=d,
            causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    global QUANTIZED_LAUNCHES
    b, h, sq, dq = q.shape
    _, t, hp, n_bits, dw = k_packed.shape
    if (k_packed.shape[0], hp, dq) != (b, h, d) or d > dw * 32 or \
            tuple(v_packed.shape) != tuple(k_packed.shape):
        raise ValueError(f"q {tuple(q.shape)} vs cache "
                         f"{tuple(k_packed.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention: q dtype {q.dtype}")
    if dw > 8 or not 1 <= n_bits <= 8:
        raise ValueError(f"attention kernel takes head dim <= 256 and 1..8 "
                         f"bits; got Dw={dw}, n_bits={n_bits}")
    dev = q.device
    if any(x.device != dev for x in (k_packed, k_scale, v_packed, v_scale)):
        raise ValueError("attention: all operands on one device")
    qp, kp = _check_positions(q_pos, kv_pos, b, sq, t, dev)
    qs = q.contiguous()
    ks = k_scale.reshape(b, t, h).to(torch.float32).contiguous()
    vs = v_scale.reshape(b, t, h).to(torch.float32).contiguous()
    kq, vq = k_packed.contiguous(), v_packed.contiguous()
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
    n_split = quantized_splits(b, h, sq, t)
    # split-KV partials: (m, l) and acc of every row, per range of tiles
    ws = torch.empty(n_split * b * h * sq * (d + 2), dtype=torch.float32,
                     device=dev) if n_split > 1 else None
    err = _contiguous_lib("repro_flash_attention_quantized")(
        qs.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), b, h, sq, t, d, dw, n_bits,
        int(causal),
        int(window) if window is not None else 0,
        float(1.0 / math.sqrt(d)), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention_quantized")
    QUANTIZED_LAUNCHES += 1
    return out


def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window=None) -> torch.Tensor:
    """Float online-softmax attention in the folded layout: ``q (BH, Sq,
    D)``, ``k``/``v`` ``(BH, T, D)`` of q's dtype, ``q_pos (BH, Sq)``,
    ``kv_pos (BH, T)`` int32 (-1 = empty slot).  Returns ``(BH, Sq,
    D)``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    global FLOAT_LAUNCHES
    bh, sq, d = q.shape
    t = k.shape[1]
    if tuple(k.shape) != (bh, t, d) or tuple(v.shape) != (bh, t, d):
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if d > 256:
        raise ValueError(f"attention kernel takes head dim <= 256, got {d}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("attention: all operands on one device")
    qp, kp = _check_positions(q_pos, kv_pos, bh, sq, t, dev)
    qs, ks, vs = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=dev)
    n_split = float_splits(bh, sq, t, q.dtype)
    # split-KV partials: (m, l) and acc of every row, per range of T
    ws = torch.empty(n_split * bh * sq * (d + 2), dtype=torch.float32,
                     device=dev) if n_split > 1 else None
    err = _contiguous_lib("repro_flash_attention")(
        qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), out.data_ptr(), 0 if ws is None else ws.data_ptr(),
        bh, 1, sq, t, d, int(causal),
        int(window) if window is not None else 0,
        float(1.0 / math.sqrt(d)), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention")
    FLOAT_LAUNCHES += 1
    return out
