"""K2 wrapper: online-softmax attention over the paged bipolar KV pool
(``csrc/paged_attention.cu``).

Port of the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_paged_quantized``.
The device decides: CPU tensors run the plain version
(:func:`repro_torch.kernels.ref.paged_attention`), CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = 0          # kernel launches since the last reset (chip_smoke)

flash_attention_paged_quantized_plain = ref.paged_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.repro_paged_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    qs = q.contiguous()
    ks = k_scale.reshape(n_blocks, bs, h).to(torch.float32).contiguous()
    vs = v_scale.reshape(n_blocks, bs, h).to(torch.float32).contiguous()
    pp = pool_pos.to(torch.int32).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    qp = q_pos.to(torch.int32).contiguous()
    kp, vp = k_pool.contiguous(), v_pool.contiguous()
    out = torch.empty((b, h, gq, d), dtype=q.dtype, device=q.device)
    fn = _lib()
    err = fn(qs.data_ptr(), kp.data_ptr(), ks.data_ptr(), vp.data_ptr(),
             vs.data_ptr(), pp.data_ptr(), bt.data_ptr(), qp.data_ptr(),
             out.data_ptr(), b, h, gq, d, dw, n_bits, bs, nb, int(causal),
             int(window) if window is not None else 0,
             float(1.0 / math.sqrt(d)), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    LAUNCHES += 1
    return out
