"""Quantized ops of the port: the signatures and padding rules of the
reference ``repro.kernels.ops``, dispatched by device alone.

A CPU tensor runs the plain torch version of each kernel
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the hand-written
kernel or raises.  There is no implementation switch and no fallback.

Ops on the dense serving path:

* ``quantize_rows`` / ``pack_weight`` -- per-row quantize + bit-plane pack
  (K3, :mod:`repro_torch.kernels.pack`), with the MSE clip search and the
  nested per-width scales for weights;
* ``ap_linear_fused`` -- the one-kernel quantized linear (K1,
  :mod:`repro_torch.kernels.apmm`): activation quantize in the GEMM
  prologue, ``bias``/``act``/dual gate-up/``residual`` epilogue,
  ``w_bits`` nested slicing;
* ``quantize_kv`` / ``dequantize_kv`` / ``fold_kv_heads`` -- the bipolar
  KV format (plain torch ops on every device, as the reference keeps
  them in jnp);
* ``paged_kv_cache_attention`` -- attention over the paged KV pool (K2,
  :mod:`repro_torch.kernels.flash_attention`).

On the contiguous engine's path and the unfused baseline:

* ``ap_matmul`` -- the packed x packed NT GEMM (K5,
  :mod:`repro_torch.kernels.apmm`), raw int32 or dequantized, operands
  of different word widths padded to the common one, ``b_bits`` nested
  slicing;
* ``ap_linear`` -- the unfused quantized linear: K3 packs the
  activations, then K5 multiplies (the fused path's bit-exactness
  oracle);
* ``kv_cache_attention`` -- attention over a contiguous packed KV cache
  in the reference's folded ``(BH, ...)`` layout, and
  ``ring_kv_cache_attention``, the same function over the cache's own
  ``(B, T, H, ...)`` layout, which the serving path reads without
  copying (both K6, :mod:`repro_torch.kernels.flash_attention`).

On the MoE path:

* ``ap_moe_expert_linear`` -- the grouped expert GEMM over the capacity
  dispatch, one launch for all experts (K4, :mod:`repro_torch.kernels.moe`):
  f32 activation quantize, dual gate/up, f32 epilogue with one cast,
  dead capacity rows exact zeros, the live-tile map.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bipolar
from repro_torch.core.bipolar import BipolarTensor
from repro_torch.kernels import apmm as apmm_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import moe as moe_kernel
from repro_torch.kernels import pack as pack_kernel
from repro_torch.kernels import ref


# ---------------------------------------------------------------------------
# Quantize + pack
# ---------------------------------------------------------------------------

def quantize_rows(x: torch.Tensor, n_bits: int, *, pad_bit: int,
                  scale: torch.Tensor | None = None,
                  scale_search: bool = False) -> BipolarTensor:
    """Quantize a row-major ``(R, K)`` matrix to packed bipolar planes.

    Per-row absmax scales (``scale_search=True``: per-row MSE clip search
    plus the nested per-width scales of the any-precision checkpoint);
    K padded to the word boundary with ``pad_bit`` (0 for activations, 1
    for weights).  The pack runs on ``x``'s device: K3 on the card."""
    r, k = x.shape
    if scale is None and scale_search:
        scale = bipolar.mse_scale(x, n_bits, axis=-1)
    if scale is None:
        scale = bipolar.absmax_scale(x, n_bits, axis=-1, keepdims=True)
    scale = scale.float().reshape(r, 1)
    width_scales = None
    if scale_search and n_bits > 1:
        qv = bipolar.quantize_values(x, n_bits, scale)
        width_scales = bipolar.nested_width_scales(x, qv, n_bits, scale)
    packed = pack_kernel.quantize_pack_rows(x.float(), scale, n_bits=n_bits,
                                            pad_bit=pad_bit)
    return BipolarTensor(packed=packed, scale=scale, n_bits=n_bits,
                         shape=(r, k), pack_axis=1,
                         width_scales=width_scales)


def pack_weight(w: torch.Tensor, n_bits: int) -> BipolarTensor:
    """Offline weight preprocessing: ``W (d_out, d_in)`` -> packed, with
    the per-row MSE clip search (once, at load)."""
    return quantize_rows(w, n_bits, pad_bit=1, scale_search=True)


# ---------------------------------------------------------------------------
# Packed x packed GEMM and the unfused quantized linear
# ---------------------------------------------------------------------------

_ALL_ONES = -1            # the word 0xFFFFFFFF in int32 storage


def _pad_words(packed: torch.Tensor, kw: int, word: int) -> torch.Tensor:
    pad = kw - packed.shape[-1]
    if pad <= 0:
        return packed
    return torch.cat([packed, torch.full(packed.shape[:-1] + (pad,), word,
                                         dtype=packed.dtype,
                                         device=packed.device)], -1)


def _normalize_packed_kw(a: BipolarTensor, b: BipolarTensor) -> tuple:
    """Pad operands packed to different K word widths to the common one.

    Both describe the same logical K.  A pads with all-zero words (its
    pad bit 0), B with all-one words (pad bit 1): the pad conventions
    the closed-form K-pad correction accounts for, so the product is
    unchanged."""
    assert a.shape[-1] == b.shape[-1], \
        f"reduction dims differ: {a.shape} vs {b.shape}"
    kw = max(a.packed.shape[-1], b.packed.shape[-1])
    if a.packed.shape[-1] < kw:
        a = dataclasses.replace(a, packed=_pad_words(a.packed, kw, 0))
    if b.packed.shape[-1] < kw:
        b = dataclasses.replace(b, packed=_pad_words(b.packed, kw,
                                                     _ALL_ONES))
    return a, b


def ap_matmul(a: BipolarTensor, b: BipolarTensor, *,
              variant: str = "fused", out_dtype=torch.float32,
              raw: bool = False, b_bits: int | None = None) -> torch.Tensor:
    """NT GEMM of packed tensors: ``Y (M, N) = A (M, K) @ B (N, K)^T``.

    ``raw=True`` returns the exact int32 product of the bipolar integer
    values (no scale dequant).  ``b_bits`` serves a nested B operand at a
    lower width: only its top ``b_bits`` planes reach the kernel."""
    if b_bits is not None:
        b = bipolar.nested_slice(b, b_bits)
    a, b = _normalize_packed_kw(a, b)
    return apmm_kernel.apmm_packed(a, b, variant=variant,
                                   out_dtype=None if raw else out_dtype)


def ap_linear(x: torch.Tensor, w: BipolarTensor, *, a_bits: int,
              variant: str = "fused", out_dtype=None,
              w_bits: int | None = None) -> torch.Tensor:
    """Unfused quantized linear ``y (..., N) = x (..., K) @ W (N, K)^T``:
    the activations are quantized per row (absmax in the input dtype)
    and packed by K3, then K5 multiplies the two packed operands and
    dequantizes.  ``w_bits`` serves a nested weight at a lower width."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k = x.shape[-1]
    xq = quantize_rows(x.reshape(-1, k), a_bits, pad_bit=0)
    y = ap_matmul(xq, w, variant=variant, out_dtype=out_dtype,
                  b_bits=w_bits)
    return y.reshape(*lead, w.shape[0])


# ---------------------------------------------------------------------------
# Fused quantized linear
# ---------------------------------------------------------------------------

def ap_linear_fused(x: torch.Tensor, w: BipolarTensor, *, a_bits: int,
                    w2: BipolarTensor | None = None,
                    bias: torch.Tensor | None = None,
                    act: str = "none",
                    residual: torch.Tensor | None = None,
                    variant: str = "fused",
                    out_dtype=None, w_bits: int | None = None
                    ) -> torch.Tensor:
    """One-kernel quantized linear ``y (..., N) = epi(x (..., K) @ W (N,
    K)^T)``, epilogue ``act(y + bias) [* (x @ W2^T)] [+ residual]``.

    ``w_bits`` serves nested weights at a lower width (both operands are
    plane-prefix sliced, so the kernel streams only ``w_bits`` planes).
    The activation scale is the per-row absmax in the INPUT dtype, then
    cast to f32, exactly as the reference computes it."""
    out_dtype = out_dtype or x.dtype
    if w_bits is not None:
        w = bipolar.nested_slice(w, w_bits)
        if w2 is not None:
            w2 = bipolar.nested_slice(w2, w_bits)
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[0]
    assert w.shape[-1] == k, (tuple(x.shape), w.shape)
    if w2 is not None:
        assert w2.shape == w.shape and w2.n_bits == w.n_bits, \
            (w.shape, w2.shape)
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    res2 = residual.reshape(m, n) if residual is not None else None
    scale = bipolar.absmax_scale(x2, a_bits, axis=-1, keepdims=True).float()
    y = apmm_kernel.apmm_fused_linear(
        x2, scale, w, w2=w2, bias=bias, residual=res2, a_bits=a_bits,
        variant=variant, act=act, out_dtype=out_dtype)
    return y.reshape(*lead, n)


# ---------------------------------------------------------------------------
# Grouped MoE expert linear
# ---------------------------------------------------------------------------

def moe_row_tile(seg: int) -> int:
    """Rows per live-map tile of a ``seg``-row segment:
    ``min(256, round_up(seg, 8))``, the reference's tile geometry (its
    ``DEFAULT_BM`` is 256)."""
    return min(256, -(-seg // 8) * 8)


def ap_moe_expert_linear(x: torch.Tensor, w: BipolarTensor, *,
                         counts: torch.Tensor, a_bits: int,
                         w2: BipolarTensor | None = None,
                         act: str = "none", variant: str = "fused",
                         out_dtype=None, with_stats: bool = False,
                         w_bits: int | None = None):
    """Grouped quantized MoE expert linear, one launch for all experts.

    ``y (E, C, N) = epi(Q(x) (E, C, K) @ W (E, N, K)^T)`` where ``C = G
    * seg`` capacity rows per expert hold ``G`` dispatch-group segments
    whose live tokens form a prefix of length ``counts[e, g]``
    (``counts (E, G)`` int32).  Activations are quantized per row in f32
    from the materialised input (absmax of the upcast rows, division in
    f32), the epilogue composes in f32 with one cast, and rows at or
    beyond a segment's count are exact zeros.  ``w2`` is the dual
    gate/up mode (``act(x @ W^T) * (x @ W2^T)``); ``w_bits`` serves
    nested expert weights at a lower width.  ``with_stats=True`` also
    returns the ``(E*G, n_row_tiles)`` int32 live map (analytic for CPU
    tensors, the kernel's own for CUDA tensors)."""
    out_dtype = out_dtype or x.dtype
    if w_bits is not None:
        w = bipolar.nested_slice(w, w_bits)
        if w2 is not None:
            w2 = bipolar.nested_slice(w2, w_bits)
    e, c, k = x.shape
    g = counts.shape[1]
    assert c % g == 0, (c, g)
    n = w.shape[1]
    assert w.shape == (e, n, k), (tuple(x.shape), w.shape)
    if w2 is not None:
        assert w2.shape == w.shape and w2.n_bits == w.n_bits, \
            (w.shape, w2.shape)
    x = x.contiguous()
    a_scale = bipolar.absmax_scale(x.float(), a_bits, axis=-1,
                                   keepdims=True)            # (E, C, 1) f32
    y, live = moe_kernel.moe_expert_linear(
        x, a_scale, counts.to(torch.int32).contiguous(), w, w2=w2,
        a_bits=a_bits, variant=variant, act=act, out_dtype=out_dtype,
        bc=moe_row_tile(c // g))
    return (y, live) if with_stats else y


# ---------------------------------------------------------------------------
# Bipolar-quantized KV cache
# ---------------------------------------------------------------------------

fold_kv_heads = ref.fold_kv_heads
dequantize_kv = ref.dequantize_kv


def quantize_kv(x: torch.Tensor, kv_bits: int):
    """K/V ``(..., D)`` -> packed planes ``(..., kv_bits, ceil(D/32))``
    int32 words + per-(token, head) scales ``(..., 1)`` f32."""
    xf = x.float()
    scale = bipolar.absmax_scale(xf, kv_bits, axis=-1, keepdims=True)
    q = bipolar.quantize_values(xf, kv_bits, scale)
    planes = bipolar.pad_for_packing(bipolar.decompose(q, kv_bits), -1, 0)
    packed = bipolar.pack_planes(planes, -1)            # (kv_bits, ..., Dw)
    return torch.movedim(packed, 0, -2), scale


def kv_cache_attention(q: torch.Tensor,
                       k_packed: torch.Tensor, k_scale: torch.Tensor,
                       v_packed: torch.Tensor, v_scale: torch.Tensor,
                       q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                       d: int, causal: bool = True,
                       window=None) -> torch.Tensor:
    """Attention over a packed bipolar KV cache, folded ``(BH, ...)``
    layout: ``q (BH, Sq, d)``; ``k_packed``/``v_packed`` ``(BH, T,
    n_bits, Dw)`` int32 words; ``k_scale``/``v_scale`` ``(BH, T, 1)``
    f32; ``q_pos (BH, Sq)``, ``kv_pos (BH, T)`` int32, negative = empty
    slot.  The head dim pads to the word boundary inside the kernel."""
    return flash_kernel.flash_attention_quantized(
        q[:, None], k_packed[:, :, None], k_scale[:, :, None],
        v_packed[:, :, None], v_scale[:, :, None], q_pos, kv_pos, d=d,
        causal=causal, window=window)[:, 0]


def ring_kv_cache_attention(qg: torch.Tensor,
                            k_packed: torch.Tensor, k_scale: torch.Tensor,
                            v_packed: torch.Tensor, v_scale: torch.Tensor,
                            q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                            d: int, causal: bool = True,
                            window=None) -> torch.Tensor:
    """:func:`kv_cache_attention` of grouped queries ``qg (B, H, G, d)``
    over a contiguous cache in its own layout -- planes ``(B, T, H,
    n_bits, Dw)``, scales ``(B, T, H, 1)``, ``q_pos (B, G)``, ``kv_pos
    (B, T)`` -- which equals folding the heads into the batch first,
    without the copy the fold would make.  Returns ``(B, H, G, d)``."""
    return flash_kernel.flash_attention_quantized(
        qg, k_packed, k_scale, v_packed, v_scale, q_pos, kv_pos, d=d,
        causal=causal, window=window)


def paged_kv_cache_attention(q: torch.Tensor,
                             k_pool: torch.Tensor, k_scale: torch.Tensor,
                             v_pool: torch.Tensor, v_scale: torch.Tensor,
                             pool_pos: torch.Tensor,
                             block_tables: torch.Tensor,
                             q_pos: torch.Tensor, *,
                             d: int, causal: bool = True,
                             window=None) -> torch.Tensor:
    """Attention over the paged packed bipolar KV pool via a block table.

    ``q (B, H, Gq, D)`` per-kv-head grouped queries (``Gq`` = GQA group
    size, times the suffix length for chunked prefill); pools
    ``(n_blocks, bs, H, n_bits, Dw)`` int32 words, scales ``(n_blocks,
    bs, H, 1)`` f32, ``pool_pos (n_blocks, bs)`` int32 (-1 = empty),
    ``block_tables (B, NB)`` (pad entries point at the null block 0),
    ``q_pos (B, Gq)`` (-1 rows are fully masked and return 0).  The head
    dim pads to the packed word boundary inside the kernel (zero q
    columns)."""
    return flash_kernel.flash_attention_paged_quantized(
        q, k_pool, k_scale, v_pool, v_scale, pool_pos, block_tables, q_pos,
        d=d, causal=causal, window=window)
