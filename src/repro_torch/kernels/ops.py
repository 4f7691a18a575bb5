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

On the MoE path:

* ``ap_moe_expert_linear`` -- the grouped expert GEMM over the capacity
  dispatch, one launch for all experts (K4, :mod:`repro_torch.kernels.moe`):
  f32 activation quantize, dual gate/up, f32 epilogue with one cast,
  dead capacity rows exact zeros, the live-tile map.
"""

from __future__ import annotations

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
