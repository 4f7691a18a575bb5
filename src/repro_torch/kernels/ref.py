"""Plain torch versions of the hand-written kernels (and their helpers).

Each function here computes exactly what one CUDA kernel of
``repro_torch/csrc`` computes, in plain torch ops on whatever device its
inputs lie on.  The kernel wrappers run these for CPU tensors (the CPU
tests hold them against the reference JAX package), and ``chip_smoke.py``
holds every kernel against its plain version on the card.

GEMM convention (shared with the kernels): ``Y (M, N) = A (M, K) @ B (N,
K)^T``, weights packed along K with pad bit 1.

Exact integer GEMMs run as float64 matmuls of small integers: every
partial sum is an integer below 2^53 in magnitude (asserted), so the f64
result is exact on the CPU and on the card alike, where torch has no
int64 or general int8 matmul.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import bipolar
from repro_torch.core.bipolar import BipolarTensor


def plane_groups(n_bits: int, group: int = 7):
    """Split ``n_bits`` planes into balanced groups of <= ``group`` bits
    (a group's recombined value fits int8 while its size is <= 7).
    Returns ``[(lo, size), ...]``."""
    n_groups = -(-n_bits // group)
    base, extra = divmod(n_bits, n_groups)
    out, lo = [], 0
    for g in range(n_groups):
        size = base + (1 if g < extra else 0)
        out.append((lo, size))
        lo += size
    return out


def int_matmul_nt(a: torch.Tensor, b: torch.Tensor, bound: int) -> torch.Tensor:
    """Exact int32 ``a (M, K) @ b (N, K)^T`` of integer tensors whose
    products are at most ``bound`` in magnitude."""
    assert a.shape[-1] * bound < 2 ** 53, (a.shape, bound)
    y = a.to(torch.float64) @ b.to(torch.float64).T
    return y.to(torch.int64).to(torch.int32)


def apmm_fused(a_values: torch.Tensor, b_values: torch.Tensor,
               n_a: int, n_b: int) -> torch.Tensor:
    """Operand-level recovery: one exact integer GEMM per pair of <=7-bit
    plane groups, shift-added (``sum_ij 2^{lo_i+lo_j} A_i B_j^T``)."""
    ua = bipolar.encode(a_values, n_a)
    ub = bipolar.encode(b_values, n_b)
    y = None
    for lo_a, sz_a in plane_groups(n_a):
        va = (((ua >> lo_a) & ((1 << sz_a) - 1)) << 1) - ((1 << sz_a) - 1)
        for lo_b, sz_b in plane_groups(n_b):
            vb = (((ub >> lo_b) & ((1 << sz_b) - 1)) << 1) - ((1 << sz_b) - 1)
            yij = int_matmul_nt(va, vb, bipolar.max_value(sz_a)
                                * bipolar.max_value(sz_b))
            yij = yij << (lo_a + lo_b)
            y = yij if y is None else y + yij
    return y


def apmm_bitserial(a_values: torch.Tensor, b_values: torch.Tensor,
                   n_a: int, n_b: int) -> torch.Tensor:
    """Paper-faithful: n_a * n_b one-bit (+-1) GEMMs, shift-add recovery."""
    a_s = 2 * bipolar.decompose(a_values, n_a).to(torch.int32) - 1
    b_s = 2 * bipolar.decompose(b_values, n_b).to(torch.int32) - 1
    y = torch.zeros((a_values.shape[0], b_values.shape[0]), dtype=torch.int32,
                    device=a_values.device)
    for i in range(n_a):
        for j in range(n_b):
            y = y + (int_matmul_nt(a_s[i], b_s[j], 1) << (i + j))
    return y


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """Epilogue activation: silu, gelu (tanh form, as ``jax.nn.gelu``)."""
    if act == "silu":
        return F.silu(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    assert act == "none", act
    return y


def _linear_int_core(q: torch.Tensor, w: BipolarTensor, n_a: int,
                     variant: str) -> torch.Tensor:
    """Exact int32 NT GEMM of activation *values* ``q (M, K)`` against a
    packed weight, K-pad corrected: pad columns of the weight decode to
    ``+maxw`` and of the activation to ``-maxa``, and the closed-form
    correction removes their product."""
    k = w.shape[-1]
    assert q.shape[-1] == k, (q.shape, w.shape)
    kp = w.packed.shape[-1] * bipolar.PACK_WIDTH
    vals = bipolar.recover(bipolar.unpack_planes(w.packed, -1, kp), w.n_bits)
    if kp > k:
        q = F.pad(q, (0, kp - k), value=-bipolar.max_value(n_a))
    if variant == "fused":
        y = apmm_fused(q, vals, n_a, w.n_bits)
    else:
        y = apmm_bitserial(q, vals, n_a, w.n_bits)
    return y + bipolar.pad_correction(k, w.n_bits, n_a)


def ap_linear_fused_ref(x2: torch.Tensor, a_scale: torch.Tensor,
                        w: BipolarTensor, *, w2=None, bias=None,
                        residual=None, a_bits: int, variant: str = "fused",
                        act: str = "none",
                        out_dtype=torch.float32) -> torch.Tensor:
    """Plain fused quantized linear: quantize activations to values,
    integer GEMM(s), then the epilogue with the kernel's cast points --
    f32 dequant, ``+bias``, cast, act in f32 (dual: ``act(Y1) * Y2``),
    cast, ``+residual`` in the output dtype."""
    q = bipolar.quantize_values(x2.float(), a_bits, a_scale)
    a_s = a_scale.reshape(-1, 1).float()
    yf = _linear_int_core(q, w, a_bits, variant).float() * a_s \
        * w.scale.reshape(1, -1)
    if bias is not None:
        yf = yf + bias.reshape(1, -1).float()
    yo = yf.to(out_dtype)
    if w2 is not None:
        y2 = _linear_int_core(q, w2, a_bits, variant).float() * a_s \
            * w2.scale.reshape(1, -1)
        h = apply_act(yo.float(), act) * y2.to(out_dtype).float()
        yo = h.to(out_dtype)
    elif act != "none":
        yo = apply_act(yo.float(), act).to(out_dtype)
    if residual is not None:
        yo = yo + residual.to(out_dtype)
    return yo


def quantize_pack_rows(x: torch.Tensor, scale: torch.Tensor, *, n_bits: int,
                       pad_bit: int) -> torch.Tensor:
    """Per-row quantize ``x (R, K)`` with ``scale (R, 1)``, decompose into
    bit planes and pack along K: ``(n_bits, R, ceil(K/32))`` int32 words,
    K padded with ``pad_bit``."""
    q = bipolar.quantize_values(x.float(), n_bits, scale.reshape(-1, 1))
    planes = bipolar.pad_for_packing(bipolar.decompose(q, n_bits), -1,
                                     pad_bit)
    return bipolar.pack_planes(planes, -1)


# ---------------------------------------------------------------------------
# Paged bipolar-KV attention
# ---------------------------------------------------------------------------

def gather_paged_kv(pool_leaf: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """``pool_leaf (n_blocks, bs, ...)`` + ``block_tables (B, NB)`` ->
    ``(B, NB*bs, ...)``: request ``b``'s logical token ``t`` is block
    ``t // bs``, slot ``t % bs`` of its table row."""
    b, nb = block_tables.shape
    bs = pool_leaf.shape[1]
    g = pool_leaf[block_tables.reshape(-1).long()]
    return g.reshape((b, nb * bs) + tuple(pool_leaf.shape[2:]))


def dequantize_kv(packed: torch.Tensor, scale: torch.Tensor, d: int,
                  dtype=torch.float32) -> torch.Tensor:
    """Planes ``(..., n_bits, Dw)`` + scale ``(..., 1)`` -> ``(..., D)``."""
    n_bits = packed.shape[-2]
    planes = torch.movedim(packed, -2, 0)
    vals = bipolar.recover(bipolar.unpack_planes(planes, -1, d), n_bits)
    return (vals.float() * scale).to(dtype)


def position_mask(qpos, kpos, causal: bool, window):
    valid = kpos >= 0
    if causal:
        valid = valid & (kpos <= qpos)
    if window is not None:
        valid = valid & (kpos > qpos - window)
    return valid


def attention_reference(q, k, v, q_pos, kv_pos, *, causal=True,
                        window=None):
    """Direct-softmax attention in the folded ``(BH, S, D)`` layout;
    fully masked rows return 0 (denominator clamp)."""
    d = q.shape[-1]
    s = torch.einsum("bqd,btd->bqt", q.float(), k.float()) / math.sqrt(d)
    valid = position_mask(q_pos[:, :, None], kv_pos[:, None, :], causal,
                          window)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = torch.clamp(torch.amax(s, -1, keepdim=True), min=-1e30)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    o = torch.einsum("bqt,btd->bqd", p, v.float())
    o = o / torch.clamp(p.sum(-1, keepdim=True), min=1e-20)
    return o.to(q.dtype)


def fold_kv_heads(a: torch.Tensor) -> torch.Tensor:
    """``(B, T, H, ...) -> (BH, T, ...)``."""
    b, t, h = a.shape[:3]
    perm = (0, 2, 1) + tuple(range(3, a.ndim))
    return a.permute(perm).reshape((b * h, t) + tuple(a.shape[3:]))


def paged_attention(q, k_pool, k_scale, v_pool, v_scale, pool_pos,
                    block_tables, q_pos, *, d: int, causal: bool = True,
                    window=None) -> torch.Tensor:
    """Plain paged attention: gather the request's blocks through its
    table, dequantize, and run :func:`attention_reference`.
    ``q (B, H, Gq, d)`` -> ``(B, H, Gq, d)``."""
    b, h, g, _ = q.shape

    def gath(leaf):
        return gather_paged_kv(leaf, block_tables)

    kv_pos = gath(pool_pos[:, :, None])[..., 0]
    k = dequantize_kv(fold_kv_heads(gath(k_pool)),
                      fold_kv_heads(gath(k_scale)), d)
    v = dequantize_kv(fold_kv_heads(gath(v_pool)),
                      fold_kv_heads(gath(v_scale)), d)
    o = attention_reference(
        q.reshape(b * h, g, q.shape[-1]), k, v,
        torch.repeat_interleave(q_pos, h, 0),
        torch.repeat_interleave(kv_pos, h, 0), causal=causal, window=window)
    return o.reshape(b, h, g, d)
