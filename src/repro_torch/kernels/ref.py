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


def silu_f32(y: torch.Tensor) -> torch.Tensor:
    """SiLU as the reference writes it, ``y * logistic(y)``: it matches
    XLA's f32 bits in 99.5% of values, ``F.silu``'s ``y / (1 + exp(-y))``
    in 73-74%.  Every SiLU of the port's plain code uses this one form,
    so the fused (K1) and unfused SwiGLU agree bit for bit on the CPU."""
    return y * torch.sigmoid(y)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once: the f32 product is exact in f64;
    the f64 sum rounds before the f32 cast only where its exact value
    needs more than 53 bits, and then lands on an f32 midpoint in ~2^-29
    of such cases."""
    a64 = a.double()
    b64 = b.double() if torch.is_tensor(b) else b
    c64 = c.double() if torch.is_tensor(c) else c
    return (a64 * b64 + c64).float()


def f32(v: float) -> float:
    """``v`` rounded to the nearest f32 (a constant of an f32 op)."""
    return torch.tensor(v, dtype=torch.float32).item()


# XLA:CPU lowers an f32 tanh to Eigen's rational approximation: the input
# clamped to +-7.99881172180176 (the FMA build's bound), then x P(x^2) /
# Q(x^2) by Horner steps that contract to FMAs, and x itself below 4e-4
_TANH_NUM = tuple(f32(c) for c in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03))
_TANH_DEN = tuple(f32(c) for c in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03))
_TANH_CLAMP = f32(7.99881172180176)
_SQRT_2_OVER_PI = f32(math.sqrt(2.0 / math.pi))


def tanh_f32(y: torch.Tensor) -> torch.Tensor:
    """f32 tanh in XLA:CPU's steps (its bits on 1.2M test values;
    ``torch.tanh`` differs in half of them)."""
    x = torch.clamp(y, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = x * x
    p = torch.full_like(x, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        p = fma_f32(x2, p, c)
    q = torch.full_like(x, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        q = fma_f32(x2, q, c)
    return torch.where(y.abs() < f32(0.0004), y, (x * p) / q)


def gelu_f32(y: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form), ``y (0.5 (1 + tanh(sqrt(2/pi) (y +
    0.044715 y^3))))``, in XLA:CPU's f32 steps: ``y^3`` as ``y (y y)``,
    the inner add contracted to an FMA, and :func:`tanh_f32`.  It gives
    XLA's bits where ``F.gelu(approximate="tanh")`` differs in a third
    of f32 values (3% after the cast to bf16)."""
    inner = fma_f32(y * (y * y), f32(0.044715), y)
    return y * (0.5 * (1.0 + tanh_f32(_SQRT_2_OVER_PI * inner)))


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """Epilogue activation: silu, gelu (tanh form, as ``jax.nn.gelu``)."""
    if act == "silu":
        return silu_f32(y)
    if act == "gelu":
        return gelu_f32(y)
    assert act == "none", act
    return y


def _plane_bits(words: torch.Tensor) -> torch.Tensor:
    """One packed plane ``(..., Kw)`` int32 -> its bits ``(..., Kw*32)``
    uint8, element ``32w + b`` from bit b of word w (the words' bytes
    read little-endian, one byte per 8 elements)."""
    by = words.contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    return ((by[..., None] >> shifts) & 1).flatten(-2)


def _packed_group_values(packed: torch.Tensor, n_bits: int, group: int):
    """Plane-group values of a packed operand ``(n_bits, ..., Kw)`` read
    straight off its words: ``[(lo, v, size)]`` with ``v = 2 *
    sum_i plane_{lo+i} 2^i - (2^size - 1)`` (int16), one entry per group
    of :func:`plane_groups` (``group=1``: the bit-serial ±1 planes) --
    the values :func:`apmm_fused` and :func:`apmm_bitserial` derive from
    the recovered integers, without materializing them."""
    out = []
    for lo, size in plane_groups(n_bits, group):
        v = None
        for i in range(size):
            b = _plane_bits(packed[lo + i]).to(torch.int16) << (i + 1)
            v = b if v is None else v + b
        out.append((lo, v - ((1 << size) - 1), size))
    return out


def _linear_int_core(q: torch.Tensor, w: BipolarTensor, n_a: int,
                     variant: str) -> torch.Tensor:
    """Exact int32 NT GEMM of activation *values* ``q (M, K)`` against a
    packed weight, K-pad corrected: pad columns of the weight decode to
    ``+maxw`` and of the activation to ``-maxa``, and the closed-form
    correction removes their product.  ``fused``: one GEMM per pair of
    <=7-bit plane groups; ``bitserial``: one ±1 GEMM per bit pair."""
    k = w.shape[-1]
    assert q.shape[-1] == k, (q.shape, w.shape)
    kp = w.packed.shape[-1] * bipolar.PACK_WIDTH
    if kp > k:
        q = F.pad(q, (0, kp - k), value=-bipolar.max_value(n_a))
    group = 7 if variant == "fused" else 1
    ua = bipolar.encode(q, n_a)
    ga = [(lo, ((((ua >> lo) & ((1 << sz) - 1)) << 1)
                - ((1 << sz) - 1)).to(torch.float64), sz)
          for lo, sz in plane_groups(n_a, group)]
    y = None
    for lo_b, vb, sz_b in _packed_group_values(w.packed, w.n_bits, group):
        vb = vb.to(torch.float64).T          # one conversion a weight group
        for lo_a, va, sz_a in ga:
            assert kp * bipolar.max_value(sz_a) * bipolar.max_value(sz_b) \
                < 2 ** 53
            yij = (va @ vb).to(torch.int64).to(torch.int32) << (lo_a + lo_b)
            y = yij if y is None else y + yij
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
    return linear_epilogue(
        _linear_int_core(q, w, a_bits, variant), a_scale, w.scale,
        y2=None if w2 is None else _linear_int_core(q, w2, a_bits, variant),
        w2_scale=None if w2 is None else w2.scale, bias=bias, act=act,
        residual=residual, out_dtype=out_dtype)


def linear_epilogue(y: torch.Tensor, a_scale: torch.Tensor,
                    w_scale: torch.Tensor, *, y2=None, w2_scale=None,
                    bias=None, act: str = "none", residual=None,
                    out_dtype=torch.float32) -> torch.Tensor:
    """K1's epilogue on the exact int32 products ``y (M, N)`` (and the
    dual's ``y2``), in the kernel's order: f32 dequant ``(y * a_s) *
    w_s``, ``+bias``, cast, act in f32 (dual: ``act(Y1) * Y2``), cast,
    ``+residual`` in the output dtype.  The fused linear's plain version
    and the tensor-parallel row product (an int32 sum of K-shard
    products) both end here."""
    a_s = a_scale.reshape(-1, 1).float()
    yf = y.float() * a_s * w_scale.reshape(1, -1)
    if bias is not None:
        yf = yf + bias.reshape(1, -1).float()
    yo = yf.to(out_dtype)
    if y2 is not None:
        y2f = y2.float() * a_s * w2_scale.reshape(1, -1)
        h = apply_act(yo.float(), act) * y2f.to(out_dtype).float()
        yo = h.to(out_dtype)
    elif act != "none":
        yo = apply_act(yo.float(), act).to(out_dtype)
    if residual is not None:
        yo = yo + residual.to(out_dtype)
    return yo


# ---------------------------------------------------------------------------
# Packed x packed GEMM (the unfused quantized linear's second half)
# ---------------------------------------------------------------------------

def unpack_values(t: BipolarTensor) -> torch.Tensor:
    """Packed ``(n_bits, R, Kw)`` -> bipolar integer values ``(R,
    Kw*32)``; pad columns decode to ``-max`` (pad bit 0) or ``+max``
    (pad bit 1)."""
    kp = t.packed.shape[-1] * bipolar.PACK_WIDTH
    return bipolar.recover(bipolar.unpack_planes(t.packed, -1, kp), t.n_bits)


def apmm_packed(a: BipolarTensor, b: BipolarTensor, *,
                variant: str = "fused") -> torch.Tensor:
    """Exact int32 NT GEMM of two packed operands of one word width:
    ``A (M, K)`` packed with pad bit 0, ``B (N, K)`` with pad bit 1.
    Every pad column contributes ``-maxA * maxB``; the closed-form
    correction ``n_pad * maxA * maxB`` removes it."""
    (m, k), (n, k2) = a.shape, b.shape
    assert k == k2, (a.shape, b.shape)
    kw = a.packed.shape[-1]
    assert b.packed.shape[-1] == kw, (a.packed.shape, b.packed.shape)
    core = apmm_fused if variant == "fused" else apmm_bitserial
    y = core(unpack_values(a), unpack_values(b), a.n_bits, b.n_bits)
    n_pad = kw * bipolar.PACK_WIDTH - k
    return y + n_pad * bipolar.max_value(a.n_bits) \
        * bipolar.max_value(b.n_bits)


def apmm_dequant(a: BipolarTensor, b: BipolarTensor, *,
                 variant: str = "fused",
                 out_dtype=torch.float32) -> torch.Tensor:
    """:func:`apmm_packed` dequantized: ``(y.f32 * a_scale) * b_scale``
    (per row of A, per row of B), then one cast."""
    y = apmm_packed(a, b, variant=variant).float()
    y = y * a.scale.reshape(-1, 1).float() * b.scale.reshape(1, -1).float()
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# Grouped MoE expert linear
# ---------------------------------------------------------------------------

def expert_weight(w: BipolarTensor, e: int) -> BipolarTensor:
    """Expert ``e`` of a stacked expert weight (packed ``(n_bits, E, N,
    Kw)``, scale ``(E, N, 1)``) as a 2-D packed weight ``(N, K)``."""
    return BipolarTensor(packed=w.packed[:, e], scale=w.scale[e],
                         n_bits=w.n_bits, shape=tuple(w.shape[1:]),
                         pack_axis=1)


def moe_expert_int_core(q: torch.Tensor, w: BipolarTensor, n_a: int,
                        variant: str, live: torch.Tensor) -> torch.Tensor:
    """Exact int32 batched expert NT GEMM ``(E, C, K) x (E, N, K) -> (E,
    C, N)`` of activation *values* against a stacked packed expert
    weight, K-pad corrected, one expert at a time (each the 2-D core of
    :func:`ap_linear_fused_ref`; the integers are exact, so the order
    of experts is immaterial).  Only the experts ``live`` (a bool per
    expert) marks are computed; the rows of the others come back 0."""
    y = torch.zeros(q.shape[:2] + (w.shape[1],), dtype=torch.int32,
                    device=q.device)
    for e, keep in enumerate(live.tolist()):
        if keep:
            y[e] = _linear_int_core(q[e], expert_weight(w, e), n_a, variant)
    return y


def moe_live_map(counts: torch.Tensor, seg: int, bc: int) -> torch.Tensor:
    """``(E*G, n_row_tiles)`` int32: 1 where a ``bc``-row tile of a
    segment starts below the segment's live-row count."""
    n_ci = -(-seg // bc)
    starts = torch.arange(n_ci, dtype=torch.int32, device=counts.device) * bc
    return (counts.reshape(-1, 1) > starts[None, :]).to(torch.int32)


def ap_moe_expert_linear_ref(x: torch.Tensor, a_scale: torch.Tensor,
                             counts: torch.Tensor, w: BipolarTensor, *,
                             w2: BipolarTensor | None = None, a_bits: int,
                             variant: str = "fused", act: str = "none",
                             out_dtype=None) -> torch.Tensor:
    """Plain grouped expert linear ``y (E, C, N) = epi(Q(x (E, C, K)) @
    W (E, N, K)^T)``: quantize in f32 with the per-row f32 scales
    ``a_scale (E, C, 1)``, the exact int core per weight, dequantize in
    f32 as ``(int * a_s) * w_s``, ``act(Y1) * Y2`` in f32 (dual), ONE
    cast to the output dtype, and exact zeros in every row at or beyond
    its segment's count (``counts (E, G)``: ``C = G * seg`` rows hold
    ``G`` segments)."""
    od = out_dtype or x.dtype
    q = bipolar.quantize_values(x.float(), a_bits, a_scale)
    # an expert without a live row contributes only rows masked to 0 below
    live_e = counts.sum(1) > 0
    yf = moe_expert_int_core(q, w, a_bits, variant, live_e).float() \
        * a_scale * w.scale[:, None, :, 0]
    if w2 is not None:
        y2 = moe_expert_int_core(q, w2, a_bits, variant, live_e).float() \
            * a_scale * w2.scale[:, None, :, 0]
        yf = apply_act(yf, act) * y2
    elif act != "none":
        yf = apply_act(yf, act)
    yo = yf.to(od)
    c = x.shape[1]
    seg = c // counts.shape[1]
    rows = torch.arange(c, device=x.device)
    live = (rows % seg)[None, :] < counts[:, rows // seg]      # (E, C)
    return torch.where(live[..., None], yo, torch.zeros((), dtype=od,
                                                        device=x.device))


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
                        window=None, return_lse: bool = False):
    """Direct-softmax attention in the folded ``(BH, S, D)`` layout;
    fully masked rows return 0 (denominator clamp).  ``return_lse`` also
    returns each row's f32 ``m + log(l)`` ``(BH, S)``, -inf for a fully
    masked row."""
    d = q.shape[-1]
    s = torch.einsum("bqd,btd->bqt", q.float(), k.float()) / math.sqrt(d)
    valid = position_mask(q_pos[:, :, None], kv_pos[:, None, :], causal,
                          window)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = torch.clamp(torch.amax(s, -1, keepdim=True), min=-1e30)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    o = torch.einsum("bqt,btd->bqd", p, v.float())
    l = p.sum(-1, keepdim=True)
    o = (o / torch.clamp(l, min=1e-20)).to(q.dtype)
    return (o, (m + torch.log(l))[..., 0]) if return_lse else o


def _split_attention(q, k, v, q_pos, kv_pos, *, size: int, causal, window):
    """Folded ``(BH, S, D)`` attention as split-KV computes it: T cut into
    ranges of ``size`` slots, each range's f32 partials ``(m, l, acc)``
    -- a range that no query row may see gives ``(-1e30, 0, 0)`` -- then
    the combine ``m = max m_s``, ``l = sum l_s e^(m_s - m)``, ``acc = sum
    acc_s e^(m_s - m)``, ``acc / max(l, 1e-20)``: a fully masked row
    returns 0.  One range computes exactly :func:`attention_reference`'s
    steps."""
    d, t = q.shape[-1], k.shape[1]
    s = torch.einsum("bqd,btd->bqt", q.float(), k.float()) / math.sqrt(d)
    valid = position_mask(q_pos[:, :, None], kv_pos[:, None, :], causal,
                          window)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    parts = []
    for lo in range(0, t, size):
        sv, ok = s[..., lo:lo + size], valid[..., lo:lo + size]
        m_s = torch.clamp(torch.amax(sv, -1, keepdim=True), min=-1e30)
        p = torch.where(ok, torch.exp(sv - m_s), torch.zeros_like(sv))
        parts.append((m_s, p.sum(-1, keepdim=True),
                      torch.einsum("bqt,btd->bqd", p,
                                   v[:, lo:lo + size].float())))
    m = torch.amax(torch.cat([m_s for m_s, _, _ in parts], -1), -1,
                   keepdim=True)
    l = sum(l_s * torch.exp(m_s - m) for m_s, l_s, _ in parts)
    acc = sum(a_s * torch.exp(m_s - m) for m_s, _, a_s in parts)
    return (acc / torch.clamp(l, min=1e-20)).to(q.dtype)


FLOAT_TILE = 64     # slots a K7 tile (csrc/flash_attention.cu's MT, FT)


def flash_attention_split(q, k, v, q_pos, kv_pos, *, splits: int,
                          tile=None, causal=True, window=None):
    """Plain version of K7's split-KV decomposition (flash-decoding), in
    the folded ``(BH, S, D)`` layout: T cut into ranges of ``ceil(T /
    splits)`` slots, or, given ``tile``, T's ``ceil(T / tile)`` tiles cut
    into ``splits`` ranges of ``ceil(tiles / splits)`` tiles (the last
    fewer): the kernel's own ranges at ``tile=FLOAT_TILE`` and its
    ``float_splits`` count (see :func:`_split_attention`).  The tests
    hold it against :func:`attention_reference`."""
    t = k.shape[1]
    if tile is None:
        size = -(-t // splits)
    else:
        tiles = -(-t // tile)
        size = -(-tiles // splits) * tile
    return _split_attention(q, k, v, q_pos, kv_pos, size=size, causal=causal,
                            window=window)


def fold_kv_heads(a: torch.Tensor) -> torch.Tensor:
    """``(B, T, H, ...) -> (BH, T, ...)``."""
    b, t, h = a.shape[:3]
    perm = (0, 2, 1) + tuple(range(3, a.ndim))
    return a.permute(perm).reshape((b * h, t) + tuple(a.shape[3:]))


def kv_cache_attention(q, k_packed, k_scale, v_packed, v_scale, q_pos,
                       kv_pos, *, d: int, causal: bool = True,
                       window=None, return_lse: bool = False):
    """Plain attention over a contiguous packed KV cache in its own
    layout: ``q (B, H, Sq, d)``, planes ``(B, T, H, n_bits, Dw)``, scales
    ``(B, T, H, 1)``, ``q_pos (B, Sq)``, ``kv_pos (B, T)``.  Folds the
    heads into the batch, dequantizes and runs
    :func:`attention_reference`: the reference's ``reference`` impl of
    ``ops.kv_cache_attention``.  Returns ``(B, H, Sq, d)``, and with
    ``return_lse`` each row's ``m + log(l)`` ``(B, H, Sq)`` too."""
    b, h, sq, _ = q.shape
    k = dequantize_kv(fold_kv_heads(k_packed), fold_kv_heads(k_scale), d)
    v = dequantize_kv(fold_kv_heads(v_packed), fold_kv_heads(v_scale), d)
    o = attention_reference(
        q.reshape(b * h, sq, q.shape[-1]), k, v,
        torch.repeat_interleave(q_pos, h, 0),
        torch.repeat_interleave(kv_pos, h, 0), causal=causal, window=window,
        return_lse=return_lse)
    if return_lse:
        return o[0].reshape(b, h, sq, d), o[1].reshape(b, h, sq)
    return o.reshape(b, h, sq, d)


def combine_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Merge normalized attention partials over disjoint slot sets, in
    the order of their leading axis (``o (n, ..., d)`` f32, ``lse (n,
    ...)``), as ``csrc/split_kv.cuh``'s combine merges a split kernel's:
    ``M = max lse``, weights ``e^(lse - M)`` summed in order, ``sum w o /
    max(sum w, 1e-20)`` in f32.  A row no part sees (every lse -inf)
    returns 0."""
    mx = torch.clamp(lse.amax(0), min=-1e30)
    acc = l = None
    for i in range(o.shape[0]):
        w = torch.exp(lse[i] - mx)
        l = w if l is None else l + w
        a = o[i].float() * w[..., None]
        acc = a if acc is None else acc + a
    return acc / torch.clamp(l, min=1e-20)[..., None]


RING_TILE = 32      # ring slots a K6 tile (csrc/flash_attention.cu's BT)


def kv_cache_attention_split(q, k_packed, k_scale, v_packed, v_scale, q_pos,
                             kv_pos, *, splits: int, d: int,
                             causal: bool = True, window=None):
    """Plain version of K6's split plan, in :func:`kv_cache_attention`'s
    layout: the ring's ``ceil(T / 32)`` tiles of 32 slots cut into
    ``splits`` ranges of ``ceil(tiles / splits)`` tiles (the last fewer),
    each range's f32 partials, then the f32 combine
    (:func:`_split_attention`).  ``splits=1`` gives
    :func:`kv_cache_attention`'s bits.  Used by the tests and by
    ``chip_smoke.py``, on no path of the model."""
    b, h, sq, _ = q.shape
    k = dequantize_kv(fold_kv_heads(k_packed), fold_kv_heads(k_scale), d)
    v = dequantize_kv(fold_kv_heads(v_packed), fold_kv_heads(v_scale), d)
    tiles = -(-k_packed.shape[1] // RING_TILE)
    o = _split_attention(
        q.reshape(b * h, sq, q.shape[-1]), k, v,
        torch.repeat_interleave(q_pos, h, 0),
        torch.repeat_interleave(kv_pos, h, 0),
        size=-(-tiles // splits) * RING_TILE, causal=causal, window=window)
    return o.reshape(b, h, sq, d)


flash_attention = attention_reference     # the float kernel's plain version


def paged_attention(q, k_pool, k_scale, v_pool, v_scale, pool_pos,
                    block_tables, q_pos, *, d: int, causal: bool = True,
                    window=None) -> torch.Tensor:
    """Plain paged attention: gather the request's blocks through its
    table, then :func:`kv_cache_attention` on the gathered view.
    ``q (B, H, Gq, d)`` -> ``(B, H, Gq, d)``."""
    def gath(leaf):
        return gather_paged_kv(leaf, block_tables)

    return kv_cache_attention(
        q, gath(k_pool), gath(k_scale), gath(v_pool), gath(v_scale), q_pos,
        gath(pool_pos[:, :, None])[..., 0], d=d, causal=causal,
        window=window)


def paged_attention_split(q, k_pool, k_scale, v_pool, v_scale, pool_pos,
                          block_tables, q_pos, *, splits: int, d: int,
                          causal: bool = True, window=None) -> torch.Tensor:
    """Plain version of K2's split plan: the ``NB`` table entries cut into
    ``splits`` ranges of ``ceil(NB / splits)`` entries (the last fewer),
    each range's f32 partials over the slots of its pool blocks, then the
    f32 combine (:func:`_split_attention`).  ``splits=1`` gives
    :func:`paged_attention`'s bits.  Used by the tests and by
    ``chip_smoke.py``, on no path of the model."""
    b, h, gq, _ = q.shape
    nb, bs = block_tables.shape[1], k_pool.shape[1]

    def fold(leaf):
        return fold_kv_heads(gather_paged_kv(leaf, block_tables))

    k = dequantize_kv(fold(k_pool), fold(k_scale), d)
    v = dequantize_kv(fold(v_pool), fold(v_scale), d)
    kv_pos = gather_paged_kv(pool_pos[:, :, None], block_tables)[..., 0]
    o = _split_attention(
        q.reshape(b * h, gq, q.shape[-1]), k, v,
        torch.repeat_interleave(q_pos, h, 0),
        torch.repeat_interleave(kv_pos, h, 0),
        size=-(-nb // splits) * bs, causal=causal, window=window)
    return o.reshape(b, h, gq, d)
