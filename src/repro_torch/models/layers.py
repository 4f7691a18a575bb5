"""Layers of the decoders and the enc-dec model, in torch: linear,
embedding, norm, RoPE and M-RoPE, GQA attention over the paged pool or a
contiguous cache, cross-attention, SwiGLU/GELU MLP, and the top-k
capacity-dispatched MoE.

A port of the attention, MLP and MoE layers of the reference
``repro.models.layers``, with
the same functional shape: ``<layer>_init(...) -> params`` and
``<layer>_apply(params, x, ...) -> y`` over plain dicts.  Linear weights
are stored ``(d_out, d_in)``; serving-time quantization replaces a weight
leaf with a :class:`BipolarTensor` and ``linear_apply`` dispatches on it
to the fused quantized linear (:func:`repro_torch.kernels.ops.ap_linear_fused`)
or, with ``QuantConfig.fused_linear=False``, the unfused one
(:func:`repro_torch.kernels.ops.ap_linear`: a K3 pack, then a K5 GEMM).

Attention runs on the paged block pool (new K/V quantized to bipolar
planes, scattered into the request's blocks and read back through
:func:`repro_torch.kernels.ops.paged_kv_cache_attention`), on a
contiguous per-row ring cache (packed planes read through
:func:`repro_torch.kernels.ops.ring_kv_cache_attention`, or float K/V
through :func:`_attn_core`), or on the sequence itself with no cache.
Positions are ``(B, S)``, or ``(3, B, S)`` for qwen2-vl's M-RoPE.  The
enc-dec decoder's cross-attention (:func:`cross_attention_apply`) reads
the projected encoder memory from its own cache, a slot of the pool's
state slots when paged, through the same packed-KV kernel.
Quantized experts run through the grouped expert GEMM
(:func:`repro_torch.kernels.ops.ap_moe_expert_linear`, two launches per
MoE layer).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bipolar
from repro_torch.core.bipolar import BipolarTensor
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.kernels.ref import apply_act, f32, fma_f32, silu_f32
from repro_torch.models.config import ModelConfig

# attention switches to online-softmax KV chunking above this length
ATTN_CHUNK_THRESHOLD = 4096
ATTN_KV_CHUNK = 1024


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


# ---------------------------------------------------------------------------
# Linear / Embedding
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
                device) -> dict:
    w = _normal(gen, (d_out, d_in), device)
    return {"w": (w / math.sqrt(d_in)).to(dtype)}


def _epilogue(y: torch.Tensor, act: str, residual, dtype) -> torch.Tensor:
    """Post-GEMM epilogue with the fused kernel's cast points: activation
    in f32 on the dtype-cast GEMM output, residual added in the output
    dtype."""
    if act != "none":
        y = apply_act(y.float(), act).to(dtype)
    if residual is not None:
        y = y + residual.to(dtype)
    return y


def _use_fused_linear(w, quant) -> bool:
    return (isinstance(w, BipolarTensor) and quant is not None
            and quant.enabled and quant.fused_linear)


def linear_apply(params: dict, x: torch.Tensor, *, quant=None,
                 act: str = "none", residual=None) -> torch.Tensor:
    """``y (..., N) = epi(x (..., K) @ W (N, K)^T)`` -- bf16, or the
    quantized linear when the weight leaf is a :class:`BipolarTensor`:
    the fused one-kernel linear (``quant.fused_linear``) or the unfused
    pack + GEMM with the epilogue here.  Both give the same bits.

    A weight the sharded step gathered carries its tensor-parallel kind
    in ``params["tp"]``: the product is then :func:`repro_torch
    .distributed.tensor_parallel.tp_linear`'s, in the weight's dtype.  A
    serve step's row weight (its K-shard, ``params["k"]``) runs
    :func:`~repro_torch.distributed.tensor_parallel.row_product` on the
    input's matching columns: the same bits as the whole product."""
    w = params["w"]
    if "k" in params:
        # a serve step's row product: the columns of x its K-shard reads
        x = TP.row_columns(x, params)
        if w.shape[-1] < params["k"][1]:
            return TP.row_product(x, w, quant=quant, act=act,
                                  residual=residual, out_dtype=x.dtype)
    elif "tp" in params:
        return _epilogue(TP.tp_linear(x, w, params["tp"]), act, residual,
                         w.dtype)
    if _use_fused_linear(w, quant):
        return ops.ap_linear_fused(x, w, a_bits=quant.a_bits, act=act,
                                   residual=residual, variant=quant.variant,
                                   out_dtype=x.dtype,
                                   w_bits=quant.nested_bits)
    if isinstance(w, BipolarTensor):
        assert quant is not None and quant.enabled
        y = ops.ap_linear(x, w, a_bits=quant.a_bits, variant=quant.variant,
                          out_dtype=x.dtype, w_bits=quant.nested_bits)
    else:
        y = torch.matmul(x, w.to(x.dtype).T)
    return _epilogue(y, act, residual, x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               device) -> dict:
    return {"w": (_normal(gen, (vocab, d_model), device) * 0.02).to(dtype)}


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def norm_init(d: int, cfg: ModelConfig, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


# The norm reproduces the f32 bits of the reference's jitted norm on the
# CPU, where XLA (1) rewrites a row reduction wider than 32 into a tree of
# reduce-windows of 32 (the padding split between both ends), each summed
# serially, (2) turns the mean's division by d into a multiply by the f32
# reciprocal, (3) lowers rsqrt to the AVX estimate `rsqrtps` refined by two
# Newton-Raphson steps, and (4) contracts a multiply feeding an add into an
# FMA.  torch.mean/var sum in another order and torch.rsqrt rounds
# otherwise: at d = 4096, 3% of bf16 rows differed.  Rows no wider than 32
# (no model's width) take another XLA fusion and are not reproduced.  The
# card runs the same torch ops.

def _serial_sum(t: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis, one element after another."""
    acc = t[..., 0] + 0.0                  # 0 + t_0, as XLA's init value
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def _tree_sum(t: torch.Tensor) -> torch.Tensor:
    """f32 row sums over the last axis (keepdim) in XLA:CPU's order."""
    while t.shape[-1] > 32:
        pad = -t.shape[-1] % 32
        if pad:
            t = F.pad(t, (pad // 2, pad - pad // 2))
        t = _serial_sum(t.unflatten(-1, (-1, 32)))
    return _serial_sum(t)[..., None]


# Under autograd the norm's two reductions take the gradients the
# reference's autodiff gives them, in one op each: a sum's gradient is
# the upstream gradient on every element of the row (what autograd
# through the serial adds gives too, bit for bit, but with a zero tensor,
# a copy and an add a summed element), and rsqrt's is JAX's own rule,
# ``g * (-0.5 * (y / v))`` (autograd through the estimate, a constant,
# and the Newton steps would give an approximation of it).

class _RowSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.width = t.shape[-1]
        return _tree_sum(t)

    @staticmethod
    def backward(ctx, g):
        return g.expand(*g.shape[:-1], ctx.width)


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    return _RowSum.apply(t)



_RSQRT_EST: dict = {}


def _rsqrt_estimate(v: torch.Tensor) -> torch.Tensor:
    """``rsqrtps`` of positive normal f32 ``v``: 12 bits, from the top 10
    mantissa bits and the exponent's parity, ``round(2^13 / sqrt(mid)) /
    2^13`` at the midpoint ``mid`` of the input's 10-bit bucket (in [1, 2)
    for an odd biased exponent, in [2, 4) for an even one), scaled by the
    exponent's half."""
    table = _RSQRT_EST.get(v.device)
    if table is None:
        mid = 1.0 + (torch.arange(1024, dtype=torch.float64) + 0.5) / 1024
        table = (torch.cat([torch.round(8192.0 / torch.sqrt(2.0 * mid)),
                            torch.round(8192.0 / torch.sqrt(mid))])
                 / 8192.0).float().to(v.device)
        _RSQRT_EST[v.device] = table
    bits = v.view(torch.int32)
    e = bits >> 23
    odd = e & 1
    est = table[odd * 1024 + ((bits >> 13) & 1023)]       # in [0.5, 1)
    return (est.view(torch.int32) + (((128 - odd - e) >> 1) << 23)).view(
        torch.float32)


def _rsqrt_newton(v: torch.Tensor) -> torch.Tensor:
    """f32 ``1 / sqrt(v)`` of positive normal ``v`` (a mean square plus
    eps) as XLA:CPU lowers ``lax.rsqrt``: the estimate, then twice ``y +=
    (-y / 2) * (v y y - 1)`` with FMAs."""
    y = _rsqrt_estimate(v)
    for _ in range(2):
        y = fma_f32(y * -0.5, fma_f32(v * y, y, -1.0), y)
    return y


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        y = _rsqrt_newton(v)
        ctx.save_for_backward(v, y)
        return y

    @staticmethod
    def backward(ctx, g):
        v, y = ctx.saved_tensors
        return g * ((y / v) * -0.5)


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    return _Rsqrt.apply(v)


def rms_normalize(xf: torch.Tensor, scale, eps: float) -> torch.Tensor:
    """f32 ``xf * rsqrt(mean(xf^2) + eps) * scale`` over the last axis,
    in XLA:CPU's steps (the RMSNorm, and mamba2's gated norm)."""
    ms = fma_f32(_row_sum(torch.square(xf)), f32(1.0 / xf.shape[-1]),
                 f32(eps))
    return xf * _rsqrt(ms) * scale


def norm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        inv_d = f32(1.0 / xf.shape[-1])
        xc = xf - _row_sum(xf) * inv_d
        var = fma_f32(_row_sum(torch.square(xc)), inv_d, f32(cfg.norm_eps))
        y = fma_f32(xc * _rsqrt(var), params["scale"], params["bias"])
    else:
        y = rms_normalize(xf, params["scale"], cfg.norm_eps)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard / partial rotary / M-RoPE)
# ---------------------------------------------------------------------------

_INV_FREQ: dict = {}


def _inv_freq(rot_dim: int, theta: float, device) -> torch.Tensor:
    """``1 / theta^(2i / rot_dim)`` in f32, made once per device (a fresh
    device tensor every call would synchronize the host with the card)."""
    key = (rot_dim, theta, str(device))
    inv = _INV_FREQ.get(key)
    if inv is None:
        exps = torch.arange(0, rot_dim, 2, dtype=torch.float32) / rot_dim
        inv = (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                               exps)).to(device)
        _INV_FREQ[key] = inv
    return inv


def _rope_angles(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, rot_dim/2)."""
    ang = positions.float()[..., None] * _inv_freq(rot_dim, theta,
                                                   positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """Rotary embedding on ``x (B, S, H, D)``.

    ``positions``: ``(B, S)``, or ``(3, B, S)`` for M-RoPE (qwen2-vl):
    the rotary half splits into the (temporal, height, width) sections
    of ``cfg.mrope_sections``, each section's frequencies turned by its
    own axis's positions.  Only the leading ``rope_pct`` fraction of D
    rotates."""
    d = x.shape[-1]
    rot = int(d * cfg.rope_pct)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    if cfg.mrope_sections is not None:
        assert positions.ndim == 3, "M-RoPE needs (3, B, S) positions"
        sec = cfg.mrope_sections
        assert sum(sec) == half, (sec, half)
        cos_parts, sin_parts = [], []
        lo = 0
        for axis, width in enumerate(sec):
            c, s = _rope_angles(positions[axis], rot, cfg.rope_theta)
            cos_parts.append(c[..., lo:lo + width])
            sin_parts.append(s[..., lo:lo + width])
            lo += width
        cos = torch.cat(cos_parts, -1)[:, :, None, :]
        sin = torch.cat(sin_parts, -1)[:, :, None, :]
    else:
        cos, sin = _rope_angles(positions, rot, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# Attention (GQA, causal, sliding-window; paged, contiguous ring, none;
# enc-dec cross-attention)
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    dt = _dtype(cfg)
    return {
        "wq": linear_init(gen, d, cfg.n_heads * dh, dt, device),
        "wk": linear_init(gen, d, cfg.n_kv_heads * dh, dt, device),
        "wv": linear_init(gen, d, cfg.n_kv_heads * dh, dt, device),
        "wo": linear_init(gen, cfg.n_heads * dh, d, dt, device),
    }


def _attn_core(q, k, v, q_pos, kv_pos, *, causal: bool,
               window: Optional[int], chunked: bool,
               score_bf16: bool = False, return_lse: bool = False):
    """Online-softmax GQA core over float K/V, in plain torch (the
    reference keeps it in jnp, outside any kernel).

    q: (B, Hkv, Sq, D) with Sq = groups*S folded; k/v: (B, Hkv, T, D);
    q_pos: (B, Sq) absolute positions; kv_pos: (B, T), negative =
    invalid.  ``chunked`` walks the KV axis in ``ATTN_KV_CHUNK`` slots
    with a running max and denominator.  Returns f32 (B, Hkv, Sq, D), and
    with ``return_lse`` each row's ``m + log(l)`` ``(B, Hkv, Sq)`` (-inf
    where no slot is visible)."""
    b, hk, sq, d = q.shape
    t = k.shape[2]
    qf = q.float() * (1.0 / np.sqrt(d))

    def mask_for(kp):  # kp: (B, Tc) -> (B, 1, Sq, Tc) additive mask
        valid = kp[:, None, None, :] >= 0
        if causal:
            valid = valid & (kp[:, None, None, :] <= q_pos[:, None, :, None])
        if window is not None:
            valid = valid & (kp[:, None, None, :]
                             > q_pos[:, None, :, None] - window)
        return torch.where(valid, 0.0, -math.inf)

    if not chunked:
        s = torch.einsum("bhqd,bhtd->bhqt", qf, k.float())
        s = s + mask_for(kv_pos)
        m = torch.clamp(s.amax(-1, keepdim=True), min=-1e30)
        p = torch.exp(s - m)          # fully-masked rows stay finite
        o = torch.einsum("bhqt,bhtd->bhqd", p, v.float())
        lsum = p.sum(-1, keepdim=True)
        o = o / torch.clamp(lsum, min=1e-20)
        return (o, (m + torch.log(lsum))[..., 0]) if return_lse else o

    nc = -(-t // ATTN_KV_CHUNK)
    pad = nc * ATTN_KV_CHUNK - t
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    # opt-in pin: the chunk axis unsharded (heads are the rank's own
    # under tensor parallelism, so it moves nothing)
    k, v = constrain(k, "attn_chunks"), constrain(v, "attn_chunks")
    m = torch.full((b, hk, sq, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros((b, hk, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, sq, d), dtype=torch.float32, device=q.device)
    for c in range(nc):
        sl = slice(c * ATTN_KV_CHUNK, (c + 1) * ATTN_KV_CHUNK)
        s = torch.einsum("bhqd,bhtd->bhqt", qf, k[:, :, sl].float())
        s = s + mask_for(kv_pos[:, sl])
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if score_bf16:      # halve probability-tensor traffic; m/l stay f32
            p = p.to(torch.bfloat16)
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + p.sum(-1, keepdim=True).float()
        acc = acc * alpha + torch.einsum(
            "bhqt,bhtd->bhqd", p.float(), v[:, :, sl].to(p.dtype).float())
        m = m_new
    o = acc / torch.clamp(lsum, min=1e-20)
    return (o, (m + torch.log(lsum))[..., 0]) if return_lse else o


def _paged_write_and_read(cache, qg, qp, k, v, pos2d, cfg: ModelConfig,
                          causal: bool):
    """The paged branch: scatter the step's K/V into the block pool and
    attend through the block table with the grouped queries ``qg (B, Hk,
    G*s, d)`` at ``qp (B, G*s)``.  Returns ``(o (B, Hk, G*s, d),
    cache)``.

    ``cache`` is one layer's pool (``k``/``v`` ``(n_blocks, bs, H,
    kv_bits, Dw)`` int32 planes, ``k_scale``/``v_scale`` ``(n_blocks, bs,
    H, 1)``, ``pos (n_blocks, bs)``) with this step's ``block_tables (B,
    NB)``, ``length (B,)`` and ``block_offset (B,)``.  The ``s`` new
    tokens of row b land at slots ``length[b] + i`` -- physically
    ``(table[slot // bs - block_offset[b]], slot % bs)``: the table is a
    rolling window when leading blocks were reclaimed.  Pad tokens
    (position -1) are dropped at the scatter.  The pool tensors are
    updated IN PLACE (the reference returns new arrays; here the pool is
    the one copy on the device)."""
    b, s = pos2d.shape
    kv_bits = cache["k"].shape[-2]
    blk = cache["k"].shape[1]
    bt, ln = cache["block_tables"], cache["length"]
    k_q, k_s = ops.quantize_kv(k, kv_bits)
    v_q, v_s = ops.quantize_kv(v, kv_bits)
    slot = ln[:, None] + torch.arange(s, dtype=torch.int32,
                                      device=pos2d.device)[None, :]
    valid = pos2d >= 0
    logical = torch.where(valid, torch.div(slot, blk, rounding_mode="floor"),
                          torch.zeros_like(slot))
    boff = cache.get("block_offset")
    if boff is not None:
        logical = logical - boff[:, None]
    entry = torch.clamp(logical, 0, bt.shape[1] - 1)
    valid_w = valid & (logical >= 0) & (logical < bt.shape[1])
    phys = torch.gather(bt, 1, entry.long())
    off = slot % blk
    # in-place scatter into the pool.  A dropped pad is routed to slot 0
    # of the null block and writes back the value already there, so the
    # pool never changes under it (a masked select would need a host
    # sync; no real token ever targets the null block)
    idx_p = torch.where(valid_w, phys, torch.zeros_like(phys)).long()
    idx_o = torch.where(valid_w, off, torch.zeros_like(off)).long()

    def write(key, new):
        buf = cache[key]
        keep = valid_w.reshape(valid_w.shape + (1,) * (new.ndim - 2))
        buf[idx_p, idx_o] = torch.where(keep, new.to(buf.dtype), buf[0, 0])

    write("k", k_q)
    write("k_scale", k_s)
    write("v", v_q)
    write("v_scale", v_s)
    write("pos", pos2d)
    o = ops.paged_kv_cache_attention(
        qg, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
        cache["pos"], bt, qp, d=cfg.head_dim, causal=causal,
        window=cfg.window)
    return o, cache


def _ring_write(cache: dict, key: str, new: torch.Tensor,
                idx: torch.Tensor) -> None:
    """Write ``new (B, s, ...)`` into ``cache[key] (B, L, ...)`` at each
    row's ring index, in place.  As ``lax.dynamic_update_slice`` does, a
    start past ``L - s`` is clamped so the rows fit."""
    buf = cache[key]
    b, s = new.shape[:2]
    start = torch.clamp(idx, max=buf.shape[1] - s).long()
    cols = start[:, None] + torch.arange(s, device=buf.device)[None, :]
    rows = torch.arange(b, device=buf.device)[:, None]
    buf[rows, cols] = new.to(buf.dtype)


def attention_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, cache: Optional[dict] = None,
                    causal: Optional[bool] = None,
                    quant=None, residual: Optional[torch.Tensor] = None):
    """GQA attention of ``x (B, S, d_model)`` at ``positions (B, S)``, or
    ``(3, B, S)`` for M-RoPE: those rotate q and k, and their axis 1 (the
    height axis, as the reference takes ``positions[ndim - 2]``) is the
    position that masks and tags the cache.

    * paged (``cache`` holds ``block_tables``): the step's K/V land in
      the block pool and attention reads through the table
      (:func:`_paged_write_and_read`);
    * contiguous (``cache`` = one layer's ring ``k``/``v`` ``(B, L, H,
      ...)``, packed planes + scales or float, ``pos (B, L)`` and a
      per-row write ``index (B,)``): the new K/V are written at each
      row's ring index, which advances by ``S`` modulo ``L``; a prompt
      longer than the ring (sliding-window prefill) attends over its own
      K/V and stores only its last ``L`` entries, index 0.  Packed
      caches are read through K6, float ones through :func:`_attn_core`;
    * no cache: self-attention over the sequence.

    Caches are updated in place (the reference returns new arrays); the
    returned dict carries the new ``index``.  ``causal`` overrides
    ``cfg.causal`` (the enc-dec encoder's self-attention is not causal).
    ``residual`` (the block input) is fused into the output projection's
    epilogue.  Returns ``(out, cache)``.

    Under the sharded step's tensor parallelism ``x`` is the rank's part
    of the sequence, which each projection gathers, and the head counts
    are the projections' rows over ``d_head``: the rank's own q heads
    and the KV heads they read (:mod:`repro_torch.distributed
    .tensor_parallel`)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    causal = cfg.causal if causal is None else causal
    pos2d = positions[positions.ndim - 2] if positions.ndim == 3 \
        else positions

    q = linear_apply(params["wq"], x, quant=quant)
    k = linear_apply(params["wk"], x, quant=quant)
    s = q.shape[1]      # the whole sequence, from the rank's part of it
    h, hk = q.shape[-1] // dh, k.shape[-1] // dh
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hk, dh)
    v = linear_apply(params["wv"], x, quant=quant).reshape(b, s, hk, dh)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    kv_heads = None         # the KV heads the rank's q heads read
    seq = cache is not None and "seq_shard" in cache
    if TP.serving():
        if seq and s == 1:
            o, new_cache = _decode_seq_parallel(cache, q, k, v, pos2d, cfg,
                                                causal)
            return linear_apply(params["wo"], o.to(x.dtype), quant=quant,
                                residual=residual), new_cache
        q, k, v, kv_heads = _serve_heads(q, k, v, cfg)
        h = q.shape[2]
        hk = kv_heads[1] - kv_heads[0]
    g = h // hk
    # fold the GQA group into the query-sequence axis: (B, Hkv, G*S, D)
    qg = q.reshape(b, s, hk, g, dh).permute(0, 2, 3, 1, 4).reshape(
        b, hk, g * s, dh)
    qp = pos2d[:, None, :].expand(b, g, s).reshape(b, g * s)

    if cache is not None and "block_tables" in cache:
        o, new_cache = _paged_write_and_read(cache, qg, qp, k, v, pos2d,
                                             cfg, causal)
    elif cache is not None:
        # a serve prefill: the layer's cache with every slot, the rank's
        # slots written back after
        whole = TP.gather_cache(cache) if seq else cache
        o, new_cache = _ring_attend(whole, qg, qp, k, v, pos2d, cfg,
                                    causal, kv_heads)
        if seq:
            new_cache = TP.keep_cache(new_cache, cache)
    else:
        new_cache = None
        kt, vt = (t[:, :, slice(*kv_heads) if kv_heads else slice(None)]
                  .transpose(1, 2) for t in (k, v))
        kt, vt = TP.shared_kv(kt, vt, cfg.n_kv_heads)
        o = _attn_core(qg, kt, vt, qp, pos2d, causal=causal,
                       window=cfg.window, chunked=s > ATTN_CHUNK_THRESHOLD,
                       score_bf16=cfg.attn_score_bf16)
    o = o.reshape(b, hk, g, s, dh).permute(0, 3, 1, 2, 4).reshape(
        b, s, h * dh).to(x.dtype)
    return linear_apply(params["wo"], o, quant=quant,
                        residual=residual), new_cache


def _ring_attend(cache, qg, qp, k, v, pos2d, cfg: ModelConfig,
                 causal: bool, kv_heads=None):
    """The contiguous branch of :func:`attention_apply`: the step's K/V
    ``(B, s, Hkv, d)`` (every KV head) written at each row's ring index,
    then ``qg`` attends to KV heads ``kv_heads`` (``(lo, hi)``; None:
    all) through K6 (packed planes) or :func:`_attn_core` (float).
    Returns ``(o, new cache)``."""
    s = pos2d.shape[1]
    dh = cfg.head_dim
    heads = slice(None) if kv_heads is None else slice(*kv_heads)
    kv_bits = cache["k"].shape[-2] if "k_scale" in cache else None
    cache_len = cache["k"].shape[1]
    quant_kv = None
    if s > cache_len:
        # SWA prefill longer than the ring: attend over the in-sequence
        # K/V directly, then store only the last cache_len entries (slot
        # order is irrelevant -- masking is by absolute position)
        tail_k, tail_v = k[:, -cache_len:], v[:, -cache_len:]
        if kv_bits:
            for key, src in (("k", tail_k), ("v", tail_v)):
                planes, scale = ops.quantize_kv(src, kv_bits)
                cache[key].copy_(planes)
                cache[key + "_scale"].copy_(scale)
        else:
            cache["k"].copy_(tail_k)
            cache["v"].copy_(tail_v)
        cache["pos"].copy_(pos2d[:, -cache_len:])
        new_cache = dict(cache, index=torch.zeros_like(cache["index"]))
        kv_pos = pos2d
    else:
        # write the new K/V at per-row ring positions (continuous
        # batching: each batch row advances independently)
        idx = cache["index"]
        if kv_bits:
            for key, src in (("k", k), ("v", v)):
                planes, scale = ops.quantize_kv(src, kv_bits)
                _ring_write(cache, key, planes, idx)
                _ring_write(cache, key + "_scale", scale, idx)
            quant_kv = tuple(cache[key][:, :, heads] for key in
                             ("k", "k_scale", "v", "v_scale"))
        else:
            _ring_write(cache, "k", k, idx)
            _ring_write(cache, "v", v, idx)
            k, v = cache["k"], cache["v"]
        _ring_write(cache, "pos", pos2d, idx)
        new_cache = dict(cache, index=(idx + s) % cache_len)
        kv_pos = cache["pos"]
    if quant_kv is not None:
        # the reference folds the heads into the batch and calls
        # ops.kv_cache_attention; the ring op computes the same on the
        # cache's own layout, so no step copies the ring
        o = ops.ring_kv_cache_attention(
            qg, *quant_kv, qp, kv_pos, d=dh, causal=causal,
            window=cfg.window)
    else:
        # decode (s == 1) is a skinny GEMV -- direct; long prefill
        # sequences use the KV-chunked online softmax to bound the score
        # transient
        chunked = s > 1 and k.shape[1] > ATTN_CHUNK_THRESHOLD
        kt, vt = TP.shared_kv(k[:, :, heads].transpose(1, 2),
                              v[:, :, heads].transpose(1, 2),
                              cfg.n_kv_heads)
        o = _attn_core(qg, kt, vt, qp, kv_pos, causal=causal,
                       window=cfg.window, chunked=chunked,
                       score_bf16=cfg.attn_score_bf16)
    return o, new_cache


def _serve_heads(q, k, v, cfg: ModelConfig):
    """A serve step's head-parallel attention: ``(q, k, v, kv_heads)``,
    the rank's q heads, every KV head (gathered over "model" where the
    projections gave the rank's; a cache's writes need them all) and the
    range of KV heads its q heads read."""
    h_all, hk_all = cfg.n_heads, cfg.n_kv_heads
    h = q.shape[2]
    k = TP.gather_heads(k, hk_all)
    v = TP.gather_heads(v, hk_all)
    g = h_all // hk_all
    q0 = 0 if h == h_all else TP.model_rank() * h
    return q, k, v, (q0 // g, q0 // g + max(1, h // g))


def _ring_write_owned(buf: torch.Tensor, new: torch.Tensor,
                      local: torch.Tensor, own: torch.Tensor) -> None:
    """Write one token ``new (B, 1, ...)`` at each row's slot ``local`` of
    the rank's sequence shard ``buf (B, L_l, ...)``, in place, on the
    rows that own the slot (the others write their own value back: no
    host sync)."""
    b = new.shape[0]
    rows = torch.arange(b, device=buf.device)
    col = torch.clamp(local, 0, buf.shape[1] - 1).long()
    keep = own.reshape((b,) + (1,) * (new.ndim - 2))
    buf[rows, col] = torch.where(keep, new[:, 0].to(buf.dtype),
                                 buf[rows, col])


def _decode_seq_parallel(cache, q, k, v, pos2d, cfg: ModelConfig,
                         causal: bool):
    """A serve step's decode over a sequence-sharded ring: every head's
    q, k and v (gathered over "model"), the new K/V row written by the
    rank that owns slot ``index`` of the whole ring, every head attending
    to the rank's own slots, and the ranks' ``(o, lse)`` combined
    (:func:`repro_torch.distributed.tensor_parallel.combine_over_model`).
    Returns ``(o (B, 1, H d) f32, new cache)``."""
    b, dh = q.shape[0], cfg.head_dim
    q = TP.gather_heads(q, cfg.n_heads)
    k = TP.gather_heads(k, cfg.n_kv_heads)
    v = TP.gather_heads(v, cfg.n_kv_heads)
    h, hk = q.shape[2], k.shape[2]
    g = h // hk
    lo, length = cache["seq_shard"]
    idx = cache["index"]
    local = idx - lo
    own = (local >= 0) & (local < cache["pos"].shape[1])
    if "k_scale" in cache:
        kv_bits = cache["k"].shape[-2]
        for key, src in (("k", k), ("v", v)):
            planes, scale = ops.quantize_kv(src, kv_bits)
            _ring_write_owned(cache[key], planes, local, own)
            _ring_write_owned(cache[key + "_scale"], scale, local, own)
    else:
        _ring_write_owned(cache["k"], k, local, own)
        _ring_write_owned(cache["v"], v, local, own)
    _ring_write_owned(cache["pos"], pos2d, local, own)
    new_cache = dict(cache, index=(idx + 1) % length)
    qg = q.reshape(b, hk, g, dh)
    qp = pos2d.expand(b, g)
    o = _attend_partial(cache, qg, qp, cache["pos"], cfg, causal,
                        cfg.window)
    return o.reshape(b, 1, h * dh), new_cache


def _attend_partial(cache, qg, qp, kv_pos, cfg: ModelConfig, causal: bool,
                    window):
    """Every head's queries ``qg (B, Hkv, G, d)`` over the rank's slots of
    ``cache``: each rank's f32 ``(o, lse)`` (K6 with its lse output on
    packed planes, :func:`_attn_core` on float K/V), combined over
    "model".  Returns f32 ``(B, Hkv, G, d)``."""
    if "k_scale" in cache:
        o, lse = ops.ring_kv_cache_attention(
            qg.float(), cache["k"], cache["k_scale"], cache["v"],
            cache["v_scale"], qp, kv_pos, d=cfg.head_dim, causal=causal,
            window=window, return_lse=True)
    else:
        o, lse = _attn_core(qg, cache["k"].transpose(1, 2),
                            cache["v"].transpose(1, 2), qp, kv_pos,
                            causal=causal, window=window, chunked=False,
                            return_lse=True)
    return TP.combine_over_model(o, lse)


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  kv_bits: Optional[int] = None, device="cuda") -> dict:
    """One layer's KV cache; for SWA archs a ring of ``min(max_len,
    window)`` slots.

    The contiguous engine keeps ``batch`` request rows of ``max_len``
    slots with a per-row write ``index``; the paged pool calls this with
    ``batch=n_blocks, max_len=block_size`` (leading dims: physical
    block, in-block slot).  With ``kv_bits`` (default ``cfg.kv_bits``;
    ``model.init_caches`` passes ``QuantConfig.kv_bits`` over it) the
    cache stores packed bipolar planes ``(batch, L, H, kv_bits,
    ceil(D/32))`` int32 + per-(token, head) f32 scales; otherwise K/V in
    the model's dtype.  Positions start at -1 (empty)."""
    kv_bits = cfg.kv_bits if kv_bits is None else kv_bits
    length = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, length, cfg.n_kv_heads)
    cache = {
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if kv_bits:
        assert 1 <= kv_bits <= 8, f"kv_bits={kv_bits} outside 1..8"
        packed = shape + (kv_bits, bipolar.packed_words(cfg.head_dim))
        cache["k"] = torch.zeros(packed, dtype=torch.int32, device=device)
        cache["v"] = torch.zeros(packed, dtype=torch.int32, device=device)
        cache["k_scale"] = torch.zeros(shape + (1,), dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape + (1,), dtype=torch.float32,
                                       device=device)
    else:
        cache["k"] = torch.zeros(shape + (cfg.head_dim,), dtype=_dtype(cfg),
                                 device=device)
        cache["v"] = torch.zeros(shape + (cfg.head_dim,), dtype=_dtype(cfg),
                                 device=device)
    return cache


def make_cross_cache(cfg: ModelConfig, batch: int, enc_len: int,
                     kv_bits: Optional[int] = None, device="cuda") -> dict:
    """One decoder layer's enc-dec cross-K/V cache: the projected encoder
    memory, replayed every decode step, ``enc_len`` rows a request.  With
    ``kv_bits`` (default ``cfg.kv_bits``) packed bipolar planes ``(batch,
    enc_len, H, kv_bits, ceil(D/32))`` int32 + per-(token, head) f32
    scales, the self-attention cache's format; otherwise K/V in the
    model's dtype.  Positions start at -1 (empty): an empty row is
    masked."""
    kv_bits = cfg.kv_bits if kv_bits is None else kv_bits
    shape = (batch, enc_len, cfg.n_kv_heads)
    cache = {"pos": torch.full((batch, enc_len), -1, dtype=torch.int32,
                               device=device)}
    if kv_bits:
        assert 1 <= kv_bits <= 8, f"kv_bits={kv_bits} outside 1..8"
        packed = shape + (kv_bits, bipolar.packed_words(cfg.head_dim))
        for key in ("k", "v"):
            cache[key] = torch.zeros(packed, dtype=torch.int32,
                                     device=device)
            cache[key + "_scale"] = torch.zeros(
                shape + (1,), dtype=torch.float32, device=device)
    else:
        for key in ("k", "v"):
            cache[key] = torch.zeros(shape + (cfg.head_dim,),
                                     dtype=_dtype(cfg), device=device)
    return cache


def _write_cross_slots(cache: dict, ck, cks, cv, cvs, kv_pos) -> dict:
    """Write one batch's projected, packed cross-K/V into its slot-pool
    rows, in place.  ``cache`` leaves are ``(rows, cap, ...)`` with
    ``slots (B,)`` ids (-1 = a pad lane, whose write is dropped).  Rows
    are written full width: the slots past the batch's encoder length
    ``t`` get position -1 and stay masked, so a reused slot cannot leak
    a freed request's memory."""
    slots = cache["slots"]
    cap = cache["k"].shape[1]
    t = ck.shape[1]
    safe = torch.clamp(slots, 0, cache["k"].shape[0] - 1).long()
    keep = slots >= 0

    def write(key, new, fill=0):
        buf = cache[key]
        full = torch.full((new.shape[0], cap) + tuple(new.shape[2:]), fill,
                          dtype=buf.dtype, device=buf.device)
        full[:, :t] = new.to(buf.dtype)
        k = keep.reshape(keep.shape + (1,) * (full.ndim - 1))
        # a pad lane writes row 0 back with its own contents (a masked
        # select would need a host sync; no real lane owns row 0)
        buf[safe] = torch.where(k, full, buf[0])

    for key, new in (("k", ck), ("k_scale", cks), ("v", cv),
                     ("v_scale", cvs)):
        write(key, new)
    write("pos", kv_pos, -1)
    return cache


def cross_attention_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                          *, memory: Optional[torch.Tensor] = None,
                          cache: Optional[dict] = None, quant=None,
                          residual: Optional[torch.Tensor] = None):
    """Enc-dec cross-attention of ``x (B, S, d_model)`` (no RoPE, not
    causal: every query row sees every encoder row).

    Prefill: ``memory (B, T, d)`` given -> project K/V from it and fill
    ``cache`` if one is given.  With a packed cache (``k_scale`` present)
    K/V are quantized and the prefill attends through the planes too,
    so every position sees decode's precision.  Decode: ``memory=None``
    -> replay the cached K/V (the encoder does not run again).

    Paged serving hands the cache as slot-pool rows: leaves ``(n_slots +
    1, cap, ...)`` and ``slots (B,)`` mapping lanes to rows (row 0 the
    null slot, -1 a pad lane).  Prefill writes this batch's rows in place
    (:func:`_write_cross_slots`); decode gathers them, a pad lane the
    null row, whose positions stay -1 (fully masked: it contributes 0).
    Packed reads run K6 (:func:`repro_torch.kernels.ops
    .ring_kv_cache_attention`, ``causal=False``, no window), float reads
    :func:`_attn_core`.  A contiguous cache's leaves are replaced by the
    prefill's, as the reference does.  ``residual`` (the block input) is
    fused into the output projection.  Returns ``(out, cache)``."""
    if TP.serving():
        return _cross_serve(params, x, cfg, memory=memory, cache=cache,
                            quant=quant, residual=residual)
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = linear_apply(params["wq"], x, quant=quant)
    # the rank's heads and the whole sequence under tensor parallelism
    # (see attention_apply)
    s, h = q.shape[1], q.shape[-1] // dh
    hk = max(1, h * cfg.n_kv_heads // cfg.n_heads)
    g = h // hk
    slotted = cache is not None and "slots" in cache
    q = q.reshape(b, s, h, dh)
    qg = q.reshape(b, s, hk, g, dh).permute(0, 2, 3, 1, 4).reshape(
        b, hk, g * s, dh)
    qp = torch.zeros((b, g * s), dtype=torch.int32, device=x.device)
    quant_kv = None             # (k, k_scale, v, v_scale) packed planes
    new_cache = cache
    if memory is not None:
        k = linear_apply(params["wk"], memory, quant=quant)
        t = k.shape[1]
        k = k.reshape(b, t, hk, dh)
        v = linear_apply(params["wv"], memory, quant=quant).reshape(
            b, t, hk, dh)
        kv_pos = torch.arange(t, dtype=torch.int32,
                              device=x.device)[None].repeat(b, 1)
        if cache is not None:
            if "k_scale" in cache:
                kv_bits = cache["k"].shape[-2]
                ck, cks = ops.quantize_kv(k, kv_bits)
                cv, cvs = ops.quantize_kv(v, kv_bits)
                quant_kv = (ck, cks, cv, cvs)
                if slotted:
                    new_cache = _write_cross_slots(cache, ck, cks, cv, cvs,
                                                   kv_pos)
                else:
                    new_cache = dict(cache, k=ck, v=cv, k_scale=cks,
                                     v_scale=cvs, pos=kv_pos)
            else:
                assert not slotted, \
                    "slot-pool cross caches store packed planes: the " \
                    "paged engine requires kv_bits for audio archs"
                new_cache = dict(cache, k=k.to(cache["k"].dtype),
                                 v=v.to(cache["v"].dtype), pos=kv_pos)
    else:
        assert cache is not None, "cross decode needs a filled cross cache"
        if slotted:
            safe = torch.clamp(cache["slots"], 0,
                               cache["k"].shape[0] - 1).long()
            quant_kv = (cache["k"][safe], cache["k_scale"][safe],
                        cache["v"][safe], cache["v_scale"][safe])
            kv_pos = cache["pos"][safe]
        elif "k_scale" in cache:
            quant_kv = (cache["k"], cache["k_scale"], cache["v"],
                        cache["v_scale"])
            kv_pos = cache["pos"]
        else:
            k, v, kv_pos = cache["k"], cache["v"], cache["pos"]
    if quant_kv is not None:
        o = ops.ring_kv_cache_attention(qg, *quant_kv, qp, kv_pos, d=dh,
                                        causal=False, window=None)
    else:
        chunked = s > 1 and k.shape[1] > ATTN_CHUNK_THRESHOLD
        o = _attn_core(qg, k.transpose(1, 2), v.transpose(1, 2), qp, kv_pos,
                       causal=False, window=None, chunked=chunked)
    o = o.reshape(b, hk, g, s, dh).permute(0, 3, 1, 2, 4).reshape(
        b, s, h * dh).to(x.dtype)
    return linear_apply(params["wo"], o, quant=quant,
                        residual=residual), new_cache


def _cross_serve(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 memory, cache, quant, residual):
    """:func:`cross_attention_apply` in a serve step over a contiguous
    cross cache: a prefill projects the rank's heads of K/V, gathers
    every head, keeps the cache's rows of the rank's sequence shard and
    attends on the rank's heads; a decode attends every head to the
    rank's encoder rows and combines the ranks' partials (as
    :func:`_decode_seq_parallel` does, not causal)."""
    b, dh = x.shape[0], cfg.head_dim
    q = linear_apply(params["wq"], x, quant=quant)
    s, h = q.shape[1], q.shape[-1] // dh
    q = q.reshape(b, s, h, dh)
    seq = cache is not None and "seq_shard" in cache
    if memory is None and seq:
        q = TP.gather_heads(q, cfg.n_heads)
        h, hk = cfg.n_heads, cfg.n_kv_heads
        qg = q.reshape(b, s, hk, h // hk, dh).permute(0, 2, 3, 1, 4).reshape(
            b, hk, -1, dh)
        qp = torch.zeros(qg.shape[:1] + qg.shape[2:3], dtype=torch.int32,
                         device=x.device)
        o = _attend_partial(cache, qg, qp, cache["pos"], cfg, False, None)
        new_cache = cache
    else:
        g = cfg.n_heads // cfg.n_kv_heads
        q0 = 0 if h == cfg.n_heads else TP.model_rank() * h
        heads = slice(q0 // g, q0 // g + max(1, h // g))
        qg = q.reshape(b, s, heads.stop - heads.start, -1, dh).permute(
            0, 2, 3, 1, 4).reshape(b, heads.stop - heads.start, -1, dh)
        qp = torch.zeros(qg.shape[:1] + qg.shape[2:3], dtype=torch.int32,
                         device=x.device)
        new_cache = cache
        if memory is not None:
            t = memory.shape[1]
            k, v = (TP.gather_heads(linear_apply(params[w], memory,
                                                 quant=quant).reshape(
                b, t, -1, dh), cfg.n_kv_heads) for w in ("wk", "wv"))
            kv_pos = torch.arange(t, dtype=torch.int32,
                                  device=x.device)[None].repeat(b, 1)
            if cache is not None and "k_scale" in cache:
                kv_bits = cache["k"].shape[-2]
                ck, cks = ops.quantize_kv(k, kv_bits)
                cv, cvs = ops.quantize_kv(v, kv_bits)
                leaves = dict(k=ck, v=cv, k_scale=cks, v_scale=cvs)
            else:
                leaves = dict(k=k, v=v)
                if cache is not None:
                    leaves = {key: t_.to(cache[key].dtype)
                              for key, t_ in leaves.items()}
            read = dict(leaves, pos=kv_pos)
            if cache is not None:
                if seq:             # the rows of the rank's shard
                    lo, n = cache["seq_shard"][0], cache["pos"].shape[1]
                    new_cache = dict(cache, **{key: t_[:, lo:lo + n]
                                               for key, t_ in read.items()})
                else:
                    new_cache = dict(cache, **read)
        else:
            read = cache
        if "k_scale" in read:
            o = ops.ring_kv_cache_attention(
                qg, *(read[key][:, :, heads] for key in
                      ("k", "k_scale", "v", "v_scale")), qp, read["pos"],
                d=dh, causal=False, window=None)
        else:
            kk, vv = read["k"][:, :, heads], read["v"][:, :, heads]
            o = _attn_core(qg, kk.transpose(1, 2), vv.transpose(1, 2), qp,
                           read["pos"], causal=False, window=None,
                           chunked=s > 1 and kk.shape[1]
                           > ATTN_CHUNK_THRESHOLD)
    hk = qg.shape[1]
    o = o.reshape(b, hk, -1, s, dh).permute(0, 3, 1, 2, 4).reshape(
        b, s, h * dh).to(x.dtype)
    return linear_apply(params["wo"], o, quant=quant,
                        residual=residual), new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: Optional[int] = None) -> dict:
    """``d_ff`` overrides ``cfg.d_ff`` (the MoE shared experts)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    p = {"w_up": linear_init(gen, d, f, dt, device),
         "w_down": linear_init(gen, f, d, dt, device)}
    if cfg.act == "silu":
        p["w_gate"] = linear_init(gen, d, f, dt, device)
    return p


def mlp_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, quant=None,
              residual: Optional[torch.Tensor] = None):
    """SwiGLU / GELU MLP.  Quantized with ``fused_linear``: gate and up
    run as ONE dual-GEMM fused-linear launch (``silu(gate) * up`` in its
    epilogue) and the down projection fuses the block residual.
    Otherwise gate and up are two linears and ``silu(gate) * up`` runs
    in f32 with one cast -- the same SiLU form as the fused epilogue's
    plain version, so both give the same bits."""
    if cfg.act == "silu":
        if _use_fused_linear(params["w_up"]["w"], quant):
            h = ops.ap_linear_fused(
                x, params["w_gate"]["w"], w2=params["w_up"]["w"],
                a_bits=quant.a_bits, act="silu", variant=quant.variant,
                out_dtype=x.dtype, w_bits=quant.nested_bits)
        else:
            up = linear_apply(params["w_up"], x, quant=quant)
            gate = linear_apply(params["w_gate"], x, quant=quant)
            h = (silu_f32(gate.float()) * up.float()).to(x.dtype)
    else:
        h = linear_apply(params["w_up"], x, quant=quant, act="gelu")
    return linear_apply(params["w_down"], h, quant=quant, residual=residual)


# ---------------------------------------------------------------------------
# MoE (top-k routing, capacity dispatch, optional shared experts)
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Router ``(E, d)`` f32, stacked experts ``w_up``/``w_gate`` ``(E,
    F, d)`` and ``w_down`` ``(E, d, F)``, and the shared experts as one
    MLP of width ``n_shared_experts * F``."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    dt = _dtype(cfg)
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": {"w": _normal(gen, (e, d), device) * scale},
        "w_up": (_normal(gen, (e, f, d), device) * scale).to(dt),
        "w_gate": (_normal(gen, (e, f, d), device) * scale).to(dt),
        "w_down": (_normal(gen, (e, d, f), device) / math.sqrt(f)).to(dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, device,
                               d_ff=cfg.n_shared_experts * f)
    return p


MOE_DISPATCH_GROUPS = 32   # static token-group count (per-group capacity)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, quant=None,
              *, with_aux: bool = False, with_stats: bool = False):
    """Top-k capacity-bounded MoE over ``x (B, S, d)``.

    Tokens split into ``G`` static groups (``G = 1`` below 4096 tokens)
    with per-group capacity ``cap`` from the static shapes alone (no
    device sync), clamped to the group's assignments.  Every token is
    routed, bucket pads (position -1) included, so pads take capacity as
    in the reference.  The f32 router picks the top ``k`` experts; a
    token's ``k`` assignments claim capacity slots in order, and one
    beyond ``cap`` is dropped.  Kept rows are copied into their slots of
    a zero ``(E, G * cap, d)`` dispatch; dropped ones all land in one
    overflow row that is never read.  Quantized experts run as two
    grouped-kernel launches (dual gate/up with ``silu(gate) * up``, then
    down) whose live-row counts skip empty capacity tiles; the combine
    gathers each assignment's row, weights it by its renormalised
    router probability cast to the output dtype, and sums the ``k`` rows
    in that dtype.  Unquantized experts run as bf16 batched einsums.  The
    shared experts add a dense MLP.

    Returns ``(y, aux, stats)``.  ``aux`` is the Switch-style
    load-balance loss, computed only with ``with_aux=True`` (serving has
    no use for it), else None.  ``stats`` is the capacity telemetry,
    computed only with ``with_stats=True``, else None: ``load (E,)`` kept
    tokens per expert, ``dropped ()`` assignments lost to capacity (int32,
    on ``x``'s device) and ``capacity ()`` dispatch slots (from the
    shapes, on the host).

    Under the sharded step (:mod:`repro_torch.distributed
    .tensor_parallel`) ``x`` is the rank's part of the sequence: it is
    gathered, and the router runs on the whole sequence of the rank's
    batch rows, the same on every model rank.
    The groups and the capacity are the global batch's: a rank takes its
    ``G / n_dp`` groups, or, when a group spans several DP ranks, its
    slots continue the per-expert counts of the group's preceding DP
    ranks, so the drops are the single process's.  The dispatch keeps
    the rank's experts where they divide "model" (``moe_dispatch``), or
    every expert whole on the rank's part of the capacity rows otherwise
    (:func:`repro_torch.distributed.tensor_parallel.expert_rows`); every
    rank then gathers every expert's output rows, combines them as the
    single process does and keeps its part of the tokens
    (``moe_combine``).  The sharded serve step keeps ``x`` whole and
    splits the experts likewise, K4 on the rank's experts or on its part
    of each group's rows.  ``aux`` takes its
    token and probability sums over the DP axes before the product.
    """
    # the shared experts' input: under tensor parallelism the rank's part
    # of the sequence (their projections gather it); the dispatch's and
    # the router's are gathered apart, in f32, so that each one's
    # gradient rounds once, and each pair's gradients meet in a view of
    # ``x`` first, where the single process's do
    split = TP.splits()
    xt = x.view_as(x) if split else x.reshape(-1, x.shape[-1])
    xrd = x.view_as(x) if split else x
    xd, xr = TP.gather_seq(xrd, f32=True), TP.gather_seq(xrd, f32=True)
    b, s, d = xd.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    n_dp, dp_rank = TP.dp_info()
    t_all = t * n_dp                 # the global batch's tokens
    if t_all >= 4096:
        g_all = next(gg for gg in (MOE_DISPATCH_GROUPS, 16, 8, 4, 2, 1)
                     if t_all % gg == 0)
    else:
        g_all = 1
    tg = t_all // g_all
    # the capacity never needs to exceed the group's routed assignments
    cap = min(int(np.ceil(k * tg * cfg.capacity_factor / e)), tg * k)
    if g_all % n_dp == 0:
        g = g_all // n_dp
    elif n_dp % g_all == 0:
        g = 1                        # a part of one group
    else:
        raise ValueError(f"{g_all} MoE dispatch groups over {n_dp} "
                         f"data-parallel ranks")
    tgl = t // g
    dev = x.device
    xg = xd.reshape(g, tgl, d)

    logits = torch.einsum("gtd,ed->gte", (xg if xr is xd else xr.reshape(
        g, tgl, d)).float(), params["router"]["w"])
    z = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = z / z.sum(-1, keepdim=True)
    top_p, top_e = torch.topk(probs, k, dim=-1)               # (G, Tg, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(g, tgl * k)                         # (G, Tg*k)
    oh = F.one_hot(flat_e, e).to(torch.int32)                  # (G, Tg*k, E)
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh      # count before
    off = None
    if tgl < tg:
        # the group's earlier tokens lie on the preceding DP ranks
        before = TP.dp_gather(oh.sum((0, 1), dtype=torch.int32))
        first = dp_rank - dp_rank % (n_dp // g_all)
        off = before[first:dp_rank].sum(0, dtype=torch.int32)
        pos = pos + off
    pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)      # (G, Tg*k)

    # dispatch: every kept slot receives exactly one row (a copy, not a
    # sum); the dropped rows all go to the overflow row e * cap
    idx = slot[..., None].expand(g, tgl * k, d)
    disp = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=dev)
    disp.scatter_(1, idx, torch.repeat_interleave(xg, k, dim=1).to(x.dtype))
    # the rank's experts where it holds a part of them (EP)
    ep = params["w_up"].shape[-3] < e
    disp = constrain(disp[:, :e * cap].reshape(g, e, cap, d),
                     "moe_dispatch", "replicated" if ep else None)
    el = disp.shape[1]                                         # (G, El, C, d)
    disp_e = disp.transpose(0, 1).reshape(el, g * cap, d)      # (El, G*C, d)
    counts = (oh * keep[..., None]).sum(1, dtype=torch.int32)  # (G, E)
    # the grouped kernel's live rows: a segment's kept rows, or where the
    # group continues the preceding DP ranks' (its rows start at ``off``)
    # every row up to the rank's last (the ones below ``off`` are zeros
    # no token reads)
    live = counts if off is None else torch.clamp(
        oh.sum(1, dtype=torch.int32) + off, max=cap)
    counts_e = live.T.contiguous()                             # (E, G)

    if isinstance(params["w_up"], BipolarTensor):
        def q_experts(a, cnt):
            h = ops.ap_moe_expert_linear(
                a, params["w_gate"], w2=params["w_up"], counts=cnt,
                a_bits=quant.a_bits, act="silu", variant=quant.variant,
                out_dtype=x.dtype, w_bits=quant.nested_bits)
            return ops.ap_moe_expert_linear(
                h, params["w_down"], counts=cnt, a_bits=quant.a_bits,
                variant=quant.variant, out_dtype=x.dtype,
                w_bits=quant.nested_bits)                      # (E, G*C, d)
        if el < e:          # the rank's experts (EP)
            lo = TP.model_rank() * el
            out = q_experts(disp_e, counts_e[lo:lo + el])
        elif TP.serving():
            # experts not split over "model" (mixtral's 8 on 16) run
            # whole on the rank's part of each group's rows
            out = TP.expert_rows(disp_e, q_experts, counts_e)
        else:
            out = q_experts(disp_e, counts_e)
    else:
        def bmm(w, a):
            return torch.einsum("eck,enk->ecn", a, w.to(a.dtype))

        def experts(a):
            up, gate = bmm(params["w_up"], a), bmm(params["w_gate"], a)
            h = (silu_f32(gate.float()) * up.float()).to(x.dtype)
            return bmm(params["w_down"], h)
        # experts not split over "model" (mixtral's 8 on 16) run whole on
        # the rank's part of the capacity rows; every rank gets every row
        out = (TP.expert_rows(disp_e, experts)
               if (TP.splits() or TP.serving()) and not ep
               else experts(disp_e))
    # every rank's experts (EP): the combine below is the single
    # process's, on every model rank, which keeps its part of the tokens
    out = TP.gather_model(out, 0) if el < e else out          # (E, G*C, d)

    out_g = out.reshape(e, g, cap, d).transpose(0, 1)          # (G, E, C, d)
    out_flat = torch.cat([out_g.reshape(g, e * cap, d),
                          torch.zeros((g, 1, d), dtype=out.dtype,
                                      device=dev)], 1)
    y = torch.gather(out_flat, 1, idx)
    wgt = (top_p.reshape(g, tgl * k)[..., None] * keep[..., None]) \
        .to(out.dtype)
    y = constrain((y * wgt).reshape(g, tgl, k, d).sum(2).reshape(b, s, d),
                  "moe_combine", "replicated")

    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, cfg, quant=quant).reshape(
            y.shape)

    aux = stats = None
    if with_aux:    # Switch-style load-balance auxiliary loss
        frac_tokens = TP.dp_sum(F.one_hot(top_e[..., 0].reshape(-1), e)
                                .float().sum(0)) / t_all
        frac_probs = TP.dp_sum(probs.reshape(-1, e).sum(0)) / t_all
        aux = e * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef
    if with_stats:
        routed = oh.sum((0, 1), dtype=torch.int32)             # (E,)
        load = counts.sum(0, dtype=torch.int32)                # (E,)
        stats = {"load": load,
                 "dropped": (routed - load).sum(dtype=torch.int32),
                 "capacity": torch.tensor(e * cap * g, dtype=torch.int32)}
    return y, aux, stats
