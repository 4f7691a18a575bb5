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
    pack + GEMM with the epilogue here.  Both give the same bits."""
    w = params["w"]
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
               score_bf16: bool = False):
    """Online-softmax GQA core over float K/V, in plain torch (the
    reference keeps it in jnp, outside any kernel).

    q: (B, Hkv, Sq, D) with Sq = groups*S folded; k/v: (B, Hkv, T, D);
    q_pos: (B, Sq) absolute positions; kv_pos: (B, T), negative =
    invalid.  ``chunked`` walks the KV axis in ``ATTN_KV_CHUNK`` slots
    with a running max and denominator.  Returns f32 (B, Hkv, Sq, D)."""
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
        return o / torch.clamp(p.sum(-1, keepdim=True), min=1e-20)

    nc = -(-t // ATTN_KV_CHUNK)
    pad = nc * ATTN_KV_CHUNK - t
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
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
    return acc / torch.clamp(lsum, min=1e-20)


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
    epilogue.  Returns ``(out, cache)``."""
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hk
    causal = cfg.causal if causal is None else causal
    pos2d = positions[positions.ndim - 2] if positions.ndim == 3 \
        else positions

    q = linear_apply(params["wq"], x, quant=quant).reshape(b, s, h, dh)
    k = linear_apply(params["wk"], x, quant=quant).reshape(b, s, hk, dh)
    v = linear_apply(params["wv"], x, quant=quant).reshape(b, s, hk, dh)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    # fold the GQA group into the query-sequence axis: (B, Hkv, G*S, D)
    qg = q.reshape(b, s, hk, g, dh).permute(0, 2, 3, 1, 4).reshape(
        b, hk, g * s, dh)
    qp = pos2d[:, None, :].expand(b, g, s).reshape(b, g * s)

    new_cache = None
    quant_kv = None
    if cache is not None and "block_tables" in cache:
        o, new_cache = _paged_write_and_read(cache, qg, qp, k, v, pos2d,
                                             cfg, causal)
    else:
        if cache is not None:
            kv_bits = cache["k"].shape[-2] if "k_scale" in cache else None
            cache_len = cache["k"].shape[1]
            if s > cache_len:
                # SWA prefill longer than the ring: attend over the
                # in-sequence K/V directly, then store only the last
                # cache_len entries (slot order is irrelevant -- masking
                # is by absolute position)
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
                new_cache = dict(cache,
                                 index=torch.zeros_like(cache["index"]))
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
                    quant_kv = (cache["k"], cache["k_scale"], cache["v"],
                                cache["v_scale"])
                else:
                    _ring_write(cache, "k", k, idx)
                    _ring_write(cache, "v", v, idx)
                    k, v = cache["k"], cache["v"]
                _ring_write(cache, "pos", pos2d, idx)
                new_cache = dict(cache, index=(idx + s) % cache_len)
                kv_pos = cache["pos"]
        else:
            kv_pos = pos2d
        if quant_kv is not None:
            # the reference folds the heads into the batch and calls
            # ops.kv_cache_attention; the ring op computes the same on the
            # cache's own layout, so no step copies the ring
            o = ops.ring_kv_cache_attention(
                qg, *quant_kv, qp, kv_pos, d=dh, causal=causal,
                window=cfg.window)
        else:
            # decode (s == 1) is a skinny GEMV -- direct; long prefill
            # sequences use the KV-chunked online softmax to bound the
            # score transient
            chunked = s > 1 and k.shape[1] > ATTN_CHUNK_THRESHOLD
            o = _attn_core(qg, k.transpose(1, 2), v.transpose(1, 2), qp,
                           kv_pos, causal=causal, window=cfg.window,
                           chunked=chunked, score_bf16=cfg.attn_score_bf16)
    o = o.reshape(b, hk, g, s, dh).permute(0, 3, 1, 2, 4).reshape(
        b, s, h * dh).to(x.dtype)
    return linear_apply(params["wo"], o, quant=quant,
                        residual=residual), new_cache


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
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hk
    slotted = cache is not None and "slots" in cache
    q = linear_apply(params["wq"], x, quant=quant).reshape(b, s, h, dh)
    qg = q.reshape(b, s, hk, g, dh).permute(0, 2, 3, 1, 4).reshape(
        b, hk, g * s, dh)
    qp = torch.zeros((b, g * s), dtype=torch.int32, device=x.device)
    quant_kv = None             # (k, k_scale, v, v_scale) packed planes
    new_cache = cache
    if memory is not None:
        t = memory.shape[1]
        k = linear_apply(params["wk"], memory, quant=quant).reshape(
            b, t, hk, dh)
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
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    if t >= 4096:
        g = next(gg for gg in (MOE_DISPATCH_GROUPS, 16, 8, 4, 2, 1)
                 if t % gg == 0)
    else:
        g = 1
    tg = t // g
    # the capacity never needs to exceed the group's routed assignments
    cap = min(int(np.ceil(k * tg * cfg.capacity_factor / e)), tg * k)
    dev = x.device
    xt = x.reshape(t, d)
    xg = x.reshape(g, tg, d)

    logits = torch.einsum("gtd,ed->gte", xg.float(), params["router"]["w"])
    z = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = z / z.sum(-1, keepdim=True)
    top_p, top_e = torch.topk(probs, k, dim=-1)               # (G, Tg, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(g, tg * k)                          # (G, Tg*k)
    oh = F.one_hot(flat_e, e).to(torch.int32)                  # (G, Tg*k, E)
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh      # count before
    pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)      # (G, Tg*k)

    # dispatch: every kept slot receives exactly one row (a copy, not a
    # sum); the dropped rows all go to the overflow row e * cap
    idx = slot[..., None].expand(g, tg * k, d)
    disp = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=dev)
    disp.scatter_(1, idx, torch.repeat_interleave(xg, k, dim=1))
    disp_e = disp[:, :e * cap].reshape(g, e, cap, d).transpose(0, 1) \
        .reshape(e, g * cap, d)                                # (E, G*C, d)
    counts = (oh * keep[..., None]).sum(1, dtype=torch.int32)  # (G, E)
    counts_e = counts.T.contiguous()                           # (E, G)

    if isinstance(params["w_up"], BipolarTensor):
        h = ops.ap_moe_expert_linear(
            disp_e, params["w_gate"], w2=params["w_up"], counts=counts_e,
            a_bits=quant.a_bits, act="silu", variant=quant.variant,
            out_dtype=x.dtype, w_bits=quant.nested_bits)
        out = ops.ap_moe_expert_linear(
            h, params["w_down"], counts=counts_e, a_bits=quant.a_bits,
            variant=quant.variant, out_dtype=x.dtype,
            w_bits=quant.nested_bits)                          # (E, G*C, d)
    else:
        def bmm(w, a):
            return torch.einsum("eck,enk->ecn", a, w.to(a.dtype))
        up, gate = bmm(params["w_up"], disp_e), bmm(params["w_gate"], disp_e)
        h = (silu_f32(gate.float()) * up.float()).to(x.dtype)
        out = bmm(params["w_down"], h)

    out_g = out.reshape(e, g, cap, d).transpose(0, 1)          # (G, E, C, d)
    out_flat = torch.cat([out_g.reshape(g, e * cap, d),
                          torch.zeros((g, 1, d), dtype=out.dtype,
                                      device=dev)], 1)
    y = torch.gather(out_flat, 1, idx)
    wgt = (top_p.reshape(g, tg * k)[..., None] * keep[..., None]) \
        .to(out.dtype)
    y = (y * wgt).reshape(g, tg, k, d).sum(2).reshape(t, d)

    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, cfg, quant=quant)

    aux = stats = None
    if with_aux:    # Switch-style load-balance auxiliary loss
        frac_tokens = F.one_hot(top_e[..., 0].reshape(-1), e).float().mean(0)
        frac_probs = probs.reshape(-1, e).mean(0)
        aux = e * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef
    if with_stats:
        routed = oh.sum((0, 1), dtype=torch.int32)             # (E,)
        load = counts.sum(0, dtype=torch.int32)                # (E,)
        stats = {"load": load,
                 "dropped": (routed - load).sum(dtype=torch.int32),
                 "capacity": torch.tensor(e * cap * g, dtype=torch.int32)}
    return y.reshape(b, s, d), aux, stats
