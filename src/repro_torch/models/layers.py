"""Layers of the dense decoder, in torch: linear, embedding, norm, RoPE,
paged GQA attention over the bipolar KV pool, SwiGLU/GELU MLP.

A port of the dense subset of the reference ``repro.models.layers``, with
the same functional shape: ``<layer>_init(...) -> params`` and
``<layer>_apply(params, x, ...) -> y`` over plain dicts.  Linear weights
are stored ``(d_out, d_in)``; serving-time quantization replaces a weight
leaf with a :class:`BipolarTensor` and ``linear_apply`` dispatches on it
to the fused quantized linear (:func:`repro_torch.kernels.ops.ap_linear_fused`).

Attention runs on the paged block pool only (the serving engine's path):
new K/V are quantized to bipolar planes, scattered into the request's
blocks, and read back through :func:`repro_torch.kernels.ops.paged_kv_cache_attention`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import bipolar
from repro_torch.core.bipolar import BipolarTensor
from repro_torch.kernels import ops
from repro_torch.kernels.ref import apply_act
from repro_torch.models.config import ModelConfig


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
    """``y (..., N) = epi(x (..., K) @ W (N, K)^T)`` -- bf16, or the fused
    quantized linear when the weight leaf is a :class:`BipolarTensor`."""
    w = params["w"]
    if _use_fused_linear(w, quant):
        return ops.ap_linear_fused(x, w, a_bits=quant.a_bits, act=act,
                                   residual=residual, variant=quant.variant,
                                   out_dtype=x.dtype,
                                   w_bits=quant.nested_bits)
    if isinstance(w, BipolarTensor):
        raise NotImplementedError(
            "the unfused quantized linear (QuantConfig.fused_linear=False) "
            "is not ported yet (ROADMAP queue 1, item 8)")
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


def norm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"] + params["bias"]
    else:
        ms = torch.mean(torch.square(xf), -1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * params["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard / partial rotary)
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
    """Rotary embedding on ``x (B, S, H, D)`` at ``positions (B, S)``; only
    the leading ``rope_pct`` fraction of D rotates."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet "
                                  "(ROADMAP queue 1, item 7)")
    d = x.shape[-1]
    rot = int(d * cfg.rope_pct)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    cos, sin = _rope_angles(positions, rot, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# Attention over the paged bipolar KV pool
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


def attention_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, cache: dict, quant=None,
                    residual: Optional[torch.Tensor] = None):
    """GQA attention of ``x (B, S, d_model)`` through the paged KV pool.

    ``cache`` is one layer's pool (``k``/``v`` ``(n_blocks, bs, H,
    kv_bits, Dw)`` int32 planes, ``k_scale``/``v_scale`` ``(n_blocks, bs,
    H, 1)``, ``pos (n_blocks, bs)``) with this step's ``block_tables (B,
    NB)``, ``length (B,)`` and ``block_offset (B,)``.  The ``s`` new
    tokens of row b land at slots ``length[b] + i`` -- physically
    ``(table[slot // bs - block_offset[b]], slot % bs)``: the table is a
    rolling window when leading blocks were reclaimed.  Pad tokens
    (position -1) are dropped at the scatter.  The pool tensors are
    updated IN PLACE (the reference returns new arrays; here the pool is
    the one copy on the device).  ``residual`` (the block input) is fused
    into the output projection's epilogue.  Returns ``(out, cache)``.
    """
    if cache is None or "block_tables" not in cache:
        raise NotImplementedError(
            "repro_torch attention runs on the paged pool only; the "
            "contiguous and cache-free paths are not ported yet (ROADMAP "
            "queue 1, items 3 and 8)")
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hk
    pos2d = positions

    q = linear_apply(params["wq"], x, quant=quant).reshape(b, s, h, dh)
    k = linear_apply(params["wk"], x, quant=quant).reshape(b, s, hk, dh)
    v = linear_apply(params["wv"], x, quant=quant).reshape(b, s, hk, dh)
    q = apply_rope(q, pos2d, cfg)
    k = apply_rope(k, pos2d, cfg)

    kv_bits = cache["k"].shape[-2]
    n_blocks, blk = cache["k"].shape[0], cache["k"].shape[1]
    bt, ln = cache["block_tables"], cache["length"]
    k_q, k_s = ops.quantize_kv(k, kv_bits)
    v_q, v_s = ops.quantize_kv(v, kv_bits)
    slot = ln[:, None] + torch.arange(s, dtype=torch.int32,
                                      device=x.device)[None, :]
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

    qg = q.reshape(b, s, hk, g, dh).permute(0, 2, 3, 1, 4).reshape(
        b, hk, g * s, dh)
    qp = pos2d[:, None, :].expand(b, g, s).reshape(b, g * s)
    o = ops.paged_kv_cache_attention(
        qg, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
        cache["pos"], bt, qp, d=dh, causal=cfg.causal, window=cfg.window)
    o = o.reshape(b, hk, g, s, dh).permute(0, 3, 1, 2, 4).reshape(
        b, s, h * dh).to(x.dtype)
    return linear_apply(params["wo"], o, quant=quant,
                        residual=residual), cache


def make_kv_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                  kv_bits: int, device) -> dict:
    """One layer's paged KV pool: ``(n_blocks, block_size)`` leading dims
    (physical block, in-block slot), packed bipolar planes ``(..., H,
    kv_bits, ceil(D/32))`` int32 + per-(token, head) scales, positions
    -1 (empty)."""
    if not kv_bits:
        raise ValueError("the paged pool stores packed bipolar planes: "
                         "set kv_bits")
    assert 1 <= kv_bits <= 8, f"kv_bits={kv_bits} outside 1..8"
    shape = (n_blocks, block_size, cfg.n_kv_heads)
    packed = shape + (kv_bits, bipolar.packed_words(cfg.head_dim))
    return {
        "pos": torch.full((n_blocks, block_size), -1, dtype=torch.int32,
                          device=device),
        "k": torch.zeros(packed, dtype=torch.int32, device=device),
        "v": torch.zeros(packed, dtype=torch.int32, device=device),
        "k_scale": torch.zeros(shape + (1,), dtype=torch.float32,
                               device=device),
        "v_scale": torch.zeros(shape + (1,), dtype=torch.float32,
                               device=device),
    }


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg)
    p = {"w_up": linear_init(gen, d, f, dt, device),
         "w_down": linear_init(gen, f, d, dt, device)}
    if cfg.act == "silu":
        p["w_gate"] = linear_init(gen, d, f, dt, device)
    return p


def mlp_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, quant=None,
              residual: Optional[torch.Tensor] = None):
    """SwiGLU / GELU MLP.  Quantized: gate and up run as ONE dual-GEMM
    fused-linear launch (``silu(gate) * up`` in its epilogue) and the down
    projection fuses the block residual."""
    if cfg.act == "silu":
        if _use_fused_linear(params["w_up"]["w"], quant):
            h = ops.ap_linear_fused(
                x, params["w_gate"]["w"], w2=params["w_up"]["w"],
                a_bits=quant.a_bits, act="silu", variant=quant.variant,
                out_dtype=x.dtype, w_bits=quant.nested_bits)
        else:
            up = linear_apply(params["w_up"], x, quant=quant)
            gate = linear_apply(params["w_gate"], x, quant=quant)
            h = (F.silu(gate.float()) * up.float()).to(x.dtype)
    else:
        h = linear_apply(params["w_up"], x, quant=quant, act="gelu")
    return linear_apply(params["w_down"], h, quant=quant, residual=residual)
