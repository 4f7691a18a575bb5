"""Mamba-2 (SSD, state-space duality) mixer, in torch.

A port of the reference ``repro.models.ssm``.  The chunked SSD algorithm
(Dao & Gu, arXiv:2405.21060) splits the sequence into chunks of length
L: within a chunk the output is an attention-like quadratic form with a
causal decay mask; across chunks a small recurrent state ``(B, H, P,
N)`` is carried, here by a Python loop over the chunks that streams each
chunk's off-diagonal output (the reference's ``lax.scan``).  Decode is
the O(1) exact recurrence on that state.

The in and out projections go through ``linear_apply``, so they are the
quantized linears (K1 on the card); the selective state update is not a
GEMM and stays f32 torch ops, as the reference keeps it in jnp outside
any Pallas kernel.  The float steps follow the reference's forms where
XLA's and torch's differ: ``softplus`` is ``logaddexp(x, 0)``, SiLU is
``ref.silu_f32`` and the gated norm runs the RMSNorm's XLA:CPU steps
(:func:`repro_torch.models.layers.rms_normalize`).

Caches are ``{"conv": (B, d_conv - 1, conv_dim) in the model's dtype,
"state": (B, H, P, N) f32}``; the paged engine hands them as slot rows
with ``slots (B,)`` (see :func:`ssm_apply`).  Unlike the reference,
which returns new arrays, slot rows are written in place.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import silu_f32
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_dtype, _normal, linear_apply,
                                       linear_init, rms_normalize)


def ssm_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, di = cfg.d_model, cfg.ssm_d_inner
    h, n, g = cfg.ssm_n_heads, cfg.ssm_d_state, cfg.ssm_n_groups
    conv_dim = di + 2 * g * n
    dt = _dtype(cfg)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((h,), generator=gen, device=device,
                   dtype=torch.float32) * (hi - lo) + lo
    # in_proj emits [z (di), xBC (di + 2*g*n), dt (h)]
    return {
        "in_proj": linear_init(gen, d, 2 * di + 2 * g * n + h, dt, device),
        "out_proj": linear_init(gen, di, d, dt, device),
        "conv_w": (_normal(gen, (cfg.ssm_d_conv, conv_dim), device)
                   / math.sqrt(cfg.ssm_d_conv)).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device,
                                          dtype=torch.float32)),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "norm_scale": torch.ones((di,), dtype=torch.float32, device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    (``F.softplus`` switches to the identity above a threshold of 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Causal cumulative sums: ``out[..., i, j] = sum_{j < k <= i}
    a[..., k]``, -inf above the diagonal (the log-decay mask)."""
    length = a.shape[-1]
    cs = torch.cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((length, length), dtype=torch.bool,
                      device=a.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def _ssd_chunked(x, dt, a, b, c, chunk: int, init_state=None):
    """Chunked SSD scan.

    ``x (B, S, H, P)`` input, ``dt (B, S, H)`` softplus'd step, ``a (H,)``
    negative decay rates, ``b``/``c (B, S, G, N)``.  ``init_state (B, H,
    P, N)`` seeds the inter-chunk recurrence (chunked prefill continuing
    a cached state); None starts from zero.  Returns ``(y (B, S, H, P),
    final_state (B, H, P, N))``, both f32."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc, rep = s // chunk, h // g

    xd = (x * dt[..., None]).float()                   # input scaling
    adt = (a[None, None, :] * dt).float()              # (B, S, H) log decay
    xc = xd.reshape(bsz, nc, chunk, h, p)
    ac = adt.reshape(bsz, nc, chunk, h)
    bh = b.reshape(bsz, nc, chunk, g, n).float().repeat_interleave(rep, 3)
    ch = c.reshape(bsz, nc, chunk, g, n).float().repeat_interleave(rep, 3)

    # intra-chunk (quadratic, attention-like)
    lmat = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))  # (B, nc, H, L, L)
    scores = torch.einsum("bclhn,bcshn->bchls", ch, bh)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * lmat, xc)

    # chunk states
    a_cum = torch.cumsum(ac, dim=2)                    # (B, nc, L, H)
    a_tot = a_cum[:, :, -1, :]                         # (B, nc, H)
    decay_states = torch.exp(a_tot[:, :, None, :] - a_cum)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          bh * decay_states[..., None], xc)

    # inter-chunk recurrence, each chunk's off-diagonal output streamed
    state_decay = torch.exp(a_cum)                     # (B, nc, L, H)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    y_off = []
    for i in range(nc):
        y_off.append(torch.einsum("blhn,bhpn->blhp", ch[:, i], state)
                     * state_decay[:, i, :, :, None])
        state = state * torch.exp(a_tot[:, i])[:, :, None, None] \
            + states[:, i]
    y = y_diag + torch.stack(y_off, 1)
    return y.reshape(bsz, s, h, p), state


def _conv_silu(window: torch.Tensor, params: dict) -> torch.Tensor:
    """Depthwise causal conv over the last ``d_conv`` rows of each window
    ``(..., d_conv, C)``, f32, then SiLU."""
    w = params["conv_w"].float()
    acc = window[..., 0, :].float() * w[0]
    for i in range(1, w.shape[0]):
        acc = acc + window[..., i, :].float() * w[i]
    return silu_f32(acc + params["conv_b"].float())


def ssm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              cache: Optional[dict] = None, quant=None):
    """Mamba-2 mixer over ``x (B, S, d_model)``; returns ``(y,
    new_cache)`` (``new_cache`` None without a cache).

    With ``cache`` and S == 1 (decode) the conv buffer and SSD state
    advance in O(1).  With ``cache`` and S > 1 (prefill, chunked
    prefill) the pass continues from the cached conv rows and SSD state
    and leaves the cache ready for the next chunk or decode step; a
    zeroed cache makes this the same as prefilling from scratch.

    Paged serving hands the cache as slot rows: ``conv``/``state`` are
    ``(n_slots + 1, ...)`` and ``cache["slots"] (B,)`` maps batch lanes
    to rows (row 0 the null slot, -1 a pad lane).  The batch's rows are
    gathered (a pad lane reads row 0), the recurrence runs on that local
    view, and the new rows are written back in place -- a pad lane's
    write is dropped."""
    if cache is not None and "slots" in cache:
        slots = cache["slots"]
        safe = torch.clamp(slots, 0, cache["state"].shape[0] - 1).long()
        local = {"conv": cache["conv"][safe], "state": cache["state"][safe]}
        y, new_local = ssm_apply(params, x, cfg, cache=local, quant=quant)
        # a pad lane writes row 0 back with its own contents (a masked
        # select would need a host sync; no real lane owns row 0)
        keep = slots >= 0
        for key in ("conv", "state"):
            buf, new = cache[key], new_local[key].to(cache[key].dtype)
            k = keep.reshape(keep.shape + (1,) * (new.ndim - 1))
            buf[safe] = torch.where(k, new, buf[0])
        return y, cache

    di = cfg.ssm_d_inner
    h, p, n, g = (cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state,
                  cfg.ssm_n_groups)
    conv_dim = di + 2 * g * n
    pad = cfg.ssm_d_conv - 1

    # under tensor parallelism x is the rank's part of the sequence and
    # in_proj gathers it: the mixer runs on the whole sequence
    zxbcdt = linear_apply(params["in_proj"], x, quant=quant)
    bsz, s, _ = zxbcdt.shape
    z, xbc, dt_raw = torch.split(zxbcdt, [di, conv_dim, h], dim=-1)
    dt = softplus(dt_raw.float() + params["dt_bias"])   # (B, S, H)
    a = -torch.exp(params["A_log"])                      # (H,) negative

    new_cache = None
    if cache is None or s > 1:
        # causal depthwise conv along S.  With a cache the buffer holds
        # the previous d_conv-1 raw xBC rows, so the pass continues where
        # the last chunk (or decode step) stopped; a fresh cache is
        # zeros, which is the zero padding exactly
        if cache is not None:
            xbc_p = torch.cat([cache["conv"].to(xbc.dtype), xbc], 1)
        else:
            xbc_p = F.pad(xbc, (0, 0, pad, 0))
        windows = torch.stack([xbc_p[:, i:i + s]
                               for i in range(cfg.ssm_d_conv)], 2)
        xbc_c = _conv_silu(windows, params)
        xs, b, c = torch.split(xbc_c, [di, g * n, g * n], dim=-1)
        xh = xs.reshape(bsz, s, h, p)
        bh = b.reshape(bsz, s, g, n)
        ch = c.reshape(bsz, s, g, n)
        pad_s = -s % cfg.ssm_chunk
        if pad_s:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad_s))
            dt = F.pad(dt, (0, 0, 0, pad_s))
            bh = F.pad(bh, (0, 0, 0, 0, 0, pad_s))
            ch = F.pad(ch, (0, 0, 0, 0, 0, pad_s))
        y, state = _ssd_chunked(xh, dt, a, bh, ch, cfg.ssm_chunk,
                                init_state=(None if cache is None
                                            else cache["state"]))
        # D skip connection on the conv'd input
        y = y[:, :s] + params["D"][None, None, :, None] * xh[:, :s]
        if cache is not None:
            # conv tail = the last d_conv-1 raw xBC rows of the continued
            # buffer (a chunk shorter than the window keeps the older
            # cached rows it still needs)
            new_cache = dict(cache, state=state,
                             conv=xbc_p[:, s:s + pad].to(cache["conv"].dtype))
    else:
        conv_buf = cache["conv"]
        window = torch.cat([conv_buf, xbc.to(conv_buf.dtype)], 1)
        xbc_c = _conv_silu(window, params)
        xs, b, c = torch.split(xbc_c, [di, g * n, g * n], dim=-1)
        xh = xs.reshape(bsz, h, p)
        bh = b.reshape(bsz, g, n).repeat_interleave(h // g, 1)
        ch = c.reshape(bsz, g, n).repeat_interleave(h // g, 1)
        dt1 = dt[:, 0, :]                                # (B, H)
        decay = torch.exp(a[None, :] * dt1)
        upd = (xh * dt1[..., None])[..., None] * bh[:, :, None, :]
        state = cache["state"] * decay[:, :, None, None] + upd
        y1 = torch.einsum("bhpn,bhn->bhp", state, ch)
        y1 = y1 + params["D"][None, :, None] * xh
        y = y1[:, None]                                  # (B, 1, H, P)
        new_cache = dict(cache, conv=window[:, 1:], state=state)

    y = y.reshape(bsz, s, di)
    # gated RMSNorm (mamba2's norm before the out projection)
    yz = rms_normalize(y * silu_f32(z.float()), params["norm_scale"], 1e-5)
    out = linear_apply(params["out_proj"], yz.to(x.dtype), quant=quant)
    return out, new_cache


def make_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device="cuda") -> dict:
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_d_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_n_heads, cfg.ssm_head_dim,
                              cfg.ssm_d_state), dtype=torch.float32,
                             device=device),
    }
