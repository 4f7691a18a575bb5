"""Model assembly of the dense decoder, in torch.

A port of the dense path of the reference ``repro.models.model``: the
layer plan, parameter init, the block (pre-norm attention + MLP with the
residual fused into the quantized linears' epilogues), the paged-pool
caches, the forward pass as a Python loop over layers, the logits, and
serving-time quantization (:func:`quantize_params`).

Parameters are a plain dict: ``embed``, ``final_norm``, ``layers`` (a
list with one dict per layer; the reference stacks them for
``lax.scan``) and ``lm_head``.  Entry points take an explicit ``device``
and default to the card: they raise when none is present and never run
on the CPU unless asked.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.bipolar import BipolarTensor, dtype_scalar
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import (ModelConfig, QuantConfig,
                                       effective_kv_bits)


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain torch versions of the kernels on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig):
    """[(mixer_kind, ffn_kind)] for the decoder stack."""
    return [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.n_layers)]


def plan_split(cfg: ModelConfig):
    """-> (prelude_plan, unit_plan, n_units): the smallest repeating unit
    of the post-prelude plan (the reference scans it; the bridge uses it
    to unstack the reference's scanned parameters)."""
    plan = layer_plan(cfg)
    prelude = plan[:cfg.first_dense]
    rest = plan[cfg.first_dense:]
    for ul in range(1, len(rest) + 1):
        if len(rest) % ul:
            continue
        unit = rest[:ul]
        if all(rest[i:i + ul] == unit for i in range(0, len(rest), ul)):
            return prelude, unit, len(rest) // ul
    return prelude, rest, 1


def check_supported(cfg: ModelConfig) -> None:
    """The port covers the dense decoder (attention + dense FFN)."""
    if cfg.family != "dense" or any(
            kinds != ("attn", "dense") for kinds in layer_plan(cfg)):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: repro_torch "
            f"runs dense decoders (ROADMAP queue 1, items 5-7)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen, cfg: ModelConfig, device) -> dict:
    return {"norm1": L.norm_init(cfg.d_model, cfg, device),
            "mixer": L.attention_init(gen, cfg, device),
            "norm2": L.norm_init(cfg.d_model, cfg, device),
            "ffn": L.mlp_init(gen, cfg, device)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                quant: Optional[QuantConfig] = None) -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``).  With ``quant`` enabled every linear is quantized right
    after its layer is made, so a full-size model never sits in bf16 at
    once; the quantization (and its bit-plane pack) runs on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = L._dtype(cfg)
    q = quant if quant is not None and quant.enabled else None

    def finish(tree):
        return quantize_params(tree, q) if q is not None else tree

    params: dict = {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt, dev),
        "final_norm": L.norm_init(cfg.d_model, cfg, dev),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append(finish(_block_init(gen, cfg, dev)))
    if not cfg.tie_embeddings:
        params["lm_head"] = finish(
            {"lm_head": L.linear_init(gen, cfg.d_model, cfg.vocab_padded,
                                      dt, dev)})["lm_head"]
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(p, x, cfg: ModelConfig, *, positions, cache, quant=None):
    """One pre-norm block.  Quantized serving with ``fused_linear`` (and
    ``residual_scale == 1``) threads the block input as ``residual`` into
    the attention output projection and the MLP down projection, so the
    residual add runs in the fused linear's epilogue."""
    rs = dtype_scalar(cfg.residual_scale, x.dtype)
    fuse_res = (quant is not None and quant.enabled and quant.fused_linear
                and cfg.residual_scale == 1.0)
    h = L.norm_apply(p["norm1"], x, cfg)
    h, new_cache = L.attention_apply(
        p["mixer"], h, cfg, positions=positions, cache=cache, quant=quant,
        residual=x if fuse_res else None)
    x = h if fuse_res else x + (h.float() * rs).to(x.dtype)
    h = L.norm_apply(p["norm2"], x, cfg)
    h = L.mlp_apply(p["ffn"], h, cfg, quant=quant,
                    residual=x if fuse_res else None)
    x = h if fuse_res else x + (h.float() * rs).to(x.dtype)
    return x, new_cache


def init_caches(cfg: ModelConfig, n_blocks: int, block_size: int,
                quant: Optional[QuantConfig] = None, device="cuda") -> dict:
    """The paged KV pool: ``{"layers": [one pool per layer]}``, each of
    ``n_blocks`` blocks of ``block_size`` tokens (block 0 is the null
    block).  ``quant.kv_bits`` (over ``cfg.kv_bits``) sets the planes."""
    check_supported(cfg)
    dev = resolve_device(device)
    kvb = effective_kv_bits(cfg, quant)
    return {"layers": [L.make_kv_cache(cfg, n_blocks, block_size, kvb, dev)
                       for _ in range(cfg.n_layers)]}


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions: torch.Tensor, caches: dict,
            quant: Optional[QuantConfig] = None,
            logits_mode: str = "none"):
    """Run the stack over ``tokens (B, S)`` at ``positions (B, S)`` (-1 =
    pad) through the paged ``caches`` (from
    :meth:`repro_torch.serving.paged_cache.PagedKVPool.step_caches`).
    Returns ``(hidden | last-position logits, caches)``."""
    quant = quant if (quant and (quant.enabled or quant.kv_bits)) else None
    x = params["embed"]["w"][tokens.long()].to(L._dtype(cfg))
    x = (x.float() * dtype_scalar(cfg.emb_scale, x.dtype)).to(x.dtype)
    new_layers = []
    for p, c in zip(params["layers"], caches["layers"]):
        x, nc = _apply_block(p, x, cfg, positions=positions, cache=c,
                             quant=quant)
        new_layers.append(nc)
    x = L.norm_apply(params["final_norm"], x, cfg)
    out = x
    if logits_mode == "last":
        out = _logits(params, x[:, -1:, :], cfg, quant)[:, 0]
    return out, dict(caches, layers=new_layers)


def _logits(params, x, cfg: ModelConfig, quant=None):
    x = (x.float() * dtype_scalar(cfg.logit_scale, x.dtype)).to(x.dtype)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"]["w"].to(x.dtype).T)
    else:
        logits = L.linear_apply(params["lm_head"], x, quant=quant)
    if cfg.vocab_padded > cfg.vocab:    # mask vocab-padding slots
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Serving-time quantization
# ---------------------------------------------------------------------------

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
               "lm_head")


def quantize_params(params: Any, qcfg: QuantConfig) -> Any:
    """Replace every quantizable linear weight with packed bipolar planes
    (norms and embeddings stay as they are)."""
    if not qcfg.enabled:
        return params
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k in _QUANT_KEYS and isinstance(v, dict) and "w" in v \
                    and not isinstance(v["w"], BipolarTensor):
                out[k] = {"w": _quantize_leaf(v["w"], qcfg)}
            else:
                out[k] = quantize_params(v, qcfg)
        return out
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_params(v, qcfg) for v in params)
    return params


def _quantize_leaf(w: torch.Tensor, qcfg: QuantConfig) -> BipolarTensor:
    """Pack a weight ``(N, K)`` along K on its own device (K3 on the
    card): packed ``(w_bits, N, Kw)``, scale ``(N, 1)``, nested
    per-width scales ``(w_bits, N, 1)``."""
    shape = tuple(w.shape)
    t = ops.quantize_rows(w.reshape(-1, shape[-1]).float(), qcfg.w_bits,
                          pad_bit=1, scale_search=True)
    kw = t.packed.shape[-1]
    width_scales = None
    if t.width_scales is not None:
        width_scales = t.width_scales.reshape(t.n_bits, *shape[:-1], 1)
    return BipolarTensor(packed=t.packed.reshape(qcfg.w_bits, *shape[:-1], kw),
                         scale=t.scale.reshape(*shape[:-1], 1),
                         n_bits=qcfg.w_bits, shape=shape,
                         pack_axis=len(shape) - 1, width_scales=width_scales)
