"""Model assembly of the decoders (dense, MoE, SSM, hybrid, the VLM
backbone) and the enc-dec model, in torch.

A port of the reference ``repro.models.model``: the layer plan,
parameter init, the block (a pre-norm mixer -- attention, with the
residual fused into the quantized output projection, or the Mamba-2
mixer of :mod:`repro_torch.models.ssm` -- then, in an enc-dec decoder,
cross-attention over the encoder's memory, then a dense MLP, a MoE or,
for mamba2, nothing), the audio encoder (:func:`encode_frames`), the
decode caches, the forward pass over the paged pool, a contiguous
cache or no cache (training, each scan unit of the reference
rematerialised) as a Python loop over layers, the logits, the chunked
cross-entropy loss (:func:`loss_fn`), and serving-time quantization
(:func:`quantize_params`).

Parameters are a plain dict: ``embed``, ``final_norm``, ``layers`` (a
list with one dict per layer, the prelude's leading dense layers first;
the reference keeps those in ``prelude`` and stacks the rest for
``lax.scan``) and ``lm_head``; an enc-dec model adds ``encoder``
(``frontend``, ``layers``: one block per encoder layer, ``final_norm``)
and ``cross`` (one ``{attn, norm}`` per decoder layer after the
prelude).  Entry points take an explicit ``device`` and default to the
card: they raise when none is present and never run on the CPU unless
asked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.bipolar import BipolarTensor, dtype_scalar
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import (ModelConfig, QuantConfig,
                                       effective_kv_bits)


LOSS_CHUNK = 512   # sequence chunk of the CE loss (bounds logits memory)


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
    """The port covers every family of the reference: dense, MoE, SSM,
    hybrid, VLM and audio (enc-dec), each layer an attention or mamba
    mixer, then a dense, MoE or no FFN."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm",
                          "audio") or any(
            mk not in ("attn", "mamba") or fk not in ("dense", "moe", "none")
            for mk, fk in layer_plan(cfg)):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): repro_torch runs dense, MoE, SSM, "
            f"hybrid, VLM and enc-dec stacks of attention or mamba mixers "
            f"and dense, MoE or no FFNs")


def moe_stats_order(cfg: ModelConfig) -> list:
    """Layer indices of the MoE layers in the reference's telemetry row
    order: prelude layers first, then each position of the scanned unit
    with its units in order."""
    prelude, unit, n_units = plan_split(cfg)
    fd, ul = len(prelude), len(unit)
    order = [i for i, (_, fk) in enumerate(prelude) if fk == "moe"]
    for p, (_, fk) in enumerate(unit):
        if fk == "moe":
            order += [fd + u * ul + p for u in range(n_units)]
    return order


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen, cfg: ModelConfig, mixer_kind: str, ffn_kind: str,
                device) -> dict:
    p = {"norm1": L.norm_init(cfg.d_model, cfg, device),
         "mixer": (L.attention_init(gen, cfg, device) if mixer_kind == "attn"
                   else S.ssm_init(gen, cfg, device))}
    if ffn_kind != "none":
        p["norm2"] = L.norm_init(cfg.d_model, cfg, device)
        p["ffn"] = (L.moe_init(gen, cfg, device) if ffn_kind == "moe"
                    else L.mlp_init(gen, cfg, device))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                quant: Optional[QuantConfig] = None) -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``).  With ``quant`` enabled every linear is quantized right
    after its layer is made, so a full-size model never sits in bf16 at
    once; the quantization (and its bit-plane pack) runs on ``device``.
    ``device="meta"`` (float parameters only) gives the tree's shapes and
    dtypes with no storage, as the reference's ``jax.eval_shape`` of its
    init does."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    dt = L._dtype(cfg)
    q = quant if quant is not None and quant.enabled else None

    def finish(tree):
        return quantize_params(tree, q) if q is not None else tree

    params: dict = {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt, dev),
        "final_norm": L.norm_init(cfg.d_model, cfg, dev),
        "layers": [],
    }
    for mixer_kind, ffn_kind in layer_plan(cfg):
        params["layers"].append(
            finish(_block_init(gen, cfg, mixer_kind, ffn_kind, dev)))
    if not cfg.tie_embeddings:
        params["lm_head"] = finish(
            {"lm_head": L.linear_init(gen, cfg.d_model, cfg.vocab_padded,
                                      dt, dev)})["lm_head"]
    if cfg.family == "audio":
        # the encoder (non-causal self-attention, MHA) behind the stub
        # frontend's projection, and one cross-attention with its norm
        # per decoder layer after the prelude
        enc_cfg = dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)
        params["encoder"] = {
            "frontend": finish({"frontend": L.linear_init(
                gen, cfg.frontend_dim, cfg.d_model, dt, dev)})["frontend"],
            "layers": [finish(_block_init(gen, enc_cfg, "attn", "dense",
                                          dev))
                       for _ in range(cfg.enc_layers)],
            "final_norm": L.norm_init(cfg.d_model, cfg, dev)}
        params["cross"] = [
            finish({"attn": L.attention_init(gen, cfg, dev),
                    "norm": L.norm_init(cfg.d_model, cfg, dev)})
            for _ in range(cfg.n_layers - cfg.first_dense)]
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(p, x, cfg: ModelConfig, mixer_kind: str, ffn_kind: str, *,
                 positions, cache, quant=None, moe_stats: bool = False,
                 causal: Optional[bool] = None, cross=None,
                 with_aux: bool = False):
    """One pre-norm block; returns ``(x, new_cache, stats, new_cross,
    aux)`` (``stats`` is :func:`repro_torch.models.layers.moe_apply`'s
    telemetry for a MoE block when ``moe_stats`` asks for it, ``aux`` its
    load-balance loss when ``with_aux`` does; else None).
    Quantized serving with ``fused_linear`` (and ``residual_scale == 1``)
    threads the block input as ``residual`` into the attention output
    projection and the dense MLP's down projection, so the residual add
    runs in the fused linear's epilogue; a mamba mixer and a MoE block
    add their residual after the fact, as the reference does.

    ``causal`` overrides ``cfg.causal`` (the encoder's blocks).  ``cross
    = (params, memory, cache)`` runs an enc-dec decoder's cross step
    between the mixer and the FFN: its norm, then
    :func:`repro_torch.models.layers.cross_attention_apply` over the
    encoder's ``memory`` (prefill) or its ``cache`` (decode), with the
    residual fused into its output projection likewise; ``new_cross`` is
    its cache (None without a cross step)."""
    rs = dtype_scalar(cfg.residual_scale, x.dtype)
    fuse_res = (quant is not None and quant.enabled and quant.fused_linear
                and cfg.residual_scale == 1.0)
    h = L.norm_apply(p["norm1"], x, cfg)
    if mixer_kind == "attn":
        h, new_cache = L.attention_apply(
            p["mixer"], h, cfg, positions=positions, cache=cache,
            causal=causal, quant=quant, residual=x if fuse_res else None)
        x = h if fuse_res else x + (h.float() * rs).to(x.dtype)
    else:
        h, new_cache = S.ssm_apply(p["mixer"], h, cfg, cache=cache,
                                   quant=quant)
        x = x + (h.float() * rs).to(x.dtype)
    new_cross = None
    if cross is not None:
        xp, memory, xc = cross
        hc = L.norm_apply(xp["norm"], x, cfg)
        hc, new_cross = L.cross_attention_apply(
            xp["attn"], hc, cfg, memory=memory, cache=xc, quant=quant,
            residual=x if fuse_res else None)
        x = hc if fuse_res else x + (hc.float() * rs).to(x.dtype)
    if ffn_kind == "none":
        return x, new_cache, None, new_cross, None
    h = L.norm_apply(p["norm2"], x, cfg)
    if ffn_kind == "moe":
        h, aux, stats = L.moe_apply(p["ffn"], h, cfg, quant=quant,
                                    with_aux=with_aux, with_stats=moe_stats)
        return (x + (h.float() * rs).to(x.dtype), new_cache, stats,
                new_cross, aux)
    h = L.mlp_apply(p["ffn"], h, cfg, quant=quant,
                    residual=x if fuse_res else None)
    x = h if fuse_res else x + (h.float() * rs).to(x.dtype)
    return x, new_cache, None, new_cross, None


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                quant: Optional[QuantConfig] = None, device="cuda",
                state_batch: Optional[int] = None,
                enc_len: Optional[int] = None) -> dict:
    """Decode caches: ``{"layers": [one cache per layer]}`` (prelude
    layers first, as in ``params["layers"]``): an attention layer's KV
    cache from :func:`repro_torch.models.layers.make_kv_cache`, a mamba
    layer's conv + SSD state from :func:`repro_torch.models.ssm
    .make_ssm_cache`.  ``quant.kv_bits`` (over ``cfg.kv_bits``) selects
    packed bipolar planes; without either the cache holds K/V in the
    model's dtype.

    The contiguous engine keeps ``batch`` request rows of ``max_len``
    slots (a ring of the window for SWA archs); the paged pool reuses
    this layout with ``batch=n_blocks, max_len=block_size`` (block 0 is
    its null block).  ``state_batch`` sizes the fixed-size per-request
    SSM leaves apart from the block count: they get ``state_batch`` rows
    (the pool's slot rows, row 0 its null slot) while attention leaves
    keep ``batch`` blocks; None gives both ``batch`` rows (the
    contiguous layout).

    An enc-dec model adds ``"cross"``: one cross-K/V cache per decoder
    layer after the prelude (:func:`repro_torch.models.layers
    .make_cross_cache`), ``enc_len`` encoder rows each (default
    ``launch.specs.enc_len(cfg, max_len)``; the paged pool passes its
    own, since its ``max_len`` is the block size), with the state leaves'
    ``state_batch`` rows: a request's cross rows are one more tenant of
    the pool's state slots."""
    check_supported(cfg)
    dev = resolve_device(device)
    kvb = effective_kv_bits(cfg, quant)
    sb = batch if state_batch is None else state_batch
    caches = {"layers": [
        L.make_kv_cache(cfg, batch, max_len, kvb, dev) if mk == "attn"
        else S.make_ssm_cache(cfg, sb, L._dtype(cfg), dev)
        for mk, _ in layer_plan(cfg)]}
    if cfg.family == "audio":
        if enc_len is None:
            from repro_torch.launch.specs import enc_len as _enc_len
            enc_len = _enc_len(cfg, max_len)
        caches["cross"] = [L.make_cross_cache(cfg, sb, enc_len, kvb, dev)
                           for _ in range(cfg.n_layers - cfg.first_dense)]
    return caches


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[dict] = None,
            patch_embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            quant: Optional[QuantConfig] = None, remat: bool = True,
            logits_mode: str = "none", collect_moe_stats: bool = False,
            with_aux: bool = False):
    """Run the stack over ``tokens (B, S)`` at ``positions (B, S)`` (-1 =
    pad; ``(3, B, S)`` for M-RoPE; default ``0..S-1`` on every row)
    through ``caches``: the paged pool's step caches (from
    :meth:`repro_torch.serving.paged_cache.PagedKVPool.step_caches`), the
    contiguous ones of :func:`init_caches`, or None (training, or a
    cache-free forward: every attention layer attends over the sequence,
    causal and windowed as the config says; every mamba mixer starts from
    a zero state).  Returns ``(hidden | last-position logits, caches)``
    (``caches`` None without caches).

    ``remat`` (the cache-free forward under autograd only) recomputes
    each unit of the reference's scan -- one layer of a uniform stack, a
    hybrid stack's whole ``attn_every`` group; the leading prelude layers
    are not rematerialised, as in the reference -- in the backward pass
    (``torch.utils.checkpoint``): the same values, a unit's input
    saved instead of its activations.

    ``patch_embeds (B, P, d)`` (the VLM's stub frontend) are added to the
    first ``P`` token embeddings.  ``frames (B, T, frontend_dim)`` (the
    audio stub frontend) run the encoder (:func:`encode_frames`), whose
    memory every decoder layer's cross-attention projects into its
    cache; an audio decode step without frames replays those caches.

    ``with_aux=True`` appends the f32 sum of the MoE layers' load-balance
    losses (0 without MoE layers), the reference's ``aux_total``.
    ``collect_moe_stats=True`` appends the per-MoE-layer capacity
    telemetry ``{"load": (L_moe, E), "dropped": (L_moe,), "capacity":
    (L_moe,)}`` (int32; rows in the reference's order, see
    :func:`moe_stats_order`; ``capacity`` comes from the shapes and lies
    on the host), or None if the stack has no MoE layers."""
    quant = quant if (quant and (quant.enabled or quant.kv_bits)) else None
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
    x = params["embed"]["w"][tokens.long()].to(L._dtype(cfg))
    x = (x.float() * dtype_scalar(cfg.emb_scale, x.dtype)).to(x.dtype)
    if patch_embeds is not None:     # the VLM's stub frontend
        npt = patch_embeds.shape[1]
        x = torch.cat([x[:, :npt] + patch_embeds.to(x.dtype), x[:, npt:]],
                      1)
    checkpointed = remat and caches is None and torch.is_grad_enabled()
    memory = None
    if cfg.family == "audio" and frames is not None:
        memory = encode_frames(params, frames, cfg, quant=quant,
                               remat=checkpointed)
    elif cfg.family == "audio":
        assert caches is not None and "cross" in caches, \
            "audio decode without frames needs filled cross caches"
    fd = cfg.first_dense
    plan = layer_plan(cfg)
    prelude, unit, _ = plan_split(cfg)
    n_prelude = len(prelude)
    cache_list = [None] * len(plan) if caches is None else caches["layers"]

    def run_layers(x, lo, hi):
        """Layers ``lo..hi-1``: ``(x, new caches, stats, new cross caches,
        aux sum or None)``."""
        ncs, nxcs, stats, aux = [], [], {}, None
        for i in range(lo, hi):
            mk, fk = plan[i]
            cross = None
            if "cross" in params and i >= fd:
                cross = (params["cross"][i - fd], memory,
                         caches["cross"][i - fd] if caches is not None
                         else None)
            x, nc, mst, nxc, a = _apply_block(
                params["layers"][i], x, cfg, mk, fk, positions=positions,
                cache=cache_list[i], quant=quant,
                moe_stats=collect_moe_stats, cross=cross, with_aux=with_aux)
            ncs.append(nc)
            if cross is not None:
                nxcs.append(nxc)
            if mst is not None:
                stats[i] = mst
            if a is not None:
                aux = a if aux is None else aux + a
        return x, ncs, stats, nxcs, aux

    new_layers, new_cross, layer_stats = [], [], {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    unit_aux = []
    spans = [(i, i + 1) for i in range(n_prelude)] + [
        (lo, lo + len(unit)) for lo in range(n_prelude, len(plan),
                                             len(unit))]
    for lo, hi in spans:
        if checkpointed and lo >= n_prelude:
            x, ncs, stats, nxcs, aux = checkpoint(
                run_layers, x, lo, hi, use_reentrant=False)
        else:
            x, ncs, stats, nxcs, aux = run_layers(x, lo, hi)
        new_layers += ncs
        new_cross += nxcs
        layer_stats.update(stats)
        if aux is not None:
            if lo < n_prelude:
                aux_total = aux_total + aux
            else:
                unit_aux.append(aux)
    if unit_aux:    # the reference adds its scan's per-unit sums at once
        aux_total = aux_total + torch.stack(unit_aux).sum()
    x = L.norm_apply(params["final_norm"], x, cfg)
    out = x
    if logits_mode == "last":
        out = _logits(params, x[:, -1:, :], cfg, quant)[:, 0]
    new_caches = None
    if caches is not None:
        new_caches = dict(caches, layers=new_layers)
        if "cross" in caches:
            new_caches["cross"] = new_cross
    ret = (out, new_caches)
    if with_aux:
        ret += (aux_total,)
    if not collect_moe_stats:
        return ret
    moe_stats = None
    if layer_stats:
        rows = [layer_stats[i] for i in moe_stats_order(cfg)]
        moe_stats = {kk: torch.stack([r[kk] for r in rows])
                     for kk in ("load", "dropped", "capacity")}
    return ret + (moe_stats,)


def encode_frames(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
                  quant: Optional[QuantConfig] = None,
                  remat: bool = False) -> torch.Tensor:
    """The enc-dec encoder: stub frontend embeddings ``frames (B, T,
    frontend_dim)`` -> memory ``(B, T, d_model)``.  The frontend linear,
    then each encoder block (MHA self-attention, not causal, at positions
    ``0..T-1``, then the dense MLP), then the final norm.  ``remat``
    recomputes each encoder block in the backward pass (one
    ``torch.utils.checkpoint`` a block, the reference's
    ``jax.checkpoint`` of its scan body); :func:`forward` asks for it
    under autograd without caches."""
    enc = params["encoder"]
    x = L.linear_apply(enc["frontend"], frames.to(L._dtype(cfg)),
                       quant=quant)
    b, t, _ = x.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device)[None].repeat(b, 1)
    enc_cfg = dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)

    def block(x, p):
        return _apply_block(p, x, enc_cfg, "attn", "dense",
                            positions=positions, cache=None, quant=quant,
                            causal=False)[0]

    for p in enc["layers"]:
        x = (checkpoint(block, x, p, use_reentrant=False) if remat
             else block(x, p))
    return L.norm_apply(enc["final_norm"], x, cfg)


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
# Loss (chunked over the sequence: logits never materialize at (B, S, V))
# ---------------------------------------------------------------------------

def loss_terms(params: dict, batch: dict, cfg: ModelConfig, *,
               quant: Optional[QuantConfig] = None, remat: bool = True):
    """The parts of :func:`loss_fn`: ``(nll, count, aux)``, the f32 sum of
    the masked tokens' negative log-likelihoods, their count and the MoE
    load-balance loss (0 without MoE layers).  A data-parallel step sums
    ``nll`` and ``count`` over its ranks before it divides."""
    x, _, aux = forward(params, batch["tokens"], cfg,
                        positions=batch.get("positions"),
                        patch_embeds=batch.get("patch_embeds"),
                        frames=batch.get("frames"), quant=quant,
                        remat=remat, with_aux=True)
    labels = batch["labels"].long()
    mask = batch.get("mask")
    mask = (labels >= 0) if mask is None else (mask > 0)
    b, s, _ = x.shape
    chunk = min(LOSS_CHUNK, s)
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    labels = torch.clamp(labels, min=0)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[1], chunk):
        logits = _logits(params, x[:, lo:lo + chunk], cfg, quant).float()
        lse = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, labels[:, lo:lo + chunk, None])[..., 0]
        ms = mask[:, lo:lo + chunk]
        tot = tot + ((lse - gold) * ms).sum()
        cnt = cnt + ms.sum()
    return tot, cnt, aux


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            quant: Optional[QuantConfig] = None, remat: bool = True):
    """Causal-LM cross-entropy plus the MoE load-balance loss, the
    reference's ``loss_fn``.  ``batch``: ``tokens``, ``labels`` (B, S)
    and optionally ``positions`` (``(3, B, S)`` for M-RoPE), ``mask``
    (labels < 0 are masked unless a mask is given), the VLM's
    ``patch_embeds`` and the enc-dec model's ``frames`` (all as
    :func:`repro_torch.launch.specs.make_batch` lays them out).  The
    final hidden states go through the logits ``LOSS_CHUNK`` positions
    at a time (the vocab's pad columns at -1e30), each chunk's logits in
    f32 before ``logsumexp``; the summed NLL is divided by ``max(count,
    1)``, then the aux is added.  Every family: dense, MoE, SSM, hybrid,
    VLM and enc-dec."""
    tot, cnt, aux = loss_terms(params, batch, cfg, quant=quant, remat=remat)
    return tot / torch.clamp(cnt, min=1.0) + aux


# ---------------------------------------------------------------------------
# Serving-time quantization
# ---------------------------------------------------------------------------

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
               "in_proj", "out_proj", "lm_head", "frontend")


def quantize_params(params: Any, qcfg: QuantConfig) -> Any:
    """Replace every quantizable linear weight (the audio frontend's
    among them), and every stacked expert weight ``(E, N, K)``, with
    packed bipolar planes (router, norms, embeddings and the SSM's conv,
    decay and skip parameters stay as they are)."""
    if not qcfg.enabled:
        return params
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k in _QUANT_KEYS and isinstance(v, dict) and "w" in v \
                    and not isinstance(v["w"], BipolarTensor):
                out[k] = {"w": _quantize_leaf(v["w"], qcfg)}
            elif k in ("w_up", "w_gate", "w_down") \
                    and isinstance(v, torch.Tensor) and v.ndim == 3:
                out[k] = _quantize_experts(v, qcfg)
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


def _quantize_experts(w: torch.Tensor, qcfg: QuantConfig) -> BipolarTensor:
    """Pack a stacked expert weight ``(E, N, K)`` one expert at a time:
    packed ``(w_bits, E, N, Kw)``, scale ``(E, N, 1)``, nested scales
    ``(w_bits, E, N, 1)``.  Scales are per row, so this is bit-identical
    to packing the ``(E*N, K)`` leaf at once, and the f32 transients of
    the clip search stay one expert's size."""
    parts = [_quantize_leaf(w[i], qcfg) for i in range(w.shape[0])]
    ws = None
    if parts[0].width_scales is not None:
        ws = torch.stack([t.width_scales for t in parts], 1)
    return BipolarTensor(packed=torch.stack([t.packed for t in parts], 1),
                         scale=torch.stack([t.scale for t in parts]),
                         n_bits=qcfg.w_bits, shape=tuple(w.shape),
                         pack_axis=2, width_scales=ws)
