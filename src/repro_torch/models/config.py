"""Model configuration system.

One :class:`ModelConfig` describes every assigned architecture family
(dense / ssm / hybrid / moe / vlm / audio).  Configs are plain frozen
dataclasses -- hashable, so they can ride along jit static args -- and
every arch file in :mod:`repro_torch.configs` exports ``CONFIG``; its
``reduced()`` variant is the CPU test size.  A copy of the reference
package's ``repro.models.config`` (the port imports nothing of
``repro``), so both packages describe the same models.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Arbitrary-precision serving configuration (the paper's technique).

    ``w_bits``/``a_bits`` apply to every APLinear-able GEMM (attention,
    MLP, MoE experts, SSM projections).  Router and norm layers stay in
    bf16 .  ``w_bits=None`` disables weight
    quantization (bf16 serving baseline).

    ``kv_bits`` quantizes the decode KV cache to packed bipolar-INT bit
    planes with per-(token, head) absmax scales: cache HBM traffic and
    footprint scale with bits/element instead of 16 (the paper's bit-level
    storage applied to the tensor that dominates long-context serving).
    Any 1..8 bits; ``None`` falls back to ``ModelConfig.kv_bits`` and then
    to the bf16 cache.  Reads dequantize on the fly -- inside the paged
    attention kernel on the GPU, via torch recovery for CPU tensors
    (see :mod:`repro_torch.kernels.ops`).

    ``fused_linear`` routes every quantized GEMM through the one-kernel
    fused linear (``ops.ap_linear_fused``): activation quantize-pack in
    the GEMM prologue, bias/activation/residual epilogue, dual-GEMM
    gate/up for SwiGLU.  Bit-identical outputs to the unfused two-launch
    path -- ``False`` only for A/B benchmarking the unfused baseline.

    ``nested_bits`` serves a *nested* checkpoint at a lower width than
    it was packed at: weights stay stored once at ``w_bits`` with
    per-width scale vectors, and every quantized GEMM ships only the
    leading ``nested_bits`` bit planes (``bipolar.nested_slice`` -- no
    requantization, weight HBM traffic scales with the served width).
    ``None`` serves the full stored width.  The engine's per-request
    precision lanes are realized as ``dataclasses.replace(quant,
    nested_bits=k)`` per lane.

    ``precision_floor`` is the load-adaptive tier policy's lower bound:
    under queue pressure the engine may degrade a request's served
    width down to -- never below -- this floor (``None`` disables
    degradation entirely).  See ``engine.tier_bits``.

    All bit-width fields are validated up front (descriptive
    ``ValueError`` instead of a shape error deep inside pack/dispatch).
    """
    w_bits: Optional[int] = None
    a_bits: int = 8
    variant: str = "fused"          # "fused" | "bitserial" (paper-faithful)
    kv_bits: Optional[int] = None   # bipolar KV-cache bits (1..8)
    fused_linear: bool = True       # one-kernel linear w/ fused epilogue
    nested_bits: Optional[int] = None   # served weight width (<= w_bits)
    precision_floor: Optional[int] = None  # tier-policy lower bound

    def __post_init__(self):
        def _chk(name, v, lo, hi):
            if v is not None and not (isinstance(v, int)
                                      and lo <= v <= hi):
                raise ValueError(
                    f"QuantConfig.{name}={v!r} out of range: expected an "
                    f"int in [{lo}, {hi}] or None")
        _chk("w_bits", self.w_bits, 1, 8)
        _chk("a_bits", self.a_bits, 1, 8)
        _chk("kv_bits", self.kv_bits, 1, 8)
        _chk("nested_bits", self.nested_bits, 1, 8)
        _chk("precision_floor", self.precision_floor, 1, 8)
        if self.a_bits is None:
            raise ValueError("QuantConfig.a_bits must be set (1..8)")
        if self.variant not in ("fused", "bitserial"):
            raise ValueError(
                f"QuantConfig.variant={self.variant!r}: expected 'fused' "
                f"or 'bitserial'")
        if self.nested_bits is not None:
            if self.w_bits is None:
                raise ValueError(
                    "QuantConfig.nested_bits requires w_bits (the stored "
                    "max width of the nested checkpoint)")
            if self.nested_bits > self.w_bits:
                raise ValueError(
                    f"QuantConfig.nested_bits={self.nested_bits} exceeds "
                    f"the stored width w_bits={self.w_bits}: a nested "
                    f"slice can only drop planes, not add them")
        if self.precision_floor is not None:
            top = self.nested_bits if self.nested_bits is not None \
                else self.w_bits
            if top is not None and self.precision_floor > top:
                raise ValueError(
                    f"QuantConfig.precision_floor={self.precision_floor} "
                    f"> max served width {top}: the tier policy could "
                    f"never satisfy the floor")

    @property
    def enabled(self) -> bool:
        return self.w_bits is not None

    @property
    def serve_bits(self) -> Optional[int]:
        """Weight width actually served: ``nested_bits`` when nested
        slicing is active, else the stored ``w_bits``."""
        return self.nested_bits if self.nested_bits is not None \
            else self.w_bits


def effective_kv_bits(cfg: "ModelConfig",
                      quant: Optional[QuantConfig]) -> Optional[int]:
    """KV-cache bit width in effect: ``quant.kv_bits`` overrides
    ``cfg.kv_bits``; ``None`` = bf16 cache."""
    if quant is not None and quant.kv_bits is not None:
        return quant.kv_bits
    return cfg.kv_bits


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None    # default d_model // n_heads
    # --- normalization / activations ---
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "silu"               # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    # --- rope ---
    rope_theta: float = 10000.0
    rope_pct: float = 1.0           # partial rotary (stablelm 0.25, glm 0.5)
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    # --- attention ---
    window: Optional[int] = None    # sliding-window attention (mixtral)
    causal: bool = True
    # --- residual scaling (minicpm) ---
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_every: int = 1              # apply MoE every k-th layer (jamba: 2)
    first_dense: int = 0            # leading dense layers (deepseek-moe: 1)
    # --- SSM (mamba2) ---
    ssm_d_state: int = 0
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 128
    # --- hybrid (jamba): attention every k-th layer, rest mamba ---
    attn_every: int = 0             # 0 = family default
    # --- enc-dec (audio) ---
    enc_layers: int = 0
    frontend_dim: int = 0           # stub frontend embedding dim
    # --- vlm ---
    n_patches: int = 0              # stub patch-embedding count
    # --- serving quantization ---
    quant: QuantConfig = QuantConfig()
    # bipolar-INT KV cache (paper's bit-level storage applied to the KV
    # stream): decode KV traffic scales with bits/element instead of 16.
    # Any 1..8 bits; None = bf16 cache.  QuantConfig.kv_bits overrides
    # this at serve time (see effective_kv_bits).
    kv_bits: Optional[int] = None
    # bf16 attention probabilities in the chunked-softmax dataflow (the
    # running max/denominator stay f32); halves score HBM traffic where
    # a fused attention kernel is not in play
    attn_score_bf16: bool = False
    # --- misc ---
    dtype: str = "bfloat16"
    max_seq_len: int = 8192

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to 256 (TP x lane) so embeddings/logits shard over
        the model axis (Megatron-style vocab padding); pad logits are
        masked to -inf in the loss/sampling path."""
        return -(-self.vocab // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def layer_kind(self, idx: int) -> str:
        """Mixer kind of layer ``idx``: 'attn' | 'mamba'."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            every = self.attn_every or 8
            # jamba: 1 attention per `every` layers, placed mid-group
            return "attn" if idx % every == every // 2 else "mamba"
        return "attn"

    def ffn_kind(self, idx: int) -> str:
        """FFN kind of layer ``idx``: 'dense' | 'moe' | 'none'.

        'none' = mixer-only blocks (pure-SSM archs: mamba2 has no FFN)."""
        if self.n_experts == 0 and self.d_ff == 0:
            return "none"
        if self.n_experts == 0 or idx < self.first_dense:
            return "dense"
        return "moe" if (idx - self.first_dense) % self.moe_every == 0 else "dense"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM / hybrid / sliding-window archs."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), exact enough
        for MODEL_FLOPS = 6*N*D roofline accounting."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        dh = self.head_dim
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) \
            + (self.n_heads * dh) * d
        mlp_dense = 3 * d * self.d_ff
        moe = (self.n_experts + 2 * self.n_shared_experts) * 3 * d * self.expert_d_ff \
            + d * self.n_experts
        di = self.ssm_d_inner
        mamba = d * (2 * di + 2 * self.ssm_n_groups * self.ssm_d_state
                     + self.ssm_n_heads) + di * d \
            + self.ssm_d_conv * (di + 2 * self.ssm_n_groups * self.ssm_d_state)
        n_dec = self.n_layers
        for i in range(n_dec):
            total += attn if self.layer_kind(i) == "attn" else mamba
            total += moe if self.ffn_kind(i) == "moe" else mlp_dense
            total += 2 * d  # norms
        for _ in range(self.enc_layers):
            total += attn + mlp_dense + 2 * d
            total += attn + d  # decoder cross-attention + its norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if self.n_experts == 0:
            return self.param_count()
        full_moe = self.n_experts * 3 * self.d_model * self.expert_d_ff
        act_moe = self.top_k * 3 * self.d_model * self.expert_d_ff
        n_moe = sum(1 for i in range(self.n_layers) if self.ffn_kind(i) == "moe")
        return self.param_count() - n_moe * (full_moe - act_moe)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        d_model = 64
        small = dict(
            n_layers=min(self.n_layers, 4),
            d_model=d_model,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads * 4 // self.n_heads, 4)),
            d_head=16,
            d_ff=0 if self.d_ff == 0 else 128,   # keep SSM mixer-only
            vocab=256,
            ssm_d_state=16 if self.ssm_d_state else 0,
            ssm_head_dim=16 if self.ssm_d_state else 64,
            ssm_n_groups=1,
            ssm_chunk=16,
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            expert_d_ff=64 if self.n_experts else 0,
            # dropless at smoke-test scale: token drops are batch-size
            # dependent and would break prefill/decode consistency checks
            capacity_factor=4.0 if self.n_experts else 1.25,
            window=64 if self.window else None,
            enc_layers=min(self.enc_layers, 2),
            frontend_dim=d_model if self.frontend_dim else 0,
            n_patches=8 if self.n_patches else 0,
            max_seq_len=128,
            # M-RoPE sections must sum to (d_head * rope_pct) / 2 = 8
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
