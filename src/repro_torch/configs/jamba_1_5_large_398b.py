"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] -- hybrid Mamba+attn, MoE.

72L d_model=8192, attention every 8th layer (1:7 attn:mamba interleave),
64H (kv=8) d_ff=24576, MoE 16 experts top-2 applied every other layer,
vocab 65536.  Mamba sublayers: d_inner 16384, state 128, headdim 128
(128 SSM heads), 8 groups.  Scan unit = the 8-layer hybrid group.
long_500k runs: 9 attention layers see the full KV; 63 mamba layers are
O(1) state updates.
"""

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    attn_every=8,
    n_experts=16,
    top_k=2,
    expert_d_ff=24576,
    moe_every=2,
    ssm_d_state=128,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_n_groups=8,
    ssm_chunk=128,
    quant=QuantConfig(w_bits=2, a_bits=8),
    max_seq_len=1048576,
)
