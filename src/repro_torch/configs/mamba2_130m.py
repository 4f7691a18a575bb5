"""Mamba2-130M [arXiv:2405.21060; unverified] -- attention-free SSM (SSD).

24L d_model=768, ssm_state=128, expand 2 (d_inner 1536), headdim 64
(24 SSM heads), 1 group, conv window 4, vocab 50280 (GPT-NeoX tok).
Sub-quadratic: decode is an O(1) state update.  No FFN (mixer-only
blocks) and tied embeddings, so its logits are a bf16 matmul.
"""

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,          # unused (attention-free); kept for config uniformity
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    ssm_d_state=128,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=1,
    ssm_chunk=128,
    quant=QuantConfig(w_bits=4, a_bits=8),
    max_seq_len=1048576,
)
