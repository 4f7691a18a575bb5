"""Mixtral-8x7B [arXiv:2401.04088; hf] -- MoE 8e top-2 + sliding window.

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000.  Every FFN is MoE
(8 experts, top-2).  Sliding-window attention (window 4096) => decode
cost is context-independent: the paged pool reclaims blocks that fall
out of the window.
"""

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    window=4096,
    n_experts=8,
    top_k=2,
    expert_d_ff=14336,
    quant=QuantConfig(w_bits=2, a_bits=8, kv_bits=8),
    max_seq_len=1048576,
)
