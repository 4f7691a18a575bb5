"""DeepSeekMoE-16B [arXiv:2401.06066; hf] -- fine-grained MoE.

28L d_model=2048 16H (kv=16, MHA) vocab=102400.  MoE: 2 shared + 64
routed experts top-6, fine-grained expert d_ff=1408 (dense-equivalent
d_ff = 10944).  Layer 0 keeps a dense FFN (d_ff 10944) -- modeled as the
unrolled prelude; layers 1-27 are MoE.
"""

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    expert_d_ff=1408,
    first_dense=1,
    quant=QuantConfig(w_bits=3, a_bits=8),
    max_seq_len=524288,
)
