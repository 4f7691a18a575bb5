"""GLM-4-9B [hf:THUDM/glm-4-9b; hf] -- dense, extreme GQA (kv=2), RoPE.

40L d_model=4096 32H (kv=2) d_ff=13696 vocab=151552.  Partial rotary
(half dims), RMSNorm, SwiGLU.  Two KV heads serve 32 query heads: the
paged attention kernel runs a GQA group of 16 per KV head.
"""

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    rope_pct=0.5,
    rope_theta=10000.0,
    quant=QuantConfig(w_bits=2, a_bits=8),
    max_seq_len=524288,
)
