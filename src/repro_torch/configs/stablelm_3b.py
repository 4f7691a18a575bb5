"""StableLM-2 [hf:stabilityai/stablelm-2-1_6b; unverified] -- dense.

32L d_model=2560 32H (kv=32, MHA) d_ff=6912 vocab=50304.
StableLM-2 family traits: partial rotary (25%), LayerNorm, SwiGLU.
Head dim 80 pads to three packed words (96) in the KV planes.
"""

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    norm_type="layernorm",
    rope_pct=0.25,
    rope_theta=10000.0,
    quant=QuantConfig(w_bits=3, a_bits=8),
    max_seq_len=524288,
)
