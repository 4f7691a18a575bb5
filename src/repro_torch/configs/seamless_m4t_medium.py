"""SeamlessM4T-medium [arXiv:2308.11596; hf] -- enc-dec, multimodal audio.

12+12L d_model=1024 16H (kv=16, MHA) d_ff=4096 vocab=256206.  The
encoder takes stub frame embeddings (a precomputed speech frontend);
the decoder is causal with cross-attention over the encoder's memory.
"""

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    frontend_dim=1024,
    act="gelu",
    norm_type="layernorm",
    quant=QuantConfig(w_bits=4, a_bits=8),
    max_seq_len=524288,
)
