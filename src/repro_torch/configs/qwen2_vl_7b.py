"""Qwen2-VL-7B [arXiv:2409.12191; hf] -- VLM backbone, M-RoPE.

28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064.  M-RoPE: rotary
position split into (temporal, height, width) sections (16, 24, 24) over
the 128-dim head half.  The vision frontend is a stub: the caller hands
precomputed patch embeddings (B, n_patches, d_model), added to the
leading token slots, plus (3, B, S) position ids.
"""

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    n_patches=1024,
    quant=QuantConfig(w_bits=2, a_bits=8),
    max_seq_len=524288,
)
