"""Llama-3-8B [arXiv:2407.21783; unverified] -- dense GQA, 128k vocab.

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=128256, rope theta 500k.
The 128k vocab exercises vocab-sharded embeddings + chunked CE loss.
"""

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    quant=QuantConfig(w_bits=2, a_bits=8, kv_bits=8),
    max_seq_len=524288,
)
