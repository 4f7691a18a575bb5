"""MiniCPM-2B [arXiv:2404.06395; hf] -- dense llama-like, WSD schedule.

40L d_model=2304 36H (kv=36, i.e. MHA) d_ff=5760 vocab=122753.
MiniCPM specifics: embedding scale 12, depth-scaled residuals
(1.4/sqrt(L)), logits scaled by d_model/256 (dim_model_base), tied
embeddings (the logits are a bf16 product with the embedding table).
"""

import numpy as np

from repro_torch.models.config import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    emb_scale=12.0,
    residual_scale=float(1.4 / np.sqrt(40)),
    logit_scale=256.0 / 2304.0,
    rope_theta=10000.0,
    quant=QuantConfig(w_bits=2, a_bits=8),
    max_seq_len=524288,
)
