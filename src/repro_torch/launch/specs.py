"""Input specs of the port's model cells.

For now only the stub audio frontend's length: the encoder of an
enc-dec model (seamless-m4t-medium) takes ``enc_len(cfg, seq)`` frame
embeddings for a decoder sequence of ``seq`` tokens, and the engine
sizes each request's cross-attention rows by it.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig


def enc_len(cfg: ModelConfig, seq: int) -> int:
    """Stub audio-encoder frame count for a decoder length ``seq``:
    ``seq // 8``, at least 64 and at most 4096."""
    return min(max(seq // 8, 64), 4096)
