"""Input specs for every (architecture x input-shape) cell.

``input_specs(cfg, shape)`` returns tensors on the ``meta`` device as
stand-ins (the shapes and dtypes of a cell's inputs, no storage): int32
tokens, labels and positions, the config's dtype for the stub
frontends' embeddings.  ``make_batch`` materialises small real batches
for tests and smoke runs, drawn from ``np.random.default_rng(seed)`` in
the same order as the reference's, so that every array equals the
reference's bit for bit.

Shape registry:
  train_4k     seq 4096,   global_batch 256   -> a training step
  prefill_32k  seq 32768,  global_batch 32    -> a prefill step
  decode_32k   seq 32768,  global_batch 128   -> a decode step (1 new
                                                token, KV cache of seq)
  long_500k    seq 524288, global_batch 1     -> a decode step; needs
                                                sub-quadratic attention
Modality frontends are stubs: the enc-dec model takes precomputed frame
embeddings, the VLM precomputed patch embeddings (+ 3-axis M-RoPE ids).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode"),
}


def cell_runnable(cfg: ModelConfig, shape_name: str):
    """-> (runnable, reason).  long_500k needs sub-quadratic attention."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention; 500k-token decode "
                       "requires SSM/hybrid/sliding-window")
    return True, ""


def enc_len(cfg: ModelConfig, seq: int) -> int:
    """Stub audio-encoder frame count for a decoder length ``seq``:
    ``seq // 8``, at least 64 and at most 4096."""
    return min(max(seq // 8, 64), 4096)


def _token_specs(cfg: ModelConfig, batch: int, seq: int, mode: str,
                 device="meta") -> dict:
    """``{name: empty tensor}`` of one cell's inputs, in the reference's
    key order (the order ``make_batch`` draws them in)."""
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    s = seq if mode != "decode" else 1
    specs = {"tokens": spec((batch, s), i32)}
    if mode == "train":
        specs["labels"] = spec((batch, s), i32)
    if cfg.family == "vlm":
        npt = min(cfg.n_patches, s)
        specs["positions"] = spec((3, batch, s), i32)
        if mode != "decode":
            specs["patch_embeds"] = spec((batch, npt, cfg.d_model), dt)
    if cfg.family == "audio" and mode != "decode":
        specs["frames"] = spec((batch, enc_len(cfg, seq), cfg.frontend_dim),
                               dt)
    if mode == "decode":
        specs["positions"] = (spec((3, batch, 1), i32)
                              if cfg.family == "vlm"
                              else spec((batch, 1), i32))
    return specs


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """One shape cell's inputs as ``meta`` tensors."""
    sh = SHAPES[shape_name]
    return _token_specs(cfg, sh["batch"], sh["seq"], sh["mode"])


def make_batch(cfg: ModelConfig, batch: int, seq: int, mode: str = "train",
               seed: int = 0, device="cuda") -> dict:
    """A random batch matching the spec, on ``device``: token ids (and
    labels) uniform in ``[0, vocab)``, positions ``0..S-1`` on every row
    (and M-RoPE axis), embeddings ``0.1 * N(0, 1)`` drawn in f32 and cast
    to the config's dtype."""
    from repro_torch.models.model import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in _token_specs(cfg, batch, seq, mode).items():
        shape = tuple(spec.shape)
        if spec.dtype == torch.int32:
            if k == "positions":
                arr = np.broadcast_to(np.arange(shape[-1], dtype=np.int32),
                                      shape)
            else:
                arr = rng.integers(0, cfg.vocab, shape, dtype=np.int32)
            out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        else:
            arr = rng.standard_normal(shape).astype(np.float32) * 0.1
            out[k] = torch.from_numpy(arr).to(device).to(spec.dtype)
    return out
