"""Bisect the card-vs-CPU training-step gap of qwen2-vl-7b and
seamless-m4t-medium against minicpm-2b's, one family feature at a time.

Each case is one gradient step at full width and 2 layers (seamless:
2 + 2), 2 x 128 tokens of a ``make_batch`` train batch, on the card and
on the CPU from the same parameters, through ``chip_smoke.
train_step_gaps`` (the card, a bf16-logsumexp control and the CPU): the
relative gaps in the loss and the gradient norm and the worst leaf's
relative L2 gradient gap.  Features switched against each model as it
is (``dataclasses.replace`` of its config):

* ``untied``: minicpm-2b with its own ``lm_head`` (its logits are a
  product with the embedding table otherwise); ``tied``: qwen2-vl and
  seamless with theirs dropped;
* ``logit scale``: minicpm-2b's logits unscaled (it scales the final
  hidden state by 256 / d_model before the product); qwen2-vl and
  seamless scaled by 256 / d_model;
* ``text only, 1-D RoPE``: qwen2-vl as a dense decoder (no patch
  embeddings, ``(B, S)`` positions);
* ``no encoder layers``: seamless's frontend projection alone as the
  cross-attention's memory; ``decoder only``: seamless with neither
  encoder nor cross-attention.

It prints the card's name and power limit first and one JSON line last.
Run it from the repository root on a machine with one CUDA card::

    python3 tools/train_gap_bisect.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def cases():
    """``{name: config}`` of every case, each at 2 layers."""
    from repro_torch.configs import get_config
    rep = dataclasses.replace
    mini = rep(get_config("minicpm-2b"), n_layers=2)
    qwen = rep(get_config("qwen2-vl-7b"), n_layers=2)
    seam = rep(get_config("seamless-m4t-medium"), n_layers=2, enc_layers=2)
    return {
        "minicpm-2b": mini,
        "minicpm-2b untied": rep(mini, tie_embeddings=False),
        "minicpm-2b logit scale 1": rep(mini, logit_scale=1.0),
        "minicpm-2b untied, logit scale 1": rep(mini, tie_embeddings=False,
                                                logit_scale=1.0),
        "qwen2-vl-7b": qwen,
        "qwen2-vl-7b text only, 1-D RoPE": rep(qwen, family="dense",
                                               mrope_sections=None),
        "qwen2-vl-7b tied": rep(qwen, tie_embeddings=True),
        "qwen2-vl-7b logit scale 256/d": rep(qwen,
                                             logit_scale=256.0 / 3584.0),
        "seamless-m4t-medium": seam,
        "seamless-m4t-medium no encoder layers": rep(seam, enc_layers=0),
        "seamless-m4t-medium decoder only": rep(seam, family="dense",
                                                enc_layers=0),
        "seamless-m4t-medium tied": rep(seam, tie_embeddings=True),
        "seamless-m4t-medium logit scale 256/d": rep(
            seam, logit_scale=256.0 / 1024.0),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import fresh_memory, smi_line, train_step_gaps
    from repro_torch.data.pipeline import DataSpec
    from repro_torch.launch.specs import make_batch
    from repro_torch.train.trainer import TrainConfig
    print(smi_line(), flush=True)
    only = sys.argv[1:]
    out = {}
    for name, cfg in cases().items():
        if only and not any(o in name for o in only):
            continue
        batch = make_batch(cfg, 2, 128, "train", seed=0, device="cpu")
        spec = DataSpec(vocab=cfg.vocab, seq_len=128, global_batch=2, seed=0)
        gaps = train_step_gaps(torch, cfg, spec, TrainConfig(seed=0),
                               batch=batch, attn_control=False)
        out[name] = {k: gaps["card"][k] for k in
                     ("loss", "grad_norm", "worst_leaf", "worst_at")}
        out[name]["control_loss"] = gaps["card with a bf16 logsumexp"][
            "loss"]
        print(f"bisect {name}: {json.dumps(out[name])}", flush=True)
        fresh_memory(torch)
    print(json.dumps({"train_gap_bisect": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
