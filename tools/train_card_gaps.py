"""One training step on the card against the CPU at the card test's
reduced case, with two lower-precision controls: the gaps that
``tests/test_torch_cuda.py::test_training_step_on_card_matches_cpu``'s
bars are set from (``chip_smoke.py``'s phase 6 prints the same gaps at
minicpm-2b's full width for its own bars).

Reduced llama3-8b (2 layers), 4 x 64 tokens: one gradient step from the
same parameters and batch on the card -- as the port computes it, with
the loss's logsumexp in bf16, and with the attention core in bf16 -- and
on the CPU, through ``chip_smoke.train_step_gaps``: each card run's
relative gaps to the CPU in the loss and the gradient norm, and the worst
and median leaf's relative L2 gradient gap.

It prints the card's name and power limit first and one JSON line last.
Run it from the repository root on a machine with one CUDA card::

    python3 tools/train_card_gaps.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import smi_line, train_step_gaps
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataSpec
    from repro_torch.train.trainer import TrainConfig
    print(smi_line(), flush=True)
    cfg = get_config("llama3-8b").reduced(n_layers=2)
    out = train_step_gaps(
        torch, cfg, DataSpec(vocab=cfg.vocab, seq_len=64, global_batch=4,
                             seed=1),
        TrainConfig(ckpt_every=0, warmup_steps=2, peak_lr=1e-3))
    print(json.dumps({"train_card_gaps": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
