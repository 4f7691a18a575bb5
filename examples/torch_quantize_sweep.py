"""Accuracy-vs-bits sweep (the paper's §5.2 setting, scaled down), on the
port.

The PyTorch counterpart of ``examples/quantize_sweep.py``: a small LM
trains briefly so its weights are meaningful, then its held-out
cross-entropy is measured under the paper's W{n}A8 bipolar quantization
for n in {1..8} plus the bf16 ceiling -- the quality/bits trade-off an
arbitrary-precision *scheme* exists to exploit (W3/W5/W6 are exactly
the points fixed-format kernels cannot serve).  On the card the
quantized forwards run K3 (the weights' pack) and K1 (every linear).

``--steps`` (120, the reference's fixed count, by default) sets the
pretraining steps; the reference has no such argument.

Run:  PYTHONPATH=src python examples/torch_quantize_sweep.py
      [--steps 120] [--device cpu]
(``--device`` defaults to ``cuda`` and raises without a card).
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataSpec, batch_at
from repro_torch.models import model as M
from repro_torch.models.config import QuantConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = M.resolve_device(args.device)

    cfg = get_config("llama3-8b").reduced(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=256, vocab=512)
    spec = DataSpec(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=3)
    tcfg = TrainConfig(num_steps=args.steps, peak_lr=1e-3, warmup_steps=10,
                       ckpt_every=0)
    print(f"— pretraining a toy model ({args.steps} steps) …")
    trainer = Trainer(cfg, tcfg, spec, device=dev)
    params = trainer.run(resume=False)[0]["params"]

    held_out = [{k: torch.from_numpy(v).to(dev) for k, v in
                 batch_at(spec, 10_000 + i).items()} for i in range(4)]

    @torch.no_grad()
    def ce(p, quant):
        return float(np.mean([
            float(M.loss_fn(p, b, cfg, quant=quant, remat=False))
            for b in held_out]))

    base = ce(params, None)
    print(f"bf16 ceiling: CE {base:.3f}")
    print(" bits |   CE   | ΔCE vs bf16")
    for bits in (8, 6, 5, 4, 3, 2, 1):
        q = QuantConfig(w_bits=bits, a_bits=8)
        qp = M.quantize_params(params, q)
        c = ce(qp, q)
        print(f"  W{bits}  | {c:6.3f} | +{c - base:.3f}")
    print("done. (W5/W6/W3 are the arbitrary-precision points the paper's "
          "scheme unlocks on hardware with int-only format catalogues)")


if __name__ == "__main__":
    main()
