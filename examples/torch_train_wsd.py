"""Train a small LM with the WSD schedule + fault-tolerance demo, on the
port.

The PyTorch counterpart of ``examples/train_wsd.py``, with the same
model, data and steps: a 0.7M-param llama-family model trains on the
deterministic synthetic pipeline, a preemption is simulated mid-run, the
run resumes from the latest atomic checkpoint, and the loss curve is
checked to continue.  The optimizer state is int8 (the bit-level
storage idea applied beyond the paper).  Training runs on the float path
and launches none of the quantized kernels.

Run:  PYTHONPATH=src python examples/torch_train_wsd.py [--steps 300]
      [--device cpu] [--ckpt-dir DIR]
(``--device`` defaults to ``cuda`` and raises without a card; the
checkpoints go to a new temporary directory unless ``--ckpt-dir`` names
one, and are deleted at the end).
"""

import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataSpec
from repro_torch.models.model import resolve_device
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.train.trainer import (SimulatedPreemption, TrainConfig,
                                       Trainer)

LOG_EVERY = 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_wsd_")
    shutil.rmtree(ckpt, ignore_errors=True)

    cfg = get_config("llama3-8b").reduced(
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=256, vocab=512)
    spec = DataSpec(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=7)
    print(f"model ~{cfg.param_count() / 1e6:.1f}M params, "
          f"WSD schedule, int8 AdamW state")

    tcfg = TrainConfig(
        num_steps=args.steps, peak_lr=1e-3, warmup_steps=20,
        schedule="wsd", adamw=AdamWConfig(state_bits=8),
        ckpt_dir=ckpt, ckpt_every=50, preempt_at=args.steps // 2)

    losses = []

    def log(step, loss):
        losses.append(loss)
        if step % LOG_EVERY == 0:
            print(f"  step {step:4d}  loss {loss:.3f}")

    try:
        t = Trainer(cfg, tcfg, spec, device=dev)
        try:
            t.run(resume=False, on_step=log)
        except SimulatedPreemption as e:
            print(f"!! {e} -- restarting from checkpoint")

        tcfg2 = TrainConfig(**{**tcfg.__dict__, "preempt_at": None})
        t2 = Trainer(cfg, tcfg2, spec, device=dev)
        t2.run(resume=True, on_step=log)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss: {first:.3f} -> {last:.3f} over {len(losses)} steps "
          f"(preempted + resumed at step {args.steps // 2})")
    assert len(losses) == args.steps, "the resumed run skipped or redid steps"
    assert last < first - 0.5, "training did not converge"
    if t2.straggler_events:
        print(f"straggler watchdog flagged {len(t2.straggler_events)} "
              f"slow steps")
    print("done.")


if __name__ == "__main__":
    main()
