"""Fault-tolerant training loop.

A port of the reference ``repro.train.trainer``, eager (no
``torch.compile``) on an explicit device:

* checkpoint/restart: periodic async atomic checkpoints; ``run(resume=
  True)`` restores the latest complete checkpoint and -- because the data
  pipeline is stateless (step -> batch) -- replays the exact token
  stream, so a restart is bit-reproducible;
* preemption simulation: ``preempt_at=N`` raises after step N, as a spot
  eviction would end the run;
* straggler watchdog: each step's wall time against the rolling median;
  a step slower than ``watchdog_factor`` times the median is recorded;
* gradient accumulation: ``microbatches=A`` sums A microbatches'
  gradients in f32 before the optimizer step (the same math, 1/A of the
  activation memory);
* a ``grad_transform`` hook applied between the gradients and the
  optimizer.

The step is the reference's: the loss and its gradients
(:func:`repro_torch.models.model.loss_fn`, every scan unit
rematerialised), then AdamW at the learning rate of the step count
*before* this update.  With one microbatch the gradients keep the
parameters' dtypes; with A > 1 they are the f32 mean of the A
microbatches'.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.tree import leaves, tree_map
from repro_torch.data.pipeline import DataSpec, batch_at
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, cosine_schedule,
                                         wsd_schedule)


class SimulatedPreemption(RuntimeError):
    pass


@dataclasses.dataclass
class TrainConfig:
    num_steps: int = 100
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    schedule: str = "wsd"            # wsd | cosine  (minicpm trains WSD)
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    ckpt_dir: Optional[str] = None   # None: a temp dir made at 1st save
    ckpt_every: int = 50
    ckpt_keep: int = 3
    seed: int = 0
    watchdog_factor: float = 3.0
    preempt_at: Optional[int] = None  # simulate preemption after this step


class Trainer:
    """``Trainer(cfg, tcfg, data_spec, device=...)``; ``run()`` trains
    ``tcfg.num_steps`` steps.  ``device`` defaults to the card and raises
    without one.  Without ``tcfg.ckpt_dir`` each trainer checkpoints into
    a new temporary directory of its own, made at its first save
    (``self.ckpt.directory``), so a run resumes only from a directory it
    is given."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 data_spec: DataSpec, *,
                 grad_transform: Optional[Callable] = None,
                 async_ckpt: bool = True, device="cuda"):
        self.cfg, self.tcfg, self.spec = cfg, tcfg, data_spec
        self.device = M.resolve_device(device)
        sched = wsd_schedule if tcfg.schedule == "wsd" else cosine_schedule
        self.schedule = sched(peak_lr=tcfg.peak_lr,
                              warmup_steps=tcfg.warmup_steps,
                              total_steps=tcfg.num_steps)
        self.ckpt = CheckpointManager(
            tcfg.ckpt_dir, interval=tcfg.ckpt_every, keep=tcfg.ckpt_keep,
            async_save=async_ckpt)
        self.grad_transform = grad_transform
        self.step_times: list = []
        self.straggler_events: list = []

    # -- state --------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> dict:
        params = M.init_params(
            self.cfg, seed=self.tcfg.seed if seed is None else seed,
            device=self.device)
        return {"params": params, "opt": adamw_init(params, self.tcfg.adamw)}

    def batch_at(self, step: int) -> dict:
        """The data pipeline's batch for ``step``, on the device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch_at(self.spec, step).items()}

    # -- one update ----------------------------------------------------------
    def loss_and_grads(self, params, batch):
        """``(loss, grads)``: the loss and its gradients with respect to
        every parameter leaf (in the leaves' dtypes; zeros for a leaf the
        loss does not reach)."""
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            loss = M.loss_fn(params, batch, self.cfg)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        finally:
            for p in flat:
                p.requires_grad_(False)
        it = iter(torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, grads))
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(self, state: dict, batch: dict):
        """One optimizer step on ``batch`` (the reference's ``_step``):
        ``(state, {"loss", "lr", "grad_norm"})``, the state's tensors
        updated in place."""
        params, opt = state["params"], state["opt"]
        a = self.tcfg.microbatches
        if a == 1:
            loss, grads = self.loss_and_grads(params, batch)
        else:
            rows = next(iter(batch.values())).shape[0] // a
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(a):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, g = self.loss_and_grads(params, mb)
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / a
            grads = tree_map(lambda g: g / a, grads)
        if self.grad_transform is not None:
            grads = self.grad_transform(grads)
        lr = self.schedule(opt.step)
        params, opt, stats = adamw_update(grads, opt, params, lr=lr,
                                          cfg=self.tcfg.adamw)
        return {"params": params, "opt": opt}, {"loss": loss, "lr": lr,
                                                **stats}

    # -- main loop -----------------------------------------------------------
    def run(self, *, resume: bool = True, state=None, on_step=None):
        start = 0
        if state is None:
            state = self.init_state()
            if resume and self.ckpt.latest_step() is not None:
                state, meta = self.ckpt.restore(state)
                start = int(meta["step"])
        history = []
        for step in range(start, self.tcfg.num_steps):
            batch = self.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])      # sync point = step end
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            history.append(loss)
            if on_step:
                on_step(step, loss)
            self.ckpt.maybe_save(state, step + 1,
                                 extra_meta={"loss": loss})
            if self.tcfg.preempt_at is not None \
                    and step + 1 >= self.tcfg.preempt_at:
                self.ckpt.maybe_save(state, step + 1, force=True,
                                     extra_meta={"loss": loss})
                self.ckpt.wait()
                raise SimulatedPreemption(f"preempted after step {step + 1}")
        self.ckpt.maybe_save(state, self.tcfg.num_steps, force=True)
        self.ckpt.wait()
        return state, history

    def _watchdog(self, step: int, dt: float):
        self.step_times.append(dt)
        window = self.step_times[-32:]
        med = float(np.median(window))
        if len(window) >= 8 and dt > self.tcfg.watchdog_factor * med:
            self.straggler_events.append(
                {"step": step, "dt": dt, "median": med})
