"""Optimizers: AdamW with optionally int8-quantized moments, schedules.

A port of the reference ``repro.optim.optimizer`` as plain functions over
the port's parameter tree (:mod:`repro_torch.core.tree`).

``state_bits=8`` stores Adam's m/v in int8 with per-row (last-axis) f32
scales: optimizer memory falls from 8 bytes a parameter to ~2.1.  m is
signed-symmetric (absmax, no zero point); v is non-negative and is
quantized in the sqrt domain to unsigned levels on the same grid.

The arithmetic follows the reference step for step, in f32: the
gradient is clipped by its global norm before the moments, the bias
corrections use the incremented step, the weight decay is decoupled and
inside the f32 update, and the new parameter is cast back to the
parameter's own dtype (bf16 for the weights: there is no f32 master
copy, as in the reference).  Unlike the reference, which returns new
arrays, :func:`adamw_update` writes the parameters and the moments in
place, so a step holds one copy of each (plus one leaf's f32
temporaries).

Sharded parameters (DTensors, :mod:`repro_torch.distributed.sharding`)
take the same step on their local shards: the moments are DTensors laid
out as their parameter (an int8 moment's row scale replicated along the
mesh dims that shard the last axis), the global norm counts each element
once however many ranks hold it, and an int8 row's absmax is the max
over every shard of the row, so the codes and scales are the ones a
single device would compute.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.tree import leaves, tree_map


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def _f32_step(step) -> torch.Tensor:
    """The step count as an f32 tensor, on the device of a tensor step."""
    return torch.as_tensor(step).to(torch.float32)


def wsd_schedule(*, peak_lr: float, warmup_steps: int, total_steps: int,
                 decay_frac: float = 0.1, min_ratio: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395).

    Linear warmup -> flat stable phase -> sharp exponential-style decay on
    the final ``decay_frac`` of steps.  Evaluated in f32, as the
    reference's ``jnp`` is.
    """
    decay_steps = max(int(total_steps * decay_frac), 1)
    stable_end = total_steps - decay_steps

    def schedule(step):
        step = _f32_step(step)
        warm = step / max(warmup_steps, 1)
        decay_t = (step - stable_end) / decay_steps
        decay = torch.pow(min_ratio, torch.clamp(decay_t, 0.0, 1.0))
        r = torch.where(step < warmup_steps, warm,
                        torch.where(step < stable_end, 1.0, decay))
        return peak_lr * r

    return schedule


def cosine_schedule(*, peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warmup, then a cosine from ``peak_lr`` down to ``min_ratio``
    of it.  In f32, but for the cosine itself: taken in f64 and rounded
    once (the correctly rounded f32 cosine), which lands within 1 f32 ulp
    of XLA:CPU's f32 ``cos`` where torch's f32 ``cos`` differs by 1 ulp
    in 5% of values (and ``1 + cos`` doubles that near the end)."""
    def schedule(step):
        step = _f32_step(step)
        warm = step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        c = torch.cos((math.pi * t).double()).float()
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + c)
        return peak_lr * torch.where(step < warmup_steps, warm, cos)

    return schedule


# ---------------------------------------------------------------------------
# int8 moment quantization
# ---------------------------------------------------------------------------

def _row_max(amax: torch.Tensor, groups) -> torch.Tensor:
    """The max of ``amax`` over the process ``groups`` that hold the other
    shards of its rows (none on one device)."""
    for g in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
    return amax


def _q8(x: torch.Tensor, signed: bool, groups=()):
    """f32 -> (int8 codes, f32 per-row scale). Rows = last axis; a row
    whose last axis is sharded takes its absmax over the ``groups``.

    The second moment is quantized in the *sqrt domain*: v spans many
    orders of magnitude and a linear int8 grid collapses small entries to
    zero (1/sqrt(v) then explodes); sqrt compresses the dynamic range.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    xf = x.float()
    if not signed:                       # v >= 0: sqrt-domain codes
        xf = torch.sqrt(xf)
    amax = _row_max(xf.abs().amax(-1, keepdim=True), groups)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127 if signed else 0, 127)
    return q.to(torch.int8), scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, signed: bool):
    out = q.float() * scale
    return out if signed else torch.square(out)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_bits: Optional[int] = None    # None = f32 moments, 8 = int8


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 (), on the parameters' device
    m: Any
    v: Any
    m_scale: Any            # None when state_bits is None
    v_scale: Any


def _zeros(p, shape, dtype):
    """Zeros of ``shape`` laid out as ``p``: a DTensor on ``p``'s mesh,
    sharded as ``p`` on each dim of the same size (replicated where the
    size differs: a row scale's last axis), or a tensor on its device."""
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    from torch.distributed.tensor import zeros
    pl = [Replicate() if isinstance(q, Shard) and shape[q.dim] != p.shape[
        q.dim] else q for q in p.placements]
    return zeros(shape, dtype=dtype, device_mesh=p.device_mesh,
                 placements=pl)


def _row_groups(p) -> tuple:
    """The process groups of the mesh dims that shard ``p``'s last axis."""
    if not isinstance(p, DTensor):
        return ()
    mesh = p.device_mesh
    return tuple(mesh.get_group(i) for i, q in enumerate(p.placements)
                 if isinstance(q, Shard) and q.dim == p.ndim - 1)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    int8 = cfg.state_bits == 8

    def zeros_like_moment(p):
        return _zeros(p, tuple(p.shape), torch.int8 if int8
                      else torch.float32)

    def zeros_scale(p):
        return _zeros(p, tuple(p.shape[:-1]) + (1,), torch.float32)

    first = _local(leaves(params)[0])
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(zeros_like_moment, params),
        v=tree_map(zeros_like_moment, params),
        m_scale=tree_map(zeros_scale, params) if int8 else None,
        v_scale=tree_map(zeros_scale, params) if int8 else None)


def _square_sum(x) -> torch.Tensor:
    """f32 sum of squares of a leaf; of a DTensor, over its whole (each
    element once: the shards' sums are added over the mesh dims that
    shard it, not over those that replicate it)."""
    s = torch.sum(torch.square(x.float()))
    return s.full_tensor() if isinstance(s, DTensor) else s


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [_square_sum(x) for x in leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 cfg: AdamWConfig):
    """One AdamW step, in place: the leaves of ``params`` and of the
    state's moments are overwritten.  ``lr`` is a float or an f32 scalar
    tensor (a schedule's value).  Returns ``(params, new_state, stats)``
    with ``stats = {"grad_norm": ...}``; ``new_state`` holds the
    incremented step."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state.step + 1
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    int8 = cfg.state_bits == 8

    def upd(p, g, m, v, ms=None, vs=None):
        groups = _row_groups(p)
        p, g, m, v, ms, vs = (None if t is None else _local(t)
                              for t in (p, g, m, v, ms, vs))
        g = g.float() * clip
        mf = _dq8(m, ms, signed=True) if int8 else m
        vf = _dq8(v, vs, signed=False) if int8 else v
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * torch.square(g)
        mh = mf / bc1
        vh = vf / bc2
        pf = p.float()
        new_p = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                           + cfg.weight_decay * pf)
        p.copy_(new_p)               # the cast to p's dtype, as astype
        if int8:
            m8, ms8 = _q8(mf, signed=True, groups=groups)
            v8, vs8 = _q8(vf, signed=False, groups=groups)
            m.copy_(m8)
            ms.copy_(ms8)
            v.copy_(v8)
            vs.copy_(vs8)
        else:
            m.copy_(mf)
            v.copy_(vf)

    if int8:
        tree_map(upd, params, grads, state.m, state.v, state.m_scale,
                 state.v_scale)
    else:
        tree_map(upd, params, grads, state.m, state.v)
    return params, state._replace(step=step), {"grad_norm": gnorm}
