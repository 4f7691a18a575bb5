"""int8 gradient-compressed data-parallel all-reduce.

A port of the reference ``repro.distributed.compress`` onto
``torch.distributed``.  Before the DP all-reduce, each gradient leaf is
quantized to int8 with a shared symmetric absmax scale (bipolar-style,
no zero point), summed on the wire in int32, and dequantized: the codes
fit a byte, a quarter of an f32 gradient.  Two small collectives and one
integer one replace the float all-reduce:

    scale = all_reduce_max(|g|) / 127        (one f32 scalar a leaf)
    g_sum = all_reduce_sum(int32(round(g / scale)))
    g_avg = g_sum * scale / n_ranks

:func:`dp_train_step` is the pure data-parallel step that uses it:
parameters replicated, the batch split on its leading dim.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.tree import leaves, tree_map


def int8_codes(g: torch.Tensor, amax: torch.Tensor):
    """``(codes, scale)``: ``g``'s int8 codes (in int32, the wire's type)
    on the shared absmax ``amax`` (an f32 scalar) and their scale.  The
    divisor is a tensor on ``amax``'s device: the card divides by a
    Python scalar as a multiply by its rounded reciprocal, the CPU
    exactly, and the scale must be the same on both."""
    scale = torch.clamp(amax, min=1e-30) / amax.new_tensor(127.0)
    return torch.round(g.float() / scale).to(torch.int32), scale


def compressed_psum(tree, group=None, *, bits: int = 8):
    """The int-quantized mean over the ranks of ``group`` of a gradient
    tree (every rank calls it with its own tree).  The int32 wire sum is
    exact for up to 2^(31-bits) ranks."""
    assert bits == 8, "int8 is the supported wire format"
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32)

    def one(g):
        amax = torch.max(torch.abs(g.float())).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        q, scale = int8_codes(g, amax[0])
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        return (q.float() * scale / n.to(q.device)).to(g.dtype)

    return tree_map(one, tree)


def _mean(tree, group):
    n = dist.get_world_size(group)

    def one(g):
        s = g.float().clone()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        return (s / n).to(g.dtype)

    return tree_map(one, tree)


def dp_train_step(loss_fn, mesh, *, axis_name: str = "data",
                  compress: bool = True):
    """A pure-DP step over ``mesh``'s ``axis_name``: parameters replicated
    (the same tensors on every rank), the batch split on its leading dim
    (each rank takes its rows of the global batch it is handed), the
    gradients all-reduced (int8-compressed, or exactly in f32).

    Returns ``step(params, batch) -> (loss, grads)``: the mean of the
    ranks' losses and the mean gradient tree, equal on every rank; the
    optimizer update is applied outside, identically on every rank."""
    group = mesh.get_group(axis_name)
    rank = mesh.get_local_rank(axis_name)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))

    def shard(b):
        rows = b.shape[0] // n
        return b[rank * rows:(rank + 1) * rows]

    def step(params, batch):
        flat = leaves(params)
        handles = [p.detach().requires_grad_(True) for p in flat]
        done = iter(handles)
        local_params = tree_map(lambda _: next(done), params)
        loss = loss_fn(local_params, tree_map(shard, batch))
        grads = torch.autograd.grad(loss, handles)
        done = iter(grads)
        grads = tree_map(lambda _: next(done), params)
        loss = loss.detach().clone().reshape(1)
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        grads = (compressed_psum(grads, group) if compress
                 else _mean(grads, group))
        return loss[0] / n, grads

    return step
