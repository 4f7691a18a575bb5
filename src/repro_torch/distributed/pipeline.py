"""GPipe-style pipeline parallelism over a mesh axis.

A port of the reference ``repro.distributed.pipeline`` onto
``torch.distributed``: the layer stack is split into ``n_stages``
contiguous stages, one a rank along the axis; microbatches stream
through with a ring shift to the next stage each tick (a pair of
point-to-point sends, ``batch_isend_irecv``), and the bubble is the
standard (S-1)/(M+S-1) GPipe bubble.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_map


def pipeline_apply(stage_fn, n_stages: int, n_micro: int, axis: str = "pipe"):
    """Build a pipelined forward ``run(mesh, stage_params, x) -> y``.

    ``stage_params``: leaves with leading dim ``n_stages`` (each rank
    takes its stage's slice; a DTensor sharded on that dim gives its
    local shard); ``x``: ``(n_micro, micro_batch, ...)`` activations
    entering stage 0, the same on every rank.  Each rank runs the skewed
    schedule: at tick t its stage s runs microbatch ``t - s`` (when in
    range) and ships its output to stage s + 1.  The last stage's outputs
    are summed over the axis (the other stages add zeros), so every rank
    returns them."""

    def run(mesh, stage_params, x):
        from torch.distributed.tensor import DTensor
        group = mesh.get_group(axis)
        stage = mesh.get_local_rank(axis)
        assert mesh.size(mesh.mesh_dim_names.index(axis)) == n_stages
        assert x.shape[0] == n_micro, (x.shape, n_micro)
        ranks = dist.get_process_group_ranks(group)
        nxt, prv = ranks[(stage + 1) % n_stages], ranks[(stage - 1)
                                                        % n_stages]

        def local(a):
            if isinstance(a, DTensor):
                return a.to_local()[0]
            return a[stage]

        params = tree_map(local, stage_params)
        buf = torch.zeros_like(x[0])           # activation in flight
        outs = torch.zeros_like(x)
        for t in range(n_micro + n_stages - 1):
            if stage == 0:                     # stage 0 injects microbatch t
                buf = x[t if t < n_micro else 0]
            m_idx = t - stage                  # microbatch at this stage
            active = 0 <= m_idx < n_micro
            y = stage_fn(params, buf) if active else buf
            if active and stage == n_stages - 1:
                outs[m_idx] = y                # the last stage collects
            if n_stages > 1:                   # ring shift to stage + 1
                recv = torch.empty_like(y)
                for req in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                        dist.P2POp(dist.irecv, recv, prv, group)]):
                    req.wait()
                buf = recv
            else:
                buf = y
        if stage != n_stages - 1:
            outs.zero_()
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
        return outs

    return run
