"""Sharding rules: DP / FSDP / TP / EP / SP specs for every tree, their
DTensor placements, and the sharded training step.

A port of the reference ``repro.distributed.sharding`` onto
``torch.distributed``'s DeviceMesh and DTensor.

Strategy:
* weights: TP ("model") on the head/ffn/vocab dimension + FSDP ("data") on
  the other matrix dimension.  Column/row pairing (wq/wk/wv/w_up/w_gate
  column, wo/w_down row) keeps one reduce per residual write.
* MoE experts: EP on the expert dim when divisible by the model axis,
  else TP on d_ff (mixtral's 8 experts on a model axis of 16).
* activations: batch over the DP axes, the residual stream's sequence
  over "model" between blocks (:func:`constrain`, named rules).
* packed bipolar weights: the same rules -- the plane axis rides as a
  leading dim, the packed-word axis inherits the FSDP ("data") shard.
* every sharded dim is divisibility-checked; an axis that does not
  divide its dim falls back to replication (mamba2-130m's 3352-row
  in_proj is DP-only).

Rules are *suffix-aligned*: a candidate spec binds to the trailing dims of
the leaf, so stack / bit-plane / expert prefixes stay unsharded unless
the rule names them.

A spec is a tuple with one entry per tensor dim: a mesh axis name, a
tuple of names (one tensor dim over several mesh dims, outer first) or
None, as a JAX ``PartitionSpec``.  :func:`placements` turns it into
DTensor placements and :func:`shard_tree` distributes a tree by it.  The
rules take a DeviceMesh or a :class:`repro_torch.launch.mesh.MeshShape`
(names and sizes alone).

:func:`sharded_step` is the training step over a mesh: parameters rest
as DTensors, each gathered for the step and its gradient reduce-scattered
back to the parameter's placement (ZeRO-3 style; ranks along "model"
compute the same batch shard).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.bipolar import BipolarTensor
from repro_torch.core.tree import get_at, leaves_with_paths, tree_map
from repro_torch.launch.mesh import dp_axes, mesh_sizes

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _key_str(p):
    """A path entry's name: a dict key, a NamedTuple field without its
    ``.`` or a BipolarTensor field; None for a list index."""
    if isinstance(p, str):
        return p[1:] if p.startswith(".") else p
    return None


def _axes_size(mesh, axis):
    if axis is None:
        return 1
    axes = axis if isinstance(axis, tuple) else (axis,)
    sizes = mesh_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def _fit(mesh, shape, spec_axes) -> tuple:
    """Suffix-align a candidate spec to ``shape`` and drop axes that do not
    divide their dim."""
    spec_axes = tuple(spec_axes)
    if len(spec_axes) > len(shape):
        spec_axes = spec_axes[len(spec_axes) - len(shape):]
    full = (None,) * (len(shape) - len(spec_axes)) + spec_axes
    return tuple(ax if ax is not None and dim % _axes_size(mesh, ax) == 0
                 else None for dim, ax in zip(shape, full))


def _dp_axis(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def _map_with_keys(fn, node, keys=()):
    """``fn(path names, leaf)`` over a tree; a packed ``BipolarTensor``
    is a node of its ``packed``, ``scale`` and ``width_scales`` (a dict of
    their results), as the reference's pytree flattens it."""
    if node is None:
        return None
    if isinstance(node, BipolarTensor):
        out = {"packed": fn(keys + ("packed",), node.packed),
               "scale": fn(keys + ("scale",), node.scale)}
        if node.width_scales is not None:
            out["width_scales"] = fn(keys + ("width_scales",),
                                     node.width_scales)
        return out
    if isinstance(node, dict):
        return {k: _map_with_keys(fn, v, keys + (k,)) for k, v in
                node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_with_keys(fn, getattr(node, f),
                                           keys + (f,))
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_map_with_keys(fn, v, keys + (None,))
                          for v in node)
    return fn(keys, node)


# ---------------------------------------------------------------------------
# activation-sharding context (read by model code through `constrain`)
# ---------------------------------------------------------------------------

_CTX: dict = {"mesh": None, "rules": {}}
_MOE_MODE = "ep"   # "ep": experts over the model axis | "tp": d_ff over it


def set_moe_mode(mode: str):
    global _MOE_MODE
    assert mode in ("ep", "tp")
    _MOE_MODE = mode


def set_activation_context(mesh, rules: Optional[dict] = None, extra=()):
    """Install the mesh + activation specs the model constrains to.

    ``rules``: name -> spec.  ``None`` mesh disables constraints
    (single-device runs).  ``extra``: names of opt-in rules (e.g.
    "attn_chunks")."""
    _CTX["mesh"] = mesh
    _CTX["rules"] = rules if rules is not None else (
        default_activation_rules(mesh, extra) if mesh is not None else {})


def constrain(x, name: str):
    """Redistribute a DTensor ``x`` to the named activation spec, fitted
    to its shape, if a context is installed; anything else (no context,
    no such rule, a local tensor) passes unchanged."""
    from torch.distributed.tensor import DTensor
    mesh, rules = _CTX["mesh"], _CTX["rules"]
    if mesh is None or name not in rules or not isinstance(x, DTensor):
        return x
    spec = _fit(mesh, x.shape, tuple(rules[name]))
    return x.redistribute(mesh, placements(mesh, spec))


def default_activation_rules(mesh, extra=()) -> dict:
    dp = _dp_axis(mesh)
    rules = {
        # residual stream between blocks: batch over DP, sequence over
        # model (Megatron-SP analogue; bounds the remat stash per card)
        "residual": (dp, "model", None),
        # grouped MoE dispatch buffer (G, E, C, d): token groups over DP,
        # experts over model in EP mode
        "moe_dispatch": ((dp, "model", None, None) if _MOE_MODE == "ep"
                         else (dp, None, None, None)),
        # combine side: expert outputs token-local (G over DP, E
        # replicated)
        "moe_combine": (dp, None, None, "model"),
    }
    if "attn_chunks" in extra:
        # stacked KV chunks (nc, B, Hkv, ck, D): chunk axis unsharded
        rules["attn_chunks"] = (None, dp, "model", None, None)
    return rules


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------

# column-parallel: d_out on model, d_in(/packed words) on data (FSDP)
_COL = ("wq", "wk", "wv", "w_up", "w_gate", "in_proj", "lm_head", "frontend",
        "embed")
# row-parallel: d_in on model, d_out on data
_ROW = ("wo", "w_down", "out_proj")
_SKIP_NAMES = ("w", "packed", "scale", "blocks", "prelude", "mixer", "ffn",
               "attn", "shared", "encoder", "cross")


def _param_spec(mesh, path_keys, shape) -> tuple:
    name = next((k for k in reversed(path_keys)
                 if k is not None and k not in _SKIP_NAMES), None)
    nd = len(shape)
    if name == "router" or nd <= 1:
        return (None,) * nd
    moe_expert = path_keys and any(
        k in ("w_up", "w_gate", "w_down") for k in path_keys if k) \
        and nd >= 3 and name not in ("shared",)
    is_shared = "shared" in [k for k in path_keys if k]
    if moe_expert and not is_shared:
        # trailing dims (E, d_out, d_in[/Kw]); EP on E when divisible
        if _MOE_MODE == "ep" and shape[-3] % mesh_sizes(mesh)["model"] == 0:
            return _fit(mesh, shape, ("model", None, "data"))
        if name in ("w_up", "w_gate"):
            return _fit(mesh, shape, (None, "model", "data"))
        return _fit(mesh, shape, (None, "data", "model"))
    if name in _COL:
        return _fit(mesh, shape, ("model", "data"))
    if name in _ROW:
        return _fit(mesh, shape, ("data", "model"))
    if name == "conv_w":
        return _fit(mesh, shape, (None, "model"))
    return (None,) * nd


def shardings_for_params(mesh, params):
    """The spec tree of ``params`` (also fits optimizer moments and
    scales: map over the moment tree -- same structure, same trailing
    dims)."""
    return _map_with_keys(
        lambda keys, leaf: _param_spec(mesh, [_key_str(k) for k in keys],
                                       tuple(leaf.shape)), params)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------

def shardings_for_batch(mesh, batch):
    dp = _dp_axis(mesh)

    def spec_of(keys, leaf):
        keys = [_key_str(k) for k in keys]
        shape = tuple(leaf.shape)
        if keys and keys[-1] == "positions" and len(shape) == 3:
            return _fit(mesh, shape, (None, dp, None))   # M-RoPE (3, B, S)
        full = ((dp,) + (None,) * max(len(shape) - 1, 0))[:len(shape)]
        return tuple(ax if ax is not None and d % _axes_size(mesh, ax) == 0
                     else None for d, ax in zip(shape, full))

    return _map_with_keys(spec_of, batch)


# expected trailing layouts per cache leaf name
_CACHE_RULES = {
    "k": ("__dp__", "model", None, None),      # (B, L, Hkv, Dh): L is SP-
    "v": ("__dp__", "model", None, None),      # sharded for long contexts
    "k_scale": ("__dp__", "model", None, None),
    "v_scale": ("__dp__", "model", None, None),
    "pos": ("__dp__", "model"),
    "index": ("__dp__",),
    "state": ("__dp__", "model", None, None),  # (B, H, P, N)
    "conv": ("__dp__", None, "model"),         # (B, w, conv_dim)
}


def shardings_for_caches(mesh, caches):
    dp = _dp_axis(mesh)

    def spec_of(keys, leaf):
        keys = [_key_str(k) for k in keys]
        name = next((k for k in reversed(keys) if k), "")
        rule = _CACHE_RULES.get(name, ("__dp__",))
        rule = tuple(dp if r == "__dp__" else r for r in rule)
        if name in ("k", "v") and leaf.dtype == torch.int32:
            # packed bipolar KV planes (int32 words, the uint32 bits)
            # carry a trailing (kv_bits, D/32) pair instead of D
            rule = rule + (None,)
        return _fit(mesh, tuple(leaf.shape), rule)

    return _map_with_keys(spec_of, caches)


def replicated(mesh, tree):
    return _map_with_keys(lambda keys, leaf: (None,) * leaf.ndim, tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d``'s entry names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec) if ax == name or (
            isinstance(ax, tuple) and name in ax)]
        assert len(dims) <= 1, (spec, name)
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _distribute(mesh, t, spec):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.to(mesh.device_type), mesh,
                             placements(mesh, spec))


def shard_tree(tree, mesh, specs):
    """Distribute every leaf of ``tree`` as a DTensor on ``mesh`` by its
    spec in ``specs`` (a tree laid out as ``tree``, from the rules
    above); a packed ``BipolarTensor`` has its fields distributed."""
    def one(path, leaf):
        spec = get_at(specs, path)
        if isinstance(leaf, BipolarTensor):
            ws = leaf.width_scales
            return dataclasses.replace(
                leaf, packed=_distribute(mesh, leaf.packed, spec["packed"]),
                scale=_distribute(mesh, leaf.scale, spec["scale"]),
                width_scales=None if ws is None else _distribute(
                    mesh, ws, spec["width_scales"]))
        return _distribute(mesh, leaf, spec)

    done = iter([one(p, leaf) for p, leaf in leaves_with_paths(tree)])
    return tree_map(lambda _: next(done), tree)


def named(mesh, specs, like):
    """``(mesh, placements)`` at every leaf of ``like``, from its spec in
    ``specs``: the ``shardings=`` tree of
    :func:`repro_torch.checkpoint.manager.restore_tree`."""
    paths = iter([p for p, _ in leaves_with_paths(like)])
    return tree_map(
        lambda _: (mesh, placements(mesh, get_at(specs, next(paths)))),
        like)


# ---------------------------------------------------------------------------
# collectives over mesh axes
# ---------------------------------------------------------------------------

def all_reduce_axes(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum ``t`` in place over the mesh dims named in ``axes``, one dim's
    group after another (outer first).  Returns ``t``."""
    for name in mesh.mesh_dim_names:
        if name in axes and mesh_sizes(mesh)[name] > 1:
            dist.all_reduce(t, group=mesh.get_group(name))
    return t


# ---------------------------------------------------------------------------
# the sharded training step
# ---------------------------------------------------------------------------

def sharded_step(loss_fn, mesh):
    """``step(params, batch) -> (loss, grads)`` over ``mesh``, the
    counterpart of the reference's ``jax.jit(..., in_shardings=...)`` of
    its loss and gradients.

    ``loss_fn(params, batch) -> (nll, count, aux)`` on local tensors:
    the summed negative log-likelihood of the batch shard's tokens, their
    count and an auxiliary loss (:func:`repro_torch.models.model
    .loss_terms`).  ``params`` are DTensors (:func:`shard_tree` under
    :func:`shardings_for_params`), ``batch`` DTensors under
    :func:`shardings_for_batch` (or the local shard itself).

    Each parameter is gathered whole at the step's start (an
    autograd-aware redistribute to ``Replicate()``) and held for the
    step, so its gradient comes back reduce-scattered over the DP axes to
    the parameter's placement; ranks along the other axes compute the
    same batch shard, so their gradients are equal and are not summed.
    (A gather inside each checkpointed unit, freed after it, waits for
    tensor-parallel compute: ROADMAP queue 1.)  The loss is the global batch's: the NLL sum and the
    count are summed over the DP axes before the division; the auxiliary
    loss is the mean of the ranks' (each over its own tokens).  Returns
    the loss (a local f32 scalar, equal on every rank) and the gradients
    (DTensors, laid out as ``params``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dp = dp_axes(mesh)
    n_dp = math.prod(mesh_sizes(mesh)[a] for a in dp)
    whole = [Replicate()] * mesh.ndim
    grad_pl = [Partial() if a in dp else Replicate()
               for a in mesh.mesh_dim_names]

    def step(params, batch):
        handles = []

        def gather(p):
            h = p.detach().requires_grad_(True)
            handles.append(h)
            return h.redistribute(mesh, whole).to_local(
                grad_placements=grad_pl)

        local_params = tree_map(gather, params)
        local_batch = tree_map(
            lambda b: b.to_local() if isinstance(b, DTensor) else b, batch)
        nll, cnt, aux = loss_fn(local_params, local_batch)
        count = all_reduce_axes(cnt.detach().clone(), mesh, dp)
        local = nll / torch.clamp(count, min=1.0) + aux / n_dp
        grads = torch.autograd.grad(local, handles)
        loss = all_reduce_axes(local.detach().clone(), mesh, dp)
        done = iter(grads)
        return loss, tree_map(lambda _: next(done), params)

    return step
