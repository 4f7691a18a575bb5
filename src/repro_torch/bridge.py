"""Parameters of the reference package, as the port's.

:func:`params_from_numpy` takes the reference model's parameter tree as
nested dicts / lists of **numpy** arrays -- the caller flattens the JAX
pytree, and each packed ``BipolarTensor`` into a dict ``{packed, scale,
n_bits, shape, width_scales}`` -- and returns the port's parameter dict
on ``device``:

* the unrolled ``prelude`` layers (deepseek-moe's dense layer 0) and
  the scanned ``blocks`` (every leaf with a leading unit axis) become
  one entry per layer of ``params["layers"]``, prelude first; a stacked
  expert weight (packed ``(u, n_bits, E, N, Kw)``, scale ``(u, E, N,
  1)``) unstacks like any other packed leaf, and the f32 router with
  it;
* packed uint32 words are viewed as int32 (same bits);
* bfloat16 arrays (numpy's ``bfloat16`` extension dtype) are viewed bit
  for bit as ``torch.bfloat16``.

It never imports jax: the tests hand it numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bipolar import BipolarTensor
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import check_supported, plan_split, \
    resolve_device


def to_tensor(arr, device) -> torch.Tensor:
    """One numpy array as a torch tensor on ``device``, bits preserved."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _is_bipolar(node) -> bool:
    return isinstance(node, dict) and "packed" in node and "n_bits" in node


def from_numpy_tree(node, device):
    """A numpy subtree (packed tensors as dicts) as torch leaves on
    ``device``, layout unchanged."""
    if _is_bipolar(node):
        shape = tuple(int(s) for s in node["shape"])
        ws = node.get("width_scales")
        return BipolarTensor(
            packed=to_tensor(node["packed"], device),
            scale=to_tensor(node["scale"], device),
            n_bits=int(node["n_bits"]), shape=shape,
            pack_axis=len(shape) - 1,
            width_scales=None if ws is None else to_tensor(ws, device))
    if isinstance(node, dict):
        return {k: from_numpy_tree(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [from_numpy_tree(v, device) for v in node]
    return to_tensor(node, device)


def _unit(node, u: int):
    """Slice unit ``u`` off every leaf of a scanned subtree (the static
    ``n_bits``/``shape`` of a packed tensor already describe one unit)."""
    if _is_bipolar(node):
        out = dict(node, packed=np.asarray(node["packed"])[u],
                   scale=np.asarray(node["scale"])[u])
        if node.get("width_scales") is not None:
            out["width_scales"] = np.asarray(node["width_scales"])[u]
        return out
    if isinstance(node, dict):
        return {k: _unit(v, u) for k, v in node.items()}
    return np.asarray(node)[u]


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference parameter tree (numpy leaves) -> the port's params."""
    check_supported(cfg)
    dev = resolve_device(device)
    prelude, unit, n_units = plan_split(cfg)
    pre = tree.get("prelude", [])
    assert len(pre) == len(prelude), (len(pre), len(prelude))
    blocks = tree["blocks"]
    assert len(blocks) == len(unit), (len(blocks), len(unit))
    params = {"embed": from_numpy_tree(tree["embed"], dev),
              "final_norm": from_numpy_tree(tree["final_norm"], dev),
              "layers": [from_numpy_tree(p, dev) for p in pre]
              + [from_numpy_tree(_unit(blocks[i], u), dev)
                 for u in range(n_units) for i in range(len(unit))]}
    if "lm_head" in tree:
        params["lm_head"] = from_numpy_tree(tree["lm_head"], dev)
    return params
