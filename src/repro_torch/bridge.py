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
* a hybrid stack's unit (jamba's 8-layer group: mamba mixers, one
  attention layer, MoE and dense FFNs) unstacks the same way, each
  layer's leaves as they are: a mamba mixer's f32 ``A_log``/``D``/
  ``dt_bias``/``norm_scale``, bf16 ``conv_w``/``conv_b`` and packed
  ``in_proj``/``out_proj``;
* an enc-dec model's ``encoder`` (its frontend, its stacked ``blocks``
  -> ``layers``, one entry per encoder layer, and its final norm) and its
  stacked ``cross`` (``n_units * unit_len`` entries: decoder layer ``j``
  after the prelude takes entry ``j``, the order of the reference's
  ``_restack_cross``) unstack the same way;
* packed uint32 words are viewed as int32 (same bits);
* bfloat16 arrays (numpy's ``bfloat16`` extension dtype) are viewed bit
  for bit as ``torch.bfloat16``.

:func:`opt_state_from_numpy` carries an ``AdamWState`` of the reference
(its ``step`` and its ``m``, ``v``, ``m_scale`` and ``v_scale`` trees,
each laid out as the parameters, int8 moments included) over the same
way, so that both packages can take one update from the same state.

:func:`caches_from_numpy` and :func:`caches_to_numpy` carry the
reference's contiguous decode-cache tree (``prelude`` list, stacked
``blocks``, uint32 planes; a mamba layer's ``conv``/``state`` rows; an
enc-dec model's ``cross`` list of stacked caches) to the port's
per-layer lists and back.

It never imports jax: the tests hand it numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bipolar import BipolarTensor
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import check_supported, plan_split, \
    resolve_device
from repro_torch.optim.optimizer import AdamWState


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
    params = {"embed": from_numpy_tree(tree["embed"], dev),
              "final_norm": from_numpy_tree(tree["final_norm"], dev),
              "layers": _layers_from_tree(tree, cfg, dev)}
    if "lm_head" in tree:
        params["lm_head"] = from_numpy_tree(tree["lm_head"], dev)
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "frontend": from_numpy_tree(enc["frontend"], dev),
            "layers": [from_numpy_tree(_unit(enc["blocks"], u), dev)
                       for u in range(cfg.enc_layers)],
            "final_norm": from_numpy_tree(enc["final_norm"], dev)}
    if "cross" in tree:
        params["cross"] = [from_numpy_tree(_unit(tree["cross"], j), dev)
                           for j in range(cfg.n_layers - cfg.first_dense)]
    return params


def opt_state_from_numpy(state: dict, cfg: ModelConfig, device="cuda"):
    """The reference's ``AdamWState`` as a dict of numpy trees (``step``,
    ``m``, ``v``, ``m_scale``, ``v_scale``; the scale trees None with f32
    moments) -> the port's
    :class:`repro_torch.optim.optimizer.AdamWState` on ``device``."""
    dev = resolve_device(device)

    def tree(key):
        t = state.get(key)
        return None if t is None else params_from_numpy(t, cfg, device=dev)

    return AdamWState(step=to_tensor(np.asarray(state["step"], np.int32),
                                     dev),
                      m=tree("m"), v=tree("v"), m_scale=tree("m_scale"),
                      v_scale=tree("v_scale"))


def _layers_from_tree(tree: dict, cfg: ModelConfig, dev) -> list:
    """The prelude entries, then each scanned unit's entries, as one
    list in layer order (the order of ``params["layers"]``)."""
    prelude, unit, n_units = plan_split(cfg)
    pre = tree.get("prelude", [])
    assert len(pre) == len(prelude), (len(pre), len(prelude))
    blocks = tree["blocks"]
    assert len(blocks) == len(unit), (len(blocks), len(unit))
    return [from_numpy_tree(p, dev) for p in pre] \
        + [from_numpy_tree(_unit(blocks[i], u), dev)
           for u in range(n_units) for i in range(len(unit))]


def caches_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's contiguous cache tree (numpy leaves: ``prelude``
    layer dicts, ``blocks`` dicts whose leaves lead with the unit axis,
    an enc-dec model's ``cross`` list laid out as ``blocks``) -> the
    port's ``{"layers": [one dict per layer], "cross": [one dict per
    decoder layer after the prelude]}``."""
    check_supported(cfg)
    dev = resolve_device(device)
    out = {"layers": _layers_from_tree(tree, cfg, dev)}
    if "cross" in tree:
        _, unit, n_units = plan_split(cfg)
        out["cross"] = [from_numpy_tree(_unit(tree["cross"][i], u), dev)
                        for u in range(n_units) for i in range(len(unit))]
    return out


def _to_numpy(key: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()         # exact: bf16 values are f32 values
    out = t.numpy()
    if key in ("k", "v") and out.dtype == np.int32:
        return out.view(np.uint32)       # packed planes: the same bits
    return out


def caches_to_numpy(caches: dict, cfg: ModelConfig) -> dict:
    """The port's per-layer caches -> the reference's tree layout with
    numpy leaves: ``prelude`` dicts and ``blocks`` dicts stacked over the
    units, planes as uint32, bfloat16 K/V as float32 (exactly)."""
    check_supported(cfg)
    prelude, unit, n_units = plan_split(cfg)
    layers = [{k: _to_numpy(k, v) for k, v in c.items()}
              for c in caches["layers"]]
    fd, ul = len(prelude), len(unit)

    def stack(dicts, off):
        return [{k: np.stack([dicts[off + u * ul + i][k]
                              for u in range(n_units)])
                 for k in dicts[off + i]}
                for i in range(ul)]

    out = {"blocks": stack(layers, fd)}
    if fd:
        out["prelude"] = layers[:fd]
    if "cross" in caches:
        out["cross"] = stack([{k: _to_numpy(k, v) for k, v in c.items()}
                              for c in caches["cross"]], 0)
    return out
