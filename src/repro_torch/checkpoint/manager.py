"""Checkpointing: atomic, versioned, keep-K, optional async.

A port of the reference ``repro.checkpoint.manager``, on the same
on-disk layout, so each package reads the other's checkpoints:
``<dir>/step_<N>/{arrays.npz, meta.json}``, one array a leaf keyed by
its ``/``-joined tree path (:mod:`repro_torch.core.tree`: dict keys, list
indices, ``.field`` for a NamedTuple field).  numpy has no bfloat16, so a
bf16 leaf is stored as its ``uint16`` bits with ``"bfloat16"`` in the
``dtypes`` sidecar of ``meta.json``, as the reference stores it; it is
read back through ``torch.int16`` and ``.view(torch.bfloat16)``, with no
``ml_dtypes``.  A checkpoint becomes visible only through the final
atomic ``os.rename`` of its temp directory, so a preemption mid-save
never corrupts the latest complete one.

``restore_tree(..., shardings=)`` is the reference's elastic restore
onto another topology: each leaf lands as a DTensor on the mesh and with
the placements given for it (:func:`repro_torch.distributed.sharding
.named`), whatever mesh it was saved from.  ``device=`` lands a leaf on
one device instead.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tree import get_at, leaves_with_paths, path_key, \
    tree_map


def _to_host(leaf) -> torch.Tensor:
    """A host copy of ``leaf`` that later in-place updates cannot reach."""
    return torch.as_tensor(leaf).detach().to("cpu", copy=True)


def _flatten_with_paths(tree):
    """-> (arrays dict, dtype sidecar): each leaf as numpy, bf16 as its
    uint16 bits with its dtype in the sidecar."""
    flat, dtypes = {}, {}
    for path, leaf in leaves_with_paths(tree):
        key = path_key(path)
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat, dtypes


def save_tree(tree, directory: str, step: int, *, keep: int = 3,
              extra_meta: Optional[dict] = None) -> str:
    """Atomic synchronous save. Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = _flatten_with_paths(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "time": time.time(), "dtypes": dtypes,
            **(extra_meta or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _cleanup(directory, keep)
    return final


def _cleanup(directory: str, keep: int):
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, name, "meta.json")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name is None:
        return torch.from_numpy(np.array(arr, copy=True))
    if dtype_name != "bfloat16":
        raise ValueError(f"checkpoint leaf of dtype {dtype_name}: only "
                         f"bfloat16 is stored through the dtype sidecar")
    bits = np.ascontiguousarray(arr).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def restore_tree(template, directory: str, step: Optional[int] = None, *,
                 device=None, shardings=None):
    """Restore into the structure of ``template`` (a tree of tensors).
    With ``shardings`` (a tree laid out as ``template`` holding a ``(mesh,
    placements)`` pair at each leaf) each leaf is distributed as a
    DTensor on its mesh, every rank reading the same file; else it lands
    on ``device``, or, without one, on the device of the template's leaf
    it replaces.  Returns ``(tree, meta)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    sidecar = meta.get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: _from_numpy(z[k], sidecar.get(k)) for k in z.files}
    paths = [path for path, _ in leaves_with_paths(template)]
    restored = iter([(arrays[path_key(path)], path) for path in paths])

    def place(leaf):         # tree_map visits the leaves in this order
        arr, path = next(restored)
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            mesh, pl = get_at(shardings, path)
            return distribute_tensor(arr.to(mesh.device_type), mesh, pl)
        return arr.to(
            device if device is not None else torch.as_tensor(leaf).device)

    return tree_map(place, template), meta


class CheckpointManager:
    """Periodic async checkpointing with bounded queue depth 1.

    A save snapshots host copies of every leaf (``.to("cpu",
    copy=True)``) *before* returning, so the optimizer may update the
    tensors in place at once; a second save request while one is in
    flight blocks (backpressure) rather than dropping checkpoints.
    ``directory=None`` saves into a new temporary directory, made at the
    first save.
    """

    def __init__(self, directory: Optional[str], *, interval: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, tree, step: int, *, force: bool = False,
                   extra_meta: Optional[dict] = None):
        if not force and (self.interval <= 0 or step % self.interval):
            return False
        self.wait()
        if self.directory is None:
            self.directory = tempfile.mkdtemp(prefix="repro_ckpt_")
        host_tree = tree_map(_to_host, tree)     # snapshot now
        if self.async_save:
            self._thread = threading.Thread(
                target=save_tree, args=(host_tree, self.directory, step),
                kwargs=dict(keep=self.keep, extra_meta=extra_meta),
                daemon=True)
            self._thread.start()
        else:
            save_tree(host_tree, self.directory, step, keep=self.keep,
                      extra_meta=extra_meta)
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self):
        return None if self.directory is None \
            else latest_step(self.directory)

    def restore(self, template, step=None, device=None):
        return restore_tree(template, self.directory, step, device=device)
