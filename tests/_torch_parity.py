"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
hand the reference JAX package's parameters to ``repro_torch`` as numpy
arrays, and convert tensors both ways."""

import numpy as np

from repro.core.bipolar import BipolarTensor as JaxBipolar
from repro_torch import bridge


def to_numpy_tree(tree):
    """A JAX parameter pytree as nested dicts/lists of numpy arrays; each
    packed ``BipolarTensor`` becomes ``{packed, scale, n_bits, shape,
    width_scales}`` (the input of ``repro_torch.bridge``)."""
    if isinstance(tree, JaxBipolar):
        return {"packed": np.asarray(tree.packed),
                "scale": np.asarray(tree.scale),
                "n_bits": tree.n_bits, "shape": tuple(tree.shape),
                "width_scales": (None if tree.width_scales is None
                                 else np.asarray(tree.width_scales))}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def torch_params(jax_params, cfg):
    """The reference parameters bridged onto the CPU for the port."""
    return bridge.params_from_numpy(to_numpy_tree(jax_params), cfg,
                                    device="cpu")


def t(arr, dtype=None):
    """numpy / JAX array -> CPU torch tensor (bits preserved)."""
    out = bridge.to_tensor(np.asarray(arr), "cpu")
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor -> float32 numpy (for comparisons)."""
    return x.detach().float().cpu().numpy()


def jax_bipolar_to_torch(jt):
    return bridge.from_numpy_tree(to_numpy_tree(jt), "cpu")
