"""Bipolar-INT data format and bit-plane pack/reassembly, in torch.

A port of the reference ``repro.core.bipolar``.  An ``n``-bit bipolar-INT
value ``x = x^(n-1) ... x^(0)`` has decimal value
``sum_i (2 * x^(i) - 1) * 2^i``: every bit means -1 (bit 0) or +1
(bit 1), so the representable set is the 2^n odd integers in
``[-(2^n - 1), 2^n - 1]``.

Conventions (identical to the reference, bit for bit):

* "value"  -- odd-integer bipolar value, int32.
* "ubits"  -- the unsigned bit field ``u = (value + (2^n - 1)) / 2``; bit
  ``i`` of ``u`` is the bipolar bit ``x^(i)``.
* "planes" -- bit-plane tensor, leading axis = bit index, uint8 in {0, 1}.
* "packed" -- planes packed along the reduction axis into 32-bit words
  (element ``32w + b`` at bit ``b`` of word ``w``), planes on the leading
  axis.  torch has no usable uint32 arithmetic, so words are stored as
  ``torch.int32`` holding the same bits; they are built in int64 and
  wrapped, so bit 31 survives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

PACK_WIDTH = 32  # bits per packed word


# ---------------------------------------------------------------------------
# Value-level encode / decode
# ---------------------------------------------------------------------------

def max_value(n_bits: int) -> int:
    """Largest representable bipolar-INT magnitude: 2^n - 1."""
    return (1 << n_bits) - 1


def encode(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Odd-integer bipolar values -> unsigned bit field ``u`` (int32)."""
    return (values.to(torch.int32) + max_value(n_bits)) >> 1


def decode(ubits: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Unsigned bit field -> odd-integer bipolar value (int32)."""
    return (ubits.to(torch.int32) << 1) - max_value(n_bits)


def round_to_odd(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest odd integer: ``2 * round((x - 1) / 2) + 1``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    return 2.0 * torch.round((x - 1.0) * 0.5) + 1.0


def quantize_values(x: torch.Tensor, n_bits: int,
                    scale: torch.Tensor) -> torch.Tensor:
    """Real tensor -> odd-integer bipolar values (int32),
    ``clip(round_to_odd(x / scale), -(2^n-1), 2^n-1)``."""
    m = max_value(n_bits)
    q = round_to_odd(x / scale)
    return torch.clamp(q, -m, m).to(torch.int32)


def absmax_scale(x: torch.Tensor, n_bits: int, axis=None, keepdims=True,
                 eps: float = 1e-8) -> torch.Tensor:
    """Symmetric absmax scale so that absmax maps to +-(2^n - 1), in the
    input dtype.

    Kept in the reciprocal-multiply form of the reference (never a
    divide).  Both factors are rounded to the input dtype and their
    product is formed in f32 and rounded once, which is what the
    reference computes for bf16 inputs; for f32 inputs it is a plain f32
    multiply."""
    ax = x.abs()
    if axis is None:
        amax = ax.amax()
        if keepdims:
            amax = amax.reshape((1,) * x.ndim)
    else:
        amax = ax.amax(dim=axis, keepdim=keepdims)
    return scale_of_absmax(amax, n_bits, eps)


def scale_of_absmax(amax: torch.Tensor, n_bits: int,
                    eps: float = 1e-8) -> torch.Tensor:
    """:func:`absmax_scale`'s scale from the absmax itself, in its dtype:
    a tensor-parallel row product takes the max of its ranks' absmax
    first (a max is exact in any order), then this."""
    amax = torch.clamp(amax, min=eps)
    return (amax.float() * dtype_scalar(1.0 / max_value(n_bits), amax.dtype)
            ).to(amax.dtype)


_SCALARS: dict = {}


def dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (exact in f32):
    multiplying an f32 tensor by it and casting back to ``dtype`` is the
    reference's ``dtype * dtype`` product, with no device tensor made
    (which would synchronize the host with the card)."""
    key = (value, dtype)
    out = _SCALARS.get(key)
    if out is None:
        out = float(torch.tensor(value, dtype=dtype).float())
        _SCALARS[key] = out
    return out


def mse_scale(x: torch.Tensor, n_bits: int, axis=-1, *,
              candidates: int = 15, lo: float = 0.65) -> torch.Tensor:
    """Per-group clip-searched scale minimizing quantization MSE: sweep
    ``candidates`` shrink factors in ``[lo, 1]`` of the absmax scale and
    keep, per group, the one with the smallest ``||q * s - x||^2``."""
    xf = x.float()
    base = absmax_scale(xf, n_bits, axis=axis, keepdims=True)
    best_s = base
    best_e = torch.full_like(base, float("inf"))
    for c in np.linspace(lo, 1.0, candidates):
        s = base * float(c)
        q = quantize_values(xf, n_bits, s)
        err = torch.sum(torch.square(q.float() * s - xf), dim=axis,
                        keepdim=True)
        take = err < best_e
        best_s = torch.where(take, s, best_s)
        best_e = torch.where(take, err, best_e)
    return best_s


def truncate_values(values: torch.Tensor, n_bits: int,
                    k: int) -> torch.Tensor:
    """Top-``k`` plane prefix of ``n_bits``-bit bipolar values, as k-bit
    bipolar values (int32): round-to-nearest onto the coarse grid, never
    a tie."""
    if k == n_bits:
        return values.to(torch.int32)
    return decode(encode(values, n_bits) >> (n_bits - k), k)


def nested_width_scales(x: torch.Tensor, values: torch.Tensor, n_bits: int,
                        scale: torch.Tensor, axis=-1, *,
                        candidates: int = 15, lo: float = 0.8,
                        hi: float = 1.2) -> torch.Tensor:
    """Per-width dequant scales ``(n_bits, *scale.shape)`` for a nested
    tensor: row ``k-1`` is the clip-searched scale of the top-``k`` plane
    slice of the FIXED integers ``values``; row ``n_bits-1`` is
    ``scale`` itself."""
    xf = x.float()
    base = scale.float()
    rows = []
    for k in range(1, n_bits + 1):
        if k == n_bits:
            rows.append(base)
            continue
        vk = truncate_values(values, n_bits, k).float()
        natural = base * float(1 << (n_bits - k))
        best_s = natural
        best_e = torch.full_like(natural, float("inf"))
        for c in np.linspace(lo, hi, candidates):
            s = natural * float(c)
            err = torch.sum(torch.square(vk * s - xf), dim=axis,
                            keepdim=True)
            take = err < best_e
            best_s = torch.where(take, s, best_s)
            best_e = torch.where(take, err, best_e)
        rows.append(best_s)
    return torch.stack(rows, dim=0)


# ---------------------------------------------------------------------------
# Bit-plane decomposition / recovery
# ---------------------------------------------------------------------------

def _bit_shifts(n: int, ndim: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).reshape(
        (n,) + (1,) * ndim)


def decompose(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Bipolar values -> bit planes ``(n_bits, *shape)`` uint8 in {0,1}."""
    u = encode(values, n_bits)
    shifts = _bit_shifts(n_bits, values.ndim, values.device)
    return ((u[None] >> shifts) & 1).to(torch.uint8)


def recover(planes: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Bit planes -> bipolar values (int32).  Inverse of :func:`decompose`."""
    weights = (1 << _bit_shifts(n_bits, planes.ndim - 1, planes.device))
    signed = 2 * planes.to(torch.int32) - 1
    return torch.sum(signed * weights, dim=0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# 32-bit word packing / reassembly
# ---------------------------------------------------------------------------

def packed_words(k: int) -> int:
    """Number of 32-bit words covering ``k`` reduction elements."""
    return (k + PACK_WIDTH - 1) // PACK_WIDTH


def wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2^32)`` -> int32 tensors with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def pack_planes(planes: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack {0,1} planes into 32-bit words along ``axis`` (an axis of the
    underlying tensor, excluding the leading plane axis).  The axis
    length must be a multiple of 32; element ``k`` goes to word
    ``k // 32``, bit ``k % 32``."""
    axis = axis + 1 if axis >= 0 else axis
    k = planes.shape[axis]
    if k % PACK_WIDTH != 0:
        raise ValueError(f"pack axis length {k} not a multiple of {PACK_WIDTH}")
    x = torch.movedim(planes, axis, -1).to(torch.int64)
    x = x.reshape(x.shape[:-1] + (k // PACK_WIDTH, PACK_WIDTH))
    shifts = torch.arange(PACK_WIDTH, dtype=torch.int64, device=x.device)
    words = torch.sum(x << shifts, dim=-1)
    return torch.movedim(wrap_int32(words), -1, axis)


def unpack_planes(packed: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """32-bit words -> {0,1} planes (uint8); inverse of :func:`pack_planes`."""
    axis = axis + 1 if axis >= 0 else axis
    x = torch.movedim(packed.to(torch.int32), axis, -1)
    shifts = torch.arange(PACK_WIDTH, dtype=torch.int32, device=x.device)
    bits = (x[..., None] >> shifts) & 1      # arithmetic shift: bit 31 ok
    bits = bits.reshape(x.shape[:-1] + (x.shape[-1] * PACK_WIDTH,))
    bits = bits[..., :k]
    return torch.movedim(bits, -1, axis).to(torch.uint8)


def pad_for_packing(planes: torch.Tensor, axis: int,
                    pad_bit: int) -> torch.Tensor:
    """Pad the pack axis to a multiple of 32 with a constant bit (weights
    pad with 1, activations with 0; see :func:`pad_correction`)."""
    axis = axis + 1 if axis >= 0 else axis
    k = planes.shape[axis]
    pad = (-k) % PACK_WIDTH
    if pad == 0:
        return planes
    shape = list(planes.shape)
    shape[axis] = pad
    fill = torch.full(shape, pad_bit, dtype=planes.dtype,
                      device=planes.device)
    return torch.cat([planes, fill], dim=axis)


def pad_correction(k: int, n_w: int, n_x: int) -> int:
    """Additive correction for W-pad-bit 1 / X-pad-bit 0 K padding:
    ``n_pad * (2^{n_w}-1) * (2^{n_x}-1)``."""
    n_pad = (-k) % PACK_WIDTH
    return n_pad * max_value(n_w) * max_value(n_x)


# ---------------------------------------------------------------------------
# Quantized tensor container
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BipolarTensor:
    """A bipolar-INT quantized tensor in packed layout.

    ``packed`` is ``(n_bits, *shape_with_K_packed)`` int32 words (the
    uint32 bits); ``scale`` broadcasts against the dequantized tensor.
    ``width_scales`` (optional, ``(n_bits, *scale.shape)``) makes the
    tensor nested: row ``k-1`` is the dequant scale of the top-``k``
    plane prefix (:func:`nested_slice`); row ``n_bits-1`` equals
    ``scale``.
    """
    packed: torch.Tensor
    scale: torch.Tensor
    n_bits: int
    shape: tuple
    pack_axis: int
    width_scales: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def to(self, device) -> "BipolarTensor":
        ws = None if self.width_scales is None \
            else self.width_scales.to(device)
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   scale=self.scale.to(device),
                                   width_scales=ws)


def nested_slice(t: BipolarTensor, k: int) -> BipolarTensor:
    """Top-``k`` plane prefix of a packed tensor as a k-bit tensor: the
    k most significant planes are the TRAILING k entries of the leading
    plane axis.  The scale comes from ``width_scales`` when present, else
    the natural ``scale * 2^{n_bits-k}``."""
    m = t.n_bits
    if k == m:
        return t
    if not 1 <= k < m:
        raise ValueError(f"nested slice width {k} outside [1, {m}]")
    drop = m - k
    if t.width_scales is not None:
        scale = t.width_scales[k - 1]
        ws = t.width_scales[:k]
    else:
        scale = t.scale * float(1 << drop)
        ws = None
    return dataclasses.replace(t, packed=t.packed[drop:], scale=scale,
                               width_scales=ws, n_bits=k)


def dequantize(t: BipolarTensor) -> torch.Tensor:
    """Packed bipolar-INT -> real tensor (float32)."""
    k = t.shape[t.pack_axis]
    planes = unpack_planes(t.packed, t.pack_axis, k)
    return recover(planes, t.n_bits).float() * t.scale
