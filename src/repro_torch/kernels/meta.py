"""The kernels' third device: ``meta``.

Each kernel wrapper runs its plain version on a CPU tensor, launches its
kernel on a CUDA tensor, and on a ``meta`` tensor calls the function of
this module of the same name: it returns empty ``meta`` outputs of the
kernel's shapes and dtypes, launches nothing (no launch counter moves)
and adds the call's work to the open :func:`tally`, if one is open.
That is how the dry run (:mod:`repro_torch.launch.dryrun`) walks the
quantized serving path at full size with no storage.

The work of a call is counted from its shapes alone, by the formulas of
the kernels' bounds (PERF.md §6), one function a kernel (``*_work``):

* K1 and K5 (``fused``): ``2 M N K`` integer MACs for every pair of
  activation and weight plane groups (``ref.plane_groups``), twice for
  K1's dual gate/up; ``bitserial``: ``2 M N K`` b1 operations for every
  pair of bits;
* K4: as K1 over every capacity row -- on ``meta`` the live rows are not
  known, so every segment is taken as full (its capacity is its height);
* K2, K6 and K7: ``4 d`` f32 (K7: the query's dtype) FLOPs for every
  (query row, KV slot, head) the call is handed, masked or not;
* K3: no operations, only bytes.

Bytes: each operand read once and each output written once.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ref

# the open tally (None: calls on meta are not counted)
_TALLY: Optional["Tally"] = None


@dataclasses.dataclass
class Call:
    """One kernel call on meta: the kernel, its variant and its work."""
    kernel: str
    variant: str
    ops: int
    bytes: int
    op_type: str


class Tally:
    """The kernel calls made while it is open, in order."""

    def __init__(self):
        self.calls: list = []

    def by_kernel(self) -> dict:
        """``{kernel: {"calls", "ops", "bytes", "op_type"}}`` summed over
        the calls (a bit-serial kernel under its own name, ``-bs``)."""
        out: dict = {}
        for c in self.calls:
            name = c.kernel + ("-bs" if c.variant == "bitserial" else "")
            e = out.setdefault(name, dict(calls=0, ops=0, bytes=0,
                                          op_type=c.op_type))
            e["calls"] += 1
            e["ops"] += c.ops
            e["bytes"] += c.bytes
        return out


@contextlib.contextmanager
def tally():
    """Count the kernel calls made on meta tensors inside the block."""
    global _TALLY
    prev, _TALLY = _TALLY, Tally()
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def _record(kernel, variant, work):
    if _TALLY is not None:
        ops, n_bytes, op_type = work
        _TALLY.calls.append(Call(kernel, variant, int(ops), int(n_bytes),
                                 op_type))


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the work of a call, from its shapes (PERF.md §6's bound formulas)
# ---------------------------------------------------------------------------

def _pairs(a_bits: int, w_bits: int, variant: str) -> int:
    """Plane-group pairs (``fused``) or bit pairs (``bitserial``)."""
    if variant == "bitserial":
        return a_bits * w_bits
    return len(ref.plane_groups(a_bits)) * len(ref.plane_groups(w_bits))


def k1_work(m, n, k, kw, *, a_bits, w_bits, variant, dual, residual,
            x_size, out_size):
    """K1: ``(ops, bytes, "int8" | "b1")``."""
    nw = 2 if dual else 1
    n_bytes = m * k * x_size + m * 4 + nw * (w_bits * n * kw * 4 + n * 4) \
        + (m * n * out_size if residual else 0) + m * n * out_size
    return (nw * _pairs(a_bits, w_bits, variant) * 2 * m * n * k, n_bytes,
            "b1" if variant == "bitserial" else "int8")


def k3_work(r, k, n_bits, *, x_size=4):
    """K3: no operations; ``x``, its scales and the planes."""
    kw = -(-k // 32)
    return 0, r * k * x_size + r * 4 + n_bits * r * kw * 4, "bytes"


def k4_work(e, c, n, k, kw, g, *, a_bits, w_bits, variant, dual, x_size,
            out_size):
    """K4 over all ``E * C`` capacity rows (every expert live)."""
    nw = 2 if dual else 1
    n_bytes = e * c * k * x_size + e * c * 4 + e * g * 4 \
        + e * nw * (w_bits * n * kw * 4 + n * 4) + e * c * n * out_size
    return (nw * _pairs(a_bits, w_bits, variant) * 2 * e * c * n * k,
            n_bytes, "b1" if variant == "bitserial" else "int8")


def k5_work(m, n, k, kw, *, a_bits, w_bits, variant, out_size):
    """K5: the two packed operands, their scales and the product."""
    n_bytes = (a_bits * m + w_bits * n) * kw * 4 + (m + n) * 4 \
        + m * n * out_size
    return (_pairs(a_bits, w_bits, variant) * 2 * m * n * k, n_bytes,
            "b1" if variant == "bitserial" else "int8")


def attention_work(rows, slots, h, d, *, slot_bytes, io_bytes, op_type):
    """K2, K6, K7: ``4 d`` FLOPs for every (query row, slot, head) pair
    (``rows`` and ``slots`` per lane, summed over lanes by the caller)."""
    return 4 * d * rows * slots * h, slot_bytes + io_bytes, op_type


# ---------------------------------------------------------------------------
# the wrappers' meta branches
# ---------------------------------------------------------------------------

def apmm_fused_linear(x2, a_scale, w, *, w2=None, bias=None, residual=None,
                      a_bits, variant="fused", act="none",
                      out_dtype=torch.float32):
    m, k = x2.shape
    n_b, n, kw = w.packed.shape
    out = _empty((m, n), out_dtype)
    _record("K1", variant,
            k1_work(m, n, k, kw, a_bits=a_bits, w_bits=n_b, variant=variant,
                    dual=w2 is not None, residual=residual is not None,
                    x_size=x2.element_size(), out_size=out_dtype.itemsize))
    return out


def quantize_pack_rows(x, scale, *, n_bits, pad_bit):
    r, k = x.shape
    out = _empty((n_bits, r, -(-k // 32)), torch.int32)
    _record("K3", "fused",
            k3_work(r, k, n_bits, x_size=x.element_size()))
    return out


def moe_expert_linear(x, a_scale, counts, w, *, w2=None, a_bits,
                      variant="fused", act="none", out_dtype=torch.bfloat16,
                      bc):
    e, c, k = x.shape
    n_b, _, n, kw = w.packed.shape
    g = counts.shape[1]
    y = _empty((e, c, n), out_dtype)
    live = _empty((e * g, -(-(c // g) // bc)), torch.int32)
    _record("K4", variant,
            k4_work(e, c, n, k, kw, g, a_bits=a_bits, w_bits=n_b,
                    variant=variant, dual=w2 is not None,
                    x_size=x.element_size(), out_size=out_dtype.itemsize))
    return y, live


def apmm_packed(a, b, *, variant="fused", out_dtype=None):
    (m, k), (n, _) = a.shape, b.shape
    n_a, _, kw = a.packed.shape
    n_b = b.packed.shape[0]
    dt = torch.int32 if out_dtype is None else out_dtype
    out = _empty((m, n), dt)
    _record("K5", variant,
            k5_work(m, n, k, kw, a_bits=n_a, w_bits=n_b, variant=variant,
                    out_size=dt.itemsize))
    return out


def flash_attention_paged_quantized(q, k_pool, k_scale, v_pool, v_scale,
                                    pool_pos, block_tables, q_pos, *, d,
                                    causal=True, window=None):
    b, h, gq, _ = q.shape
    _, bs, _, n_bits, dw = k_pool.shape
    nb = block_tables.shape[1]
    out = _empty(tuple(q.shape), q.dtype)
    slot = h * (2 * n_bits * dw * 4 + 8) + 4
    io = 2 * q.numel() * q.element_size() + q_pos.numel() * 4 \
        + block_tables.numel() * 4
    _record("K2", "fused",
            attention_work(b * gq, nb * bs, h, d,
                           slot_bytes=b * nb * bs * slot, io_bytes=io,
                           op_type="f32"))
    return out


def flash_attention_quantized(q, k_packed, k_scale, v_packed, v_scale, q_pos,
                              kv_pos, *, d, causal=True, window=None,
                              return_lse=False):
    b, h, sq, _ = q.shape
    _, t, _, n_bits, dw = k_packed.shape
    out = _empty(tuple(q.shape), q.dtype)
    io = 2 * q.numel() * q.element_size() + (q_pos.numel()
                                             + kv_pos.numel()) * 4 \
        + (b * h * sq * 4 if return_lse else 0)
    _record("K6", "fused",
            attention_work(b * sq, t, h, d,
                           slot_bytes=b * t * h * 2 * (n_bits * dw * 4 + 4),
                           io_bytes=io, op_type="f32"))
    if return_lse:
        return out, _empty((b, h, sq), torch.float32)
    return out


def flash_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None):
    bh, sq, d = q.shape
    t = k.shape[1]
    out = _empty(tuple(q.shape), q.dtype)
    io = 2 * q.numel() * q.element_size() + (q_pos.numel()
                                             + kv_pos.numel()) * 4
    _record("K7", "fused",
            attention_work(bh * sq, t, 1, d,
                           slot_bytes=bh * t * 2 * d * k.element_size(),
                           io_bytes=io,
                           op_type="bf16" if q.dtype == torch.bfloat16
                           else "f32"))
    return out
