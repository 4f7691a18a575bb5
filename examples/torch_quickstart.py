"""Quickstart: the paper's arbitrary-precision MatMul, on the port.

The PyTorch + CUDA counterpart of ``examples/quickstart.py``, with the
same data (``np.random.default_rng(0)``) and the same steps:

 1. bipolar-INT quantization + §4.1 bit-plane packing (exact n bits/elt;
    K3 on the card),
 2. the §3.2 bit-serial MatMul == the fused operand-recovery MatMul ==
    the exact integer product (bit for bit; K5 on the card),
 3. on the card, the kernels (K5 both variants, K3) against their plain
    torch versions on the CPU, bit for bit; on the CPU the ops run the
    plain versions themselves, and the step says so,
 4. quantized-GEMM accuracy vs the float GEMM across bit-widths.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(``--device`` defaults to ``cuda`` and raises without a card).
"""

import argparse

import numpy as np
import torch

from repro_torch.core import bipolar
from repro_torch.kernels import ops, pack, ref
from repro_torch.models.model import resolve_device


def nbytes_packed(t) -> int:
    """The packed planes' and the scales' bytes."""
    return t.packed.numel() * 4 + t.scale.numel() * t.scale.element_size()


def nbytes_dense_bf16(t) -> int:
    return int(np.prod(t.shape)) * 2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)

    rng = np.random.default_rng(0)
    M, N, K = 64, 96, 300   # deliberately unaligned: pad correction in action

    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(dev)                          # activations
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)
                         ).to(dev)                          # weights

    print("== 1. quantize + pack (paper §3.1 + §4.1) ==")
    for bits in (1, 2, 3, 4):
        t = ops.pack_weight(w, bits)
        print(f"  W{bits}: packed {nbytes_packed(t):8d} B   "
              f"bf16 {nbytes_dense_bf16(t):8d} B   "
              f"({nbytes_dense_bf16(t) / nbytes_packed(t):.1f}x smaller)")

    print("== 2. bit-serial == fused == exact (paper §3.2 / Fig. 2) ==")
    at = ops.quantize_rows(x, 2, pad_bit=0)
    bt = ops.quantize_rows(w, 3, pad_bit=1)
    y_bs = ops.ap_matmul(at, bt, variant="bitserial", raw=True)
    y_fu = ops.ap_matmul(at, bt, variant="fused", raw=True)
    exact = (bipolar.quantize_values(x.cpu(), 2, at.scale.cpu()).long()
             @ bipolar.quantize_values(w.cpu(), 3, bt.scale.cpu()).long().T)
    assert torch.equal(y_bs.cpu(), y_fu.cpu())
    assert torch.equal(y_fu.cpu().long(), exact)
    print(f"  W3A2 {M}x{N}x{K}: bit-serial and fused agree bit-for-bit "
          f"(checksum {int(y_fu.cpu().long().sum())})")

    if dev.type == "cuda":
        print("== 3. the card's kernels vs their plain versions ==")
        a_cpu, b_cpu = at.to("cpu"), bt.to("cpu")
        for variant, y in (("fused", y_fu), ("bitserial", y_bs)):
            want = ref.apmm_packed(a_cpu, b_cpu, variant=variant)
            assert torch.equal(y.cpu(), want), variant
        assert torch.equal(at.packed.cpu(), pack.quantize_pack_rows_plain(
            x.cpu(), at.scale.cpu(), n_bits=2, pad_bit=0))
        print("  K5 (fused and bit-serial) and K3 on the card match the "
              "plain torch versions exactly")
    else:
        print("== 3. the plain versions (no card) ==")
        print(f"  on {dev.type} tensors the ops ran the kernels' plain torch "
              f"versions; the kernels run on CUDA tensors only")

    print("== 4. accuracy vs float across bit-widths ==")
    y_f = x.cpu().numpy() @ w.cpu().numpy().T
    for wb, ab in ((1, 2), (2, 2), (3, 4), (4, 8), (8, 8)):
        wt = ops.pack_weight(w, wb)
        y_q = ops.ap_linear(x, wt, a_bits=ab).cpu().numpy()
        rel = np.abs(y_q - y_f).mean() / np.abs(y_f).mean()
        print(f"  W{wb}A{ab}: mean relative error {rel * 100:6.2f}%")

    print("done.")


if __name__ == "__main__":
    main()
