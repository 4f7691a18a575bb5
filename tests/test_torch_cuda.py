"""Card-only tests of the port's CUDA kernels against their plain torch
versions, on the card.  Run on a machine with an NVIDIA card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips (decided inside the ``device`` fixture).
Tolerances: K3 words and the K1 integer core (``act="none"``, f32 out)
are bit-exact; K1 SiLU outputs within 1 bf16 ulp per element (exp
differs between the kernel and torch, rounded once to bf16), gelu
within 1.6e-2 relative (tanh); K2 within 1 bf16 ulp per element, or
1e-5 absolute near zero (f32 sum order and exp), held against the
plain version of its C entry's split plan
(``ref.paged_attention_split``) at decode shapes, where it splits each
table across blocks, and against ``ref.paged_attention`` at a prefill
chunk, where it does not.  K4: the integer core of each weight and the bf16 ``act="none"`` output bit-exact, the dual
SiLU output within 1 bf16 ulp, dead rows exactly 0, the live map equal
to the analytic one.  K5 (the packed x packed GEMM): the raw int32
product and the f32/bf16 dequant bit-exact, on both sides of its
small-M route's threshold (``apmm.packed_small_m_max()``); the unfused
linear (K3 + K5) equal to the fused one (K1) bit for bit at ``act="none"`` and with a
residual, and within K1's 1-ulp SiLU rule through the SwiGLU.  K6 and
K7 (contiguous attention, packed and float K/V): within 1 bf16 ulp per
element, or 1e-5 absolute, of the plain version; K6 and K7's bf16 route
also where their C entries split T (some ranges seen by no query row)
and against the split plain versions (``ref.kv_cache_attention_split``,
``ref.flash_attention_split``), K6 on both sides of its split
threshold.  K3 is also held bit for bit at every width 1..8 and against
the bit-serial prologue, which runs its warp routine.  K1's small-M route (M up to
``apmm.small_m_max()``): the integer core bit-exact on both sides of the
threshold, the dual SiLU within 1 bf16 ulp, bias and residual bit-exact.
Fused K4 on both sides of its route threshold (``moe.fused_route_max()``:
the weight-streaming decode route and the int8 tensor-core chunk route)
at six width pairs: the same rules as K4's other cases.
The bitserial variants of K1 and K4 on both sides of the b1 core's
stacked-route threshold (``apmm.bitserial_stack_max()``,
``moe.bitserial_stack_max()``): integer cores bit-exact to the plain
versions and to the fused kernels, outputs equal to the fused kernels';
their prologue's packed words equal K3's and its SU the rows' sums.
The enc-dec and VLM shapes: K6 not causal at seamless-m4t-medium's
cross-attention reads (pad lanes on the null row exactly 0), K2 at
qwen2-vl-7b's GQA group 7, K1 and K1-bs at seamless's GELU up projection
(1 bf16 ulp), and both reduced models served on the card and the CPU.
Training: one gradient step of reduced llama3-8b on the card against the
CPU (the loss within 4e-5, the gradient norm within 2e-4, each leaf's
gradient within 2e-2 in relative L2; a bf16 logsumexp misses), and a
restart on the card with int8 moments that is bit-exact.  The
distributed layer at world size 1 over NCCL (``-k distributed``; a
one-rank group for the module): ``sharded_step`` equal to the plain step
bit for bit, ``compressed_psum`` equal to the CPU's, a restore onto the
card mesh bit for bit, a one-stage pipeline within 1e-5 of sequential.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bipolar
from repro_torch.kernels import apmm, flash_attention, moe, ops, pack, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16_ulps(a, b):
    """Elementwise ordinal distance of two bf16 tensors' bit patterns."""
    def ordinal(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordinal(a) - ordinal(b)).abs()


def _rand(rng, shape, dev, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, dtype)


@pytest.mark.parametrize("n_bits", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("k", [32, 100, 4096])
@pytest.mark.parametrize("pad_bit", [0, 1])
def test_pack_kernel_words_equal_plain(device, n_bits, k, pad_bit):
    rng = np.random.default_rng(n_bits * 31 + k)
    x = _rand(rng, (37, k), device) * 2.5
    scale = bipolar.absmax_scale(x, n_bits, axis=-1)
    got = pack.quantize_pack_rows(x, scale, n_bits=n_bits, pad_bit=pad_bit)
    torch.cuda.synchronize()
    want = ref.quantize_pack_rows(x, scale, n_bits=n_bits, pad_bit=pad_bit)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [1, 3, 14336])
@pytest.mark.parametrize("k", [1, 31, 33, 100, 4096])
@pytest.mark.parametrize("pad_bit", [0, 1])
def test_pack_kernel_words_equal_plain_every_width(device, rows, k, pad_bit):
    """K3 at every width 1..8, both pad bits, K below, around and above
    one word (ragged last words) and row counts on both sides of its C
    entry's choice of words a warp: the plain version's words."""
    rng = np.random.default_rng(rows + k + pad_bit)
    x = _rand(rng, (rows, k), device) * 2.5
    before = pack.LAUNCHES
    for n_bits in range(1, 9):
        scale = bipolar.absmax_scale(x, n_bits, axis=-1)
        got = pack.quantize_pack_rows(x, scale, n_bits=n_bits,
                                      pad_bit=pad_bit)
        torch.cuda.synchronize()
        want = ref.quantize_pack_rows(x, scale, n_bits=n_bits,
                                      pad_bit=pad_bit)
        assert torch.equal(got, want), n_bits
    assert pack.LAUNCHES == before + 8


@pytest.mark.parametrize("m,k", [(1, 1), (3, 33), (4, 4096), (5, 1001),
                                 (70, 14336)])
@pytest.mark.parametrize("a_bits", [1, 4, 8])
def test_pack_kernel_words_equal_bitserial_prologue(device, m, k, a_bits):
    """K3 (pad bit 0) and the bit-serial prologue run one warp routine
    (csrc/pack_core.cuh) at different words a warp: the same words."""
    rng = np.random.default_rng(m * k + a_bits)
    x = _rand(rng, (m, k), device)
    a_s = bipolar.absmax_scale(x, a_bits, axis=-1).float()
    planes, _ = apmm.bitserial_pack_x(x, a_s, a_bits=a_bits,
                                      kw=bipolar.packed_words(k))
    got = pack.quantize_pack_rows(x, a_s, n_bits=a_bits, pad_bit=0)
    torch.cuda.synchronize()
    assert torch.equal(got, planes)


@pytest.mark.parametrize("m,n,k", [(5, 70, 100), (67, 130, 300),
                                   (4, 256, 4096)])
@pytest.mark.parametrize("a_bits,w_bits", [(8, 2), (8, 8), (4, 3)])
def test_apmm_kernel_integer_core_bit_exact(device, m, n, k, a_bits, w_bits):
    rng = np.random.default_rng(m + n + k + a_bits * 10 + w_bits)
    w = ops.pack_weight(_rand(rng, (n, k), device), w_bits)
    x = _rand(rng, (m, k), device)
    a_s = bipolar.absmax_scale(x, a_bits, axis=-1).float()
    got = apmm.apmm_fused_linear(x, a_s, w, a_bits=a_bits,
                                 out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = ref.ap_linear_fused_ref(x, a_s, w, a_bits=a_bits,
                                   out_dtype=torch.float32)
    assert torch.equal(got, want)
    bias = _rand(rng, (n,), device)
    got = apmm.apmm_fused_linear(x, a_s, w, bias=bias, a_bits=a_bits)
    want = ref.ap_linear_fused_ref(x, a_s, w, bias=bias, a_bits=a_bits)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,k", [(5, 70, 100), (67, 200, 256)])
def test_apmm_kernel_bf16_dual_silu_residual(device, m, n, k):
    rng = np.random.default_rng(m * n)
    w = ops.pack_weight(_rand(rng, (n, k), device), 2)
    w2 = ops.pack_weight(_rand(rng, (n, k), device), 2)
    x = _rand(rng, (m, k), device, torch.bfloat16)
    res = _rand(rng, (m, n), device, torch.bfloat16)
    got = ops.ap_linear_fused(x, w, a_bits=8, residual=res)
    want = ref.ap_linear_fused_ref(
        x, bipolar.absmax_scale(x, 8, axis=-1).float(), w, residual=res,
        a_bits=8, out_dtype=torch.bfloat16)
    assert torch.equal(got, want)
    a_s = bipolar.absmax_scale(x, 8, axis=-1).float()
    assert torch.equal(
        apmm.apmm_fused_linear(x, a_s, w2, a_bits=8, out_dtype=torch.float32),
        ref.ap_linear_fused_ref(x, a_s, w2, a_bits=8,
                                out_dtype=torch.float32))
    got = ops.ap_linear_fused(x, w, w2=w2, a_bits=8, act="silu")
    want = ref.ap_linear_fused_ref(x, a_s, w, w2=w2, a_bits=8, act="silu",
                                   out_dtype=torch.bfloat16)
    assert int(_bf16_ulps(got, want).max()) <= 1


def _small_m(m_case):
    """M of a small-M case: a number (12 and 20 end in a partial group of
    8 rows), or the route's threshold (+1)."""
    t = apmm.small_m_max()
    return {"threshold": t, "threshold+1": t + 1}.get(m_case, m_case)


@pytest.mark.parametrize("m_case", [1, 4, 8, 12, 20, "threshold",
                                    "threshold+1"])
@pytest.mark.parametrize("n", [70, 4096])
@pytest.mark.parametrize("k", [100, 4096, 14336])
@pytest.mark.parametrize("a_bits,w_bits", [(8, 2), (8, 8), (4, 3), (1, 1)])
def test_apmm_kernel_small_m_integer_core_bit_exact(device, m_case, n, k,
                                                    a_bits, w_bits):
    """K1's decode shapes: M <= small_m_max() runs the small-M route (its
    launch counter moves), M above it the tile kernel; the integer core
    is bit-exact on both sides of the threshold."""
    m = _small_m(m_case)
    assert apmm.small_m_max() >= 8
    rng = np.random.default_rng(m * 7 + n + k + a_bits * 10 + w_bits)
    w = ops.pack_weight(_rand(rng, (n, k), device), w_bits)
    x = _rand(rng, (m, k), device, torch.bfloat16)
    a_s = bipolar.absmax_scale(x, a_bits, axis=-1).float()
    before = apmm.SMALL_M_LAUNCHES
    got = apmm.apmm_fused_linear(x, a_s, w, a_bits=a_bits,
                                 out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert apmm.SMALL_M_LAUNCHES - before == int(m <= apmm.small_m_max())
    want = ref.ap_linear_fused_ref(x, a_s, w, a_bits=a_bits,
                                   out_dtype=torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m_case", [1, 4, 8, 12, 20, "threshold",
                                    "threshold+1"])
@pytest.mark.parametrize("n,k", [(70, 100), (4096, 4096), (70, 14336)])
def test_apmm_kernel_small_m_dual_silu_residual(device, m_case, n, k):
    """Dual gate/up with SiLU within 1 bf16 ulp, the residual output and
    a bias bit-exact, at the small-M shapes."""
    m = _small_m(m_case)
    rng = np.random.default_rng(m * 13 + n + k)
    w = ops.pack_weight(_rand(rng, (n, k), device), 2)
    w2 = ops.pack_weight(_rand(rng, (n, k), device), 2)
    x = _rand(rng, (m, k), device, torch.bfloat16)
    res = _rand(rng, (m, n), device, torch.bfloat16)
    bias = _rand(rng, (n,), device)
    a_s = bipolar.absmax_scale(x, 8, axis=-1).float()
    got = apmm.apmm_fused_linear(x, a_s, w, w2=w2, a_bits=8, act="silu",
                                 out_dtype=torch.bfloat16)
    want = ref.ap_linear_fused_ref(x, a_s, w, w2=w2, a_bits=8, act="silu",
                                   out_dtype=torch.bfloat16)
    assert int(_bf16_ulps(got, want).max()) <= 1
    got = apmm.apmm_fused_linear(x, a_s, w, residual=res, bias=bias,
                                 a_bits=8, out_dtype=torch.bfloat16)
    want = ref.ap_linear_fused_ref(x, a_s, w, residual=res, bias=bias,
                                   a_bits=8, out_dtype=torch.bfloat16)
    assert torch.equal(got, want)


def _pool(rng, dev, n_blocks, bs, h, n_bits, d):
    kv = _rand(rng, (2, n_blocks, bs, h, d), dev)
    kq, ks = ops.quantize_kv(kv[0], n_bits)
    vq, vs = ops.quantize_kv(kv[1], n_bits)
    return kq, ks, vq, vs


@pytest.mark.parametrize("bs,d,gq,window", [(16, 128, 4, None),
                                            (16, 128, 64, None),
                                            (8, 48, 20, 24), (4, 32, 3, None)])
def test_paged_attention_kernel_matches_plain(device, bs, d, gq, window):
    rng = np.random.default_rng(bs * d + gq)
    b, h, n_bits, n_blocks, nb = 3, 2, 8, 12, 5
    kq, ks, vq, vs = _pool(rng, device, n_blocks, bs, h, n_bits, d)
    pos = torch.full((n_blocks, bs), -1, dtype=torch.int32)
    tables = torch.zeros((b, nb), dtype=torch.int32)
    lens = [3 * bs + 2, bs, 0]
    nxt = 1
    for i, ln in enumerate(lens):          # row 2 owns nothing: all masked
        for j in range(-(-ln // bs)):
            tables[i, j] = nxt
            cnt = min(bs, ln - j * bs)
            pos[nxt, :cnt] = torch.arange(j * bs, j * bs + cnt)
            nxt += 1
    qpos = torch.tensor([[max(ln - 1 - (gq - 1 - g) // 2, -1)
                          for g in range(gq)] for ln in lens],
                        dtype=torch.int32)
    qpos[0, 0] = -1                        # a padded query row
    q = _rand(rng, (b, h, gq, d), device, torch.bfloat16)
    args = (q, kq, ks, vq, vs, pos.to(device), tables.to(device),
            qpos.to(device))
    got = flash_attention.flash_attention_paged_quantized(
        *args, d=d, window=window)
    torch.cuda.synchronize()
    want = ref.paged_attention(*args, d=d, window=window)
    near = (got.float() - want.float()).abs() <= 1e-5
    assert torch.all((_bf16_ulps(got, want) <= 1) | near)
    assert torch.all(got[2] == 0) and torch.all(got[0, :, 0] == 0)


def _paged_case(dev, seed, lanes, s_q, nb, window, *, h=8, group=4, d=128,
                bs=16, n_bits=8, dtype=torch.bfloat16):
    """K2's arguments: lane i holds ``lanes[i]`` tokens in blocks of its
    own, less those wholly out of the window (reclaimed: not in its
    table), the table padded to ``nb`` null entries; None: a pad lane on
    an all-null table.  Queries: each lane's last ``s_q`` positions times
    ``group`` heads (pad lanes -1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    spans = []
    for ctx in lanes:
        lo = 0 if ctx is None or window is None else \
            max(0, ctx - s_q + 1 - window) // bs
        spans.append(None if ctx is None else (ctx, lo, -(-ctx // bs) - lo))
    n_blocks = 1 + sum(sp[2] for sp in spans if sp)
    kv = torch.randn((2, n_blocks, bs, h, d), generator=g, device=dev)
    kq, ks = ops.quantize_kv(kv[0], n_bits)
    vq, vs = ops.quantize_kv(kv[1], n_bits)
    pos = torch.full((n_blocks, bs), -1, dtype=torch.int32, device=dev)
    tables = torch.zeros((len(lanes), nb), dtype=torch.int32, device=dev)
    q_pos = torch.full((len(lanes), group * s_q), -1, dtype=torch.int32,
                       device=dev)
    nxt = 1
    for row, sp in enumerate(spans):
        if sp is None:
            continue
        ctx, first, n_blk = sp
        tables[row, :n_blk] = torch.arange(nxt, nxt + n_blk)
        p = torch.arange(first * bs, (first + n_blk) * bs, device=dev)
        pos[nxt:nxt + n_blk] = torch.where(p < ctx, p, -1).reshape(
            n_blk, bs).to(torch.int32)
        nxt += n_blk
        q_pos[row] = torch.arange(ctx - s_q, ctx, dtype=torch.int32,
                                  device=dev).repeat(group)
    q = torch.randn((len(lanes), h, group * s_q, d), generator=g,
                    device=dev).to(dtype)
    return q, kq, ks, vq, vs, pos, tables, q_pos


# (lanes, s_q, NB, window, options): llama decode (B = 4, ctx 600), a
# prefill chunk (one 256-token lane: a grid that fills the card), mixtral's
# decode step (8 lanes, 3 of them pads, one past its 4,096-token window),
# and a small odd shape (bs 4, d 40, 3 bits: 4-byte copies)
_PAGED_CASES = {
    "decode": ((600,) * 4, 1, 64, None, {}),
    "chunk": ((600,), 256, 64, None, {}),
    "mixtral window": ((609, 109, 309, 4309, 209, None, None, None), 1, 272,
                       4096, {}),
    "odd": ((37, 6, None, 15), 2, 11, 9,
            dict(h=2, group=2, d=40, bs=4, n_bits=3)),
}


@pytest.mark.parametrize("case", list(_PAGED_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_split_kv(device, case, dtype):
    """K2 where its C entry splits the table (decode shapes: B * H blocks)
    and where it does not (the chunk): within 1 bf16 ulp or 1e-5 (f32 q:
    1e-6 relative or 1e-5) of the plain version of its plan -- the split
    plain version, or the plain version itself at one range -- pad lanes
    and pad query rows exactly 0."""
    lanes, s_q, nb, window, kw = _PAGED_CASES[case]
    args = _paged_case(device, len(case), lanes, s_q, nb, window,
                       dtype=dtype, **kw)
    b, h, gq, d = args[0].shape
    n_split = flash_attention.paged_splits(b, h, gq, nb)
    assert (n_split > 1) == (case != "chunk")
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_attention_paged_quantized(
        *args, d=d, window=window)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    want = ref.paged_attention_split(*args, splits=n_split, d=d,
                                     window=window)
    if n_split == 1:
        assert torch.equal(want, ref.paged_attention(*args, d=d,
                                                     window=window))
    assert _within_one_ulp_or(got, want)
    pads = [i for i, ln in enumerate(lanes) if ln is None]
    assert torch.all(got[pads] == 0)


def test_launch_counters_count_kernel_launches_only(device):
    rng = np.random.default_rng(0)
    x = _rand(rng, (8, 64), device)
    before = (pack.LAUNCHES, apmm.LAUNCHES)
    w = ops.pack_weight(x, 2)
    ops.ap_linear_fused(x, w, a_bits=8)
    ref.ap_linear_fused_ref(x, bipolar.absmax_scale(x, 8, axis=-1), w,
                            a_bits=8)
    assert (pack.LAUNCHES, apmm.LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("m", [1, 8, 9, 63, 64, 65])
def test_apmm_kernel_row_edges_gelu_bias_nested(device, m):
    """Row-tile edges, the gelu epilogue with bias (tolerance: tanh and
    exp differ between the kernel and torch) and nested w_bits slicing
    (bit-exact integer core)."""
    rng = np.random.default_rng(m)
    n, k = 96, 200
    w = ops.pack_weight(_rand(rng, (n, k), device), 4)
    x = _rand(rng, (m, k), device, torch.bfloat16)
    a_s = bipolar.absmax_scale(x, 8, axis=-1).float()
    for bits in (1, 2, 4):
        ws = bipolar.nested_slice(w, bits)
        got = apmm.apmm_fused_linear(x, a_s, ws, a_bits=8)
        want = ref.ap_linear_fused_ref(x, a_s, ws, a_bits=8)
        assert torch.equal(got, want), bits
    bias = _rand(rng, (n,), device)
    got = apmm.apmm_fused_linear(x, a_s, w, bias=bias, act="gelu", a_bits=8,
                                 out_dtype=torch.bfloat16)
    want = ref.ap_linear_fused_ref(x, a_s, w, bias=bias, act="gelu",
                                   a_bits=8, out_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)


def _expert_weight(rng, dev, e, n, k, bits):
    w = _rand(rng, (e, n, k), dev) / k ** 0.5
    from repro_torch.models.model import _quantize_experts
    from repro_torch.models.config import QuantConfig
    return _quantize_experts(w, QuantConfig(w_bits=bits))


@pytest.mark.parametrize("e,g,seg,k,n", [
    (8, 1, 2, 256, 300),          # decode: the decode route
    (4, 2, 5, 37, 19),            # odd K and N, two groups
    (3, 1, 70, 200, 130),         # a work list over two row tiles
    (2, 1, 300, 96, 64),          # two 256-row live-map tiles
    (4, 32, 3, 64, 64),           # G = 32
])
@pytest.mark.parametrize("a_bits,w_bits", [(8, 2), (4, 3), (8, 8)])
def test_moe_kernel_matches_plain(device, e, g, seg, k, n, a_bits, w_bits):
    rng = np.random.default_rng(e * 1000 + seg + k + a_bits * 10 + w_bits)
    w = _expert_weight(rng, device, e, n, k, w_bits)
    w2 = _expert_weight(rng, device, e, n, k, w_bits)
    counts = torch.from_numpy(rng.integers(0, seg + 1, (e, g))
                              .astype(np.int32))
    counts[1 % e] = 0                                 # an empty expert
    counts = counts.to(device)
    x = _rand(rng, (e, g * seg, k), device, torch.bfloat16)
    bc = ops.moe_row_tile(seg)
    a_s = bipolar.absmax_scale(x.float(), a_bits, axis=-1)
    rows = torch.arange(g * seg, device=device)
    dead = (rows % seg)[None, :] >= counts[:, rows // seg]
    before = moe.LAUNCHES
    for wt in (w, w2):               # integer core of each weight
        got, live = moe.moe_expert_linear(x, a_s, counts, wt, a_bits=a_bits,
                                          out_dtype=torch.float32, bc=bc)
        torch.cuda.synchronize()
        want, live_ref = moe.moe_expert_linear_plain(
            x, a_s, counts, wt, a_bits=a_bits, out_dtype=torch.float32,
            bc=bc)
        assert torch.equal(got, want)
        assert torch.equal(live, live_ref)
        assert not got[dead].any()
    got = ops.ap_moe_expert_linear(x, w, counts=counts, a_bits=a_bits)
    want = ref.ap_moe_expert_linear_ref(x, a_s, counts, w, a_bits=a_bits)
    assert torch.equal(got, want)
    got = ops.ap_moe_expert_linear(x, w, w2=w2, counts=counts,
                                   a_bits=a_bits, act="silu")
    want = ref.ap_moe_expert_linear_ref(x, a_s, counts, w, w2=w2,
                                        a_bits=a_bits, act="silu")
    assert int(_bf16_ulps(got, want).max()) <= 1
    assert not got[dead].any()
    assert moe.LAUNCHES == before + 4
    # the bitserial kernel: the same outputs and live map as the plain
    # version and as the fused kernel, on its own counter
    bs_before = moe.BITSERIAL_LAUNCHES
    for wt in (w, w2):
        got, live = moe.moe_expert_linear(x, a_s, counts, wt, a_bits=a_bits,
                                          variant="bitserial",
                                          out_dtype=torch.float32, bc=bc)
        torch.cuda.synchronize()
        want, live_ref = moe.moe_expert_linear_plain(
            x, a_s, counts, wt, a_bits=a_bits, variant="bitserial",
            out_dtype=torch.float32, bc=bc)
        fused, _ = moe.moe_expert_linear(x, a_s, counts, wt, a_bits=a_bits,
                                         out_dtype=torch.float32, bc=bc)
        assert torch.equal(got, want) and torch.equal(got, fused)
        assert torch.equal(live, live_ref)
        assert not got[dead].any()
    got = ops.ap_moe_expert_linear(x, w, w2=w2, counts=counts,
                                   a_bits=a_bits, act="silu",
                                   variant="bitserial")
    fused = ops.ap_moe_expert_linear(x, w, w2=w2, counts=counts,
                                     a_bits=a_bits, act="silu")
    want = ref.ap_moe_expert_linear_ref(x, a_s, counts, w, w2=w2,
                                        a_bits=a_bits, act="silu",
                                        variant="bitserial")
    assert torch.equal(got, fused)
    assert int(_bf16_ulps(got, want).max()) <= 1
    assert moe.BITSERIAL_LAUNCHES == bs_before + 3
    assert moe.LAUNCHES == before + 7
    if w_bits == 8:                  # nested slices of the 8-bit weights
        got = ops.ap_moe_expert_linear(x, w, counts=counts, a_bits=a_bits,
                                       w_bits=3)
        want = ref.ap_moe_expert_linear_ref(
            x, a_s, counts, bipolar.nested_slice(w, 3), a_bits=a_bits)
        assert torch.equal(got, want)


class _RecordingEngine:
    """Mixin recording each logits row the engine samples from."""

    def _sample_checked(self, row, seq):
        self.rows = getattr(self, "rows", {})
        self.rows[(id(seq.req), len(seq.req.out))] = np.array(row)
        return super()._sample_checked(row, seq)


def test_engine_on_card_matches_engine_on_cpu(device):
    """The same reduced w2/a8/kv8 model served on the card (kernels) and
    on the CPU (plain versions): greedy tokens agree wherever the CPU
    run's top-1/top-2 margin exceeds 0.05 (the kernels' exp and f32
    summation order differ from torch's)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import model as M
    from repro_torch.models.config import QuantConfig
    from repro_torch.serving import engine as E

    class CpuEngine(_RecordingEngine, E.Engine):
        pass

    cfg = get_config("llama3-8b").reduced(n_layers=2, d_head=32, vocab=256)
    q = QuantConfig(w_bits=2, a_bits=8, kv_bits=8)
    params = M.init_params(cfg, seed=1, device="cpu", quant=q)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, (5 + 7 * i,), dtype=np.int32)
               for i in range(3)]
    outs = {}
    before = (apmm.LAUNCHES, flash_attention.LAUNCHES)
    for dev, cls in (("cpu", CpuEngine), ("cuda", E.Engine)):
        p = params if dev == "cpu" else _to(params, device)
        eng = cls(p, cfg, n_slots=2, max_len=48, quant=q, paged=True,
                  block_size=8, chunk_tokens=8)
        reqs = [E.Request(prompt=pr.copy(), max_new_tokens=8)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert eng.report()["free_blocks"] == eng.report()["n_usable"]
        outs[dev] = (reqs, eng)
    assert apmm.LAUNCHES > before[0] and flash_attention.LAUNCHES > before[1]
    (rc, ec), (rg, _) = outs["cpu"], outs["cuda"]
    for a, b in zip(rc, rg):
        kk = next((i for i, (x, y) in enumerate(zip(a.out, b.out))
                   if x != y), None)
        if kk is not None:
            top = np.sort(ec.rows[(id(a), kk)])
            assert top[-1] - top[-2] < 0.05, (kk, a.out, b.out)


def _to(tree, dev):
    from repro_torch.core.bipolar import BipolarTensor
    if isinstance(tree, BipolarTensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_moe_engine_on_card_matches_engine_on_cpu(device):
    """Reduced mixtral w2/a8/kv8 with metrics on, served on the card (K1,
    K2, K4) and on the CPU: prompts beyond the window (reclaim fires),
    greedy tokens agree wherever the CPU run's top-1/top-2 margin
    exceeds 0.05, and the card run's MoE telemetry reaches the registry
    (``obs.on_moe`` moves the card's stats to the host)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import QuantConfig
    from repro_torch.serving import engine as E

    class CpuEngine(_RecordingEngine, E.Engine):
        pass

    cfg = get_config("mixtral-8x7b").reduced(n_layers=2, d_head=32)
    q = QuantConfig(w_bits=2, a_bits=8, kv_bits=8)
    params = M.init_params(cfg, seed=1, device="cpu", quant=q)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, (70 + 7 * i,), dtype=np.int32)
               for i in range(2)]
    outs = {}
    before = moe.LAUNCHES
    for dev, cls in (("cpu", CpuEngine), ("cuda", E.Engine)):
        p = params if dev == "cpu" else _to(params, device)
        eng = cls(p, cfg, n_slots=2, max_len=128, quant=q, paged=True,
                  block_size=8, chunk_tokens=8, metrics=True)
        reqs = [E.Request(prompt=pr.copy(), max_new_tokens=8)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        rep = eng.report()
        assert rep["free_blocks"] == rep["n_usable"]
        assert rep["window_reclaimed"] >= 1
        text = eng.obs.registry.render()
        count = [ln for ln in text.splitlines()
                 if ln.startswith("repro_moe_expert_load_count")]
        assert count and float(count[0].split()[-1]) > 0
        outs[dev] = (reqs, eng)
    assert moe.LAUNCHES > before
    (rc, ec), (rg, _) = outs["cpu"], outs["cuda"]
    for a, b in zip(rc, rg):
        kk = next((i for i, (x, y) in enumerate(zip(a.out, b.out))
                   if x != y), None)
        if kk is not None:
            top = np.sort(ec.rows[(id(a), kk)])
            assert top[-1] - top[-2] < 0.05, (kk, a.out, b.out)


def _packed_operand(rng, dev, rows, k, bits, pad_bit, extra_words=0):
    x = _rand(rng, (rows, k), dev) * 2
    t = ops.quantize_rows(x, bits, pad_bit=pad_bit)
    if extra_words:
        import dataclasses
        fill = torch.full((bits, rows, extra_words), -pad_bit,
                          dtype=torch.int32, device=dev)
        t = dataclasses.replace(t, packed=torch.cat([t.packed, fill], -1))
    return t


@pytest.mark.parametrize("m,n,k", [(4, 300, 256), (5, 70, 100),
                                   (67, 130, 300), (130, 64, 45)])
@pytest.mark.parametrize("a_bits,w_bits", [(8, 2), (8, 8), (3, 5), (1, 1)])
def test_apmm_packed_kernel_bit_exact(device, m, n, k, a_bits, w_bits):
    rng = np.random.default_rng(m + n + k + a_bits * 10 + w_bits)
    a = _packed_operand(rng, device, m, k, a_bits, 0)
    b = _packed_operand(rng, device, n, k, w_bits, 1)
    before = apmm.PACKED_LAUNCHES
    got = apmm.apmm_packed(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, apmm.apmm_packed_plain(a, b))
    for od in (torch.float32, torch.bfloat16):
        got = apmm.apmm_packed(a, b, out_dtype=od)
        assert torch.equal(got, apmm.apmm_packed_plain(a, b, out_dtype=od))
    assert apmm.PACKED_LAUNCHES == before + 3
    # the bitserial kernel: bit-exact to its plain version and to the
    # fused kernel, raw and dequantized, on its own counter
    bs_before = apmm.PACKED_BITSERIAL_LAUNCHES
    for od in (None, torch.float32, torch.bfloat16):
        got = apmm.apmm_packed(a, b, variant="bitserial", out_dtype=od)
        torch.cuda.synchronize()
        want = apmm.apmm_packed_plain(a, b, variant="bitserial",
                                      out_dtype=od)
        assert torch.equal(got, want)
        assert torch.equal(got, apmm.apmm_packed(a, b, out_dtype=od))
    assert apmm.PACKED_BITSERIAL_LAUNCHES == bs_before + 3
    assert apmm.PACKED_LAUNCHES == before + 6


def _packed_small_m(m_case):
    t = apmm.packed_small_m_max()
    return {"threshold": t, "threshold+1": t + 1}.get(m_case, m_case)


@pytest.mark.parametrize("m_case", [1, 4, 5, 12, "threshold",
                                    "threshold+1"])
@pytest.mark.parametrize("n,k", [(70, 100), (4096, 4096), (130, 14336)])
@pytest.mark.parametrize("a_bits,w_bits", [(8, 2), (8, 8), (3, 5), (1, 1)])
def test_apmm_packed_kernel_small_m_route_edges(device, m_case, n, k,
                                                a_bits, w_bits):
    """K5 at M <= packed_small_m_max() runs its small-M route (K1's
    weight-streaming GEMM; the counter moves), above it the dp4a tile:
    raw int32 and f32/bf16 dequant bit-exact on both sides of the
    threshold, odd K and a weight packed wider than A included."""
    m = _packed_small_m(m_case)
    assert apmm.packed_small_m_max() >= 8
    rng = np.random.default_rng(m * 7 + n + k + a_bits * 10 + w_bits)
    a = _packed_operand(rng, device, m, k, a_bits, 0)
    b = _packed_operand(rng, device, n, k, w_bits, 1,
                        extra_words=2 if k == 100 else 0)
    a, b = ops._normalize_packed_kw(a, b)
    before = apmm.PACKED_SMALL_M_LAUNCHES
    for od in (None, torch.float32, torch.bfloat16):
        got = apmm.apmm_packed(a, b, out_dtype=od)
        torch.cuda.synchronize()
        assert torch.equal(got, apmm.apmm_packed_plain(a, b, out_dtype=od))
    small = m <= apmm.packed_small_m_max()
    assert apmm.PACKED_SMALL_M_LAUNCHES - before == 3 * small


@pytest.mark.parametrize("m", [1, 4, 5, 12, 33, 67, 130])
@pytest.mark.parametrize("n,k", [(70, 100), (300, 4096), (130, 1000)])
@pytest.mark.parametrize("a_bits,w_bits", [(8, 2), (2, 8), (8, 8), (1, 1),
                                           (3, 5)])
def test_apmm_bitserial_kernel_integer_core_bit_exact(device, m, n, k,
                                                      a_bits, w_bits):
    """K1's bitserial kernel: the integer core (f32 out, act none) equal to
    the plain version's and to the fused kernel's, small M included."""
    rng = np.random.default_rng(m * 7 + n + k + a_bits * 10 + w_bits)
    w = ops.pack_weight(_rand(rng, (n, k), device), w_bits)
    x = _rand(rng, (m, k), device)
    a_s = bipolar.absmax_scale(x, a_bits, axis=-1).float()
    before = (apmm.BITSERIAL_LAUNCHES, apmm.LAUNCHES)
    got = apmm.apmm_fused_linear(x, a_s, w, a_bits=a_bits,
                                 variant="bitserial",
                                 out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = ref.ap_linear_fused_ref(x, a_s, w, a_bits=a_bits,
                                   variant="bitserial",
                                   out_dtype=torch.float32)
    assert torch.equal(got, want)
    assert apmm.BITSERIAL_LAUNCHES == before[0] + 1
    assert apmm.LAUNCHES == before[1]
    fused = apmm.apmm_fused_linear(x, a_s, w, a_bits=a_bits,
                                   out_dtype=torch.float32)
    assert torch.equal(got, fused)


@pytest.mark.parametrize("m", [4, 5, 67])
@pytest.mark.parametrize("n,k", [(70, 100), (4096, 4096), (200, 14336)])
def test_apmm_bitserial_kernel_dual_silu_bias_residual(device, m, n, k):
    """bf16 dual gate/up SiLU, bias, residual and nested weights: equal to
    the fused kernel bit for bit (same integer core, same epilogue code),
    and to the plain version within 1 bf16 ulp (SiLU) or bit for bit."""
    rng = np.random.default_rng(m + n + k)
    wg = ops.pack_weight(_rand(rng, (n, k), device), 2)
    wu = ops.pack_weight(_rand(rng, (n, k), device), 2)
    x = _rand(rng, (m, k), device, torch.bfloat16)
    a_s = bipolar.absmax_scale(x, 8, axis=-1).float()
    kw = dict(w2=wu, a_bits=8, act="silu", out_dtype=torch.bfloat16)
    got = apmm.apmm_fused_linear(x, a_s, wg, variant="bitserial", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, apmm.apmm_fused_linear(x, a_s, wg, **kw))
    want = ref.ap_linear_fused_ref(x, a_s, wg, variant="bitserial", **kw)
    assert int(_bf16_ulps(got, want).max()) <= 1
    w8 = ops.pack_weight(_rand(rng, (n, k), device), 8)
    bias = _rand(rng, (n,), device)
    res = _rand(rng, (m, n), device, torch.bfloat16)
    for bits in (8, 3):
        ws = bipolar.nested_slice(w8, bits)
        kw = dict(bias=bias, residual=res, a_bits=8,
                  out_dtype=torch.bfloat16)
        got = apmm.apmm_fused_linear(x, a_s, ws, variant="bitserial", **kw)
        assert torch.equal(got, ref.ap_linear_fused_ref(
            x, a_s, ws, variant="bitserial", **kw))
        assert torch.equal(got, apmm.apmm_fused_linear(x, a_s, ws, **kw))


_BITSERIAL_PATHS = {
    # name: (arch, first prompt length, QuantConfig extras, engine kwargs)
    "llama-paged": ("llama3-8b", 5, {},
                    dict(paged=True, block_size=8, chunk_tokens=8)),
    "mixtral-paged": ("mixtral-8x7b", 70, {},
                      dict(paged=True, block_size=8, chunk_tokens=8)),
    "llama-contiguous-unfused": ("llama3-8b", 5, dict(fused_linear=False),
                                 dict(paged=False)),
}


@pytest.mark.parametrize("path", list(_BITSERIAL_PATHS))
def test_bitserial_engine_on_card_matches_cpu_and_fused(device, path):
    """A reduced w2/a8/kv8 model served three times: bit-serially on the
    CPU (plain versions), bit-serially on the card and with the fused
    variant on the card.  The card's bit-serial tokens equal its fused
    tokens (the integer cores are exact, the epilogues the same code),
    and the CPU's wherever the CPU run's top-1/top-2 margin exceeds 0.05
    (exp and f32 sum order differ, as for the fused engine).  The
    bit-serial card run launches only the bitserial GEMM kernels, as
    many as the fused run launches fused ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import QuantConfig
    from repro_torch.serving import engine as E

    class CpuEngine(_RecordingEngine, E.Engine):
        pass

    arch, first, qx, eng_kw = _BITSERIAL_PATHS[path]
    cfg = get_config(arch).reduced(n_layers=2, d_head=32, vocab=256)
    qb = QuantConfig(w_bits=2, a_bits=8, kv_bits=8, variant="bitserial",
                     **qx)
    qf = QuantConfig(w_bits=2, a_bits=8, kv_bits=8, **qx)
    params = M.init_params(cfg, seed=1, device="cpu", quant=qb)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, (first + 7 * i,), dtype=np.int32)
               for i in range(3)]

    def counts():
        return np.array([apmm.BITSERIAL_LAUNCHES,
                         apmm.PACKED_BITSERIAL_LAUNCHES,
                         moe.BITSERIAL_LAUNCHES, apmm.LAUNCHES,
                         apmm.PACKED_LAUNCHES, moe.LAUNCHES])

    outs, launched = [], []
    for cls, p, q in ((CpuEngine, params, qb),
                      (E.Engine, _to(params, device), qb),
                      (E.Engine, _to(params, device), qf)):
        before = counts()
        eng = cls(p, cfg, n_slots=2, max_len=128, quant=q, **eng_kw)
        reqs = [E.Request(prompt=pr.copy(), max_new_tokens=8)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        if eng.paged:
            assert eng.report()["free_blocks"] == eng.report()["n_usable"]
        launched.append(counts() - before)
        outs.append((reqs, eng))
    cpu, bits, fused = launched
    assert not cpu.any()
    assert not bits[3:].any() and not fused[:3].any()
    assert np.array_equal(bits[:3], fused[3:])
    k4 = arch == "mixtral-8x7b"
    assert (bits[0] > 0) == qx.get("fused_linear", True)
    assert (bits[1] > 0) != qx.get("fused_linear", True)
    assert (bits[2] > 0) == k4
    (rc, ec), (rb, _), (rf, _) = outs
    for a, b in zip(rb, rf):
        assert len(a.out) == 8 and a.out == b.out
    for a, b in zip(rc, rb):
        kk = next((i for i, (x, y) in enumerate(zip(a.out, b.out))
                   if x != y), None)
        if kk is not None:
            top = np.sort(ec.rows[(id(a), kk)])
            assert top[-1] - top[-2] < 0.05, (kk, a.out, b.out)


def test_ap_matmul_kernel_unequal_word_widths_and_nested(device):
    rng = np.random.default_rng(3)
    a = _packed_operand(rng, device, 9, 67, 8, 0, extra_words=1)
    b = _packed_operand(rng, device, 33, 67, 4, 1, extra_words=3)
    got = ops.ap_matmul(a, b, raw=True)
    want = ref.apmm_packed(*ops._normalize_packed_kw(a.to("cpu"),
                                                     b.to("cpu")))
    assert torch.equal(got.cpu(), want)
    w = ops.pack_weight(_rand(rng, (40, 67), device), 6)
    for bits in (1, 3, 6):
        got = ops.ap_matmul(a, w, b_bits=bits)
        want = ref.apmm_dequant(*ops._normalize_packed_kw(
            a, bipolar.nested_slice(w, bits)))
        assert torch.equal(got, want), bits


@pytest.mark.parametrize("m,n,k", [(4, 256, 4096), (5, 70, 100),
                                   (67, 200, 256)])
def test_unfused_linear_equals_fused_linear_on_card(device, m, n, k):
    """K3 + K5 and K1 on the same inputs: the same bits at act="none"
    and with a residual; the SwiGLU within 1 bf16 ulp (K1's SiLU runs in
    the kernel, the unfused one in torch)."""
    from repro_torch.models import layers as L
    from repro_torch.models.config import QuantConfig
    rng = np.random.default_rng(m * n)
    w, w2 = (ops.pack_weight(_rand(rng, (n, k), device), 2)
             for _ in range(2))
    x = _rand(rng, (m, k), device, torch.bfloat16)
    res = _rand(rng, (m, n), device, torch.bfloat16)
    before = (pack.LAUNCHES, apmm.PACKED_LAUNCHES, apmm.LAUNCHES)
    assert torch.equal(ops.ap_linear(x, w, a_bits=8),
                       ops.ap_linear_fused(x, w, a_bits=8))
    assert torch.equal(ops.ap_linear(x, w, a_bits=8) + res,
                       ops.ap_linear_fused(x, w, a_bits=8, residual=res))
    assert (pack.LAUNCHES, apmm.PACKED_LAUNCHES, apmm.LAUNCHES) == \
        (before[0] + 2, before[1] + 2, before[2] + 2)
    h = {}
    for fused in (True, False):
        q = QuantConfig(w_bits=2, a_bits=8, fused_linear=fused)
        gate = L.linear_apply({"w": w}, x, quant=q)
        h[fused] = (ops.ap_linear_fused(x, w, w2=w2, a_bits=8, act="silu")
                    if fused else
                    (ref.silu_f32(gate.float())
                     * L.linear_apply({"w": w2}, x, quant=q).float()
                     ).to(torch.bfloat16))
    assert int(_bf16_ulps(h[True], h[False]).max()) <= 1


def _ring(rng, dev, b, t, h, n_bits, d, live):
    """A contiguous ring: K/V quantized per (row, slot, head), ``live[i]``
    slots of row i valid (positions 0..live-1), the rest empty."""
    kv = _rand(rng, (2, b, t, h, d), dev)
    kq, ks = ops.quantize_kv(kv[0], n_bits)
    vq, vs = ops.quantize_kv(kv[1], n_bits)
    pos = torch.full((b, t), -1, dtype=torch.int32, device=dev)
    for i, n_live in enumerate(live):
        pos[i, :n_live] = torch.arange(n_live, dtype=torch.int32)
    return kv, kq, ks, vq, vs, pos


def _within_one_ulp_or(got, want, atol=1e-5):
    near = (got.float() - want.float()).abs() <= atol
    if got.dtype == torch.bfloat16:
        return bool(torch.all((_bf16_ulps(got, want) <= 1) | near))
    return bool(torch.all(near | ((got.float() - want.float()).abs()
                                  <= 1e-6 * want.float().abs())))


@pytest.mark.parametrize("b,t,sq,d,window", [(4, 256, 4, 128, None),
                                             (2, 100, 37, 48, 24),
                                             (3, 64, 3, 32, None)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_contiguous_attention_kernels_match_plain(device, b, t, sq, d,
                                                  window, dtype):
    rng = np.random.default_rng(b * t + sq + d)
    h, n_bits = 2, 8
    live = [t, t // 2, 0, 5][:b]          # row 2 (if any): an empty ring
    kv, kq, ks, vq, vs, pos = _ring(rng, device, b, t, h, n_bits, d, live)
    q = _rand(rng, (b, h, sq, d), device, getattr(torch, dtype))
    q_pos = torch.stack([torch.arange(max(n_live - sq, 0),
                                      max(n_live - sq, 0) + sq)
                         for n_live in live]).to(device, torch.int32)
    q_pos[0, 0] = -1                       # a padded query row
    args = (q, kq, ks, vq, vs, q_pos, pos)
    before = flash_attention.QUANTIZED_LAUNCHES
    got = flash_attention.flash_attention_quantized(*args, d=d,
                                                    window=window)
    torch.cuda.synchronize()
    want = ref.kv_cache_attention(*args, d=d, window=window)
    assert _within_one_ulp_or(got, want)
    assert torch.all(got[0, :, 0] == 0)
    if b > 2:
        assert torch.all(got[2] == 0)
    assert flash_attention.QUANTIZED_LAUNCHES == before + 1
    # K7 over the float K/V, folded (BH, T, D)
    kf = ref.fold_kv_heads(kv[0].to(q.dtype))
    vf = ref.fold_kv_heads(kv[1].to(q.dtype))
    qf = q.reshape(b * h, sq, d)
    qpf = q_pos.repeat_interleave(h, 0)
    kpf = pos.repeat_interleave(h, 0)
    got = flash_attention.flash_attention(qf, kf, vf, qpf, kpf,
                                          window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention(qf, kf, vf, qpf, kpf, window=window)
    assert _within_one_ulp_or(got, want)
    assert flash_attention.FLOAT_LAUNCHES >= 1


@pytest.mark.parametrize("bh,sq,t,live,d,window", [
    (32, 4, 1024, 300, 128, None),      # decode: most T ranges see nothing
    (32, 4, 1024, 300, 128, 64),        # decode, sliding window
    (6, 1, 700, 700, 48, None),         # T not a multiple of the tile
    (4, 200, 256, 180, 32, None),       # prefill rows, 20 pads first
    (2, 70, 130, 130, 40, 33)])         # head dim without 16-byte rows
def test_float_attention_kernel_split_kv(device, bh, sq, t, live, d, window):
    """K7's bf16 route on shapes where its C entry splits T (decode) and
    where it does not (prefill): within 1 bf16 ulp or 1e-5 of the plain
    version, fully masked rows exactly 0, including ranges of T that no
    query row may see."""
    rng = np.random.default_rng(bh * sq + t + d)
    q, k, v = (_rand(rng, (bh, n_, d), device, torch.bfloat16)
               for n_ in (sq, t, t))
    kv_pos = torch.full((bh, t), -1, dtype=torch.int32)
    kv_pos[:, :live] = torch.arange(live, dtype=torch.int32)
    q_pos = torch.arange(live - sq, live, dtype=torch.int32).clamp(
        min=-1).repeat(bh, 1)
    q_pos[0, 0] = -1                       # a padded query row
    q_pos[1] = -1                          # a fully masked head
    q_pos, kv_pos = q_pos.to(device), kv_pos.to(device)
    n_split = flash_attention.float_splits(bh, sq, t, torch.bfloat16)
    if sq <= 4:
        assert n_split > 1
    before = flash_attention.FLOAT_LAUNCHES
    got = flash_attention.flash_attention(q, k, v, q_pos, kv_pos,
                                          window=window)
    torch.cuda.synchronize()
    assert flash_attention.FLOAT_LAUNCHES == before + 1
    want = ref.flash_attention(q, k, v, q_pos, kv_pos, window=window)
    assert _within_one_ulp_or(got, want)
    assert torch.all(got[0, 0] == 0) and torch.all(got[1] == 0)
    split = ref.flash_attention_split(q, k, v, q_pos, kv_pos,
                                      splits=n_split, window=window)
    assert _within_one_ulp_or(got, split)


def _ring_kinds(dev, rng, b, t, h, d, n_bits, sq):
    """Ring rows of every kind K6's ranges meet, cycled over ``b`` rows:
    positions 0..t/2 then empty slots; a ring that wrapped (positions
    t+5..2t+4 at slot pos % t); a prompt of 3t/4 tokens whose queries sit
    at the start (its later tiles in the causal future); an empty ring.
    Queries: each row's last ``sq`` positions (at least 0; the prompt's
    first), row 0's first query row a pad (fully masked)."""
    kv = _rand(rng, (2, b, t, h, d), dev)
    kq, ks = ops.quantize_kv(kv[0], n_bits)
    vq, vs = ops.quantize_kv(kv[1], n_bits)
    kv_pos = torch.full((b, t), -1, dtype=torch.int32)
    q_pos = torch.full((b, sq), -1, dtype=torch.int32)
    for row in range(b):
        kind = row % 4
        if kind == 0:
            kv_pos[row, :t // 2 + 1] = torch.arange(t // 2 + 1)
            q_pos[row] = torch.arange(t // 2 + 1 - sq, t // 2 + 1).clamp(
                min=0)
        elif kind == 1:
            pos = torch.arange(t + 5, 2 * t + 5)
            kv_pos[row, pos % t] = pos.to(torch.int32)
            q_pos[row] = torch.arange(2 * t + 5 - sq, 2 * t + 5)
        elif kind == 2:
            kv_pos[row, :3 * t // 4] = torch.arange(3 * t // 4)
            q_pos[row] = torch.arange(sq).clamp(max=3 * t // 4 - 1)
    q_pos[0, 0] = -1
    return kq, ks, vq, vs, q_pos.to(dev), kv_pos.to(dev)


def _k6_split_threshold_sq(h):
    """The smallest Sq (a multiple of 16) whose (q-tile, head) grid of one
    request fills split_kv::FILL_PER_SM = 2 blocks an SM: K6 splits below
    it and not from it."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * -(-2 * n_sm // h)


@pytest.mark.parametrize("b,h,sq,t,d,n_bits,window", [
    (4, 8, 4, 1024, 128, 8, None),       # llama3-8b's decode shape
    (4, 8, 4, 1024, 128, 8, 256),        # its 256-token window
    (3, 2, 3, 232, 40, 3, None),         # short last tile, Dw 2
    (5, 1, 4, 100, 32, 8, 30),           # T < 4 tiles, a window
    (1, 8, "below", 256, 128, 8, None),  # the grid just under the threshold
    (1, 8, "at", 256, 128, 8, None),     # the grid that fills the card
    (4, 32, 1, 1024, 80, 8, None),       # stablelm-3b: d 80 (Dw 3), group 1
    (4, 36, 1, 1024, 64, 8, None),       # minicpm-2b: d 64 (Dw 2), group 1
    (4, 2, 16, 1024, 128, 8, None),      # glm4-9b: 2 kv heads, group 16
    (1, 32, "at", 256, 80, 8, None)])    # a d-80 prefill that fills the card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantized_attention_kernel_split_kv(device, b, h, sq, t, d, n_bits,
                                             window, dtype):
    """K6 on both sides of its split threshold, with ranges no query row
    sees (empty slots, the causal future, out of window) and a fully
    masked row: within 1 bf16 ulp or 1e-5 of the plain version of the
    split its C entry plans (``quantized_splits``), and of the unsplit
    plain version; the fully masked row exactly 0."""
    if sq in ("below", "at"):
        sq = _k6_split_threshold_sq(h) - (16 if sq == "below" else 0)
    rng = np.random.default_rng(b * t + sq + d + n_bits)
    kq, ks, vq, vs, q_pos, kv_pos = _ring_kinds(device, rng, b, t, h, d,
                                                n_bits, sq)
    q = _rand(rng, (b, h, sq, d), device, dtype)
    args = (q, kq, ks, vq, vs, q_pos, kv_pos)
    n_split = flash_attention.quantized_splits(b, h, sq, t)
    blocks = -(-sq // 16) * h * b
    assert (n_split > 1) == (blocks < 2 * torch.cuda.get_device_properties(
        0).multi_processor_count)
    before = flash_attention.QUANTIZED_LAUNCHES
    got = flash_attention.flash_attention_quantized(*args, d=d,
                                                    window=window)
    torch.cuda.synchronize()
    assert flash_attention.QUANTIZED_LAUNCHES == before + 1
    split = ref.kv_cache_attention_split(*args, splits=n_split, d=d,
                                         window=window)
    assert _within_one_ulp_or(got, split)
    assert _within_one_ulp_or(got, ref.kv_cache_attention(
        *args, d=d, window=window))
    assert torch.all(got[0, :, 0] == 0)
    if b > 3:
        assert torch.all(got[3] == 0)          # an empty ring


def test_quantized_attention_kernel_prefill_unsplit(device):
    """The admitting step's bucketed prefill (B = 1, 8 heads, Sq = 4 x
    1024 rows, 600 live slots of T = 1024, pads fully masked): one range,
    within 1 bf16 ulp or 1e-5 of the unsplit plain version."""
    rng = np.random.default_rng(3)
    b, h, t, live, s, d = 1, 8, 1024, 600, 1024, 128
    _, kq, ks, vq, vs, pos = _ring(rng, device, b, t, h, 8, d, [live])
    tok = torch.full((s,), -1, dtype=torch.int32)
    tok[:live] = torch.arange(live, dtype=torch.int32)
    q_pos = tok.repeat(4)[None].to(device)
    q = _rand(rng, (b, h, 4 * s, d), device, torch.bfloat16)
    assert flash_attention.quantized_splits(b, h, 4 * s, t) == 1
    got = flash_attention.flash_attention_quantized(q, kq, ks, vq, vs, q_pos,
                                                    pos, d=d)
    torch.cuda.synchronize()
    want = ref.kv_cache_attention(q, kq, ks, vq, vs, q_pos, pos, d=d)
    assert _within_one_ulp_or(got, want)
    assert torch.all(got[:, :, q_pos[0] < 0] == 0)


def test_contiguous_attention_matches_paged_attention(device):
    """The same K/V written into a contiguous ring and into pool blocks:
    K6 and K2 agree within 1 bf16 ulp or 1e-5."""
    rng = np.random.default_rng(11)
    b, t, h, n_bits, d, bs, g = 2, 64, 2, 8, 128, 16, 4
    _, kq, ks, vq, vs, pos = _ring(rng, device, b, t, h, n_bits, d,
                                   [50, 64])
    nb = t // bs
    k_pool = torch.zeros((1 + b * nb, bs, h, n_bits, d // 32),
                         dtype=torch.int32, device=device)
    v_pool = torch.zeros_like(k_pool)
    k_sc = torch.zeros((1 + b * nb, bs, h, 1), device=device)
    v_sc = torch.zeros_like(k_sc)
    pool_pos = torch.full((1 + b * nb, bs), -1, dtype=torch.int32,
                          device=device)
    tables = (1 + torch.arange(b * nb, dtype=torch.int32,
                               device=device)).reshape(b, nb)
    for src, dst in ((kq, k_pool), (vq, v_pool), (ks, k_sc), (vs, v_sc)):
        dst[1:] = src.reshape((b * nb, bs) + tuple(src.shape[2:]))
    pool_pos[1:] = pos.reshape(b * nb, bs)
    q = _rand(rng, (b, h, g, d), device, torch.bfloat16)
    q_pos = torch.tensor([[49] * g, [63] * g], dtype=torch.int32,
                         device=device)
    k6 = flash_attention.flash_attention_quantized(q, kq, ks, vq, vs, q_pos,
                                                   pos, d=d)
    k2 = flash_attention.flash_attention_paged_quantized(
        q, k_pool, k_sc, v_pool, v_sc, pool_pos, tables, q_pos, d=d)
    torch.cuda.synchronize()
    assert _within_one_ulp_or(k6, k2)


def test_unfused_contiguous_engine_on_card_matches_cpu(device):
    """Reduced llama3-8b at w2/a8/kv8 with the unfused linear, served by
    ``Engine(paged=False)`` on the card (K3, K5, K6) and on the CPU
    (plain versions): greedy tokens agree wherever the CPU run's
    top-1/top-2 margin exceeds 0.05 (the kernels' exp and f32 summation
    order differ from torch's); K1, K2 and K4 never launch."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import QuantConfig
    from repro_torch.serving import engine as E

    class CpuEngine(_RecordingEngine, E.Engine):
        pass

    cfg = get_config("llama3-8b").reduced(n_layers=2, d_head=32, vocab=256)
    q = QuantConfig(w_bits=2, a_bits=8, kv_bits=8, fused_linear=False)
    params = M.init_params(cfg, seed=1, device="cpu", quant=q)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, (5 + 7 * i,), dtype=np.int32)
               for i in range(3)]
    outs = {}
    for dev, cls in (("cpu", CpuEngine), ("cuda", E.Engine)):
        p = params if dev == "cpu" else _to(params, device)
        before = (apmm.LAUNCHES, apmm.PACKED_LAUNCHES, moe.LAUNCHES,
                  flash_attention.LAUNCHES,
                  flash_attention.QUANTIZED_LAUNCHES)
        eng = cls(p, cfg, n_slots=2, max_len=48, quant=q)
        reqs = [E.Request(prompt=pr.copy(), max_new_tokens=8)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        after = (apmm.LAUNCHES, apmm.PACKED_LAUNCHES, moe.LAUNCHES,
                 flash_attention.LAUNCHES,
                 flash_attention.QUANTIZED_LAUNCHES)
        launched = [a - b_ for a, b_ in zip(after, before)]
        if dev == "cuda":
            assert launched[0] == launched[2] == launched[3] == 0
            assert launched[1] > 0 and launched[4] > 0
        else:
            assert launched == [0] * 5
        outs[dev] = (reqs, eng)
    (rc, ec), (rg, _) = outs["cpu"], outs["cuda"]
    for a, b_ in zip(rc, rg):
        assert len(b_.out) == 8
        kk = next((i for i, (x, y) in enumerate(zip(a.out, b_.out))
                   if x != y), None)
        if kk is not None:
            top = np.sort(ec.rows[(id(a), kk)])
            assert top[-1] - top[-2] < 0.05, (kk, a.out, b_.out)


# ---------------------------------------------------------------------------
# The bit-serial core's routes (K1-bs, K4-bs): the stacked route up to the
# library's threshold, the rows route above; the prologue's words and SU
# ---------------------------------------------------------------------------

_BS_PAIRS = [(8, 2), (2, 8), (8, 8), (1, 1), (3, 5)]
_BS_ROWS = [1, 2, 4, 5, 16, 17, 32, 33, 64, 65, 256, "max", "max+1"]


def _rows_case(rows, threshold):
    if rows == "max":
        return threshold
    if rows == "max+1":
        return threshold + 1
    return rows


@pytest.mark.parametrize("m_case", _BS_ROWS)
@pytest.mark.parametrize("n,k", [(77, 1001), (300, 4096)])
@pytest.mark.parametrize("a_bits,w_bits", _BS_PAIRS)
def test_k1_bitserial_route_boundaries(device, m_case, n, k, a_bits,
                                       w_bits):
    """K1-bs on both sides of its stacked route's threshold: the integer
    core (f32 out, act none) of each weight equal to the plain bitserial
    version's and to the fused kernel's; the bf16 dual SiLU with bias and
    residual equal to the fused kernel's bit for bit and within 1 ulp of
    plain."""
    m = _rows_case(m_case, apmm.bitserial_stack_max())
    rng = np.random.default_rng(m * 31 + n + k + a_bits * 10 + w_bits)
    wg = ops.pack_weight(_rand(rng, (n, k), device), w_bits)
    wu = ops.pack_weight(_rand(rng, (n, k), device), w_bits)
    x = _rand(rng, (m, k), device, torch.bfloat16)
    a_s = bipolar.absmax_scale(x, a_bits, axis=-1).float()
    before = apmm.BITSERIAL_LAUNCHES
    for w in (wg, wu):
        got = apmm.apmm_fused_linear(x, a_s, w, a_bits=a_bits,
                                     variant="bitserial",
                                     out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.ap_linear_fused_ref(
            x, a_s, w, a_bits=a_bits, variant="bitserial",
            out_dtype=torch.float32))
        assert torch.equal(got, apmm.apmm_fused_linear(
            x, a_s, w, a_bits=a_bits, out_dtype=torch.float32))
    bias = _rand(rng, (n,), device)
    res = _rand(rng, (m, n), device, torch.bfloat16)
    kw = dict(w2=wu, bias=bias, residual=res, a_bits=a_bits, act="silu",
              out_dtype=torch.bfloat16)
    got = apmm.apmm_fused_linear(x, a_s, wg, variant="bitserial", **kw)
    assert torch.equal(got, apmm.apmm_fused_linear(x, a_s, wg, **kw))
    want = ref.ap_linear_fused_ref(x, a_s, wg, variant="bitserial", **kw)
    assert int(_bf16_ulps(got, want).max()) <= 1
    assert apmm.BITSERIAL_LAUNCHES == before + 3


@pytest.mark.parametrize("seg_case", _BS_ROWS)
@pytest.mark.parametrize("a_bits,w_bits", _BS_PAIRS)
def test_k4_bitserial_route_boundaries(device, seg_case, a_bits, w_bits):
    """K4-bs on both sides of its stacked route's threshold, at odd N and
    K, with an empty expert (count 0), a full one and two dispatch
    groups: the integer core of each weight, the live map and the dead
    rows' zeros equal to the plain bitserial version's and the fused
    kernel's; the bf16 dual SiLU equal to the fused kernel's bit for bit
    and within 1 ulp of plain."""
    seg = _rows_case(seg_case, moe.bitserial_stack_max())
    e, g, n, k = 4, 2, 77, 1001
    rng = np.random.default_rng(seg * 13 + a_bits * 10 + w_bits)
    w = _expert_weight(rng, device, e, n, k, w_bits)
    w2 = _expert_weight(rng, device, e, n, k, w_bits)
    counts = torch.from_numpy(rng.integers(0, seg + 1, (e, g))
                              .astype(np.int32))
    counts[1] = 0                                     # an empty expert
    counts[2] = seg                                   # a full one
    counts = counts.to(device)
    x = _rand(rng, (e, g * seg, k), device, torch.bfloat16)
    bc = ops.moe_row_tile(seg)
    a_s = bipolar.absmax_scale(x.float(), a_bits, axis=-1)
    rows = torch.arange(g * seg, device=device)
    dead = (rows % seg)[None, :] >= counts[:, rows // seg]
    before = moe.BITSERIAL_LAUNCHES
    for wt in (w, w2):
        got, live = moe.moe_expert_linear(x, a_s, counts, wt, a_bits=a_bits,
                                          variant="bitserial",
                                          out_dtype=torch.float32, bc=bc)
        torch.cuda.synchronize()
        want, live_ref = moe.moe_expert_linear_plain(
            x, a_s, counts, wt, a_bits=a_bits, variant="bitserial",
            out_dtype=torch.float32, bc=bc)
        fused, live_f = moe.moe_expert_linear(x, a_s, counts, wt,
                                              a_bits=a_bits,
                                              out_dtype=torch.float32, bc=bc)
        assert torch.equal(got, want) and torch.equal(got, fused)
        assert torch.equal(live, live_ref) and torch.equal(live, live_f)
        assert not got[dead].any()
    got, _ = moe.moe_expert_linear(x, a_s, counts, w, w2=w2, a_bits=a_bits,
                                   act="silu", variant="bitserial",
                                   out_dtype=torch.bfloat16, bc=bc)
    fused, _ = moe.moe_expert_linear(x, a_s, counts, w, w2=w2,
                                     a_bits=a_bits, act="silu",
                                     out_dtype=torch.bfloat16, bc=bc)
    want = ref.ap_moe_expert_linear_ref(x, a_s, counts, w, w2=w2,
                                        a_bits=a_bits, act="silu",
                                        variant="bitserial",
                                        out_dtype=torch.bfloat16)
    assert torch.equal(got, fused)
    assert int(_bf16_ulps(got, want).max()) <= 1
    assert moe.BITSERIAL_LAUNCHES == before + 3


_FUSED_PAIRS = [(8, 2), (2, 8), (7, 7), (8, 8), (1, 1), (3, 5)]


@pytest.mark.parametrize("seg_case", [1, 2, "max", "max+1", 70, 130])
@pytest.mark.parametrize("n,k", [(77, 1001), (130, 200)])
@pytest.mark.parametrize("a_bits,w_bits", _FUSED_PAIRS)
def test_k4_fused_route_boundaries(device, seg_case, n, k, a_bits, w_bits):
    """Fused K4 on both sides of its route threshold
    (``moe.fused_route_max()``: the decode route's tallest segment and the
    chunk route's first), at odd N and K (K = 200: 4-byte copies, Kw not
    a multiple of 4), with an empty expert, a full one and two dispatch
    groups (the chunk route's work list runs across segments and, at 70
    and 130 rows, across tiles): the integer core of each weight, the
    live map and the dead rows' zeros equal to the plain version's, the
    bf16 output at act none equal, the dual SiLU within 1 ulp."""
    seg = _rows_case(seg_case, moe.fused_route_max())
    e, g = 4, 2
    rng = np.random.default_rng(seg * 13 + a_bits * 10 + w_bits + k)
    w = _expert_weight(rng, device, e, n, k, w_bits)
    w2 = _expert_weight(rng, device, e, n, k, w_bits)
    counts = torch.from_numpy(rng.integers(0, seg + 1, (e, g))
                              .astype(np.int32))
    counts[1] = 0                                     # an empty expert
    counts[2] = seg                                   # a full one
    counts = counts.to(device)
    x = _rand(rng, (e, g * seg, k), device, torch.bfloat16)
    bc = ops.moe_row_tile(seg)
    a_s = bipolar.absmax_scale(x.float(), a_bits, axis=-1)
    rows = torch.arange(g * seg, device=device)
    dead = (rows % seg)[None, :] >= counts[:, rows // seg]
    before = moe.LAUNCHES
    for wt in (w, w2):
        got, live = moe.moe_expert_linear(x, a_s, counts, wt, a_bits=a_bits,
                                          out_dtype=torch.float32, bc=bc)
        torch.cuda.synchronize()
        want, live_ref = moe.moe_expert_linear_plain(
            x, a_s, counts, wt, a_bits=a_bits, out_dtype=torch.float32,
            bc=bc)
        assert torch.equal(got, want)
        assert torch.equal(live, live_ref)
        assert not got[dead].any()
    got, _ = moe.moe_expert_linear(x, a_s, counts, w, a_bits=a_bits,
                                   out_dtype=torch.bfloat16, bc=bc)
    want = ref.ap_moe_expert_linear_ref(x, a_s, counts, w, a_bits=a_bits,
                                        out_dtype=torch.bfloat16)
    assert torch.equal(got, want)
    got, _ = moe.moe_expert_linear(x, a_s, counts, w, w2=w2, a_bits=a_bits,
                                   act="silu", out_dtype=torch.bfloat16,
                                   bc=bc)
    want = ref.ap_moe_expert_linear_ref(x, a_s, counts, w, w2=w2,
                                        a_bits=a_bits, act="silu",
                                        out_dtype=torch.bfloat16)
    assert int(_bf16_ulps(got, want).max()) <= 1
    assert not got[dead].any()
    assert moe.LAUNCHES == before + 4


def _su_of(x, a_s, a_bits):
    """Each row's sum of its unsigned bipolar fields U = (q + maxA) / 2."""
    q = bipolar.quantize_values(x.float(), a_bits, a_s)
    return ((q + bipolar.max_value(a_bits)) // 2).sum(-1).to(torch.int32)


@pytest.mark.parametrize("m,k", [(1, 32), (4, 4096), (5, 1001), (70, 14336)])
@pytest.mark.parametrize("a_bits", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bitserial_prologue_words_equal_pack(device, m, k, a_bits, dtype):
    """K1-bs's prologue: its packed planes equal K3's words (``ref``'s
    pack, pad bit 0) of the same X and scales, and its SU each row's sum
    of the unsigned bipolar fields."""
    rng = np.random.default_rng(m + k + a_bits)
    x = _rand(rng, (m, k), device, dtype)
    a_s = bipolar.absmax_scale(x.float(), a_bits, axis=-1).float()
    kw = bipolar.packed_words(k)
    before = apmm.BITSERIAL_LAUNCHES
    planes, su = apmm.bitserial_pack_x(x, a_s, a_bits=a_bits, kw=kw)
    torch.cuda.synchronize()
    assert torch.equal(planes, ref.quantize_pack_rows(x, a_s, n_bits=a_bits,
                                                      pad_bit=0))
    assert torch.equal(su, _su_of(x, a_s, a_bits))
    assert apmm.BITSERIAL_LAUNCHES == before


@pytest.mark.parametrize("seg,k", [(2, 4096), (5, 1001), (40, 14336)])
@pytest.mark.parametrize("a_bits", [2, 8])
def test_moe_bitserial_prologue_words_equal_pack(device, seg, k, a_bits):
    """K4-bs's prologue: the live rows' planes equal K3's words of the same
    rows and scales, their SU the sum of U; dead rows' SU is 0."""
    e, g = 4, 2
    rng = np.random.default_rng(seg + k + a_bits)
    x = _rand(rng, (e, g * seg, k), device, torch.bfloat16)
    a_s = bipolar.absmax_scale(x.float(), a_bits, axis=-1)
    counts = torch.from_numpy(rng.integers(0, seg + 1, (e, g))
                              .astype(np.int32))
    counts[0] = 0
    counts[3] = seg
    counts = counts.to(device)
    kw = bipolar.packed_words(k)
    planes, su = moe.bitserial_pack_x(x, a_s, counts, a_bits=a_bits, kw=kw)
    torch.cuda.synchronize()
    rows = torch.arange(g * seg, device=device)
    live = ((rows % seg)[None, :] < counts[:, rows // seg]).reshape(-1)
    xf, sf = x.reshape(e * g * seg, k), a_s.reshape(e * g * seg, 1)
    want = ref.quantize_pack_rows(xf, sf, n_bits=a_bits, pad_bit=0)
    assert torch.equal(planes[:, live], want[:, live])
    assert torch.equal(su[live], _su_of(xf, sf, a_bits)[live])
    assert not su[~live].any()


# ---------------------------------------------------------------------------
# the shapes of glm4-9b, stablelm-3b, minicpm-2b and deepseek-moe-16b
# ---------------------------------------------------------------------------

# K2 at head dims and GQA groups llama's do not have: (lanes, s_q, NB,
# window, options) as _PAGED_CASES
_HEAD_CASES = {
    "stablelm decode d80 group 1": ((600,) * 4, 1, 64, None,
                                    dict(h=32, group=1, d=80)),
    "stablelm chunk d80": ((600,), 256, 64, None, dict(h=32, group=1, d=80)),
    "minicpm decode d64 group 1": ((600,) * 4, 1, 64, None,
                                   dict(h=36, group=1, d=64)),
    "glm4 decode group 16": ((600,) * 4, 1, 64, None,
                             dict(h=2, group=16, d=128)),
    "glm4 chunk group 16": ((600, None), 32, 64, None,
                            dict(h=2, group=16, d=128)),
    "d80 window pads": ((37, None, 300, 15), 2, 32, 40,
                        dict(h=4, group=2, d=80, n_bits=3)),
    # qwen2-vl-7b's 4 kv heads with a group of 7 (odd, not a power of
    # two) at decode and at a 600-token whole-prompt prefill (Gq 4200),
    # and seamless-m4t-medium's decoder, 16 kv heads of group 1 at d 64
    "qwen2-vl decode group 7": ((640, 140, None, 240), 1, 64, None,
                                dict(h=4, group=7, d=128)),
    "qwen2-vl prefill group 7": ((600,), 600, 64, None,
                                 dict(h=4, group=7, d=128)),
    "seamless decode d64 group 1": ((640, 140, 340, 240), 1, 64, None,
                                    dict(h=16, group=1, d=64)),
}


@pytest.mark.parametrize("case", list(_HEAD_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_head_dims_and_groups(device, case, dtype):
    """K2 at head dim 80 (three packed words: the 4-byte staging path)
    and 64 (two), and at GQA groups 1 and 16: within 1 bf16 ulp or 1e-5
    of the plain version of the split its C entry plans, pad lanes
    exactly 0."""
    lanes, s_q, nb, window, kw = _HEAD_CASES[case]
    args = _paged_case(device, len(case), lanes, s_q, nb, window,
                       dtype=dtype, **kw)
    b, h, gq, d = args[0].shape
    assert args[1].shape[-1] == -(-d // 32)
    n_split = flash_attention.paged_splits(b, h, gq, nb)
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_attention_paged_quantized(
        *args, d=d, window=window)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    want = ref.paged_attention_split(*args, splits=n_split, d=d,
                                     window=window)
    assert _within_one_ulp_or(got, want)
    assert _within_one_ulp_or(got, ref.paged_attention(*args, d=d,
                                                       window=window))
    pads = [i for i, ln in enumerate(lanes) if ln is None]
    assert torch.all(got[pads] == 0)


@pytest.mark.parametrize("seg", [1, 30])
@pytest.mark.parametrize("linear", ["gate/up", "down"])
def test_moe_kernel_deepseek_experts(device, seg, linear):
    """Fused K4 and K4-bs at deepseek-moe-16b's experts (E = 64, gate/up
    N 1408 x K 2048, down N 2048 x K 1408, w3 a8) at the segment heights
    its decode (1 row: the decode route, the stacked route) and chunk
    steps (30 rows: the chunk route, the stacked route's top) give them,
    counts from a top-6 routing with the last expert empty: the integer
    cores, the live map and dead rows equal to the plain versions' (the
    bitserial kernel's also to the fused kernel's), the bf16 output at
    act none equal, the dual SiLU within 1 ulp."""
    e, (n, k) = 64, ((1408, 2048) if linear == "gate/up" else (2048, 1408))
    dual = linear == "gate/up"
    g_ = torch.Generator(device=device).manual_seed(seg)
    logits = torch.randn((8 if seg == 1 else 256, e), generator=g_,
                         device=device)
    logits[:, e - 1] = -1e9
    top = logits.topk(6, dim=-1).indices.reshape(-1)
    oh = torch.nn.functional.one_hot(top, e).to(torch.int32)
    pos = torch.gather(torch.cumsum(oh, 0) - oh, 1, top[:, None])[:, 0]
    counts = (oh * (pos < seg)[:, None].to(torch.int32)).sum(0)
    counts = counts[:, None].contiguous().to(torch.int32)      # (E, 1)
    rng = np.random.default_rng(seg + n)
    w = _expert_weight(rng, device, e, n, k, 3)
    w2 = _expert_weight(rng, device, e, n, k, 3) if dual else None
    x = _rand(rng, (e, seg, k), device, torch.bfloat16)
    bc = ops.moe_row_tile(seg)
    a_s = bipolar.absmax_scale(x.float(), 8, axis=-1)
    dead = torch.arange(seg, device=device)[None, :] >= counts
    assert counts[e - 1] == 0 and counts.sum() > 0
    before = (moe.LAUNCHES, moe.BITSERIAL_LAUNCHES)
    for wt in (w, w2) if dual else (w,):
        fused, live = moe.moe_expert_linear(x, a_s, counts, wt, a_bits=8,
                                            out_dtype=torch.float32, bc=bc)
        torch.cuda.synchronize()
        want, live_ref = moe.moe_expert_linear_plain(
            x, a_s, counts, wt, a_bits=8, out_dtype=torch.float32, bc=bc)
        assert torch.equal(fused, want) and torch.equal(live, live_ref)
        assert not fused[dead].any()
        got, live_b = moe.moe_expert_linear(x, a_s, counts, wt, a_bits=8,
                                            variant="bitserial",
                                            out_dtype=torch.float32, bc=bc)
        torch.cuda.synchronize()
        assert torch.equal(got, fused) and torch.equal(live_b, live)
    act = "silu" if dual else "none"
    got, _ = moe.moe_expert_linear(x, a_s, counts, w, w2=w2, a_bits=8,
                                   act=act, out_dtype=torch.bfloat16, bc=bc)
    got_bs, _ = moe.moe_expert_linear(x, a_s, counts, w, w2=w2, a_bits=8,
                                      act=act, variant="bitserial",
                                      out_dtype=torch.bfloat16, bc=bc)
    want = ref.ap_moe_expert_linear_ref(x, a_s, counts, w, w2=w2, a_bits=8,
                                        act=act, out_dtype=torch.bfloat16)
    assert torch.equal(got_bs, got)
    assert int(_bf16_ulps(got, want).max()) <= (1 if dual else 0)
    assert not got[dead].any()
    n_w = 2 if dual else 1
    assert moe.LAUNCHES == before[0] + n_w + 1
    assert moe.BITSERIAL_LAUNCHES == before[1] + n_w + 1


@pytest.mark.parametrize("m", [1, 4, 64, 65, 256])
def test_apmm_kernel_non_vector_k(device, m):
    """K1 and K1-bs at deepseek-moe-16b's dense down projection (N 2048,
    K 10944 = 342 words, not a multiple of 4: the weight loads without
    16-byte vectors), w3 a8, on both sides of the small-M threshold: the
    integer core bit-exact (the bitserial kernel's also equal to the
    fused kernel's), the residual output bit-exact."""
    n, k = 2048, 10944
    rng = np.random.default_rng(m)
    w = ops.pack_weight(_rand(rng, (n, k), device), 3)
    assert w.packed.shape[-1] == 342
    x = _rand(rng, (m, k), device, torch.bfloat16)
    res = _rand(rng, (m, n), device, torch.bfloat16)
    a_s = bipolar.absmax_scale(x, 8, axis=-1).float()
    before = apmm.SMALL_M_LAUNCHES
    got = apmm.apmm_fused_linear(x, a_s, w, a_bits=8,
                                 out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert apmm.SMALL_M_LAUNCHES - before == int(m <= apmm.small_m_max())
    want = ref.ap_linear_fused_ref(x, a_s, w, a_bits=8,
                                   out_dtype=torch.float32)
    assert torch.equal(got, want)
    got_bs = apmm.apmm_fused_linear(x, a_s, w, a_bits=8, variant="bitserial",
                                    out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got_bs, want)
    kw = dict(residual=res, a_bits=8, out_dtype=torch.bfloat16)
    got = apmm.apmm_fused_linear(x, a_s, w, **kw)
    assert torch.equal(got, ref.ap_linear_fused_ref(x, a_s, w, **kw))
    assert torch.equal(apmm.apmm_fused_linear(x, a_s, w, variant="bitserial",
                                              **kw), got)


_DENSE_ARCHS = {
    "glm4-9b": dict(d_head=32),          # group 4 reduced, rotary 0.5
    "stablelm-3b": dict(d_head=80),      # its own head dim: Dw 3, layernorm
    "minicpm-2b": dict(d_head=64),       # Dw 2, tied and scaled logits
}


@pytest.mark.parametrize("arch", list(_DENSE_ARCHS))
def test_dense_config_engine_on_card_matches_cpu(device, arch):
    """Reduced glm4-9b, stablelm-3b and minicpm-2b at their own weight
    bits and a kv8 pool, served on the card (K1, K2) and on the CPU:
    greedy tokens agree wherever the CPU run's top-1/top-2 margin
    exceeds 0.05, as the other card engine tests hold them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E

    class CpuEngine(_RecordingEngine, E.Engine):
        pass

    cfg = get_config(arch).reduced(n_layers=2, vocab=256,
                                   **_DENSE_ARCHS[arch])
    q = dataclasses.replace(cfg.quant, kv_bits=8)
    params = M.init_params(cfg, seed=3, device="cpu", quant=q)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, (5 + 7 * i,), dtype=np.int32)
               for i in range(3)]
    outs = {}
    before = (apmm.LAUNCHES, flash_attention.LAUNCHES)
    for dev, cls in (("cpu", CpuEngine), ("cuda", E.Engine)):
        p = params if dev == "cpu" else _to(params, device)
        eng = cls(p, cfg, n_slots=2, max_len=48, quant=q, paged=True,
                  block_size=8, chunk_tokens=8)
        reqs = [E.Request(prompt=pr.copy(), max_new_tokens=8)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.finish_reason == "length" for r in reqs)
        assert eng.report()["free_blocks"] == eng.report()["n_usable"]
        outs[dev] = (reqs, eng)
    assert apmm.LAUNCHES > before[0] and flash_attention.LAUNCHES > before[1]
    (rc, ec), (rg, _) = outs["cpu"], outs["cuda"]
    for a, b in zip(rc, rg):
        kk = next((i for i, (x, y) in enumerate(zip(a.out, b.out))
                   if x != y), None)
        if kk is not None:
            top = np.sort(ec.rows[(id(a), kk)])
            assert top[-1] - top[-2] < 0.05, (kk, a.out, b.out)


_STATEFUL_ARCHS = {
    "mamba2-130m": dict(n_layers=2),                  # its own w4/a8
    "jamba-1.5-large-398b": dict(n_layers=2, attn_every=2),   # w2, kv8
}


@pytest.mark.parametrize("arch", list(_STATEFUL_ARCHS))
def test_stateful_engine_on_card_matches_cpu(device, arch):
    """Reduced mamba2-130m (two mamba layers: K1 only) and hybrid jamba
    (a mamba + MoE layer and an attention + dense layer: K1, K2, K4) at
    their own weight bits, served paged with chunked prefill on the card
    and on the CPU: the SSM state rides the slot pool on both, and the
    greedy tokens agree wherever the CPU run's top-1/top-2 margin exceeds
    0.05, as the other card engine tests hold them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E

    class CpuEngine(_RecordingEngine, E.Engine):
        pass

    cfg = get_config(arch).reduced(vocab=256, **_STATEFUL_ARCHS[arch])
    q = dataclasses.replace(cfg.quant, kv_bits=8)
    params = M.init_params(cfg, seed=3, device="cpu", quant=q)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, (5 + 7 * i,), dtype=np.int32)
               for i in range(3)]
    outs = {}
    before = (apmm.LAUNCHES, flash_attention.LAUNCHES, moe.LAUNCHES)
    for dev, cls in (("cpu", CpuEngine), ("cuda", E.Engine)):
        p = params if dev == "cpu" else _to(params, device)
        eng = cls(p, cfg, n_slots=2, max_len=48, quant=q, paged=True,
                  block_size=8, chunk_tokens=8)
        reqs = [E.Request(prompt=pr.copy(), max_new_tokens=8)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.finish_reason == "length" for r in reqs)
        rep = eng.report()
        assert rep["free_blocks"] == rep["n_usable"]
        assert rep["used_state_slots"] == 0
        eng.pool.validate(check_contents=True)
        outs[dev] = (reqs, eng)
    assert apmm.LAUNCHES > before[0]
    if arch.startswith("jamba"):
        assert flash_attention.LAUNCHES > before[1] \
            and moe.LAUNCHES > before[2]
    state = outs["cuda"][1].pool.caches["layers"][0]["state"]
    assert state.device.type == "cuda"
    (rc, ec), (rg, _) = outs["cpu"], outs["cuda"]
    for a, b in zip(rc, rg):
        kk = next((i for i, (x, y) in enumerate(zip(a.out, b.out))
                   if x != y), None)
        if kk is not None:
            top = np.sort(ec.rows[(id(a), kk)])
            assert top[-1] - top[-2] < 0.05, (kk, a.out, b.out)


# ---------------------------------------------------------------------------
# the shapes of seamless-m4t-medium and qwen2-vl-7b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lives,sq,t", [
    ((128, 64, 64, 64, None), 1, 128),  # decode: slot rows, a pad lane
    ((128,), 1024, 128),                # the 600-token prompt's prefill
    ((64,), 128, 64)])                  # the 100-token prompt's prefill
def test_quantized_attention_kernel_not_causal_cross_reads(device, lives, sq,
                                                           t):
    """K6 with ``causal=False`` at seamless-m4t-medium's cross-attention
    reads (16 heads, d 64, kv8, every query at position 0): each lane's
    rows past its encoder length at position -1, a pad lane on the null
    row (all -1) exactly 0; within 1 bf16 ulp or 1e-5 of the plain
    version of the split its C entry plans and of the unsplit one."""
    rng = np.random.default_rng(sq + t)
    h, d, n_bits = 16, 64, 8
    b = len(lives)
    kv = _rand(rng, (2, b, t, h, d), device)
    kq, ks = ops.quantize_kv(kv[0], n_bits)
    vq, vs = ops.quantize_kv(kv[1], n_bits)
    kv_pos = torch.full((b, t), -1, dtype=torch.int32, device=device)
    for row, live in enumerate(lives):
        if live:
            kv_pos[row, :live] = torch.arange(live, dtype=torch.int32)
    q_pos = torch.zeros((b, sq), dtype=torch.int32, device=device)
    q = _rand(rng, (b, h, sq, d), device, torch.bfloat16)
    args = (q, kq, ks, vq, vs, q_pos, kv_pos)
    n_split = flash_attention.quantized_splits(b, h, sq, t)
    before = flash_attention.QUANTIZED_LAUNCHES
    got = flash_attention.flash_attention_quantized(*args, d=d, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.QUANTIZED_LAUNCHES == before + 1
    assert _within_one_ulp_or(got, ref.kv_cache_attention_split(
        *args, splits=n_split, d=d, causal=False))
    assert _within_one_ulp_or(got, ref.kv_cache_attention(
        *args, d=d, causal=False))
    pads = [i for i, live in enumerate(lives) if live is None]
    assert torch.all(got[pads] == 0)
    assert got.abs().sum() > 0


@pytest.mark.parametrize("m", [4, 64, 128])
def test_apmm_kernels_gelu_up_projection(device, m):
    """K1 and K1-bs at seamless-m4t-medium's GELU up projection (N 4096,
    K 1024, w4) at decode (M 4) and at its encoder's frames on both sides
    of the small-M threshold (64 and 128 rows): the integer core
    bit-exact, the GELU output within 1 bf16 ulp of the plain version
    (tanh differs between the kernel and torch, rounded once to bf16)
    or 1e-5 absolute (where 1 + tanh nears 0 the output is within ~1e-6
    of 0), the bitserial output equal to the fused kernel's."""
    rng = np.random.default_rng(m)
    n, k = 4096, 1024
    w = ops.pack_weight(_rand(rng, (n, k), device), 4)
    x = _rand(rng, (m, k), device, torch.bfloat16)
    a_s = bipolar.absmax_scale(x, 8, axis=-1).float()
    small = apmm.SMALL_M_LAUNCHES
    core = apmm.apmm_fused_linear(x, a_s, w, a_bits=8,
                                  out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (apmm.SMALL_M_LAUNCHES - small == 1) == (m <= apmm.small_m_max())
    assert torch.equal(core, ref.ap_linear_fused_ref(
        x, a_s, w, a_bits=8, out_dtype=torch.float32))
    kw = dict(act="gelu", a_bits=8, out_dtype=torch.bfloat16)
    got = apmm.apmm_fused_linear(x, a_s, w, **kw)
    want = ref.ap_linear_fused_ref(x, a_s, w, **kw)
    assert _within_one_ulp_or(got, want)
    got_bs = apmm.apmm_fused_linear(x, a_s, w, variant="bitserial", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_bs, got)


_ENCDEC_VLM_ARCHS = {
    "seamless-m4t-medium": dict(n_layers=2),   # 2 + 2 layers, its own w4
    "qwen2-vl-7b": dict(n_layers=2),           # M-RoPE, group 4, w2
}


@pytest.mark.parametrize("arch", list(_ENCDEC_VLM_ARCHS))
def test_encdec_and_vlm_engines_on_card_match_cpu(device, arch):
    """Reduced seamless-m4t-medium (the encoder on the stub frontend's
    frames, the cross-K/V in state slots: K1, K2, K6 not causal) and
    qwen2-vl-7b (M-RoPE positions: K1, K2) at their own weight bits and a
    kv8 pool, served paged on the card and on the CPU (the engine drops
    ``chunk_tokens`` for both): greedy tokens agree wherever the CPU
    run's top-1/top-2 margin exceeds 0.05, as the other card engine
    tests hold them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E

    class CpuEngine(_RecordingEngine, E.Engine):
        pass

    cfg = get_config(arch).reduced(**_ENCDEC_VLM_ARCHS[arch])
    q = dataclasses.replace(cfg.quant, kv_bits=8)
    params = M.init_params(cfg, seed=3, device="cpu", quant=q)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, (5 + 7 * i,), dtype=np.int32)
               for i in range(3)]
    outs = {}
    before = (apmm.LAUNCHES, flash_attention.LAUNCHES,
              flash_attention.QUANTIZED_LAUNCHES)
    for dev, cls in (("cpu", CpuEngine), ("cuda", E.Engine)):
        p = params if dev == "cpu" else _to(params, device)
        eng = cls(p, cfg, n_slots=2, max_len=48, quant=q, paged=True,
                  block_size=8, chunk_tokens=8)
        assert eng.chunk_tokens is None
        reqs = [E.Request(prompt=pr.copy(), max_new_tokens=8)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.finish_reason == "length" for r in reqs)
        rep = eng.report()
        assert rep["free_blocks"] == rep["n_usable"]
        assert rep.get("used_state_slots", 0) == 0
        eng.pool.validate(check_contents=True)
        outs[dev] = (reqs, eng)
    assert apmm.LAUNCHES > before[0] and flash_attention.LAUNCHES > before[1]
    if arch.startswith("seamless"):
        assert flash_attention.QUANTIZED_LAUNCHES > before[2]
        assert outs["cuda"][1].pool.caches["cross"][0]["k"].is_cuda
    (rc, ec), (rg, _) = outs["cpu"], outs["cuda"]
    for a, b in zip(rc, rg):
        kk = next((i for i, (x, y) in enumerate(zip(a.out, b.out))
                   if x != y), None)
        if kk is not None:
            top = np.sort(ec.rows[(id(a), kk)])
            assert top[-1] - top[-2] < 0.05, (kk, a.out, b.out)


# --- training on the card ------------------------------------------------------

def _trainer(tmp_path, dev, **tkw):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataSpec
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = get_config("llama3-8b").reduced(n_layers=2)
    spec = DataSpec(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=1)
    tcfg = TrainConfig(ckpt_dir=str(tmp_path), ckpt_every=0, warmup_steps=2,
                       peak_lr=1e-3, **tkw)
    return Trainer(cfg, tcfg, spec, async_ckpt=False, device=dev)


def test_training_step_on_card_matches_cpu(device, tmp_path, monkeypatch):
    """One gradient step of reduced llama3-8b on the card and on the CPU
    from the same parameters and batch: the loss within 4e-5 of its
    value, the gradient norm within 2e-4, each leaf's gradient within
    2e-2 in relative L2 norm (about 3x the gaps measured on the H100:
    1.1e-5, 6.4e-5 and 7.5e-3); and no kernel of K1-K7 launches.  The
    same step with the loss's logsumexp in bf16 (1.3e-4 off in the loss)
    misses a bar."""
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.optim.optimizer import global_norm
    card, cpu = _trainer(tmp_path, device), _trainer(tmp_path, "cpu")
    params = card.init_state()["params"]
    lc, gc = cpu.loss_and_grads(tree_map(lambda p: p.cpu(), params),
                                cpu.batch_at(0))
    lc, nc = float(lc), float(global_norm(gc))

    def misses():
        lg, gg = card.loss_and_grads(params, card.batch_at(0))
        out = [abs(float(lg) - lc) > 4e-5 * abs(lc),
               abs(float(global_norm(gg)) - nc) > 2e-4 * nc]
        for a, b in zip(leaves(gg), leaves(gc)):
            assert a.is_cuda and a.dtype == b.dtype
            a, b = a.float().cpu(), b.float()
            out.append(bool((a - b).norm() > 2e-2 * b.norm()))
        return out

    before = (apmm.LAUNCHES, flash_attention.FLOAT_LAUNCHES)
    assert not any(misses())
    assert (apmm.LAUNCHES, flash_attention.FLOAT_LAUNCHES) == before
    lse = torch.logsumexp
    monkeypatch.setattr(torch, "logsumexp", lambda x, *a, **kw: lse(
        x.bfloat16(), *a, **kw).float())
    assert any(misses())


def test_training_restart_on_card_is_bit_exact(device, tmp_path):
    """8 steps straight against 4 + a checkpoint + a fresh trainer + 4,
    int8 moments, on the card: the losses and the final state bit for
    bit."""
    from repro_torch.core.tree import leaves
    from repro_torch.optim.optimizer import AdamWConfig
    kw = dict(adamw=AdamWConfig(state_bits=8))
    full, hist_full = _trainer(tmp_path / "a", device, num_steps=8,
                               **kw).run(resume=False)
    _trainer(tmp_path / "b", device, num_steps=4, **kw).run(resume=False)
    res, hist_res = _trainer(tmp_path / "b", device, num_steps=8,
                             **kw).run(resume=True)
    assert hist_full[4:] == hist_res

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    for a, b in zip(leaves(full), leaves(res)):
        assert a.is_cuda and a.dtype == b.dtype
        assert torch.equal(bits(a), bits(b))


# --- the distributed layer at world size 1 over NCCL ------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL process group (an in-process store) and its
    ``(data, model)`` mesh of shape (1, 1) on the card, for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0),
                            timeout=datetime.timedelta(seconds=120))
    yield make_mesh((1, 1), ("data", "model"))
    dist.destroy_process_group()


def _same_bits(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


def test_distributed_sharded_step_equals_plain_step(nccl_mesh, tmp_path):
    """``sharded_step`` on the (1, 1) mesh: the loss and every gradient
    leaf equal to ``Trainer.loss_and_grads``'s bit for bit (reduced
    llama3-8b); no kernel of K1-K7 launches."""
    import functools
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import sharding as S
    from repro_torch.models import model as M
    tr = _trainer(tmp_path, "cuda")
    params, batch = tr.init_state()["params"], tr.batch_at(0)
    loss0, grads0 = tr.loss_and_grads(params, batch)
    before = (apmm.LAUNCHES, flash_attention.FLOAT_LAUNCHES)
    ps = S.shard_tree(params, nccl_mesh,
                      S.shardings_for_params(nccl_mesh, params))
    bs = S.shard_tree(batch, nccl_mesh,
                      S.shardings_for_batch(nccl_mesh, batch))
    loss1, grads1 = S.sharded_step(functools.partial(
        M.loss_terms, cfg=tr.cfg), nccl_mesh)(ps, bs)
    assert (apmm.LAUNCHES, flash_attention.FLOAT_LAUNCHES) == before
    assert _same_bits(loss1.reshape(()), loss0.reshape(()))
    for a, b in zip(leaves(grads1), leaves(grads0)):
        assert _same_bits(a.to_local(), b)


def test_distributed_compressed_psum_equals_cpu(nccl_mesh):
    """Over one rank ``compressed_psum`` is quantize then dequantize: its
    result and the int8 codes equal the CPU's on the same gradients."""
    from repro_torch.distributed import compress as C
    rng = np.random.default_rng(3)
    tree = {"a": _rand(rng, (300, 70), "cuda", torch.bfloat16),
            "b": _rand(rng, (129,), "cuda") * 1e-4}
    got = C.compressed_psum(tree, nccl_mesh.get_group("data"))
    for k, g in tree.items():
        gc = g.cpu()
        q, _ = C.int8_codes(g, torch.max(torch.abs(g.float())))
        qc, sc = C.int8_codes(gc, torch.max(torch.abs(gc.float())))
        assert torch.equal(q.cpu(), qc)
        assert _same_bits(got[k].cpu(), (qc.float() * sc / 1.0).to(g.dtype))


def test_distributed_restore_onto_the_card_mesh(nccl_mesh, tmp_path):
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import manager as CM
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import sharding as S
    params = _trainer(tmp_path, "cuda").init_state()["params"]
    CM.save_tree(params, str(tmp_path / "ck"), 1)
    shd = S.named(nccl_mesh, S.shardings_for_params(nccl_mesh, params),
                  params)
    back, _ = CM.restore_tree(params, str(tmp_path / "ck"), shardings=shd)
    for a, b in zip(leaves(params), leaves(back)):
        assert isinstance(b, DTensor) and b.device_mesh is nccl_mesh
        assert b.to_local().is_cuda and _same_bits(b.to_local(), a)


def test_distributed_pipeline_one_stage(nccl_mesh):
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    rng = np.random.default_rng(4)
    ws = _rand(rng, (1, 64, 64), "cuda") / 8
    x = _rand(rng, (8, 2, 64), "cuda")
    run = pipeline_apply(lambda w, h: torch.tanh(h @ w), 1, 8, axis="pipe")
    out = run(make_mesh((1,), ("pipe",)), ws, x)
    assert float((out - torch.tanh(x @ ws[0])).abs().max()) <= 1e-5
