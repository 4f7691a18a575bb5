"""Card-only tests of the port's CUDA kernels against their plain torch
versions, on the card.  Run on a machine with an NVIDIA card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips (decided inside the ``device`` fixture).
Tolerances: K3 words and the K1 integer core (``act="none"``, f32 out)
are bit-exact; K1 SiLU outputs within 1 bf16 ulp per element (exp
differs between the kernel and torch, rounded once to bf16), gelu
within 1.6e-2 relative (tanh); K2 within 1 bf16 ulp per element, or
1e-5 absolute near zero (f32 sum order and exp).  K4: the integer core
of each weight and the bf16 ``act="none"`` output bit-exact, the dual
SiLU output within 1 bf16 ulp, dead rows exactly 0, the live map equal
to the analytic one.
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
    (8, 1, 2, 256, 300),          # decode: 8-row tiles
    (4, 2, 5, 37, 19),            # odd K and N, two groups
    (3, 1, 70, 200, 130),         # 64-row tiles, one 72-row live tile
    (2, 1, 300, 96, 64),          # two 256-row live tiles
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
    with pytest.raises(NotImplementedError, match="bitserial"):
        ops.ap_moe_expert_linear(x, w, counts=counts, a_bits=a_bits,
                                 variant="bitserial")
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
