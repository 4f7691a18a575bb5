"""The port's dry run (``repro_torch.launch.dryrun``) against the reference.

* Per-rank bytes: for every arch at ``train_4k`` and ``decode_32k`` on the
  pod256 mesh, the dry run's ``param_bytes``, ``opt_bytes`` (int8
  moments), ``batch_bytes`` and ``cache_bytes`` -- its own state functions
  over a 256-rank fake process group, in a subprocess -- equal the sums
  of the reference's ``NamedSharding.shard_shape`` bytes under its rules
  (``jax.eval_shape`` trees on 256 host devices, nothing lowered, in
  three subprocesses).  Each reference leaf's bytes are also held to the
  port's matching leaves (one a layer where the reference stacks).
* FLOPs: the dry run's ``flops`` of a reduced llama3-8b train cell on a
  one-rank mesh equal, exactly (tolerance 0), the reference's
  ``benchmarks/hlo_analysis.analyze(...)["dot_flops"]`` of the same cell
  jitted on one device (XLA:CPU computes the bf16 dots in f32, so only
  the total is compared); both count the recompute of the checkpointed
  layers.
* The meta route follows the real one: a reduced serve cell's prefill
  and decode steps on meta and on the CPU make the same K1-K6 calls with
  the same input and output shapes, and the meta route's work tally
  equals the count functions of ``kernels.meta`` applied to the CPU's
  calls; a meta tensor never reaches a kernel or moves a launch counter,
  a CPU tensor never reaches the meta route.
* The CLI, in subprocesses: a dense and a MoE decode cell, llama3-8b's
  prefill cell and its train cell at full size on pod256 (the sharded
  serve step: at most an eighth of the weights' bytes gathered at once;
  llama3-8b's decode within 6 GiB at its peak, 0.25 GiB gathered and
  an eighth of the FLOPs the step took before it split over "model",
  its prefill within 12 GiB; the sharded training step's
  tensor-parallel compute: at most 1 GiB of weights gathered at once,
  at most 3.5e14 FLOPs a rank, a peak under 80 GB), one ``long_500k``
  cell skipped with the reference's reason, the resume rule, an
  ``attn_chunks`` cell named as the reference names it, and an unknown
  lever refused.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.bipolar import BipolarTensor
from repro_torch.kernels import apmm, flash_attention, meta, moe, pack
from repro_torch.launch.specs import _token_specs
from repro_torch.models import model as M
from repro_torch.models.config import QuantConfig
from repro_torch.serving import engine as E

from test_torch_sharding_rules import _ref_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2 ** 30
SRC = os.path.join(ROOT, "src")


def _env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([SRC, ROOT]), **extra)


# ---------------------------------------------------------------------------
# per-rank bytes against the reference's shard shapes
# ---------------------------------------------------------------------------

_REFERENCE_BYTES = textwrap.dedent(r"""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    from functools import partial
    import jax, numpy as np
    from repro.configs import get_config
    from repro.distributed import sharding as S
    from repro.launch.specs import input_specs
    from repro.models import model as M
    from repro.optim.optimizer import AdamWConfig, adamw_init
    mesh = jax.make_mesh((16, 16), ("data", "model"))

    def keyof(p):
        for attr in ("key", "name", "idx"):
            v = getattr(p, attr, None)
            if v is not None:
                return v
        return None

    def records(tree, shard):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        out = []
        for (path, leaf), s in zip(flat, jax.tree.leaves(shard)):
            local = s.shard_shape(leaf.shape)
            out.append([[keyof(p) for p in path],
                        int(np.prod(local)) * leaf.dtype.itemsize])
        return out

    out = {}
    for arch in sys.argv[2].split(","):
        cfg = get_config(arch)
        # the dry run's cells pin the KV format (kv8 is a lever)
        cfg = dataclasses.replace(cfg, kv_bits=None, quant=dataclasses
                                  .replace(cfg.quant, kv_bits=None))
        params = jax.eval_shape(partial(M.init_params, cfg),
                                jax.random.PRNGKey(0))
        opt = jax.eval_shape(partial(adamw_init,
                                     cfg=AdamWConfig(state_bits=8)), params)
        rec = {"params": records(params, S.shardings_for_params(mesh,
                                                                params))}
        for f in ("m", "v", "m_scale", "v_scale"):
            t = getattr(opt, f)
            rec["opt." + f] = records(t, S.shardings_for_params(mesh, t))
        rec["opt.step"] = [[[], 4]]
        b = input_specs(cfg, "train_4k")
        rec["batch:train_4k"] = records(b, S.shardings_for_batch(mesh, b))
        qp = jax.eval_shape(partial(M.quantize_params, qcfg=cfg.quant),
                            params)
        rec["qparams"] = records(qp, S.shardings_for_params(mesh, qp))
        c = jax.eval_shape(lambda: M.init_caches(cfg, 128, 32768,
                                                 quant=cfg.quant))
        rec["caches"] = records(c, S.shardings_for_caches(mesh, c))
        b = input_specs(cfg, "decode_32k")
        rec["batch:decode_32k"] = records(b, S.shardings_for_batch(mesh, b))
        out[arch] = rec
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")

_PORT_BYTES = textwrap.dedent(r"""
    import json, sys
    from repro_torch.core.bipolar import BipolarTensor
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.launch import dryrun as D

    def records(tree):
        out = []
        for path, leaf in leaves_with_paths(tree):
            parts = [((), leaf)]
            if isinstance(leaf, BipolarTensor):
                parts = [((k,), getattr(leaf, k)) for k in
                         ("packed", "scale", "width_scales")
                         if getattr(leaf, k) is not None]
            for sub, t in parts:
                out.append([list(path) + list(sub), D.local_bytes([t])])
        return out

    mesh = D.production_mesh(False)
    out = {}
    for arch in sys.argv[2].split(","):
        cfg = D.cell_config(arch)
        st = D.train_state(cfg, mesh, 256, 4096)
        ss = D.serve_state(cfg, mesh, 128, 32768, "decode")
        rec = {"params": records(st["params"]),
               "batch:train_4k": records(st["batch"]),
               "qparams": records(ss["params"]),
               "caches": records(ss["caches"]),
               "batch:decode_32k": records(ss["batch"])}
        for f in ("m", "v", "m_scale", "v_scale"):
            rec["opt." + f] = records(getattr(st["opt"], f))
        rec["opt.step"] = [[[], D.local_bytes([st["opt"].step])]]
        rec["totals"] = {
            "train_4k": dict(param_bytes=D.local_bytes(st["params"]),
                             opt_bytes=D.local_bytes(st["opt"]),
                             batch_bytes=D.local_bytes(st["batch"])),
            "decode_32k": dict(param_bytes=D.local_bytes(ss["params"]),
                               cache_bytes=D.local_bytes(ss["caches"]),
                               batch_bytes=D.local_bytes(ss["batch"]))}
        out[arch] = rec
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")

# the reference's abstract quantize takes most of its time (jamba's ~11 s)
_SPLIT = (("jamba-1.5-large-398b", "mamba2-130m", "minicpm-2b"),
          ("deepseek-moe-16b", "seamless-m4t-medium", "stablelm-3b"),
          ("mixtral-8x7b", "glm4-9b", "llama3-8b", "qwen2-vl-7b"))

@pytest.fixture(scope="module")
def shard_bytes(tmp_path_factory):
    assert sorted(a for part in _SPLIT for a in part) == sorted(ARCHS)
    out = tmp_path_factory.mktemp("bytes")
    runs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_BYTES, str(out / f"ref{i}.json"),
         ",".join(part)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for i, part in enumerate(_SPLIT)]
    runs.append(subprocess.Popen(
        [sys.executable, "-c", _PORT_BYTES, str(out / "port.json"),
         ",".join(ARCHS)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    ref = {}
    for i, r in enumerate(runs):
        log, _ = r.communicate(timeout=600)
        assert r.returncode == 0, log[-3000:]
        if i < len(_SPLIT):
            with open(out / f"ref{i}.json") as f:
                ref.update(json.load(f))
    with open(out / "port.json") as f:
        port = json.load(f)
    return ref, port


def _by_reference_leaf(cfg, kind, port_recs):
    """The port's leaf bytes summed onto the reference's leaf paths."""
    base = kind.split(":")[0].split(".")[0]
    rule = "params" if base in ("params", "qparams", "opt") else base
    out: dict = {}
    for path, n in port_recs:
        if kind == "opt.step" or base == "batch":
            rpath = path
        else:
            rpath, _ = _ref_path(cfg, path, rule)
        key = tuple(rpath)
        out[key] = out.get(key, 0) + n
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_bytes_equal_the_references_shard_shapes(shard_bytes,
                                                          arch):
    """Leaf by leaf and in total.  One class of leaves has another spec
    by design (``test_torch_sharding_rules``): in EP mode the reference
    reads a dense FFN's stack axis as experts and shards it over "model"
    where the port shards the layer's d_ff; the bytes on a rank are the
    same, so no leaf's bytes differ."""
    ref, port = shard_bytes
    cfg = get_config(arch)
    sums = {}
    for kind, recs in ref[arch].items():
        want = {tuple(p): n for p, n in recs}
        got = _by_reference_leaf(cfg, kind, port[arch][kind])
        assert set(got) == set(want), (kind, set(got) ^ set(want))
        diffs = {"/".join(map(str, k)): got[k] - want[k] for k in want
                 if got[k] != want[k]}
        assert not diffs, (kind, diffs)
        sums[kind] = sum(want.values())
    opt = sum(v for k, v in sums.items() if k.startswith("opt."))
    assert port[arch]["totals"] == {
        "train_4k": dict(param_bytes=sums["params"], opt_bytes=opt,
                         batch_bytes=sums["batch:train_4k"]),
        "decode_32k": dict(param_bytes=sums["qparams"],
                           cache_bytes=sums["caches"],
                           batch_bytes=sums["batch:decode_32k"])}


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO dot FLOPs
# ---------------------------------------------------------------------------

_REFERENCE_FLOPS = textwrap.dedent(r"""
    import json
    from functools import partial
    import jax
    from benchmarks import hlo_analysis as H
    from repro.configs import get_config
    from repro.launch.specs import make_batch
    from repro.models import model as M
    from repro.optim.optimizer import (AdamWConfig, adamw_init,
                                       adamw_update, wsd_schedule)
    cfg = get_config("llama3-8b").reduced(n_layers=2, d_head=32, vocab=512)
    adamw = AdamWConfig(state_bits=8)
    sched = wsd_schedule(peak_lr=3e-4, warmup_steps=2000, total_steps=100000)
    params = jax.eval_shape(partial(M.init_params, cfg),
                            jax.random.PRNGKey(0))
    opt = jax.eval_shape(partial(adamw_init, cfg=adamw), params)
    batch = jax.eval_shape(lambda: make_batch(cfg, 2, 64, "train"))

    def train_step(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: M.loss_fn(p, batch, cfg))(params)
        params, opt, _ = adamw_update(grads, opt, params, lr=sched(opt.step),
                                      cfg=adamw)
        return params, opt, loss

    c = jax.jit(train_step).lower(params, opt, batch).compile()
    print("flops " + json.dumps(H.analyze(c.as_text())["dot_flops"]))
""")

_PORT_FLOPS = textwrap.dedent(r"""
    import json
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    cfg = get_config("llama3-8b").reduced(n_layers=2, d_head=32, vocab=512)
    print("flops " + json.dumps(D.measure(cfg, mesh, "train", 2, 64)
                                ["flops"]))
""")


def test_train_cell_flops_equal_the_references_dot_flops():
    runs = [subprocess.Popen([sys.executable, "-c", code], env=_env(),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, cwd=ROOT)
            for code in (_REFERENCE_FLOPS, _PORT_FLOPS)]
    got = []
    for r in runs:
        log, _ = r.communicate(timeout=300)
        assert r.returncode == 0, log[-3000:]
        got.append(json.loads([ln for ln in log.splitlines()
                               if ln.startswith("flops ")][-1][6:]))
    ref, port = got
    assert port["total"] == ref, (port, ref)
    # the products are bf16 but for the attention core's and the loss's
    assert port["bfloat16"] > port["float32"] > 0


# ---------------------------------------------------------------------------
# the meta route follows the real one
# ---------------------------------------------------------------------------

_WRAPPERS = [(apmm, "apmm_fused_linear"), (apmm, "apmm_packed"),
             (pack, "quantize_pack_rows"), (moe, "moe_expert_linear"),
             (flash_attention, "flash_attention_paged_quantized"),
             (flash_attention, "flash_attention_quantized"),
             (flash_attention, "flash_attention")]


def _meta_like(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, BipolarTensor):
        return dataclasses.replace(
            x, packed=_meta_like(x.packed), scale=_meta_like(x.scale),
            width_scales=_meta_like(x.width_scales))
    return x


def _shapes(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, BipolarTensor):
        return ("bipolar", _shapes(x.packed), _shapes(x.scale),
                _shapes(x.width_scales))
    if isinstance(x, (tuple, list)):
        return tuple(_shapes(v) for v in x)
    return x


@pytest.fixture
def kernel_calls(monkeypatch):
    """Every call of a kernel wrapper: ``(name, argument shapes, keyword
    arguments, output shapes)``; the CPU's calls are also replayed on
    meta twins of their arguments inside ``tally`` (the work the meta
    route counts for them)."""
    calls, tally = [], meta.Tally()

    def spy(mod, name):
        real = getattr(mod, name)

        def call(*args, **kw):
            out = real(*args, **kw)
            first = args[0].packed if isinstance(args[0], BipolarTensor) \
                else args[0]
            if first.device.type == "cpu":
                prev, meta._TALLY = meta._TALLY, tally
                try:
                    getattr(meta, name)(*map(_meta_like, args), **kw)
                finally:
                    meta._TALLY = prev
            calls.append((name, _shapes(args),
                          sorted((k, _shapes(v)) for k, v in kw.items()),
                          _shapes(out)))
            return out
        monkeypatch.setattr(mod, name, call)

    for mod, name in _WRAPPERS:
        spy(mod, name)
    return calls, tally


_CELLS = {
    "llama3-8b kv8": ("llama3-8b", QuantConfig(w_bits=2, a_bits=8,
                                               kv_bits=8)),
    "llama3-8b kv8 unfused": ("llama3-8b", QuantConfig(
        w_bits=2, a_bits=8, kv_bits=8, fused_linear=False)),
    "llama3-8b bitserial": ("llama3-8b", QuantConfig(
        w_bits=3, a_bits=8, variant="bitserial")),
    "mixtral-8x7b kv8": ("mixtral-8x7b", QuantConfig(w_bits=2, a_bits=8,
                                                     kv_bits=8)),
    "seamless-m4t-medium kv8": ("seamless-m4t-medium", QuantConfig(
        w_bits=4, a_bits=8, kv_bits=8)),
}


def _serve_cell(cfg, q, device):
    """A reduced cell's quantized parameters, caches (4 rows of 32 slots),
    a prefill of 16 tokens and one decode step, on ``device``: the
    kernel tally of each part."""
    out = {}
    with meta.tally() as t:
        params = M.init_params(cfg, seed=0, device=device, quant=q)
    out["load"] = t.by_kernel()
    caches = M.init_caches(cfg, 4, 32, quant=q, device=device)
    for mode, s in (("prefill", 16), ("decode", 32)):
        b = _token_specs(cfg, 4, s, mode, device="meta")
        if device != "meta":
            b = {k: (torch.zeros(v.shape, dtype=v.dtype) if k != "tokens"
                     else torch.randint(0, cfg.vocab, v.shape,
                                        dtype=v.dtype,
                                        generator=torch.Generator()
                                        .manual_seed(1)))
                 for k, v in b.items()}
        fn = E.prefill_step if mode == "prefill" else E.serve_step
        with meta.tally() as t, torch.no_grad():
            logits, caches = fn(params, b, caches, cfg, q)
        assert logits.device.type == device
        assert tuple(logits.shape) == (4, cfg.vocab_padded)
        out[mode] = t.by_kernel()
    return out


@pytest.mark.parametrize("cell", list(_CELLS))
def test_meta_serve_cell_makes_the_cpus_kernel_calls(kernel_calls, cell):
    arch, q = _CELLS[cell]
    cfg = get_config(arch).reduced(n_layers=2, d_head=32, vocab=512)
    calls, tally = kernel_calls
    before = _launches()
    got_meta = _serve_cell(cfg, q, "meta")
    meta_calls = list(calls)
    calls.clear()
    _serve_cell(cfg, q, "cpu")
    assert _launches() == before
    assert [c[0] for c in meta_calls] == [c[0] for c in calls]
    assert meta_calls == calls
    want = tally.by_kernel()
    got = {}
    for part in got_meta.values():
        for k, v in part.items():
            e = got.setdefault(k, dict(calls=0, ops=0, bytes=0,
                                       op_type=v["op_type"]))
            for f in ("calls", "ops", "bytes"):
                e[f] += v[f]
    assert got == want
    names = {c[0] for c in calls}
    assert "quantize_pack_rows" in names
    assert "apmm_fused_linear" in names or "apmm_packed" in names
    if cfg.n_experts:
        assert "moe_expert_linear" in names
    if q.kv_bits:
        assert "flash_attention_quantized" in names


def _launches():
    return (apmm.LAUNCHES, apmm.PACKED_LAUNCHES, apmm.BITSERIAL_LAUNCHES,
            apmm.PACKED_BITSERIAL_LAUNCHES, pack.LAUNCHES, moe.LAUNCHES,
            moe.BITSERIAL_LAUNCHES, flash_attention.LAUNCHES,
            flash_attention.QUANTIZED_LAUNCHES,
            flash_attention.FLOAT_LAUNCHES)


def test_meta_route_only_from_meta_tensors(monkeypatch):
    """Each wrapper on meta tensors returns its kernel's shapes and dtypes
    and moves no counter; on CPU tensors it never reaches the meta route
    (each meta function raises if called)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 80)).astype(np.float32))
    w = ops.pack_weight(torch.from_numpy(
        rng.standard_normal((40, 80)).astype(np.float32)), 3)
    before = _launches()
    xm, wm = _meta_like(x), _meta_like(w)
    y = ops.ap_linear_fused(xm.bfloat16(), wm, a_bits=8, act="silu", w2=wm)
    assert (y.device.type, tuple(y.shape), y.dtype) == \
        ("meta", (6, 40), torch.bfloat16)
    t = ops.quantize_rows(xm, 4, pad_bit=0, scale_search=True)
    assert tuple(t.packed.shape) == (4, 6, 3) and t.packed.is_meta
    assert tuple(t.width_scales.shape) == (4, 6, 1)
    z = ops.ap_matmul(t, wm, raw=True)
    assert (tuple(z.shape), z.dtype, z.is_meta) == ((6, 40), torch.int32,
                                                    True)
    xe = torch.empty((4, 8, 80), device="meta")
    we = dataclasses.replace(
        wm, packed=torch.empty((3, 4, 40, 3), dtype=torch.int32,
                               device="meta"),
        scale=torch.empty((4, 40, 1), device="meta"), shape=(4, 40, 80))
    ye, live = ops.ap_moe_expert_linear(
        xe, we, counts=torch.empty((4, 2), dtype=torch.int32, device="meta"),
        a_bits=8, with_stats=True)
    assert tuple(ye.shape) == (4, 8, 40) and tuple(live.shape) == (8, 1)
    assert _launches() == before

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the meta route")

    for _, name in _WRAPPERS:
        monkeypatch.setattr(meta, name, refuse)
    y = ops.ap_linear_fused(x, w, a_bits=8)
    assert y.device.type == "cpu" and _launches() == before


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args, out):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "single", "--out", str(out)] + list(args), env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _done(proc):
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


# the serve cells before their step split over "model" (pod256, the
# parent of the sharded serve step): every weight gathered whole at the
# step's start, in GiB, and llama3-8b decode_32k's FLOPs a rank
_WHOLE_GIB = {"llama3-8b": 2.7436, "mixtral-8x7b": 11.19}
_PARENT_DECODE_FLOPS = 1.374e11


def test_cli_cells_at_full_size(tmp_path):
    runs = {(a, s): _cli("--arch", a, "--shape", s, out=tmp_path)
            for a, s in (("llama3-8b", "decode_32k"),
                         ("mixtral-8x7b", "decode_32k"),
                         ("llama3-8b", "prefill_32k"),
                         ("llama3-8b", "long_500k"),
                         ("llama3-8b", "train_4k"))}
    for (a, s), proc in runs.items():
        rc, out, err = _done(proc)
        assert rc == 0, out[-2000:] + err[-2000:]
        assert f"[{a}__{s}__pod256]" in out
        assert "failures=0" in out
    for arch in ("llama3-8b", "mixtral-8x7b"):
        with open(tmp_path / f"{arch}__decode_32k__pod256.json") as f:
            rec = json.load(f)
        cfg = get_config(arch)
        assert rec["status"] == "ok", rec.get("traceback")
        assert (rec["mode"], rec["seq"], rec["batch"], rec["n_chips"]) == \
            ("decode", 32768, 128, 256)
        assert rec["params"] == cfg.param_count()
        assert (rec["w_bits"], rec["a_bits"]) == (2, 8)
        m = rec["memory"]
        assert m["argument_bytes"] == sum(
            m[k] for k in ("param_bytes", "opt_bytes", "batch_bytes",
                           "cache_bytes"))
        assert m["opt_bytes"] == 0 and m["cache_bytes"] > 0
        assert m["peak_bytes"] > m["argument_bytes"]
        # the serve step gathers one block's weights at a time, its
        # "model" shard kept
        assert 0 < m["gathered_bytes"] <= _WHOLE_GIB[arch] * GIB / 8, m
        assert isinstance(rec["fallbacks"], list)
        assert rec["int_ops"]["K1"] > 0 and rec["kernels"]["K1"]["calls"]
        assert rec["flops"]["total"] > 0
        assert rec["collectives"]["all_gather_into_tensor"]["count"] > 0
        assert "hlo" not in rec
        if arch == "mixtral-8x7b":
            assert rec["int_ops"]["K4"] > 0
            assert rec["moe_rows"] == "capacity"
            assert "experts whole on dispatch-row shards" in rec[
                "fallbacks"]
        else:
            # sequence-parallel decode: the caches stay on their shard
            assert m["peak_bytes"] <= 6 * GIB, m
            assert m["gathered_bytes"] <= GIB / 4, m
            assert 0 < rec["flops"]["total"] <= _PARENT_DECODE_FLOPS / 8
    with open(tmp_path / "llama3-8b__prefill_32k__pod256.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["peak_bytes"] <= 12 * GIB, rec["memory"]
    with open(tmp_path / "llama3-8b__train_4k__pod256.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok", rec.get("traceback")
    m = rec["memory"]
    assert 0 < m["gathered_bytes"] <= 2 ** 30, m
    assert m["peak_bytes"] < 80e9, m
    assert 0 < rec["flops"]["total"] <= 3.5e14, rec["flops"]
    with open(tmp_path / "llama3-8b__long_500k__pod256.json") as f:
        rec = json.load(f)
    assert rec["status"] == "skipped"
    assert rec["reason"].startswith("full quadratic attention; 500k-token "
                                    "decode requires SSM/hybrid/sliding-"
                                    "window")
    # a cell already ok is not run again
    stamp = os.path.getmtime(tmp_path / "llama3-8b__long_500k__pod256.json")
    rc, out, _ = _done(_cli("--arch", "llama3-8b", "--shape", "long_500k",
                            out=tmp_path))
    assert rc == 0 and "[llama3-8b" not in out
    assert os.path.getmtime(
        tmp_path / "llama3-8b__long_500k__pod256.json") == stamp


def test_cli_refuses_attn_chunks(tmp_path, capsys):
    """An unknown lever is refused (exit 2, no file); ``attn_chunks`` is
    a lever: its cell runs, its id carries the opt as the reference's
    does, and its record says what the pin does."""
    from repro_torch.launch import dryrun
    proc = _cli("--arch", "llama3-8b", "--shape", "decode_32k", "--opt",
                "attn_chunks", out=tmp_path)
    rc = dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                      "--mesh", "single", "--out", str(tmp_path / "no"),
                      "--opt", "attn_chunk"])
    assert rc == 2
    assert "unknown --opt ['attn_chunk']" in capsys.readouterr().err
    assert not (tmp_path / "no").exists()
    rc, out, err = _done(proc)
    assert rc == 0, out[-2000:] + err[-2000:]
    cid = "llama3-8b__decode_32k__pod256__opt-attn_chunks"
    assert f"[{cid}] ok" in out
    with open(tmp_path / f"{cid}.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["opts"] == ["attn_chunks"]
    assert rec["attn_chunks"].startswith("pins nothing")
