"""The sharded serve step (``distributed.sharding.sharded_serve_step``) on
the CPU: 8 gloo ranks, spawned once for the module, against the
single-process port and the reference.

The ranks run this file as a script (``_rank_main``, torch and the port
only, one intra-op thread each), meet through a ``FileStore`` in the
module's temporary directory and write their results there; each rank
also runs some of the cases in one process (no group), and the
reference's engine steps run meanwhile in one subprocess (excess
precision off).

Each case (``CASES``: reduced llama3-8b fused w2/a8/kv8 and bit-serial
with bf16 caches, deepseek-moe-16b with 8 experts (EP), mixtral-8x7b
with 3 experts (whole on the rank's dispatch rows), jamba (the SSM
mixer whole) and llama with 6 q heads (whole heads on 4 and 8 ranks))
runs a 16-token prefill of 8 rows and 8 greedy decode steps on each
``MESHES`` shape, against the same steps in one process:

* on (8, 1) logits and caches bit for bit;
* on (4, 2), (2, 4) and (1, 8) every cache leaf bit for bit (every row
  written: the prefill's and the decode steps'), logits within 1e-5 of
  the largest |logit| (the decode's combine of the ranks' attention
  partials sums in another f32 order), the 9 greedy tokens equal.

Witnesses: a (4, 2) rank's linear FLOPs a token (the plain kernels'
integer GEMMs) are about half an (8, 1) rank's; the most gathered
weight bytes at once are within one block's share of a rank; a row
product whose absmax is taken per rank misses bit-exactness where the
global one meets it.  The K-shard row product equals the fused linear
bit for bit without a group (split locally), and K6's plain version's
lse recombines a two-way split.  Anchor: the (4, 2) greedy tokens of
reduced llama3-8b w2/a8/kv8 equal the reference's single-device engine
steps on the same (bridged) parameters.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

WORLD = 8
B, S, STEPS, MAX_LEN = 8, 16, 8, 64
MESHES = ((8, 1), (4, 2), (2, 4), (1, 8))
LOGIT_TOL = 1e-5          # of the largest |logit|
# the reduced width every case shares: heads and d_ff whose packed words
# divide the model axis, so that the row products split
RED = dict(n_layers=2, d_head=32, n_heads=8, n_kv_heads=4, d_ff=256,
           vocab=256)
# name -> (arch, reduce() overrides, QuantConfig arguments)
CASES = {
    "llama3-8b": ("llama3-8b", {}, dict(w_bits=2, a_bits=8, kv_bits=8)),
    "llama3-8b bitserial": ("llama3-8b", {},
                            dict(w_bits=2, a_bits=8, variant="bitserial")),
    "deepseek-moe-16b": ("deepseek-moe-16b", {"n_experts": 8},
                         dict(w_bits=3, a_bits=8, kv_bits=8)),
    "mixtral-8x7b": ("mixtral-8x7b", {"n_experts": 3},
                     dict(w_bits=2, a_bits=8, kv_bits=8)),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {"attn_every": 2},
                             dict(w_bits=2, a_bits=8, kv_bits=8)),
    "llama3-8b whole heads": ("llama3-8b", {"n_heads": 6, "n_kv_heads": 2},
                              dict(w_bits=4, a_bits=8, kv_bits=8)),
}


def _case(name):
    from repro_torch.configs import get_config
    from repro_torch.models.config import QuantConfig
    arch, over, qargs = CASES[name]
    return (get_config(arch).reduced(**dict(RED, **over)),
            QuantConfig(**qargs))


def _prompts():
    return np.random.default_rng(7).integers(0, RED["vocab"], (B, S),
                                             dtype=np.int32)


def _batch(tokens, pos0):
    t = torch.as_tensor(tokens)
    s = t.shape[1]
    return {"tokens": t, "positions": (torch.arange(
        pos0, pos0 + s, dtype=torch.int32)[None].expand(t.shape[0], s)
        .contiguous())}


def _greedy(logits, cfg):
    return logits[:, :cfg.vocab].float().argmax(-1).to(torch.int32)


# --- one process -------------------------------------------------------------

def _single(name, params=None):
    """Prefill and STEPS greedy decode steps in one process: each step's
    logits, the tokens, the caches at the end."""
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    cfg, q = _case(name)
    if params is None:
        params = M.init_params(cfg, seed=0, device="cpu", quant=q)
    caches = M.init_caches(cfg, B, MAX_LEN, quant=q, device="cpu")
    logits_all, toks = [], []
    with torch.no_grad():
        logits, caches = E.prefill_step(params, _batch(_prompts(), 0),
                                        caches, cfg, q)
        for i in range(STEPS + 1):
            logits_all.append(logits.float().numpy())
            tok = _greedy(logits, cfg)
            toks.append(tok.numpy())
            if i == STEPS:
                break
            logits, caches = E.serve_step(
                params, _batch(tok[:, None].numpy(), S + i), caches, cfg, q)
    return {"logits": logits_all, "tokens": np.stack(toks, 1),
            "caches": _cache_leaves(caches)}


def _cache_leaves(caches):
    from repro_torch.core.tree import leaves_with_paths
    out = {}
    for path, t in leaves_with_paths(caches):
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t.full_tensor()
        out[path] = (t.view(torch.int16) if t.dtype == torch.bfloat16
                     else t).numpy().copy()
    return out


# --- one rank ----------------------------------------------------------------

_MESHES: dict = {}


def _mesh(shape):
    """The (data, model) mesh of ``shape``, made once a process."""
    if shape not in _MESHES:
        from repro_torch.launch import mesh as LM
        _MESHES[shape] = LM.make_mesh(shape, ("data", "model"), "cpu")
    return _MESHES[shape]


def _full_logits(logits, mesh, vocab):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = [Shard(0), Shard(1) if logits.shape[-1] < vocab else Replicate()]
    return DTensor.from_local(logits, mesh, pl, run_check=False).full_tensor()


def _sharded(name, shape, S_, M, out, params=None, flops=False):
    """The case on a ``shape`` (data, model) mesh: each step's full
    logits, the tokens, the full caches at the end, the step's gathered
    bytes and fallbacks (and the decode step's integer-GEMM FLOPs a
    local token)."""
    import functools
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.serving import engine as E
    cfg, q = _case(name)
    mesh = _mesh(shape)
    if params is None:
        params = M.init_params(cfg, seed=0, device="cpu", quant=q)
    caches = M.init_caches(cfg, B, MAX_LEN, quant=q, device="cpu")
    ps = S_.shard_tree(params, mesh, S_.shardings_for_params(mesh, params))
    cs = S_.shard_tree(caches, mesh, S_.shardings_for_caches(mesh, caches))
    dp = mesh.get_local_rank("data")
    rows = slice(dp * (B // shape[0]), (dp + 1) * (B // shape[0]))
    prefill = S_.sharded_serve_step(
        functools.partial(E.prefill_step, cfg=cfg, quant=q), mesh)
    decode = S_.sharded_serve_step(
        functools.partial(E.serve_step, cfg=cfg, quant=q), mesh)
    res = {"logits": [], "tokens": [], "gathered": [], "flops": None}
    with torch.no_grad():
        logits, cs = prefill(ps, _batch(_prompts()[rows], 0), cs)
        res["gathered"].append(prefill.gathered_bytes)
        res["fallbacks"] = prefill.fallbacks
        for i in range(STEPS + 1):
            full = _full_logits(logits, mesh, cfg.vocab_padded)
            res["logits"].append(full.float().numpy())
            tok = _greedy(full, cfg)
            res["tokens"].append(tok.numpy())
            if i == STEPS:
                break
            batch = _batch(tok[rows, None].numpy(), S + i)
            if flops and i == 0:
                with FlopCounterMode(display=False) as fc:
                    logits, cs = decode(ps, batch, cs)
                mm = fc.get_flop_counts()["Global"].get(
                    torch.ops.aten.mm, 0)
                res["flops"] = mm / batch["tokens"].numel()
            else:
                logits, cs = decode(ps, batch, cs)
            res["gathered"].append(decode.gathered_bytes)
    res["tokens"] = np.stack(res["tokens"], 1)
    res["caches"] = _cache_leaves(cs)
    res["bound"] = _block_bound(mesh, params, shape[1], S_)
    out[(name, shape)] = res


def _block_bound(mesh, params, m, S_):
    """The most bytes of one block's (or the embedding's, or lm_head's)
    weights a rank holds once they are gathered over the DP axes: each
    leaf's whole bytes, over the model axis where the rules split it."""
    specs = S_.shardings_for_params(mesh, params)

    def share(tree, spec):
        tot = 0
        for t, sp in zip(_tensors(tree), _tensors(spec)):
            n = t.numel() * t.element_size()
            tot += n // m if "model" in sp else n
        return tot

    parts = [(params["layers"][i], specs["layers"][i])
             for i in range(len(params["layers"]))]
    parts += [(params[k], specs[k]) for k in ("embed", "lm_head")
              if k in params]
    return max(share(p, s) for p, s in parts)


def _tensors(tree):
    """Leaves in order, a packed weight's (or its spec dict's) fields
    apart."""
    from repro_torch.core.bipolar import BipolarTensor
    from repro_torch.core.tree import leaves
    out = []
    for leaf in leaves(tree) if not isinstance(tree, BipolarTensor) \
            else [tree]:
        if isinstance(leaf, BipolarTensor):
            out += [t for t in (leaf.packed, leaf.scale, leaf.width_scales)
                    if t is not None]
        else:
            out.append(leaf)
    return out


def _row_witness(S_, out):
    """On the (4, 2) mesh: a w_down-like row product on the rank's
    K-shard, with the global absmax (the port's) and with each rank's own
    (a witness), against the fused linear on the whole weight."""
    import dataclasses
    from repro_torch.core.bipolar import absmax_scale
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import ops, ref
    from repro_torch.models.config import QuantConfig
    mesh = _mesh((4, 2))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(
        np.float32)).bfloat16()
    x[:, 200] = 9.0          # one rank's half holds each row's absmax
    w = ops.pack_weight(torch.from_numpy(
        rng.standard_normal((64, 256)).astype(np.float32)), 2)
    q = QuantConfig(w_bits=2, a_bits=8)
    want = ops.ap_linear_fused(x, w, a_bits=8)
    with TP.active(mesh, serve=True) as ctx:
        r = ctx.model_rank
        lo, hi = 4 * r, 4 * r + 4
        wl = dataclasses.replace(w, packed=w.packed[..., lo:hi],
                                 shape=(64, 128))
        xl = x[:, 128 * r:128 * (r + 1)]
        got = TP.row_product(xl, wl, quant=q)
        local = absmax_scale(xl, 8, axis=-1).float()
        y = TP.row_partial(xl, wl, local, a_bits=8, variant="fused")
        y = TP._all_reduce(y, "sum", ctx.model_group)
        bad = ref.linear_epilogue(y, local, wl.scale, out_dtype=x.dtype)
    out["row_witness"] = (bool(torch.equal(got.view(torch.int16),
                                           want.view(torch.int16))),
                          bool(torch.equal(bad.view(torch.int16),
                                           want.view(torch.int16))))


def _rank_main(rank, out_dir):
    import datetime
    import torch.distributed as dist
    from repro_torch.distributed import sharding as S_
    from repro_torch.models import model as M
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=240))
    with open(os.path.join(out_dir, f"single{rank}.pkl"), "wb") as f:
        pickle.dump({name: _single(name) for i, name in enumerate(CASES)
                     if i % WORLD == rank}, f)
    out = {}
    for name in CASES:
        for shape in MESHES:
            _sharded(name, shape, S_, M, out,
                     flops=name == "llama3-8b" and shape in ((8, 1),
                                                             (4, 2)))
    _row_witness(S_, out)
    # the anchor: the reference's parameters, bridged, on (4, 2)
    import time
    from repro_torch import bridge
    t0 = time.time()
    path = os.path.join(out_dir, "ref_params.pkl")
    while not os.path.exists(path + ".done"):
        assert time.time() - t0 < 300, "no reference parameters"
        time.sleep(0.2)
    with open(path, "rb") as f:
        tree = pickle.load(f)
    cfg, _ = _case("llama3-8b")
    anchor = {}
    _sharded("llama3-8b", (4, 2), S_, M, anchor,
             params=bridge.params_from_numpy(tree, cfg, device="cpu"))
    out["anchor"] = anchor[("llama3-8b", (4, 2))]["tokens"]
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# --- the reference's side ----------------------------------------------------

_REFERENCE = textwrap.dedent(r"""
    import functools, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, sys.argv[2])
    import test_torch_serve_parallel as T
    from _torch_parity import to_numpy_tree
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.models.config import QuantConfig
    from repro.serving import engine as JE
    arch, over, qargs = T.CASES["llama3-8b"]
    cfg = get_config(arch).reduced(**dict(T.RED, **over))
    q = QuantConfig(**qargs)
    params = JM.quantize_params(JM.init_params(cfg, jax.random.PRNGKey(0)),
                                q)
    path = sys.argv[1]
    with open(path + "/ref_params.pkl", "wb") as f:
        pickle.dump(to_numpy_tree(params), f)
    open(path + "/ref_params.pkl.done", "w").close()
    caches = JM.init_caches(cfg, T.B, T.MAX_LEN, quant=q)
    prefill = jax.jit(functools.partial(JE.prefill_step, cfg=cfg, quant=q))
    decode = jax.jit(functools.partial(JE.serve_step, cfg=cfg, quant=q))
    toks = jnp.asarray(T._prompts())
    pos = jnp.broadcast_to(jnp.arange(T.S, dtype=jnp.int32), toks.shape)
    logits, caches = prefill(params, {"tokens": toks, "positions": pos},
                             caches)
    out = []
    for i in range(T.STEPS + 1):
        tok = jnp.argmax(logits[:, :cfg.vocab].astype(jnp.float32),
                         -1).astype(jnp.int32)
        out.append(np.asarray(tok))
        if i == T.STEPS:
            break
        logits, caches = decode(params, {
            "tokens": tok[:, None],
            "positions": jnp.full((T.B, 1), T.S + i, jnp.int32)}, caches)
    with open(path + "/ref.pkl", "wb") as f:
        pickle.dump(np.stack(out, 1), f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the 8 ranks and the reference's subprocess; yields a
    function that waits for one of them and returns its results."""
    out = tmp_path_factory.mktemp("serve")
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(out), here],
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=os.pathsep.join([src, here])),
        stdout=open(out / "ref.log", "w"), stderr=subprocess.STDOUT)
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(out)],
        env=env, stdout=open(out / f"rank{r}.log", "w"),
        stderr=subprocess.STDOUT) for r in range(WORLD)]

    def result(which):
        if which == "ref":
            assert ref.wait(timeout=300) == 0, (out / "ref.log").read_text()
            with open(out / "ref.pkl", "rb") as f:
                return pickle.load(f)
        for r, p in enumerate(ranks):
            rc = p.wait(timeout=400)
            assert rc == 0, (out / f"rank{r}.log").read_text()[-4000:]
        with open(out / "rank0.pkl", "rb") as f:
            return pickle.load(f)

    result.out = out
    yield result
    for p in ranks + [ref]:
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def dist_out(runs):
    return runs("ranks")


@pytest.fixture(scope="module")
def single(runs, dist_out):
    out = {}
    for r in range(WORLD):
        with open(runs.out / f"single{r}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out


# --- 1. the sharded serve step against the single process --------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serve_matches_single_process(dist_out, single, name,
                                              shape):
    got, want = dist_out[(name, shape)], single[name]
    assert got["caches"].keys() == want["caches"].keys()
    for path, w in want["caches"].items():
        np.testing.assert_array_equal(got["caches"][path], w,
                                      err_msg=str(path))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for g, w in zip(got["logits"], want["logits"]):
        if shape[1] == 1:
            np.testing.assert_array_equal(g, w)
        else:
            real = w > -1e29              # the vocab pad columns are -1e30
            gap = np.abs(g - w)[real].max()
            assert gap <= LOGIT_TOL * np.abs(w[real]).max(), gap


def test_fallbacks_are_named(dist_out):
    fb = dist_out[("llama3-8b whole heads", (2, 4))]["fallbacks"]
    assert any(f.startswith("whole heads") for f in fb), fb
    assert any(f.startswith("row product whole") for f in fb), fb
    assert "ssm mixer whole" in dist_out[("jamba-1.5-large-398b",
                                          (4, 2))]["fallbacks"]
    assert "experts whole on dispatch-row shards" in dist_out[
        ("mixtral-8x7b", (4, 2))]["fallbacks"]
    assert dist_out[("llama3-8b", (4, 2))]["fallbacks"] == [
        "residual whole over model (prefill)"]
    # deepseek's shared expert: d_ff 64 is 2 words, whole over 4 ranks
    assert "row product whole (K 64)" in dist_out[("deepseek-moe-16b",
                                                   (2, 4))]["fallbacks"]


# --- 2. witnesses ------------------------------------------------------------

def test_model_axis_splits_the_linear_work(dist_out):
    tp = dist_out[("llama3-8b", (4, 2))]["flops"]
    dp = dist_out[("llama3-8b", (8, 1))]["flops"]
    assert 0 < tp <= 0.55 * dp, (tp, dp)


def test_gathered_weights_stay_within_one_block(dist_out):
    r = dist_out[("llama3-8b", (4, 2))]
    assert 0 < max(r["gathered"]) <= r["bound"], (r["gathered"], r["bound"])


def test_row_product_with_a_per_rank_absmax_misses(dist_out):
    exact, local = dist_out["row_witness"]
    assert exact and not local


def test_sharded_tokens_equal_the_references_engine(dist_out, runs):
    np.testing.assert_array_equal(dist_out["anchor"], runs("ref"))


# --- 3. no group: the row product and K6's lse -------------------------------

@pytest.mark.parametrize("variant", ["fused", "bitserial"])
@pytest.mark.parametrize("w_bits", [2, 3, 4, 8])
def test_k_shard_row_product_is_the_fused_linear(w_bits, variant):
    """K 200 (7 words, the last 24 of them pad) cut into shards of 3, 2
    and 2 words: K3 at the rows' scale, K5's raw partials summed in
    int32, K1's epilogue once -- the fused linear's bits."""
    import dataclasses
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(w_bits)
    k = 200
    x = torch.from_numpy(rng.standard_normal((5, k)).astype(
        np.float32)).bfloat16()
    res = torch.from_numpy(rng.standard_normal((5, 48)).astype(
        np.float32)).bfloat16()
    w = ops.pack_weight(torch.from_numpy(
        rng.standard_normal((48, k)).astype(np.float32)), w_bits)
    want = ops.ap_linear_fused(x, w, a_bits=8, residual=res,
                               variant=variant)
    scale = TP.row_scale(x, 8)
    y = None
    for lo, hi in ((0, 3), (3, 5), (5, 7)):
        kl = min(hi * 32, k) - lo * 32
        wl = dataclasses.replace(w, packed=w.packed[..., lo:hi],
                                 shape=(48, kl))
        part = TP.row_partial(x[:, lo * 32:lo * 32 + kl], wl, scale,
                              a_bits=8, variant=variant)
        y = part if y is None else y + part
    got = ref.linear_epilogue(y, scale, w.scale, residual=res,
                              out_dtype=x.dtype)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    unfused = ops.ap_linear(x, w, a_bits=8, variant=variant) + res
    assert torch.equal(got.view(torch.int16), unfused.view(torch.int16))


def test_k6_plain_lse_recombines_a_split():
    """K6's plain version: ``o`` with the lse asked for equals ``o``
    without it; two halves of the slots, each with its lse, combine to
    the whole within 1e-5 (rows one half cannot see give -inf)."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(2)
    b, h, g, t, d = 2, 3, 4, 64, 32
    kv = torch.from_numpy(rng.standard_normal((2, b, t, h, d)).astype(
        np.float32))
    k, ks = ops.quantize_kv(kv[0], 8)
    v, vs = ops.quantize_kv(kv[1], 8)
    q = torch.from_numpy(rng.standard_normal((b, h, g, d)).astype(
        np.float32))
    kv_pos = torch.arange(t, dtype=torch.int32)[None].repeat(b, 1)
    kv_pos[1, 40:] = -1
    q_pos = torch.tensor([[63] * g, [20] * g], dtype=torch.int32)
    o = ops.ring_kv_cache_attention(q, k, ks, v, vs, q_pos, kv_pos, d=d)
    o2, lse = ops.ring_kv_cache_attention(q, k, ks, v, vs, q_pos, kv_pos,
                                          d=d, return_lse=True)
    assert torch.equal(o, o2) and lse.shape == (b, h, g)
    parts = [ops.ring_kv_cache_attention(
        q, k[:, sl], ks[:, sl], v[:, sl], vs[:, sl], q_pos, kv_pos[:, sl],
        d=d, return_lse=True) for sl in (slice(0, 32), slice(32, 64))]
    assert torch.isinf(parts[1][1][1]).all()      # row 1 sees no slot
    got = ref.combine_partials(torch.stack([p[0] for p in parts]),
                               torch.stack([p[1] for p in parts]))
    assert (got - o).abs().max().item() <= 1e-5


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
