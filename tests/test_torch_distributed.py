"""The port's distributed layer on the CPU: 8 gloo ranks, spawned once
for the module, against the single-process port and the reference.

The ranks run this file as a script (``_rank_main``, torch and the port
only, one intra-op thread each), meet through a ``FileStore`` in the
module's temporary directory (so that parallel test workers never share
a port) and write their results there; the reference's side (8 host
devices, ``shard_map``) runs meanwhile in one subprocess.  Each test
below reads one part of those results.

Bars, each with a negative witness where one can miss it:

* sharded loss on a (4, 2) ``(data, model)`` mesh, reduced llama3-8b (2
  layers) on ``batch_at(seq_len=32, global_batch=8)``: within 1e-5
  relative of the single-process port's loss (measured: equal); every
  leaf's gradient within 1e-2 relative L2 (measured worst 3.7e-3: the
  shards' bf16 partial gradients are summed in bf16).  Reduced
  mixtral-8x7b: loss within 5e-3 relative (measured 2.5e-4), gradients
  within 2e-2 (measured worst 1.6e-2, a router's): its load-balance loss
  is the mean of the four DP ranks' (each over its own tokens), not the
  global batch's.  Witness: mixtral misses llama's 1e-5 loss bar.
* resident bytes: a rank holds under 0.55 of the replicated parameter
  bytes, and at least a third of the leaves are sharded.
* ``compressed_psum`` at 8 ranks: bit-identical to the reference's.
  Witness: a scale taken locally (no MAX all-reduce) is not.  The
  compressed ``dp_train_step`` within 0.05 relative L2 of the exact
  one, its loss within 1e-3.
* sharded AdamW (f32 and int8 moments) from the same gradients: params
  within 1 bf16 ulp or 2^-16 of the leaf's largest, moments and scales
  within 2^-16 of the leaf's largest, int8 codes equal but for +-1 on
  rounding edges.  Witness: int8 row scales taken from the local shard
  of a row miss the scales' bar.
* GPipe, 4 stages x 8 microbatches: within 1e-5 of the sequential result
  and of the reference's ``pipeline_apply`` on the same numpy weights.
* elastic restore: saved from (4, 2), restored onto (2, 4), every leaf
  equal bit for bit and on the (2, 4) mesh; a checkpoint written by the
  reference restores onto a mesh bit for bit.
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
LOSS_TOL = {"llama3-8b": 1e-5, "mixtral-8x7b": 5e-3}   # relative
GRAD_TOL = {"llama3-8b": 1e-2, "mixtral-8x7b": 2e-2}   # relative L2, a leaf
PIPE = dict(n_stages=4, n_micro=8, mb=2, d=16)


def _pipe_inputs():
    rng = np.random.default_rng(11)
    d = PIPE["d"]
    ws = (rng.standard_normal((PIPE["n_stages"], d, d))
          / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((PIPE["n_micro"], PIPE["mb"], d)).astype(
        np.float32)
    return ws, x


def _grad_trees(rank):
    """The seeded per-rank gradient tree of the compressed all-reduce."""
    rng = np.random.default_rng(100 + rank)
    return {"a": (rng.standard_normal((64, 32)) * (rank + 1)).astype(
                np.float32),
            "b": (rng.standard_normal((7, 5, 3)) * 1e-3).astype(np.float32),
            "c": rng.standard_normal((129,)).astype(np.float32)}


# --- one rank ----------------------------------------------------------------

def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _np(t):
    return _full(t).detach().float().numpy()


def _sharded_case(arch, mesh, S, M, out):
    import functools
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataSpec, batch_at
    cfg = get_config(arch).reduced(n_layers=2)
    params = M.init_params(cfg, seed=0, device="cpu")
    spec = DataSpec(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in batch_at(spec, 0).items()}
    ps = S.shard_tree(params, mesh, S.shardings_for_params(mesh, params))
    bs = S.shard_tree(batch, mesh, S.shardings_for_batch(mesh, batch))
    step = S.sharded_step(functools.partial(M.loss_terms, cfg=cfg), mesh)
    loss, grads = step(ps, bs)
    res = {"loss": float(loss), "grads": [_np(g) for g in leaves(grads)]}
    local = [p.to_local() for p in leaves(ps)]
    res["local_bytes"] = sum(t.numel() * t.element_size() for t in local)
    res["full_bytes"] = sum(p.numel() * p.element_size()
                            for p in leaves(params))
    res["n_sharded"] = sum(any(not q.is_replicate() for q in p.placements)
                           for p in leaves(ps))
    res["n_leaves"] = len(leaves(ps))
    out[arch] = res
    return cfg, params, ps, grads


def _adamw_case(ps, grads, out):
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.optim import optimizer as PO
    full_grads = tree_map(_full, grads)
    out["adamw_grads"] = [g.float().numpy() for g in leaves(full_grads)]
    for bits in (None, 8):
        for witness in ((False, True) if bits else (False,)):
            row_max = PO._row_max
            if witness:      # an int8 row's scale from its local shard
                PO._row_max = lambda amax, groups: amax
            try:
                acfg = PO.AdamWConfig(state_bits=bits)
                sp = tree_map(lambda p: p.detach().clone(), ps)
                st = PO.adamw_init(sp, acfg)
                sp, st, stats = PO.adamw_update(
                    grads, st, sp, lr=torch.tensor(1e-2), cfg=acfg)
            finally:
                PO._row_max = row_max
            out[("adamw", bits, witness)] = {
                "params": [_full(p).detach() for p in leaves(sp)],
                "m": [_full(x) for x in leaves(st.m)],
                "v": [_full(x) for x in leaves(st.v)],
                "m_scale": None if st.m_scale is None else
                [_full(x) for x in leaves(st.m_scale)],
                "v_scale": None if st.v_scale is None else
                [_full(x) for x in leaves(st.v_scale)],
                "grad_norm": float(stats["grad_norm"])}


def _rank_main(rank, out_dir, ref_ckpt):
    import datetime
    import functools
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as CM
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data.pipeline import DataSpec, batch_at
    from repro_torch.distributed import compress as C
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=240))
    out = {}
    mesh = LM.make_host_mesh(4, 2)
    cfg, params, ps, grads = _sharded_case("llama3-8b", mesh, S, M, out)
    _adamw_case(ps, grads, out)
    _sharded_case("mixtral-8x7b", mesh, S, M, out)

    # an activation constrained to the residual rule (batch over data,
    # sequence over model), then no longer once the context is gone
    from torch.distributed.tensor import Replicate, distribute_tensor
    x = torch.arange(8 * 32 * 16, dtype=torch.float32).reshape(8, 32, 16)
    xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    S.set_activation_context(mesh)
    y = S.constrain(xd, "residual")
    S.set_activation_context(None)
    out["constrain"] = (tuple((type(q).__name__, getattr(q, "dim", None))
                              for q in y.placements),
                        bool(torch.equal(y.full_tensor(), x)),
                        S.constrain(xd, "residual") is xd)

    # compressed all-reduce, the port's and a local-scale mutation
    mesh1d = LM.make_mesh((WORLD,), ("data",), "cpu")
    group = mesh1d.get_group("data")
    tree = {k: torch.from_numpy(v) for k, v in _grad_trees(rank).items()}
    out["psum"] = {k: v.numpy() for k, v in
                   C.compressed_psum(tree, group).items()}

    class _NoMax:                 # the MAX all-reduce of the scale skipped
        def __getattr__(self, name):
            return getattr(dist, name)

        def all_reduce(self, t, op=dist.ReduceOp.SUM, group=None):
            if op != dist.ReduceOp.MAX:
                dist.all_reduce(t, op=op, group=group)

    C.dist = _NoMax()
    try:
        out["psum_local_scale"] = {k: v.numpy() for k, v in
                                   C.compressed_psum(tree, group).items()}
    finally:
        C.dist = dist
    spec = DataSpec(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in batch_at(spec, 0).items()}
    loss_fn = functools.partial(M.loss_fn, cfg=cfg)
    for compress in (True, False):
        step = C.dp_train_step(loss_fn, mesh1d, compress=compress)
        loss, g = step(params, batch)
        out[("dp", compress)] = (float(loss),
                                 [x.float().numpy() for x in leaves(g)])

    # GPipe: two pipes of 4 stages side by side
    ws, x = _pipe_inputs()
    pmesh = LM.make_mesh((2, PIPE["n_stages"]), ("rep", "pipe"), "cpu")
    run = pipeline_apply(lambda w, h: torch.tanh(h @ w), PIPE["n_stages"],
                         PIPE["n_micro"], axis="pipe")
    out["pipe"] = run(pmesh, torch.from_numpy(ws),
                      torch.from_numpy(x)).numpy()

    # elastic restore: saved from (4, 2), restored onto (2, 4)
    ckpt = os.path.join(out_dir, "ckpt")
    full = tree_map(lambda p: _full(p).detach(), ps)
    if rank == 0:
        CM.save_tree(full, ckpt, 1)
    dist.barrier()
    mesh24 = LM.make_host_mesh(2, 4)
    shd = S.named(mesh24, S.shardings_for_params(mesh24, params), params)
    restored, _ = CM.restore_tree(params, ckpt, shardings=shd)
    out["restore_equal"] = all(
        torch.equal(_full(r).view(torch.int16) if r.dtype == torch.bfloat16
                    else _full(r), (p.view(torch.int16)
                                    if p.dtype == torch.bfloat16 else p))
        for r, p in zip(leaves(restored), leaves(params)))
    out["restore_meshes"] = sorted({
        (tuple(r.device_mesh.mesh_dim_names), tuple(r.device_mesh.shape))
        for r in leaves(restored)})
    out["restore_sharded"] = sum(
        any(not q.is_replicate() for q in r.placements)
        for r in leaves(restored))
    # the reference's checkpoint, laid out as the reference's tree (its
    # subprocess writes ref.pkl last)
    import time
    t0 = time.time()
    while not os.path.exists(os.path.join(out_dir, "ref.pkl")):
        assert time.time() - t0 < 300, "no reference checkpoint"
        time.sleep(0.2)
    with open(os.path.join(ref_ckpt, "layout.pkl"), "rb") as f:
        layout = pickle.load(f)
    template = _template(layout)
    plain, _ = CM.restore_tree(template, ref_ckpt, device="cpu")
    shd = S.named(mesh24, S.shardings_for_params(mesh24, template),
                  template)
    onto, _ = CM.restore_tree(template, ref_ckpt, shardings=shd)
    out["ref_restore_equal"] = all(
        torch.equal(_full(a).view(torch.int16), b.view(torch.int16))
        if b.dtype == torch.bfloat16 else torch.equal(_full(a), b)
        for a, b in zip(leaves(onto), leaves(plain)))
    out["ref_restore_sharded"] = sum(
        any(not q.is_replicate() for q in a.placements)
        for a in leaves(onto))
    out["ref_restore_leaves"] = len(leaves(onto))
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _template(layout):
    """Empty tensors at the reference tree's paths: ``layout`` is a list
    of ``(path, shape, dtype name)``, a path of dict keys and list
    indices."""
    root: dict = {}
    for path, shape, dt in layout:
        node = root
        for k, nk in zip(path[:-1], path[1:]):
            node = node.setdefault(k, [] if isinstance(nk, int) else {}) \
                if isinstance(node, dict) else _slot(node, k, nk)
        dtype = torch.bfloat16 if dt == "bfloat16" else getattr(torch, dt)
        leaf = torch.empty(tuple(shape), dtype=dtype)
        if isinstance(node, dict):
            node[path[-1]] = leaf
        else:
            while len(node) <= path[-1]:
                node.append(None)
            node[path[-1]] = leaf
    return root


def _slot(lst, i, nk):
    while len(lst) <= i:
        lst.append(None)
    if lst[i] is None:
        lst[i] = [] if isinstance(nk, int) else {}
    return lst[i]


# --- the reference's side ----------------------------------------------------

_REFERENCE = textwrap.dedent(r"""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, sys.argv[3])
    import test_torch_distributed as T
    from repro.checkpoint import manager as CM
    from repro.configs import get_config
    from repro.distributed.compress import compressed_psum
    from repro.distributed.pipeline import pipeline_apply
    from repro.kernels.compat import shard_map
    from repro.models import model as M
    out = {}
    mesh = jax.make_mesh((8,), ("data",))
    trees = [T._grad_trees(r) for r in range(8)]
    stacked = {k: jnp.asarray(np.stack([t[k] for t in trees]))
               for k in trees[0]}
    f = shard_map(lambda t: compressed_psum(
                      jax.tree.map(lambda a: a[0], t), "data"),
                  mesh=mesh, in_specs=(P("data"),), out_specs=P(),
                  check_vma=False)
    out["psum"] = {k: np.asarray(v) for k, v in jax.jit(f)(stacked).items()}
    ws, x = T._pipe_inputs()
    pmesh = jax.make_mesh((4,), ("pipe",))
    run = pipeline_apply(lambda w, h: jnp.tanh(h @ w), 4, 8, axis="pipe")
    out["pipe"] = np.asarray(run(pmesh, jnp.asarray(ws), jnp.asarray(x)))
    cfg = get_config("llama3-8b").reduced(n_layers=2)
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    CM.save_tree(params, sys.argv[2], 1)
    layout = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        layout.append((keys, tuple(leaf.shape), str(leaf.dtype)))
    with open(os.path.join(sys.argv[2], "layout.pkl"), "wb") as fh:
        pickle.dump(layout, fh)
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the 8 ranks and the reference's subprocess; yields a
    function that waits for one of them and returns its results."""
    out = tmp_path_factory.mktemp("dist")
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    ref_ckpt = out / "ref_ckpt"
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(out / "ref.pkl"),
         str(ref_ckpt), here],
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=src),
        stdout=open(out / "ref.log", "w"), stderr=subprocess.STDOUT)
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(out),
         str(ref_ckpt)], env=env, stdout=open(out / f"rank{r}.log", "w"),
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

    yield result
    for p in ranks + [ref]:
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def dist_out(runs):
    return runs("ranks")


@pytest.fixture(scope="module")
def single():
    """The single-process port's loss and gradients on the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataSpec, batch_at
    from repro_torch.models import model as M
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for arch in LOSS_TOL:
            cfg = get_config(arch).reduced(n_layers=2)
            params = M.init_params(cfg, seed=0, device="cpu")
            spec = DataSpec(vocab=cfg.vocab, seq_len=32, global_batch=8,
                            seed=0)
            batch = {k: torch.from_numpy(v)
                     for k, v in batch_at(spec, 0).items()}
            flat = leaves(params)
            for x in flat:
                x.requires_grad_(True)
            loss = M.loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, flat)
            for x in flat:
                x.requires_grad_(False)
            out[arch] = {"loss": float(loss.detach()), "params": params,
                         "grads": [g.float().numpy() for g in grads]}
    finally:
        torch.set_num_threads(n)
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- 1. the sharded loss and gradients ---------------------------------------

@pytest.mark.parametrize("arch", list(LOSS_TOL))
def test_sharded_loss_matches_single_process(dist_out, single, arch):
    got, want = dist_out[arch]["loss"], single[arch]["loss"]
    assert abs(got - want) <= LOSS_TOL[arch] * abs(want), (got, want)


@pytest.mark.parametrize("arch", list(LOSS_TOL))
def test_sharded_grads_match_single_process(dist_out, single, arch):
    errs = [_rel(a, b) for a, b in zip(dist_out[arch]["grads"],
                                       single[arch]["grads"])]
    assert len(errs) == len(single[arch]["grads"])
    assert max(errs) <= GRAD_TOL[arch], errs


def test_mixtral_aux_under_dp_misses_the_llama_bar(dist_out, single):
    """Witness of the MoE caveat: the DP ranks' mean aux is not the
    global batch's, so mixtral misses the dense stack's 1e-5 bar."""
    got, want = dist_out["mixtral-8x7b"]["loss"], single["mixtral-8x7b"][
        "loss"]
    assert abs(got - want) > LOSS_TOL["llama3-8b"] * abs(want)


def test_constrain_redistributes_to_the_fitted_rule(dist_out):
    placements, same, identity_without_context = dist_out["constrain"]
    assert placements == (("Shard", 0), ("Shard", 1))
    assert same and identity_without_context


# --- 2. resident bytes -------------------------------------------------------

def test_params_are_sharded(dist_out):
    r = dist_out["llama3-8b"]
    assert r["local_bytes"] < 0.55 * r["full_bytes"], r
    assert r["n_sharded"] >= r["n_leaves"] // 3, r


# --- 3. the compressed all-reduce --------------------------------------------

def test_compressed_psum_is_the_references_bit_for_bit(dist_out, runs):
    ref = runs("ref")["psum"]
    for k, v in dist_out["psum"].items():
        assert v.dtype == ref[k].dtype
        np.testing.assert_array_equal(v, ref[k])


def test_compressed_psum_with_a_local_scale_is_not(dist_out, runs):
    ref = runs("ref")["psum"]
    assert any(not np.array_equal(v, ref[k])
               for k, v in dist_out["psum_local_scale"].items())


def test_compressed_dp_step_close_to_exact(dist_out):
    lc, gc = dist_out[("dp", True)]
    le, ge = dist_out[("dp", False)]
    assert abs(lc - le) < 1e-3
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(gc, ge))
    den = sum(float(np.sum(b ** 2)) for b in ge)
    assert (num / max(den, 1e-30)) ** 0.5 < 0.05


# --- 4. sharded AdamW --------------------------------------------------------

def _ulps(a, b):
    """Units in the last place between two bf16 or f32 tensors."""
    bits, mask = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
                  else (torch.int32, 0x7FFFFFFF))

    def ordinal(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & mask), i)
    return (ordinal(a) - ordinal(b)).abs()


def _close(got, want, tol):
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() <= tol * max(
        want.abs().max().item(), 1e-30)


def _adamw_single(dist_out, single, bits):
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.optim import optimizer as PO
    params = tree_map(lambda p: p.detach().clone(),
                      single["llama3-8b"]["params"])
    flat = leaves(params)
    grads = [torch.from_numpy(g).to(p.dtype)
             for g, p in zip(dist_out["adamw_grads"], flat)]
    done = iter(grads)
    grads = tree_map(lambda _: next(done), params)
    acfg = PO.AdamWConfig(state_bits=bits)
    p, st, stats = PO.adamw_update(grads, PO.adamw_init(params, acfg),
                                   params, lr=torch.tensor(1e-2), cfg=acfg)
    return leaves(p), st, stats


@pytest.mark.parametrize("bits", [None, 8])
def test_sharded_adamw_matches_single_process(dist_out, single, bits):
    from repro_torch.core.tree import leaves
    got = dist_out[("adamw", bits, False)]
    want_p, want_st, stats = _adamw_single(dist_out, single, bits)
    g = float(stats["grad_norm"])
    assert abs(got["grad_norm"] - g) <= 2.0 ** -16 * g
    for a, b in zip(got["params"], want_p):
        assert a.dtype == b.dtype
        near = (a.float() - b.float()).abs() <= 2.0 ** -16 * b.float(
        ).abs().max()
        assert bool(((_ulps(a, b) <= 1) | near).all())
    keys = ("m_scale", "v_scale") if bits else ("m", "v")
    for key in keys:
        for a, b in zip(got[key], leaves(getattr(want_st, key))):
            assert _close(a, b, 2.0 ** -16), key
    if bits:
        for key in ("m", "v"):
            for a, b in zip(got[key], leaves(getattr(want_st, key))):
                assert a.dtype == b.dtype == torch.int8
                diff = (a.int() - b.int()).abs()
                assert diff.max().item() <= 1
                assert (diff > 0).float().mean().item() < 1e-3


def test_adamw_with_a_local_row_scale_misses_the_bar(dist_out, single):
    from repro_torch.core.tree import leaves
    got = dist_out[("adamw", 8, True)]
    _, want_st, _ = _adamw_single(dist_out, single, 8)
    assert not all(_close(a, b, 2.0 ** -16)
                   for key in ("m_scale", "v_scale")
                   for a, b in zip(got[key], leaves(getattr(want_st, key))))


# --- 5. GPipe ----------------------------------------------------------------

def test_gpipe_matches_sequential_and_the_reference(dist_out, runs):
    ws, x = _pipe_inputs()
    ref = torch.from_numpy(x)
    for w in torch.from_numpy(ws):
        ref = torch.tanh(ref @ w)
    out = dist_out["pipe"]
    np.testing.assert_allclose(out, ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, runs("ref")["pipe"], rtol=1e-5,
                               atol=1e-5)


# --- 6. elastic restore ------------------------------------------------------

def test_elastic_restore_onto_another_mesh(dist_out):
    assert dist_out["restore_equal"]
    assert dist_out["restore_meshes"] == [(("data", "model"), (2, 4))]
    assert dist_out["restore_sharded"] > 0


def test_reference_checkpoint_restores_onto_a_mesh(dist_out):
    assert dist_out["ref_restore_equal"]
    assert 0 < dist_out["ref_restore_sharded"] <= dist_out[
        "ref_restore_leaves"]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
