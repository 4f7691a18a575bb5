"""The port's training stack held to the reference on the CPU: the data
pipeline, the schedules, one AdamW update (f32 and int8 moments), the
loss and its gradients, rematerialisation, and a 3-step trainer run.

The reference's loss, gradients and trainer losses are computed once per
module, jitted, in a subprocess with ``XLA_FLAGS=--xla_allow_excess_
precision=false`` (the ground rules' anchor: in-process, XLA keeps bf16
intermediates at f32 precision across fused ops, which the port does
not), and handed over as numpy.

Bars, each with a negative witness that fails it:

* ``batch_at``: bit for bit.  Schedules: within 1 f32 ulp of the
  reference's f32 values.
* one AdamW update from identical params, grads and state: params within
  1 bf16 ulp (f32 leaves 1 f32 ulp) or, where the update cancels a weight
  to near 0, 2^-16 of the leaf's largest magnitude (measured: one embed
  weight at -1.7e-7, 5 ulps off), moments and scales within 2^-16 of
  each leaf's largest magnitude, ``grad_norm`` within 2^-16 relative
  (measured 1.3e-6: the global norms sum ~600k squares in another
  order, and the clip follows), int8 codes equal but for +-1 where a
  value sits on a rounding edge.  Witness: a
  port that clips after the moments (the moments hold the unclipped
  gradient) misses the moments' bar.
* ``loss_fn``: dense and SSM within 1e-5 (measured: llama3-8b 0,
  mamba2-130m 4.8e-7); MoE within 2e-3 (measured: 4.0e-4 on reduced
  mixtral-8x7b: the router's f32 softmax rounds otherwise than XLA's, and
  a few top-2 weights cast to bf16 flip, as they do between the
  reference's own eager and jitted runs, 1.5e-4 apart).  Gradients: each
  leaf within 1.5e-2 of the reference's in relative L2 norm (measured
  worst: 6.0e-3 dense, 9.5e-3 MoE, 3.6e-3 SSM; the weights' gradients
  are bf16).  Witness: a port that drops the MoE aux loss is 2.5e-2 off
  in the loss, and its routers' gradients 2.0e-2 and 4.2e-2 off.
* remat on and off: bit-identical loss and gradients.
* a 3-step ``Trainer`` run of each package from the same params: every
  step's loss within 4e-3 (measured worst 8.6e-4: Adam's first steps
  move each weight by about ``lr`` whatever its gradient's size, so a
  gradient near zero that differs in sign moves its weight the other
  way).  Witness: a trainer that takes the lr from the incremented step
  (lr > 0 at step 0) is 2.8e-2 off at step 1.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy_tree
from repro.data import pipeline as RD
from repro.optim import optimizer as RO
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.data import pipeline as PD
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import optimizer as PO
from repro_torch.train.trainer import TrainConfig, Trainer

LOSS_ARCHS = ("llama3-8b", "mixtral-8x7b", "mamba2-130m")
LOSS_TOL = {"llama3-8b": 1e-5, "mixtral-8x7b": 2e-3, "mamba2-130m": 1e-5}
GRAD_TOL = 1.5e-2            # relative L2 norm, each leaf
TRAIN_TOL = 4e-3             # each step's loss, 3-step trainer run

_ANCHOR = textwrap.dedent(r"""
    import pickle, sys, tempfile
    from functools import partial
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, sys.argv[2])
    from _torch_parity import to_numpy_tree
    from repro.configs import get_config
    from repro.data.pipeline import DataSpec
    from repro.models import model as M
    from repro.train.trainer import TrainConfig, Trainer
    out = {}
    for arch in %(archs)r:
        cfg = get_config(arch).reduced(n_layers=2)
        params = M.init_params(cfg, jax.random.PRNGKey(3))
        rng = np.random.default_rng(5)
        toks = rng.integers(0, cfg.vocab, (2, 32), dtype=np.int32)
        labels = rng.integers(0, cfg.vocab, (2, 32), dtype=np.int32)
        labels[0, :3] = -1                      # masked
        batch = {"tokens": toks, "labels": labels}
        loss, grads = jax.jit(jax.value_and_grad(partial(M.loss_fn, cfg=cfg)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        out[arch] = dict(params=to_numpy_tree(params),
                         grads=to_numpy_tree(grads), loss=float(loss),
                         batch=batch)
    cfg = get_config("llama3-8b").reduced(n_layers=2)
    spec = DataSpec(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    t = Trainer(cfg, TrainConfig(num_steps=3, ckpt_dir=tempfile.mkdtemp(),
                                 ckpt_every=0, warmup_steps=2, peak_lr=1e-3),
                spec, async_ckpt=False)
    state = t.init_state()
    params0 = to_numpy_tree(state["params"])
    _, hist = t.run(resume=False, state=state)
    out["trainer"] = dict(params=params0, history=hist)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""") % {"archs": LOSS_ARCHS}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its steps are many
    small ops, and under a parallel test run a pool of threads a worker
    waits at every op's barrier for cores the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _anchor_run(tmp_path_factory):
    """Starts the reference's run (``anchor``) in a subprocess when the
    module's first test starts, so that the tests before the first that
    reads it run meanwhile."""
    out = tmp_path_factory.mktemp("anchor")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    with open(out / "anchor.log", "w") as log:
        run = subprocess.Popen(
            [sys.executable, "-c", _ANCHOR, str(out / "anchor.pkl"), here],
            env=env, stdout=log, stderr=subprocess.STDOUT)
    yield run, out
    run.kill()
    run.wait()


@pytest.fixture(scope="module")
def anchor(_anchor_run):
    """The reference's jitted losses, gradients and 3-step trainer run,
    excess precision off (one subprocess for the module)."""
    run, out = _anchor_run
    rc = run.wait(timeout=600)
    assert rc == 0, (out / "anchor.log").read_text()
    with open(out / "anchor.pkl", "rb") as f:   # written by the run above
        return pickle.load(f)


def _ulps_f32(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# --- the data pipeline -------------------------------------------------------

@pytest.mark.parametrize("seed,step,shard,num_shards", [
    (0, 0, 0, 1), (3, 5, 1, 2), (7, 123, 3, 4), (1, 9, 0, 2)])
def test_batch_at_is_the_references_bit_for_bit(seed, step, shard,
                                                num_shards):
    kw = dict(vocab=1000, seq_len=40, global_batch=8, seed=seed,
              num_shards=num_shards, shard=shard)
    ref = RD.batch_at(RD.DataSpec(**kw), step)
    got = PD.batch_at(PD.DataSpec(**kw), step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == ref[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], ref[k])


# --- schedules ---------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    ("wsd", dict(peak_lr=1e-3, warmup_steps=2, total_steps=8)),
    ("wsd", dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
                 decay_frac=0.2)),
    ("cosine", dict(peak_lr=3e-4, warmup_steps=5, total_steps=60)),
    ("cosine", dict(peak_lr=1e-3, warmup_steps=10, total_steps=100))])
def test_schedule_within_one_f32_ulp(kind, kw):
    make = {"wsd": (RO.wsd_schedule, PO.wsd_schedule),
            "cosine": (RO.cosine_schedule, PO.cosine_schedule)}[kind]
    ref, port = make[0](**kw), make[1](**kw)
    steps = range(kw["total_steps"] + 5)
    want = np.array([np.float32(ref(s)) for s in steps])
    got = port(torch.tensor(list(steps), dtype=torch.int32)).numpy()
    assert got.dtype == np.float32
    assert _ulps_f32(got, want).max() <= 1


# --- no jax, no ml_dtypes ----------------------------------------------------

_ISOLATION = r"""
import os, sys, tempfile
sys.modules["jax"] = None          # any import now fails
sys.modules["ml_dtypes"] = None
import torch
from repro_torch.checkpoint import manager as CM
from repro_torch.data import pipeline
from repro_torch.optim import optimizer
from repro_torch.train import trainer
from repro_torch import bridge
tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 7}
d = tempfile.mkdtemp()
CM.save_tree(tree, d, 1)
out, _ = CM.restore_tree(tree, d)
assert torch.equal(out["w"].view(torch.int16), tree["w"].view(torch.int16))
bad = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m in ("repro", "jax", "ml_dtypes") or m.startswith(("repro.", "jax."))))
assert not bad, bad
"""


def test_training_modules_import_without_jax_or_ml_dtypes():
    """The card's machine has no ml_dtypes: a bf16 checkpoint round trip
    runs with it (and jax) unimportable."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    out = subprocess.run([sys.executable, "-c", _ISOLATION], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# --- one AdamW update --------------------------------------------------------

def _adamw_case(state_bits):
    """Reduced llama3-8b params, a state after one reference update and
    the gradients of the next (large: the clip is active)."""
    import jax
    from repro.configs import get_config as ref_config
    from repro.models import model as RM
    cfg = get_config("llama3-8b").reduced(n_layers=2)
    rcfg = ref_config("llama3-8b").reduced(n_layers=2)
    params = RM.init_params(rcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)

    def grads_like(p):
        return jnp.asarray(3.0 * rng.standard_normal(p.shape), p.dtype)

    acfg = RO.AdamWConfig(state_bits=state_bits)
    g0 = jax.tree.map(grads_like, params)
    params, state, _ = RO.adamw_update(g0, RO.adamw_init(params, acfg),
                                       params, lr=1e-2, cfg=acfg)
    grads = jax.tree.map(grads_like, params)
    return cfg, acfg, params, state, grads


def _port_inputs(cfg, params, state, grads):
    p = bridge.params_from_numpy(to_numpy_tree(params), cfg, device="cpu")
    g = bridge.params_from_numpy(to_numpy_tree(grads), cfg, device="cpu")
    st = bridge.opt_state_from_numpy(
        {k: (None if getattr(state, k) is None
             else to_numpy_tree(getattr(state, k)))
         for k in state._fields}, cfg, device="cpu")
    return p, g, st


def _close(got, want, tol):
    """max |got - want| <= tol * max |want| (leaf by leaf)."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() <= tol * max(
        want.abs().max().item(), 1e-30)


def _bf16_ulps(a, b):
    def ordinal(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordinal(a) - ordinal(b)).abs()


def _adamw_results(state_bits, **port_over):
    cfg, acfg, params, state, grads = _adamw_case(state_bits)
    p, g, st = _port_inputs(cfg, params, state, grads)
    import dataclasses
    pcfg = dataclasses.replace(PO.AdamWConfig(state_bits=state_bits),
                               **port_over)
    p, st, stats = PO.adamw_update(g, st, p, lr=torch.tensor(
        1e-2, dtype=torch.float32), cfg=pcfg)
    rp, rst, rstats = RO.adamw_update(grads, state, params,
                                      lr=jnp.float32(1e-2), cfg=acfg)
    want_p, want_st = _port_inputs(cfg, rp, rst, grads)[::2]
    return p, st, stats, want_p, want_st, rstats


def _moments_close(st, want_st, int8):
    ok = True
    for key in ("m_scale", "v_scale") if int8 else ("m", "v"):
        for a, b in zip(leaves(getattr(st, key)), leaves(getattr(want_st,
                                                                 key))):
            ok &= _close(a, b, 2.0 ** -16)
    return ok


@pytest.mark.parametrize("state_bits", [None, 8])
def test_adamw_update_matches_reference(state_bits):
    p, st, stats, want_p, want_st, rstats = _adamw_results(state_bits)
    int8 = state_bits == 8
    g_ref = float(rstats["grad_norm"])
    assert g_ref > 1.0                               # the clip is active
    assert abs(float(stats["grad_norm"]) - g_ref) <= 2.0 ** -16 * g_ref
    assert int(st.step) == int(want_st.step) == 2
    for a, b in zip(leaves(p), leaves(want_p)):
        assert a.dtype == b.dtype
        ulps = (_bf16_ulps(a, b) if a.dtype == torch.bfloat16 else
                torch.from_numpy(_ulps_f32(a.numpy(), b.numpy())))
        near = (a.float() - b.float()).abs() <= 2.0 ** -16 * b.float(
        ).abs().max()
        assert bool(((ulps <= 1) | near).all())
    assert _moments_close(st, want_st, int8)
    if int8:
        for key in ("m", "v"):
            for a, b in zip(leaves(getattr(st, key)),
                            leaves(getattr(want_st, key))):
                assert a.dtype == b.dtype == torch.int8
                diff = (a.int() - b.int()).abs()
                assert diff.max().item() <= 1
                assert (diff > 0).float().mean().item() < 1e-3


@pytest.mark.parametrize("state_bits", [None, 8])
def test_adamw_that_clips_after_the_moments_misses_the_bar(state_bits):
    """Negative witness: moments fed the unclipped gradient."""
    _, st, _, _, want_st, _ = _adamw_results(state_bits, grad_clip=1e30)
    assert not _moments_close(st, want_st, state_bits == 8)


# --- the norm's gradient -----------------------------------------------------

@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_gradients_match_reference(norm_type):
    """The norm's input and scale gradients (f32 input, d 256) within
    2^-20 of the largest of the reference's (measured 8.4e-8); its row
    sum's one-op gradient is the gradient autograd gives through the
    serial adds, bit for bit."""
    import dataclasses
    import jax
    from repro.configs import get_config as ref_config
    from repro.models import layers as RL
    cfg, rcfg = (dataclasses.replace(g("llama3-8b").reduced(d_model=256),
                                     norm_type=norm_type)
                 for g in (get_config, ref_config))
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((16, 256))).astype(np.float32)
    w = rng.standard_normal((16, 256)).astype(np.float32)
    p = {"scale": (rng.random(256) + 0.5).astype(np.float32),
         "bias": (rng.random(256) - 0.5).astype(np.float32)}
    if norm_type == "rmsnorm":
        del p["bias"]
    want = jax.jit(jax.grad(
        lambda p, x: jnp.sum(RL.norm_apply(p, x, rcfg) * w),
        argnums=(0, 1)))({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    want = (np.asarray(want[1]), np.asarray(want[0]["scale"]))

    def port_grads():
        xt = torch.from_numpy(x).requires_grad_(True)
        pt = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()}
        out = (L.norm_apply(pt, xt, cfg) * torch.from_numpy(w)).sum()
        return torch.autograd.grad(out, [xt, pt["scale"]])

    got = port_grads()
    for g, r in zip(got, want):
        assert np.abs(g.numpy() - r).max() <= 2.0 ** -20 * np.abs(r).max()
    row_sum = L._row_sum
    try:
        L._row_sum = L._tree_sum           # autograd through the adds
        through_adds = port_grads()
    finally:
        L._row_sum = row_sum
    assert all(torch.equal(a, b) for a, b in zip(got, through_adds))


# --- the loss and its gradients ----------------------------------------------

def _port_loss_and_grads(cfg, params, batch, remat=True):
    flat = leaves(params)
    for x in flat:
        x.requires_grad_(True)
    loss = M.loss_fn(params, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, flat)
    for x in flat:
        x.requires_grad_(False)
    return loss.detach(), grads


def _grad_errors(cfg, ref_grads, grads):
    """{path: relative L2 error} of each leaf's gradient."""
    want = bridge.params_from_numpy(ref_grads, cfg, device="cpu")
    out = {}
    for (path, w), g in zip(leaves_with_paths(want), grads):
        assert w.dtype == g.dtype, path
        w, g = w.float(), g.float()
        out[path] = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
    return out


def _loss_case(anchor, arch):
    cfg = get_config(arch).reduced(n_layers=2)
    a = anchor[arch]
    params = bridge.params_from_numpy(a["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in a["batch"].items()}
    return cfg, a, params, batch


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_reference(anchor, arch):
    cfg, a, params, batch = _loss_case(anchor, arch)
    loss, grads = _port_loss_and_grads(cfg, params, batch)
    assert abs(float(loss) - a["loss"]) <= LOSS_TOL[arch], (float(loss),
                                                            a["loss"])
    errs = _grad_errors(cfg, a["grads"], grads)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_loss_without_the_moe_aux_misses_the_bar(anchor, monkeypatch):
    """Negative witness: a port whose MoE layers drop the load-balance
    loss (mixtral-8x7b reduced)."""
    moe_apply = L.moe_apply

    def no_aux(*args, **kw):
        y, aux, stats = moe_apply(*args, **kw)
        return y, aux * 0.0, stats

    monkeypatch.setattr(L, "moe_apply", no_aux)
    cfg, a, params, batch = _loss_case(anchor, "mixtral-8x7b")
    loss, grads = _port_loss_and_grads(cfg, params, batch)
    assert abs(float(loss) - a["loss"]) > LOSS_TOL["mixtral-8x7b"]
    errs = _grad_errors(cfg, a["grads"], grads)
    routers = [e for path, e in errs.items() if "router" in path]
    assert len(routers) == 2 and min(routers) > GRAD_TOL, errs


@pytest.mark.parametrize("arch,over", [
    ("llama3-8b", {}), ("mixtral-8x7b", {}), ("mamba2-130m", {}),
    ("deepseek-moe-16b", {}), ("jamba-1.5-large-398b", {"attn_every": 2})])
def test_remat_is_bit_identical(arch, over):
    """One checkpointed unit a layer (jamba: its 2-layer hybrid group;
    deepseek: the dense prelude layer runs without)."""
    cfg = get_config(arch).reduced(n_layers=4 if over else 3, **over)
    params = M.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    la, ga = _port_loss_and_grads(cfg, params, batch, remat=True)
    lb, gb = _port_loss_and_grads(cfg, params, batch, remat=False)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_loss_chunks_pads_and_masks(monkeypatch):
    """The chunked loss with a padded last chunk equals the one-chunk
    loss within f32 rounding; labels < 0 and a given mask drop the same
    positions."""
    cfg = get_config("llama3-8b").reduced(n_layers=1)
    params = M.init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40),
                                         dtype=np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40),
                                           dtype=np.int32))
    masked = labels.clone()
    masked[:, :5] = -1
    mask = torch.ones_like(labels)
    mask[:, :5] = 0
    out = {}
    with torch.no_grad():
        for chunk in (16, 512):             # 16: three chunks, 8 pads
            monkeypatch.setattr(M, "LOSS_CHUNK", chunk)
            out[chunk] = [float(M.loss_fn(params, b, cfg)) for b in (
                {"tokens": toks, "labels": labels},
                {"tokens": toks, "labels": masked},
                {"tokens": toks, "labels": labels, "mask": mask})]
    np.testing.assert_allclose(out[16], out[512], rtol=1e-6)
    assert out[16][1] == out[16][2] != out[16][0]


def test_forward_without_caches_keeps_the_serving_return_shape():
    cfg = get_config("mixtral-8x7b").reduced(n_layers=2)
    params = M.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with torch.no_grad():
        out = M.forward(params, toks, cfg)
        x, caches, aux = M.forward(params, toks, cfg, with_aux=True)
    assert len(out) == 2 and out[1] is None and caches is None
    assert torch.equal(out[0], x)
    assert aux.dtype == torch.float32 and float(aux) > 0


# --- a 3-step trainer run ----------------------------------------------------

def _port_history(anchor, tmp_path, schedule_shift=0):
    cfg = get_config("llama3-8b").reduced(n_layers=2)
    spec = PD.DataSpec(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    tcfg = TrainConfig(num_steps=3, ckpt_dir=str(tmp_path), ckpt_every=0,
                       warmup_steps=2, peak_lr=1e-3)
    t = Trainer(cfg, tcfg, spec, async_ckpt=False, device="cpu")
    if schedule_shift:
        schedule = t.schedule
        t.schedule = lambda step: schedule(step + schedule_shift)
    params = bridge.params_from_numpy(anchor["trainer"]["params"], cfg,
                                      device="cpu")
    state = {"params": params, "opt": PO.adamw_init(params, tcfg.adamw)}
    _, hist = t.run(resume=False, state=state)
    return np.array(hist) - np.array(anchor["trainer"]["history"])


def test_trainer_losses_track_reference(anchor, tmp_path):
    diff = _port_history(anchor, tmp_path)
    assert np.abs(diff).max() <= TRAIN_TOL, diff


def test_trainer_with_lr_of_the_incremented_step_misses_the_bar(anchor,
                                                                tmp_path):
    """Negative witness: lr = schedule(step + 1), nonzero at step 0."""
    diff = _port_history(anchor, tmp_path, schedule_shift=1)
    assert np.abs(diff).max() > TRAIN_TOL, diff
