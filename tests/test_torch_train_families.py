"""The VLM's and the enc-dec model's training losses held to the
reference on the CPU: reduced qwen2-vl-7b (M-RoPE ``(3, B, S)``
positions, patch embeddings) and seamless-m4t-medium (frames through the
encoder, cross-attention from the memory), 2 layers, on
``launch.specs.make_batch`` train batches.

The reference's losses and gradients are computed once per module,
jitted, in a subprocess with ``XLA_FLAGS=--xla_allow_excess_precision=
false`` (as ``tests/test_torch_train.py`` does), and handed over as
numpy.

Bars, each with a negative witness that misses it:

* the loss within 1e-5 of the reference's (measured: qwen2-vl-7b
  4.8e-7, seamless-m4t-medium 2.4e-6).  Witnesses: a loss that drops
  the patch embeddings (qwen2-vl, 3.5e-2 off) or zeroes the frames
  (seamless, 9.8e-2 off) misses it.
* every leaf's gradient within 1.5e-2 relative L2 of the reference's
  (``test_torch_train.py``'s bar; measured worst 2.0e-3 qwen2-vl, a
  norm scale, and 1.07e-2 seamless, a cross-attention norm's bias), the
  encoder's, the frontend's and the cross K/V projections' among them,
  each nonzero.
* ``remat`` on and off: bit-identical loss and gradients (the encoder's
  blocks are checkpointed one by one as well).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.launch.specs import make_batch
from repro_torch.models import model as M

ARCHS = ("qwen2-vl-7b", "seamless-m4t-medium")
LOSS_TOL = 1e-5
GRAD_TOL = 1.5e-2            # relative L2 norm, each leaf
BATCH, SEQ = 2, 32

_ANCHOR = textwrap.dedent(r"""
    import pickle, sys
    from functools import partial
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, sys.argv[2])
    from _torch_parity import to_numpy_tree
    from repro.configs import get_config
    from repro.launch.specs import make_batch
    from repro.models import model as M
    out = {}
    for arch in %(archs)r:
        cfg = get_config(arch).reduced(n_layers=2)
        params = M.init_params(cfg, jax.random.PRNGKey(4))
        batch = make_batch(cfg, %(b)d, %(s)d, "train", seed=6)
        loss, grads = jax.jit(jax.value_and_grad(partial(M.loss_fn,
                                                         cfg=cfg)))(
            params, batch)
        out[arch] = dict(params=to_numpy_tree(params),
                         grads=to_numpy_tree(grads), loss=float(loss))
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""") % {"archs": ARCHS, "b": BATCH, "s": SEQ}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _anchor_run(tmp_path_factory):
    """Starts the reference's run when the module's first test starts."""
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
    run, out = _anchor_run
    rc = run.wait(timeout=600)
    assert rc == 0, (out / "anchor.log").read_text()
    with open(out / "anchor.pkl", "rb") as f:
        return pickle.load(f)


def _loss_and_grads(cfg, params, batch, remat=True):
    flat = leaves(params)
    for x in flat:
        x.requires_grad_(True)
    loss = M.loss_fn(params, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, flat)
    for x in flat:
        x.requires_grad_(False)
    return loss.detach(), grads


def _case(anchor, arch):
    cfg = get_config(arch).reduced(n_layers=2)
    params = bridge.params_from_numpy(anchor[arch]["params"], cfg,
                                      device="cpu")
    batch = make_batch(cfg, BATCH, SEQ, "train", seed=6, device="cpu")
    return cfg, params, batch


def _grad_errors(cfg, ref_grads, grads):
    want = bridge.params_from_numpy(ref_grads, cfg, device="cpu")
    out = {}
    for (path, w), g in zip(leaves_with_paths(want), grads):
        assert w.dtype == g.dtype, path
        w, g = w.float(), g.float()
        out["/".join(map(str, path))] = (
            (g - w).norm() / w.norm().clamp(min=1e-30)).item()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_identical(arch):
    cfg = get_config(arch).reduced(n_layers=2)
    params = M.init_params(cfg, seed=1, device="cpu")
    batch = make_batch(cfg, BATCH, 24, "train", seed=2, device="cpu")
    la, ga = _loss_and_grads(cfg, params, batch, remat=True)
    lb, gb = _loss_and_grads(cfg, params, batch, remat=False)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_encoder_remat_checkpoints_each_block(monkeypatch):
    """``encode_frames(remat=True)`` runs one checkpoint an encoder block;
    the forward asks for it only under autograd without caches."""
    calls = []
    real = M.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(M, "checkpoint", counting)
    cfg = get_config("seamless-m4t-medium").reduced(n_layers=2)
    params = M.init_params(cfg, seed=1, device="cpu")
    batch = make_batch(cfg, 1, 16, "train", seed=2, device="cpu")
    _loss_and_grads(cfg, params, batch, remat=True)
    assert calls.count("block") == cfg.enc_layers
    calls.clear()
    with torch.no_grad():
        M.loss_fn(params, batch, cfg)
    assert calls == []


def test_training_runs_no_serving_branch(monkeypatch):
    """Under training the cross K/V come from the memory: the slot-row
    write, the packed quantization and the packed read (K6) never run."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L

    def banned(*args, **kw):
        raise AssertionError("a serving-only branch ran under training")

    for owner, name in ((L, "_write_cross_slots"), (ops, "quantize_kv"),
                        (ops, "ring_kv_cache_attention")):
        monkeypatch.setattr(owner, name, banned)
    cfg = get_config("seamless-m4t-medium").reduced(n_layers=2)
    params = M.init_params(cfg, seed=1, device="cpu")
    batch = make_batch(cfg, 1, 16, "train", seed=2, device="cpu")
    loss, grads = _loss_and_grads(cfg, params, batch)
    assert torch.isfinite(loss) and len(grads) == len(leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(anchor, arch):
    cfg, params, batch = _case(anchor, arch)
    assert ("patch_embeds" in batch) == (arch == "qwen2-vl-7b")
    assert ("frames" in batch) == (arch == "seamless-m4t-medium")
    loss, grads = _loss_and_grads(cfg, params, batch)
    assert abs(float(loss) - anchor[arch]["loss"]) <= LOSS_TOL, (
        float(loss), anchor[arch]["loss"])
    errs = _grad_errors(cfg, anchor[arch]["grads"], grads)
    assert max(errs.values()) <= GRAD_TOL, errs
    named = dict(zip(["/".join(map(str, p)) for p, _ in
                      leaves_with_paths(params)], grads))
    if arch == "seamless-m4t-medium":
        # gradients reach the encoder, the frontend and the cross K/V
        reach = [k for k in named if k.startswith(("encoder/", "cross/"))
                 and ("frontend" in k or "/layers/" in k or "/wk/" in k
                      or "/wv/" in k)]
        assert any(k.startswith("encoder/frontend") for k in reach)
        assert any("/wk/" in k and k.startswith("cross/") for k in reach)
        assert all(float(named[k].float().abs().max()) > 0 for k in reach)


@pytest.mark.parametrize("arch,drop", [("qwen2-vl-7b", "patch_embeds"),
                                       ("seamless-m4t-medium", "frames")])
def test_loss_without_the_stub_frontend_misses_the_bar(anchor, arch, drop):
    """Negative witness: the patch embeddings dropped, or the frames
    zeroed (the enc-dec forward needs its memory)."""
    cfg, params, batch = _case(anchor, arch)
    if drop == "patch_embeds":
        del batch["patch_embeds"]
    else:
        batch["frames"] = torch.zeros_like(batch["frames"])
    with torch.no_grad():
        loss = M.loss_fn(params, batch, cfg)
    assert abs(float(loss) - anchor[arch]["loss"]) > LOSS_TOL
