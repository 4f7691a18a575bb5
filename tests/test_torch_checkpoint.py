"""The port's checkpointing and trainer on the CPU: the reference's
training-stack tests (``tests/test_train.py``) on ``repro_torch``, and
checkpoints read across the two packages bit for bit.

Reduced llama3-8b (2 layers), ``seq_len`` 32, batch 4, as the
reference's tests train it.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as RCM
from repro_torch.checkpoint import manager as CM
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataSpec
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.train.trainer import (SimulatedPreemption, TrainConfig,
                                       Trainer)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its steps are many
    small ops, and under a parallel test run a pool of threads a worker
    waits at every op's barrier for cores the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(tmp, **tkw):
    cfg = get_config("llama3-8b").reduced(n_layers=2)
    spec = DataSpec(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    tcfg = TrainConfig(num_steps=12, ckpt_dir=str(tmp), ckpt_every=5,
                       warmup_steps=2, peak_lr=1e-3, **tkw)
    return cfg, spec, tcfg


def _trainer(cfg, tcfg, spec):
    return Trainer(cfg, tcfg, spec, async_ckpt=False, device="cpu")


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


# --- checkpoint manager ------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones((2,), dtype=torch.int8),
                  torch.zeros((), dtype=torch.int32)],
            "c": (torch.arange(4, dtype=torch.float32) / 3).to(
                torch.bfloat16)}


def test_checkpoint_roundtrip_and_keep(tmp_path):
    tree = _tree()
    for step in (1, 2, 3, 4):
        CM.save_tree(tree, str(tmp_path), step, keep=2)
    assert CM.all_steps(str(tmp_path)) == [3, 4]
    out, meta = CM.restore_tree(tree, str(tmp_path))
    assert meta["step"] == 4 and meta["dtypes"] == {"c": "bfloat16"}
    assert all(_same_bits(a, b) for a, b in zip(leaves(tree), leaves(out)))


def test_checkpoint_tmp_dir_never_visible(tmp_path):
    CM.save_tree({"x": torch.ones(3)}, str(tmp_path), 7)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    """The manager copies every leaf to the host before it returns: an
    in-place update right after ``maybe_save`` does not reach the file."""
    tree = {"w": torch.zeros(64, 64)}
    mgr = CM.CheckpointManager(str(tmp_path), interval=1, async_save=True)
    assert mgr.maybe_save(tree, 1)
    tree["w"].add_(1.0)
    mgr.wait()
    out, _ = mgr.restore(tree)
    assert float(out["w"].abs().max()) == 0.0


# --- checkpoints across the two packages -------------------------------------

_VALUES = {"f32": np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4),
           "i8": np.array([-127, -1, 0, 5, 127], np.int8),
           "bf16": np.array([0.1, -2.5, 3e-8, 65280.0], np.float32)}


def _port_small_tree():
    return {"w": torch.from_numpy(_VALUES["bf16"]).to(torch.bfloat16),
            "moments": [torch.from_numpy(_VALUES["i8"]),
                        torch.from_numpy(_VALUES["f32"])],
            "step": torch.tensor(7, dtype=torch.int32)}


def _jax_small_tree():
    return {"w": jnp.asarray(_VALUES["bf16"]).astype(jnp.bfloat16),
            "moments": [jnp.asarray(_VALUES["i8"]),
                        jnp.asarray(_VALUES["f32"])],
            "step": jnp.int32(7)}


def _bits(x):
    """A leaf of either package as its raw bytes and dtype name."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), name
    return np.asarray(x).tobytes(), np.asarray(x).dtype.name


def test_port_checkpoint_is_read_by_the_reference(tmp_path):
    port = _port_small_tree()
    CM.save_tree(port, str(tmp_path), 3)
    out, meta = RCM.restore_tree(_jax_small_tree(), str(tmp_path))
    assert meta["step"] == 3
    got = [_bits(x) for x in jax.tree.leaves(out)]
    assert got == [_bits(x) for x in leaves(port)]
    assert [n for _, n in got] == ["int8", "float32", "int32", "bfloat16"]


def test_reference_checkpoint_is_read_by_the_port(tmp_path):
    ref = _jax_small_tree()
    RCM.save_tree(ref, str(tmp_path), 5)
    out, meta = CM.restore_tree(_port_small_tree(), str(tmp_path))
    assert meta["step"] == 5
    assert [_bits(x) for x in leaves(out)] == \
        [_bits(x) for x in jax.tree.leaves(ref)]


# --- trainer: restart & fault tolerance --------------------------------------

@pytest.mark.parametrize("state_bits", [None, 8])
def test_restart_is_bit_exact(tmp_path, state_bits):
    """12 steps straight vs 6 + restart + 6: identical losses, params and
    optimizer state (f32 and int8 moments)."""
    adamw = AdamWConfig(state_bits=state_bits)
    cfg, spec, tcfg = _tiny(tmp_path / "a", adamw=adamw)
    state_full, hist_full = _trainer(cfg, tcfg, spec).run(resume=False)

    cfg2, spec2, tcfg2 = _tiny(tmp_path / "b", adamw=adamw)
    tcfg2.num_steps = 6
    _trainer(cfg2, tcfg2, spec2).run(resume=False)
    tcfg3 = TrainConfig(**{**tcfg2.__dict__, "num_steps": 12})
    state_resumed, hist_resumed = _trainer(cfg2, tcfg3, spec2).run(
        resume=True)

    assert hist_full[6:] == hist_resumed
    assert all(_same_bits(a, b) for a, b in zip(leaves(state_full),
                                                leaves(state_resumed)))


def test_preemption_recovery(tmp_path):
    cfg, spec, tcfg = _tiny(tmp_path, preempt_at=7)
    t = _trainer(cfg, tcfg, spec)
    with pytest.raises(SimulatedPreemption):
        t.run(resume=False)
    assert t.ckpt.latest_step() == 7
    # recover: a fresh trainer resumes from step 7 and completes
    tcfg2 = TrainConfig(**{**tcfg.__dict__, "preempt_at": None})
    state, hist = _trainer(cfg, tcfg2, spec).run(resume=True)
    assert len(hist) == 12 - 7
    assert int(state["opt"].step) == 12


def test_straggler_watchdog_detects_slow_steps(tmp_path):
    cfg, spec, tcfg = _tiny(tmp_path)
    tcfg.ckpt_every = 0
    t = _trainer(cfg, tcfg, spec)
    for i, dt in enumerate([0.1] * 10 + [0.9] + [0.1] * 5):
        t._watchdog(i, dt)
    assert len(t.straggler_events) == 1
    assert t.straggler_events[0]["step"] == 10


def test_microbatch_equals_full_batch(tmp_path):
    """Gradient accumulation (A=2, f32 sums) must match the single-batch
    step, within the reference test's bars."""
    cfg, spec, tcfg = _tiny(tmp_path / "m1")
    tcfg.num_steps = 3
    tcfg.ckpt_every = 0
    sA, hA = _trainer(cfg, tcfg, spec).run(resume=False)
    tcfgB = TrainConfig(**{**tcfg.__dict__, "microbatches": 2,
                           "ckpt_dir": str(tmp_path / "m2")})
    sB, hB = _trainer(cfg, tcfgB, spec).run(resume=False)
    np.testing.assert_allclose(hA, hB, rtol=2e-2)
    for a, b in zip(leaves(sA["params"]), leaves(sB["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=0.05, atol=1e-2)


def test_microbatch_gradients_are_f32_means(tmp_path):
    """With A > 1 the gradients handed to the optimizer are f32 (the sum
    from f32 zeros, divided by A); with A = 1 they keep the parameters'
    dtypes."""
    seen = {}
    for a in (1, 2):
        cfg, spec, tcfg = _tiny(tmp_path / str(a), microbatches=a)
        tcfg.num_steps = 1
        tcfg.ckpt_every = 0

        def record(grads, a=a):
            seen[a] = {x.dtype for x in leaves(grads)}
            return grads

        t = Trainer(cfg, tcfg, spec, async_ckpt=False, device="cpu",
                    grad_transform=record)
        t.run(resume=False)
    assert seen[1] == {torch.bfloat16, torch.float32}
    assert seen[2] == {torch.float32}


def test_loss_decreases_on_learnable_stream(tmp_path):
    cfg, spec, tcfg = _tiny(tmp_path)
    tcfg.num_steps = 30
    tcfg.ckpt_every = 0
    _, hist = _trainer(cfg, tcfg, spec).run(resume=False)
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) - 0.3


def test_trainer_defaults_to_the_card_and_its_own_checkpoint_dir(tmp_path):
    cfg, spec, _ = _tiny(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, TrainConfig(), spec)
    a = Trainer(cfg, TrainConfig(), spec, device="cpu")
    b = Trainer(cfg, TrainConfig(), spec, device="cpu")
    # nothing is made on disk before the first save
    assert a.ckpt.directory is None and a.ckpt.latest_step() is None
    tree = {"w": torch.arange(3.0)}
    try:
        for t in (a, b):
            t.ckpt.maybe_save(tree, 1, force=True)
            t.ckpt.wait()
        assert a.ckpt.directory != b.ckpt.directory
        assert a.ckpt.latest_step() == b.ckpt.latest_step() == 1
    finally:
        for t in (a, b):
            if t.ckpt.directory is not None:
                shutil.rmtree(t.ckpt.directory)
