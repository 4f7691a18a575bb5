"""The port's input specs against the reference's ``repro.launch.specs``:
``make_batch`` bit for bit (every arch, train / prefill / decode),
``input_specs`` shapes and dtypes and ``cell_runnable`` for every arch x
``SHAPES`` cell; and the production meshes of ``launch.mesh``."""

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import specs as RS
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as PS


def _bits(x):
    """An array's bits as numpy (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_is_the_references_bit_for_bit(arch, mode):
    want = RS.make_batch(ref_config(arch), 2, 24, mode, seed=7)
    got = PS.make_batch(get_config(arch), 2, 24, mode, seed=7, device="cpu")
    assert list(got) == list(want)              # the draw order too
    for k in want:
        w, g = _bits(want[k]), _bits(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_make_batch_other_seed_differs():
    cfg = get_config("seamless-m4t-medium")
    a = PS.make_batch(cfg, 2, 24, "train", seed=1, device="cpu")
    b = PS.make_batch(cfg, 2, 24, "train", seed=2, device="cpu")
    assert not torch.equal(a["frames"], b["frames"])


def test_make_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.make_batch(get_config("llama3-8b"), 1, 8)


_DT = {torch.int32: "int32", torch.bfloat16: "bfloat16",
       torch.float32: "float32"}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_runnable_cells(arch):
    rcfg, cfg = ref_config(arch), get_config(arch)
    assert list(PS.SHAPES) == list(RS.SHAPES)
    for name in RS.SHAPES:
        assert PS.SHAPES[name] == RS.SHAPES[name]
        assert PS.cell_runnable(cfg, name)[0] == \
            RS.cell_runnable(rcfg, name)[0]
        want = RS.input_specs(rcfg, name)
        got = PS.input_specs(cfg, name)
        assert list(got) == list(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape), (name, k)
            assert _DT[got[k].dtype] == str(spec.dtype), (name, k)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_process_group(multi_pod):
    """Built only when called, over a started group of its size: without
    one it raises (and never falls back to fewer ranks or to gloo)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as LM
    assert not dist.is_initialized()
    n = 512 if multi_pod else 256
    with pytest.raises(RuntimeError, match=f"process group of {n} ranks"):
        LM.make_production_mesh(multi_pod=multi_pod)
    shape = LM.MeshShape(*LM.production_shape(multi_pod=multi_pod))
    assert LM.mesh_sizes(shape) == dict(
        zip(shape.mesh_dim_names, (2, 16, 16) if multi_pod else (16, 16)))
    assert LM.dp_axes(shape) == (("pod", "data") if multi_pod
                                 else ("data",))
