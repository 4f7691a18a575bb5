"""The kernel build cache of ``repro_torch.kernels._build`` (no ``nvcc``
needed): a library's name hashes its source, the ``csrc/*.cuh`` headers
the source includes and the flags, so that an edited header -- the b1
core (K1, K4 and K5; K2 takes its cp.async helpers), the int8
plane-group steps (K1, K4, K5), the int8 tensor-core chunk GEMM (K1,
K4, K5), the small-M GEMM (K1, K5), the
split-KV combine (K2, K6/K7), the bipolar-KV attention kernel (K2, K6)
or the quantize-and-pack (K3 and, through the b1 core, every source that
includes it) -- rebuilds every source that includes it and nothing
else."""

import pytest

import os
import shutil

from repro_torch.kernels import _build


def _copy_csrc(tmp_path, monkeypatch):
    for name in os.listdir(_build._CSRC):
        shutil.copy(os.path.join(_build._CSRC, name), tmp_path / name)
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    return tmp_path


def test_sources_that_include_the_core_list_it():
    core = ["bitserial_core.cuh", "int8_core.cuh", "int8_mma.cuh"]
    for name, extra in (("apmm_fused_linear", ["small_m.cuh"]),
                        ("apmm_packed", ["small_m.cuh"]),
                        ("moe_expert_linear", [])):
        src = _build._target(name)[0]
        assert [os.path.basename(p) for p in _build._sources_of(src)] == \
            [f"{name}.cu"] + core + extra + ["pack_core.cuh"]
    for name, headers in (("pack", ["pack_core.cuh"]),
                          ("paged_attention", ["bipolar_attention.cuh",
                                               "bitserial_core.cuh",
                                               "split_kv.cuh",
                                               "pack_core.cuh"]),
                          ("flash_attention", ["bipolar_attention.cuh",
                                               "split_kv.cuh",
                                               "bitserial_core.cuh",
                                               "pack_core.cuh"])):
        assert [os.path.basename(p) for p in _build._sources_of(
            _build._target(name)[0])] == [f"{name}.cu"] + headers


def test_editing_a_header_renames_the_libraries_that_include_it(
        tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    names = _build.sources()
    before = {n: _build._target(n)[2] for n in names}
    assert before == {n: _build._target(n)[2] for n in names}   # stable
    header = csrc / "bitserial_core.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n)[2] for n in names}
    changed = {n for n in names if after[n] != before[n]}
    assert changed == {"apmm_fused_linear", "apmm_packed",
                       "moe_expert_linear", "paged_attention",
                       "flash_attention"}


def test_editing_the_int8_core_renames_the_libraries_that_include_it(
        tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    names = _build.sources()
    before = {n: _build._target(n)[2] for n in names}
    header = csrc / "int8_core.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n)[2] for n in names}
    assert {n for n in names if after[n] != before[n]} == {
        "apmm_fused_linear", "apmm_packed", "moe_expert_linear"}


@pytest.mark.parametrize("header,users", [
    ("small_m.cuh", {"apmm_fused_linear", "apmm_packed"}),
    ("int8_mma.cuh", {"apmm_fused_linear", "apmm_packed",
                      "moe_expert_linear"}),
    ("split_kv.cuh", {"paged_attention", "flash_attention"}),
    ("bipolar_attention.cuh", {"paged_attention", "flash_attention"}),
    ("pack_core.cuh", {"pack", "apmm_fused_linear", "apmm_packed",
                       "moe_expert_linear", "paged_attention",
                       "flash_attention"})])
def test_editing_a_shared_route_header_renames_its_users(
        tmp_path, monkeypatch, header, users):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    names = _build.sources()
    before = {n: _build._target(n)[2] for n in names}
    path = csrc / header
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n)[2] for n in names}
    assert {n for n in names if after[n] != before[n]} == users


def test_editing_a_source_renames_only_its_library(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    names = _build.sources()
    before = {n: _build._target(n)[2] for n in names}
    src = csrc / "pack.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    after = {n: _build._target(n)[2] for n in names}
    assert {n for n in names if after[n] != before[n]} == {"pack"}
