"""The port's sharding rules against the reference's, leaf by leaf.

One reference subprocess (``XLA_FLAGS=--xla_force_host_platform_device_
count=512``, no compile) builds the reference's meshes -- the production
(16, 16) and (2, 16, 16) and the host (4, 2) and (2, 4) -- and calls
``shardings_for_params`` (float and ``quantize_params``'d trees),
``shardings_for_caches`` (float and packed KV) and ``shardings_for_batch``
(every ``SHAPES`` cell's ``input_specs``) on ``jax.eval_shape`` trees of
every arch at full size, in both MoE modes; it writes each leaf's path,
shape, dtype and ``.spec`` as JSON.

The port's rules take the same meshes as :class:`MeshShape` (names and
sizes, no process group) and must give:

* on meta trees laid out as the reference's (its paths and shapes; packed
  uint32 words as the port's int32): the reference's spec for every leaf;
* on the port's own trees (``init_params``/``init_caches`` on ``meta``:
  one entry a layer, no stack axis; ``input_specs``): the reference's spec
  of the matching leaf with its stack axis dropped.  One class of leaves
  differs, and the test pins it: in EP mode the reference reads the stack
  axis of a *dense* FFN's ``(n_units, d_ff, d)`` weight as an expert axis
  (its rule keys on ``w_up``/``w_gate``/``w_down`` and ``ndim >= 3``) and
  shards it over "model" when the unit count divides; the port's
  per-layer ``(d_ff, d)`` weight takes the column/row rule (ROADMAP
  queue 3).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.tree import leaves_with_paths
from repro_torch.distributed import sharding as S
from repro_torch.launch import specs as LS
from repro_torch.launch.mesh import MeshShape, production_shape
from repro_torch.models import model as M
from repro_torch.models.config import QuantConfig

MESHES = {"prod": production_shape(),
          "multipod": production_shape(multi_pod=True),
          "host42": ((4, 2), ("data", "model")),
          "host24": ((2, 4), ("data", "model"))}
CACHE_B, CACHE_LEN, ENC_LEN = 16, 1024, 128

_REFERENCE = textwrap.dedent(r"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from functools import partial
    import jax, numpy as np
    from repro.configs import get_config
    from repro.distributed import sharding as S
    from repro.launch import specs as LS
    from repro.models import model as M
    from repro.models.config import QuantConfig
    meshes = json.loads(sys.argv[2])
    B, L, E = (int(a) for a in sys.argv[3:6])
    archs = sys.argv[6].split(",")

    def keyof(p):
        for attr in ("key", "name", "idx"):
            v = getattr(p, attr, None)
            if v is not None:
                return v
        return None

    def spec(entry):
        return [list(e) if isinstance(e, tuple) else e for e in entry]

    def records(tree, shard):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        shd = jax.tree.leaves(shard)
        return [[[keyof(p) for p in path], list(leaf.shape),
                 str(leaf.dtype), spec(s.spec)]
                for (path, leaf), s in zip(flat, shd)]

    out = {}
    for arch in archs:
        cfg = get_config(arch)
        params = jax.eval_shape(partial(M.init_params, cfg),
                                jax.random.PRNGKey(0))
        qparams = jax.eval_shape(partial(
            M.quantize_params, qcfg=QuantConfig(w_bits=4, a_bits=8)), params)
        enc = dict(enc_len=E) if cfg.family == "audio" else {}
        caches = {
            "caches_f": jax.eval_shape(lambda: M.init_caches(cfg, B, L,
                                                             **enc)),
            "caches_q": jax.eval_shape(lambda: M.init_caches(
                cfg, B, L, quant=QuantConfig(kv_bits=8), **enc))}
        batches = {"batch:" + s: LS.input_specs(cfg, s) for s in LS.SHAPES}
        for mname, (shape, names) in meshes.items():
            mesh = jax.make_mesh(tuple(shape), tuple(names))
            for mode in ("ep", "tp"):
                S.set_moe_mode(mode)
                rec = {"params": records(params, S.shardings_for_params(
                           mesh, params)),
                       "qparams": records(qparams, S.shardings_for_params(
                           mesh, qparams))}
                for k, c in caches.items():
                    rec[k] = records(c, S.shardings_for_caches(mesh, c))
                for k, b in batches.items():
                    rec[k] = records(b, S.shardings_for_batch(mesh, b))
                out[f"{arch}|{mname}|{mode}"] = rec
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


# the reference's abstract quantize takes most of its time (jamba's ~11
# s): three subprocesses, each a share of the archs
_SPLIT = (("jamba-1.5-large-398b", "mamba2-130m", "minicpm-2b"),
          ("deepseek-moe-16b", "seamless-m4t-medium", "stablelm-3b"),
          ("mixtral-8x7b", "glm4-9b", "llama3-8b", "qwen2-vl-7b"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    assert sorted(a for part in _SPLIT for a in part) == sorted(ARCHS)
    out = tmp_path_factory.mktemp("rules")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=src)
    runs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(out / f"specs{i}.json"),
         json.dumps(MESHES), str(CACHE_B), str(CACHE_LEN), str(ENC_LEN),
         ",".join(part)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for i, part in enumerate(_SPLIT)]
    specs = {}
    for i, r in enumerate(runs):
        log, _ = r.communicate(timeout=600)
        assert r.returncode == 0, log[-3000:]
        with open(out / f"specs{i}.json") as f:
            specs.update(json.load(f))
    return specs


def _spec(entry):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entry)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32, "uint32": torch.int32, "int8": torch.int8}


def _meta_tree(records):
    """Meta tensors at the reference's paths (dict keys and list
    indices; packed uint32 words as int32, the port's packed dtype)."""
    root: dict = {}
    for path, shape, dtype, _ in records:
        node = root
        for k, nk in zip(path[:-1], path[1:]):
            new = [] if isinstance(nk, int) else {}
            if isinstance(node, dict):
                node = node.setdefault(k, new)
            else:
                while len(node) <= k:
                    node.append(None)
                if node[k] is None:
                    node[k] = new
                node = node[k]
        leaf = torch.empty(shape, dtype=_DTYPES[dtype], device="meta")
        if isinstance(node, dict):
            node[path[-1]] = leaf
        else:
            while len(node) <= path[-1]:
                node.append(None)
            node[path[-1]] = leaf
    return root


def _rule(kind):
    if kind in ("params", "qparams"):
        return S.shardings_for_params
    if kind.startswith("caches"):
        return S.shardings_for_caches
    return S.shardings_for_batch


def _spec_items(node, prefix=()):
    """(path, spec) pairs of a spec tree, whose leaves are tuples."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _spec_items(v, prefix + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _spec_items(v, prefix + (i,))
    elif node is not None:
        yield prefix, node


@pytest.fixture(autouse=True)
def _ep_mode():
    yield
    S.set_moe_mode("ep")


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_on_the_references_trees(reference, arch):
    n = 0
    for mname, (shape, names) in MESHES.items():
        mesh = MeshShape(shape, names)
        for mode in ("ep", "tp"):
            S.set_moe_mode(mode)
            for kind, recs in reference[f"{arch}|{mname}|{mode}"].items():
                got = dict(_spec_items(_rule(kind)(mesh, _meta_tree(recs))))
                assert len(got) == len(recs), (kind, len(got), len(recs))
                for path, _, _, spec in recs:
                    want = _spec(spec)
                    assert got[tuple(path)] == want, (mname, mode, kind,
                                                      path, want)
                    n += 1
    assert n > 200


def _ref_path(cfg, path, kind):
    """The reference leaf of the port's leaf at ``path`` and the number of
    stack axes it leads with."""
    prelude, unit, _ = M.plan_split(cfg)
    fd, ul = len(prelude), len(unit)
    path = list(path)
    if path[0] == "layers":
        j = path[1]
        if j < fd:
            return ["prelude", j] + path[2:], 0
        return ["blocks", (j - fd) % ul] + path[2:], 1
    if path[0] == "cross":
        if kind == "params":
            return ["cross"] + path[2:], 1
        return ["cross", path[1] % ul] + path[2:], 1
    if path[:2] == ["encoder", "layers"]:
        return ["encoder", "blocks"] + path[3:], 1
    return path, 0


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_on_the_ports_own_trees(reference, arch):
    cfg = get_config(arch)
    trees = {
        "params": M.init_params(cfg, device="meta"),
        "caches_f": M.init_caches(cfg, CACHE_B, CACHE_LEN, device="meta",
                                  enc_len=ENC_LEN),
        "caches_q": M.init_caches(cfg, CACHE_B, CACHE_LEN, device="meta",
                                  quant=QuantConfig(kv_bits=8),
                                  enc_len=ENC_LEN)}
    trees.update({"batch:" + s: LS.input_specs(cfg, s) for s in LS.SHAPES})
    n = stack_read = 0
    for mname, (shape, names) in MESHES.items():
        mesh = MeshShape(shape, names)
        for mode in ("ep", "tp"):
            S.set_moe_mode(mode)
            rec = reference[f"{arch}|{mname}|{mode}"]
            for kind, tree in trees.items():
                want = {tuple(p): (_spec(s), shp, dt)
                        for p, shp, dt, s in rec[kind]}
                got = dict(_spec_items(_rule(kind)(mesh, tree)))
                leaf_of = dict(leaves_with_paths(tree))
                for path, spec in got.items():
                    rpath, k = _ref_path(cfg, path, kind.split("_")[0])
                    rspec, rshape, rdt = want[tuple(rpath)]
                    leaf = leaf_of[path]
                    assert list(leaf.shape) == rshape[k:], (path, rpath)
                    assert _DTYPES[rdt] == leaf.dtype, (path, rdt)
                    n += 1
                    if rspec[:k] != (None,) * k:
                        # the reference shards a dense FFN's stack axis
                        assert kind == "params" and mode == "ep" and \
                            rspec[0] == "model" and \
                            path[-2] in ("w_up", "w_gate", "w_down") and \
                            leaf.ndim == 2, (path, rspec)
                        rule = ("model", "data") if path[-2] != "w_down" \
                            else ("data", "model")
                        assert spec == S._fit(mesh, tuple(leaf.shape), rule)
                        stack_read += 1
                        continue
                    assert spec == rspec[k:], (mname, mode, kind, path,
                                               rspec)
    assert n > 500
    if arch == "llama3-8b":
        # 32 units divide every mesh's model axis: w_up, w_gate and
        # w_down of each of the 32 layers on each of the four meshes, in
        # EP mode
        assert stack_read == 32 * 3 * 4
