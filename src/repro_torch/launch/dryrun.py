"""Dry run: every (arch x shape x mesh) cell traced on meta tensors over a
fake process group of 256 or 512 ranks.

The counterpart of the reference's ``launch/dryrun.py``, which lowers
and compiles each cell on 512 placeholder XLA devices.  Here the
placeholder devices are a ``"fake"`` process group (``FakeStore``, rank
0: its collectives move nothing) with the production mesh of
:func:`repro_torch.launch.mesh.production_shape` over it, and every
tensor is a ``meta`` tensor: nothing is allocated and nothing launches.
A fake group's world size is fixed when it starts, so each mesh runs in
a process of its own: ``--mesh both`` runs this module once for
``single`` (256 ranks) and once for ``multi`` (512 ranks).  A fake group
and an NCCL one cannot share a process either: call it in a subprocess
from one that starts another group.

Run it from the repository root::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--out DIR] [--force]
        [--opt kv8,bitserial,...]

Each cell writes ``{out}/{arch}__{shape}__{pod256|pod512}[__opt-...]
.json`` (the reference's cell ids; a cell whose file says ``ok`` or
``skipped`` is not run again without ``--force``) and prints one line;
the exit code is 1 if any cell failed.

A train cell is the port's own step: ``init_params`` and ``adamw_init``
(int8 moments) sharded by ``shardings_for_params``, the batch by
``shardings_for_batch``, then one :func:`repro_torch.distributed
.sharding.sharded_step` (forward, backward with the recompute of every
checkpointed unit, the gradients' reduce-scatter) and one
``adamw_update`` of the local shards at the WSD schedule's lr.  A serve
cell quantizes the parameters (``quantize_params``), makes the caches
(``init_caches``), shards both (``shardings_for_caches``) and runs one
``prefill_step`` or ``serve_step`` through
:func:`~repro_torch.distributed.sharding.sharded_serve_step`; the
quantized kernels take their meta route (:mod:`repro_torch.kernels
.meta`), which counts their work from shapes: K4's segments are taken
as full (``moe_rows: "capacity"`` in the record).  The serve step is
tensor-, sequence- and expert-parallel over "model"
(:mod:`repro_torch.distributed.tensor_parallel`'s serve mode): each
block's weights gathered over the DP axes at its use with the "model"
shard kept, column products on the rank's rows, row products on its
K-shard, decode attention over the rank's slots of the caches, which
stay on their sequence shard; a prefill gathers one layer's cache at a
time.

The record, for rank 0 (every rank's shards have one shape):

* ``memory``: ``param_bytes``, ``opt_bytes``, ``batch_bytes`` and
  ``cache_bytes``, the bytes of each argument tree's local shards,
  exactly, and ``argument_bytes``, their sum; ``gathered_bytes``, the
  most bytes of gathered weights alive at once in the step, counted by
  its gathers (a train cell's units gather theirs inside the
  checkpoint, a serve cell's blocks at their use; each freed after
  it); ``peak_bytes``, an estimate
  of the step's peak: the arguments plus the most bytes of storage that
  the step's own ops held live at once (every op's new storages, each
  counted until it is freed, views counted with their base).  It leaves
  out the allocator's rounding and fragmentation, the kernels' own
  workspaces (K1's small-M buffer, split-KV partials), library
  workspaces (cuBLAS), the CUDA context and NCCL's buffers.
* ``flops``: the floating-point FLOPs of the step's products by
  ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s table),
  by the dtype of the first operand; the recompute of the checkpointed
  units is counted, as it runs.
* ``int_ops``: K1's, K4's and K5's integer (or b1) operations, by
  kernel; ``kernels``: every kernel call's count, operations and bytes
  (``load_kernels``: K3 at ``quantize_params``).
* ``collectives``: count and bytes (the larger of a call's input and
  output, on this rank) by collective.
* ``fallbacks`` (a serve cell): the named fallbacks its step took
  (whole heads, a row product whole, the SSM mixer whole, experts whole
  on dispatch-row shards, ...); the residual stream is whole over
  "model" in every serve cell.

The reference's ``hlo`` block (XLA's op names and ``cost_analysis``)
has no counterpart and is left out.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.bipolar import BipolarTensor
from repro_torch.core.tree import leaves
from repro_torch.distributed import sharding as S
from repro_torch.kernels import meta as kmeta
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.specs import SHAPES, _token_specs, cell_runnable
from repro_torch.models import model as M
from repro_torch.models.config import QuantConfig
from repro_torch.optim.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, wsd_schedule)
from repro_torch.serving import engine as E

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT_DIR = os.environ.get("DRYRUN_OUT", os.path.join(ROOT, "build", "dryrun"))
OPTS = ("moe_tp", "attn_chunks", "kv8", "bf16serve", "bitserial",
        "attn_bf16")
GIB = 2 ** 30


# ---------------------------------------------------------------------------
# the placeholder devices
# ---------------------------------------------------------------------------

def start_fake_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks in this process, as
    rank 0 (once; another world size raises)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks is running; the dry run needs "
                               f"{world}: run it in a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(shape, names):
    """A DeviceMesh of ``shape`` over a fake group of its size."""
    import math
    from torch.distributed.device_mesh import init_device_mesh
    start_fake_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def production_mesh(multi_pod: bool):
    return fake_mesh(*production_shape(multi_pod=multi_pod))


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    out = []
    for leaf in leaves(tree):
        if isinstance(leaf, BipolarTensor):
            out += [t for t in (leaf.packed, leaf.scale, leaf.width_scales)
                    if t is not None]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor of ``tree``."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(tree))


def n_tensors(tree) -> int:
    return len(_tensors(tree))


# ---------------------------------------------------------------------------
# the step's counters
# ---------------------------------------------------------------------------

_COLLECTIVE_NS = ("_c10d_functional", "c10d")


class StepCounter(TorchDispatchMode):
    """A dispatch mode over one step: the live bytes of the storages its
    ops make (the most at once: ``peak``), the FLOPs of its products by
    ``torch.utils.flop_counter``'s table (by the dtype of the first
    operand), and its collectives.  ``arguments``' storages exist before
    the step and are not counted."""

    def __init__(self, arguments=()):
        super().__init__()
        self.live = self.peak = 0
        self.flops: dict = {}
        self.collectives: dict = {}
        self._seen = {_local(t).untyped_storage()._cdata: None
                      for t in arguments}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pk = func._overloadpacket
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        fl = flop_registry.get(pk)
        if fl is not None:
            first = next(t for t in tree_leaves(args)
                         if isinstance(t, torch.Tensor))
            key = str(first.dtype).removeprefix("torch.")
            self.flops[key] = self.flops.get(key, 0) + int(
                fl(*args, **kwargs, out_val=out))
        ns, name = pk._qualified_op_name.split("::")
        if ns in _COLLECTIVE_NS and not name.startswith(("_", "wait")):
            ins = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
            n = max(sum(_local(t).numel() * _local(t).element_size()
                        for t in ts) for ts in (ins, outs))
            e = self.collectives.setdefault(name, [0, 0])
            e[0] += 1
            e[1] += n
        for t in outs:
            st = _local(t).untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = weakref.ref(
                st, functools.partial(_freed, weakref.ref(self), key, n))
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def _freed(ref, key, n, _):
    """A counted storage was freed."""
    counter = ref()
    if counter is not None:
        counter.live -= n
        counter._seen.pop(key, None)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def cell_config(arch: str, opts=()):
    """``arch``'s config with the levers of ``opts`` (the reference's:
    the KV format pinned, ``kv8`` its 8-bit bipolar cache).
    ``attn_chunks`` is a lever of the activation rules, not of the
    config (:func:`measure` installs it)."""
    bad = sorted(set(opts) - set(OPTS))
    if bad:
        raise ValueError(f"unknown --opt {bad}; the levers are {OPTS}")
    cfg = get_config(arch)
    kv = 8 if "kv8" in opts else None
    cfg = dataclasses.replace(cfg, kv_bits=kv,
                              quant=dataclasses.replace(cfg.quant,
                                                        kv_bits=kv))
    if "bf16serve" in opts:
        cfg = dataclasses.replace(cfg, quant=QuantConfig(w_bits=None))
    if "bitserial" in opts:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, variant="bitserial"))
    if "attn_bf16" in opts:
        cfg = dataclasses.replace(cfg, attn_score_bf16=True)
    S.set_moe_mode("tp" if "moe_tp" in opts else "ep")
    return cfg


def _batch(cfg, batch, seq, mode, device, seed=0):
    if device == "meta":
        return _token_specs(cfg, batch, seq, mode)
    from repro_torch.launch.specs import make_batch
    return make_batch(cfg, batch, seq, mode, seed=seed, device=device)


ADAMW = AdamWConfig(state_bits=8)


def train_state(cfg, mesh, batch, seq, *, device="meta", seed=0) -> dict:
    """A train cell's arguments on ``mesh``: ``params`` and ``opt`` (int8
    moments) sharded by ``shardings_for_params``, ``batch`` by
    ``shardings_for_batch``."""
    params = M.init_params(cfg, seed=seed, device=device)
    opt = adamw_init(params, ADAMW)
    pspec = S.shardings_for_params(mesh, params)
    sspec = S.shardings_for_params(mesh, opt.m_scale)
    opt = type(opt)(
        step=opt.step, m=S.shard_tree(opt.m, mesh, pspec),
        v=S.shard_tree(opt.v, mesh, pspec),
        m_scale=S.shard_tree(opt.m_scale, mesh, sspec),
        v_scale=S.shard_tree(opt.v_scale, mesh, sspec))
    params = S.shard_tree(params, mesh, pspec)
    b = _batch(cfg, batch, seq, "train", device, seed)
    return {"params": params, "opt": opt,
            "batch": S.shard_tree(b, mesh, S.shardings_for_batch(mesh, b))}


def train_step(cfg, mesh, state):
    """One sharded step, then AdamW on the local shards (in place).
    Returns the loss and the most bytes of gathered weights the step held
    at once (``sharded_step``'s count)."""
    sched = wsd_schedule(peak_lr=3e-4, warmup_steps=2000,
                         total_steps=100000)
    step = S.sharded_step(functools.partial(M.loss_terms, cfg=cfg), mesh)
    loss, grads = step(state["params"], state["batch"])
    adamw_update(grads, state["opt"], state["params"],
                 lr=sched(state["opt"].step), cfg=ADAMW)
    return loss, step.gathered_bytes


def serve_state(cfg, mesh, batch, seq, mode, *, device="meta",
                seed=0) -> dict:
    """A serve cell's arguments on ``mesh``: the quantized parameters,
    the caches of ``batch`` rows of ``seq`` slots and the step's batch,
    each sharded by its rules.  On meta, ``load_kernels`` holds the
    tally of ``quantize_params``."""
    with kmeta.tally() as load:
        params = M.init_params(cfg, seed=seed, device=device,
                               quant=cfg.quant)
    caches = M.init_caches(cfg, batch, seq, quant=cfg.quant, device=device)
    b = _batch(cfg, batch, seq, mode, device, seed)
    return {"params": S.shard_tree(params, mesh,
                                   S.shardings_for_params(mesh, params)),
            "caches": S.shard_tree(caches, mesh,
                                   S.shardings_for_caches(mesh, caches)),
            "batch": S.shard_tree(b, mesh, S.shardings_for_batch(mesh, b)),
            "load_kernels": load.by_kernel()}


def serve_step(cfg, mesh, state, mode):
    """One sharded prefill or decode step (:func:`repro_torch.distributed
    .sharding.sharded_serve_step`).  Returns its logits, its caches, the
    most bytes of gathered weights it held at once and its named
    fallbacks."""
    fn = E.prefill_step if mode == "prefill" else E.serve_step
    step = S.sharded_serve_step(
        functools.partial(fn, cfg=cfg, quant=cfg.quant), mesh)
    with torch.no_grad():
        logits, caches = step(state["params"], state["batch"],
                              state["caches"])
    return logits, caches, step.gathered_bytes, step.fallbacks


def measure(cfg, mesh, mode, batch, seq, opts=()) -> dict:
    """Build one cell's arguments on meta over ``mesh`` and trace its step
    under the counters: the record's measured fields.  ``opts`` naming
    ``attn_chunks`` installs that activation rule for the step."""
    opts_rules = ("attn_chunks",) if "attn_chunks" in opts else ()
    if mode == "train":
        state = train_state(cfg, mesh, batch, seq)
        args = {"params": state["params"], "opt": state["opt"],
                "batch": state["batch"]}
    else:
        state = serve_state(cfg, mesh, batch, seq, mode)
        args = {k: state[k] for k in ("params", "batch", "caches")}
    mem = {"param_bytes": local_bytes(state["params"]),
           "opt_bytes": local_bytes(state.get("opt")),
           "batch_bytes": local_bytes(state["batch"]),
           "cache_bytes": local_bytes(state.get("caches"))}
    mem["argument_bytes"] = sum(mem.values())
    t0 = time.time()
    S.set_activation_context(mesh, extra=opts_rules)
    with kmeta.tally() as tally, StepCounter(_tensors(args)) as counter:
        if mode == "train":
            mem["gathered_bytes"] = train_step(cfg, mesh, state)[1]
        else:
            _, _, mem["gathered_bytes"], fallbacks = serve_step(
                cfg, mesh, state, mode)
    S.set_activation_context(None)
    mem["peak_bytes"] = mem["argument_bytes"] + counter.peak
    kernels = tally.by_kernel()
    rec = dict(
        trace_s=round(time.time() - t0, 2), memory=mem,
        flops=dict(counter.flops, total=sum(counter.flops.values())),
        int_ops={k: v["ops"] for k, v in kernels.items()
                 if k.split("-")[0] in ("K1", "K4", "K5")},
        kernels=kernels,
        collectives={k: dict(count=c, bytes=b)
                     for k, (c, b) in sorted(counter.collectives.items())})
    if mode != "train":
        rec["fallbacks"] = fallbacks
        rec["load_kernels"] = state["load_kernels"]
        if any(k.startswith("K4") for k in kernels):
            rec["moe_rows"] = "capacity"
    return rec


# ---------------------------------------------------------------------------
# per-cell runner
# ---------------------------------------------------------------------------

def cell_id(arch, shape_name, multi_pod, opts=()) -> str:
    cid = f"{arch}__{shape_name}__{'pod512' if multi_pod else 'pod256'}"
    return cid + ("__opt-" + "-".join(sorted(opts)) if opts else "")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR, quiet: bool = False,
             opts: tuple = ()) -> dict:
    """Run one cell in this process (whose fake group has the mesh's
    size), write its record and return it."""
    cfg = cell_config(arch, opts)
    shape = SHAPES[shape_name]
    mesh_tag = "pod512" if multi_pod else "pod256"
    cid = cell_id(arch, shape_name, multi_pod, opts)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, cid + ".json")
    ok, reason = cell_runnable(cfg, shape_name)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "opts": list(opts),
        "mode": shape["mode"], "seq": shape["seq"], "batch": shape["batch"],
        "n_chips": 512 if multi_pod else 256,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "w_bits": cfg.quant.w_bits, "a_bits": cfg.quant.a_bits,
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
    else:
        try:
            mesh = production_mesh(multi_pod)
            rec.update(measure(cfg, mesh, shape["mode"], shape["batch"],
                               shape["seq"], opts))
            if "attn_chunks" in opts:
                rec["attn_chunks"] = (
                    "pins nothing the step does not already do: the "
                    "KV-chunk axis is never sharded (a train step's and "
                    "a serve prefill's heads are the rank's own)")
            rec["status"] = "ok"
        except Exception as e:  # noqa: BLE001 -- a failed cell is a report
            rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    if not quiet:
        m = rec.get("memory", {})
        print(f"[{cid}] {rec['status']} "
              f"peak={m.get('peak_bytes', 0) / GIB:.2f}GiB "
              f"argument={m.get('argument_bytes', 0) / GIB:.2f}GiB "
              f"gathered={m.get('gathered_bytes', 0) / GIB:.2f}GiB "
              f"trace={rec.get('trace_s', 0)}s "
              f"{rec.get('error', rec.get('reason', ''))}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true",
                    help="re-run cells with existing results")
    ap.add_argument("--opt", default="",
                    help="comma-separated levers (" + ",".join(OPTS) + ")")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)
    try:
        cell_config(ARCHS[0], opts)
    except ValueError as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 2
    if args.mesh == "both":
        # one process a mesh: a fake group's world size is fixed
        argv = sys.argv[1:] if argv is None else list(argv)
        rcs = []
        for mesh in ("single", "multi"):
            rest = [a for i, a in enumerate(argv) if a != "--mesh"
                    and (i == 0 or argv[i - 1] != "--mesh")
                    and not a.startswith("--mesh=")]
            rcs.append(subprocess.call(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--mesh", mesh] + rest))
        return 1 if any(rcs) else 0
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    multi = args.mesh == "multi"
    failures = 0
    for arch in archs:
        for shape in shapes:
            p = os.path.join(args.out, cell_id(arch, shape, multi, opts)
                             + ".json")
            if os.path.exists(p) and not args.force:
                with open(p) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
            rec = run_cell(arch, shape, multi, args.out, opts=opts)
            failures += rec["status"] == "failed"
    print(f"dry-run sweep done, failures={failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
