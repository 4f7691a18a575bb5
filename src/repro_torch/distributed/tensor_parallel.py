"""Tensor-, sequence- and expert-parallel compute over a mesh's "model"
axis, and the per-use weight gathers, for the sharded training step and
the sharded serve step.

:func:`repro_torch.distributed.sharding.sharded_step` installs a
:class:`Context` for its step (:func:`active`), and
:func:`~repro_torch.distributed.sharding.sharded_serve_step` a serve one
(``active(mesh, serve=True)``), and each hands the model every parameter
as a :class:`Param` (its local shard and placements); the model code
calls the functions below, each of which is the identity (or returns its
tree unchanged) when no context is installed, so single-process runs
never see them.  With a context on a mesh whose "model" axis is 1 they
do the data-parallel part only (weights gathered over the DP axes at
their use), and at world size 1 either step is the plain step bit for
bit.

Training.  The layout is Megatron's with sequence parallelism, by the
rules of :func:`~repro_torch.distributed.sharding.shardings_for_params`:

* the residual stream between blocks is ``(B_dp, S / m, d)``: the rank's
  batch rows and its part of the sequence (the "residual" rule), on
  which every norm runs;
* a column-parallel product (q/k/v, the MLP's gate/up, the shared
  experts', ``in_proj``) gathers the sequence of its input itself and
  multiplies it by the weight's local rows (:class:`_ColumnLinear`);
  attention runs on the rank's own heads;
* a row-position product (wo, w_down, out_proj) takes its weight whole
  and the rank's part of the sequence with every feature (an all-to-all
  from the rank's heads or d_ff rows), so each output element is the
  single process's product over all of K (:func:`tp_linear`);
* the embedding is looked up in the rank's vocab rows and the partial
  sums reduce-scattered to the residual; ``lm_head`` is column-parallel
  and the loss takes its max, sum of exponentials and gold logit over
  "model" (:func:`vocab_lse_gold`);
* MoE: experts over "model" where they divide it (EP), else every expert
  whole on the rank's part of the capacity rows (:func:`expert_rows`;
  the rules keep them split by d_ff at rest); the router runs on the
  gathered sequence, the
  same on every model rank; every expert's output rows are gathered and
  combined as the single process does; the dispatch groups and the
  load-balance loss are the global batch's (:func:`dp_info`,
  :func:`dp_sum`).

Fallbacks, each named where it is taken: attention whose q heads do not
divide "model" (or whose KV heads neither divide nor are divided by it)
runs on whole heads, its q/k/v weights gathered over "model"; the
Mamba-2 mixer's ``in_proj`` (its contiguous d_out shard cuts across the
z, x, B, C and dt sections) and ``conv_w`` are gathered over "model" and
the mixer runs whole; the enc-dec frontend is gathered over "model" and
applied to the rank's frames.  Where several ranks share a KV head
(llama3-8b's 8 on 16) each gathers ``wk`` and ``wv`` and keeps the rows
of the head its q heads read (:func:`shared_kv`).

Gradients.  A weight's gather is an autograd Function
(:class:`_GatherWeight`) whose backward reduce-scatters the gradient
over the dims it gathered and sums it over the dims it is replicated on,
in f32, and rounds once.  A tensor-parallel shard's gradient is its
rank's own; a leaf replicated over "model" (norms, the router, the SSM's
vectors, every weight gathered whole) is used on split work -- the
rank's part of the sequence, its experts, its heads -- so its gradient
is partial and is summed over "model" once.  A value every model rank
computes whole and that is not split further (the MoE load-balance loss)
enters only the model rank 0's objective.  Each activation gradient that
crosses ranks is summed in f32 before it is rounded, where the single
process rounds its own product: the sharded gradients stay within the
DP-only split's bf16 noise of the single process's.

Serving (no autograd, no gradient bookkeeping).  The residual stream
stays whole over "model" (a decode step's one token cannot be split; in
a prefill this is a named fallback) and every product keeps the bits of
the single process's (:func:`serve_block_params`):

* a column product (q/k/v, gate/up, the shared experts', ``lm_head``)
  multiplies the whole input by the rank's rows of the packed planes:
  each output column is the single process's;
* a row product (wo, w_down, out_proj) multiplies the rank's features by
  its K-shard of the planes (:func:`row_product`): the rows' absmax is
  taken over "model" (a max, exact), K3 packs the shard at that scale,
  K5 returns its exact int32 partial, the partials are summed over
  "model" in int32 (exact in any order) and K1's epilogue runs once;
* attention at decode is sequence-parallel: the caches rest on their
  sequence shard, the step's q/k/v heads are gathered, the rank that
  owns the ring slot writes it, every rank attends every head to its
  own slots and the ``(o, lse)`` partials are combined in f32 in rank
  order (:func:`combine_over_model`); a prefill attends on the rank's
  heads over the layer's gathered cache (:func:`gather_cache`) and
  writes each rank's slots back (:func:`keep_cache`);
* the embedding is looked up in the rank's vocab rows and summed over
  "model" (one rank adds a non-zero row: exact); ``lm_head`` returns the
  rank's vocab columns;
* MoE: experts over "model" where they divide it (EP), else whole on the
  rank's part of each dispatch group's rows (:func:`expert_rows`);
* the Mamba-2 mixer runs whole, its state and conv rows gathered for the
  layer and the rank's part kept (:func:`layer_cache`,
  :func:`rest_cache`).

Fallbacks are recorded in ``Context.fallbacks``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import weakref
from typing import Optional

import torch

from repro_torch.core.bipolar import BipolarTensor
from repro_torch.launch.mesh import dp_axes, mesh_sizes


class Context:
    """A mesh's groups and this rank's coordinates, and the bytes of the
    weights gathered so far: ``gathered_live`` now, ``gathered_peak`` the
    most at once.  ``serve``: the serve step's context; ``fallbacks`` the
    named fallbacks it took."""

    def __init__(self, mesh, serve: bool = False):
        self.mesh = mesh
        self.serve = serve
        self.fallbacks: set = set()
        sizes = mesh_sizes(mesh)
        # a group for each mesh dim of more than one rank
        self.groups = {a: mesh.get_group(a) if n > 1 else None
                       for a, n in sizes.items()}
        self.m = sizes.get("model", 1)
        self.model_group = self.groups.get("model")
        self.model_rank = (mesh.get_local_rank("model")
                           if "model" in sizes else 0)
        self.dp = [a for a in dp_axes(mesh) if sizes[a] > 1]
        self.dp_groups = [self.groups[a] for a in self.dp]
        self.n_dp = math.prod(sizes[a] for a in self.dp)
        rank = 0
        for a in self.dp:                     # outer first, as the batch
            rank = rank * sizes[a] + mesh.get_local_rank(a)
        self.dp_rank = rank
        self.gathered_live = self.gathered_peak = 0
        self._counted: dict = {}

    def count(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._counted:
            return
        n = st.nbytes()
        self._counted[key] = weakref.ref(
            st, functools.partial(_freed, weakref.ref(self), key, n))
        self.gathered_live += n
        self.gathered_peak = max(self.gathered_peak, self.gathered_live)


def _freed(ref, key, n, _):
    ctx = ref()
    if ctx is not None:
        ctx.gathered_live -= n
        ctx._counted.pop(key, None)


_CTX: dict = {"ctx": None}


@contextlib.contextmanager
def active(mesh, serve: bool = False):
    """Install a :class:`Context` of ``mesh`` for the block (``serve``:
    the serve step's); yields it."""
    prev = _CTX["ctx"]
    _CTX["ctx"] = ctx = Context(mesh, serve)
    try:
        yield ctx
    finally:
        _CTX["ctx"] = prev


def current() -> Optional[Context]:
    return _CTX["ctx"]


def splits() -> bool:
    """Whether a training context is installed whose "model" axis splits
    work."""
    return _split() is not None


def _split() -> Optional[Context]:
    """The training context if its "model" axis splits work, else
    None."""
    ctx = _CTX["ctx"]
    return ctx if ctx is not None and ctx.m > 1 and not ctx.serve else None


def serving() -> bool:
    """Whether a serve context is installed whose "model" axis splits
    work."""
    return _serve() is not None


def _serve() -> Optional[Context]:
    """The serve context if its "model" axis splits work, else None."""
    ctx = _CTX["ctx"]
    return ctx if ctx is not None and ctx.m > 1 and ctx.serve else None


def fallback(name: str) -> None:
    """Record a named fallback in the installed context."""
    ctx = _CTX["ctx"]
    if ctx is not None:
        ctx.fallbacks.add(name)


# ---------------------------------------------------------------------------
# collectives on local tensors, autograd-aware
# ---------------------------------------------------------------------------

def _wait(t):
    from torch.distributed import _functional_collectives as funcol
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_gather(x, dim, group):
    from torch.distributed import _functional_collectives as funcol
    return _wait(funcol.all_gather_tensor(x.contiguous(), dim, group))


def _reduce_scatter(x, dim, group):
    from torch.distributed import _functional_collectives as funcol
    return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim,
                                              group))


def _all_reduce(x, op, group):
    from torch.distributed import _functional_collectives as funcol
    return _wait(funcol.all_reduce(x.contiguous(), op, group))


def _seq_to_features(x, group, m):
    """``(B, S, K_l)`` -> ``(B, S/m, m*K_l)``: every rank's features of
    this rank's part of the sequence, in rank order (an all-to-all)."""
    from torch.distributed import _functional_collectives as funcol
    b, s, k = x.shape
    parts = x.reshape(b, m, s // m, k).transpose(0, 1).contiguous()
    got = _wait(funcol.all_to_all_single(parts, None, None, group))
    return got.reshape(m, b, s // m, k).permute(1, 2, 0, 3).reshape(
        b, s // m, m * k)


def _features_to_seq(y, group, m):
    """The inverse of :func:`_seq_to_features`."""
    from torch.distributed import _functional_collectives as funcol
    b, sl, mk = y.shape
    parts = y.reshape(b, sl, m, mk // m).permute(2, 0, 1, 3).contiguous()
    got = _wait(funcol.all_to_all_single(parts, None, None, group))
    return got.transpose(0, 1).reshape(b, m * sl, mk // m)


class _SeqToFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, m):
        ctx.group, ctx.m = group, m
        return _seq_to_features(x, group, m)

    @staticmethod
    def backward(ctx, g):
        return _features_to_seq(g, ctx.group, ctx.m), None, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` (the result in f32 if ``f32``, the same
    values); the gradient is reduce-scattered back in f32 and cast once
    to ``x``'s dtype (each rank's use of the gathered tensor is
    partial)."""

    @staticmethod
    def forward(ctx, x, dim, group, f32):
        ctx.dim, ctx.group, ctx.dtype = dim, group, x.dtype
        y = _all_gather(x, dim, group)
        return y.float() if f32 else y

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g.float(), ctx.dim, ctx.group)
                .to(ctx.dtype), None, None, None)


class _ColumnLinear(torch.autograd.Function):
    """``gather(x) @ w.T`` for the rank's sequence shard ``x (B, S/m,
    K)``: the sequence all-gathered, the product the single process's;
    the input's gradient is the f32 partial product reduce-scattered in
    f32 and cast once, so that it rounds where the single process's
    product rounds (and each use of ``x`` adds its own in ``x``'s dtype,
    in the single process's order)."""

    @staticmethod
    def forward(ctx, x, w, group):
        xf = _all_gather(x, 1, group)
        ctx.save_for_backward(xf, w)
        ctx.group = group
        return torch.matmul(xf, w.T)

    @staticmethod
    def backward(ctx, g):
        xf, w = ctx.saved_tensors
        dx = _reduce_scatter(torch.matmul(g.float(), w.float()), 1,
                             ctx.group).to(xf.dtype)
        return dx, _weight_grad(xf, g), None


class _HeadLinear(torch.autograd.Function):
    """``x32 @ w.T`` for the f32 gathered final hidden states ``x32``
    (values of the weight's dtype): the product the single process's,
    the input's gradient kept in f32 for :class:`_GatherSeq`'s f32
    reduction."""

    @staticmethod
    def forward(ctx, x32, w):
        ctx.save_for_backward(x32, w)
        return torch.matmul(x32.to(w.dtype), w.T)

    @staticmethod
    def backward(ctx, g):
        x32, w = ctx.saved_tensors
        return (torch.matmul(g.float(), w.float()),
                _weight_grad(x32.to(w.dtype), g))


def _weight_grad(x, g):
    """``d(x @ w.T)/dw`` as autograd takes it: ``(x^T g)^T`` over the
    flattened rows."""
    return torch.mm(x.reshape(-1, x.shape[-1]).t(),
                    g.reshape(-1, g.shape[-1])).t()


class _SharedHead(torch.autograd.Function):
    """The f32 K or V of a KV head that ``share`` consecutive model ranks
    compute, each for its own q heads: the forward passes it; the
    backward sums the ranks' partial gradients in f32 over those ranks
    (before anything rounds them) and hands the whole to the first of
    them, zeros to the others, so that the head's projection gradients
    are counted once."""

    @staticmethod
    def forward(ctx, x, group, share, rank):
        ctx.group, ctx.share, ctx.rank = group, share, rank
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        parts = _all_gather(g[None], 0, ctx.group)
        first = ctx.rank - ctx.rank % ctx.share
        whole = parts[first:first + ctx.share].sum(0)
        return (whole if ctx.rank == first else torch.zeros_like(whole),
                None, None, None)


class _GatherWeight(torch.autograd.Function):
    """A weight's local shard all-gathered over ``gathers`` (``(group,
    dim)``, one a mesh dim it is sharded on); the gradient is
    reduce-scattered back over them and summed over ``partial`` (the
    groups of the mesh dims it is replicated on, where each rank's use
    is a part), in f32, and cast once to the weight's dtype."""

    @staticmethod
    def forward(ctx, local, gathers, partial):
        ctx.gathers, ctx.partial = gathers, partial
        for group, dim in gathers:
            local = _all_gather(local, dim, group)
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        dtype, g = g.dtype, g.float()
        for group, dim in reversed(ctx.gathers):
            g = _reduce_scatter(g, dim, group)
        for group in ctx.partial:
            g = _all_reduce(g, "sum", group)
        return g.to(dtype), None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum partial ``x`` over the group, keep this rank's part of
    ``dim``; the gradient is all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _SumReplicated(torch.autograd.Function):
    """Sum ``x`` over the groups, one after another; the result is the
    same on every rank and so is the gradient each rank seeds, so the
    gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, groups):
        for group in groups:
            x = _all_reduce(x, "sum", group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def seq_bounds(n_local: int):
    """``(lo, hi)``: the positions of the full sequence that a sequence
    shard of ``n_local`` holds on this rank (``(0, n_local)`` unsplit)."""
    ctx = _split()
    lo = 0 if ctx is None else ctx.model_rank * n_local
    return lo, lo + n_local


def _model_dim(x, spec):
    """The dim of ``x`` that ``spec`` (suffix-aligned) puts on "model"."""
    spec = tuple(spec)[-x.ndim:]
    spec = (None,) * (x.ndim - len(spec)) + spec
    for d, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return d
    return None


def to_layout(x: torch.Tensor, spec, src: Optional[str]) -> torch.Tensor:
    """A local tensor brought to ``spec``'s layout on the "model" axis
    (the DP dims are the rank's batch already): ``src="partial"`` (a
    partial sum over "model") is summed and scattered along the spec's
    "model" dim, in f32 and cast back to ``x``'s dtype once (a spec with
    no "model" dim, in serving: summed whole);
    ``src="replicated"`` (the same on every model rank) keeps this rank's
    part of that dim; ``src=None`` (already laid out so) passes."""
    ctx = _split() or _serve()
    if ctx is None or src is None:
        return x
    dim = _model_dim(x, spec)
    if dim is None:
        if src == "partial" and ctx.serve:     # summed whole, in f32
            return _all_reduce(x.float(), "sum", ctx.model_group).to(
                x.dtype)
        if src == "partial":
            raise ValueError("a partial sum needs a dim on 'model' to "
                             "scatter")
        return x
    if x.shape[dim] % ctx.m:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"the model axis ({ctx.m})")
    if src == "replicated":
        n = x.shape[dim] // ctx.m
        return x.narrow(dim, ctx.model_rank * n, n)
    assert src == "partial", src
    return _ReduceScatter.apply(x.float(), dim, ctx.model_group).to(x.dtype)


def gather_seq(x: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """The whole sequence (dim 1) of a sequence-sharded activation: the
    MoE's routed input, the final hidden states (``f32``: held in f32,
    see :class:`_HeadLinear`).  Serving keeps the sequence whole."""
    ctx = _split()
    if ctx is None:
        return x
    return _GatherSeq.apply(x, 1, ctx.model_group, f32)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``'s parts on every model rank, concatenated along ``dim`` (the
    MoE's experts); in training the gradient, partial on each rank, is
    summed and scattered back (:class:`_GatherSeq`)."""
    ctx = _split()
    if ctx is not None:
        return _GatherSeq.apply(x, dim, ctx.model_group, False)
    ctx = _serve()
    return x if ctx is None else _all_gather(x, dim, ctx.model_group)


def expert_rows(x: torch.Tensor, fn, counts=None) -> torch.Tensor:
    """``fn`` (the experts' MLP, weights whole) on this rank's part of the
    capacity rows of ``x (E, R, d)``, the same on every model rank (R
    padded to a multiple of the model axis), then every rank's rows
    gathered: ``(E, R, d)``, each row the single process's.

    With ``counts (E, G)`` (serving's grouped kernel: ``R = G * cap``,
    each group's live rows a prefix of its ``cap``) the rank takes its
    part of every group's rows, ``fn(rows, counts)`` sees each part's
    live prefix, and the parts are put back in place."""
    ctx = _split() or _serve()
    group = ctx.model_group

    def gather(y, dim):
        return (_all_gather(y, dim, group) if ctx.serve
                else _GatherSeq.apply(y, dim, group, False))
    if counts is not None:
        e, r, d = x.shape
        g = counts.shape[1]
        cap = r // g
        n = -(-cap // ctx.m)
        xg = torch.nn.functional.pad(x.reshape(e, g, cap, d),
                                     (0, 0, 0, n * ctx.m - cap))
        lo = ctx.model_rank * n
        y = fn(xg[:, :, lo:lo + n].reshape(e, g * n, d),
               torch.clamp(counts - lo, 0, n).to(counts.dtype))
        y = gather(y.reshape(e, g, n, -1), dim=2)
        return y[:, :, :cap].reshape(e, r, -1)
    r = x.shape[1]
    pad = -r % ctx.m
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    n = x.shape[1] // ctx.m
    y = fn(x.narrow(1, ctx.model_rank * n, n))
    return gather(y, dim=1)[:, :r]


def tp_linear(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """A linear the sharded step marked (``params["tp"]`` of
    :func:`block_params`), in ``w``'s dtype.

    * ``"col"``: ``x`` is the rank's sequence shard, ``w`` the rank's
      rows (or whole, in a fallback): :class:`_ColumnLinear`.
    * ``"row"``: ``w`` whole; ``x`` the whole sequence of the rank's
      features (its heads, its d_ff rows: brought to the rank's part of
      the sequence with every feature by an all-to-all) or of every
      feature (the rank's part taken).  Each output element is then the
      single process's product, over all of K at once (partial sums over
      "model", reduce-scattered, would round a few elements a layer
      otherwise than the single process).
    * ``"head"``: the loss's ``lm_head`` (or tied embedding) rows on the
      f32 gathered final hidden states: :class:`_HeadLinear`."""
    ctx = _split()
    if kind == "col":
        return _ColumnLinear.apply(x, w, ctx.model_group)
    if kind == "head":
        return _HeadLinear.apply(x, w)
    assert kind == "row", kind
    if x.shape[-1] == w.shape[-1]:
        x = to_layout(x, (None, "model", None), "replicated")
    else:
        x = _SeqToFeatures.apply(x, ctx.model_group, ctx.m)
    return torch.matmul(x.to(w.dtype), w.T)


def vocab_lse_gold(logits: torch.Tensor, labels: torch.Tensor, lo: int):
    """``(logsumexp, gold logit)`` per row of f32 ``logits (..., V_l)``,
    the rank's vocab columns ``lo..lo+V_l``: the max, the sum of
    exponentials and the gold logit taken over "model" (plain
    ``logsumexp`` and ``gather`` unsplit)."""
    ctx = _split()
    if ctx is None:
        return (torch.logsumexp(logits, -1),
                torch.gather(logits, -1, labels[..., None])[..., 0])
    g = ctx.model_group
    mx = _all_reduce(logits.detach().amax(-1), "max", g)
    se = _SumReplicated.apply(torch.exp(logits - mx[..., None]).sum(-1), [g])
    local = labels - lo
    own = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1,
                        torch.clamp(local, 0, logits.shape[-1] - 1)[..., None]
                        )[..., 0]
    gold = _SumReplicated.apply(torch.where(own, gold, 0.0), [g])
    return mx + torch.log(se), gold


def shared_kv(k: torch.Tensor, v: torch.Tensor, n_kv_heads: int):
    """The attention core's K and V ``(B, Hkv_l, T, D)``: unchanged,
    unless several model ranks share each KV head (more ranks than KV
    heads, llama3-8b's 8 on 16), when they come back in f32 through
    :class:`_SharedHead`."""
    ctx = _split()
    if ctx is None or n_kv_heads >= ctx.m:
        return k, v
    share = ctx.m // n_kv_heads
    return tuple(_SharedHead.apply(t.float(), ctx.model_group, share,
                                   ctx.model_rank) for t in (k, v))


def head(p: dict) -> dict:
    """``lm_head`` (or the tied embedding) gathered for the logits: the
    rank's vocab rows, marked ``"head"`` when a training step's "model"
    splits them (the loss reads the gathered final hidden states; a
    serve step's is a column product on the whole ones)."""
    out = use(p)
    return dict(out, tp="head") if _split() is not None else out


def model_rank() -> int:
    ctx = _CTX["ctx"]
    return 0 if ctx is None else ctx.model_rank


def shard_bounds(n_local: int, n_full: int):
    """``(lo, hi)`` of this rank's rows of a dim of ``n_full`` that it
    holds ``n_local`` of (over "model")."""
    if n_local == n_full:
        return 0, n_full
    lo = model_rank() * n_local
    return lo, lo + n_local


# ---------------------------------------------------------------------------
# data parallelism inside the model (the MoE's groups and aux)
# ---------------------------------------------------------------------------

def dp_info():
    """``(DP size, this rank's DP index)``; ``(1, 0)`` without a
    context."""
    ctx = _CTX["ctx"]
    return (1, 0) if ctx is None else (ctx.n_dp, ctx.dp_rank)


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the DP axes (each rank seeds the same gradient
    of the sum, so the gradient passes unchanged)."""
    ctx = _CTX["ctx"]
    if ctx is None or not ctx.dp_groups:
        return x
    return _SumReplicated.apply(x, ctx.dp_groups)


def dp_gather(x: torch.Tensor) -> torch.Tensor:
    """``(n_dp, *x.shape)``: every DP rank's ``x`` in DP order (no
    gradient)."""
    ctx = _CTX["ctx"]
    x = x[None]
    if ctx is None:
        return x
    for group in reversed(ctx.dp_groups):       # inner axis first
        x = _all_gather(x, 0, group)
    return x


# ---------------------------------------------------------------------------
# weights, gathered at their use
# ---------------------------------------------------------------------------

class Param:
    """A parameter as the sharded step hands it to the model: its local
    shard (the autograd leaf) and its DTensor placements, one a mesh
    dim.  :func:`use` and :func:`block_params` turn it into the tensor
    the layer reads."""

    __slots__ = ("local", "placements")

    def __init__(self, local: torch.Tensor, placements):
        self.local, self.placements = local, tuple(placements)


def _gather(p, keep_model: bool):
    """``p``'s tensor at its use: gathered over every mesh dim it is
    sharded on but "model", and over "model" too unless ``keep_model``
    (a tensor-parallel shard kept); its gradient is partial over every
    other mesh dim (:class:`_GatherWeight`).  Anything but a
    :class:`Param` is returned as it is."""
    ctx = _CTX["ctx"]
    if isinstance(p, BipolarTensor):
        return _gather_packed(p, keep_model)
    if ctx is None or not isinstance(p, Param):
        return p
    gathers, partial = [], []
    for name, pl in zip(ctx.mesh.mesh_dim_names, p.placements):
        group = ctx.groups[name]
        if group is None or (name == "model" and keep_model
                             and pl.is_shard()):
            continue
        if pl.is_shard():
            gathers.append((group, pl.dim))
        else:
            partial.append(group)
    if ctx.serve:           # no gradient: plain all-gathers
        t = p.local
        for group, dim in gathers:
            t = _all_gather(t, dim, group)
    elif not gathers and not partial:
        return p.local
    else:
        t = _GatherWeight.apply(p.local, gathers, partial)
    if gathers:
        ctx.count(t)
    return t


def _gather_packed(p: BipolarTensor, keep_model: bool) -> BipolarTensor:
    """A packed weight whose fields are :class:`Param` leaves, gathered at its
    use: its logical ``shape`` is that of the planes kept, K the real
    elements of the rank's words (the last words' pad excluded) where
    "model" splits the packed words."""
    if not isinstance(p.packed, Param):
        return p
    packed = _gather(p.packed, keep_model)
    k = p.shape[-1]
    kw = -(-k // 32)
    if packed.shape[-1] < kw:               # the rank's K-shard of words
        lo = model_rank() * packed.shape[-1]
        k = min(k, (lo + packed.shape[-1]) * 32) - lo * 32
    ws = p.width_scales
    return dataclasses.replace(
        p, packed=packed, scale=_gather(p.scale, keep_model),
        width_scales=None if ws is None else _gather(ws, keep_model),
        shape=tuple(packed.shape[1:-1]) + (k,))


def use(tree, keep_model: bool = True):
    """Every :class:`Param` of ``tree`` (a dict of dicts) gathered at its
    use (:func:`_gather`)."""
    if isinstance(tree, dict):
        return {k: use(v, keep_model) for k, v in tree.items()}
    return _gather(tree, keep_model)


def _col(p: dict, keep_model: bool) -> dict:
    """A linear that reads the gathered sequence (q/k/v, gate/up,
    in_proj): its rows over "model" kept, or the weight whole."""
    return {"w": _gather(p["w"], keep_model), "tp": "col"}


def _model_shard(p):
    """The dim of ``p`` (a :class:`Param`, or a packed weight's planes)
    sharded over "model", or None."""
    if isinstance(p, BipolarTensor):
        p = p.packed
    if not isinstance(p, Param):
        return None
    pl = p.placements[_CTX["ctx"].mesh.mesh_dim_names.index("model")]
    return pl.dim if pl.is_shard() else None


def _row(p: dict) -> dict:
    """A row-position linear (wo, w_down, out_proj): gathered whole, for
    the rank's part of the sequence (:func:`tp_linear`'s ``"row"``)."""
    return {"w": _gather(p["w"], False), "tp": "row"}


def _attention(p: dict, n_heads: int, n_kv_heads: int, d_head: int,
               ctx: Context) -> dict:
    m = ctx.m
    split = n_heads % m == 0 and (n_kv_heads % m == 0 or m % n_kv_heads == 0)
    # fallback (heads that do not divide "model"): whole heads, q/k/v
    # gathered over "model", wo row-parallel on its slice of the output
    out = {"wq": _col(p["wq"], split), "wo": _row(p["wo"])}
    if split and n_kv_heads < m:
        # several ranks share a KV head: keep the rows of the one the
        # rank's q heads read
        j = ctx.model_rank // (m // n_kv_heads)
        for k in ("wk", "wv"):
            w = _gather(p[k]["w"], False)
            out[k] = {"w": w[j * d_head:(j + 1) * d_head], "tp": "col"}
    else:
        out["wk"], out["wv"] = _col(p["wk"], split), _col(p["wv"], split)
    return out


def block_params(p: dict, cfg, mixer_kind: str = "attn") -> dict:
    """One block's parameters (a decoder or encoder layer, or a
    cross-attention's ``{attn, norm}``) gathered at their use: the
    tensors the layers read, each linear marked with its ``"tp"`` kind
    for :func:`tp_linear`.  Unchanged without a context; gathered over
    the DP axes alone, unmarked, when "model" is 1."""
    ctx = _CTX["ctx"]
    if ctx is None:
        return p
    if ctx.m == 1:
        return use(p)
    if ctx.serve:
        return _serve_block(p, cfg, mixer_kind, ctx)
    out = {}
    for key, sub in p.items():
        if key == "attn" or (key == "mixer" and mixer_kind == "attn"):
            out[key] = _attention(sub, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, ctx)
        elif key == "mixer":
            # the Mamba-2 mixer runs whole (fallback): in_proj's d_out
            # shard would cut its z/x/B/C/dt sections
            out[key] = {k: (_row(v) if k == "out_proj" else
                            _col(v, False) if k == "in_proj" else
                            use(v, False)) for k, v in sub.items()}
        elif key == "ffn":
            out[key] = _ffn(sub)
        else:
            out[key] = use(sub)
    return out


def _ffn(p: dict) -> dict:
    """A dense MLP (gate/up column-parallel, ``w_down`` a row product) or
    a MoE (router replicated; expert stacks kept as their shards where
    the experts are split over "model" (EP), else gathered whole for
    :func:`expert_rows`; the shared experts as an MLP)."""
    out = {}
    for k, v in p.items():
        if k == "shared":
            out[k] = _ffn(v)
        elif isinstance(v, dict) and k != "router":
            out[k] = _row(v) if k == "w_down" else _col(v, True)
        else:
            out[k] = use(v, k == "router" or _model_shard(v) == 0)
    return out


# ---------------------------------------------------------------------------
# serving: the block's weights, the row product, the caches
# ---------------------------------------------------------------------------

def _serve_block(p: dict, cfg, mixer_kind: str, ctx: Context) -> dict:
    """:func:`block_params` in a serve context: column weights as the
    rank's rows (or whole, where the rules leave them so), row weights as
    their K-shard marked ``"row"`` (:func:`row_product`)."""
    out = {}
    for key, sub in p.items():
        if key == "attn" or (key == "mixer" and mixer_kind == "attn"):
            out[key] = _serve_attention(sub, cfg, ctx)
        elif key == "mixer":
            # fallback: the Mamba-2 mixer runs whole (in_proj's d_out shard
            # would cut its z/x/B/C/dt sections); out_proj takes its
            # K-shard of the whole mixer's features
            fallback("ssm mixer whole")
            out[key] = {k: (_serve_row(v) if k == "out_proj" else
                            use(v, False)) for k, v in sub.items()}
        elif key == "ffn":
            out[key] = _serve_ffn(sub)
        else:
            out[key] = use(sub)
    return out


def _serve_attention(p: dict, cfg, ctx: Context) -> dict:
    h, hk, m = cfg.n_heads, cfg.n_kv_heads, ctx.m
    split = h % m == 0 and (hk % m == 0 or m % hk == 0)
    if not split:
        # fallback: q heads (or KV heads) that do not divide "model":
        # whole heads, q/k/v gathered over "model"
        fallback(f"whole heads ({h} q, {hk} kv heads on {m})")
    kv_split = split and hk % m == 0
    if split and not kv_split:
        # several ranks share a KV head: k and v whole (the cache's
        # writes need every head), each rank attends the head its q
        # heads read
        fallback(f"k/v projections whole ({hk} kv heads on {m})")
    return {"wq": _serve_col(p["wq"], split),
            "wk": _serve_col(p["wk"], kv_split),
            "wv": _serve_col(p["wv"], kv_split), "wo": _serve_row(p["wo"])}


def _serve_ffn(p: dict) -> dict:
    """A dense MLP (gate/up the rank's rows, ``w_down`` a row product) or
    a MoE (router replicated; expert stacks the rank's experts where they
    divide "model" (EP), else gathered whole; the shared experts as an
    MLP)."""
    out = {}
    for k, v in p.items():
        if k == "shared":
            out[k] = _serve_ffn(v)
        elif isinstance(v, dict) and k != "router":
            out[k] = _serve_row(v) if k == "w_down" else _serve_col(v)
        elif k == "router":
            out[k] = use(v, True)
        else:
            t = v.packed if isinstance(v, BipolarTensor) else v
            ep = _model_shard(v) == t.local.ndim - 3 \
                if isinstance(t, Param) else False
            if not ep:
                # fallback: experts that do not divide "model" run whole
                # on the rank's part of the dispatch rows (expert_rows)
                fallback("experts whole on dispatch-row shards")
            out[k] = use(v, ep)
    return out


def _split_dim(w):
    """The dim of a linear weight's leaf (its packed planes) that "model"
    splits, counted from the end (-2: d_out, -1: d_in or its words), or
    None.  The rules may split a dense MLP's planes along their plane
    axis (they read ``(w_bits, N, Kw)`` as an expert stack where "model"
    divides ``w_bits``): no product splits so."""
    d = _model_shard(w)
    t = w.packed if isinstance(w, BipolarTensor) else w
    return None if d is None else d - t.local.ndim


# (a packed weight split so is moved to the split its product reads by
# one all-to-all, :func:`_planes_to`)


def _planes_to(p: Param, dim: int) -> torch.Tensor:
    """A packed leaf that "model" splits along its plane axis (0), its DP
    shards gathered, then moved by one all-to-all so that "model" splits
    ``dim`` instead: every plane of the rank's part of ``dim``."""
    from torch.distributed import _functional_collectives as funcol
    ctx = _CTX["ctx"]
    t = _gather(p, True)
    parts = torch.stack(t.chunk(ctx.m, dim)).contiguous()
    got = _wait(funcol.all_to_all_single(parts, None, None,
                                         ctx.model_group))
    out = got.reshape((ctx.m * t.shape[0],) + tuple(got.shape[2:]))
    ctx.count(out)
    return out


def _planes_moved(w: BipolarTensor, row: bool) -> BipolarTensor:
    """A packed weight whose planes "model" splits (see
    :func:`_split_dim`) as the product reads it: the rank's rows of every
    plane (``row=False``) or the rank's K words (``row``)."""
    packed = _planes_to(w.packed, -1 if row else -2)
    scale = _gather(w.scale, False)
    ws = None if w.width_scales is None else _gather(w.width_scales, False)
    k = w.shape[-1]
    if row:
        lo = model_rank() * packed.shape[-1]
        k = min(k, (lo + packed.shape[-1]) * 32) - lo * 32
    else:                   # the scales of the rank's rows
        n = packed.shape[-2]
        lo = model_rank() * n
        scale = scale[lo:lo + n]
        ws = None if ws is None else ws[:, lo:lo + n]
    return dataclasses.replace(
        w, packed=packed, scale=scale, width_scales=ws,
        shape=tuple(packed.shape[1:-1]) + (k,))


def _serve_col(p: dict, split: bool = True) -> dict:
    """A column weight in serving: the rank's rows where "model" splits
    its d_out (and ``split``), else whole (a fallback named where it is
    not the caller's)."""
    w = p["w"]
    d = _split_dim(w)
    if d == -3 and split and \
            w.packed.local.shape[-2] % _CTX["ctx"].m == 0:
        return {"w": _planes_moved(w, False)}
    return {"w": _gather(w, split and d == -2)}


def _serve_row(p: dict) -> dict:
    """A row weight in serving: its K-shard of the packed words kept over
    "model" (``"k"``: the shard's first element and the whole K), marked
    ``"row"``.  A float weight, or packed words the rules leave whole
    over "model" (they do not divide it), is gathered whole: a named
    fallback, the product the plain one on every feature."""
    w = p["w"]
    if isinstance(w, BipolarTensor) and _split_dim(w) == -3 \
            and w.packed.local.shape[-1] % _CTX["ctx"].m == 0:
        wl = _planes_moved(w, True)
        lo = model_rank() * wl.packed.shape[-1] * 32
        return {"w": wl, "tp": "row", "k": (lo, w.shape[-1])}
    if isinstance(w, BipolarTensor) and _split_dim(w) == -1:
        wl = _gather_packed(w, True)
        lo = model_rank() * wl.packed.shape[-1] * 32
        return {"w": wl, "tp": "row", "k": (lo, w.shape[-1])}
    w = _gather(w, False)
    k = w.shape[-1]
    fallback(f"row product whole (K {k})")
    return {"w": w, "tp": "row", "k": (0, k)}


def row_columns(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The columns of a row product's input that its weight's K-shard
    multiplies (``p["k"]``): ``x`` holds every feature, or the rank's
    even part of them (its heads, its d_ff rows), which is gathered over
    "model" where it is not the weight's part."""
    ctx = _serve()
    lo, k = p["k"]
    n = p["w"].shape[-1]
    kx = x.shape[-1]
    if kx != k:
        if lo == ctx.model_rank * kx and n == kx:
            return x
        x = _all_gather(x, x.ndim - 1, ctx.model_group)
    return x[..., lo:lo + n]


def row_scale(x2: torch.Tensor, a_bits: int) -> torch.Tensor:
    """The f32 activation scale of each row of ``x2 (M, K_l)``, a K-shard
    of the rows: the absmax in the input dtype over "model" (a max:
    exact), then ``ops.ap_linear_fused``'s scale of it."""
    from repro_torch.core.bipolar import scale_of_absmax
    amax = x2.abs().amax(-1, keepdim=True)
    ctx = _serve()
    if ctx is not None:
        amax = _all_reduce(amax.float(), "max", ctx.model_group).to(
            x2.dtype)
    return scale_of_absmax(amax, a_bits).float()


def row_partial(x2: torch.Tensor, w: BipolarTensor, a_scale, *,
                a_bits: int, variant: str) -> torch.Tensor:
    """A K-shard's exact int32 partial product: ``x2 (M, K_l)`` packed by
    K3 at ``a_scale`` (pad bit 0), then K5's raw product with the
    shard's planes ``w (N, K_l)`` (its own K-pad correction included, so
    a weight's pad is counted once, in its last shard)."""
    from repro_torch.kernels import ops
    xq = ops.quantize_rows(x2, a_bits, pad_bit=0, scale=a_scale)
    return ops.ap_matmul(xq, w, variant=variant, raw=True)


def row_product(x: torch.Tensor, w: BipolarTensor, *, quant,
                act: str = "none", residual=None, out_dtype=None):
    """``epi(x (..., K_l) @ w (N, K_l)^T)`` for the rank's K-shard of a
    row weight and the matching columns of the input: the rows' scale
    over "model" (:func:`row_scale`), the shard's int32 partial
    (:func:`row_partial`), the partials summed over "model" in int32,
    then K1's epilogue (:func:`repro_torch.kernels.ref.linear_epilogue`)
    once.  Bit for bit ``ops.ap_linear_fused`` (and ``ops.ap_linear``)
    on the whole weight and every feature."""
    from repro_torch.core.bipolar import nested_slice
    from repro_torch.kernels.ref import linear_epilogue
    out_dtype = out_dtype or x.dtype
    if quant.nested_bits is not None:
        w = nested_slice(w, quant.nested_bits)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    a_scale = row_scale(x2, quant.a_bits)
    y = row_partial(x2, w, a_scale, a_bits=quant.a_bits,
                    variant=quant.variant)
    y = _all_reduce(y, "sum", _serve().model_group)
    n = w.shape[0]
    y = linear_epilogue(y, a_scale, w.scale, act=act, out_dtype=out_dtype,
                        residual=None if residual is None
                        else residual.reshape(-1, n))
    return y.reshape(*lead, n)


def gather_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``t (B, S, h_l, D)``, the rank's even part of ``n_heads`` heads (or
    every head), with every head: gathered over "model"."""
    ctx = _serve()
    if ctx is None or t.shape[2] == n_heads:
        return t
    return _all_gather(t, 2, ctx.model_group)


def combine_over_model(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Each rank's attention partials over its own slots, ``o (..., d)``
    f32 and ``lse (...)``, gathered over "model" and merged in f32 in
    rank order (:func:`repro_torch.kernels.ref.combine_partials`)."""
    from repro_torch.kernels.ref import combine_partials
    group = _serve().model_group
    return combine_partials(_all_gather(o.float()[None], 0, group),
                            _all_gather(lse.float()[None], 0, group))


# the leaves of an attention (or cross) cache that rest on their sequence
# shard: (B, L, ...) with L over "model"
_SEQ_LEAVES = ("k", "v", "k_scale", "v_scale", "pos")


def layer_cache(c):
    """``(cache, back)``: one layer's cache as the layer reads it.  Its
    :class:`Param` leaves become local tensors: an attention cache's on
    their sequence shard, with ``"seq_shard": (first slot, L)`` when
    "model" splits them in serving; the SSM's ``state`` and ``conv``
    gathered over "model" for the layer (``back`` names them for
    :func:`rest_cache`).  Anything else passes."""
    ctx = _CTX["ctx"]
    if ctx is None or not isinstance(c, dict) or not any(
            isinstance(t, Param) for t in c.values()):
        return c, None
    out, back = {}, []
    for key, t in c.items():
        dim = _model_shard(t)
        if not isinstance(t, Param) or dim is None or _serve() is None:
            out[key] = t.local if isinstance(t, Param) else t
        elif key in _SEQ_LEAVES:
            n = t.local.shape[1]
            out[key] = t.local
            out["seq_shard"] = (ctx.model_rank * n, n * ctx.m)
        else:
            out[key] = _all_gather(t.local, dim, ctx.model_group)
            back.append((key, dim))
    return out, back


def rest_cache(c, back):
    """A layer's new cache back in the placements :func:`layer_cache`
    read it in: the gathered leaves narrowed to the rank's part, the
    sequence-shard mark dropped."""
    if back is None or c is None:
        return c
    c = {k: v for k, v in c.items() if k != "seq_shard"}
    ctx = _CTX["ctx"]
    for key, dim in back:
        n = c[key].shape[dim] // ctx.m
        c[key] = c[key].narrow(dim, ctx.model_rank * n, n).contiguous()
    return c


def gather_cache(c: dict) -> dict:
    """A sequence-sharded layer cache with every slot: its leaves gathered
    over "model" (a prefill's transient: one layer's cache of the rank's
    batch rows)."""
    group = _serve().model_group
    return {k: (_all_gather(v, 1, group) if k in _SEQ_LEAVES else v)
            for k, v in c.items() if k != "seq_shard"}


def keep_cache(full: dict, c: dict) -> dict:
    """The rank's slots of the whole layer cache ``full``, written into
    its shard ``c`` in place; returns ``c`` with ``full``'s ``index``."""
    lo = c["seq_shard"][0]
    for k in _SEQ_LEAVES:
        if k in c:
            c[k].copy_(full[k][:, lo:lo + c[k].shape[1]])
    return dict(c, index=full["index"]) if "index" in full else c
