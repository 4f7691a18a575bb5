"""Serving runtime of the port: the paged continuous-batching engine.

A port of the paged path of the reference ``repro.serving.engine``.
Requests share a refcounted copy-on-write block pool of packed
bipolar-INT KV planes (:mod:`repro_torch.serving.paged_cache`) addressed
through per-request block tables and scheduled by
:mod:`repro_torch.serving.scheduler` -- FCFS admission gated on free
blocks, decode batches bucketed to powers of two, preemption with warm
restart when the pool runs dry, and the prefix cache: admission acquires
the cached blocks of a common prompt prefix and prefills only the
suffix, directly through the block table.

**Chunked prefill** (``chunk_tokens``): a prompt streams through the step
loop ``chunk_tokens`` at a time, fused with the decode batch into one
bucketed ``(B, S)`` dispatch (:meth:`Engine._fused_dispatch`) whose pad
rows are position-masked; running decodes emit a token every step while
a long prompt trickles in.

The submit/stream API (:class:`StreamHandle`, ``on_token`` callbacks,
deadlines, cancellation), the observability hooks (``metrics=``, default
the no-op ``NULL_OBS``), fault containment (``faults=``) and nested-precision lanes
(``Request.precision``) are the reference's, unchanged.  Backpressure
(``max_queue=``) and the pool watchdog (``validate_every=``) are not
ported yet (ROADMAP queue 1, item 9).

Where the reference jit-compiles one program per bucket, the port runs
eagerly: :func:`prefill_step_bucketed` and :func:`serve_step` are plain
functions, and every quantized linear, every attention read and every
weight pack on the card is one launch of a hand-written kernel.  The
contiguous engine (``paged=False``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, QuantConfig
from repro_torch.obs import NULL_OBS, MetricsRegistry, ServingObs
from repro_torch.serving.faults import NULL_FAULTS, RequestFault


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def prefill_step_bucketed(params, batch: dict, caches, cfg: ModelConfig,
                          quant: Optional[QuantConfig] = None):
    """Forward a length-bucketed ``(B, S)`` batch (pad positions -1,
    masked everywhere) and take the logits at ``batch["last_idx"]`` (B,)
    -- each lane's last *real* token.  Returns ``(logits (B, V),
    caches)``."""
    x, caches = M.forward(params, batch["tokens"], cfg,
                          positions=batch["positions"], caches=caches,
                          quant=quant, logits_mode="none")
    idx = batch["last_idx"].long()
    xl = x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]
    logits = M._logits(params, xl, cfg, quant)
    return logits[:, 0], caches


def serve_step(params, batch: dict, caches, cfg: ModelConfig,
               quant: Optional[QuantConfig] = None):
    """One decode step: one new token per sequence, ``batch`` = tokens
    (B, 1), positions (B, 1).  Returns ``(logits (B, V), caches)``."""
    return M.forward(params, batch["tokens"], cfg,
                     positions=batch["positions"], caches=caches,
                     quant=quant, logits_mode="last")


def kv_cache_bytes(caches, *, payload_only: bool = False) -> int:
    """Total bytes of the attention KV state in a cache tree: ``k``/``v``
    plus (unless ``payload_only``) their scales."""
    keys = ("k", "v") if payload_only else ("k", "v", "k_scale", "v_scale")

    def walk(node):
        if isinstance(node, dict):
            return sum(v.numel() * v.element_size() if k in keys
                       and isinstance(v, torch.Tensor) else walk(v)
                       for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return sum(walk(v) for v in node)
        return 0

    return int(walk(caches))


def _next_pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def prefill_bucket(s: int, cap: int, floor: int = 8) -> int:
    """Bucket a prompt length to the next power of two (>= ``floor``,
    capped at ``cap``): a stream of varied prompt lengths runs at
    O(log cap) distinct shapes.  Lengths at or beyond ``cap`` stay
    exact."""
    if s >= cap:
        return s
    return min(_next_pow2(s, floor), cap)


def tier_bits(requested: Optional[int], *, max_bits: int,
              floor: Optional[int] = None, queue_depth: int = 0,
              pressure: int = 4) -> int:
    """Resolve one request's served weight width (bits).

    ``requested`` (None = full width) is capped at ``max_bits``, the
    checkpoint's stored width -- a nested checkpoint can serve fewer
    planes than it stores, never more.  Without a ``floor`` the request
    gets exactly what it asked for (no load adaptation).  With one, the
    policy is load-adaptive: every ``pressure`` waiting requests shed
    one bit off the grant, clamped at the floor -- bulk lanes degrade
    under overload and recover as the queue drains (each *new*
    admission re-reads the depth; granted requests keep their bits).
    A request explicitly asking for less than the floor is honored:
    the floor bounds degradation, not choice.
    """
    bits = min(requested or max_bits, max_bits)
    if floor is None:
        return bits
    lo = min(floor, bits)
    return max(lo, bits - queue_depth // max(pressure, 1))


# ---------------------------------------------------------------------------
# Requests and per-request state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)    # identity equality: queue membership
class Request:                      # must never compare prompt arrays
    prompt: np.ndarray              # (s,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0        # 0 = greedy
    seed: Optional[int] = None      # per-request sampling stream; token k
                                    # is drawn from rng((seed, k)), so
                                    # preemption/recompute cannot change
                                    # the sampled sequence.  None: the
                                    # engine assigns a distinct seed at
                                    # submit (identical prompts still
                                    # sample diverse completions)
    precision: Optional[int] = None  # requested weight width (bits) for
                                     # nested-precision serving; capped
                                     # at quant.w_bits, load-adapted by
                                     # tier_bits, frozen at admission.
                                     # None: the engine's full width
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None     # rejection / quarantine detail
    # -- async streaming API -------------------------------------------------
    on_token: Optional[Callable[[int], None]] = None   # emission-order cb
    timeout: Optional[float] = None  # seconds from submit to deadline
    deadline: Optional[float] = None  # absolute (engine clock); computed
                                      # from ``timeout`` at submit if unset
    # why the request stopped: one of FINISH_REASONS (the class constant
    # below is THE enum -- obs labels and tests assert against it)
    finish_reason: Optional[str] = None

    # not a dataclass field (no annotation): the single definition of
    # every value ``finish_reason`` may take
    FINISH_REASONS = frozenset(
        {"length", "timeout", "cancelled", "rejected", "error"})


class StreamHandle:
    """Async view of a submitted request.

    The engine is single-threaded, so "async" means the handle *drives*
    it: :meth:`tokens` steps the engine until the request advances and
    yields each output token in emission order, which lets callers
    interleave many requests (each with its own handle or ``on_token``
    callback) without threads.  :meth:`cancel` aborts the request and
    releases its memory through the refcount path."""

    def __init__(self, engine: "Engine", req: Request):
        self.engine, self.req = engine, req

    @property
    def done(self) -> bool:
        return self.req.done

    @property
    def finish_reason(self) -> Optional[str]:
        return self.req.finish_reason

    @property
    def error(self) -> Optional[str]:
        """Rejection / quarantine detail (``finish_reason`` in
        ``{'rejected', 'error'}``), else None."""
        return self.req.error

    def cancel(self) -> bool:
        return self.engine.cancel(self.req)

    def tokens(self, max_steps: int = 10_000):
        """Yield output tokens as they are emitted, stepping the engine
        as needed; returns when the request finishes (or the engine
        runs out of work / ``max_steps``)."""
        sent = steps = 0
        while True:
            while sent < len(self.req.out):
                yield self.req.out[sent]
                sent += 1
            if self.req.done or steps >= max_steps:
                return
            if not self.engine.step():
                return
            steps += 1

    def result(self, max_steps: int = 10_000) -> Request:
        """Block (drive the engine) until the request finishes."""
        for _ in self.tokens(max_steps):
            pass
        return self.req


class Engine:
    """Continuous batching over the paged pool (``paged=True``, requires
    ``kv_bits``): requests share a
    :class:`~repro_torch.serving.paged_cache.PagedKVPool` of ``n_blocks``
    blocks x ``block_size`` tokens on the parameters' device, run under
    the :class:`~repro_torch.serving.scheduler.Scheduler`, and the decode
    batch is whatever is running, padded to the next power-of-two bucket
    (<= ``max_batch``).  With ``prefix_cache`` (default) admission reuses
    pool blocks whose prompt-chain hash matches the head of the request
    and prefills only the suffix; block aliasing is refcounted with
    copy-on-write, so sharing changes memory management, not math:
    greedy decode stays token-identical to ``prefix_cache=False``.
    ``paged`` defaults to True and ``paged=False`` raises (the contiguous
    engine is not ported).
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 max_len: int = 256, quant: Optional[QuantConfig] = None,
                 paged: bool = True, block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 prefix_cache: bool = True,
                 chunk_tokens: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None, faults=None,
                 max_queue: Optional[int] = None,
                 validate_every: Optional[int] = None):
        self.params, self.cfg, self.quant = params, cfg, quant
        self.n_slots, self.max_len = n_slots, max_len
        self.steps = 0
        # per-width QuantConfig cache (nested-precision serving)
        self._quant_cache: dict = {}
        self._seed_counter = 0      # default per-request sampling seeds
        # fault facade (repro_torch.serving.faults): one seeded schedule
        # shared by the pool, scheduler, and engine; NULL_FAULTS (default)
        # is the constant-False twin -- hot path and tokens untouched
        self.faults = faults if faults is not None else NULL_FAULTS
        if max_queue is not None or validate_every is not None:
            raise NotImplementedError(
                "Engine(max_queue=, validate_every=): backpressure and the "
                "pool watchdog are not ported yet (ROADMAP queue 1, item 9)")
        # deadline clock, injectable for deterministic timeout tests; ALL
        # observability timestamps route through it too, so a ServingObs
        # built with its own test clock supplies the engine clock when
        # none is injected here.  The fault facade may wrap it with
        # injected forward jumps
        if clock is None and isinstance(metrics, ServingObs):
            clock = metrics.clock
        self._clock = self.faults.wrap_clock(clock)
        # ``metrics``: None/False = off (NULL_OBS: no-op hooks, no clock
        # reads, token-identical hot path); True = fresh ServingObs;
        # or pass a MetricsRegistry / ServingObs to share a namespace
        if metrics is None or metrics is False:
            self.obs = NULL_OBS
        elif isinstance(metrics, ServingObs):
            self.obs = metrics
            self.obs.clock = self._clock
        elif isinstance(metrics, MetricsRegistry):
            self.obs = ServingObs(registry=metrics, clock=self._clock)
        elif metrics is True:
            self.obs = ServingObs(clock=self._clock)
        else:
            raise TypeError(
                f"metrics: expected None/bool/MetricsRegistry/"
                f"ServingObs, got {type(metrics).__name__}")
        self._deadlines = False     # fast-path: no deadline submitted yet
        self.chunk_tokens_processed = 0
        if not paged:
            raise NotImplementedError(
                "Engine(paged=False): the contiguous engine is not ported "
                "yet (ROADMAP queue 1, item 8); use paged=True")
        M.check_supported(cfg)
        self.chunk_tokens = chunk_tokens
        from repro_torch.serving.paged_cache import PagedKVPool
        from repro_torch.serving.scheduler import Scheduler
        assert max_len % block_size == 0, (max_len, block_size)
        if n_blocks is None:
            # the token capacity of n_slots max_len slabs, plus the
            # reserved null block
            n_blocks = n_slots * (max_len // block_size) + 1
        self.max_batch = max_batch or 2 * n_slots
        self.device = params["embed"]["w"].device
        # NULL_OBS.registry is None -> the pool keeps a private registry,
        # so report() snapshots work with metrics off
        self.pool = PagedKVPool(
            cfg, n_blocks, block_size, quant=quant,
            prefix_cache=prefix_cache, device=self.device,
            metrics=self.obs.registry, faults=self.faults)
        # nested-precision serving needs packed weights to slice; without
        # w_bits every lane runs the configured quant and the scheduler
        # stays unsalted
        tiered = quant is not None and quant.w_bits is not None
        self.scheduler = Scheduler(self.pool, max_len=max_len,
                                   max_batch=self.max_batch,
                                   chunk_tokens=self.chunk_tokens,
                                   obs=self.obs,
                                   precision_policy=(
                                       self._tier_policy if tiered
                                       else None))
        self.n_batch_blocks = max_len // block_size   # table width
        # robustness counters live in the pool's registry, so render()
        # scrapes faults and quarantines next to the serving counters
        reg = self.pool.metrics
        self._c_fault_requests = reg.counter(
            "repro_engine_fault_requests",
            "requests quarantined by step-level containment, by fault "
            "kind", labelnames=("kind",))
        self._fault_children: dict = {}
        self._c_fault_steps = reg.counter(
            "repro_engine_fault_steps",
            "steps aborted by a transient pool fault the scheduler "
            "could not absorb (state intact, step retried)")
        self._c_precision = reg.counter(
            "repro_engine_precision",
            "output tokens emitted per effective serving precision "
            "(weight bits; 'full' = unquantized weights)",
            labelnames=("bits",))
        self._precision_children: dict = {}
        self.faults.bind(reg)

    # -- request lifecycle -------------------------------------------------
    def submit(self, req: Request) -> StreamHandle:
        # double-submit is idempotent: a request this engine already
        # holds (queued or running) just gets a fresh handle -- queueing
        # it twice would double-release through free()'s strict path
        if getattr(req, "_engine", None) is self and not req.done:
            return StreamHandle(self, req)
        req._engine = self
        if getattr(req, "seed", None) is None:
            req.seed = self._seed_counter     # stable across preemption
            self._seed_counter += 1
        if getattr(req, "timeout", None) is not None \
                and getattr(req, "deadline", None) is None:
            req.deadline = self._clock() + req.timeout
        if getattr(req, "deadline", None) is not None:
            self._deadlines = True
        # trace starts BEFORE scheduler.submit so an immediate
        # rejection still closes a balanced span tree
        self.obs.on_submit(req)
        self.scheduler.submit(req)
        return StreamHandle(self, req)

    # -- nested-precision lanes --------------------------------------------
    def _tier_policy(self, req: Request) -> int:
        """Scheduler admission hook: resolve the request's served width
        through :func:`tier_bits` against the queue depth *now*, and
        freeze it on the request -- a preempted request re-admits at
        the SAME bits whatever the queue looks like by then (precision
        never changes mid-request, the tier property suite's
        invariant)."""
        frozen = getattr(req, "_tier_bits", None)
        if frozen is not None:
            return frozen
        q = self.quant
        bits = tier_bits(getattr(req, "precision", None),
                         max_bits=q.w_bits,
                         floor=q.precision_floor,
                         queue_depth=len(self.scheduler.waiting))
        req._tier_bits = bits
        return bits

    def _quant_for(self, bits: Optional[int]) -> Optional[QuantConfig]:
        """QuantConfig for one precision lane, cached per width.

        Full-width lanes reuse ``self.quant`` verbatim.  Narrower lanes get a cached
        ``nested_bits=bits`` copy; the floor is dropped -- it already
        did its job in :meth:`_tier_policy`, and a request granted
        bits below the configured floor (explicitly requested) must
        still validate."""
        q = self.quant
        if bits is None or q is None or bits == q.serve_bits:
            return q
        cached = self._quant_cache.get(bits)
        if cached is None:
            cached = dataclasses.replace(q, nested_bits=bits,
                                         precision_floor=None)
            self._quant_cache[bits] = cached
        return cached

    def cancel(self, req: Request) -> bool:
        """Abort ``req``: no further tokens are emitted and no further
        ``on_token`` callbacks fire; the request releases its blocks through the scheduler's refcount path
        (mid-prefill included).  Returns False if the request already
        finished or is unknown to this engine."""
        if req.done:
            return False
        return self.scheduler.cancel(req)

    def _expire(self) -> None:
        """Finish every request whose deadline has passed: a clean
        completion with ``finish_reason='timeout'`` whose memory
        returns through the same path cancellation uses."""
        if not self._deadlines:
            return
        now = self._clock()

        def expired(req):
            dl = getattr(req, "deadline", None)
            return dl is not None and now >= dl and not req.done

        sch = self.scheduler
        stale = [r for r in list(sch.waiting) if expired(r)]
        stale += [s.req for s in list(sch.running) if expired(s.req)]
        for req in stale:
            sch.cancel(req, reason="timeout")

    def _emit(self, seq, tok: int) -> None:
        """Append an output token and fire ``on_token``: emission order
        == callback order, and a finished request (cancelled/expired by
        another lane's callback mid-step) never reaches here again.

        Callback *exceptions* are isolated per-request: they surface as
        a :class:`RequestFault` the step loop turns into a quarantine of
        this request alone (a callback that cancels/expires requests is
        a supported pattern and raises nothing)."""
        seq.req.out.append(tok)
        self.obs.on_token(seq.req, tok)
        bits = getattr(seq, "precision", None)
        if bits is None:
            q = self.quant
            bits = q.serve_bits if q is not None and q.w_bits else "full"
        child = self._precision_children.get(bits)
        if child is None:
            child = self._c_precision.labels(bits=str(bits))
            self._precision_children[bits] = child
        child.inc()
        if self.faults.callback_error(seq.req):
            raise RequestFault(
                f"injected on_token failure at token "
                f"{len(seq.req.out) - 1}", kind="callback")
        cb = getattr(seq.req, "on_token", None)
        if cb is not None:
            try:
                cb(tok)
            except RequestFault:
                raise
            except Exception as e:
                raise RequestFault(f"on_token callback raised: {e!r}",
                                   kind="callback") from e

    def _sample_checked(self, row: np.ndarray, seq) -> int:
        """Guarded sampling: a non-finite logits row (numerical blowup,
        or the injector's poisoned row) never reaches the sampler --
        it raises a :class:`RequestFault` that quarantines exactly this
        request.  Always on: the finiteness scan is O(V) on a row the
        step already materialized on host."""
        if self.faults.nan_logits(seq.req):
            row = np.full_like(row, np.nan)
        if not np.isfinite(row).all():
            raise RequestFault(
                f"non-finite logits row at output index "
                f"{len(seq.req.out)}", kind="nan_logits")
        return self._sample_token(row, seq)

    def _quarantine(self, seq, exc: Exception) -> None:
        """Step-level containment: retire exactly the offending
        sequence with ``finish_reason='error'``, surfacing the cause on
        ``req.error``; its blocks return through
        the scheduler's refcount path.  The rest of the batch never notices."""
        kind = getattr(exc, "kind", "exception")
        req = seq.req
        if req.error is None:
            req.error = f"quarantined ({kind}): {exc}"
        child = self._fault_children.get(kind)
        if child is None:
            child = self._c_fault_requests.labels(kind=kind)
            self._fault_children[kind] = child
        child.inc()
        if seq in self.scheduler.running:
            self.scheduler.finish(seq, reason="error")
            return
        req.done = True
        req.finish_reason = "error"
        self.obs.on_finish(req, "error", seq=seq)

    # -- device transfer ----------------------------------------------------
    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr, np.int32),
                               device=self.device)

    @staticmethod
    def _host(logits: torch.Tensor) -> np.ndarray:
        return logits.float().cpu().numpy()

    @staticmethod
    def _sample_token(row_logits: np.ndarray, seq) -> int:
        """Sample the next token for ``seq`` (a SequenceState).

        Greedy below temperature 0+; otherwise inverse-CDF over the
        softmax using the request's stateless per-token RNG stream
        (``seq.sample_rng(k)`` for output index k) -- the draw depends
        only on (request seed, output index), never on batch composition
        or preemption history."""
        t = seq.temperature
        if t <= 0.0:
            return int(np.argmax(row_logits))
        z = row_logits.astype(np.float64) / t
        z -= z.max()
        probs = np.exp(z)
        probs /= probs.sum()
        u = seq.sample_rng(len(seq.req.out)).random()
        return int(min(np.searchsorted(np.cumsum(probs), u),
                       len(probs) - 1))

    # -- paged path ----------------------------------------------------------
    def _paged_prefill(self, seq, tokens: np.ndarray):
        """Scheduler admission callback (whole-prompt mode): prefill the
        whole uncached suffix in one pass, then sample the first token
        (or restore the pending input on a warm resume)."""
        start = seq.cached_len
        logits = self._suffix_forward(
            seq, np.asarray(tokens[start:], np.int32), start)
        seq.length = len(tokens)
        if seq.req.out:
            # re-admission after preemption: the pending input token is
            # already known; the recomputed logits would reproduce it
            seq.last_tok = seq.req.out[-1]
        else:
            seq.last_tok = self._sample_checked(logits[0], seq)
            self._emit(seq, seq.last_tok)

    def _suffix_forward(self, seq, suffix: np.ndarray, start: int):
        """B=1 block-table *suffix* forward: chain positions ``start..``
        run through the model and land in ``seq``'s blocks.

        The first ``start`` tokens of the chain are already resident in
        the pool (prefix-cache hit, or -- chunked prefill -- the chunks
        a previous step landed); only ``suffix`` runs through the
        model, at B=1 with its length bucketed to the next power of two
        (pad tokens carry position -1: their pool writes are dropped
        and their attention rows masked, so a varied suffix stream
        runs at O(log max_len) distinct shapes).  The suffix K/V lands
        directly in the request's blocks via the paged scatter write,
        and its queries attend through the shared prefix blocks and the
        fresh suffix in the same kernel pass.  Returns the ``(1, V)``
        f32 logits (host numpy) at the last real suffix token.
        """
        s = len(suffix)
        assert s >= 1, "suffix forward needs >= 1 token to compute"
        p = prefill_bucket(s, self.max_len)
        toks = np.zeros(p, np.int32)
        toks[:s] = suffix
        pos = np.full(p, -1, np.int32)
        pos[:s] = np.arange(start, start + s)
        # bucket the table width like decode does: the kernel grid walks
        # one iteration per table entry
        nbw = min(_next_pow2(max(len(seq.blocks), 1)), self.n_batch_blocks)
        tables = np.zeros((1, nbw), np.int32)   # pad entries: null block
        tables[0, :len(seq.blocks)] = seq.blocks
        batch = {"tokens": self._dev(toks[None]),
                 "positions": self._dev(pos[None]),
                 "last_idx": self._dev(np.asarray([s - 1], np.int32))}
        caches = self.pool.step_caches(tables, np.asarray([start], np.int32))
        quant = self._quant_for(getattr(seq, "precision", None))
        logits, caches = prefill_step_bucketed(
            self.params, batch, caches, self.cfg, quant)
        self.pool.absorb(caches)
        return self._host(logits)

    def _decode_bucket(self, n: int) -> int:
        return min(_next_pow2(n), self.max_batch)

    def _paged_step(self) -> bool:
        sch = self.scheduler
        obs = self.obs
        t0 = obs.t() if obs.enabled else 0.0
        self._expire()
        try:
            if self.chunk_tokens is None:
                # whole-prompt mode: admission prefills, the step decodes
                sch.admit(self._paged_prefill)
                if not sch.running:
                    # fault-free, an empty step means an empty engine;
                    # with injection on, an admission race/rollback can
                    # leave work waiting -- report it so run() retries
                    return self.faults.enabled and sch.has_work
                sch.ensure_append_capacity()  # reclaims out-of-window too
                plan = [(s, 1) for s in sch.running]
            else:
                sch.admit_chunked()
                plan = sch.ensure_step_capacity(sch.plan_step())
                if not plan:
                    return self.faults.enabled and sch.has_work
        except RuntimeError:
            # a transient pool fault the scheduler could not absorb by
            # preempting (e.g. injected exhaustion with one request
            # left).  Alloc is atomic and the rollback paths ran, so
            # state is intact: consume the step and retry on the next
            # one.  Grown blocks stay owned by their seqs (reused next
            # step, no leak)
            self._c_fault_steps.inc()
            self.steps += 1
            return sch.has_work
        chunk_used = 0
        if obs.enabled and self.chunk_tokens is not None:
            chunk_used = sum(n for s, n in plan if s.prefilling)
        tf0 = obs.t() if obs.enabled else 0.0
        rows = self._forward_plan(plan)
        tf1 = obs.t() if obs.enabled else 0.0
        self._advance(plan, rows, tf0, tf1)
        if obs.enabled:
            self.pool.sync_gauges()
            obs.on_step(
                t0, running=len(sch.running), waiting=len(sch.waiting),
                chunk_used=chunk_used, chunk_budget=self.chunk_tokens,
                occupancy=(self.pool.used_blocks
                           / max(self.pool.n_usable, 1)
                           if self.pool.needs_blocks else None))
        return True

    def _forward_plan(self, plan) -> list:
        """Run the planned step's forward pass(es); returns per-entry
        logits rows aligned with ``plan``.

        Everything fuses into ONE dispatch (:meth:`_fused_forward`)
        whenever a chunk of more than one token is in flight; otherwise
        decodes run the ``(B, 1)`` :func:`serve_step` and a one-token
        chunk its own suffix forward."""
        if any(n > 1 for _, n in plan):
            return self._fused_forward(plan)
        rows: list = [None] * len(plan)
        decodes = [(i, s) for i, (s, n) in enumerate(plan)
                   if not s.prefilling]
        for i, (seq, n) in enumerate(plan):
            if not seq.prefilling:
                continue
            toks = np.asarray(seq.pending[seq.length:seq.length + n],
                              np.int32)
            rows[i] = self._suffix_forward(seq, toks, seq.length)[0]
        if decodes:
            logits = self._decode_forward([s for _, s in decodes])
            for j, (i, _) in enumerate(decodes):
                rows[i] = logits[j]
        return rows

    @staticmethod
    def _precision_groups(seqs, key):
        """Distinct served widths among ``seqs`` (via ``key``), widest
        first -- a stable grouping order so mixed-precision steps
        dispatch deterministically."""
        return sorted({key(s) for s in seqs},
                      key=lambda b: (b is None, -(b or 0)))

    def _decode_forward(self, running):
        """Decode forward over ``running``, grouped per served
        precision: a mixed batch dispatches once per distinct width over
        that width's lanes.  A
        homogeneous batch -- the common case, and every pre-nested
        config -- is exactly one dispatch, unchanged.  Returns logits
        rows indexable by position in ``running``."""
        groups = self._precision_groups(running, lambda s: s.precision)
        if len(groups) <= 1:
            return self._decode_dispatch(running)
        rows: list = [None] * len(running)
        for bits in groups:
            idx = [i for i, s in enumerate(running) if s.precision == bits]
            logits = self._decode_dispatch([running[i] for i in idx])
            for j, i in enumerate(idx):
                rows[i] = logits[j]
        return rows

    def _decode_dispatch(self, running) -> np.ndarray:
        """One bucketed ``(B, 1)`` decode dispatch over ``running``
        (all lanes at one served precision); returns the (bucketed)
        f32 logits rows."""
        bb = self._decode_bucket(len(running))
        # bucket the table width too: the paged kernel's grid walks one
        # iteration per table entry, so a full-width (max_len/block_size)
        # table would make every decode step pay for the longest possible
        # sequence -- exactly the over-allocation paging removes.  With
        # sliding-window reclaim the tables are rolling windows, so the
        # width (and the kernel grid, and the HBM the step moves) stays
        # O(window/block_size) however long the generation runs
        nb = min(_next_pow2(max(len(s.blocks) for s in running) or 1),
                 self.n_batch_blocks)
        if self.obs.enabled:
            self.obs.on_dispatch(live=len(running), lanes=bb,
                                 tok_live=len(running), tok_lanes=bb)
        toks = np.zeros(bb, np.int32)
        pos = np.full(bb, -1, np.int32)       # pad lanes: masked everywhere
        lens = np.zeros(bb, np.int32)
        tables = np.zeros((bb, nb), np.int32)  # 0 = the null block
        offsets = np.zeros(bb, np.int32)       # reclaimed logical blocks
        for i, seq in enumerate(running):
            toks[i], pos[i], lens[i] = seq.last_tok, seq.length, seq.length
            tables[i, :len(seq.blocks)] = seq.blocks
            offsets[i] = seq.freed_prefix
        batch = {"tokens": self._dev(toks[:, None]),
                 "positions": self._dev(pos[:, None])}
        caches = self.pool.step_caches(tables, lens, block_offsets=offsets)
        quant = self._quant_for(running[0].precision)
        logits, caches = serve_step(self.params, batch, caches, self.cfg,
                                    quant)
        self.pool.absorb(caches)
        return self._host(logits)

    def _fused_forward(self, plan) -> list:
        """Fused decode + chunk-prefill forward, grouped per served
        precision like :meth:`_decode_forward`: one
        :meth:`_fused_dispatch` per distinct width over that width's
        plan entries.  Homogeneous plans (every pre-nested config) fuse
        into exactly ONE dispatch, unchanged."""
        groups = self._precision_groups(plan, lambda e: e[0].precision)
        if len(groups) <= 1:
            return self._fused_dispatch(plan)
        rows: list = [None] * len(plan)
        for bits in groups:
            idx = [i for i, (s, _) in enumerate(plan)
                   if s.precision == bits]
            sub = self._fused_dispatch([plan[i] for i in idx])
            for j, i in enumerate(idx):
                rows[i] = sub[j]
        return rows

    def _fused_dispatch(self, plan) -> list:
        """ONE dispatch for a mixed decode + chunk-prefill step.

        Decode lanes carry 1 real token, chunk lanes up to
        ``chunk_tokens``, padded to a common bucketed ``(B, S)``; pad
        tokens carry position -1 (attention rows masked, pool writes
        dropped) exactly like bucketed prefill pads, and the Sq>=1
        paged kernel masks causality by absolute position per row, so
        lanes of different real lengths coexist in one grid.  Per-lane
        logits are gathered at ``last_idx`` (the lane's last real
        token)."""
        bb = self._decode_bucket(len(plan))
        smax = max(n for _, n in plan)
        sq = prefill_bucket(smax, self.max_len)
        nb = min(_next_pow2(max(len(s.blocks) for s, _ in plan) or 1),
                 self.n_batch_blocks)
        if self.obs.enabled:
            self.obs.on_dispatch(live=len(plan), lanes=bb,
                                 tok_live=sum(n for _, n in plan),
                                 tok_lanes=bb * sq)
        toks = np.zeros((bb, sq), np.int32)
        pos = np.full((bb, sq), -1, np.int32)  # pads: masked everywhere
        last = np.zeros(bb, np.int32)
        lens = np.zeros(bb, np.int32)
        tables = np.zeros((bb, nb), np.int32)  # 0 = the null block
        offsets = np.zeros(bb, np.int32)
        for i, (seq, n) in enumerate(plan):
            if seq.prefilling:
                toks[i, :n] = np.asarray(
                    seq.pending[seq.length:seq.length + n], np.int32)
            else:
                toks[i, 0] = seq.last_tok
            pos[i, :n] = np.arange(seq.length, seq.length + n)
            last[i], lens[i] = n - 1, seq.length
            tables[i, :len(seq.blocks)] = seq.blocks
            offsets[i] = seq.freed_prefix
        batch = {"tokens": self._dev(toks), "positions": self._dev(pos),
                 "last_idx": self._dev(last)}
        caches = self.pool.step_caches(tables, lens, block_offsets=offsets)
        quant = self._quant_for(plan[0][0].precision)
        logits, caches = prefill_step_bucketed(
            self.params, batch, caches, self.cfg, quant)
        self.pool.absorb(caches)
        logits = self._host(logits)
        return [logits[i] for i in range(len(plan))]

    def _advance(self, plan, rows, t_fwd0: float = 0.0,
                 t_fwd1: float = 0.0) -> None:
        """Consume a step's logits: advance lengths, sample/emit decode
        tokens (and the first token of a request whose prefill just
        completed), finish what is done.  ``t_fwd0``/``t_fwd1`` bound
        the step's forward pass (engine clock) -- each landed chunk is
        traced as a closed ``chunk_prefill`` span over that window."""
        sch = self.scheduler
        obs = self.obs
        self.steps += 1
        for (seq, n), row in zip(plan, rows):
            if seq.req.done:    # cancelled/expired by a callback mid-step
                continue
            try:
                if seq.prefilling:
                    seq.length += n
                    self.chunk_tokens_processed += n
                    if obs.enabled:
                        obs.on_chunk(seq, n, t_fwd0, t_fwd1)
                    sch.register_progress(seq)
                    if seq.length < len(seq.pending):
                        continue               # more chunks to stream
                    seq.pending = None
                    obs.on_decode_begin(seq)
                    if seq.req.out:
                        # warm resume: the pending input token is known
                        seq.last_tok = seq.req.out[-1]
                        continue
                    seq.last_tok = self._sample_checked(row, seq)
                    self._emit(seq, seq.last_tok)
                else:
                    seq.last_tok = self._sample_checked(row, seq)
                    self._emit(seq, seq.last_tok)
                    seq.length += 1
                if len(seq.req.out) >= seq.req.max_new_tokens \
                        or seq.length >= self.max_len - 1:
                    sch.finish(seq)
            except RequestFault as e:
                # step-level containment: retire exactly this sequence;
                # the other plan entries consume their rows untouched
                self._quarantine(seq, e)

    # -- decode loop --------------------------------------------------------
    def step(self) -> bool:
        """One batched decode step across all active requests."""
        return self._paged_step()

    def run(self, max_steps: int = 10_000):
        while self.steps < max_steps and self._has_work():
            if not self.step():
                break

    def _has_work(self) -> bool:
        return self.scheduler.has_work

    def report(self) -> dict:
        """Occupancy snapshot: the pool's accounting plus the queue."""
        rep = self.pool.report(
            tokens_resident=self.scheduler.tokens_resident())
        rep.update(running=len(self.scheduler.running),
                   waiting=len(self.scheduler.waiting),
                   preemptions=self.scheduler.n_preemptions,
                   rejections=self.scheduler.n_rejections,
                   chunk_tokens=self.chunk_tokens,
                   chunk_tokens_processed=self.chunk_tokens_processed)
        return rep
