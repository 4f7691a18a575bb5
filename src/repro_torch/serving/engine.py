"""Serving runtime of the port: the contiguous and the paged
continuous-batching engines.

A port of the reference ``repro.serving.engine``, in two memory regimes:

* **contiguous** (``paged=False``, the default): a fixed decode batch of
  ``n_slots`` lanes, each lane owning one request's ``(max_len,)`` KV
  ring (a ring of the window for sliding-window archs); a request
  prefills alone at B=1 with its prompt bucketed to a power of two, its
  cache rows are copied into a free lane, and decode advances every
  lane in lock-step.
* **paged** (``paged=True``): requests share a refcounted copy-on-write
  block pool of packed bipolar-INT KV planes
  (:mod:`repro_torch.serving.paged_cache`) addressed through per-request
  block tables and scheduled by :mod:`repro_torch.serving.scheduler` --
  FCFS admission gated on free blocks, decode batches bucketed to powers
  of two, preemption with warm restart when the pool runs dry, and the
  prefix cache: admission acquires the cached blocks of a common prompt
  prefix and prefills only the suffix, directly through the block table.
  SSM and hybrid stacks keep each request's conv + SSD state in one slot
  of the pool's fixed-size *state slot pool*; their prompts prefill at
  exact length (a recurrence consumes pad tokens), and they share no
  prefix.  An enc-dec stack (audio) keeps each request's cross-attention
  K/V (its encoder memory, projected once at prefill) in a state slot
  too, and shares no prefix either; a VLM shares none, since equal
  tokens need not carry equal patch embeddings.

The VLM and audio frontends are stubs, as in the reference: a prefill
adds zero patch embeddings ``(1, min(n_patches, p), d_model)`` to the
first tokens (``p`` the bucketed prompt length) and runs the encoder on
zero frames ``(1, enc_len(cfg, p), frontend_dim)``; VLM positions are
``(3, B, S)``, the same position on every M-RoPE axis.  Those families
prefill whole prompts: ``chunk_tokens`` is dropped for them.

**Chunked prefill** (``chunk_tokens``, paged only): a prompt streams
through the step loop ``chunk_tokens`` at a time, fused with the decode
batch into one bucketed ``(B, S)`` dispatch (:meth:`Engine._fused_dispatch`)
whose pad rows are position-masked; running decodes emit a token every
step while a long prompt trickles in.  A stateful stack's mixed step
splits instead: one bucketed decode dispatch, plus one exact-length B=1
dispatch per chunk lane that continues the lane's slot state.

The submit/stream API (:class:`StreamHandle`, ``on_token`` callbacks,
deadlines, cancellation), the observability hooks (``metrics=``, default
the no-op ``NULL_OBS``; paged MoE stacks report their capacity telemetry
through ``obs.on_moe`` when metrics are on), fault containment
(``faults=``), nested-precision lanes (``Request.precision``, paged),
backpressure (``max_queue=``: submits past a full waiting queue are shed
with a ``retry_after`` hint, :meth:`StreamHandle.resubmit` backs off and
submits again) and the pool watchdog (``validate_every=``: the paged
pool's invariant check every few steps, recovering from a violation by
rebuilding the pool's bookkeeping from the block tables) are the
reference's, unchanged.

Where the reference jit-compiles one program per bucket, the port runs
eagerly: :func:`prefill_step`, :func:`prefill_step_bucketed` and
:func:`serve_step` are plain functions, and every quantized linear,
every attention read over packed KV and every weight pack on the card
is a launch of a hand-written kernel.
"""

from __future__ import annotations

import dataclasses
import time
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

def prefill_step(params, batch: dict, caches, cfg: ModelConfig,
                 quant: Optional[QuantConfig] = None):
    """Process a full prompt ``batch`` = tokens (B, S), positions (B, S)
    (default ``0..S-1``) and the stub frontends' ``patch_embeds`` /
    ``frames``, filling the caches.  Returns ``(last_logits (B, V),
    caches)``."""
    return M.forward(params, batch["tokens"], cfg,
                     positions=batch.get("positions"), caches=caches,
                     patch_embeds=batch.get("patch_embeds"),
                     frames=batch.get("frames"),
                     quant=quant, logits_mode="last")


def prefill_step_bucketed(params, batch: dict, caches, cfg: ModelConfig,
                          quant: Optional[QuantConfig] = None,
                          moe_stats: bool = False):
    """Forward a length-bucketed ``(B, S)`` batch (pad positions -1,
    masked everywhere) and take the logits at ``batch["last_idx"]`` (B,)
    -- each lane's last *real* token.  Returns ``(logits (B, V),
    caches)``, plus the per-MoE-layer capacity telemetry dict when
    ``moe_stats=True``."""
    out = M.forward(params, batch["tokens"], cfg,
                    positions=batch["positions"], caches=caches,
                    patch_embeds=batch.get("patch_embeds"),
                    frames=batch.get("frames"),
                    quant=quant, logits_mode="none",
                    collect_moe_stats=moe_stats)
    x, caches = out[:2]
    idx = batch["last_idx"].long()
    xl = x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]
    logits = M._logits(params, xl, cfg, quant)
    return (logits[:, 0], caches) + out[2:]


def serve_step(params, batch: dict, caches, cfg: ModelConfig,
               quant: Optional[QuantConfig] = None, moe_stats: bool = False):
    """One decode step: one new token per sequence, ``batch`` = tokens
    (B, 1), positions (B, 1).  Returns ``(logits (B, V), caches)``, plus
    the capacity telemetry dict when ``moe_stats=True``."""
    return M.forward(params, batch["tokens"], cfg,
                     positions=batch["positions"], caches=caches,
                     quant=quant, logits_mode="last",
                     collect_moe_stats=moe_stats)


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
    # backpressure hint: seconds to wait before resubmitting, set when
    # the engine sheds this request off a full queue (max_queue)
    retry_after: Optional[float] = None

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

    @property
    def retry_after(self) -> Optional[float]:
        """Backpressure hint attached when the engine shed this request
        off a full queue."""
        return self.req.retry_after

    def cancel(self) -> bool:
        return self.engine.cancel(self.req)

    def resubmit(self, max_attempts: int = 5, base_delay: float = 0.05,
                 max_delay: float = 2.0,
                 sleep: Optional[Callable[[float], None]] = None
                 ) -> "StreamHandle":
        """Client-side backoff helper: while the request sits shed
        (``finish_reason='rejected'``), wait max(engine ``retry_after``
        hint, capped exponential backoff) and submit it again.  Returns
        self once the request is back in the engine (drive it with
        :meth:`tokens`/:meth:`result` as usual) or after
        ``max_attempts`` consecutive sheds.  ``sleep`` is injectable so
        tests back off on a fake clock."""
        sleep = time.sleep if sleep is None else sleep
        for attempt in range(max_attempts):
            if not (self.req.done and self.req.finish_reason == "rejected"):
                return self
            sleep(min(max_delay, max(self.req.retry_after or 0.0,
                                     base_delay * (2 ** attempt))))
            self._reset_for_resubmit()
            self.engine.submit(self.req)
        return self

    def _reset_for_resubmit(self) -> None:
        """Clear the terminal fields a shed left behind so the request
        can go through ``submit`` again (deadline is recomputed from
        ``timeout``; emitted tokens are untouched -- a shed request
        never emitted any)."""
        r = self.req
        r.done = False
        r.error = None
        r.finish_reason = None
        r.retry_after = None
        r.deadline = None
        r._engine = None       # re-arm the double-submit guard

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


def _tree_write_slot(batched: dict, single: dict, slot: int) -> dict:
    """Copy a B=1 cache tree into row ``slot`` of the batched one, in
    place (the reference returns a new tree; here each layer's cache is
    the one copy on the device).  Both trees are ``{"layers": [one dict
    per layer]}`` (an enc-dec model's also ``"cross"``) with every leaf's
    batch dim first.  A prefilled cross cache holds the prompt's
    ``enc_len`` rows, which may be fewer than the lane's: it lands in the
    lane's leading rows, and the rest get position -1 (masked), as the
    paged path's ``_write_cross_slots`` writes them, so a lane that served
    a longer prompt cannot leak that request's encoder memory into the
    next one."""
    for section in ("layers", "cross"):
        for cb, cs in zip(batched.get(section, []), single.get(section, [])):
            for key, leaf in cb.items():
                src = cs[key][0]
                if src.ndim:
                    leaf[slot, :src.shape[0]] = src
                    if section == "cross" and key == "pos":
                        leaf[slot, src.shape[0]:] = -1
                else:                           # a ring's write index
                    leaf[slot] = src
    return batched


class Engine:
    """Continuous batching, contiguous or paged.

    Contiguous (default): each of the ``n_slots`` decode lanes owns one
    request at a time; prefill runs per request at B=1 (bucketed, see
    :func:`prefill_bucket`) and the filled cache rows are copied into
    the lane's row of the batched cache; decode advances all active
    lanes in lock-step.

    Paged (``paged=True``; a stack with attention needs ``kv_bits``): requests share a
    :class:`~repro_torch.serving.paged_cache.PagedKVPool` of ``n_blocks``
    blocks x ``block_size`` tokens on the parameters' device, run under
    the :class:`~repro_torch.serving.scheduler.Scheduler`, and the decode
    batch is whatever is running, padded to the next power-of-two bucket
    (<= ``max_batch``).  With ``prefix_cache`` (default) admission reuses
    pool blocks whose prompt-chain hash matches the head of the request
    and prefills only the suffix; block aliasing is refcounted with
    copy-on-write, so sharing changes memory management, not math:
    greedy decode stays token-identical to the contiguous engine (and to
    ``prefix_cache=False``) at equal ``kv_bits``.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 max_len: int = 256, quant: Optional[QuantConfig] = None,
                 paged: bool = False, block_size: int = 16,
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
        self.paged = paged
        self.steps = 0
        # per-width QuantConfig cache (nested-precision serving)
        self._quant_cache: dict = {}
        self._seed_counter = 0      # default per-request sampling seeds
        # fault facade (repro_torch.serving.faults): one seeded schedule
        # shared by the pool, scheduler, and engine; NULL_FAULTS (default)
        # is the constant-False twin -- hot path and tokens untouched
        self.faults = faults if faults is not None else NULL_FAULTS
        # backpressure: bound on the waiting queue; submits past it are
        # shed with finish_reason='rejected' + a retry_after hint
        self.max_queue = max_queue
        # pool integrity watchdog cadence (steps between validate runs)
        assert validate_every is None or validate_every >= 1, validate_every
        self.validate_every = validate_every
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
        # MoE capacity telemetry: collected (and moved to the host) only
        # when observability is on AND the stack has MoE layers
        self._moe_telemetry = bool(
            self.obs.enabled
            and any(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers)))
        self.chunk_tokens_processed = 0
        if chunk_tokens is not None and not paged:
            raise ValueError("chunk_tokens requires paged=True (chunked "
                             "prefill writes through the block pool)")
        M.check_supported(cfg)
        # whole-prompt frontends (vlm patch embeds, audio encoder frames)
        # fill their side inputs in one prefill pass: those families keep
        # whole-prompt admission
        if chunk_tokens is not None and cfg.family in ("vlm", "audio"):
            chunk_tokens = None
        self.chunk_tokens = chunk_tokens
        self.device = params["embed"]["w"].device
        if paged:
            from repro_torch.serving.paged_cache import (PagedKVPool,
                                                         needs_state_slots)
            from repro_torch.serving.scheduler import Scheduler
            assert max_len % block_size == 0, (max_len, block_size)
            if n_blocks is None:
                # the token capacity of n_slots contiguous lanes, plus
                # the reserved null block
                n_blocks = n_slots * (max_len // block_size) + 1
            self.max_batch = max_batch or 2 * n_slots
            stateful = needs_state_slots(cfg)
            enc = None
            if cfg.family == "audio":
                from repro_torch.launch.specs import enc_len
                enc = enc_len(cfg, max_len)
            # the engine's VLM frontend is a stub (zero patch embeds), but
            # real per-request patch embeds would make equal token
            # prefixes carry different KV: the prefix cache stays off for
            # vlm.  Stateful archs (ssm/hybrid/audio) keep it off too: SSM
            # state is an order-dependent running summary, not
            # block-addressable content, and cross caches are per
            # request, so there is no prefix to share.  NULL_OBS.registry
            # is None -> the pool keeps a private registry, so report()
            # snapshots work with metrics off
            self.pool = PagedKVPool(
                cfg, n_blocks, block_size, quant=quant,
                prefix_cache=(prefix_cache and cfg.family != "vlm"
                              and not stateful),
                n_state_slots=self.max_batch if stateful else 0,
                enc_len=enc, device=self.device,
                metrics=self.obs.registry, faults=self.faults)
            # nested-precision serving needs packed weights to slice;
            # without w_bits every lane runs the configured quant and the
            # scheduler stays unsalted
            tiered = quant is not None and quant.w_bits is not None
            self.scheduler = Scheduler(self.pool, max_len=max_len,
                                       max_batch=self.max_batch,
                                       chunk_tokens=self.chunk_tokens,
                                       obs=self.obs,
                                       precision_policy=(
                                           self._tier_policy if tiered
                                           else None))
            self.n_batch_blocks = max_len // block_size   # table width
        else:
            self.caches = M.init_caches(cfg, n_slots, max_len, quant=quant,
                                        device=self.device)
            self.slot_req: list = [None] * n_slots   # SequenceState per lane
            self.queue: list = []
        # robustness counters: in the pool's registry (paged) or the obs
        # registry / a private one (contiguous), so render() scrapes
        # faults, quarantines and sheds next to the serving counters
        reg = self.pool.metrics if paged \
            else (self.obs.registry or MetricsRegistry())
        self._c_fault_requests = reg.counter(
            "repro_engine_fault_requests",
            "requests quarantined by step-level containment, by fault "
            "kind", labelnames=("kind",))
        self._fault_children: dict = {}
        self._c_fault_steps = reg.counter(
            "repro_engine_fault_steps",
            "steps aborted by a transient pool fault the scheduler "
            "could not absorb (state intact, step retried)")
        self._c_watchdog = reg.counter(
            "repro_engine_fault_watchdog_violations",
            "pool invariant violations caught by the validate_every "
            "watchdog (corrupt chains quarantined, free lists rebuilt)")
        self._c_shed = reg.counter(
            "repro_sched_shed_requests",
            "submits shed by the max_queue backpressure bound")
        self._g_retry_after = reg.gauge(
            "repro_sched_shed_retry_after",
            "retry_after hint attached to the most recent shed (s)")
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
        depth = len(self.scheduler.waiting) if self.paged \
            else len(self.queue)
        if self.max_queue is not None and depth >= self.max_queue:
            self._shed(req, depth)
            return StreamHandle(self, req)
        if self.paged:
            self.scheduler.submit(req)
        else:
            self.queue.append(req)
        return StreamHandle(self, req)

    def _shed(self, req: Request, depth: int) -> None:
        """Backpressure: the waiting queue is at ``max_queue`` -- finish
        the request immediately with ``finish_reason='rejected'`` and a
        ``retry_after`` hint that grows with queue depth and pool
        occupancy (deterministic, so shed/backoff behavior replays)."""
        if self.paged and self.pool.needs_blocks:
            occ = self.pool.used_blocks / max(self.pool.n_usable, 1)
        elif self.paged:      # a pure-SSM pool: state slots only
            occ = (self.pool.slots.used_slots
                   / max(self.pool.slots.n_slots, 1))
        else:
            occ = (sum(r is not None for r in self.slot_req)
                   / max(self.n_slots, 1))
        req.retry_after = 0.05 * (depth + 1) * (1.0 + occ)
        req.error = (f"rejected: queue full ({depth} waiting >= "
                     f"max_queue={self.max_queue})")
        req.done = True
        req.finish_reason = "rejected"
        self._c_shed.inc()
        self._g_retry_after.set(req.retry_after)
        self.obs.on_finish(req, "rejected")

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
        ``on_token`` callbacks fire; paged requests release their blocks
        through the scheduler's refcount path (mid-prefill included), a
        contiguous lane is vacated.  Returns False if the request already
        finished or is unknown to this engine."""
        if req.done:
            return False
        if self.paged:
            return self.scheduler.cancel(req)
        if req in self.queue:
            self.queue.remove(req)
        else:
            for i, seq in enumerate(self.slot_req):
                if seq is not None and seq.req is req:
                    self.slot_req[i] = None
                    break
            else:
                return False
        req.done, req.finish_reason = True, "cancelled"
        self.obs.on_finish(req, "cancelled")
        return True

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

        if self.paged:
            sch = self.scheduler
            stale = [r for r in list(sch.waiting) if expired(r)]
            stale += [s.req for s in list(sch.running) if expired(s.req)]
            for req in stale:
                sch.cancel(req, reason="timeout")
            return
        for req in [r for r in self.queue if expired(r)]:
            self.queue.remove(req)
            req.done, req.finish_reason = True, "timeout"
            self.obs.on_finish(req, "timeout")
        for i, seq in enumerate(self.slot_req):
            if seq is not None and expired(seq.req):
                self.slot_req[i] = None
                seq.req.done, seq.req.finish_reason = True, "timeout"
                self.obs.on_finish(seq.req, "timeout", seq=seq)

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
        ``req.error``; paged blocks return through the scheduler's
        refcount path, a contiguous lane is simply vacated.  The rest of
        the batch never notices."""
        kind = getattr(exc, "kind", "exception")
        req = seq.req
        if req.error is None:
            req.error = f"quarantined ({kind}): {exc}"
        child = self._fault_children.get(kind)
        if child is None:
            child = self._c_fault_requests.labels(kind=kind)
            self._fault_children[kind] = child
        child.inc()
        if self.paged and seq in self.scheduler.running:
            self.scheduler.finish(seq, reason="error")
            return
        if not self.paged:
            for i, s in enumerate(self.slot_req):
                if s is seq:
                    self.slot_req[i] = None
                    break
        req.done = True
        req.finish_reason = "error"
        self.obs.on_finish(req, "error", seq=seq)

    # -- pool integrity watchdog -------------------------------------------
    def _watchdog(self) -> None:
        """``validate_every`` cadence: run the pool's full invariant
        checker off the hot path; on violation, recover instead of
        raising -- quarantine the chains whose tables are corrupt and
        rebuild the pool's bookkeeping from the survivors."""
        try:
            self.pool.validate()
        except AssertionError:
            self._c_watchdog.inc()
            self._rebuild_pool()

    def _rebuild_pool(self) -> None:
        """Recover a pool whose invariants broke: block tables are the
        ground truth.  Sequences whose table is self-evidently corrupt
        (out-of-range, null, or duplicated block ids; impossible slot)
        are quarantined *bypassing* release -- their references cannot
        be trusted against the refcount map.  Every derived structure
        is then rebuilt from the surviving tables: refcounts from a
        table-reference count, the free list as the unreferenced ids,
        the state-slot pool from the surviving slots.  The prefix cache is
        dropped wholesale (hits become misses; math unchanged) and chain
        memos reset.  Ends with a full ``validate()`` -- recovery must
        restore the invariants it is guarding, not defer them."""
        from collections import Counter as _Counter
        from repro_torch.serving.paged_cache import ChainMemo
        pool, sch = self.pool, self.scheduler

        def table_corrupt(s) -> bool:
            seen = set()
            for b in s.blocks:
                b = int(b)
                if b < 1 or b > pool.n_usable or b in seen:
                    return True
                seen.add(b)
            return pool.slots is not None and s.slot >= 0 \
                and not 1 <= s.slot <= pool.slots.n_slots
        bad = [s for s in sch.running if table_corrupt(s)]
        for seq in bad:
            sch.running.remove(seq)
            seq.blocks = []
            seq.slot = -1
            self._quarantine(
                seq, RequestFault("pool integrity violation: block "
                                  "table corrupt", kind="watchdog"))
        counts = _Counter(int(b) for s in sch.running for b in s.blocks)
        pool._ref = dict(counts)
        pool._lru.clear()            # prefix cache dropped wholesale
        pool._meta.clear()
        pool._full_index.clear()
        pool._partial_index.clear()
        pool._free = [b for b in range(pool.n_blocks - 1, 0, -1)
                      if b not in counts]
        if pool.slots is not None:
            used = {s.slot for s in sch.running if s.slot >= 1}
            pool.slots._used = used
            pool.slots._free = [i for i in range(pool.slots.n_slots, 0, -1)
                                if i not in used]
        for seq in sch.running:
            seq.chain_memo = ChainMemo()
        pool.version += 1
        sch._blocked_head = None
        pool.validate()

    def _step(self, step_fn, batch: dict, caches, quant):
        """Run one forward step (:func:`prefill_step_bucketed` or
        :func:`serve_step`); with MoE telemetry on, its capacity stats go
        to ``obs.on_moe``.  Returns ``(logits, caches)``."""
        if not self._moe_telemetry:
            return step_fn(self.params, batch, caches, self.cfg, quant)
        logits, caches, mst = step_fn(self.params, batch, caches, self.cfg,
                                      quant, moe_stats=True)
        self.obs.on_moe(mst)
        return logits, caches

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

    # -- contiguous path -----------------------------------------------------
    def _admit(self):
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self._prefill_into(req, slot)

    @property
    def _bucketable(self) -> bool:
        """Prompt lengths may pad to pow2 buckets only when every mixer
        masks by position: SSM/hybrid recurrences consume pad tokens
        regardless, so those archs prefill at exact length (one rule
        for the contiguous AND paged prefill paths -- diverging them
        would break paged-vs-contiguous token identity)."""
        return all(self.cfg.layer_kind(i) == "attn"
                   for i in range(self.cfg.n_layers))

    def _bucketed_prefill(self, prompt: np.ndarray):
        """Prefill one prompt at B=1 with length bucketing.

        Returns ``(logits (1, V) at the last real token, filled B=1
        cache)``.  Pad tokens carry position -1: they are masked out of
        every attention read and land in the cache as invalid slots that
        decode overwrites (the ring index is rewound to the real length
        below).  SSM/hybrid archs prefill at exact length -- the
        recurrence consumes every input regardless of position, so pads
        would corrupt the cached state."""
        s = len(prompt)
        ring = min(self.max_len, self.cfg.window) if self.cfg.window \
            else self.max_len
        p = prefill_bucket(s, ring) if self._bucketable else s
        one = M.init_caches(self.cfg, 1, self.max_len, quant=self.quant,
                            device=self.device)
        toks = np.zeros(p, np.int32)
        toks[:s] = np.asarray(prompt, np.int32)
        pos = np.full(p, -1, np.int32)
        pos[:s] = np.arange(s)
        batch = self._prefill_batch(toks, pos, s)
        logits, one = prefill_step_bucketed(self.params, batch, one,
                                            self.cfg, self.quant)
        return logits, self._rewind_ring_index(one, s, p)

    def _positions(self, pos: np.ndarray) -> torch.Tensor:
        """``pos (B, S)`` on the device; ``(3, B, S)`` for a VLM, the
        same position on every M-RoPE axis (the engine's text-only
        frontend)."""
        t = self._dev(pos)
        if self.cfg.family == "vlm":
            t = t[None].expand(3, *pos.shape).contiguous()
        return t

    def _prefill_batch(self, toks: np.ndarray, pos: np.ndarray,
                       s: int) -> dict:
        """The B=1 prefill batch of a prompt padded to ``p = len(toks)``
        whose last real token is at ``s - 1``, with the stub frontends'
        inputs: zero patch embeddings for a VLM, zero encoder frames
        ``(1, enc_len(cfg, p), frontend_dim)`` for an enc-dec model."""
        cfg, p = self.cfg, len(toks)
        batch = {"tokens": self._dev(toks[None]),
                 "positions": self._positions(pos[None]),
                 "last_idx": self._dev(np.asarray([s - 1], np.int32))}
        dt = getattr(torch, cfg.dtype)
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (1, min(cfg.n_patches, p), cfg.d_model), dtype=dt,
                device=self.device)
        if cfg.family == "audio":
            from repro_torch.launch.specs import enc_len
            batch["frames"] = torch.zeros(
                (1, enc_len(cfg, p), cfg.frontend_dim), dtype=dt,
                device=self.device)
        return batch

    @staticmethod
    def _rewind_ring_index(caches, s: int, p: int):
        """Point each KV ring's write index at the first *pad* slot.

        The prefill write advanced ``index`` by the padded length ``p``;
        left alone, decode would skip the ``p - s`` pad slots (wasting
        ring capacity) or -- when ``p`` wraps the ring -- overwrite live
        prompt KV.  The first pad sits at ``s`` (normal write) or
        ``s - (p - ring)`` (the sliding-window tail store keeps the last
        ``ring`` entries), i.e. ``(s - max(0, p - ring)) % ring``.  A
        mamba layer's conv + state cache has no ring."""
        def fix(c):
            if "index" not in c:
                return c
            ring = c["pos"].shape[-1]
            idx = (s - max(0, p - ring)) % ring
            return dict(c, index=torch.full_like(c["index"], idx))

        return dict(caches, layers=[fix(c) for c in caches["layers"]])

    def _prefill_into(self, req: Request, slot: int):
        from repro_torch.serving.scheduler import SequenceState
        obs = self.obs
        seq = SequenceState(req=req, length=len(req.prompt))
        obs.on_admit(seq, prefilling=True)
        t0 = obs.t() if obs.enabled else 0.0
        logits, one = self._bucketed_prefill(req.prompt)
        self.caches = _tree_write_slot(self.caches, one, slot)
        if obs.enabled:
            obs.on_chunk(seq, len(req.prompt), t0, obs.t())
        obs.on_decode_begin(seq)
        try:
            seq.last_tok = self._sample_checked(self._host(logits)[0], seq)
            self._emit(seq, seq.last_tok)
        except RequestFault as e:
            self._quarantine(seq, e)   # lane stays free for the next admit
            return
        self.slot_req[slot] = seq

    def _contiguous_step(self) -> bool:
        obs = self.obs
        t0 = obs.t() if obs.enabled else 0.0
        self._expire()
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        if obs.enabled:
            obs.on_dispatch(live=len(active), lanes=self.n_slots,
                            tok_live=len(active), tok_lanes=self.n_slots)
        # idle lanes decode token 0 at position 0 into their own rows,
        # which the next admission overwrites whole
        toks = np.zeros(self.n_slots, np.int32)
        pos = np.zeros(self.n_slots, np.int32)
        for slot, seq in enumerate(self.slot_req):
            if seq is not None:
                toks[slot], pos[slot] = seq.last_tok, seq.length
        batch = {"tokens": self._dev(toks[:, None]),
                 "positions": self._positions(pos[:, None])}
        logits, self.caches = serve_step(self.params, batch, self.caches,
                                         self.cfg, self.quant)
        logits = self._host(logits)
        self.steps += 1
        for slot in active:
            seq = self.slot_req[slot]
            if seq is None or seq.req.done:   # cancelled by a callback
                continue
            try:
                seq.last_tok = self._sample_checked(logits[slot], seq)
                self._emit(seq, seq.last_tok)
            except RequestFault as e:
                self._quarantine(seq, e)
                continue
            seq.length += 1
            if len(seq.req.out) >= seq.req.max_new_tokens \
                    or seq.length >= self.max_len - 1:
                seq.req.done = True
                seq.req.finish_reason = "length"
                self.slot_req[slot] = None
                self.obs.on_finish(seq.req, "length", seq=seq)
        if obs.enabled:
            obs.on_step(
                t0, waiting=len(self.queue),
                running=sum(r is not None for r in self.slot_req))
        return True

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
        fresh suffix in the same kernel pass.  Stateful archs prefill at
        exact length and continue the slot-resident conv/SSD state, so a
        chunk picks up exactly where the last one stopped.  Returns the
        ``(1, V)`` f32 logits (host numpy) at the last real suffix
        token.
        """
        s = len(suffix)
        assert s >= 1, "suffix forward needs >= 1 token to compute"
        p = prefill_bucket(s, self.max_len) if self._bucketable else s
        toks = np.zeros(p, np.int32)
        toks[:s] = suffix
        pos = np.full(p, -1, np.int32)
        pos[:s] = np.arange(start, start + s)
        # bucket the table width like decode does: the kernel grid walks
        # one iteration per table entry
        nbw = min(_next_pow2(max(len(seq.blocks), 1)), self.n_batch_blocks)
        tables = np.zeros((1, nbw), np.int32)   # pad entries: null block
        tables[0, :len(seq.blocks)] = seq.blocks
        batch = self._prefill_batch(toks, pos, s)
        slots = (np.asarray([seq.slot], np.int32)
                 if self.pool.slots is not None else None)
        caches = self.pool.step_caches(
            tables, np.asarray([start], np.int32), slots=slots)
        quant = self._quant_for(getattr(seq, "precision", None))
        logits, caches = self._step(prefill_step_bucketed, batch, caches,
                                    quant)
        self.pool.absorb(caches)
        return self._host(logits)

    def _decode_bucket(self, n: int) -> int:
        return min(_next_pow2(n), self.max_batch)

    def _paged_step(self) -> bool:
        sch = self.scheduler
        obs = self.obs
        t0 = obs.t() if obs.enabled else 0.0
        self._expire()
        if self.validate_every is not None and self.steps \
                and self.steps % self.validate_every == 0:
            self._watchdog()
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

        Attention-only configs fuse everything into ONE dispatch
        (:meth:`_fused_forward`) whenever a chunk of more than one token
        is in flight; otherwise decodes run the ``(B, 1)``
        :func:`serve_step` and a one-token chunk its own suffix forward.
        Stateful archs (SSM/hybrid) cannot pad the recurrence, so their
        mixed steps split: one bucketed decode dispatch plus one
        exact-length B=1 dispatch per chunk lane, riding the cached
        conv/state continuation."""
        if any(n > 1 for _, n in plan) and self._bucketable:
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
        slot_ids = np.full(bb, -1, np.int32)   # pad lanes: no slot
        for i, seq in enumerate(running):
            toks[i], pos[i], lens[i] = seq.last_tok, seq.length, seq.length
            tables[i, :len(seq.blocks)] = seq.blocks
            offsets[i] = seq.freed_prefix
            slot_ids[i] = seq.slot
        batch = {"tokens": self._dev(toks[:, None]),
                 "positions": self._positions(pos[:, None])}
        caches = self.pool.step_caches(
            tables, lens, block_offsets=offsets,
            slots=slot_ids if self.pool.slots is not None else None)
        quant = self._quant_for(running[0].precision)
        logits, caches = self._step(serve_step, batch, caches, quant)
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
        token).  Attention-only configs (``_bucketable``); pool slots
        never exist here."""
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
        logits, caches = self._step(prefill_step_bucketed, batch, caches,
                                    quant)
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
        return self._paged_step() if self.paged else self._contiguous_step()

    def run(self, max_steps: int = 10_000):
        while self.steps < max_steps and self._has_work():
            if not self.step():
                break

    def _has_work(self) -> bool:
        if self.paged:
            return self.scheduler.has_work
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def report(self) -> dict:
        """Occupancy snapshot (paged: pool accounting; contiguous: lanes)."""
        if self.paged:
            rep = self.pool.report(
                tokens_resident=self.scheduler.tokens_resident())
            rep.update(running=len(self.scheduler.running),
                       waiting=len(self.scheduler.waiting),
                       preemptions=self.scheduler.n_preemptions,
                       rejections=self.scheduler.n_rejections,
                       chunk_tokens=self.chunk_tokens,
                       chunk_tokens_processed=self.chunk_tokens_processed)
            return rep
        active = sum(r is not None for r in self.slot_req)
        return dict(n_slots=self.n_slots, running=active,
                    waiting=len(self.queue),
                    pool_bytes=kv_cache_bytes(self.caches),
                    tokens_resident=sum(r.length for r in self.slot_req
                                        if r is not None))
