"""ServingObs: the one facade the serving stack reports through.

The engine, scheduler, and pool do not talk to the registry or tracer
directly on timed paths -- they call lifecycle hooks on a ``ServingObs``
(``on_submit`` / ``on_admit`` / ``on_token`` / ``on_preempt`` /
``on_finish`` / ``on_step`` / ``on_dispatch``), which owns:

* a :class:`~repro_torch.obs.metrics.MetricsRegistry` (shared with the pool
  and scheduler, so every counter lives in ONE namespace),
* a :class:`~repro_torch.obs.trace.Tracer` building the per-request span
  trees, and
* the **engine's clock**: the engine binds its injectable ``clock`` to
  the facade at construction, so every timestamp -- TTFT, inter-token,
  span edges, step durations -- is deterministic under an injected
  test clock (the same one deadline expiry already uses).

``NULL_OBS`` is the disabled twin: a stateless singleton whose hooks
are constant no-ops (``enabled = False``).  The engine's hot path calls
the cheap per-event hooks unconditionally (one attribute access + one
no-op call, no clock read, no allocation) and guards anything that
would *compute* (per-step gauge math, forward-pass timing) behind
``obs.enabled`` -- which is how metrics-off keeps token-identity and
a <= 2% step-time overhead (the reference package's benchmarks/obs_overhead.py measures it).

Traces ride the request object (``req._trace``): preemption re-queues
the request but the trace survives, so a preempted-then-resumed
request shows ``queued -> running -> queued -> running`` with one root
span.  Every hook tolerates a request with no trace (a scheduler used
standalone, without an engine's ``on_submit``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.obs.metrics import (LATENCY_BUCKETS, TOKEN_BUCKETS,
                               MetricsRegistry)
from repro_torch.obs.trace import Tracer

__all__ = ["ServingObs", "NULL_OBS"]


class ServingObs:
    """Live observability: registry + tracer + clock, with the
    lifecycle hooks the serving stack calls (see module docstring)."""

    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 tracer: Optional[Tracer] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.clock = clock or time.monotonic
        r = self.registry
        # per-request latency distributions
        self._h_ttft = r.histogram(
            "repro_request_ttft_seconds",
            "submit-to-first-token latency")
        self._h_intertok = r.histogram(
            "repro_request_intertoken_seconds",
            "gap between consecutive emitted tokens of one request")
        self._h_queue = r.histogram(
            "repro_request_queue_wait_seconds",
            "time spent waiting (initial queue + re-queues after "
            "preemption)")
        self._h_step = r.histogram(
            "repro_engine_step_seconds", "engine step wall time")
        # lifecycle counters
        self._c_submitted = r.counter(
            "repro_requests_submitted", "requests handed to submit()")
        self._c_finished = r.counter(
            "repro_requests_finished",
            "finished requests by finish_reason",
            labelnames=("reason",))
        self._finished_children: dict = {}
        self._c_tokens = r.counter(
            "repro_engine_tokens", "output tokens emitted")
        self._c_steps = r.counter(
            "repro_engine_steps", "engine steps executed")
        self._c_prefill_tokens = r.counter(
            "repro_engine_prefill_tokens",
            "prompt tokens run through prefill passes (chunked "
            "step-loop chunks or whole-prompt admission)")
        # step-loop gauges (set once per step / dispatch)
        self._g_running = r.gauge(
            "repro_engine_running", "requests currently running")
        self._g_waiting = r.gauge(
            "repro_engine_waiting", "requests queued for admission")
        self._g_lanes = r.gauge(
            "repro_engine_batch_lanes",
            "dispatch lanes by kind (bucket padding waste = padded)",
            labelnames=("kind",))
        self._g_lanes_live = self._g_lanes.labels(kind="live")
        self._g_lanes_pad = self._g_lanes.labels(kind="padded")
        self._g_pad_waste = r.gauge(
            "repro_engine_padding_waste",
            "fraction of dispatched token slots that were padding")
        self._g_chunk_util = r.gauge(
            "repro_engine_chunk_budget_utilization",
            "fraction of the chunk budget the step's plan used")
        self._g_occupancy = r.gauge(
            "repro_pool_occupancy", "used / usable pool blocks")
        # MoE capacity pressure (per forward dispatch, fed by the
        # engine's moe_stats-specialized steps)
        self._h_moe_load = r.histogram(
            "repro_moe_expert_load",
            "tokens dispatched to one expert in one MoE layer pass",
            buckets=TOKEN_BUCKETS)
        self._c_moe_dropped = r.counter(
            "repro_moe_dropped_tokens",
            "routed assignments lost to the expert capacity bound")
        self._g_moe_util = r.gauge(
            "repro_moe_capacity_utilization",
            "kept assignments / dispatch slots over the last forward")

    # -- clock ---------------------------------------------------------------
    def t(self) -> float:
        return self.clock()

    # -- request lifecycle ---------------------------------------------------
    def on_submit(self, req: Any, label: Optional[str] = None) -> None:
        now = self.clock()
        self._c_submitted.inc()
        tr = self.tracer.start(now, label)
        req._trace = tr
        tr.begin("queued", now)

    def on_admit(self, seq: Any, cached_tokens: int = 0,
                 prefilling: bool = False) -> None:
        now = self.clock()
        tr = getattr(seq.req, "_trace", None)
        if tr is None:
            return
        if "queued" in tr._open:
            q = tr._open["queued"]
            tr.end("queued", now)
            self._h_queue.observe(now - q.t0)
        tr.begin("running", now)
        if cached_tokens:
            tr.prefix_hit_tokens += cached_tokens
            tr.instant("prefix_hit", now, dict(tokens=cached_tokens))
        if not prefilling:
            tr.begin("decode", now)
        self._track_blocks(tr, seq)

    def on_decode_begin(self, seq: Any) -> None:
        tr = getattr(seq.req, "_trace", None)
        if tr is not None and "decode" not in tr._open:
            tr.begin("decode", self.clock())

    def on_chunk(self, seq: Any, n: int, t0: float, t1: float) -> None:
        """One chunk of ``seq``'s prompt landed between ``t0`` and
        ``t1`` (whole-prompt admission records its single prefill pass
        through here too, as chunk 0)."""
        self._c_prefill_tokens.inc(n)
        tr = getattr(seq.req, "_trace", None)
        if tr is None:
            return
        tr.complete("chunk_prefill", t0, t1,
                    dict(index=tr.n_chunks, tokens=n))
        tr.n_chunks += 1
        self._track_blocks(tr, seq)

    def on_token(self, req: Any, tok: int) -> None:
        now = self.clock()
        self._c_tokens.inc()
        tr = getattr(req, "_trace", None)
        if tr is None:
            return
        if tr.token_times:
            self._h_intertok.observe(now - tr.token_times[-1])
        else:
            self._h_ttft.observe(now - tr.t_submit)
        tr.token(now, len(req.out) - 1, tok)

    def on_preempt(self, seq: Any) -> None:
        now = self.clock()
        tr = getattr(seq.req, "_trace", None)
        if tr is None:
            return
        tr.n_preemptions += 1
        if "decode" in tr._open:
            tr.end("decode", now)
        if "running" in tr._open:
            tr.end("running", now)
        tr.begin("queued", now)

    def on_finish(self, req: Any, reason: str,
                  seq: Any = None) -> None:
        child = self._finished_children.get(reason)
        if child is None:
            child = self._c_finished.labels(reason=reason)
            self._finished_children[reason] = child
        child.inc()
        tr = getattr(req, "_trace", None)
        if tr is None:
            return
        if seq is not None:
            self._track_blocks(tr, seq)
        tr.finish(self.clock(), reason)

    @staticmethod
    def _track_blocks(tr: Any, seq: Any) -> None:
        held = getattr(seq, "freed_prefix", 0) \
            + len(getattr(seq, "blocks", ()))
        if held > tr.peak_blocks:
            tr.peak_blocks = held

    # -- step loop -----------------------------------------------------------
    def on_step(self, t0: float, *, running: int, waiting: int,
                chunk_used: Optional[int] = None,
                chunk_budget: Optional[int] = None,
                occupancy: Optional[float] = None) -> None:
        self._c_steps.inc()
        self._h_step.observe(self.clock() - t0)
        self._g_running.set(running)
        self._g_waiting.set(waiting)
        if chunk_budget:
            self._g_chunk_util.set((chunk_used or 0) / chunk_budget)
        if occupancy is not None:
            self._g_occupancy.set(occupancy)

    def on_dispatch(self, *, live: int, lanes: int,
                    tok_live: int, tok_lanes: int) -> None:
        """Record one forward dispatch's bucket-padding waste:
        ``live`` real lanes padded to ``lanes`` bucket lanes, carrying
        ``tok_live`` real tokens of ``tok_lanes`` dispatched slots."""
        self._g_lanes_live.set(live)
        self._g_lanes_pad.set(lanes - live)
        if tok_lanes:
            self._g_pad_waste.set(1.0 - tok_live / tok_lanes)

    def on_moe(self, stats: Any) -> None:
        """Record one forward pass's MoE capacity telemetry: ``stats``
        is the :func:`repro_torch.models.model.forward` dict -- ``load``
        ``(L_moe, E)`` kept tokens per expert, ``dropped (L_moe,)``
        assignments lost to the capacity bound, ``capacity (L_moe,)``
        dispatch slots -- device arrays; the host transfer happens
        here, off the jitted step."""
        if stats is None:
            return
        load = np.asarray(stats["load"])
        for v in load.reshape(-1):
            self._h_moe_load.observe(float(v))
        dropped = int(np.asarray(stats["dropped"]).sum())
        if dropped:
            self._c_moe_dropped.inc(dropped)
        cap = int(np.asarray(stats["capacity"]).sum())
        if cap:
            self._g_moe_util.set(float(load.sum()) / cap)


class _NullObs:
    """Disabled twin of :class:`ServingObs`: every hook is a constant
    no-op -- no clock reads, no allocations, nothing retained.  One
    shared singleton (``NULL_OBS``) serves every disabled engine."""

    __slots__ = ()
    enabled = False
    registry = None
    tracer = None

    def t(self):
        return 0.0

    def on_submit(self, req, label=None):
        pass

    def on_admit(self, seq, cached_tokens=0, prefilling=False):
        pass

    def on_decode_begin(self, seq):
        pass

    def on_chunk(self, seq, n, t0, t1):
        pass

    def on_token(self, req, tok):
        pass

    def on_preempt(self, seq):
        pass

    def on_finish(self, req, reason, seq=None):
        pass

    def on_step(self, t0, **kw):
        pass

    def on_dispatch(self, **kw):
        pass

    def on_moe(self, stats):
        pass


NULL_OBS = _NullObs()
