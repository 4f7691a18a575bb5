"""FaultInjector: deterministic, seeded fault injection for the serving
stack -- the chaos-testing twin of ``repro_torch.obs.ServingObs``.

The engine, scheduler, and pool each carry a fault facade and consult it
at a fixed set of *injection sites*.  Every site method returns True
("fire the fault here") with an independent per-site probability, drawn
from ONE seeded ``numpy`` Generator in call order -- so a given
``(seed, workload)`` pair replays the exact same fault schedule, which
is what lets the chaos tests compare a faulted run against its
fault-free twin token for token.

Sites, by subsystem (each maps to a recovery path the chaos suite
asserts):

* **pool** -- ``alloc_fail`` / ``slot_fail`` raise the pool's own
  exhaustion ``RuntimeError`` *before any state mutates* (alloc is
  atomic: it either completes or leaves the pool untouched), and
  ``forced_evict`` evicts one LRU-cached block on an otherwise
  satisfiable alloc (prefix-cache pressure: hits become misses, math is
  unchanged).
* **scheduler** -- ``admit_race`` makes an admission probe lose its
  capacity race for one step (the head retries next step);
  ``preempt_storm`` evicts the youngest running request before the real
  capacity loop runs (recompute restarts are token-identical by the
  seeded-sampling contract).
* **engine** -- ``nan_logits`` poisons one request's logits row for one
  step (containment must quarantine exactly that request);
  ``callback_error`` makes a request's ``on_token`` delivery raise;
  ``wrap_clock`` returns a clock that occasionally jumps forward by
  ``clock_jump`` seconds (deadline storms).

``NULL_FAULTS`` is the disabled twin, mirroring ``NULL_OBS``: a
stateless ``__slots__ = ()`` singleton whose site checks are constant
``False`` -- the hot path pays one attribute access + one no-op call per
site and the engine stays token-identical to a build without the
injection points (the reference package's benchmarks gate the cost).

:class:`RequestFault` lives here (not in engine.py) so the scheduler's
admission-rollback path can distinguish a *per-request* fault (the
request finishes with ``finish_reason='error'``) from a *transient
pool* fault (the request re-queues and the step retries) without a
circular import.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Optional

import numpy as np

__all__ = ["FaultInjector", "NULL_FAULTS", "RequestFault"]


class RequestFault(Exception):
    """A fault attributable to ONE request (poisoned logits, a raising
    ``on_token`` callback): step-level containment quarantines that
    request -- ``finish_reason='error'``, blocks/slots released through
    the refcount path -- and the rest of the batch proceeds untouched.
    ``kind`` labels the ``repro_engine_fault_requests`` counter."""

    def __init__(self, msg: str, kind: str = "exception"):
        super().__init__(msg)
        self.kind = kind


class FaultInjector:
    """Seeded fault schedule over the serving stack's injection sites.

    Probabilities are per *site consultation*, drawn in call order from
    one ``default_rng(seed)`` stream: deterministic for a fixed
    workload, independent across sites.  ``fired`` tallies what
    actually fired (the chaos suite asserts coverage); ``bind`` mirrors
    the schedule into the shared metrics registry as
    ``repro_faults_injected{site=...}``.
    """

    enabled = True

    def __init__(self, seed: int = 0, *,
                 p_alloc_fail: float = 0.0,
                 p_slot_fail: float = 0.0,
                 p_forced_evict: float = 0.0,
                 p_admit_race: float = 0.0,
                 p_preempt_storm: float = 0.0,
                 p_nan_logits: float = 0.0,
                 p_callback_error: float = 0.0,
                 p_clock_jump: float = 0.0,
                 clock_jump: float = 3600.0):
        self.seed = int(seed)
        self._rng = np.random.default_rng(np.random.SeedSequence(seed))
        self.p_alloc_fail = p_alloc_fail
        self.p_slot_fail = p_slot_fail
        self.p_forced_evict = p_forced_evict
        self.p_admit_race = p_admit_race
        self.p_preempt_storm = p_preempt_storm
        self.p_nan_logits = p_nan_logits
        self.p_callback_error = p_callback_error
        self.p_clock_jump = p_clock_jump
        self.clock_jump = clock_jump
        self.fired: Counter = Counter()     # site -> times fired
        self._c_injected = None             # registry counter (bind)
        self._children: dict = {}

    # -- registry ------------------------------------------------------------
    def bind(self, registry) -> None:
        """Declare the injection counter on the shared metrics registry
        (the engine calls this with the pool's registry so one render()
        scrapes faults alongside the recovery counters)."""
        if registry is None or self._c_injected is not None:
            return
        self._c_injected = registry.counter(
            "repro_faults_injected",
            "faults fired by the seeded injector, by site",
            labelnames=("site",))

    def _fire(self, site: str, p: float) -> bool:
        if p <= 0.0 or self._rng.random() >= p:
            return False
        self.fired[site] += 1
        if self._c_injected is not None:
            child = self._children.get(site)
            if child is None:
                child = self._c_injected.labels(site=site)
                self._children[site] = child
            child.inc()
        return True

    # -- pool sites ----------------------------------------------------------
    def alloc_fail(self, n: int) -> bool:
        """Consulted at :meth:`PagedKVPool.alloc` entry, before any
        mutation: True simulates exhaustion on an otherwise satisfiable
        allocation."""
        return self._fire("alloc_fail", self.p_alloc_fail)

    def slot_fail(self) -> bool:
        """Consulted at :meth:`PagedKVPool.alloc_slot` entry."""
        return self._fire("slot_fail", self.p_slot_fail)

    def forced_evict(self) -> bool:
        """Consulted once per :meth:`PagedKVPool.alloc`: True evicts one
        LRU-cached block even though the free list could satisfy the
        request (simulated cache pressure)."""
        return self._fire("forced_evict", self.p_forced_evict)

    # -- scheduler sites -----------------------------------------------------
    def admit_race(self) -> bool:
        """Consulted at the top of each admission probe: True makes the
        head lose this step's capacity race (clean break, retried)."""
        return self._fire("admit_race", self.p_admit_race)

    def preempt_storm(self) -> bool:
        """Consulted repeatedly before the capacity loop: each True
        evicts the youngest running request (drawn again until False, so
        one storm can evict several)."""
        return self._fire("preempt_storm", self.p_preempt_storm)

    # -- engine sites --------------------------------------------------------
    def nan_logits(self, req) -> bool:
        """Consulted per (step, sampled request): True poisons the
        request's logits row with NaN before sampling."""
        return self._fire("nan_logits", self.p_nan_logits)

    def callback_error(self, req) -> bool:
        """Consulted per ``on_token`` delivery: True makes the delivery
        raise a :class:`RequestFault` as if the callback threw."""
        return self._fire("callback_error", self.p_callback_error)

    def wrap_clock(self, clock: Optional[Callable[[], float]]
                   ) -> Callable[[], float]:
        """Wrap the engine's clock: each read may jump the clock forward
        by ``clock_jump`` seconds (the offset is cumulative and
        monotone, so wrapped time never runs backward)."""
        base = clock or time.monotonic
        if self.p_clock_jump <= 0.0:
            return base
        state = {"offset": 0.0}

        def jumping() -> float:
            if self._fire("clock_jump", self.p_clock_jump):
                state["offset"] += self.clock_jump
            return base() + state["offset"]

        return jumping


class _NullFaults:
    """Disabled twin of :class:`FaultInjector`: every site check is a
    constant ``False`` -- no RNG draws, no allocation, nothing retained.
    One shared singleton (``NULL_FAULTS``) serves every engine that was
    not handed an injector, keeping the default hot path token-identical
    (the reference package's benchmarks gate the residual cost)."""

    __slots__ = ()
    enabled = False
    fired: Counter = Counter()

    def bind(self, registry) -> None:
        pass

    def alloc_fail(self, n) -> bool:
        return False

    def slot_fail(self) -> bool:
        return False

    def forced_evict(self) -> bool:
        return False

    def admit_race(self) -> bool:
        return False

    def preempt_storm(self) -> bool:
        return False

    def nan_logits(self, req) -> bool:
        return False

    def callback_error(self, req) -> bool:
        return False

    def wrap_clock(self, clock):
        return clock or time.monotonic


NULL_FAULTS = _NullFaults()
