"""Request scheduler for paged continuous batching with prefix caching.

Replaces the fixed-slot admission of the contiguous engine: requests are
admitted FCFS whenever the block pool can hold their prompt, the decode
batch is assembled from whatever is running (the engine pads it to
bucketed batch sizes to bound recompiles), and when the pool runs dry
mid-decode the *youngest* running request is preempted by eviction.

Admission goes through the pool's prefix cache
(:meth:`~repro_torch.serving.paged_cache.PagedKVPool.acquire_prefix`): blocks
whose prompt-chain hash matches the head of the request's token chain
are *acquired* (refcount + 1, shared through the block table) rather
than recomputed, and only the suffix is prefilled.  Completion and
preemption *release* blocks instead of destroying them -- a released
block parks in the pool's LRU cache until allocation pressure evicts
it, which turns recompute-preemption into a **warm restart**: the
re-admitted request re-acquires its own blocks and re-prefills only the
partial tail.  A decode append into a block another table still maps
(refcount > 1) first goes through copy-on-write, so shared blocks never
mutate under a reader.

Per-request state lives in :class:`SequenceState` objects (not parallel
numpy arrays): cached length, next input token, owned blocks, the state
slot, sampling params, and the per-request RNG stream (sampling is
keyed by ``(request seed, output index)``, so a preempted-then-resumed
request reproduces the exact tokens an uncontended run produces even at
temperature > 0).

**Chunked prefill** (``chunk_tokens``): instead of prefilling a whole
prompt in one admission pass (stalling every running decode for
O(prompt) and transiently demanding O(prompt) blocks), admission only
acquires the prefix-cache hit and a state slot, and the prompt then
*streams* through the step loop: :meth:`Scheduler.plan_step` composes
each step from every decoding request (always, one token each) plus a
``chunk_tokens`` budget of prompt tokens split oldest-first among
prefilling requests, and :meth:`Scheduler.ensure_step_capacity`
allocates just that step's blocks.  Decodes are therefore never crowded
out of a step, and per-step prompt work -- the decode-latency tax -- is
bounded by the chunk budget.

Liveness guarantee: a request whose *peak held-block count* exceeds the
pool is rejected at submit time (:meth:`Scheduler.lifetime_need`), so
the oldest running request can always grow -- preemption of everything
younger frees or re-caches enough blocks -- and the preemption loop
terminates.  Whole-prompt mode pins that peak at the full
``blocks_for(prompt + new)`` transient; chunked prefill grows at most
one chunk per step and reclaims out-of-window blocks *between chunks*,
so for sliding-window configs the peak drops to
``blocks_for(window + chunk) + 2`` and prompts far longer than the pool
become servable.

Sliding-window reclaim: before each step's allocations
(:meth:`Scheduler.ensure_append_capacity`) every running request's
leading blocks whose tokens are all out of the attention window are
released back through the refcount path -- block tables become rolling
windows (``SequenceState.freed_prefix``) and steady-state memory per
request is O(window), not O(length).  State slots: stateful archs
(ssm/hybrid/audio) additionally gate admission on a free slot of the
pool's :class:`~repro_torch.serving.paged_cache.StateSlotPool`; pure-SSM
configs skip block accounting entirely (``pool.needs_blocks``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.obs import NULL_OBS
from repro_torch.serving.faults import RequestFault
from repro_torch.serving.paged_cache import ChainMemo, PagedKVPool


@dataclasses.dataclass(eq=False)       # identity equality: states are
class SequenceState:                   # removed from lists by object
    """Mutable per-request decode state (one object per live request)."""
    req: "Request"                  # repro_torch.serving.engine.Request
    length: int = 0                 # tokens whose KV is resident
    last_tok: int = 0               # next input token
    blocks: list = dataclasses.field(default_factory=list)
    cached_len: int = 0             # prompt tokens served from the cache
    admitted_at: int = -1           # admission counter (preemption order)
    # sliding-window reclaim: leading logical blocks already released as
    # fully out-of-window; ``blocks`` holds only the live suffix and the
    # block table carries this as its per-request ``block_offset``
    freed_prefix: int = 0
    # state slot (SSM conv+state / enc-dec cross rows); -1 = none
    slot: int = -1
    # served weight width (bits), resolved by the engine's tier policy
    # at FIRST admission and frozen on the request (precision never
    # changes mid-request; preemption re-admits at the same bits).
    # Salts every prefix-cache chain op below, so equal prompts share
    # KV only at equal precision.  None = the engine's configured width
    precision: Optional[int] = None
    # resume point for pool.register_chain: full blocks already indexed
    # by this owner are skipped, so chain bookkeeping on every
    # finish/preempt costs O(new blocks), not O(chain length)
    chain_memo: ChainMemo = dataclasses.field(default_factory=ChainMemo)
    # chunked prefill: the full token chain still streaming in (prompt
    # plus any fed-back outputs); None once every token's KV is
    # resident and the request is decoding
    pending: Optional[np.ndarray] = None

    @property
    def prefilling(self) -> bool:
        return self.pending is not None and self.length < len(self.pending)

    @property
    def temperature(self) -> float:
        return getattr(self.req, "temperature", 0.0)

    def sample_rng(self, index: int) -> np.random.Generator:
        """Generator for this request's ``index``-th output token.

        Keyed ``(request seed, output index)`` -- stateless, so the
        draw for token k is the same whether the request ran straight
        through, was preempted and recomputed, or resumed warm from the
        prefix cache (the reproducibility contract of recompute
        preemption at temperature > 0).
        """
        seed = getattr(self.req, "seed", None)
        return np.random.default_rng(
            np.random.SeedSequence(entropy=(int(seed or 0), index)))

    def resume_tokens(self) -> np.ndarray:
        """Tokens to (re-)prefill: the prompt plus every generated token
        that has already been fed back (all of ``out`` except the last,
        which is the pending input)."""
        toks = [np.asarray(self.req.prompt, np.int32)]
        if self.req.out:
            toks.append(np.asarray(self.req.out[:-1], np.int32))
        return np.concatenate(toks)

    def token_chain(self) -> np.ndarray:
        """Every token whose KV is resident (prompt + fed-back outputs),
        the chain the pool's prefix index is keyed by."""
        toks = [np.asarray(self.req.prompt, np.int32)]
        if self.req.out:
            toks.append(np.asarray(self.req.out, np.int32))
        return np.concatenate(toks)[:self.length]


class Scheduler:
    """FCFS admission + preemption-by-eviction over a :class:`PagedKVPool`.

    The engine drives it.  Whole-prompt mode (``chunk_tokens=None``):
    :meth:`admit` before each step (prefilling via the engine's
    callback), :meth:`ensure_append_capacity` to make room for the
    step's KV append (allocating fresh blocks and copy-on-write copies
    of shared ones).  Chunked mode: :meth:`admit_chunked`, then
    :meth:`plan_step` to compose the fused decode+chunk step and
    :meth:`ensure_step_capacity` to make room for it.  Either way
    :meth:`finish`/:meth:`cancel`/:meth:`reject` retire requests.
    """

    def __init__(self, pool: PagedKVPool, *, max_len: int, max_batch: int,
                 chunk_tokens: Optional[int] = None, obs=None,
                 tail_compaction: bool = True, faults=None,
                 precision_policy=None):
        assert chunk_tokens is None or chunk_tokens >= 1, chunk_tokens
        self.pool = pool
        # nested-precision serving: ``precision_policy(req) -> bits``
        # resolves a request's served weight width at admission (the
        # engine passes its load-adaptive tier policy).  None keeps
        # every sequence at the configured width, unsalted -- the
        # pre-nested behavior, bit for bit
        self.precision_policy = precision_policy
        # fault facade: defaults to the pool's injector so engine-built
        # stacks share ONE seeded schedule across all three subsystems
        self.faults = faults if faults is not None else pool.faults
        self.max_len, self.max_batch = max_len, max_batch
        self.chunk_tokens = chunk_tokens
        # sub-block sliding-window compaction (see _compact_tail)
        self.tail_compaction = tail_compaction
        self.waiting: deque = deque()      # of engine.Request
        self.running: list[SequenceState] = []
        # lifecycle tracing facade (the engine passes its ServingObs;
        # a standalone scheduler runs against the no-op twin) and the
        # scheduler's slice of the shared metrics namespace -- event
        # counters live in the POOL's registry so one render() scrapes
        # the whole serving stack
        self.obs = obs if obs is not None else NULL_OBS
        m = pool.metrics
        self._c_preemptions = m.counter(
            "repro_sched_preemptions",
            "running requests evicted to free pool blocks")
        self._c_rejections = m.counter(
            "repro_sched_rejections",
            "requests rejected at submit (impossible to serve)")
        self._c_admissions = m.counter(
            "repro_sched_admissions", "requests admitted to running")
        self._c_stall_tokens = m.counter(
            "repro_sched_stall_tokens",
            "prompt tokens co-scheduled with >= 1 running decode (the "
            "per-step decode-latency tax)")
        self._c_stall_steps = m.counter(
            "repro_sched_stall_steps",
            "steps that co-scheduled prompt work with a running decode")
        self._c_compactions = m.counter(
            "repro_sched_tail_compactions",
            "straddling window-edge blocks released early by copying "
            "their live tail into a pre-seeded append block")
        self._c_admit_rollbacks = m.counter(
            "repro_sched_admit_rollbacks",
            "admissions rolled back by a transient alloc/slot failure "
            "(blocks and slot returned through the refcount path, "
            "request re-queued at the head)")
        self._admit_counter = 0
        # (head request, pool.version) of the last admission probe that
        # failed the capacity gate: while neither changes, re-probing
        # would re-walk the head's whole chain (hashing + refcount
        # churn) every engine step just to fail again
        self._blocked_head = None

    # legacy counter attributes: snapshots of the shared registry (the
    # registry is the source of truth, same rule as the pool's n_*)
    @property
    def n_preemptions(self) -> int:
        return int(self._c_preemptions.value)

    @property
    def n_rejections(self) -> int:
        return int(self._c_rejections.value)

    # -- submission ----------------------------------------------------------
    def submit(self, req) -> None:
        """Queue a request; impossible ones are rejected immediately (a
        request longer than the pool must fail cleanly, never hang)."""
        worst = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) == 0:
            self.reject(req, "empty prompt (no position to take logits "
                             "from)")
            return
        if len(req.prompt) >= self.max_len - 1:
            self.reject(req, f"prompt ({len(req.prompt)} tokens) >= "
                             f"max_len-1 ({self.max_len - 1})")
            return
        if self.pool.needs_blocks:
            need = self.lifetime_need(worst)
            if need > self.pool.n_usable:
                self.reject(req, f"holds up to {need} blocks at once, "
                                 f"pool has {self.pool.n_usable}")
                return
        self.waiting.append(req)

    def lifetime_need(self, worst_tokens: int) -> int:
        """Peak block count a request may *hold at once* over its
        lifetime -- the submit-time liveness gate.

        Whole-prompt mode writes the entire chain in one admission
        pass, so even windowed configs pay the full un-reclaimed
        ``blocks_for(worst)`` transient.
        Chunked prefill grows a request at most ``chunk_tokens`` per
        step and reclaims out-of-window blocks *between chunks*, so a
        sliding-window request peaks at the in-window blocks plus one
        chunk's growth plus the two boundary partials -- prompts far
        longer than the pool become servable.  Without a window nothing
        is reclaimed mid-prefill (the whole chain stays live), so
        chunking changes decode latency, not this bound."""
        full = self.pool.blocks_for(min(worst_tokens, self.max_len))
        w = self.pool.cfg.window
        if self.chunk_tokens is None or w is None:
            return full
        return min(full, self.pool.blocks_for(w + self.chunk_tokens) + 2)

    def reject(self, req, reason: str) -> None:
        req.error = f"rejected: {reason}"
        req.done = True
        req.finish_reason = "rejected"
        self._c_rejections.inc()
        self.obs.on_finish(req, "rejected")

    # -- admission -----------------------------------------------------------
    def admit(self, prefill_fn) -> None:
        """FCFS: prefill the head of the queue while blocks and batch
        lanes are available.  The pool's prefix cache is consulted
        first: cached blocks are acquired (shared), a shared partial
        tail is copy-on-written, and only ``blocks_for(len) - hits``
        fresh blocks are drawn.  ``prefill_fn(seq, tokens)`` runs the
        engine's suffix prefill (``seq.cached_len`` tokens are already
        resident) and fills ``seq.length``/``seq.last_tok``; afterwards
        the full chain is registered in the prefix index so the *next*
        same-prefix request hits it."""
        stall = 0     # prompt tokens prefilled while decodes were live
        while self.waiting and len(self.running) < self.max_batch:
            if self.faults.admit_race():
                break      # injected race: the head loses this step
            req = self.waiting[0]
            if self.pool.slots is not None \
                    and self.pool.slots.free_slots == 0:
                break      # FCFS: wait for a finishing request's slot
            if self._blocked_head is not None \
                    and self._blocked_head[0] is req \
                    and self._blocked_head[1] == self.pool.version:
                break      # nothing changed since this head last failed
            seq = SequenceState(req=req)
            if self.precision_policy is not None:
                seq.precision = self.precision_policy(req)
            tokens = seq.resume_tokens()
            hit = self.pool.acquire_prefix(tokens, salt=seq.precision)
            # a shared partial tail must be copied before the suffix
            # writes into it (COW); sole-reference tails extend in place
            cow = hit.partial and self.pool.refcount(hit.ids[-1]) > 1
            if self.pool.needs_blocks:
                need = self.pool.blocks_for(len(tokens)) - len(hit.ids) \
                    + (1 if cow else 0)
                # block-aligned chains open a fresh block on the first
                # decode append: admitting without that headroom would
                # get the request preempted (its prefill discarded) on
                # the same step
                headroom = 1 if len(tokens) % self.pool.block_size == 0 \
                    else 0
            else:
                need = headroom = 0     # pure-SSM: state slots only
            if need + headroom > self.pool.free_blocks:
                self.pool.release(hit.ids)     # back to the cache
                # memoize AFTER the release (it bumps pool.version)
                self._blocked_head = (req, self.pool.version)
                break                          # FCFS: no skipping the head
            self.waiting.popleft()
            self._blocked_head = None
            seq.blocks = list(hit.ids)
            announced = False    # obs.on_admit already fired?
            try:
                if cow:
                    seq.blocks[-1] = self.pool.cow(seq.blocks[-1])
                if need - (1 if cow else 0):
                    seq.blocks.extend(
                        self.pool.alloc(need - (1 if cow else 0)))
                if self.pool.slots is not None:
                    seq.slot = self.pool.alloc_slot()
                seq.cached_len = hit.cached_len
                self.pool.record_hit(hit, len(tokens))
                seq.admitted_at = self._admit_counter
                self._admit_counter += 1
                self._c_admissions.inc()
                # whole-prompt admission stalls every running decode for
                # the entire suffix -- the O(prompt) tax chunked prefill
                # bounds (same stall definition either way: prompt tokens
                # co-scheduled with >= 1 running decode)
                if any(not s.prefilling for s in self.running):
                    stall += len(tokens) - seq.cached_len
                obs = self.obs
                obs.on_admit(seq, cached_tokens=seq.cached_len,
                             prefilling=True)
                announced = True
                t0 = obs.t() if obs.enabled else 0.0
                prefill_fn(seq, tokens)
                if obs.enabled:
                    obs.on_chunk(seq, len(tokens) - seq.cached_len,
                                 t0, obs.t())
                obs.on_decode_begin(seq)
                self.pool.register_chain(tokens, seq.blocks,
                                         memo=seq.chain_memo,
                                         salt=seq.precision)
                # a long prompt's leading blocks may already be fully out
                # of the attention window: return them before decode
                self._reclaim_seq(seq)
            except Exception as e:
                self._rollback_admission(req, seq, e, announced)
                break
            self.running.append(seq)
        if stall:
            self._c_stall_tokens.inc(stall)
            self._c_stall_steps.inc()

    def _rollback_admission(self, req, seq, exc, announced) -> None:
        """Unwind a partially-admitted request after a mid-admission
        failure: every block reference ``seq`` holds returns through
        the refcount path and the state slot (if taken) is freed, so
        the pool is exactly as if the admission never started.  A
        transient pool fault (exhaustion ``RuntimeError``) re-queues
        the request at the head for the next step; a
        request-attributable :class:`RequestFault` (e.g. its first
        token's callback raised mid-prefill) finishes it with
        ``finish_reason='error'`` instead -- re-queueing after a
        partial emission would corrupt ``resume_tokens``."""
        self.pool.release(seq.blocks)
        seq.blocks = []
        if seq.slot >= 0:
            self.pool.free_slot(seq.slot)
            seq.slot = -1
        self._c_admit_rollbacks.inc()
        if isinstance(exc, RequestFault):
            req.done = True
            req.finish_reason = "error"
            if getattr(req, "error", None) is None:
                req.error = str(exc)
            self.obs.on_finish(req, "error", seq=seq)
        else:
            if announced:
                # on_admit already opened the trace's running span:
                # close it like a preemption so the walk stays balanced
                self.obs.on_preempt(seq)
            self.waiting.appendleft(req)

    def admit_chunked(self) -> None:
        """FCFS *chunked* admission: acquire the prefix-cache hit and a
        state slot, set up the pending chain, and return -- no blocks
        are allocated and no model pass runs here.  The prompt then
        streams through the step loop (:meth:`plan_step` /
        :meth:`ensure_step_capacity`) one chunk budget at a time, so
        the capacity gate is the *first chunk's* block need plus one
        block of headroom, not the whole prompt."""
        assert self.chunk_tokens is not None, \
            "admit_chunked needs Scheduler(chunk_tokens=...)"
        while self.waiting and len(self.running) < self.max_batch:
            if self.faults.admit_race():
                break      # injected race: the head loses this step
            req = self.waiting[0]
            if self.pool.slots is not None \
                    and self.pool.slots.free_slots == 0:
                break      # FCFS: wait for a finishing request's slot
            if self._blocked_head is not None \
                    and self._blocked_head[0] is req \
                    and self._blocked_head[1] == self.pool.version:
                break      # nothing changed since this head last failed
            seq = SequenceState(req=req)
            if self.precision_policy is not None:
                seq.precision = self.precision_policy(req)
            tokens = seq.resume_tokens()
            hit = self.pool.acquire_prefix(tokens, salt=seq.precision)
            seq.blocks = list(hit.ids)
            seq.cached_len = seq.length = hit.cached_len
            seq.pending = tokens
            if self.pool.needs_blocks:
                first = min(self.chunk_tokens, len(tokens) - seq.length)
                # blocks the running requests' own next step will draw:
                # admitting into them would only get this (the
                # youngest) request preempted right back out
                reserve = sum(self._span_need(s, self._next_n(s))
                              for s in self.running)
                if self._span_need(seq, first) + 1 + reserve \
                        > self.pool.free_blocks:
                    self.pool.release(hit.ids)     # back to the cache
                    # memoize AFTER the release (it bumps pool.version)
                    self._blocked_head = (req, self.pool.version)
                    break                          # FCFS: no skipping
            self.waiting.popleft()
            self._blocked_head = None
            if self.pool.slots is not None:
                try:
                    seq.slot = self.pool.alloc_slot()
                except RuntimeError as e:
                    self._rollback_admission(req, seq, e, False)
                    break
            self.pool.record_hit(hit, len(tokens))
            seq.admitted_at = self._admit_counter
            self._admit_counter += 1
            self._c_admissions.inc()
            self.obs.on_admit(seq, cached_tokens=seq.cached_len,
                              prefilling=seq.prefilling)
            if not seq.prefilling:
                self.obs.on_decode_begin(seq)
            self.running.append(seq)

    # -- chunked step planning -----------------------------------------------
    def _next_n(self, seq: SequenceState) -> int:
        """Tokens ``seq`` would process in a full-budget step."""
        if not seq.prefilling:
            return 1
        return min(self.chunk_tokens, len(seq.pending) - seq.length)

    def plan_step(self) -> list:
        """Compose one continuous-batching step as ``(seq, n_tokens)``
        entries.  Every decoding request is planned every step (one
        token each): prompt work can *never* crowd a decode out of a
        step, which is the starvation bound the property suite asserts.
        Prefilling requests split the ``chunk_tokens`` budget
        oldest-first, so per-step prompt work -- the decode-latency tax
        -- is bounded by the budget and the head of the prefill line
        drains in ceil(remaining / chunk_tokens) steps."""
        plan = [(s, 1) for s in self.running if not s.prefilling]
        budget = self.chunk_tokens or 0
        for s in sorted((s for s in self.running if s.prefilling),
                        key=lambda s: s.admitted_at):
            if budget <= 0:
                break
            n = min(budget, len(s.pending) - s.length)
            plan.append((s, n))
            budget -= n
        return plan

    # -- sliding-window reclaim ----------------------------------------------
    def _reclaim_seq(self, seq: SequenceState) -> None:
        """Release every leading block of ``seq`` whose tokens are all
        out of the attention window for all future queries.

        The pending query position is ``seq.length``, so future queries
        attend positions ``> q - window >= length - window``; logical
        block ``j`` (tokens ``[j*bs, (j+1)*bs)``) is dead once
        ``(j+1)*bs - 1 <= length - window``.  Released blocks go through
        the refcount path (prefix-shared copies survive for their other
        readers) and the block table becomes a rolling window: ``blocks``
        keeps the live suffix, ``freed_prefix`` the offset."""
        w = self.pool.cfg.window
        if w is None or not self.pool.needs_blocks:
            return
        n_dead = max(0, (seq.length - w + 1) // self.pool.block_size)
        drop = n_dead - seq.freed_prefix
        if drop > 0:
            # the write-target block (logical length // bs) is never dead
            # for window >= 1, so the live suffix keeps at least the tail
            assert drop <= len(seq.blocks), (drop, len(seq.blocks))
            dead, seq.blocks = seq.blocks[:drop], seq.blocks[drop:]
            seq.freed_prefix = n_dead
            self.pool.release(dead, window_reclaim=True)
        self._compact_tail(seq, n_dead)

    def _compact_tail(self, seq: SequenceState, n_dead: int) -> None:
        """Sub-block compaction at the window edge: release the
        *straddling* block (head slots dead, tail slots live) a whole
        block-lifetime early by copying its live tail into a fresh
        block pre-seeded as the chain's NEXT append target.

        With window ``w`` and block size ``bs``, ``d0 = (length-w+1) %
        bs`` head slots of logical block ``j = n_dead`` are permanently
        out of window but the block stays held until ``d0`` wraps --
        on average ``bs/2`` dead slots per request.  Instead: allocate
        a fresh block ``F``, copy the straddler's live slots
        ``d0..bs`` (positions AND planes, slot-aligned) into ``F``,
        append ``F`` as logical block ``jt+1`` (``jt`` = the current
        tail), bump ``freed_prefix`` past the straddler and release it.
        Held blocks stay constant *now* but the next append-driven
        allocation is already satisfied, so peak blocks drop by ~1 per
        request.  The paged kernel reads keys by per-slot ``pos`` tag
        across every table entry, so a copied token's KV may live in a
        block that is not its natural ``pos // bs`` home.

        Die-before-clobber: ``F`` slot ``o`` is overwritten when
        position ``(jt+1)*bs + o`` lands; a step writing ``n`` tokens
        from query position ``q0`` may clobber while ``q0`` still
        attends the copied token unless ``d0 >= fill - bs + 1 + (n-1)``
        (``fill`` = tokens in the tail block) -- always true for
        decode (``n=1``, RHS <= 1 <= d0), checked against the chunk
        budget otherwise.  Guards: the straddler must not be the write
        target (``len(blocks) >= 2``), a prior compaction must not
        have advanced past it (``freed_prefix == n_dead``), and the
        pool must hold a strictly-free block -- evicting a cached
        block for a net-zero count move would shrink the prefix cache.
        """
        if not self.tail_compaction:
            return
        w = self.pool.cfg.window
        dead_tokens = seq.length - w + 1
        if dead_tokens <= 0 or seq.freed_prefix != n_dead \
                or len(seq.blocks) < 2:
            return
        bs = self.pool.block_size
        d0 = dead_tokens % bs
        if d0 < 1:
            return
        fill = seq.length - (seq.length - 1) // bs * bs
        slack = (self.chunk_tokens or 1) - 1
        if d0 < fill - bs + 1 + slack:
            return
        if self.pool.free_uncached_blocks < 1:
            return
        (fresh,) = self.pool.alloc(1)
        self.pool.copy_tail(seq.blocks[0], fresh, d0)
        head = seq.blocks[0]
        seq.blocks = seq.blocks[1:] + [fresh]
        seq.freed_prefix = n_dead + 1
        self.pool.release([head], window_reclaim=True)
        self._c_compactions.inc()

    def reclaim_out_of_window(self) -> None:
        """Roll every running request's block table past its dead
        prefix (sliding-window attention), returning out-of-window
        blocks to the pool before this step's allocations."""
        for seq in self.running:
            self._reclaim_seq(seq)

    # -- step capacity -------------------------------------------------------
    def _span_need(self, seq: SequenceState, n: int) -> int:
        """Blocks writing ``n`` tokens at position ``seq.length`` costs:
        fresh blocks to cover the span, plus 1 COW copy when the first
        write lands in a partial block another table still maps."""
        if not self.pool.needs_blocks or n <= 0:
            return 0
        have = seq.freed_prefix + len(seq.blocks)
        need = max(0, self.pool.blocks_for(seq.length + n) - have)
        if seq.length % self.pool.block_size and seq.blocks \
                and self.pool.refcount(seq.blocks[-1]) > 1:
            need += 1
        return need

    def ensure_append_capacity(self) -> None:
        """Whole-prompt mode's per-step capacity call: every running
        request appends one decode token.  (The chunked loop calls
        :meth:`ensure_step_capacity` with its plan instead.)"""
        self.ensure_step_capacity([(s, 1) for s in self.running])

    def ensure_step_capacity(self, plan: list) -> list:
        """Allocate the planned step's blocks (fresh + copy-on-write),
        evicting the youngest running request(s) while the pool is
        short; returns the plan minus preempted entries.  Out-of-window
        blocks are reclaimed first -- freeing a dead prefix can make
        preemption unnecessary, and with chunked prefill this runs
        *between chunks*, so a windowed request's table rolls while its
        prompt is still streaming in and its held-block peak stays at
        :meth:`lifetime_need`, not O(prompt).  Terminates: the oldest
        request alone always fits (the submit gate bounds any single
        request's peak hold by the pool size, and preempting every
        younger request returns all other blocks to refcount 0)."""
        self.reclaim_out_of_window()
        if not self.pool.needs_blocks:
            return plan
        # injected preemption storm: evict the youngest as if the pool
        # were under pressure (recompute restarts reproduce the same
        # tokens by the seeded-sampling contract, so this only stresses
        # the warm-restart path, not the math)
        while self.faults.preempt_storm() and len(self.running) > 1:
            victim = max(self.running, key=lambda s: s.admitted_at)
            self.preempt(victim)
            plan = [(s, n) for s, n in plan if s is not victim]
        while True:
            while True:
                need = sum(self._span_need(s, n) for s, n in plan)
                if need <= self.pool.free_blocks:
                    break
                assert len(self.running) > 1, \
                    "pool cannot hold the oldest request " \
                    "(submit gate broken)"
                victim = max(self.running, key=lambda s: s.admitted_at)
                self.preempt(victim)
                plan = [(s, n) for s, n in plan if s is not victim]
            grow = [(s, self.pool.blocks_for(s.length + n)
                     - (s.freed_prefix + len(s.blocks)))
                    for s, n in plan]
            grow = [(s, g) for s, g in grow if g > 0]
            try:
                if grow:    # one alloc = one pos-reset scatter per layer
                    ids = self.pool.alloc(sum(g for _, g in grow))
                    k = 0
                    for seq, g in grow:
                        seq.blocks.extend(ids[k:k + g])
                        k += g
                for seq, n in plan:
                    if seq.length % self.pool.block_size == 0 \
                            or not seq.blocks:
                        continue
                    # the partial block the first write lands in (NOT
                    # blocks[-1] -- a multi-token chunk may have grown
                    # past it just above)
                    j = seq.length // self.pool.block_size \
                        - seq.freed_prefix
                    if self.pool.refcount(seq.blocks[j]) > 1:
                        seq.blocks[j] = self.pool.cow(seq.blocks[j])
            except RuntimeError:
                # alloc or COW failed AFTER the capacity check (an
                # injected exhaustion, or eviction pressure from a COW
                # draw): alloc is atomic and partial grow/COW state is
                # individually consistent (grown blocks stay owned by
                # their seqs), so treat it as a shortfall -- preempt the
                # youngest and retry.  With one request left, surface to
                # the engine's step containment instead.
                if len(self.running) <= 1:
                    raise
                victim = max(self.running, key=lambda s: s.admitted_at)
                self.preempt(victim)
                plan = [(s, n) for s, n in plan if s is not victim]
                continue
            break
        # the step's decode-stall metric, recorded on the FINAL plan
        # (post-preemption): prompt tokens this step co-schedules with
        # at least one running decode.  This is the canonical stall
        # definition -- the reference package's chunked-prefill benchmark asserts its own
        # hand count equals these counters
        stall = sum(n for s, n in plan if s.prefilling)
        if stall and any(not s.prefilling for s, _ in plan):
            self._c_stall_tokens.inc(stall)
            self._c_stall_steps.inc()
        return plan

    def _release_seq(self, seq: SequenceState) -> None:
        """Register the chain (newly filled blocks become hits for
        same-prefix requests -- including this one, on warm restart)
        and drop this table's references.  A rolled table
        (``freed_prefix > 0``) skips registration: its blocks no longer
        start at chain position 0, and a prefix walker could never
        reach them without the reclaimed head anyway.  The state slot
        (if any) returns to the slot pool."""
        if seq.freed_prefix == 0:
            self.pool.register_chain(seq.token_chain(), seq.blocks,
                                     memo=seq.chain_memo,
                                     salt=seq.precision)
        self.pool.release(seq.blocks)
        seq.blocks = []
        if seq.slot >= 0:
            self.pool.free_slot(seq.slot)
            seq.slot = -1

    def preempt(self, seq: SequenceState) -> None:
        """Evict: release the blocks (they stay cached until allocation
        pressure reclaims them), re-queue at the front.  On re-admission
        the prefix lookup re-acquires whatever survived, so an
        uncontended pool turns the recompute into a warm restart."""
        self._release_seq(seq)
        self.running.remove(seq)
        self.waiting.appendleft(seq.req)
        self._c_preemptions.inc()
        self.obs.on_preempt(seq)

    def register_progress(self, seq: SequenceState) -> None:
        """Index the blocks a freshly landed chunk filled in the prefix
        cache: a same-prefix request admitted mid-prefill shares the
        chain that is already resident (copy-on-write protects the
        growing tail).  Rolled tables skip registration, same as
        :meth:`_release_seq`.  O(new blocks) via the chain memo."""
        if seq.freed_prefix == 0:
            self.pool.register_chain(seq.token_chain(), seq.blocks,
                                     memo=seq.chain_memo,
                                     salt=seq.precision)

    # -- completion ----------------------------------------------------------
    def finish(self, seq: SequenceState, reason: str = "length") -> None:
        self._release_seq(seq)
        self.running.remove(seq)
        seq.req.done = True
        seq.req.finish_reason = reason
        self.obs.on_finish(seq.req, reason, seq=seq)

    def cancel(self, req, reason: str = "cancelled") -> bool:
        """Abort ``req`` wherever it lives.  A running request --
        decoding or mid-chunked-prefill -- releases every block and its
        state slot through the refcount path (the zero-leak property
        the harness asserts); a waiting request just leaves the queue.
        Returns False for unknown (or already finished) requests."""
        found = None
        for seq in self.running:
            if seq.req is req:
                self._release_seq(seq)
                self.running.remove(seq)
                found = seq
                break
        else:
            try:
                self.waiting.remove(req)
            except ValueError:
                return False
        req.done = True
        req.finish_reason = reason
        self.obs.on_finish(req, reason, seq=found)
        return True

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def tokens_resident(self) -> int:
        return sum(s.length for s in self.running)
