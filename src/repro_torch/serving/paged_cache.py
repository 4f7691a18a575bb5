"""Paged block pool over packed bipolar-INT KV planes (serving memory).

A port of the reference ``repro.serving.paged_cache`` over torch device
buffers: the host logic (refcounts, copy-on-write, the prefix index, the
LRU, ``validate``, the state-slot pool) is the reference's, and block
copies, position resets and slot resets write the pool tensors in place.

The contiguous engine reserves ``max_len`` cache tokens per slot whether
a request is 8 tokens or 8k, so the 2x-16x payload savings of ``kv_bits``
is eaten by over-allocation.  This module turns the quantized KV cache
into a *block pool* (the TensorRT-LLM paged-KV design): fixed-size token blocks
shared by every request and every layer, addressed through per-request
block tables.  Concurrent requests then scale with *tokens actually
resident x bits/element*, not ``n_slots x max_len x 16``.

Layout.  The pool is :func:`repro_torch.models.model.init_caches`: one
dict per layer whose leading dims are (physical block, in-block slot) --
``k``/``v`` are ``(n_blocks, block_size, H, kv_bits, D/32)`` int32 bit
planes (the uint32 bits), scales are
``(n_blocks, block_size, H, 1)`` f32 and ``pos`` is ``(n_blocks,
block_size)`` int32.  One *logical* block id addresses the same physical
index in every layer's pool, so a request owns a single block table.

Block 0 is the reserved **null block**: never allocated, its positions
stay -1, and block-table padding points at it -- a padded or inactive
lane therefore reads only masked slots and contributes exactly 0.

Sharing (copy-on-write prefix cache).  Blocks are *refcounted*: several
requests may map the same physical block through their tables (the
serving analogue of the paper's §4.2 rule of never re-moving data that
is already resident in fast memory -- here, never re-prefilling a
prompt prefix whose packed planes already sit in the pool).  Blocks are
content-addressed by a **prompt-token-chain hash**: the key of block
``j`` commits to every token from position 0 through the end of the
block, so a hash hit means the whole prefix matches (token contents are
additionally compared exactly -- a hash collision can cost a missed
hit, never a wrong one).  :meth:`release` drops a reference; a block
reaching refcount 0 is not reclaimed but parked in an LRU cache and
only :meth:`alloc` evicts it when the free list runs dry.  A write to a
block with refcount > 1 must go through :meth:`cow` (copy-on-write):
the writer gets a private copy, the shared block stays immutable for
its other readers.

Safety argument for shared *partial* blocks (a tail block whose slots
``[0, filled)`` are valid for the sharer): every slot a sharer did not
itself (over)write holds a token at an absolute position >= the
sharer's own write frontier, so the causal mask (``kv_pos <= q_pos``)
excludes it from every one of the sharer's reads until the sharer has
replaced it.  Writers still must COW while refcount > 1 so a block
never mutates under a *live* reader's table.

Sliding-window reclaim.  With ``cfg.window = w < max_len`` a request's
oldest blocks eventually hold only tokens at positions ``<= q - w`` for
every future query position ``q`` -- permanently masked, pure dead
weight in HBM.  The scheduler *releases* such blocks back through the
refcount path (:meth:`release` with ``window_reclaim=True``): a
prefix-shared block survives for its other readers, a sole-owned one
returns to the pool (LRU-parked while indexed, free-listed otherwise).
Block tables become **rolling windows**: the request's table keeps only
live blocks and carries a per-request ``block_offset`` (count of
reclaimed leading logical blocks) so decode writes still land at
``table[slot // bs - offset]``.  Steady-state decode memory is
O(window/block_size + 1) blocks per request instead of O(length);
:meth:`report` counts these reclaims separately from LRU evictions
(``window_reclaimed``).

Invariants the pool maintains (see :meth:`validate`):
* the null block is never allocated, shared, indexed or freed;
* freshly allocated (and LRU-evicted) blocks have positions reset to -1
  (stale positions from a freed request could otherwise pass the causal
  mask);
* every non-free block has a refcount >= 0; refcount-0 blocks are
  exactly the LRU-cached ones, and only indexed blocks are cached;
* a prefix-index entry's recorded token chain always matches the
  tokens whose KV the block holds (in slots ``[0, filled)``);
* decode/prefill steps receive the pool with this batch's
  ``block_tables`` / ``length`` injected per layer (:meth:`step_caches`)
  and give updated pool leaves back through :meth:`absorb`.

State slot pool.  SSM conv+state leaves (mamba and hybrid mixers) and
enc-dec cross-K/V caches (one per decoder layer, ``enc_len`` encoder
rows) are fixed-size per request -- nothing token-granular to page.
:class:`StateSlotPool` allocates them in whole-request **slots**: the
pool's state leaves carry ``n_state_slots + 1`` rows (row 0 reserved
null, read by padded batch lanes), a request owns one slot id for its
lifetime, and :meth:`step_caches` injects the batch's slot ids so the
mixers and the cross-attention gather and scatter their rows.  A
pure-SSM pool has no blocks to speak of (``needs_blocks`` is False); a
hybrid or enc-dec pool has both.  A cross cache's ``pos`` rows rest at
-1 (masked), not 0, in the null slot and in a freshly taken one.

Telemetry.  Event counters (``repro_pool_*``: prefix hits/lookups, COW
copies, evictions, window reclaims, chain-hash ops) live in a shared
:class:`repro_torch.obs.metrics.MetricsRegistry` (pass ``metrics=``; the pool
otherwise keeps a private one).  The registry is the **source of
truth**: the legacy ``n_cow``-style attributes are read-only properties
over it and :meth:`report` is a snapshot of it, so the dict keys, the
benchmark scripts, and a scraped ``registry.render()`` can never
disagree (ROADMAP "Observability" contract).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import (ModelConfig, QuantConfig,
                                       effective_kv_bits)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.faults import NULL_FAULTS

_KV_KEYS = ("k", "v", "k_scale", "v_scale", "pos")

# root of every prompt-token chain hash (any fixed value works; chains
# are only compared within one pool's lifetime)
_CHAIN_ROOT = hash(("paged-kv-prefix-root",))


def _chain_hash(prev: int, tokens: tuple) -> int:
    """Extend a prompt-chain hash by one block's tokens.  The chain
    commits to every token since position 0, so equal hashes (plus the
    exact token compare on lookup) mean equal full prefixes."""
    return hash((prev, tokens))


def _chain_root(salt=None) -> int:
    """Root of a prompt chain's hash walk.  ``salt`` (the serving
    precision, in nested-weight serving) partitions the prefix index:
    equal prompts registered under different salts share nothing -- a
    4-bit lane must never warm-start from KV a request computed through
    8-bit weights, whose logits (and thus cached values under quantized
    KV re-read) belong to a different effective model."""
    if salt is None:
        return _CHAIN_ROOT
    return _chain_hash(_CHAIN_ROOT, ("precision-salt", int(salt)))


def _rest_value(key: str) -> int:
    """What a state slot's rows hold when no request owns them: -1 for a
    cross cache's positions (masked), 0 for every other leaf."""
    return -1 if key == "pos" else 0


def needs_blocks(cfg: ModelConfig) -> bool:
    """True when the decoder owns at least one self-attention KV stream
    (pageable in token blocks).  Pure-SSM archs have none -- their pool
    is slots only."""
    return any(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def needs_state_slots(cfg: ModelConfig) -> bool:
    """True when the arch carries fixed-size per-request state that the
    paged engine must slot-allocate: SSM conv+state (ssm/hybrid) or
    enc-dec cross caches (audio)."""
    return cfg.family in ("ssm", "hybrid", "audio")


def supports_paging(cfg: ModelConfig) -> bool:
    """Attention KV goes through the block pool, SSM/hybrid state and
    enc-dec cross caches through the fixed-size slot pool."""
    return needs_blocks(cfg) or needs_state_slots(cfg)


@dataclasses.dataclass
class ChainMemo:
    """Per-owner memo of how far a sequence's chain has already been
    registered: the first ``n_full`` full blocks of the owner's block
    list are indexed *by the owner's own blocks* (their entries are
    stable while the owner holds its references) and ``h`` is the chain
    hash through them.  :meth:`PagedKVPool.register_chain` resumes from
    here instead of re-hashing the whole chain -- release/finish/preempt
    bookkeeping for a length-L chain costs O(new blocks), not O(L)
    A block that lost the duplicate race to
    another physical copy stalls the memo, keeping it re-walkable so it
    can claim the index once the incumbent is evicted.  Owned by
    :class:`repro_torch.serving.scheduler.SequenceState`; a fresh state
    (re-admission after preemption) starts a fresh memo.
    """
    n_full: int = 0
    h: int = _CHAIN_ROOT


@dataclasses.dataclass
class _BlockMeta:
    """Prefix-index record for one cached/cacheable block."""
    prefix_hash: int       # chain hash of everything BEFORE this block
    start: int             # absolute position of the block's first token
    tokens: tuple          # tokens resident in slots [0, len(tokens))

    @property
    def filled(self) -> int:
        return len(self.tokens)

    @property
    def key(self) -> int:
        return _chain_hash(self.prefix_hash, self.tokens)


@dataclasses.dataclass
class PrefixHit:
    """Result of :meth:`PagedKVPool.acquire_prefix` (refcounts already
    bumped on ``ids``)."""
    ids: list              # acquired blocks, chain order
    cached_len: int        # prompt tokens covered (KV already resident)
    partial: bool          # last id is a partially-filled block
    filled: int            # valid tokens in that partial block (else 0)


class StateSlotPool:
    """Fixed-size per-request state slots (SSM conv+state).

    The allocation unit is one request's entire state -- every mamba
    layer's conv/state row -- addressed by a single slot id valid in all
    layers (the slot analogue of the block pool's one-logical-id-
    addresses-all-layers rule).  Row 0 is the reserved **null slot**:
    never allocated; padded batch lanes gather it (zeros, contributing
    nothing) and their writes are dropped.
    """

    def __init__(self, n_slots: int):
        assert n_slots >= 1, "need at least one usable slot"
        self.n_slots = n_slots
        # LIFO free list; slot 0 reserved as the null slot
        self._free = list(range(n_slots, 0, -1))
        self._used: set = set()

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def used_slots(self) -> int:
        return len(self._used)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"slot pool exhausted: all {self.n_slots} state slots "
                f"are owned by running requests")
        slot = self._free.pop()
        self._used.add(slot)
        return slot

    def free(self, slot: int) -> None:
        slot = int(slot)
        if slot == 0:
            raise ValueError("free(): slot 0 is the reserved null slot")
        if slot not in self._used:
            raise ValueError(f"free(): double free of slot {slot}")
        self._used.remove(slot)
        self._free.append(slot)

    def validate(self) -> None:
        free = set(self._free)
        assert 0 not in free and 0 not in self._used, "null slot escaped"
        assert not (free & self._used), free & self._used
        assert len(free) + len(self._used) == self.n_slots, \
            (len(free), len(self._used), self.n_slots)


class PagedKVPool:
    """Refcounted copy-on-write pool of packed bipolar KV planes on one
    device, plus a fixed-size slot pool for per-request SSM / enc-dec
    cross state.

    ``n_blocks`` counts physical blocks *including* the reserved null
    block 0; capacity available to requests is ``n_usable = n_blocks-1``
    blocks of ``block_size`` tokens each.  ``prefix_cache=False``: no
    index, release destroys immediately.  ``n_state_slots`` (required
    for ssm, hybrid and audio archs) sizes the :class:`StateSlotPool`;
    ``enc_len`` caps the enc-dec cross rows and is required for audio
    archs (the engine passes the stub frontend's length for its
    ``max_len``; the pool cannot derive it, its own ``max_len`` being
    the block size).
    """

    def __init__(self, cfg: ModelConfig, n_blocks: int, block_size: int,
                 quant: Optional[QuantConfig] = None, *,
                 prefix_cache: bool = True, n_state_slots: int = 0,
                 enc_len: Optional[int] = None,
                 device="cuda", metrics: Optional[MetricsRegistry] = None,
                 faults=None):
        M.check_supported(cfg)
        assert supports_paging(cfg), \
            f"no pageable KV stream or slottable state for {cfg.family!r}"
        kv_bits = effective_kv_bits(cfg, quant)
        self.needs_blocks = needs_blocks(cfg)
        self.needs_slots = needs_state_slots(cfg)
        if self.needs_blocks:
            assert kv_bits, "the paged pool stores packed bipolar " \
                "planes: set kv_bits (QuantConfig.kv_bits or " \
                "ModelConfig.kv_bits)"
        assert n_blocks >= 2, "need at least the null block + one usable"
        if cfg.window is not None and block_size > cfg.window:
            raise ValueError(
                f"Engine block_size={block_size} exceeds ModelConfig."
                f"window={cfg.window}: a block spanning more than the "
                f"attention window could hold live and dead tokens at "
                f"once for arbitrarily long; choose block_size <= "
                f"window (or raise ModelConfig.window)")
        if self.needs_slots and n_state_slots < 1:
            raise ValueError(
                f"{cfg.family} archs carry fixed-size per-request state "
                f"(SSM conv+state / enc-dec cross caches): pass "
                f"n_state_slots >= 1 so the slot pool can hold it (Engine "
                f"sizes it to max_batch)")
        if cfg.family == "audio" and enc_len is None:
            raise ValueError(
                "audio archs need enc_len (the cross-row capacity): the "
                "pool passes block_size where init_caches expects "
                "max_len, so it cannot derive the frontend length "
                "itself -- Engine passes enc_len(cfg, max_len)")
        self.cfg, self.quant = cfg, quant
        # fault injection facade (tests/chaos harness): site checks are
        # constant no-ops on the NULL_FAULTS twin, same contract as obs
        self.faults = faults if faults is not None else NULL_FAULTS
        self.kv_bits = kv_bits
        self.n_blocks, self.block_size = n_blocks, block_size
        self.prefix_cache = prefix_cache
        self.slots = (StateSlotPool(n_state_slots)
                      if self.needs_slots else None)
        self.caches = M.init_caches(
            cfg, batch=n_blocks, max_len=block_size, quant=quant,
            device=device, enc_len=enc_len,
            state_batch=(n_state_slots + 1) if self.needs_slots else None)
        self.device = next(iter(self.caches["layers"][0].values())).device
        # LIFO free list, block 0 reserved as the null block
        self._free = list(range(n_blocks - 1, 0, -1))
        self._ref: dict = {}            # block id -> refcount (>= 0)
        self._lru: OrderedDict = OrderedDict()   # refcount-0 cached blocks
        self._meta: dict = {}           # block id -> _BlockMeta
        self._full_index: dict = {}     # chain hash -> full block id
        self._partial_index: dict = {}  # prefix chain hash -> partial id
        # bumped on every state change that could alter an allocation or
        # prefix-lookup outcome; lets the scheduler memoize a failed
        # admission probe instead of re-walking the head's chain per step
        self.version = 0
        # event accounting lives in the metrics registry (one
        # namespace shared with the scheduler and engine -- report()
        # and the legacy ``n_*`` attributes below are snapshots of it).
        # A standalone pool gets a private registry; the engine passes
        # its own so everything scrapes in one render()
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        m = self.metrics
        self._c_prefix_hits = m.counter(
            "repro_pool_prefix_hits",
            "committed admissions that reused >= 1 cached prefix block")
        self._c_hit_tokens = m.counter(
            "repro_pool_prefix_hit_tokens",
            "prompt tokens served from resident prefix blocks")
        self._c_lookups = m.counter(
            "repro_pool_prefix_lookups",
            "committed admissions probed against the prefix index")
        self._c_lookup_tokens = m.counter(
            "repro_pool_prefix_lookup_tokens",
            "prompt tokens of committed admissions")
        self._c_cow = m.counter(
            "repro_pool_cow", "copy-on-write block copies")
        self._c_evictions = m.counter(
            "repro_pool_evictions",
            "LRU-cached blocks evicted under allocation pressure")
        self._c_window = m.counter(
            "repro_pool_window_reclaimed",
            "out-of-window blocks returned to the pool (SWA reclaim)")
        # block-chunk hashes computed by register_chain (the ChainMemo
        # resume point keeps this O(new blocks) per call, not O(chain))
        self._c_chain_ops = m.counter(
            "repro_pool_chain_hash_ops",
            "block-chunk hashes computed by register_chain")
        self._g_blocks = m.gauge(
            "repro_pool_blocks", "pool blocks by state",
            labelnames=("state",))

    # -- accounting ----------------------------------------------------------
    # Legacy counter attributes, preserved as registry snapshots: the
    # registry is the single source of truth.
    @property
    def n_prefix_hits(self) -> int:
        return int(self._c_prefix_hits.value)

    @property
    def n_hit_tokens(self) -> int:
        return int(self._c_hit_tokens.value)

    @property
    def n_lookups(self) -> int:
        return int(self._c_lookups.value)

    @property
    def n_lookup_tokens(self) -> int:
        return int(self._c_lookup_tokens.value)

    @property
    def n_cow(self) -> int:
        return int(self._c_cow.value)

    @property
    def n_evictions(self) -> int:
        return int(self._c_evictions.value)

    @property
    def n_window_reclaimed(self) -> int:
        return int(self._c_window.value)

    @property
    def n_chain_hash_ops(self) -> int:
        return int(self._c_chain_ops.value)

    @property
    def n_usable(self) -> int:
        return self.n_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Blocks :meth:`alloc` can hand out *right now*: truly free ones
        plus refcount-0 cached blocks (evictable)."""
        return len(self._free) + len(self._lru)

    @property
    def used_blocks(self) -> int:
        """Blocks some request currently references (refcount >= 1)."""
        return self.n_usable - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks parked in the LRU prefix cache."""
        return len(self._lru)

    @property
    def shared_blocks(self) -> int:
        """Blocks mapped by more than one live block table."""
        return sum(1 for r in self._ref.values() if r > 1)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def report(self, tokens_resident: Optional[int] = None) -> dict:
        """Occupancy / fragmentation / sharing accounting.

        ``tokens_resident``: total tokens currently cached across
        requests (the scheduler knows; the pool only sees blocks).
        Internal fragmentation = allocated-but-empty token slots as a
        fraction of allocated slots.

        Every event-counter key is read back from the metrics registry
        (the pool increments registry counters directly), so this dict
        is a *snapshot* of the shared namespace and can never drift
        from a scraped ``registry.render()``."""
        from repro_torch.serving.engine import kv_cache_bytes
        self.sync_gauges()
        pool_bytes = kv_cache_bytes(self.caches)
        payload = kv_cache_bytes(self.caches, payload_only=True)
        slots = self.used_blocks * self.block_size
        rep = dict(
            n_blocks=self.n_blocks, block_size=self.block_size,
            kv_bits=self.kv_bits,
            n_usable=self.n_usable, free_blocks=self.free_blocks,
            used_blocks=self.used_blocks,
            cached_blocks=self.cached_blocks,
            shared_blocks=self.shared_blocks,
            max_refcount=max(self._ref.values(), default=0),
            prefix_hits=self.n_prefix_hits,
            prefix_hit_tokens=self.n_hit_tokens,
            prefix_lookups=self.n_lookups,
            prefix_lookup_tokens=self.n_lookup_tokens,
            cow_copies=self.n_cow,
            evictions=self.n_evictions,
            window_reclaimed=self.n_window_reclaimed,
            chain_hash_ops=self.n_chain_hash_ops,
            pool_bytes=int(pool_bytes), payload_bytes=int(payload),
            bytes_per_block=int(pool_bytes / max(self.n_blocks, 1)),
            occupancy=self.used_blocks / max(self.n_usable, 1),
        )
        if self.slots is not None:
            rep.update(state_slots=self.slots.n_slots,
                       free_state_slots=self.slots.free_slots,
                       used_state_slots=self.slots.used_slots)
        if tokens_resident is not None:
            rep["tokens_resident"] = int(tokens_resident)
            rep["fragmentation"] = (
                1.0 - tokens_resident / slots if slots else 0.0)
        return rep

    def sync_gauges(self) -> None:
        """Refresh the registry's block-state gauges from the live
        pool structure (called by :meth:`report` and the engine's
        per-step hook; gauges are derived state, counters are not)."""
        self._g_blocks.labels(state="free").set(len(self._free))
        self._g_blocks.labels(state="used").set(self.used_blocks)
        self._g_blocks.labels(state="cached").set(self.cached_blocks)
        self._g_blocks.labels(state="shared").set(self.shared_blocks)

    # -- alloc / free --------------------------------------------------------
    def alloc(self, n: int) -> list:
        """Take ``n`` blocks at refcount 1 with positions reset to -1.

        The free list is drained first; when dry, refcount-0 cached
        blocks are evicted in LRU order (their prefix-index entries are
        dropped with them).

        Fault sites (both consulted BEFORE any mutation, so alloc is
        atomic -- it either completes or leaves the pool untouched):
        ``alloc_fail`` raises the exhaustion error on a satisfiable
        request; ``forced_evict`` evicts one LRU-cached block first."""
        if self.faults.alloc_fail(n):
            raise RuntimeError(
                f"pool exhausted (injected fault): want {n} blocks, "
                f"{self.free_blocks} free")
        if n > self.free_blocks:
            raise RuntimeError(
                f"pool exhausted: want {n} blocks, {self.free_blocks} free")
        if self.faults.forced_evict() and self._lru:
            victim, _ = self._lru.popitem(last=False)       # LRU end
            self._unregister(victim)
            del self._ref[victim]
            self._free.append(victim)
            self._c_evictions.inc()
        self.version += 1
        ids = []
        for _ in range(n):
            if not self._free:
                victim, _ = self._lru.popitem(last=False)   # LRU end
                self._unregister(victim)
                del self._ref[victim]
                self._free.append(victim)
                self._c_evictions.inc()
            bid = self._free.pop()
            self._ref[bid] = 1
            ids.append(bid)
        self._reset_pos(ids)
        return ids

    def free(self, ids) -> None:
        """Destroy blocks outright (no caching).

        Safe against misuse: freeing an empty list is a no-op; freeing a
        block that is not live (double-free), freeing the null block, a
        duplicated id, or a block other tables still reference raises a
        clear error instead of silently corrupting the free list."""
        ids = list(ids)
        if len(set(ids)) != len(ids):
            raise ValueError(f"free(): duplicate block ids in {ids}")
        for bid in ids:
            bid = int(bid)
            if bid == 0:
                raise ValueError("free(): block 0 is the reserved null block")
            if bid not in self._ref:
                raise ValueError(
                    f"free(): double free of block {bid} (not live; free "
                    f"list and prefix cache are intact)")
            if self._ref[bid] > 1:
                raise ValueError(
                    f"free(): block {bid} still has refcount "
                    f"{self._ref[bid]}; release() the extra references")
        self.version += 1
        for bid in ids:
            self._destroy(int(bid))

    # -- refcounting ---------------------------------------------------------
    def acquire(self, ids) -> None:
        """Add one reference per block (a cached block leaves the LRU)."""
        ids = list(ids)
        if ids:
            self.version += 1
        for bid in ids:
            bid = int(bid)
            assert bid != 0 and bid in self._ref, bid
            if self._ref[bid] == 0:
                self._lru.pop(bid)
            self._ref[bid] += 1

    def release(self, ids, *, window_reclaim: bool = False) -> None:
        """Drop one reference per block.  At refcount 0 an indexed block
        parks in the LRU cache (evicted only when :meth:`alloc` runs
        dry); an unindexed one is destroyed.  With ``prefix_cache=False``
        refcount 0 always destroys.

        ``window_reclaim``: this release retires an out-of-window block
        (sliding-window attention: every token the block holds is
        permanently masked for its owner).  Prefix-shared blocks survive
        for their other readers -- ``report()``'s ``window_reclaimed``
        counts only blocks that reached refcount 0 and so became
        *reallocatable*: free-listed if unindexed, LRU-parked if the
        prefix index still maps them (a parked block serves future
        same-prefix hits until allocation pressure takes it, at which
        point it ALSO counts in ``evictions`` -- the two counters tally
        different events, retire-by-window vs reuse-under-pressure, not
        disjoint block sets)."""
        ids = list(ids)
        if ids:
            self.version += 1
        for bid in ids:
            bid = int(bid)
            if self._ref.get(bid, 0) < 1:
                raise ValueError(
                    f"release(): block {bid} has no live reference "
                    f"(double release?)")
            self._ref[bid] -= 1
            if self._ref[bid] > 0:
                continue
            if window_reclaim:
                self._c_window.inc()
            if self.prefix_cache and bid in self._meta:
                self._lru[bid] = None          # MRU end
            else:
                self._destroy(bid)

    @property
    def free_uncached_blocks(self) -> int:
        """Blocks on the free list proper -- allocatable WITHOUT evicting
        a cached (refcount-0, prefix-indexed) block.  The sub-block
        window compactor gates on this: trading a cached block for a
        net-zero block-count move would silently shrink the prefix
        cache."""
        return len(self._free)

    def copy_tail(self, src: int, dst: int, start: int) -> None:
        """Copy slot rows ``start..block_size`` of block ``src`` into
        the SAME slots of ``dst``, every plane plus the ``pos`` tags
        (sub-block sliding-window compaction: the live tail of a
        straddling block moves, with its absolute positions, into a
        fresh block that doubles as the chain's next append target).
        ``src`` is only read -- prefix-shared copies stay intact for
        their other readers."""
        s, d = int(src), int(dst)
        sl = slice(int(start), self.block_size)
        for c in self._attn_caches():
            for key in _KV_KEYS:
                c[key][d, sl] = c[key][s, sl]        # in place

    def cow(self, bid: int) -> int:
        """Copy-on-write: clone ``bid``'s planes into a fresh block and
        drop one reference on the original.  Callers must route every
        write to a block with refcount > 1 through here, so shared
        blocks never mutate under another reader's table."""
        bid = int(bid)
        assert self._ref.get(bid, 0) >= 1, bid
        (new,) = self.alloc(1)
        for c in self._attn_caches():
            for key in _KV_KEYS:
                c[key][new] = c[key][bid]            # in place
        self.release([bid])
        self._c_cow.inc()
        return new

    def _destroy(self, bid: int) -> None:
        """Forget a block entirely: index entries dropped, back on the
        free list.  Positions are reset at the next alloc."""
        self._unregister(bid)
        self._ref.pop(bid, None)
        self._lru.pop(bid, None)
        self._free.append(bid)

    # -- prefix index --------------------------------------------------------
    def acquire_prefix(self, tokens, *, salt=None) -> PrefixHit:
        """Longest cached prefix of ``tokens`` whose KV is resident.

        ``salt`` must match the salt the chain was registered under
        (:func:`_chain_root`): nested-precision serving salts with the
        request's served bits, so lanes only share KV at equal
        precision.

        Walks block-size chunks of the prompt chain through the full
        index, then probes for a cached partial tail block continuing
        the chain.  Coverage is capped at ``len(tokens) - 1``: the last
        token must always be recomputed so the caller has logits to
        sample from.  Every returned block is acquired (refcount +1);
        token contents AND the recorded prefix hash / start offset are
        compared exactly, so a chain-hash collision can only cost a
        miss, never serve KV computed under a different prefix.  Hit
        statistics are NOT recorded here (a capacity-gated admission
        may re-probe the same queue head every step): the caller
        reports a committed admission via :meth:`record_hit`."""
        tokens = np.asarray(tokens)
        n = len(tokens)
        ids: list = []
        h = _chain_root(salt)
        covered = 0
        bs = self.block_size
        if self.prefix_cache:
            while covered + bs <= n - 1:
                chunk = tuple(int(t) for t in tokens[covered:covered + bs])
                bid = self._full_index.get(_chain_hash(h, chunk))
                if bid is None:
                    break
                meta = self._meta[bid]
                if meta.tokens != chunk or meta.prefix_hash != h \
                        or meta.start != covered:
                    break
                ids.append(bid)
                h = _chain_hash(h, chunk)
                covered += bs
        partial, filled = False, 0
        if self.prefix_cache:
            bid = self._partial_index.get(h)
            if bid is not None and bid not in ids:
                meta = self._meta[bid]
                f = meta.filled
                chunk = tuple(int(t) for t in tokens[covered:covered + f])
                if 0 < f <= n - 1 - covered and meta.tokens == chunk \
                        and meta.prefix_hash == h and meta.start == covered:
                    ids.append(bid)
                    partial, filled = True, f
                    covered += f
        self.acquire(ids)
        return PrefixHit(ids=ids, cached_len=covered, partial=partial,
                         filled=filled)

    def record_hit(self, hit: PrefixHit, n_tokens: int) -> None:
        """Count a *committed* admission in the hit statistics -- one
        lookup per admitted request.  Probes that failed the capacity
        gate and released their blocks must not inflate the counters
        that reports and benchmarks divide by prompt tokens."""
        self._c_lookups.inc()
        self._c_lookup_tokens.inc(int(n_tokens))
        if hit.ids:
            self._c_prefix_hits.inc()
            self._c_hit_tokens.inc(hit.cached_len)

    def register_chain(self, tokens, block_ids,
                       memo: Optional[ChainMemo] = None,
                       salt=None) -> None:
        """Index ``block_ids`` under the chain hashes of ``tokens``.

        ``block_ids[j]`` must hold the KV of ``tokens[j*bs:(j+1)*bs]``
        (the trailing partially-filled block included).  Existing
        entries win on duplicate content (the newcomer simply stays
        unindexed and is destroyed at release); a partial entry is
        replaced only by a longer partial on the same chain.

        ``memo`` (a per-owner :class:`ChainMemo`) resumes the walk after
        the full blocks a previous call already registered -- their
        tokens, ids and indexing outcome are immutable while the owner
        holds its references -- so repeated registration of a growing
        chain (every release/finish/preempt) hashes only the *new*
        blocks instead of re-walking the whole chain.

        ``salt`` must equal the owner's :meth:`acquire_prefix` salt --
        the chain lands in that salt's partition of the index.  A memo
        that has advanced past block 0 already carries the salted hash,
        so only the fresh walk consults ``salt``."""
        if not self.prefix_cache:
            return
        self.version += 1
        tokens = np.asarray(tokens)
        bs = self.block_size
        start, h = 0, _chain_root(salt)
        if memo is not None and memo.n_full:
            start, h = min(memo.n_full, len(block_ids)), memo.h
        for j in range(start, len(block_ids)):
            bid = int(block_ids[j])
            lo = j * bs
            chunk = tuple(int(t) for t in tokens[lo:lo + bs])
            if not chunk:
                break
            self._c_chain_ops.inc()
            meta = _BlockMeta(prefix_hash=h, start=lo, tokens=chunk)
            if len(chunk) == bs:
                key = meta.key
                cur = self._full_index.get(key)
                if cur is None:
                    self._unregister(bid)
                    self._meta[bid] = meta
                    self._full_index[key] = bid
                # else: duplicate content -> keep the incumbent
                h = key
                # advance the memo only while contiguous AND this block
                # IS the index entry: a block that lost the duplicate
                # race must stay re-walkable, so it can be re-indexed
                # once the incumbent is evicted from the LRU cache
                if memo is not None and memo.n_full == j \
                        and self._full_index.get(key) == bid:
                    memo.n_full, memo.h = j + 1, key
            else:                                   # partial tail
                cur = self._partial_index.get(h)
                if cur == bid or cur is None \
                        or self._meta[cur].filled < len(chunk):
                    if cur is not None and cur != bid:
                        self._unregister(cur)
                        if self._ref.get(cur) == 0:   # cached + unindexed
                            self._destroy(cur)        # -> useless, reclaim
                    self._unregister(bid)
                    self._meta[bid] = meta
                    self._partial_index[h] = bid
                break                               # chain ends here

    def _unregister(self, bid: int) -> None:
        meta = self._meta.pop(bid, None)
        if meta is None:
            return
        if meta.filled == self.block_size:
            if self._full_index.get(meta.key) == bid:
                del self._full_index[meta.key]
        elif self._partial_index.get(meta.prefix_hash) == bid:
            del self._partial_index[meta.prefix_hash]

    # -- invariants (test/debug surface) ------------------------------------
    def validate(self, check_contents: bool = False) -> None:
        """Assert the pool's structural invariants; with
        ``check_contents`` also verify that every indexed block's
        recorded token chain agrees with the resident positions
        (hash -> contents agreement) and that the null slot's rows are
        still at rest in every state leaf (pad lanes read them): zero,
        and -1 in a cross cache's ``pos``."""
        free = set(self._free)
        live = set(self._ref)
        assert 0 not in free and 0 not in live, "null block entered the pool"
        assert not (free & live), f"free list ∩ live set: {free & live}"
        assert len(free) + len(live) == self.n_usable, \
            (len(free), len(live), self.n_usable)
        assert all(r >= 0 for r in self._ref.values()), self._ref
        zero = {b for b, r in self._ref.items() if r == 0}
        assert zero == set(self._lru), (zero, set(self._lru))
        assert set(self._meta) <= live, "index entry for a freed block"
        for key, bid in self._full_index.items():
            meta = self._meta.get(bid)
            assert meta is not None and meta.filled == self.block_size
            assert meta.key == key
        for h, bid in self._partial_index.items():
            meta = self._meta.get(bid)
            assert meta is not None and 0 < meta.filled < self.block_size
            assert meta.prefix_hash == h
        if self.slots is not None:
            self.slots.validate()
        if check_contents:
            for c in self._attn_caches():
                pos = c["pos"].cpu().numpy()
                assert (pos[0] == -1).all(), "null block positions moved"
                for bid, meta in self._meta.items():
                    want = meta.start + np.arange(meta.filled)
                    got = pos[bid, :meta.filled]
                    assert (got == want).all(), (bid, got, want)
                break    # one layer suffices: ids address all layers alike
            for c in self._state_caches():
                for key, leaf in c.items():
                    assert leaf[0].eq(_rest_value(key)).all(), \
                        f"null slot {key} row written"

    # -- state slots ---------------------------------------------------------
    def alloc_slot(self) -> int:
        """Take one state slot with its rows reset in place (a reused
        slot must not leak a freed request's SSM state through the
        recurrence, or its cross-K/V through the position mask): zero,
        and -1 in a cross cache's ``pos``.  The ``slot_fail`` fault site
        fires before the slot pool mutates (admission rolls cleanly
        back)."""
        assert self.slots is not None, "pool has no state slot pool"
        if self.faults.slot_fail():
            raise RuntimeError(
                f"slot pool exhausted (injected fault): "
                f"{self.slots.free_slots} of {self.slots.n_slots} free")
        slot = self.slots.alloc()
        for c in self._state_caches():
            for key, leaf in c.items():
                leaf[slot] = _rest_value(key)        # in place
        return slot

    def free_slot(self, slot: int) -> None:
        assert self.slots is not None, "pool has no state slot pool"
        self.slots.free(slot)

    # -- tree plumbing -------------------------------------------------------
    @staticmethod
    def _is_attn(c) -> bool:
        """Self-attention KV cache dict (block-addressed), vs an SSM
        state dict (``conv``/``state``, slot-addressed)."""
        return "conv" not in c

    def _attn_caches(self, caches=None):
        """Every attention layer's KV pool dict (one logical block id
        addresses the same physical index in each)."""
        caches = self.caches if caches is None else caches
        yield from (c for c in caches["layers"] if self._is_attn(c))

    def _state_caches(self, caches=None):
        """Every slot-addressed state dict: each mamba layer's conv +
        state, then each enc-dec cross cache."""
        caches = self.caches if caches is None else caches
        yield from (c for c in caches["layers"] if not self._is_attn(c))
        yield from caches.get("cross", [])

    def _reset_pos(self, ids) -> None:
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        for c in self._attn_caches():
            c["pos"][idx] = -1                       # in place

    _STEP_KEYS = ("block_tables", "length", "block_offset", "slots")

    def step_caches(self, block_tables: np.ndarray, lengths: np.ndarray,
                    *, block_offsets: Optional[np.ndarray] = None,
                    slots: Optional[np.ndarray] = None):
        """Pool tree for one decode/prefill step: each attention layer's
        pool dict gains this batch's ``block_tables (B, NB)``, ``length
        (B,)`` -- the write offset of the step's first new token -- and
        ``block_offset (B,)``, the count of leading logical blocks
        reclaimed out-of-window (entry ``j`` maps logical block ``j +
        offset``); each mamba layer's state dict and each cross cache
        gains ``slots (B,)``, the batch rows' slot ids (-1 for padded
        lanes).  The pool tensors themselves are shared, not copied: the
        step writes them in place."""
        dev = self.device
        bt = torch.as_tensor(np.asarray(block_tables, np.int32), device=dev)
        ln = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
        off = (torch.zeros_like(ln) if block_offsets is None else
               torch.as_tensor(np.asarray(block_offsets, np.int32),
                               device=dev))
        sl = None if slots is None else torch.as_tensor(
            np.asarray(slots, np.int32), device=dev)

        def aug(c):
            if self._is_attn(c):
                return dict(c, block_tables=bt, length=ln, block_offset=off)
            assert sl is not None, "state caches need this batch's slot ids"
            return dict(c, slots=sl)

        out = {"layers": [aug(c) for c in self.caches["layers"]]}
        if "cross" in self.caches:
            assert sl is not None, "cross caches need this batch's slot ids"
            out["cross"] = [dict(c, slots=sl) for c in self.caches["cross"]]
        return out

    def absorb(self, new_caches) -> None:
        """Store the step's pool leaves back, stripping the per-step keys
        (the leaves are the pool's own tensors, updated in place)."""
        self.caches = {
            section: [{k: v for k, v in c.items()
                       if k not in self._STEP_KEYS}
                      for c in new_caches[section]]
            for section in ("layers", "cross") if section in new_caches}
