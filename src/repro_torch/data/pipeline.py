"""Deterministic, stateless synthetic LM data pipeline.

A copy of the reference package's ``repro.data.pipeline`` (numpy only;
the port imports nothing of ``repro``): ``batch = batch_at(spec, step)``
is a pure function of (seed, step, shard), the same tokens in both
packages.  That is what makes checkpoint/restart *exact*: a resumed run
replays the identical token stream with no iterator state to persist.
Host-sharding: each data-parallel host materializes only its
``shard/num_shards`` slice of the global batch.

The stream is learnable (not uniform noise): each sequence interleaves
Markov-chain n-grams drawn from a small per-seed pattern bank with noise
tokens, so a small model visibly reduces its loss within a few hundred
steps.  The trainer moves each batch to its device with
``torch.from_numpy(...).to(device)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataSpec:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_patterns: int = 64        # pattern bank size
    pattern_len: int = 8
    noise_prob: float = 0.1
    num_shards: int = 1
    shard: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.num_shards == 0
        return self.global_batch // self.num_shards


def _pattern_bank(spec: DataSpec) -> np.ndarray:
    rng = np.random.default_rng(spec.seed ^ 0x5EED)
    return rng.integers(0, spec.vocab, (spec.n_patterns, spec.pattern_len),
                        dtype=np.int32)


def _markov(spec: DataSpec) -> np.ndarray:
    """Pattern-to-pattern transition table (deterministic per seed)."""
    rng = np.random.default_rng(spec.seed ^ 0xA11CE)
    return rng.integers(0, spec.n_patterns, (spec.n_patterns, 4),
                        dtype=np.int32)


def batch_at(spec: DataSpec, step: int) -> dict:
    """Materialize this shard's (local_batch, seq_len) batch for ``step``."""
    bank = _pattern_bank(spec)
    trans = _markov(spec)
    lb = spec.local_batch
    rng = np.random.default_rng(
        (spec.seed * 1_000_003 + step) * 65_537 + spec.shard)
    n_pat = spec.seq_len // spec.pattern_len + 2
    seqs = np.empty((lb, n_pat * spec.pattern_len), np.int32)
    state = rng.integers(0, spec.n_patterns, lb)
    for i in range(n_pat):
        seqs[:, i * spec.pattern_len:(i + 1) * spec.pattern_len] = bank[state]
        state = trans[state, rng.integers(0, 4, lb)]
    seqs = seqs[:, :spec.seq_len + 1]
    noise = rng.random(seqs.shape) < spec.noise_prob
    seqs = np.where(noise, rng.integers(0, spec.vocab, seqs.shape), seqs)
    return {"tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32)}
