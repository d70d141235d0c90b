"""Deterministic synthetic token pipeline for LM training (counterpart of
``repro.data.tokens``; the same numpy code, so the streams are equal bit for
bit).

Tokens are generated from a counter-based PRNG keyed by (stream_seed, step,
shard), so the stream is (a) reproducible across restarts - a trainer
resumed from step k sees exactly the tokens it would have seen - and (b)
shardable across hosts without communication. A Zipf-ish marginal plus a
short Markov blend gives non-trivial, learnable structure for the
end-to-end examples.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, markov_order: int = 1):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        # fixed task structure: Zipf unigram + a sparse bigram table
        ranks = np.arange(1, vocab_size + 1)
        self.unigram = (1.0 / ranks ** 1.1)
        self.unigram /= self.unigram.sum()
        self.shift = rng.integers(1, vocab_size)

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        """(tokens, labels) for a global step, int32 numpy arrays of shape
        (batch // num_shards, seq_len); deterministic in (step, shard)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        b = self.batch // num_shards
        base = rng.choice(self.vocab_size, size=(b, self.seq_len + 1),
                          p=self.unigram)
        # half the positions follow a deterministic bigram (learnable signal)
        follow = rng.random((b, self.seq_len)) < 0.5
        nxt = (base[:, :-1] + self.shift) % self.vocab_size
        seq = base.copy()
        seq[:, 1:] = np.where(follow, nxt, base[:, 1:])
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        return tokens, labels
