"""Synthetic LM data pipeline.

No external corpora ship with the container, so training/calibration run on a
deterministic synthetic corpus with LM-like statistics:

  * Zipf-distributed unigrams (vocabulary rank-frequency ~ 1/k^a), and
  * a low-order Markov backbone (each token biases a successor bucket) so the
    model has real sequential structure to learn — cross-entropy drops well
    below the unigram entropy, which is what the examples/tests assert.

Deterministic per (seed, step): any host can regenerate any batch, which is
what makes checkpoint/restart and elastic rescaling exact (DESIGN §4).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


def byte_encode(text: str, vocab_size: int) -> np.ndarray:
    """UTF-8 byte tokenizer (ids 0..255 reserved; asserts vocab >= 256)."""
    assert vocab_size >= 256
    return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)


def byte_decode(tokens: np.ndarray) -> str:
    b = bytes(int(t) & 0xFF for t in np.asarray(tokens).ravel())
    return b.decode("utf-8", errors="replace")


@dataclasses.dataclass
class SyntheticCorpus:
    """Zipf + Markov token stream."""

    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    n_successors: int = 32     # Markov branching factor
    markov_weight: float = 0.7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = ranks ** (-self.zipf_a)
        self._unigram /= self._unigram.sum()
        # successor table: token t prefers tokens succ[t] (dense LM-ish graph)
        self._succ = rng.integers(0, v, size=(v, self.n_successors))

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        """Deterministic (tokens, labels) for one step.

        labels[t] = tokens[t+1]; the last label wraps to a fresh sample.
        """
        rng = np.random.default_rng((self.seed, step))
        v = self.vocab_size
        out = np.empty((batch_size, seq_len + 1), np.int32)
        # vectorized: choose per-position "use markov?" and successor slot
        base = rng.choice(v, size=(batch_size, seq_len + 1), p=self._unigram)
        use_mkv = rng.random((batch_size, seq_len + 1)) < self.markov_weight
        slot = rng.integers(0, self.n_successors, (batch_size, seq_len + 1))
        out[:, 0] = base[:, 0]
        for t in range(1, seq_len + 1):
            succ = self._succ[out[:, t - 1], slot[:, t]]
            out[:, t] = np.where(use_mkv[:, t], succ, base[:, t])
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def unigram_entropy(self) -> float:
        p = self._unigram
        return float(-(p * np.log(p)).sum())


def make_batches(corpus: SyntheticCorpus, batch_size: int, seq_len: int,
                 start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield corpus.batch(step, batch_size, seq_len)
        step += 1


@dataclasses.dataclass
class CalibrationSampler:
    """Paper §5.1: sample N sequences of fixed length for projector fitting."""

    corpus: SyntheticCorpus
    n_sequences: int = 64
    seq_len: int = 512
    batch_size: int = 8

    def batches(self) -> Iterator[np.ndarray]:
        n_batches = -(-self.n_sequences // self.batch_size)
        for i in range(n_batches):
            yield self.corpus.batch(10_000_000 + i, self.batch_size,
                                    self.seq_len)["tokens"]
