"""Synthetic token data pipeline: corpus generation, packing, sharded batches.

The port's copy of the JAX package's ``data/pipeline.py`` (numpy only, so
the batches are equal to the bit for the same ``DataConfig``); they stay
numpy and the trainer moves them to its device.

No external datasets are available offline, so the corpus is a seeded
Zipf-distributed token stream with injected n-gram structure (so models have
something learnable: loss should drop well below ln(vocab)).  Documents are
packed into fixed-length sequences with EOS separators, mirroring a real
LM pipeline's pack-and-shift stage.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    eos_id: int = 0
    ngram_order: int = 3
    ngram_strength: float = 0.8   # prob of following the n-gram machine


class SyntheticCorpus:
    """Deterministic pseudo-corpus with learnable bigram/trigram structure."""

    def __init__(self, dc: DataConfig):
        self.dc = dc
        rng = np.random.RandomState(dc.seed)
        V = dc.vocab_size
        # sparse deterministic successor table: each (a, b) -> c
        self._succ = rng.randint(1, V, size=(min(V, 4096), min(V, 4096)))
        # zipf unigram fallback, drawn as ``rng.choice(V, p=unigram)`` draws
        # it (the same cdf, one uniform each), with the cdf summed once
        # here rather than over all V tokens at every draw
        ranks = np.arange(1, V + 1)
        p = 1.0 / ranks ** 1.1
        self._unigram = p / p.sum()
        cdf = self._unigram.cumsum()
        self._cdf = cdf / cdf[-1]

    def doc(self, rng: np.random.RandomState, length: int) -> np.ndarray:
        V = self.dc.vocab_size
        n = self._succ.shape[0]
        out = np.empty(length, np.int64)
        a, b = rng.randint(1, V), rng.randint(1, V)
        for i in range(length):
            if rng.rand() < self.dc.ngram_strength:
                c = int(self._succ[a % n, b % n])
            else:
                c = int(self._cdf.searchsorted(rng.random_sample(),
                                               side="right"))
            out[i] = c
            a, b = b, c
        return out


def packed_batches(dc: DataConfig) -> Iterator[dict]:
    """Yields {"tokens": [B, S], "labels": [B, S]} int32 batches forever."""
    corpus = SyntheticCorpus(dc)
    rng = np.random.RandomState(dc.seed + 1)
    buf = np.empty(0, np.int64)
    need = dc.batch_size * (dc.seq_len + 1)
    while True:
        while buf.size < need:
            doc_len = int(rng.randint(dc.seq_len // 4, dc.seq_len * 2))
            doc = corpus.doc(rng, doc_len)
            buf = np.concatenate([buf, doc, [dc.eos_id]])
        chunk = buf[:need].reshape(dc.batch_size, dc.seq_len + 1)
        buf = buf[need:]
        yield {"tokens": chunk[:, :-1].astype(np.int32),
               "labels": chunk[:, 1:].astype(np.int32)}


def embeds_batches(dc: DataConfig, d_model: int) -> Iterator[dict]:
    """Stub-frontend batches (musicgen): precomputed frame embeddings."""
    rng = np.random.RandomState(dc.seed + 2)
    tok_iter = packed_batches(dc)
    table = rng.randn(dc.vocab_size, d_model).astype(np.float32) * 0.02
    for batch in tok_iter:
        yield {"embeds": table[batch["tokens"]],
               "labels": batch["labels"]}
