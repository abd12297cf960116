"""Synthetic data (own numpy copy of the reference's
``repro/data/synthetic.py``), deterministic given ``seed``:

1. ``lm_batches``: a structured LM stream (Zipf unigrams mixed with
   repeated motifs) so that small models have a learnable signal within a
   few hundred steps; the training launcher's data. Bit-equal to the
   reference's batches for the same arguments.
2. ``needle_stream``: long contexts with a motif planted at a known page
   and repeated at the end, so a good KV retriever must select the
   needle's page.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 64
    zipf_a: float = 1.3


class SyntheticLM:
    """Mixture of Zipf tokens and repeated motifs (copy structure)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.motifs = rng.integers(0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len))

    def _zipf(self, rng, n):
        z = rng.zipf(self.cfg.zipf_a, size=n)
        return (z - 1) % self.cfg.vocab_size

    def sample_row(self, rng) -> np.ndarray:
        cfg = self.cfg
        out = []
        while sum(map(len, out)) < cfg.seq_len:
            if rng.random() < 0.5:
                out.append(self.motifs[rng.integers(cfg.n_motifs)])
            else:
                out.append(self._zipf(rng, cfg.motif_len))
        return np.concatenate(out)[: cfg.seq_len]

    def batches(self) -> Iterator[np.ndarray]:
        """(batch_size, seq_len) int32 batches, forever."""
        rng = np.random.default_rng(self.cfg.seed + 1)
        while True:
            yield np.stack([self.sample_row(rng)
                            for _ in range(self.cfg.batch_size)]).astype(np.int32)


def lm_batches(vocab_size, seq_len, batch_size, seed=0) -> Iterator[np.ndarray]:
    return SyntheticLM(DataConfig(vocab_size, seq_len, batch_size, seed)).batches()


@dataclass(frozen=True)
class NeedleSample:
    tokens: np.ndarray      # (T,) context ending with the needle's query motif
    needle_page: int        # page index holding the needle
    answer: int             # token right after the needle motif


def needle_stream(vocab_size, seq_len, page_size, seed=0,
                  motif_len=8) -> Iterator[NeedleSample]:
    rng = np.random.default_rng(seed)
    while True:
        toks = (rng.zipf(1.3, size=seq_len) - 1) % vocab_size
        motif = rng.integers(0, vocab_size, size=motif_len)
        answer = int(rng.integers(0, vocab_size))
        lo, hi = 2 * page_size, seq_len - 4 * page_size - motif_len
        pos = int(rng.integers(lo, hi))
        toks[pos: pos + motif_len] = motif
        toks[pos + motif_len] = answer
        toks[seq_len - motif_len:] = motif
        yield NeedleSample(tokens=toks.astype(np.int32),
                           needle_page=pos // page_size, answer=answer)
