"""Needle-retrieval stream (own numpy copy of the reference's
``repro/data/synthetic.py:75``): long contexts with a motif planted at a
known page and repeated at the end, so a good KV retriever must select the
needle's page. Deterministic given ``seed``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


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
