"""Per-slot bigram drafter for speculative decoding (reference
``repro/core/drafter.py``).

FreeKV speculates on which pages the next step needs; this module
speculates on which tokens the model will emit, so one verify pass
(``models.model.serve_step_verify``) can commit several tokens a target
step. The drafter is training-free and model-free: a per-slot table of
bigram successors over the request's own stream (prompt, optional hint and
committed continuation).

The table is one top-level decode-state lane:

  ``draft_tab`` (B, vocab) int32: ``draft_tab[b, t]`` is the most recent
  successor of token ``t`` seen in slot ``b``'s stream, or -1.

It rides the slot splice and the preemption swap with the other top-level
lanes (``serving/kv_slots``). The prompt seeds it on the host at admission
(``seed_from_prompt``); ``propose`` and ``update`` run on the card inside
the decode window, with no host read.

Exactness does not depend on the drafts: the verify pass accepts the
longest prefix the target model agrees with, so a wrong proposal (or a
miss, proposing token 0) only costs its row of the drafted block.
"""
from __future__ import annotations

import numpy as np
import torch


def init_draft_tab(batch: int, vocab: int, device="cpu"):
    """Empty successor table: no bigram seen yet."""
    return torch.full((batch, vocab), -1, dtype=torch.int32, device=device)


def seed_from_prompt(vocab: int, tokens) -> np.ndarray:
    """Bigram table (1, vocab) of one request's prompt, on the host. Later
    occurrences win (``tab[t]`` is the most recent successor of ``t``), as
    ``update`` orders the generated stream."""
    tab = np.full((1, vocab), -1, np.int32)
    toks = np.asarray(tokens, np.int64)
    if toks.size >= 2:
        src = np.clip(toks[:-1], 0, vocab - 1)
        tab[0, src] = np.clip(toks[1:], 0, vocab - 1)
    return tab


def propose(tab, cur, draft_len: int):
    """Chain ``draft_len`` successor lookups from ``cur`` (B,) -> (B,
    draft_len) int32 proposals; a miss proposes token 0, which the verify
    pass rejects."""
    B = cur.shape[0]
    bidx = torch.arange(B, device=cur.device)
    out = []
    t = cur.to(torch.int64)
    for _ in range(draft_len):
        nxt = tab[bidx, t.clamp(0, tab.shape[1] - 1)]
        t = torch.where(nxt >= 0, nxt, torch.zeros_like(nxt)).to(torch.int64)
        out.append(t.to(torch.int32))
    if not out:
        return torch.zeros((B, 0), dtype=torch.int32, device=cur.device)
    return torch.stack(out, dim=1)


def update(tab, toks, emit):
    """Fold one verify block's committed bigrams into ``tab`` in place and
    return it. ``toks`` (B, S): the stream fed and emitted this block, where
    ``toks[:, j] -> toks[:, j + 1]`` is a bigram iff ``emit[:, j + 1]``.
    Rows are written one after another in stream order, as the
    one-token-a-step path would; a masked row writes back the value it
    read."""
    B, S = toks.shape
    V = tab.shape[1]
    bidx = torch.arange(B, device=tab.device)
    for j in range(S - 1):
        src = toks[:, j].to(torch.int64).clamp(0, V - 1)
        new = toks[:, j + 1].to(torch.int64).clamp(0, V - 1).to(tab.dtype)
        old = tab[bidx, src]
        tab[bidx, src] = torch.where(emit[:, j + 1], new, old)
    return tab
