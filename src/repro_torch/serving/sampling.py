"""Token sampling: greedy / temperature / top-p (reference
``repro/serving/sampling.py``). Greedy is the exact argmax (first maximal
index, as ``jnp.argmax``). Temperature and top-p draw from an explicit
``torch.Generator``, so they match the reference in distribution only."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0     # 0 => greedy
    top_p: float = 1.0


def _filter_logits(logits, cfg: SamplerConfig):
    logits = logits.float() / cfg.temperature
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = torch.sum(cum < cfg.top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits >= cutoff, logits,
                             torch.full((), float("-inf"), device=logits.device))
    return logits


def sample(logits, cfg: SamplerConfig, generator=None):
    """logits (B, V) -> tokens (B,) int32."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_filter_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
