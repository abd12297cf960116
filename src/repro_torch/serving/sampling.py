"""Token sampling: greedy / temperature / top-p (reference
``repro/serving/sampling.py``). Greedy is the exact argmax (first maximal
index, as ``jnp.argmax``).

Two entry points, as in the reference:

* ``sample(logits, cfg, generator)``: the static engine's batch sampler.
  Temperature and top-p draw from an explicit ``torch.Generator``, so they
  match the reference in distribution only.
* ``sample_step(logits, cfg, keys)``: the per-slot sampler the continuous
  scheduler runs on the card inside the decode window
  (``models.model.serve_step_sampled``). Greedy only: the reference draws
  token ``i`` of a request from ``fold_in(request_key(seed, uid), i)``, and
  those threefry streams are not ported yet (ROADMAP queue 1, item 4), so
  ``keys`` is carried but unused and a temperature raises.
"""
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


def sample_step(logits, cfg: SamplerConfig, keys=None):
    """Per-slot sampling: logits (B, V) -> (B,) int32, on the logits'
    device; ``keys`` (B, 2) is the per-slot key lane of the loop carry."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    raise NotImplementedError(
        "sampling with temperature > 0 under the continuous scheduler needs the "
        "reference's per-request threefry key streams (ROADMAP queue 1, item 4)")
