"""Serving engine, static lockstep path (reference ``repro/serving/engine.py``,
``generate`` and ``_generate_batch``).

Requests are served in batches of ``batch_size``: left-pad the prompts, run
``prefill``, then one ``serve_step`` per generated token with host-side
sampling, stopping each row at its token limit or eos. The continuous
scheduler (slot pool, device decode loop, per-request sampling streams) is
the next slice of the port (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, FreeKVConfig
from repro_torch.models.model import DECODE_STAT_KEYS, prefill, serve_step
from repro_torch.serving.sampling import SamplerConfig, sample


@dataclass
class Request:
    uid: int
    tokens: np.ndarray                 # prompt (T,)
    max_new_tokens: int = 32
    eos_token: Optional[int] = None


@dataclass
class Completion:
    uid: int
    tokens: List[int]
    prefill_s: float
    decode_s: float
    steps: int
    stats: dict


def _request_stats(agg) -> dict:
    stats = dict(agg)
    if agg["kv_heads"] > 0:
        stats["correction_rate"] = agg["corrected"] / agg["kv_heads"]
        stats["mean_similarity"] = (agg["sim_sum"] / agg["sim_cnt"]
                                    if agg["sim_cnt"] else 0.0)
    if agg.get("sel_pages", 0) > 0:
        stats["spec_hit_rate"] = agg["spec_hit_pages"] / agg["sel_pages"]
    return stats


class ServeEngine:
    def __init__(self, cfg: ArchConfig, fkv: FreeKVConfig, params,
                 max_len: int, batch_size: int,
                 sampler: SamplerConfig = SamplerConfig(),
                 state_dtype=torch.float32,
                 scheduler: str = "static",
                 device="cuda"):
        if scheduler == "continuous":
            raise NotImplementedError(
                "scheduler='continuous' is not yet ported (ROADMAP queue 1, "
                "item 7); use scheduler='static'")
        if scheduler != "static":
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.device = resolve_device(device)
        self.cfg, self.fkv, self.params = cfg, fkv, params
        self.max_len, self.batch_size = max_len, batch_size
        self.sampler = sampler
        self.state_dtype = state_dtype
        self.scheduler = scheduler
        # whether every logit of the last generate() call was finite
        self.last_logits_finite: Optional[bool] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, requests: List[Request], seed: int = 0) -> List[Completion]:
        out: List[Completion] = []
        self.last_logits_finite = True
        for i in range(0, len(requests), self.batch_size):
            out.extend(self._generate_batch(requests[i: i + self.batch_size], seed + i))
        return out

    def _generate_batch(self, reqs: List[Request], seed: int) -> List[Completion]:
        cfg, fkv = self.cfg, self.fkv
        B = len(reqs)
        T = max(len(r.tokens) for r in reqs)
        toks = np.zeros((B, T), np.int32)
        for i, r in enumerate(reqs):            # left-pad to align the last token
            toks[i, T - len(r.tokens):] = r.tokens
        if T + max(r.max_new_tokens for r in reqs) > self.max_len:
            raise ValueError(f"prompt {T} + new tokens exceeds max_len {self.max_len}")
        batch = {"tokens": torch.from_numpy(toks).long().to(self.device)}

        t0 = time.perf_counter()
        logits, state = prefill(cfg, fkv, self.params, batch, max_len=self.max_len,
                                state_dtype=self.state_dtype)
        self._sync()
        prefill_s = time.perf_counter() - t0

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        max_new = max(r.max_new_tokens for r in reqs)
        out_toks = [[] for _ in reqs]
        aggs = [{k: 0.0 for k in DECODE_STAT_KEYS} for _ in reqs]
        decode_ss = [0.0 for _ in reqs]
        cur = sample(logits, self.sampler, gen)
        finite = torch.isfinite(logits).all()       # read once, after the batch
        done = [r.max_new_tokens <= 0 for r in reqs]
        for _ in range(max_new):
            cur_host = cur.tolist()
            for i, r in enumerate(reqs):
                if done[i]:
                    continue
                out_toks[i].append(cur_host[i])
                if len(out_toks[i]) >= r.max_new_tokens or \
                        (r.eos_token is not None and cur_host[i] == r.eos_token):
                    done[i] = True
            if all(done):
                break
            ts = time.perf_counter()
            logits, state, stats = serve_step(cfg, fkv, self.params, state,
                                              cur[:, None].long(), collect_stats=True)
            cur = sample(logits, self.sampler, gen)
            finite &= torch.isfinite(logits).all()
            # one device-to-host read for all the step's statistics
            stats_np = dict(zip(DECODE_STAT_KEYS, torch.stack(
                [stats[k] for k in DECODE_STAT_KEYS]).cpu().numpy()))
            dt = time.perf_counter() - ts
            for i in range(B):
                if not done[i]:
                    decode_ss[i] += dt
                    for k in aggs[i]:
                        aggs[i][k] += float(stats_np[k][i])
        self._sync()
        self.last_logits_finite = self.last_logits_finite and bool(finite)
        return [Completion(uid=r.uid, tokens=out_toks[i], prefill_s=prefill_s,
                           decode_s=decode_ss[i], steps=max(len(out_toks[i]) - 1, 0),
                           stats=_request_stats(aggs[i]))
                for i, r in enumerate(reqs)]
