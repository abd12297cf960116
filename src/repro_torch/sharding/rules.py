"""Which axis of a retrieval-state leaf carries its KV heads under
KV-head-group tensor parallelism (the KV-head branch of the reference's
``decode_state_spec``, ``repro/sharding/rules.py:145-173``).

The shards of ``core/sharded_retrieval.TPGroupShardedRetriever`` do not
read this table: each builds its slice of every leaf itself, as the plain
retriever of a local config whose head counts are divided by tp, and holds
it under ``"<shard>/<key>"``. The table says how those slices join back
into the unsharded layout (its KV heads, or for ``qprev`` its query heads;
the leaves with no such axis, lengths and ring positions, whole in every
shard): ``join_state`` does that join. The tests hold the table against
the reference's ``tp_state_specs`` and the joined state against the
unsharded retriever. The parameter rules wait for ``--model-parallel``
(ROADMAP queue 1 item 2).
"""
from __future__ import annotations

from typing import Optional

import torch

# leaf key -> its KV-head axis (B leading; the port has no stacked periods)
_KV_AXIS = {
    # (B, n_pages, kv, ...): the pool, its quant scales, the page summaries
    "pool": 2, "pool_scale": 2, "summ": 2,
    # the centroid index, kv on axis 2 like summ (``core/centroid_index``)
    "cent": 2, "cent_mean": 2, "cent_assign": 2, "cent_count": 2,
    # (B, kv, n_sel, ...): the selection buffers
    "sel_k": 1, "sel_v": 1, "sel_idx": 1,
    # (B, T, kv, d): sink and window rings, the full cache, cross-attention
    "sink_k": 2, "sink_v": 2, "win_k": 2, "win_v": 2, "k": 2, "v": 2, "xk": 2, "xv": 2,
    # (B, kv, ...): ShadowKV's key factors, RaaS's kept pages
    "k_u": 1, "k_w": 1, "keep_k": 1, "keep_v": 1, "keep_idx": 1, "last_used": 1,
}
# leaf key -> its query-head axis
_HEAD_AXIS = {"qprev": 1}                         # (B, H, d)


def base_key(key: str) -> str:
    """A leaf's key without its shard prefix: ``"1/pool"`` -> ``"pool"``."""
    return key.rsplit("/", 1)[-1]


def tp_state_axis(key: str) -> Optional[int]:
    """The axis of retrieval-state leaf ``key`` that is split over the
    shards, or None for a leaf every shard holds whole."""
    key = base_key(key)
    return _KV_AXIS.get(key, _HEAD_AXIS.get(key))


def join_state(state: dict, tp: int, device="cpu") -> dict:
    """A layer's ``tp`` shards as one state in the unsharded layout, on
    ``device``: split leaves concatenated along ``tp_state_axis``, whole
    ones taken from shard 0."""
    out = {}
    for key in [k[2:] for k, t in state.items()
                if k.startswith("0/") and isinstance(t, torch.Tensor)]:
        parts = [state[f"{s}/{key}"].to(device) for s in range(tp)]
        axis = tp_state_axis(key)
        out[key] = parts[0] if axis is None else torch.cat(parts, dim=axis)
    return out
