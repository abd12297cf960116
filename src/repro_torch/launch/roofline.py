"""The cost model on one NVIDIA H100 (counterpart of the reference's
``repro/launch/roofline.py``):

    compute term    = FLOPs             / PEAK_BF16
    memory term     = HBM bytes         / HBM_BPS
    collective term = collective bytes  / NVLINK_BPS   (0 on one card)

The byte and FLOP counts are the reference's (``analytic_decode_bytes``,
``model_flops``), exactly; only the rates are the card's. The reference's
HLO collective parsers have no counterpart: torch produces no HLO, and the
collective term waits for tensor parallelism.

``kernel_bound`` turns the cost of one launch (``kernels/cost.py``) or of
any other piece of work into its bound at these rates.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM5 80GB data sheet
PEAK_BF16 = 989e12       # FLOP/s, dense bf16 on the tensor cores (no sparsity)
PEAK_F32 = 67e12         # FLOP/s, float32 outside the tensor cores (TF32 off)
HBM_BPS = 3.35e12        # B/s, HBM3
PCIE_BPS = 64e9          # B/s, PCIe Gen5 x16 a direction: the pinned host pool
NVLINK_BPS = 450e9       # B/s a direction (900 GB/s both ways), NVLink 4: the
#                          collective term, first used by tensor parallelism
CARD_BYTES = 80e9        # device memory


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> Roofline:
    return Roofline(compute_s=flops_per_dev / PEAK_BF16,
                    memory_s=bytes_per_dev / HBM_BPS,
                    collective_s=coll_bytes_per_dev / NVLINK_BPS)


# ---------------------------------------------------------------------------
# one decode step, analytically (the reference's napkin model)
# ---------------------------------------------------------------------------
def decode_byte_parts(cfg, fkv, shape, mesh_shape=None) -> dict:
    """The summands of ``analytic_decode_bytes`` by name, per device:
    ``weights`` (the active parameters' model-axis shard, bf16),
    ``attention`` (sink + window + the selected pages of every KV head, and
    the local layers' windows), ``pool`` (one page appended and the selected
    pages recalled, a layer: the bytes that cross PCIe when the pool is in
    pinned host memory), ``summaries`` (the page summaries scanned for the
    selection) and ``state`` (the recurrent layers' state, read and
    written). Their sum, in this order, is ``analytic_decode_bytes``."""
    axes = dict(mesh_shape or {"data": 1, "model": 1})
    mp = axes.get("model", 1)
    nb = axes.get("data", 1) * axes.get("pod", 1)
    B = shape.global_batch
    B_loc = max(1, B // nb) if B % nb == 0 else B
    it = 2  # bf16
    pc = cfg.param_counts()
    # weights: each device reads its model-axis shard once per step
    w_bytes = pc["active"] * it / mp
    n_attn = sum(1 for m, _ in cfg.layers if m == "attn")
    n_local = sum(1 for m, _ in cfg.layers if m == "attn_local")
    kv, d, p = cfg.n_kv_heads, cfg.d_head, fkv.page_size
    n_sel = max(0, (fkv.budget - fkv.n_sink - fkv.n_window) // p)
    resident = fkv.n_sink + fkv.n_window + p + n_sel * p
    kv_term = B_loc * kv * resident * d * 2 * it
    # kv-head or page sharding splits the budget attention over 'model'
    if cfg.n_kv_heads % mp == 0 or fkv.sharded_retrieval:
        kv_term /= mp
    attn_bytes = kv_term * n_attn
    attn_bytes += (B_loc * kv * min(cfg.sliding_window, 10 ** 9) * d * 2 * it
                   ) * n_local
    # pool append (1 page w) + recall (n_sel pages r) + summaries scan
    n_pages_ctx = shape.seq_len // p
    pool_bytes = B_loc * kv * 2 * p * d * it * (1 + n_sel) * n_attn
    summ_bytes = B_loc * kv * n_pages_ctx * 2 * d * it * n_attn
    if cfg.n_kv_heads % mp == 0 or fkv.sharded_retrieval or B % nb != 0:
        pool_bytes /= mp
        summ_bytes /= mp
    # recurrent states (mamba / xlstm): read + write
    st = 0.0
    for m, _ in cfg.layers:
        if m == "mamba":
            di = cfg.ssm_expand * cfg.d_model
            st += 2 * B_loc * di * cfg.ssm_d_state * 4 / mp
        elif m in ("mlstm", "slstm"):
            di = int(cfg.xlstm_proj_factor * cfg.d_model)
            dqk = int(cfg.xlstm_qk_dim_factor * di)
            st += 2 * B_loc * dqk * (di // max(cfg.n_heads, 1)) * 4
    return {"weights": w_bytes, "attention": attn_bytes, "pool": pool_bytes,
            "summaries": summ_bytes, "state": st}


def analytic_decode_bytes(cfg, fkv, shape, mesh_shape=None) -> float:
    """Per-device HBM bytes of one decode step: weight reads + budget-KV
    reads (per KV head) + page append + recall reads + the summaries' scan
    + recurrent-state read/write (reference ``roofline.py:99``); the decode
    memory term. ``mesh_shape`` (default one device) keeps the counts exact
    at any mesh."""
    p = decode_byte_parts(cfg, fkv, shape, mesh_shape)
    return p["weights"] + p["attention"] + p["pool"] + p["summaries"] + p["state"]


def decode_step_bound_s(parts: dict, pool_link: bool = False) -> float:
    """Seconds one decode step takes at least: every part of
    ``decode_byte_parts`` over HBM, or with ``pool_link`` the pool part over
    PCIe (a pinned host pool) beside the rest over HBM, the slower of the
    two (the link and HBM move in parallel)."""
    on_card = sum(v for k, v in parts.items() if not (pool_link and k == "pool"))
    link = parts["pool"] if pool_link else 0.0
    return max(on_card / HBM_BPS, link / PCIE_BPS)


def model_flops(cfg, shape, n_tokens: int) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for training, 2
    N_active a generated or prefilled token (forward only)."""
    n_active = cfg.param_counts()["active"]
    if shape.mode == "train":
        return 6.0 * n_active * n_tokens
    return 2.0 * n_active * n_tokens


def kernel_bound(cost: dict) -> dict:
    """The bound of one kernel launch (``kernels/cost.py``) or of any other
    work from its cost: the slower of its bytes, the HBM bytes over HBM_BPS
    beside the link bytes over PCIE_BPS, and its operations, ``flops`` over
    PEAK_BF16 plus ``flops_f32`` (products outside the tensor cores) over
    PEAK_F32. A key left out counts 0 -> {"bound_bytes", "bound_ops",
    "bound_ms", "bound_by"}, and "bound_ops_f32" where ``flops_f32`` is
    given."""
    hbm, link = cost.get("hbm_bytes", 0), cost.get("link_bytes", 0)
    flops, flops_f32 = cost.get("flops", 0), cost.get("flops_f32", 0)
    t_bytes = max(link / PCIE_BPS, hbm / HBM_BPS)
    t_ops = flops / PEAK_BF16 + flops_f32 / PEAK_F32
    out = {"bound_bytes": hbm + link, "bound_ops": flops, "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if "flops_f32" in cost:
        out["bound_ops_f32"] = flops_f32
    return out
