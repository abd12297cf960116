"""The dry run: every arch x shape counted on the meta device, on the CPU, no
card needed (counterpart of the reference's ``repro/launch/dryrun.py``,
which lowers and compiles each case for a TPU mesh).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama31-8b --shape decode_32k

For each case the params (bf16), the AdamW state and the decode state are
built on meta, at full width and depth, and one train step, ``prefill`` or
``serve_step`` runs under ``launch/op_cost.analyze``. The Python loops run
every iteration (the Mamba and sLSTM prefills loop over time), so a case is
counted at 1 and at 2 periods of its layer pattern and extrapolated linearly
to ``n_periods``, as the reference's loop-aware analyzer multiplies the
layer scan's body (``hlo_cost.py:104-141``). One JSON record a case goes to
``artifacts/dryrun_torch/``; a case that does not fit one card is counted
and reported (``fits_80GB: false``), not skipped. The rates are the H100
data sheet's (``launch/roofline``), so every second in a record is computed,
not measured.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.configs.base import ArchConfig, FreeKVConfig, ShapeConfig
from repro_torch.core import paging
from repro_torch.kernels import ops
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.models.model import init_decode_state, init_params, prefill, serve_step
from repro_torch.training.optimizer import AdamWConfig, adamw_init, tree_leaves
from repro_torch.training.train_step import make_train_step

PARAM_DTYPE = torch.bfloat16
ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")
META = torch.device("meta")


def dryrun_fkv(page_size=32) -> FreeKVConfig:
    """The paper's long-generation serving configuration (Sec. 5.3), the
    reference's; the pool in pinned host memory, as the port serves it."""
    return FreeKVConfig(method="freekv", page_size=page_size, budget=2048,
                        n_sink=512, n_window=512, tau=0.9,
                        pool_pad_pages=512, offload="host")


def input_specs(cfg: ArchConfig, shape: ShapeConfig):
    """Meta stand-ins for every model input (no allocation)."""
    B, T = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        batch = {"tokens": torch.zeros((B, T), dtype=torch.long, device=META)}
        if cfg.frontend is not None:
            batch["frontend"] = torch.zeros((B, cfg.n_frontend_tokens, cfg.d_model),
                                            dtype=PARAM_DTYPE, device=META)
        return batch
    return {"tokens": torch.zeros((B, 1), dtype=torch.long, device=META)}


def _opt_cfg(cfg: ArchConfig) -> AdamWConfig:
    # bf16 optimizer state for >50B-param archs, as the reference
    big = cfg.param_counts()["total"] > 5e10
    return AdamWConfig(state_dtype="bfloat16" if big else "float32")


def _with_periods(cfg: ArchConfig, n: int) -> ArchConfig:
    return dataclasses.replace(
        cfg, n_layers=len(cfg.prelude) + len(cfg.pattern) * n, n_periods=n)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _state_bytes(state) -> tuple:
    """(device bytes, host-pool bytes) of a decode state."""
    host = sum(t.numel() * t.element_size() for _, t in tree_leaves(state)
               if isinstance(t, torch.Tensor) and t.is_meta and ops.is_host_pool(t, META))
    return paging.state_bytes(state) - host, host


def _build(cfg: ArchConfig, shape: ShapeConfig, fkv: FreeKVConfig):
    """(fn, args, memory) for one case on meta: the step to count, its
    arguments and the bytes of what it holds."""
    params = init_params(cfg, device=META, dtype=PARAM_DTYPE)
    batch = input_specs(cfg, shape)
    mem = {"param_bytes": _nbytes(params), "optimizer_bytes": 0, "device_state_bytes": 0,
           "host_pool_bytes": 0}
    if shape.mode == "train":
        opt_cfg = _opt_cfg(cfg)
        opt_state = adamw_init(params, opt_cfg)
        mem["optimizer_bytes"] = _nbytes(opt_state)
        return make_train_step(cfg, opt_cfg), (params, opt_state, batch), mem
    max_len = shape.seq_len + 64
    state = init_decode_state(cfg, fkv, shape.global_batch, max_len, PARAM_DTYPE, META)
    mem["device_state_bytes"], mem["host_pool_bytes"] = _state_bytes(state)
    if shape.mode == "prefill":
        # the prefill builds into the state's rows, as a slot's admission does
        def pf(p, b):
            return prefill(cfg, fkv, p, b, max_len=max_len, state_dtype=PARAM_DTYPE,
                           into=state["layers"])
        return pf, (params, batch), mem

    def step(p, s, b):
        return serve_step(cfg, fkv, p, s, b["tokens"])
    return step, (params, state, batch), mem


def _numbers(r) -> dict:
    """The extrapolable numbers of an ``op_cost.analyze`` result."""
    return {"flops": r["flops"], "bytes": r["bytes"], "link_bytes": r["link_bytes"],
            "aten_flops": r["aten_flops"], "aten_bytes": r["aten_bytes"],
            "peak_live_bytes": r["peak_live_bytes"],
            "kernels": {k: dict(v) for k, v in r["kernels"].items()},
            "per_op": {k: dict(v) for k, v in r["per_op"].items()}}


def count(cfg: ArchConfig, shape: ShapeConfig, fkv: FreeKVConfig) -> dict:
    """One case counted directly at ``cfg``'s own depth."""
    fn, args, _ = _build(cfg, shape, fkv)
    return _numbers(op_cost.analyze(fn, *args))


def _line(a, b, n):
    """The value at n periods on the line through a (1 period) and b (2)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a if isinstance(a, dict) else {}, b if isinstance(b, dict) else {}
        return {k: _line(a.get(k, 0), b.get(k, 0), n) for k in {**a, **b}}
    return a + (n - 1) * (b - a)


def extrapolated(cfg: ArchConfig, shape: ShapeConfig, fkv: FreeKVConfig) -> dict:
    """The counts at ``cfg.n_periods`` from counts at 1 and 2 periods (a
    stack of one period is counted directly)."""
    one = count(_with_periods(cfg, 1), shape, fkv)
    if cfg.n_periods == 1:
        return one
    two = count(_with_periods(cfg, 2), shape, fkv)
    return _line(one, two, cfg.n_periods)


def lower_case(arch, shape) -> dict:
    """One case -> its record (the reference's fields on one card).
    ``shape`` is a name of ``SHAPES`` or a ``ShapeConfig``."""
    cfg = get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    fkv = dryrun_fkv()
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": "1", "n_devices": 1,
           "mode": shape.mode, "periods_counted": [1] if cfg.n_periods == 1 else [1, 2],
           "n_periods": cfg.n_periods}
    t0 = time.time()
    _, _, mem = _build(cfg, shape, fkv)
    c = extrapolated(cfg, shape, fkv)
    rec["count_s"] = round(time.time() - t0, 1)
    held = mem["param_bytes"] + mem["optimizer_bytes"] + mem["device_state_bytes"]
    per_dev = held + c["peak_live_bytes"]
    rec["memory"] = {**mem, "peak_live_bytes_estimate": c["peak_live_bytes"],
                     "per_device_total_estimate": per_dev,
                     "fits_80GB": bool(per_dev < rl.CARD_BYTES)}
    rec["cost"] = {"flops_per_device": c["flops"], "bytes_accessed_per_device": c["bytes"],
                   "link_bytes_per_device": c["link_bytes"], "collective_bytes_per_device": 0,
                   "aten_flops": c["aten_flops"], "aten_bytes": c["aten_bytes"]}
    mem_bytes = c["bytes"]
    if shape.mode == "decode":
        # decode's memory term: analytic, as the reference's
        mem_bytes = rl.analytic_decode_bytes(cfg, fkv, shape, {"data": 1, "model": 1})
        rec["cost"]["bytes_analytic"] = mem_bytes
        rec["cost"]["bytes_analytic_parts"] = rl.decode_byte_parts(
            cfg, fkv, shape, {"data": 1, "model": 1})
    terms = rl.roofline_terms(c["flops"], mem_bytes, 0.0)
    n_tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    mf = rl.model_flops(cfg, shape, n_tokens)
    rec["roofline"] = {
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "bound_s": terms.bound_s, "model_flops_total": mf, "counted_flops_total": c["flops"],
        "useful_flops_ratio": mf / c["flops"] if c["flops"] else 0.0,
        "kernels": c["kernels"],
        "top_ops": [{"name": n, **d} for n, d in op_cost.top_ops(c, "flops", 6)],
        "rates": {"peak_bf16": rl.PEAK_BF16, "hbm_bps": rl.HBM_BPS, "pcie_bps": rl.PCIE_BPS,
                  "source": "H100 SXM data sheet, not measured"}}
    return rec


def run(archs, shapes, out_dir=ARTIFACT_DIR, skip_existing=True):
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}"
            path = os.path.join(out_dir, tag + ".json")
            if skip_existing and os.path.exists(path):
                print(f"[skip] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rec = lower_case(arch, shape)
                rec["status"] = "ok"
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {"arch": arch, "shape": shape, "mesh": "1", "status": "error",
                       "error": repr(e), "traceback": traceback.format_exc()[-4000:]}
                print(f"  ERROR: {e!r}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                r = rec["roofline"]
                print(f"  ok count={rec['count_s']}s "
                      f"mem/dev={rec['memory']['per_device_total_estimate'] / 1e9:.2f}GB "
                      f"dominant={r['dominant']} bound={r['bound_s']:.4g}s "
                      f"useful={r['useful_flops_ratio']:.3f}", flush=True)
            results.append(rec)
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    archs = list(ASSIGNED) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    t0 = time.time()
    run(archs, shapes, skip_existing=not args.force)
    print(f"dry run: {len(archs) * len(shapes)} cases in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
