"""The port's cost model (``repro_torch.launch.roofline``,
``repro_torch.kernels.cost``, ``op_cost`` and ``dryrun``) on the CPU:

* the configs' ``SHAPES``, ``ASSIGNED``, ``PAPER_MODELS`` and
  ``param_counts()`` exactly equal to the reference's for every registered
  arch and its ``-smoke`` form; ``analytic_decode_bytes`` and
  ``model_flops`` at ``dryrun_fkv()`` exactly equal on every arch x shape,
  at mesh {"data": 1, "model": 1} and {"data": 16, "model": 16}, and
  ``decode_byte_parts`` summing exactly to ``analytic_decode_bytes``;
* ``op_cost.analyze`` on the reference test's own case
  (``tests/test_sharding.py:92``): seven tanh(c @ w) count 7 * 2 * 64 *
  128 * 128 FLOPs within 1%, their gradient 3x within 5%, and a product's
  bytes are its operands' plus its result's, on the CPU and on meta;
* a smoke ``serve_step`` and ``prefill`` counted on meta launch the
  kernels the card's branch launches (freekv/none, freekv/int8, quest,
  centroid): the count a layer, equal to the wrapper calls of the same step
  on the CPU, and each kernel's counted bytes equal to its
  ``kernels/cost`` formula at the step's shapes, a slot's view of a host
  pool read over the link as the whole pool is;
* the dry run's 1- and 2-period extrapolation equal to a direct 3-period
  count for one smoke arch of each family, in every mode;
* ``dryrun.lower_case`` on smoke configs at a small shape of each mode;
* ``EngineMetrics.dequant_overhead_s``."""
import dataclasses

import pytest
import torch

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import PAPER_MODELS as J_PAPER_MODELS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs.base import FreeKVConfig as JFreeKVConfig
from repro.launch import roofline as jroofline
from repro_torch.configs import ASSIGNED, PAPER_MODELS, SHAPES, get_config, list_archs
from repro_torch.configs.base import FreeKVConfig, ShapeConfig
from repro_torch.core import offload
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import roofline as rl
from repro_torch.models import model
from repro_torch.serving.metrics import EngineMetrics

ARCHS = list_archs() + [a + "-smoke" for a in list_archs()]
MESHES = ({"data": 1, "model": 1}, {"data": 16, "model": 16})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test (the steps are many small ops; see
    ``tests/test_torch_ssm.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jdryrun_fkv():
    # the reference's ``dryrun_fkv()`` (``repro/launch/dryrun.py:33``); that
    # module forces 512 XLA host devices when imported, so it is not
    return JFreeKVConfig(method="freekv", page_size=32, budget=2048, n_sink=512, n_window=512,
                         tau=0.9, pool_pad_pages=512)


def test_shapes_and_arch_pools_equal_the_reference():
    assert sorted(list_archs()) == sorted(jlist_archs())
    assert ASSIGNED == J_ASSIGNED and PAPER_MODELS == J_PAPER_MODELS
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(J_SHAPES[name])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_counts() == jcfg.param_counts()
    assert (cfg.uses_attention, cfg.uses_moe) == (jcfg.uses_attention, jcfg.uses_moe)
    s, js = SHAPES[shape], J_SHAPES[shape]
    fkv, jfkv = dryrun.dryrun_fkv(), _jdryrun_fkv()
    for n_tokens in (1, s.global_batch * s.seq_len):
        assert rl.model_flops(cfg, s, n_tokens) == jroofline.model_flops(jcfg, js, n_tokens)
    for mesh in MESHES:
        want = jroofline.analytic_decode_bytes(jcfg, jfkv, js, dict(mesh))
        assert rl.analytic_decode_bytes(cfg, fkv, s, dict(mesh)) == want
        parts = rl.decode_byte_parts(cfg, fkv, s, dict(mesh))
        assert list(parts) == ["weights", "attention", "pool", "summaries", "state"]
        total = 0.0
        for v in parts.values():
            total += v
        assert total == want


def test_roofline_terms_use_the_card_rates():
    t = rl.roofline_terms(989e12, 3.35e12, 0.0)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 0.0)
    assert rl.roofline_terms(1.0, 2 * 3.35e12, 0.0).dominant == "memory"
    parts = {"weights": 3.35e12, "attention": 0.0, "pool": 64e9 * 2, "summaries": 0.0,
             "state": 0.0}
    assert rl.decode_step_bound_s(parts) == (3.35e12 + 128e9) / 3.35e12
    assert rl.decode_step_bound_s(parts, pool_link=True) == 2.0


def test_kernel_bound_takes_the_slowest_term():
    b = rl.kernel_bound({"hbm_bytes": 3.35e12, "link_bytes": 64e9 * 2})
    assert (b["bound_ms"], b["bound_by"], b["bound_bytes"]) == (2000.0, "bytes", 3.35e12 + 128e9)
    assert "bound_ops_f32" not in b
    # bf16 products on the tensor cores and float32 ones outside them add up
    b = rl.kernel_bound({"hbm_bytes": 3.35e12, "flops": 989e12, "flops_f32": 67e12})
    assert (b["bound_ms"], b["bound_by"]) == (2000.0, "operations")
    assert (b["bound_ops"], b["bound_ops_f32"]) == (989e12, 67e12)


# ---------------------------------------------------------------------------
# op_cost on the reference test's case
# ---------------------------------------------------------------------------
def _scan(x, w):
    c = x
    for _ in range(7):
        c = torch.tanh(c @ w)
    return c.sum()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_op_cost_counts_the_products(device):
    x, w = torch.ones(64, 128, device=device), torch.ones(128, 128, device=device)
    expected = 7 * 2 * 64 * 128 * 128
    r = op_cost.analyze(_scan, x, w)
    assert abs(r["flops"] - expected) / expected < 0.01
    assert op_cost.top_ops(r, "flops", 1)[0][0] == "mm"
    w.requires_grad_(True)
    r2 = op_cost.analyze(lambda x, w: torch.autograd.grad(_scan(x, w), w)[0], x, w)
    assert abs(r2["flops"] - 3 * expected) / (3 * expected) < 0.05
    r3 = op_cost.analyze(torch.mm, x, w.detach())
    assert r3["bytes"] == (64 * 128 + 128 * 128 + 64 * 128) * 4
    assert r3["flops"] == 2 * 64 * 128 * 128 and r3["kernels"] == {}


# ---------------------------------------------------------------------------
# the card's kernel launches, counted on meta
# ---------------------------------------------------------------------------
SMOKE = "llama31-8b-smoke"
B, T = 2, 96
# one decode step's launches a layer on the card, per method (the gathers:
# FreeKV's top-up and staged recall; Quest's one blocking recall of its
# per-head pages; Centroid's candidates then the exact scan over them)
STEP = {
    ("freekv", "none"): {"paged_attention": 1, "select_pages": 1, "recall_gather": 2,
                         "complete_page": 1},
    ("freekv", "int8"): {"paged_attention": 1, "select_pages": 1, "recall_gather_quant": 2,
                         "complete_page": 1},
    ("quest", "none"): {"paged_attention": 1, "select_pages": 1, "recall_gather": 1,
                        "complete_page": 1},
    ("centroid", "none"): {"paged_attention": 1, "select_pages": 2, "centroid_candidates": 1,
                           "recall_gather": 2, "complete_page": 1},
}


def _fkv(method, kv_quant):
    return FreeKVConfig(method=method, kv_quant=kv_quant, page_size=8, budget=64, n_sink=8,
                        n_window=8, offload="host", centroid_count=4)


def _two_layers():
    cfg = get_config(SMOKE)
    return dataclasses.replace(cfg, n_layers=2, n_periods=2)


def _step_inputs(cfg, fkv, device):
    params = model.init_params(cfg, seed=0, device=device)
    tokens = torch.arange(B * T, device=device).reshape(B, T) % cfg.vocab_size
    return params, {"tokens": tokens}


class _Spy:
    """Counts the wrapper calls of ``ops`` (their CPU branch runs)."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for fn in ops.KERNELS:
            monkeypatch.setattr(ops, fn.__name__, self._wrap(fn))

    def _wrap(self, fn):
        def call(*a, **k):
            self.calls[fn.__name__] = self.calls.get(fn.__name__, 0) + 1
            return fn(*a, **k)
        return call


@pytest.fixture(scope="module")
def meta_counts():
    """prefill and one serve_step of each method counted on meta."""
    cfg = _two_layers()
    out = {}
    for key in STEP:
        fkv = _fkv(*key)
        params, batch = _step_inputs(cfg, fkv, "meta")
        pre = op_cost.analyze(model.prefill, cfg, fkv, params, batch, max_len=T + 16)
        _, state = pre["out"]
        step = op_cost.analyze(model.serve_step, cfg, fkv, params, state,
                               torch.zeros((B, 1), dtype=torch.long, device="meta"))
        out[key] = (pre, step, state)
    return cfg, out


@pytest.mark.parametrize("key", list(STEP), ids=lambda k: "/".join(k))
def test_meta_step_launches_the_card_kernels(key, meta_counts, monkeypatch):
    cfg, counts = meta_counts
    pre, step, _ = counts[key]
    launches = {k: v["launches"] for k, v in step["kernels"].items()}
    assert launches == {k: n * cfg.n_layers for k, n in STEP[key].items()}
    first = "recall_gather_quant" if key[1] == "int8" else "recall_gather"
    assert {k: v["launches"] for k, v in pre["kernels"].items()} == {
        "flash_prefill": cfg.n_layers, "fill_pages": cfg.n_layers,
        "select_pages": cfg.n_layers, first: cfg.n_layers}
    # the same step on the CPU calls the same wrappers as often (prefill
    # attention is the one branch that differs: the CPU keeps the
    # reference's attention_auto)
    spy = _Spy(monkeypatch)
    fkv = _fkv(*key)
    params, batch = _step_inputs(cfg, fkv, "cpu")
    _, state = model.prefill(cfg, fkv, params, batch, max_len=T + 16)
    assert spy.calls == {k: v["launches"] for k, v in pre["kernels"].items()
                         if k != "flash_prefill"}
    spy.calls.clear()
    model.serve_step(cfg, fkv, params, state, torch.zeros((B, 1), dtype=torch.long))
    assert spy.calls == launches
    assert all(fn.launches == 0 for fn in ops.KERNELS)


def _expected_step_costs(cfg, fkv, state):
    """Each kernel's ``kernels/cost`` cost at the decode step's shapes: float32
    queries (the params' dtype; a kernel takes its inputs at one dtype, so
    the bf16 state's pages and summaries go in as float32 too), a bf16 state
    and pool."""
    st = state["layers"][0]
    kv, d, p, G = cfg.n_kv_heads, cfg.d_head, fkv.page_size, cfg.group_size
    n_pages, n_sel = st["summ"].shape[1], st["sel_idx"].shape[2]
    L = st["sink_k"].shape[1] + st["win_k"].shape[1] + n_sel * p
    it, st_it = 4, st["win_k"].element_size()
    if fkv.method == "quest":       # a row per query head: G * n_sel pages a KV head
        return {"paged_attention": kcost.paged_attention(B, kv * G, 1, L // p, p, d, it),
                "select_pages": kcost.select_pages(B, kv, G, n_pages, d, n_sel, it,
                                                   per_head=True),
                "recall_gather": kcost.recall_gather(B, kv, G * n_sel, p, d, st_it, host=False),
                "complete_page": kcost.complete_page(B, p, kv, d, st_it, host=False)}
    costs = {"paged_attention": kcost.paged_attention(B, kv, G, L // p, p, d, it),
             "select_pages": kcost.select_pages(B, kv, G, n_pages, d, n_sel, it)}
    if fkv.kv_quant == "int8":
        costs["recall_gather_quant"] = kcost.recall_gather_quant(B, kv, n_sel, p, d, 8, 1, st_it)
        costs["complete_page"] = kcost.complete_page(B, p, kv, d, st_it, bits=8, n_g=1)
    else:
        costs["recall_gather"] = kcost.recall_gather(B, kv, n_sel, p, d, st_it)
        costs["complete_page"] = kcost.complete_page(B, p, kv, d, st_it)
    return costs


@pytest.mark.parametrize("key", [k for k in STEP if k[0] != "centroid"],
                         ids=lambda k: "/".join(k))
def test_meta_kernel_bytes_are_the_roofline_formulas(key, meta_counts):
    cfg, counts = meta_counts
    pre, step, state = counts[key]
    fkv = _fkv(*key)
    for name, c in _expected_step_costs(cfg, fkv, state).items():
        k = step["kernels"][name]
        n = k["launches"]
        assert (k["bytes"], k["link_bytes"], k["flops"]) == (
            n * c["hbm_bytes"], n * c["link_bytes"], n * c["flops"]), name
    kv, d, p, H = cfg.n_kv_heads, cfg.d_head, fkv.page_size, cfg.n_heads
    fp = kcost.flash_prefill(B, H, kv, T, T, d, 4)
    assert pre["kernels"]["flash_prefill"]["flops"] == cfg.n_layers * fp["flops"]
    assert pre["kernels"]["flash_prefill"]["bytes"] == cfg.n_layers * fp["hbm_bytes"]
    bits = 8 if key[1] == "int8" else 0
    fill = kcost.fill_pages(B, T // p, p, kv, d, 4, 2, bits=bits, n_g=1 if bits else 0)
    assert pre["kernels"]["fill_pages"]["bytes"] == cfg.n_layers * fill["hbm_bytes"]
    assert step["bytes"] == step["aten_bytes"] + sum(k["bytes"] for k in step["kernels"].values())
    assert step["flops"] == step["aten_flops"] + sum(k["flops"] for k in step["kernels"].values())


@pytest.mark.parametrize("draft_len", [0, 2])
def test_meta_decode_window_launches_each_step(draft_len):
    """A decode window on meta polls no flag (nothing to read) and runs every
    step: a greedy window of 3 steps launches 3 steps' kernels; a
    speculative one 3 iterations of 1 + draft_len rows each, plus one
    rollback recall_gather a layer an iteration."""
    from repro_torch.serving.sampling import SamplerConfig
    cfg = get_config(SMOKE)
    fkv = dataclasses.replace(_fkv("freekv", "none"), draft_len=draft_len)
    m = "meta"
    params = model.init_params(cfg, device=m)
    state = model.init_decode_state(cfg, fkv, B, 128, torch.float32, m)
    lane = dict(dtype=torch.int32, device=m)
    loop = {"cur": torch.zeros(B, **lane), "key": torch.zeros((B, 2), dtype=torch.long, device=m),
            "count": torch.zeros(B, **lane), "limit": torch.full((B,), 9, **lane),
            "eos": torch.full((B,), -1, **lane), "fin": torch.zeros(B, dtype=torch.bool, device=m)}
    if draft_len:
        r = op_cost.analyze(model.decode_window_spec, cfg, fkv, params, state, loop,
                            SamplerConfig(), 3)
    else:
        r = op_cost.analyze(model.decode_window, cfg, fkv, params, state, loop, SamplerConfig(),
                            3, read_finishes=True)
    rows = 3 * (1 + draft_len)
    assert r["out"][2].shape[0] == 3
    assert {k: v["launches"] for k, v in r["kernels"].items()} == {
        "paged_attention": rows, "select_pages": rows, "complete_page": rows,
        "recall_gather": 2 * rows + (3 if draft_len else 0)}


def test_meta_pool_stands_for_the_host_pool():
    cfg = get_config(SMOKE)
    state = model.init_decode_state(cfg, _fkv("freekv", "none"), 1, 64, torch.float32, "meta")
    layer = state["layers"][0]
    assert ops.is_host_pool(layer["pool"], torch.device("meta"))
    assert not ops.is_host_pool(layer["summ"], torch.device("meta"))
    # the dry run's host bytes are the pools' and nothing else (the CPU
    # mirror of the positions is no pool)
    pools = [t for lay in state["layers"] for k, t in lay.items() if k in ("pool", "pool_scale")]
    assert dryrun._state_bytes(state)[1] == sum(t.numel() * t.element_size() for t in pools)
    sim = model.init_decode_state(cfg, FreeKVConfig(page_size=8, budget=64, n_sink=8,
                                                    n_window=8), 1, 64, torch.float32, "meta")
    assert not ops.is_host_pool(sim["layers"][0]["pool"], torch.device("meta"))


@pytest.mark.parametrize("offload_to", ["host", "sim"])
def test_a_view_of_the_pool_keeps_its_place(offload_to):
    """A slot's view of the meta pool (``pool[b:b + 1]``) is read over the
    link exactly when the whole pool would be."""
    meta = torch.device("meta")
    fkv = FreeKVConfig(page_size=8, budget=64, n_sink=8, n_window=8, offload=offload_to)
    pool = offload.alloc_pool((3, 16, 2, 2, 8, 32), torch.bfloat16, fkv, meta)
    view = pool[1:2]
    assert ops.is_host_pool(view, meta) == ops.is_host_pool(pool, meta) == (offload_to == "host")
    idx = torch.zeros((1, 2, 4), dtype=torch.int32, device=meta)
    r = op_cost.analyze(ops.recall_gather, view, idx)
    want = kcost.recall_gather(1, 2, 4, 8, 32, 2, host=offload_to == "host")
    got = r["kernels"]["recall_gather"]
    assert (got["bytes"], got["link_bytes"]) == (want["hbm_bytes"], want["link_bytes"])
    assert (got["link_bytes"] > 0) == (offload_to == "host")


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
FAMILIES = ("llama31-8b-smoke", "deepseek-moe-16b-smoke", "jamba-1.5-large-398b-smoke",
            "xlstm-350m-smoke", "whisper-tiny-smoke")
SMALL = {"train": ShapeConfig("train_s", 32, 2, "train"),
         "prefill": ShapeConfig("prefill_s", 64, 2, "prefill"),
         "decode": ShapeConfig("decode_s", 64, 2, "decode")}
_LINEAR = ("flops", "bytes", "link_bytes", "aten_flops", "aten_bytes", "kernels", "per_op")


@pytest.mark.parametrize("mode", list(SMALL))
@pytest.mark.parametrize("arch", FAMILIES)
def test_extrapolation_equals_a_direct_count(arch, mode):
    cfg = get_config(arch)
    fkv = FreeKVConfig(page_size=8, budget=48, n_sink=8, n_window=8, offload="host")
    got = dryrun.extrapolated(dryrun._with_periods(cfg, 3), SMALL[mode], fkv)
    want = dryrun.count(dryrun._with_periods(cfg, 3), SMALL[mode], fkv)
    assert {k: got[k] for k in _LINEAR} == {k: want[k] for k in _LINEAR}
    assert got["flops"] > 0 and got["bytes"] > 0


@pytest.mark.parametrize("mode", list(SMALL))
def test_lower_case_writes_the_record(mode, tmp_path):
    shape = dataclasses.replace(SMALL[mode], seq_len=640)   # past dryrun_fkv's sink + window
    rec = dryrun.lower_case(SMOKE, shape)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_devices"], rec["mode"]) == (
        SMOKE, shape.name, "1", 1, mode)
    for key in ("param_bytes", "optimizer_bytes", "device_state_bytes", "host_pool_bytes",
                "peak_live_bytes_estimate", "per_device_total_estimate", "fits_80GB"):
        assert key in rec["memory"]
    assert rec["memory"]["fits_80GB"] is True
    assert (rec["memory"]["optimizer_bytes"] > 0) == (mode == "train")
    assert (rec["memory"]["host_pool_bytes"] > 0) == (mode != "train")
    for key in ("flops_per_device", "bytes_accessed_per_device", "collective_bytes_per_device"):
        assert key in rec["cost"]
    assert rec["cost"]["collective_bytes_per_device"] == 0
    assert ("bytes_analytic" in rec["cost"]) == (mode == "decode")
    r = rec["roofline"]
    assert r["dominant"] in ("compute", "memory") and r["bound_s"] > 0
    assert r["model_flops_total"] > 0 and 0 < r["useful_flops_ratio"]
    assert r["top_ops"] and r["rates"]["hbm_bps"] == rl.HBM_BPS
    if mode != "train":
        assert r["kernels"]
    out = tmp_path / "dry"
    res = dryrun.run([SMOKE], [], out_dir=str(out))
    assert res == [] and out.is_dir()


# ---------------------------------------------------------------------------
# the dequantization estimate
# ---------------------------------------------------------------------------
def test_dequant_overhead_s():
    from repro_torch.quant.accounting import DEQUANT_ELEMS_PER_S
    em = EngineMetrics(kv_quant="none", dequant_elems_per_block=2 * 32 * 128)
    em.sync_pages += 10
    assert em.dequant_overhead_s == 0.0
    assert em.summary()["kv_quant"]["dequant_overhead_s"] == 0.0
    em = EngineMetrics(kv_quant="int8", dequant_elems_per_block=2 * 32 * 128)
    em.sync_pages += 10
    em.async_pages += 30
    assert em.dequant_overhead_s == 40 * 2 * 32 * 128 / DEQUANT_ELEMS_PER_S
    assert em.summary()["kv_quant"]["dequant_overhead_s"] == em.dequant_overhead_s
    # the rate is the card's recall_gather_quant int8 row from a device pool
    # (no PCIe time in it): its elements over 0.01749824 ms
    assert DEQUANT_ELEMS_PER_S == 4 * 8 * 56 * 2 * 32 * 128 / 0.01749824e-3
