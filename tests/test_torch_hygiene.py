"""Package rules of the PyTorch port: it imports neither ``jax`` nor the JAX
package ``repro``; its entry points default to the card and raise without
one; and a CUDA request never falls back to the plain kernel versions."""
import ast
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.configs.base import FreeKVConfig
from repro_torch.kernels import build, ops

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists()
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from repro_torch.core.retrieval import make_retriever
    from repro_torch.models import model
    from repro_torch.serving.engine import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(page_size=8, budget=64, n_sink=8, n_window=8)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_decode_state(cfg, fkv, 1, 64)
    with pytest.raises(RuntimeError, match="cuda"):
        make_retriever(cfg, fkv).init_state(1, 64)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, fkv, {}, max_len=64, batch_size=1, scheduler="static")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, fkv, {}, max_len=64, batch_size=1)
    from repro_torch.serving.kv_slots import SlotPool
    with pytest.raises(RuntimeError, match="cuda"):
        SlotPool(cfg, fkv, 2, 64)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "granite-3-8b-smoke", "--scheduler", "static"])
    from repro_torch.launch.mesh import make_tp_mesh
    with pytest.raises(RuntimeError, match="cuda"):
        make_tp_mesh(2)
    with pytest.raises(RuntimeError, match="cuda"):
        make_tp_mesh(2, ("cuda:0", "cuda:0"))
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, fkv, {}, max_len=64, batch_size=1, tp=2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "granite-3-8b-smoke", "--tp", "2"])
    from repro_torch.launch import train
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import init_train
    with pytest.raises(RuntimeError, match="cuda"):
        init_train(get_config("smollm-360m-smoke"), AdamWConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "smollm-360m-smoke", "--steps", "1"])
    from repro_torch.launch.mesh import make_host_mesh
    for mp in (1, 2):
        with pytest.raises(RuntimeError, match="cuda"):
            make_host_mesh(mp)
    with pytest.raises(RuntimeError, match="cuda"):
        make_host_mesh(2, ("cuda:0", "cuda:0"))
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "smollm-360m-smoke", "--steps", "1", "--model-parallel", "2"])


def test_tp_mesh_never_shares_a_card_unasked(monkeypatch):
    """With fewer cards than tp, the default mesh (and so ``ServeEngine(tp)``
    and ``serve --tp``) raises: two shards share one card only where the
    devices are named."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.serving.engine import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = get_config("granite-3-8b-smoke")
    fkv = FreeKVConfig(page_size=8, budget=64, n_sink=8, n_window=8)
    for tp in (2, 4):
        with pytest.raises(RuntimeError, match=f"tp={tp} needs {tp} cuda devices"):
            make_tp_mesh(tp)
    with pytest.raises(RuntimeError, match="tp=2 needs 2 cuda devices"):
        ServeEngine(cfg, fkv, {}, max_len=64, batch_size=1, tp=2)
    with pytest.raises(RuntimeError, match="cuda:1 requested"):
        make_tp_mesh(2, ("cuda:0", "cuda:1"))
    with pytest.raises(RuntimeError, match="tp=2 needs 2 cuda devices"):
        serve.main(["--arch", "granite-3-8b-smoke", "--device", "cpu", "--tp", "2"])
    mesh = make_tp_mesh(2, ("cuda:0", "cuda:0"))
    assert mesh.devices == (torch.device("cuda", 0),) * 2 and mesh.shape == {"model": 2}
    assert make_tp_mesh(2, ("cpu", "cpu")).axis_names == ("model",)


def test_host_mesh_never_shares_a_card_unasked(monkeypatch):
    """``make_host_mesh`` (and so ``train --model-parallel``) takes every card
    and raises when their count does not divide by the model axis; shards
    share a card only where the devices are named."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for mp in (2, 4):
        with pytest.raises(RuntimeError, match=f"model_parallel={mp} needs {mp} devices"):
            make_host_mesh(mp)
    with pytest.raises(RuntimeError, match="model_parallel=2 needs 2 devices"):
        train.main(["--arch", "smollm-360m-smoke", "--device", "cpu", "--model-parallel", "2"])
    with pytest.raises(RuntimeError, match="cuda:1 requested"):
        make_host_mesh(2, ("cuda:0", "cuda:1"))
    mesh = make_host_mesh(2, ("cuda:0",) * 4)
    assert mesh.dims == (2, 2) and mesh.devices == ((torch.device("cuda", 0),) * 2,) * 2
    assert make_host_mesh(1).dims == (1, 1)
    # with two cards the mesh takes them, but a --device cpu run never does
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_host_mesh(2).devices == ((torch.device("cuda", 0), torch.device("cuda", 1)),)
    with pytest.raises(RuntimeError, match="model_parallel=2 needs 2 devices, --device cpu"):
        train.main(["--arch", "smollm-360m-smoke", "--device", "cpu", "--model-parallel", "2"])
    with pytest.raises(ValueError, match="first device cuda:0 is not --device cpu"):
        train.main(["--arch", "smollm-360m-smoke", "--device", "cpu", "--model-parallel", "2",
                    "--mesh-devices", "cuda:0,cuda:1"])


def test_cuda_request_without_built_library_raises(monkeypatch):
    """A tensor treated as a CUDA tensor with no compiler and no library
    raises; the plain version is never taken in its place."""
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", Path("/nonexistent-freekv-build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    q = torch.randn(1, 1, 2, 16)
    kp = torch.randn(1, 1, 2, 8, 16)
    pos = torch.arange(16, dtype=torch.int32).reshape(1, 1, 2, 8)
    cur = torch.tensor([15], dtype=torch.int32)
    calls = [
        lambda: ops.paged_attention(q, kp, kp, pos, cur, scale=0.25),
        lambda: ops.page_scores(q, torch.randn(1, 3, 1, 2, 16), scale=0.25),
        lambda: ops.recall_gather(torch.randn(1, 3, 1, 2, 8, 16),
                                  torch.zeros((1, 1, 2), dtype=torch.int32)),
        lambda: ops.recall_gather_quant(torch.zeros((1, 3, 1, 2, 8, 16), dtype=torch.int8),
                                        torch.ones((1, 3, 1, 2, 1)),
                                        torch.zeros((1, 1, 2), dtype=torch.int32), bits=8),
        lambda: ops.page_summary(torch.randn(1, 16, 2, 64), page_size=8),
        lambda: ops.flash_prefill(torch.randn(1, 2, 8, 64), torch.randn(1, 1, 8, 64),
                                  torch.randn(1, 1, 8, 64), scale=0.125),
        lambda: ops.recall_values(torch.randn(1, 3, 1, 2, 8, 16),
                                  torch.zeros((1, 1, 2), dtype=torch.int32)),
        lambda: ops.recall_values_quant(torch.zeros((1, 3, 1, 2, 8, 16), dtype=torch.int8),
                                        torch.ones((1, 3, 1, 2, 1)),
                                        torch.zeros((1, 1, 2), dtype=torch.int32), bits=8),
        lambda: ops.centroid_scores(q, torch.randn(1, 4, 1, 2, 16),
                                    torch.ones((1, 4, 1), dtype=torch.int32), scale=0.25),
        lambda: ops.select_pages(q, torch.randn(1, 3, 1, 2, 16),
                                 torch.tensor([24], dtype=torch.int32), n_sel=2, scale=0.25,
                                 page_size=8, n_sink=0, n_window=0),
        lambda: ops.centroid_candidates(q, torch.randn(1, 4, 1, 2, 16),
                                        torch.ones((1, 4, 1), dtype=torch.int32),
                                        torch.zeros((1, 3, 1), dtype=torch.int32),
                                        torch.tensor([24], dtype=torch.int32), m=2, scale=0.25,
                                        page_size=8, n_sink=0, n_window=0),
        lambda: ops.fill_pages(torch.randn(1, 16, 2, 64), torch.randn(1, 16, 2, 64),
                               torch.zeros(1, 2, 2, 2, 64), torch.zeros(1, 2, 2, 2, 8, 64)),
        lambda: ops.complete_page(torch.randn(1, 24, 2, 64), torch.randn(1, 24, 2, 64),
                                  torch.tensor([16], dtype=torch.int32),
                                  torch.zeros(1, 4, 2, 2, 64), torch.zeros(1, 4, 2, 2, 8, 64)),
        lambda: ops.paged_attention_lse(q, kp, kp, pos, cur, scale=0.25),
        lambda: ops.select_pages_shard(q, torch.randn(1, 3, 1, 2, 16),
                                       torch.tensor([24], dtype=torch.int32), page_lo=1,
                                       n_sel=2, scale=0.25, page_size=8, n_sink=0, n_window=0),
        lambda: ops.complete_page_shard(torch.randn(1, 24, 2, 64), torch.randn(1, 24, 2, 64),
                                        torch.tensor([16], dtype=torch.int32),
                                        torch.zeros(1, 2, 2, 2, 64),
                                        torch.zeros(1, 2, 2, 2, 8, 64), page_lo=1),
    ]
    assert len(calls) == len(ops.KERNELS)
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert [fn.launches for fn in ops.KERNELS] == [0] * len(ops.KERNELS)


def test_other_devices_raise():
    """A device other than the CPU, CUDA and meta (where a wrapper takes the
    card's branch and launches nothing: ``launch/op_cost``) raises."""
    class OnXpu:
        device = torch.device("xpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.page_scores(OnXpu(), OnXpu(), scale=0.25)
    m = torch.empty((1, 1, 2, 16), device="meta")
    out = ops.page_scores(m, torch.empty((1, 3, 1, 2, 16), device="meta"), scale=0.25)
    assert out.device.type == "meta" and out.shape == (1, 1, 2, 3)
    assert ops.page_scores.launches == 0


def test_dispatch_has_no_try_fallback():
    """``kernels/ops.py`` holds no ``try``: a failing kernel surfaces."""
    tree = ast.parse((ROOT / "src" / "repro_torch" / "kernels" / "ops.py").read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_sink_and_window_must_be_whole_pages():
    with pytest.raises(ValueError, match="multiples of page_size"):
        FreeKVConfig(page_size=32, n_sink=48)
