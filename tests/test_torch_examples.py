"""The port's examples (``examples/torch_*.py``) run end to end on the CPU at
the reference examples' sizes (the training example for fewer steps): each
``main()`` returns, prints its lines, and every token it generated lies in
the vocabulary; the training losses are finite."""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test (see ``tests/test_torch_ssm.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_vocab(tokens, arch):
    vocab = get_config(arch).vocab_size
    return len(tokens) > 0 and all(isinstance(t, int) and 0 <= t < vocab for t in tokens)


def test_quickstart(capsys):
    outs = _example("torch_quickstart").main(["--device", "cpu", "--kv-quant", "int8"])
    assert [len(o.tokens) for o in outs] == [16, 16]
    assert all(_in_vocab(o.tokens, "smollm-360m-smoke") for o in outs)
    text = capsys.readouterr().out
    assert "request 0:" in text and "kv_quant=int8" in text and "dequant" in text


def test_serve_longcontext(capsys):
    res = _example("torch_serve_longcontext").main(["--device", "cpu"])
    assert list(res) == ["full", "quest", "arkvale", "freekv"]
    for outs in res.values():
        assert [len(o.tokens) for o in outs] == [12, 12]
        assert all(_in_vocab(o.tokens, "granite-3-8b-smoke") for o in outs)
    text = capsys.readouterr().out
    assert text.count("match_vs_full=") == 4


def test_longgen_reasoning(capsys):
    outs = _example("torch_longgen_reasoning").main(["--device", "cpu"])
    assert sorted(outs) == [0.8, 0.9]
    for out in outs.values():
        assert len(out.tokens) == 96 and _in_vocab(out.tokens, "smollm-360m-smoke")
        assert 0.0 <= out.stats["correction_rate"] <= 1.0
    assert capsys.readouterr().out.count("generated 96 tokens") == 2


def test_train_lm(capsys, tmp_path):
    ckpt = tmp_path / "lm.npz"
    losses = _example("torch_train_lm").main(["--device", "cpu", "--steps", "5",
                                              "--ckpt", str(ckpt)])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert ckpt.exists()
    text = capsys.readouterr().out
    assert "step    0 loss=" in text and f"checkpoint -> {ckpt}" in text
