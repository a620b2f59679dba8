"""The port stands alone and follows the device rule.

``ser_tpu_torch`` and ``chip_smoke.py`` import nothing of JAX, flax, optax
or the JAX package ``ser_tpu``; entry points run on ``cuda`` unless the
caller asks for the CPU, and raise where CUDA is missing.
"""

import ast
from pathlib import Path

import pytest
import torch

from ser_tpu_torch import predict
from ser_tpu_torch.device import resolve_device
from ser_tpu_torch.serving import Predictor

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "ser_tpu")
SOURCES = sorted((ROOT / "ser_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ser_tpu_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_device_rule_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert Predictor(device="cpu").model.linear_in.weight.device.type == "cpu"


def test_predict_cli_device_rule_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--synthetic", "--audio_frontend", "mfcc",
                      "--initial_model", str(tmp_path / "none.npz")])
    assert not list(tmp_path.iterdir())  # refused before any work


def test_train_cli_device_rule_without_cuda(monkeypatch, tmp_path):
    """The train CLI runs on ``cuda`` unless given ``--device cpu``, and
    raises where CUDA is missing before it writes any file."""
    from ser_tpu_torch.train import __main__ as train_cli
    from ser_tpu_torch.train.trainer import ModelTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    args = train_cli.parser_args(["--synthetic", "--epoch", "1",
                                  "--save_path", str(tmp_path / "exp")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(args)
    assert not list(tmp_path.iterdir())  # refused before any work
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelTrainer()
    assert ModelTrainer(device="cpu").generator.device.type == "cpu"
