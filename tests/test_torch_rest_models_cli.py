"""DialogueRNN and the MARN family through the port's CLIs, on the CPU.

- ``python -m ser_tpu_torch.predict`` against the JAX ``predict.py`` on the
  same small pickles and the same JAX checkpoint, for DialogueRNN and
  MARN_ATV on IEMOCAP (the trimodal input) and MARN_AT on MELD at
  ``--n_classes 7``: the JSON equal and ``res.csv`` equal byte for byte,
  time-major rows for MARN_AT and MARN_ATV as the JAX CLI writes them. For
  DialogueRNN the port also reads the checkpoint as the reference's torch
  state dict (``--torch_format``, the JAX package's
  ``export_torch_checkpoint``, keys ``model.``-prefixed) and writes the
  same files.
- ``python -m ser_tpu_torch.train --model M --synthetic`` for 2 epochs (the
  synthetic pickles cut to 8 train and 3 test dialogues of 3-9 utterances,
  batch 4), then ``python -m ser_tpu_torch.predict --model M --synthetic``
  on its epoch-2 checkpoint reports the Acc and F1 that ``score.txt``
  printed, for DialogueRNN and MARN_ATV.
One intra-op thread, as the other train test files.
"""

import re
from functools import partial

import jax
import jax.numpy as jnp
import pytest
import torch

import predict as jpredict
from ser_tpu.compat.torch_export import export_torch_checkpoint
from ser_tpu.data.synthetic import generate_iemocap_pickles as jgenerate
from ser_tpu.data.synthetic import generate_meld_pickles as jgenerate_meld
from ser_tpu.data.synthetic import synthetic_batch
from ser_tpu.models.registry import get_model_spec as jget_model_spec
from ser_tpu.train.checkpoint import save_parameters
from ser_tpu_torch import predict as tpredict
from ser_tpu_torch.data import synthetic as tsynthetic
from ser_tpu_torch.train import __main__ as train_cli
from test_torch_marn_rest_cli import SMALL, _last_json


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,dataset", [("DialogueRNN", "IEMOCAP"), ("MARN_ATV", "IEMOCAP"),
                                          ("MARN_AT", "MELD")])
def test_predict_cli_matches_jax(name, dataset, tmp_path, capsys):
    if dataset == "MELD":
        feat = jgenerate_meld(str(tmp_path), n_train=5, n_test=3, min_len=4, max_len=12, seed=3)
    else:
        feat = jgenerate(str(tmp_path), n_train=5, n_test=3, min_len=4, max_len=12, seed=3)
    spec = jget_model_spec(name)
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(L=8, B=2).items() if k != "vid"}
    key = jax.random.PRNGKey(5)
    params = spec.build(6, dataset).init({"params": key, "dropout": key},
                                         *spec.make_inputs(batch), deterministic=True)["params"]
    ckpt = str(tmp_path / "model.npz")
    save_parameters(params, ckpt)
    common = ["--model", name, "--feature_path", feat, "--batch_size", "2",
              "--dataset", dataset, "--n_classes", "7" if dataset == "MELD" else "6"]
    jpredict.main(common + ["--initial_model", ckpt, "--res_csv", str(tmp_path / "jax.csv")])
    theirs = _last_json(capsys.readouterr().out)
    assert theirs.pop("res_csv") == str(tmp_path / "jax.csv")
    runs = [("npz", ["--initial_model", ckpt])]
    if name == "DialogueRNN":
        torch_ckpt = str(tmp_path / "reference.model")
        keys = export_torch_checkpoint(params, torch_ckpt, name, log=lambda *_: None)
        assert keys[0].startswith("model.dialog_rnn_f.dialogue_cell.")
        runs.append(("torch", ["--initial_model", torch_ckpt, "--torch_format"]))
    for tag, flags in runs:
        csv_path = tmp_path / f"torch_{tag}.csv"
        tpredict.main(common + flags + ["--res_csv", str(csv_path), "--device", "cpu"])
        out = capsys.readouterr().out
        ours = _last_json(out)
        assert "is not in the model" not in out and "Wrong parameter" not in out
        assert ours.pop("res_csv") == str(csv_path)
        assert ours == theirs and ours["fusion_weights"] == {}
        assert csv_path.read_bytes() == (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("name", ["DialogueRNN", "MARN_ATV"])
def test_train_cli_synthetic_then_predict_scores_its_checkpoint(name, tmp_path, monkeypatch,
                                                                capsys):
    small = partial(tsynthetic.generate_iemocap_pickles, **SMALL)
    monkeypatch.setattr(train_cli, "generate_iemocap_pickles", small)
    monkeypatch.setattr(tpredict, "generate_iemocap_pickles", small)
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "exp"
    train_cli.main(train_cli.parser_args(
        ["--model", name, "--synthetic", "--epoch", "2", "--batch_size", "4",
         "--device", "cpu", "--save_path", str(exp)]))
    score = (exp / "score.txt").read_text()
    lines = [line for line in score.splitlines() if " —— epoch " in line]
    assert f"Model: {name}" in score and len(lines) == 2
    assert sorted(p.name for p in (exp / "model").iterdir()) == [
        "model_0001.model", "model_0002.model"]
    capsys.readouterr()
    tpredict.main(["--model", name, "--synthetic", "--batch_size", "4",
                   "--initial_model", str(exp / "model" / "model_0002.model"),
                   "--device", "cpu", "--res_csv", str(tmp_path / "predict.csv")])
    out = capsys.readouterr().out
    rep = _last_json(out)
    assert "is not in the model" not in out and rep["n_examples"] == 3
    scored = re.search(r"Acc ([\d.]+), Fscore ([\d.]+)", lines[1]).groups()
    assert (f"{rep['weighted_accuracy']:.2f}", f"{rep['weighted_f1']:.2f}") == scored
