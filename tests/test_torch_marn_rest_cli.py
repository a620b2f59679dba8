"""MARN1_mf, MARN1_la and MARN1_newz through the port's CLIs, on the CPU.

- ``python -m ser_tpu_torch.predict --model MARN1_newz`` against the JAX
  ``predict.py --model MARN1_newz`` on the same small pickles and the same
  JAX checkpoint (its fusion logits ``w`` set off their init): the JSON,
  ``fusion_weights.w`` raw (not softmaxed, as the JAX trainer reports it),
  equal, and ``res.csv`` equal byte for byte; on IEMOCAP and on MELD at
  ``--n_classes 7``, where newz keeps its 6 logits as the JAX registry
  builds it.
- ``python -m ser_tpu_torch.train --model MARN1_mf --synthetic`` for 2
  epochs (the synthetic pickles cut to 8 train and 3 test dialogues of 3-9
  utterances, batch 4), then ``python -m ser_tpu_torch.predict --model
  MARN1_mf --synthetic`` on its epoch-2 checkpoint reports the Acc and F1
  that ``score.txt`` printed.
One intra-op thread, as the other train test files.
"""

import json
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predict as jpredict
from ser_tpu.data.synthetic import generate_iemocap_pickles as jgenerate
from ser_tpu.data.synthetic import generate_meld_pickles as jgenerate_meld
from ser_tpu.data.synthetic import synthetic_batch
from ser_tpu.models.registry import get_model_spec as jget_model_spec
from ser_tpu.train.checkpoint import flatten_params, save_parameters, unflatten_into
from ser_tpu_torch import predict as tpredict
from ser_tpu_torch.data import synthetic as tsynthetic
from ser_tpu_torch.train import __main__ as train_cli

SMALL = dict(n_train=8, n_test=3, min_len=3, max_len=9)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_json(out: str) -> dict:
    lines = out.splitlines()
    start = len(lines) - 1 - lines[::-1].index("{")
    return json.loads("\n".join(lines[start:]))


@pytest.mark.parametrize("dataset", ["IEMOCAP", "MELD"])
def test_predict_cli_newz_matches_jax(dataset, tmp_path, capsys):
    if dataset == "MELD":
        feat = jgenerate_meld(str(tmp_path), n_train=5, n_test=3, min_len=4,
                              max_len=12, seed=3)
    else:
        feat = jgenerate(str(tmp_path), n_train=5, n_test=3, min_len=4, max_len=12, seed=3)
    spec = jget_model_spec("MARN1_newz")
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(L=8, B=2).items() if k != "vid"}
    key = jax.random.PRNGKey(5)
    params = spec.build(6, dataset).init({"params": key, "dropout": key},
                                         *spec.make_inputs(batch),
                                         deterministic=True)["params"]
    flat = flatten_params(params)
    flat["w"] = np.array([0.3, -0.7], np.float32)
    ckpt = str(tmp_path / "newz.npz")
    save_parameters(unflatten_into(params, flat), ckpt)

    common = ["--model", "MARN1_newz", "--initial_model", ckpt, "--feature_path", feat,
              "--batch_size", "2", "--dataset", dataset,
              "--n_classes", "7" if dataset == "MELD" else "6"]
    jpredict.main(common + ["--res_csv", str(tmp_path / "jax.csv")])
    theirs = _last_json(capsys.readouterr().out)
    tpredict.main(common + ["--res_csv", str(tmp_path / "torch.csv"), "--device", "cpu"])
    out = capsys.readouterr().out
    ours = _last_json(out)
    assert "is not in the model" not in out and "Wrong parameter" not in out
    assert ours.pop("res_csv") == str(tmp_path / "torch.csv")
    assert theirs.pop("res_csv") == str(tmp_path / "jax.csv")
    assert ours == theirs
    np.testing.assert_allclose(ours["fusion_weights"]["w"], [0.3, -0.7], rtol=1e-7)
    assert list(ours["fusion_weights"]) == ["w"]
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_train_cli_mf_synthetic_then_predict_scores_its_checkpoint(tmp_path, monkeypatch,
                                                                   capsys):
    small = partial(tsynthetic.generate_iemocap_pickles, **SMALL)
    monkeypatch.setattr(train_cli, "generate_iemocap_pickles", small)
    monkeypatch.setattr(tpredict, "generate_iemocap_pickles", small)
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "exp"
    train_cli.main(train_cli.parser_args(
        ["--model", "MARN1_mf", "--synthetic", "--epoch", "2", "--batch_size", "4",
         "--device", "cpu", "--save_path", str(exp)]))
    score = (exp / "score.txt").read_text()
    lines = [line for line in score.splitlines() if " —— epoch " in line]
    assert "Model: MARN1_mf" in score and len(lines) == 2
    assert sorted(p.name for p in (exp / "model").iterdir()) == [
        "model_0001.model", "model_0002.model"]
    assert (tmp_path / "parameters.csv").read_text() == "\n"  # mf has no fusion weights
    capsys.readouterr()
    tpredict.main(["--model", "MARN1_mf", "--synthetic", "--batch_size", "4",
                   "--initial_model", str(exp / "model" / "model_0002.model"),
                   "--device", "cpu", "--res_csv", str(tmp_path / "predict.csv")])
    out = capsys.readouterr().out
    rep = _last_json(out)
    assert "is not in the model" not in out and rep["n_examples"] == 3
    scored = re.search(r"Acc ([\d.]+), Fscore ([\d.]+)", lines[1]).groups()
    assert (f"{rep['weighted_accuracy']:.2f}", f"{rep['weighted_f1']:.2f}") == scored
