"""The rank-1 MARN1 variants through the port's CLIs, on the CPU.

- ``python -m ser_tpu_torch.predict --model MARN1_nsps`` against the JAX
  ``predict.py --model MARN1_nsps`` on the same small pickles and the same
  JAX checkpoint (its fusion logits ``p`` set off their init, so their
  softmax is not [0.5, 0.5]): the JSON, ``fusion_weights.p`` included,
  equal, and ``res.csv`` equal byte for byte.
- ``python -m ser_tpu_torch.train --model MARN1_sp --synthetic`` for 2
  epochs (the synthetic pickles cut to 8 train and 3 test dialogues of 3-9
  utterances, batch 4), then ``python -m ser_tpu_torch.predict --model
  MARN1_sp --synthetic`` on its epoch-2 checkpoint reports the Acc and F1
  that ``score.txt`` printed.
- ``--resume latest`` for MARN1_nsps: 1 epoch then a resume to 3 ends
  bit-equal to 3 epochs never stopped (``last.state`` array for array,
  ``parameters.csv`` with its softmax(p) lists, ``score.txt``'s epoch lines).
- Both CLIs resolve the six variants and refuse a queued model, naming
  every model still queued.
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
from ser_tpu.data.synthetic import synthetic_batch
from ser_tpu.models.registry import get_model_spec as jget_model_spec
from ser_tpu.train.checkpoint import flatten_params, save_parameters, unflatten_into
from ser_tpu_torch import predict as tpredict
from ser_tpu_torch.data import synthetic as tsynthetic
from ser_tpu_torch.models.registry import available_models, get_model_spec
from ser_tpu_torch.train import __main__ as train_cli

VARIANTS = ("MARN1_sp", "MARN1_cf", "MARN1_azs", "MARN1_sps", "MARN1_nsps", "MARN1_no_en")
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


def test_predict_cli_nsps_matches_jax(tmp_path, capsys):
    feat = jgenerate(str(tmp_path), n_train=5, n_test=3, min_len=4, max_len=12, seed=3)
    spec = jget_model_spec("MARN1_nsps")
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(L=8, B=2).items() if k != "vid"}
    key = jax.random.PRNGKey(5)
    params = spec.build(6, "IEMOCAP").init({"params": key, "dropout": key},
                                            *spec.make_inputs(batch),
                                            deterministic=True)["params"]
    flat = flatten_params(params)
    flat["p"] = np.array([0.3, -0.7], np.float32)
    ckpt = str(tmp_path / "nsps.npz")
    save_parameters(unflatten_into(params, flat), ckpt)

    common = ["--model", "MARN1_nsps", "--initial_model", ckpt, "--feature_path", feat,
              "--batch_size", "2"]
    jpredict.main(common + ["--res_csv", str(tmp_path / "jax.csv")])
    theirs = _last_json(capsys.readouterr().out)
    tpredict.main(common + ["--res_csv", str(tmp_path / "torch.csv"), "--device", "cpu"])
    out = capsys.readouterr().out
    ours = _last_json(out)
    assert "is not in the model" not in out and "Wrong parameter" not in out
    assert ours.pop("res_csv") == str(tmp_path / "torch.csv")
    assert theirs.pop("res_csv") == str(tmp_path / "jax.csv")
    assert ours == theirs
    assert ours["n_examples"] == 3 and list(ours["fusion_weights"]) == ["p"]
    p = ours["fusion_weights"]["p"]
    np.testing.assert_allclose(p, np.exp([0.3, -0.7]) / np.exp([0.3, -0.7]).sum(), rtol=1e-6)
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_train_cli_sp_synthetic_then_predict_scores_its_checkpoint(tmp_path, monkeypatch,
                                                                   capsys):
    small = partial(tsynthetic.generate_iemocap_pickles, **SMALL)
    monkeypatch.setattr(train_cli, "generate_iemocap_pickles", small)
    monkeypatch.setattr(tpredict, "generate_iemocap_pickles", small)
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "exp"
    train_cli.main(train_cli.parser_args(
        ["--model", "MARN1_sp", "--synthetic", "--epoch", "2", "--batch_size", "4",
         "--device", "cpu", "--save_path", str(exp)]))
    score = (exp / "score.txt").read_text()
    lines = [line for line in score.splitlines() if " —— epoch " in line]
    assert "Model: MARN1_sp" in score and len(lines) == 2
    assert sorted(p.name for p in (exp / "model").iterdir()) == [
        "model_0001.model", "model_0002.model"]
    assert (tmp_path / "parameters.csv").read_text() == "\n"  # sp has no fusion weights
    capsys.readouterr()
    tpredict.main(["--model", "MARN1_sp", "--synthetic", "--batch_size", "4",
                   "--initial_model", str(exp / "model" / "model_0002.model"),
                   "--device", "cpu", "--res_csv", str(tmp_path / "predict.csv")])
    out = capsys.readouterr().out
    rep = _last_json(out)
    assert "is not in the model" not in out and rep["n_examples"] == 3
    scored = re.search(r"Acc ([\d.]+), Fscore ([\d.]+)", lines[1]).groups()
    assert (f"{rep['weighted_accuracy']:.2f}", f"{rep['weighted_f1']:.2f}") == scored


def _train_nsps(feature_path, work, *extra):
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        train_cli.main(train_cli.parser_args(
            ["--model", "MARN1_nsps", "--feature_path", feature_path, "--save_path",
             str(work / "exp"), "--batch_size", "4", "--device", "cpu", "--save_state",
             *extra]))
    finally:
        mp.undo()


def test_resume_latest_for_nsps_is_bit_equal(tmp_path):
    feat = tsynthetic.generate_iemocap_pickles(str(tmp_path / "pickles"), n_train=6,
                                               n_test=2, min_len=3, max_len=7, seed=5)
    runs = {name: tmp_path / name for name in ("unstopped", "resumed")}
    for run in runs.values():
        run.mkdir()
    _train_nsps(feat, runs["unstopped"], "--epoch", "3")
    _train_nsps(feat, runs["resumed"], "--epoch", "1")
    _train_nsps(feat, runs["resumed"], "--epoch", "3", "--resume", "latest")
    states = {}
    for name, run in runs.items():
        with np.load(run / "exp" / "model" / "last.state") as z:
            states[name] = {k: z[k] for k in z.files}
    a, b = states["unstopped"], states["resumed"]
    assert sorted(a) == sorted(b) and a["extra/history/fusion/p"].shape == (3, 2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    csv = [(run / "parameters.csv").read_text() for run in runs.values()]
    assert csv[0] == csv[1] and csv[0].startswith('p\n"[0.')
    lines = [[line.split(" —— ", 1)[1] for line in (run / "exp" / "score.txt").read_text()
              .splitlines() if " —— epoch " in line] for run in runs.values()]
    assert len(lines[0]) == 3 and lines[0] == lines[1]


def test_registry_resolves_the_six_variants():
    for name in VARIANTS:
        assert get_model_spec(name).name == name


@pytest.mark.parametrize("cli", ["predict", "train"])
def test_clis_refuse_a_queued_model_naming_every_queued_one(cli, tmp_path):
    """No model is queued any more: an unknown one is refused, naming all
    15 that both CLIs take, before any file is written."""
    argv = ["--model", "MARN2", "--feature_path", str(tmp_path), "--device", "cpu"]
    with pytest.raises(KeyError) as err:
        if cli == "predict":
            tpredict.main(argv + ["--initial_model", str(tmp_path / "none.npz")])
        else:
            train_cli.main(train_cli.parser_args(argv + ["--save_path", str(tmp_path / "e")]))
    message = str(err.value)
    assert "unknown model 'MARN2'" in message and len(available_models()) == 15
    assert all(f"'{name}'" in message for name in available_models())
    assert all(name in message for name in VARIANTS)  # the available ones
    assert not list(tmp_path.iterdir())
