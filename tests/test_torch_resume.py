"""Exact resume of the port's train CLI on the CPU, for IEMOCAP and MELD.

Three epochs run without a stop with ``--save_state``; one epoch, then
``--resume latest --epoch 3``: the two ``model/last.state`` files are equal
array for array (parameters, Adam's moments and step counts, the epoch, the
generator, the F1 and fusion-weight history), the epoch-3 checkpoints byte
for byte, and ``score.txt``'s epoch lines and ``parameters.csv`` equal apart
from the timestamps. A state file that lacks a parameter or an optimizer
leaf raises ``ValueError``; ``--resume latest`` with no file starts fresh
with the JAX ``train.py``'s message. Tiny pickles (6 train, 2 test
dialogues of 3-7 utterances, batch 4) at full model width, one intra-op
thread (as the other train test files).
"""

import numpy as np
import pytest
import torch

import train as jtrain_cli
from ser_tpu_torch.data.synthetic import (generate_iemocap_pickles,
                                          generate_meld_pickles)
from ser_tpu_torch.train import __main__ as train_cli
from ser_tpu_torch.train.trainer import ModelTrainer

TINY = dict(n_train=6, n_test=2, min_len=3, max_len=7, seed=5)
DATASETS = {"IEMOCAP": (generate_iemocap_pickles, 6), "MELD": (generate_meld_pickles, 7)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The eager train loop is thousands of small ops: one intra-op thread
    runs it faster while other test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(feature_path, dataset, work, save_path, *extra):
    """One run of the train CLI from the directory ``work`` (it writes
    ``parameters.csv`` and ``res.csv`` there)."""
    n_classes = DATASETS[dataset][1]
    args = train_cli.parser_args(
        ["--feature_path", feature_path, "--dataset", dataset, "--n_classes", str(n_classes),
         "--save_path", str(save_path), "--batch_size", "4", "--device", "cpu",
         "--save_state", *extra])
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        train_cli.main(args)
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=sorted(DATASETS))
def runs(request, tmp_path_factory):
    """``{"unstopped": dir, "resumed": dir}`` for one dataset, each holding
    the run's ``exp`` and its working directory's files."""
    dataset = request.param
    root = tmp_path_factory.mktemp(dataset.lower())
    feature_path = DATASETS[dataset][0](str(root / "pickles"), **TINY)
    out = {}
    for name in ("unstopped", "resumed"):
        (root / name).mkdir()
        out[name] = root / name
    _train(feature_path, dataset, out["unstopped"], out["unstopped"] / "exp", "--epoch", "3")
    _train(feature_path, dataset, out["resumed"], out["resumed"] / "exp", "--epoch", "1")
    _train(feature_path, dataset, out["resumed"], out["resumed"] / "exp", "--epoch", "3",
           "--resume", "latest")
    return dataset, out


def _state(run):
    with np.load(run / "exp" / "model" / "last.state") as z:
        return {k: z[k] for k in z.files}


def test_resumed_state_is_bit_equal(runs):
    dataset, out = runs
    a, b = _state(out["unstopped"]), _state(out["resumed"])
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["extra/epoch"]) == 3 and len(a["extra/history/fscores"]) == 3
    assert a["extra/generator"].dtype == np.uint8
    n_params = sum(k.startswith("params/") for k in a)
    assert n_params == 128 and sum(k.startswith("opt/") for k in a) == 3 * n_params
    stepped = [k for k in a if k.endswith("/step") and a[k] > 0]
    assert len(stepped) == 128 - 38  # every live parameter; the dead ones never
    head = "params/nn_out.3.bias"
    assert a[head].shape == (DATASETS[dataset][1],)


def test_resumed_checkpoint_is_byte_equal(runs):
    _, out = runs
    names = [sorted(p.name for p in (run / "exp" / "model").iterdir()) for run in out.values()]
    assert names[0] == names[1] == ["last.state", "model_0001.model", "model_0002.model",
                                    "model_0003.model"]
    for name in names[0]:
        assert ((out["unstopped"] / "exp" / "model" / name).read_bytes()
                == (out["resumed"] / "exp" / "model" / name).read_bytes()), name


def test_resumed_score_lines_equal(runs):
    dataset, out = runs
    lines = {k: [line.split(" —— ", 1)[1] for line in
                 (run / "exp" / "score.txt").read_text().splitlines() if " —— epoch " in line]
             for k, run in out.items()}
    assert len(lines["unstopped"]) == 3 and lines["unstopped"] == lines["resumed"]
    assert (out["unstopped"] / "exp" / "score.txt").read_text().count(
        f"Dataset : {dataset}") == 1
    assert ((out["unstopped"] / "parameters.csv").read_text()
            == (out["resumed"] / "parameters.csv").read_text())


@pytest.mark.parametrize("drop", ["params/linear_in.weight",
                                  "opt/encoder_l.slf_attn.w_qs.weight/exp_avg",
                                  "opt/nn_out.3.bias/exp_avg_sq",
                                  "opt/marn_cell_f.lstm_q0.weight_ih/step",
                                  "extra/generator"])
def test_state_with_a_key_removed_raises(tmp_path, drop):
    trainer = ModelTrainer(device="cpu", seed=0)
    path = tmp_path / "last.state"
    trainer.save_train_state(str(path), 2)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != drop}
    assert len(flat) == 2 + 4 * 128 - 1
    np.savez(tmp_path / "cut.npz", **flat)
    with pytest.raises(ValueError, match=drop.split("/")[-1]):
        ModelTrainer(device="cpu", seed=1).load_train_state(str(tmp_path / "cut.npz"))


def test_state_roundtrip_restores_a_trainer(tmp_path):
    """Adam state after steps (dead parameters with none), the generator and
    the epoch come back into a trainer built from another seed."""
    from ser_tpu_torch.data.synthetic import synthetic_batch

    src = ModelTrainer(device="cpu", seed=3)
    for seed in (0, 1):
        src._train_step_impl(synthetic_batch(L=6, B=2, seed=seed, min_len=3), 1e-3)
    src.save_train_state(str(tmp_path / "s.state"), 4, {"fscores": [1.5, 2.25]})
    dst = ModelTrainer(device="cpu", seed=9)
    assert dst.load_train_state(str(tmp_path / "s.state")) == 4
    assert dst.history == {"fscores": [1.5, 2.25]}
    assert torch.equal(dst.generator.get_state(), src.generator.get_state())
    for (name, p), q in zip(src.model.named_parameters(), dst.model.parameters()):
        assert torch.equal(p, q), name
        a, b = src.optimizer.state.get(p, {}), dst.optimizer.state.get(q, {})
        assert sorted(a) == sorted(b), name
        for leaf in a:
            assert torch.equal(a[leaf], b[leaf]) and a[leaf].dtype == b[leaf].dtype, name
    assert len(dst.optimizer.state) == 128 - 38
    batch = synthetic_batch(L=6, B=2, seed=2, min_len=3)
    assert torch.equal(src._train_step_impl(batch, 1e-3), dst._train_step_impl(batch, 1e-3))


def test_resume_latest_without_a_file_starts_fresh_as_jax(tmp_path, capsys):
    save = str(tmp_path / "exp" / "model")
    assert train_cli._resolve_resume("latest", save) == ""
    ours = capsys.readouterr().out
    assert jtrain_cli._resolve_resume("latest", save) == ""
    assert ours == capsys.readouterr().out == (
        f"--resume latest: no {save}/last.state yet; starting fresh\n")
    assert train_cli._resolve_resume("some.state", save) == "some.state"


@pytest.mark.parametrize("flag", [["--dataset", "MELD"], ["--save_state"],
                                  ["--resume", "latest"]])
def test_cli_takes_what_the_port_now_has(flag, tmp_path):
    args = train_cli.parser_args(["--save_path", str(tmp_path / "exp"), *flag])
    train_cli.check_supported(args)  # no refusal
