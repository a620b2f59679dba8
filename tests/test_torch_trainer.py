"""The port's trainer and train CLI on the CPU, and checkpoints across the two
packages.

- ``ModelTrainer`` trains MARN1_onlysp (full width, dropout on) for 12 epochs
  on small synthetic pickles (16 train, 6 test dialogues of 6-16
  utterances, batch 8): the loss falls and the test accuracy is above 30%,
  the bar of ``tests/test_trainer_e2e.py``.
- A checkpoint the port writes loads into the JAX package's ``ModelTrainer``
  and one the JAX package writes loads into the port's, with equal eval
  predictions: ``res.csv`` equal byte for byte.
- ``legacy_h_csv_path`` writes the JAX trainer's ``h.csv`` byte for byte,
  and only beside ``res.csv``.
- The train CLI writes ``score.txt``, the checkpoints and ``parameters.csv``;
  ``--eval True`` prints the JAX ``train.py``'s Acc/Fscore line on one
  checkpoint and writes its ``score.txt`` byte for byte
  (``tests/test_torch_resume.py`` holds ``--dataset MELD``,
  ``--save_state`` and ``--resume``; ``tests/test_torch_mixed_precision.py``,
  ``tests/test_torch_parallel.py`` and ``tests/test_torch_tp.py``
  ``--compute_dtype bf16``, ``--dp`` and ``--tp``).
- The train step's CUDA graphs (``train/step_graph.py``) on what the CPU
  can show: the rule that engages them refuses every case but one f32
  process on the card with a marked model, the key follows each shape and
  each dropout rate, the static inputs are views of one buffer, the graphs
  are dropped whenever the optimizer, its state or the train state is
  replaced and kept when the weights are loaded in place, and ``set_lr``
  writes a tensor learning rate in place (``tests/test_torch_cuda.py``
  holds the graphs on the card).
"""

import numpy as np
import pytest
import torch

import train as jtrain_cli
from ser_tpu.data.loaders import get_loaders as jget_loaders
from ser_tpu.train.trainer import ModelTrainer as JModelTrainer
from ser_tpu_torch.data.loaders import PrefetchLoader, get_loaders
from ser_tpu_torch.data.synthetic import generate_iemocap_pickles
from ser_tpu_torch.train import __main__ as train_cli
from ser_tpu_torch.models.dialogue_rnn import DialogueRNN
from ser_tpu_torch.models.marn_newz import MARN1NewZ
from ser_tpu_torch.models.marn_onlysp import MARN1OnlySP
from ser_tpu_torch.models.marn_variants import MARN1LA, MARN1MF, MARN1NSPS, MARN1SP
from ser_tpu_torch.models.registry import build_model
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.ops.layers import Dropout
from ser_tpu_torch.train.checkpoint import save_parameters
from ser_tpu_torch.train.optim import set_lr, torch_adam
from ser_tpu_torch.train.step_graph import StepGraphs, dropout_rates, engages, graph_key
from ser_tpu_torch.train.trainer import ModelTrainer
from ser_tpu_torch.utils import profiling

BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's eager train loop is thousands of small ops: one intra-op
    thread runs it several times faster than many, above all while other
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def feature_path(tmp_path_factory):
    return generate_iemocap_pickles(str(tmp_path_factory.mktemp("pickles")),
                                    n_train=16, n_test=6, min_len=6,
                                    max_len=16, seed=3)


@pytest.fixture(scope="module")
def trained(feature_path, tmp_path_factory):
    train_loader, _, test_loader = get_loaders(feature_path, batch_size=BATCH,
                                               valid=0.25)
    trainer = ModelTrainer(device="cpu", seed=111, res_csv_path=str(
        tmp_path_factory.mktemp("res") / "res.csv"))
    losses = [trainer.train_network(epoch, PrefetchLoader(train_loader))[1]
              for epoch in range(1, 13)]
    return trainer, losses, test_loader


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    return JModelTrainer(model="MARN1_onlysp", seed=5, res_csv_path=str(
        tmp_path_factory.mktemp("jres") / "res.csv"))


def _jax_test_loader(feature_path):
    return jget_loaders(feature_path, dataset="IEMOCAP", batch_size=BATCH,
                        valid=0.25, num_workers=0)[2]


def test_loss_decreases(trained):
    _, losses, _ = trained
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_learns_above_chance(trained):
    trainer, _, test_loader = trained
    acc, f1, extras = trainer.eval_network(test_loader)
    assert acc > 30.0, f"acc {acc} not above 6-way chance"
    assert 0 <= f1 <= 100 and extras == {}
    assert not trainer.model.training


def test_step_lr_schedule(trained):
    trainer, _, _ = trained
    assert trainer.lr_at(1) == 1e-3
    assert abs(trainer.lr_at(2) - 1e-3 * 0.98) < 1e-15
    assert abs(trainer.lr_at(11) - 1e-3 * 0.98 ** 10) < 1e-15
    assert trainer.optimizer.param_groups[0]["lr"] == trainer.lr_at(12)


def test_port_checkpoint_loads_in_jax(trained, jax_trainer, feature_path, tmp_path):
    trainer, _, test_loader = trained
    ckpt = tmp_path / "port.model"
    trainer.save_parameters(str(ckpt))
    trainer.res_csv_path = str(tmp_path / "port.csv")
    acc, f1, _ = trainer.eval_network(test_loader)
    jax_trainer.load_parameters(str(ckpt))
    jax_trainer.res_csv_path = str(tmp_path / "jax.csv")
    jacc, jf1, _ = jax_trainer.eval_network(_jax_test_loader(feature_path))
    assert (acc, f1) == (jacc, jf1)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_jax_checkpoint_loads_in_port(jax_trainer, feature_path, tmp_path, capsys):
    ckpt = str(tmp_path / "jax.model")
    jax_trainer.save_parameters(ckpt)
    jax_trainer.res_csv_path = str(tmp_path / "jax.csv")
    jacc, jf1, _ = jax_trainer.eval_network(_jax_test_loader(feature_path))
    trainer = ModelTrainer(device="cpu", seed=0, res_csv_path=str(tmp_path / "port.csv"))
    trainer.load_parameters(ckpt)
    assert "is not in the model" not in capsys.readouterr().out
    acc, f1, _ = trainer.eval_network(get_loaders(feature_path, batch_size=BATCH,
                                                  valid=0.25)[2])
    assert (acc, f1) == (jacc, jf1)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_h_csv_is_the_jax_trainers(trained, jax_trainer, feature_path, tmp_path):
    """``legacy_h_csv_path``, set after construction as the JAX test sets
    it: ``h.csv`` byte-equal to the JAX trainer's on the same weights and
    loader, beside an equal ``res.csv``."""
    trainer, _, test_loader = trained
    ckpt = str(tmp_path / "port.model")
    trainer.save_parameters(ckpt)
    jax_trainer.load_parameters(ckpt)
    files = {}
    for who, t, loader in (("port", trainer, test_loader),
                           ("jax", jax_trainer, _jax_test_loader(feature_path))):
        t.res_csv_path = str(tmp_path / f"{who}_res.csv")
        t.legacy_h_csv_path = str(tmp_path / f"{who}_h.csv")
        try:
            t.eval_network(loader)
        finally:
            t.legacy_h_csv_path = None
        files[who] = [(tmp_path / f"{who}_{f}.csv").read_bytes() for f in ("res", "h")]
    assert files["port"] == files["jax"]
    assert files["port"][1].startswith(b"trues,preds,masks\n")


@pytest.mark.parametrize("res_csv", [True, False])
def test_h_csv_only_where_res_csv_is_written(trained, tmp_path, res_csv):
    """No ``h.csv`` without its path, and none without ``res_csv_path``: the
    JAX trainer writes it only beside ``res.csv``."""
    trainer, _, test_loader = trained
    res, h = tmp_path / "res.csv", tmp_path / "h.csv"
    kept = trainer.res_csv_path, trainer.legacy_h_csv_path
    trainer.res_csv_path = str(res) if res_csv else None
    trainer.legacy_h_csv_path = None if res_csv else str(h)
    try:
        trainer.eval_network(test_loader)
    finally:
        trainer.res_csv_path, trainer.legacy_h_csv_path = kept
    assert res.exists() == res_csv and not h.exists()
    assert ModelTrainer(device="cpu", legacy_h_csv_path=str(h)).legacy_h_csv_path == str(h)


def test_tolerant_partial_load(tmp_path, capsys):
    """Unknown names and wrong shapes are skipped with the reference's
    prints; what fits loads; the rest keeps its values; Adam starts anew."""
    src = ModelTrainer(device="cpu", seed=1)
    dst = ModelTrainer(device="cpu", seed=2)
    ckpt = tmp_path / "partial.npz"
    save_parameters(src.model, ckpt)
    with np.load(ckpt) as z:
        flat = {k: z[k] for k in z.files}
    kept = "encoder_l/slf_attn/w_qs/kernel"
    bad_shape = "nn_out_3/bias"
    partial = {kept: flat[kept], bad_shape: np.zeros(2, np.float32),
               "module.linear_in/bias": flat["linear_in/bias"],
               "no_such/param": np.zeros(3, np.float32)}
    np.savez(tmp_path / "partial2.npz", **partial)
    before = {k: v.clone() for k, v in dst.model.state_dict().items()}
    dst.load_parameters(str(tmp_path / "partial2.npz"))
    out = capsys.readouterr().out
    assert "no_such/param is not in the model." in out
    assert f"Wrong parameter length: {bad_shape}" in out
    after, want = dst.model.state_dict(), src.model.state_dict()
    for key in ("encoder_l.slf_attn.w_qs.weight", "linear_in.bias"):
        assert after[key].equal(want[key]), key
    for key in ("nn_out.3.bias", "linear_in.weight"):
        assert after[key].equal(before[key]), key
    assert not dst.optimizer.state


def test_torch_export_loads_in_both_packages(trained, jax_trainer, tmp_path, capsys):
    """``export_parameters_torch`` writes the reference's torch state dict:
    the port's ``--torch_format`` load and the JAX package's torch import
    both take every parameter of it unchanged."""
    from ser_tpu.train.checkpoint import flatten_params
    from ser_tpu_torch.compat.from_jax import to_jax_params

    trainer, _, _ = trained
    path = str(tmp_path / "export.model")
    trainer.export_parameters_torch(path)
    other = ModelTrainer(device="cpu", seed=9)
    other.load_parameters(path, torch_format=True)
    jax_trainer.load_parameters(path, torch_format=True)
    assert "is not in the model" not in capsys.readouterr().out
    want = trainer.model.state_dict()
    for key, value in other.model.state_dict().items():
        assert value.equal(want[key]), key
    jflat = flatten_params(jax_trainer.params)
    for name, value in to_jax_params(want).items():
        np.testing.assert_array_equal(np.asarray(jflat[name]), value, err_msg=name)


def test_init_args_is_jaxs(tmp_path):
    import argparse

    from ser_tpu.utils.paths import init_args as jinit_args
    from ser_tpu_torch.utils.paths import init_args

    ours = init_args(argparse.Namespace(save_path=str(tmp_path / "a")))
    theirs = jinit_args(argparse.Namespace(save_path=str(tmp_path / "a")))
    assert vars(ours) == vars(theirs)
    assert (tmp_path / "a" / "model").is_dir()


def _cli_args(feature_path, save_path, *extra):
    return train_cli.parser_args(
        ["--feature_path", feature_path, "--save_path", str(save_path),
         "--batch_size", str(BATCH), "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def cli_run(feature_path, tmp_path_factory):
    """Two epochs of the train CLI on the CPU, run from a scratch directory
    (``parameters.csv`` and ``res.csv`` go to the working directory)."""
    work = tmp_path_factory.mktemp("cli")
    mp = pytest.MonkeyPatch()
    mp.chdir(work)
    try:
        train_cli.main(_cli_args(feature_path, work / "exp", "--epoch", "2"))
    finally:
        mp.undo()
    return work


def test_train_cli_writes_score_checkpoints_and_parameters(cli_run):
    exp = cli_run / "exp"
    lines = (exp / "score.txt").read_text().splitlines()
    assert lines[:3] == ["Model: MARN1_onlysp ", "Dataset : IEMOCAP", "-" * 20]
    epochs = [line for line in lines if " —— epoch " in line]
    assert len(epochs) == 2 and "epoch 2, Loss " in epochs[1]
    assert "Best Fscore: " in epochs[1]
    assert sorted(p.name for p in (exp / "model").iterdir()) == [
        "model_0001.model", "model_0002.model"]
    rows = (cli_run / "parameters.csv").read_text().splitlines()
    assert rows[0] == "w,v,v1,v2" and len(rows) == 3
    assert np.isfinite([[float(v) for v in row.split(",")] for row in rows[1:]]).all()
    assert (cli_run / "res.csv").exists()


def test_eval_cli_prints_the_jax_train_py_line(cli_run, feature_path, tmp_path,
                                               monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ckpt = str(cli_run / "exp" / "model" / "model_0002.model")
    common = ["--eval", "True", "--initial_model", ckpt,
              "--feature_path", feature_path, "--batch_size", str(BATCH)]
    train_cli.main(train_cli.parser_args(
        common + ["--save_path", str(tmp_path / "port"), "--device", "cpu"]))
    port = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("Acc ")]
    jtrain_cli.main(jtrain_cli.parser_args(
        common + ["--save_path", str(tmp_path / "jax"), "--num_workers", "0"]))
    jax = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("Acc ")]
    assert len(port) == 1 and port == jax
    # the eval-only run writes train.py's score.txt header, no more
    score = (tmp_path / "port" / "score.txt").read_bytes()
    assert score == b"Model: MARN1_onlysp \nDataset : IEMOCAP\n" + b"-" * 20 + b"\n"
    assert score == (tmp_path / "jax" / "score.txt").read_bytes()


def test_cli_names_the_zoo_item_for_another_model(tmp_path):
    """Every model of the JAX registry is ported: an unknown name raises,
    listing them, before any file is written."""
    with pytest.raises(KeyError, match=r"unknown model 'MARN2'; available: .*'BiLSTM'"):
        train_cli.main(_cli_args(str(tmp_path), tmp_path / "exp", "--model", "MARN2"))
    assert not list(tmp_path.iterdir())


# the train step's CUDA graphs, on the CPU

GRAPHED = dict(device=torch.device("cuda"), processes=1, compute_dtype=torch.float32,
               infonce=0.0, encoder_attention="mha")
REFUSED = {"cpu": dict(device=torch.device("cpu")), "dp": dict(processes=2),
           "tp": dict(processes=4), "bf16": dict(compute_dtype=torch.bfloat16),
           "infonce": dict(infonce=0.1), "zoo_encoder": dict(encoder_attention="muse")}


@pytest.mark.parametrize("marked", [MARN1OnlySP, MARN1SP, MARN1NSPS, MARN1MF, MARN1LA])
def test_graph_engages_for_one_f32_process_on_the_card(marked):
    assert engages(**GRAPHED, model=marked)


@pytest.mark.parametrize("case", list(REFUSED) + ["debug_nans", "unmarked", "newz"])
def test_graph_engagement_refuses(case):
    model = {"unmarked": DialogueRNN, "newz": MARN1NewZ}.get(case, MARN1OnlySP)
    was = profiling.nan_checks_enabled()
    profiling.enable_nan_checks(case == "debug_nans")
    try:
        assert not engages(**{**GRAPHED, **REFUSED.get(case, {})}, model=model)
    finally:
        profiling.enable_nan_checks(was)


def test_cpu_trainer_steps_eagerly_with_a_float_lr():
    trainer = ModelTrainer(device="cpu", seed=1)
    assert not trainer.graphed
    assert not trainer.optimizer.param_groups[0]["capturable"]
    assert isinstance(trainer.optimizer.param_groups[0]["lr"], float)


def test_graph_key_follows_each_shape_and_each_dropout_rate():
    model = build_model("MARN1_onlysp", generator(0), 6)
    base = graph_key((110, 80, 1124), 2, model)
    others = [graph_key(s, p, model) for s, p in (((109, 80, 1124), 2), ((110, 40, 1124), 2),
                                                   ((110, 80, 1124), 9), ((110, 80, 1324), 2))]
    assert base not in others and len(set(others)) == 4
    rates = [(m, "p") for m in model.modules() if isinstance(m, Dropout)]
    rates += [(model, "dropout_rate"), (model, "attn_dropout")]
    assert len(rates) == len(dropout_rates(model)) > 2
    for m, attr in rates:
        old = getattr(m, attr)
        setattr(m, attr, 0.0)
        assert graph_key((110, 80, 1124), 2, model) != base, (m, attr)
        setattr(m, attr, old)
    assert graph_key((110, 80, 1124), 2, model) == base


def test_graph_static_inputs_are_views_of_one_buffer_a_name():
    graphs = StepGraphs(torch.device("cpu"), torch.Generator())
    label = lambda B, L: torch.ones(B, L, dtype=torch.int32)  # noqa: E731
    big = graphs.inputs({"x": torch.ones(110, 80, 3), "label": label(80, 110)})
    graphs.graphs["planted"] = object()
    small = graphs.inputs({"x": torch.ones(109, 40, 3), "label": label(40, 109)})
    assert graphs.graphs  # a smaller shape reads the same buffers
    for name in ("x", "label"):
        assert small[name].data_ptr() == big[name].data_ptr() == graphs.buffers[name].data_ptr()
    assert small["x"].shape == (109, 40, 3) and small["label"].dtype is torch.int32
    graphs.pool = "planted"
    graphs.inputs({"x": torch.ones(111, 80, 3)})
    assert not graphs.graphs and graphs.buffers["x"].numel() == 111 * 80 * 3
    assert graphs.pool is None  # a pool that no graph holds is not captured into again


def test_graphs_dropped_when_optimizer_or_train_state_replaced_kept_on_weights(tmp_path, capsys):
    trainer = ModelTrainer(device="cpu", seed=1)

    def plant():
        trainer.graphs.graphs[("planted",)] = object()

    plant()
    params = list(trainer.model.parameters())
    trainer.model.load_state_dict({k: v + 1 for k, v in trainer.model.state_dict().items()})
    assert trainer.graphs.graphs and all(p is q for p, q in zip(params, trainer.model.parameters()))
    trainer.optimizer.load_state_dict(trainer.optimizer.state_dict())
    assert not trainer.graphs.graphs
    plant()
    trainer.optimizer = trainer._adam(1e-3)
    assert not trainer.graphs.graphs
    plant()
    trainer.save_parameters(str(tmp_path / "p.npz"))
    trainer.load_parameters(str(tmp_path / "p.npz"))
    assert not trainer.graphs.graphs
    plant()
    trainer.optimizer.load_state_dict(trainer.optimizer.state_dict())  # the new one's hook
    assert not trainer.graphs.graphs
    plant()
    trainer.save_train_state(str(tmp_path / "s.npz"), 1)
    assert trainer.graphs.graphs
    trainer.load_train_state(str(tmp_path / "s.npz"))
    assert not trainer.graphs.graphs


def test_set_lr_writes_a_tensor_rate_in_place():
    w = torch.nn.Parameter(torch.ones(3))
    opt = torch_adam([w], 1e-3, capturable=True)
    lr = opt.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and lr.item() == pytest.approx(1e-3)
    set_lr(opt, 5e-4)
    assert opt.param_groups[0]["lr"] is lr and lr.item() == pytest.approx(5e-4)
    plain = torch_adam([w], 1e-3)
    set_lr(plain, 5e-4)
    assert plain.param_groups[0]["lr"] == 5e-4


def test_graph_spans_are_program_spans():
    assert {"ser#graph.capture", "ser#graph.replay"} <= set(profiling.SPANS)
