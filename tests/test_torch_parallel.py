"""Data parallelism in the port (``--dp``, ``ser_tpu_torch/parallel``) on
the CPU: the loader's per-process rows, and one launch of two gloo
processes against the one-process trainer.

- The loader cases of ``tests/test_multiprocess.py`` on the port's
  ``EpochLoader``: each process's rows reassemble the one-process batch
  exactly (same shuffle, same length bucket), the global ``umask`` and
  ``label`` ride along, a batch that does not divide over the processes
  raises, and one process's loader is unchanged.
- Two processes (``torch.distributed``, gloo, the ``torchrun`` environment
  variables, a free port), each running this file as a script: MARN1_onlysp
  at [9, 4], dropout off, 2 rows a process. Each process's loss equals the
  one-process step's at rtol 1e-5; the reduced gradients equal its
  gradients within 1e-3 of a tensor's largest entry plus 1e-6 of the
  step's largest (the train-step contract); the parameters after Adam are
  bit-equal across the processes; the dead set is onlysp's 38. The same
  with ``--infonce`` at weight 1e4 (the negatives are every process's rows,
  gathered inside autograd). The eval of the same weights gives the
  one-process Acc and F1 exactly. A
  ``save_train_state`` of the two processes resumes in two processes (each
  its own generator state) and refuses one process, and a one-process file
  refuses two. Then ``python -m ser_tpu_torch.train --dp --epoch 1
  --batch_size 16 --synthetic --device cpu`` in both: one ``score.txt``
  block, one ``res.csv``.
- A single-process ``--dp`` run prints ``train.py``'s line and trains as
  without the flag.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # a worker process
    sys.path.insert(0, str(ROOT))

from ser_tpu_torch.data.loaders import EpochLoader  # noqa: E402
from ser_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from ser_tpu_torch.ops.layers import Dropout  # noqa: E402
from ser_tpu_torch.parallel import local_batch_slice  # noqa: E402
from ser_tpu_torch.train import __main__ as train_cli  # noqa: E402
from ser_tpu_torch.train.trainer import ModelTrainer  # noqa: E402

L, B, LR, SEED, WORLD = 9, 4, 1e-3, 3, 2
INFONCE = 1e4  # at 0.1 the term's gradients lie below the tolerance


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_items(n=10, seed=3):
    """A 10-field IEMOCAP-shaped dataset in memory, the same on every
    process."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        T = int(rng.integers(4, 9))
        fields = [rng.standard_normal((T, d)).astype(np.float32)
                  for d in (1024, 1024, 1024, 1024, 512, 100)]
        qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=T)]
        label = rng.integers(0, 6, size=T).astype(np.int64)
        items.append((*fields, qmask, np.ones(T, np.float32), label, f"d{i}"))
    return items


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.dropout_rate = model.attn_dropout = 0.0
    return model


def step_batch(rank=0, world=1):
    """The [L, B] step batch, or process ``rank``'s rows of it."""
    batch = {k: v for k, v in synthetic_batch(L=L, B=B, seed=0).items()}
    if world == 1:
        return batch
    return EpochLoader([], [], B, process_index=rank, process_count=world)._local_rows(batch)


def eval_loader(rank=0, world=1):
    return EpochLoader(make_items(), np.arange(10), 4, shuffle=False,
                       process_index=rank, process_count=world)


def test_process_slices_reassemble_global_batch():
    items = make_items()
    kw = dict(batch_size=4, shuffle=True)
    full = list(EpochLoader(items, np.arange(10), seed=11, **kw))
    local = [list(EpochLoader(items, np.arange(10), seed=11, process_index=p,
                              process_count=WORLD, **kw)) for p in range(WORLD)]
    assert len(full) == len(local[0]) == len(local[1]) == 3
    for bi, fb in enumerate(full):
        assert set(local[0][bi]) == set(fb) | {"umask_global", "label_global"}
        for key, v in fb.items():
            if key == "vid":
                assert sum((local[p][bi][key] for p in range(WORLD)), []) == v
            elif key in ("umask", "label"):
                got = np.concatenate([local[p][bi][key] for p in range(WORLD)], axis=0)
                np.testing.assert_array_equal(got, v)
                for p in range(WORLD):
                    np.testing.assert_array_equal(local[p][bi][key + "_global"], v)
            else:
                got = np.concatenate([local[p][bi][key] for p in range(WORLD)], axis=1)
                np.testing.assert_array_equal(got, v)


def test_process_count_must_divide_batch():
    with pytest.raises(ValueError, match="global batch 3 not divisible by 2 processes"):
        EpochLoader(make_items(4), np.arange(4), batch_size=3,
                    process_index=0, process_count=2)
    with pytest.raises(ValueError, match="global batch 6 not divisible by 4 processes"):
        local_batch_slice(1, 4)(6)
    assert local_batch_slice(1, 4)(8) == slice(2, 4)
    assert local_batch_slice()(8) == slice(0, 8)  # no process group: one process


def test_single_process_loader_unchanged():
    items = make_items()
    a = list(EpochLoader(items, np.arange(10), 4, seed=5))
    b = list(EpochLoader(items, np.arange(10), 4, seed=5, process_index=0, process_count=1))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y) and "umask_global" not in y
        for k in x:
            if k != "vid":
                np.testing.assert_array_equal(x[k], y[k])


def test_single_process_dp_runs_single(tmp_path, monkeypatch, capsys):
    """Without a process group ``--dp`` prints ``train.py``'s line and the
    run is the one without the flag, score line for score line."""
    from ser_tpu_torch.data.synthetic import generate_iemocap_pickles

    feats = generate_iemocap_pickles(str(tmp_path / "feats"), n_train=8, n_test=4,
                                     min_len=4, max_len=8, seed=3)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    lines = {}
    for name, extra in (("plain", []), ("dp", ["--dp"])):
        train_cli.main(train_cli.parser_args(
            ["--feature_path", feats, "--epoch", "1", "--batch_size", "4", "--device", "cpu",
             "--num_workers", "0", "--save_path", str(tmp_path / name)] + extra))
        text = (tmp_path / name / "score.txt").read_text()
        lines[name] = [line.split(" —— ")[1] for line in text.splitlines() if " —— " in line]
    assert "--dp requested but only one device present; running single" in capsys.readouterr().out
    assert len(lines["dp"]) == 1 and lines["dp"] == lines["plain"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process step, eval and train-state file the workers are held
    to."""
    out = tmp_path_factory.mktemp("one")
    trainer = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None)
    no_dropout(trainer.model)
    acc, f1, _ = trainer.eval_network(eval_loader())
    loss = trainer._train_step_impl(step_batch(), LR).item()
    grads = {n: None if p.grad is None else p.grad.clone()
             for n, p in trainer.model.named_parameters()}
    trainer.save_train_state(out / "one.state", 1)
    nce = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None, infonce=INFONCE)
    no_dropout(nce.model)
    nce_loss = nce._train_step_impl(step_batch(), LR).item()
    nce_grads = {n: None if p.grad is None else p.grad.clone()
                 for n, p in nce.model.named_parameters()}
    return dict(loss=loss, grads=grads, acc=acc, f1=f1, state=out / "one.state",
                nce_loss=nce_loss, nce_grads=nce_grads)


@pytest.fixture(scope="module")
def two_processes(one_process, tmp_path_factory):
    """Both workers' results: ``[rank 0, rank 1]``, each a dict."""
    work = tmp_path_factory.mktemp("dp")
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(work), str(one_process["state"])],
            cwd=str(work), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    results = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
        results.append(dict(json.loads(line[len("RESULT "):]), out=out))
    return work, sorted(results, key=lambda r: r["rank"])


def test_each_process_loss_is_the_one_process_loss(one_process, two_processes):
    for r in two_processes[1]:
        np.testing.assert_allclose(r["loss"], one_process["loss"], rtol=1e-5)


@pytest.mark.parametrize("kind", ["plain", "nce"])
def test_reduced_gradients_are_the_one_process_gradients(one_process, two_processes, kind):
    work, results = two_processes
    want = one_process["grads" if kind == "plain" else "nce_grads"]
    top = max(g.abs().max().item() for g in want.values() if g is not None)
    for r in results:
        if kind == "nce":
            np.testing.assert_allclose(r["nce_loss"], one_process["nce_loss"], rtol=1e-5)
        with np.load(work / f"{kind}_grads{r['rank']}.npz") as z:
            got = {k: z[k] for k in z.files}
        assert set(got) == {n for n, g in want.items() if g is not None}
        for name, g in got.items():
            w = want[name].numpy()
            tol = 1e-3 * np.abs(w).max() + 1e-6 * top
            np.testing.assert_array_less(np.abs(g - w), tol, err_msg=name)


def test_parameters_bit_equal_across_processes(two_processes):
    work, _ = two_processes
    with np.load(work / "params0.npz") as a, np.load(work / "params1.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dead_set_is_onlysps(one_process, two_processes):
    want = sorted(n for n, g in one_process["grads"].items() if g is None)
    assert len(want) == 38
    for r in two_processes[1]:
        assert r["dead"] == want


def test_dp_eval_gives_the_one_process_metrics(one_process, two_processes):
    for r in two_processes[1]:
        assert (r["acc"], r["f1"]) == (one_process["acc"], one_process["f1"])


def test_train_state_round_trip_and_world_size(one_process, two_processes):
    for r in two_processes[1]:
        assert r["resumed_epoch"] == 1 and r["resumed_params_equal"]
        assert r["resumed_own_generator"]
        assert "was written by 1 process(es); this run has 2" in r["one_process_file"]
    trainer = ModelTrainer(device="cpu", seed=SEED, res_csv_path=None)
    with pytest.raises(ValueError, match=r"written by 2 process\(es\); this run has 1"):
        trainer.load_train_state(two_processes[0] / "two.state")


def test_two_process_train_cli_writes_one_record(two_processes):
    work, results = two_processes
    text = (work / "cli" / "score.txt").read_text()
    assert text.count("Model: MARN1_onlysp") == 1
    assert len([line for line in text.splitlines() if " —— epoch 1," in line]) == 1
    rows = (work / "res.csv").read_text().splitlines()
    assert rows[0] == "preds,labels,masks" and len(rows) > 1
    assert (work / "cli" / "model" / "model_0001.model").exists()
    for r in results:
        assert f"process {r['rank']}/2: loading 8 of 16 dialogues per batch" in r["out"]


def _worker(work: Path, one_state: Path) -> None:
    """One process of the launch (the module docstring)."""
    import torch.distributed as dist

    from ser_tpu_torch.parallel import initialize_distributed, world

    torch.set_num_threads(1)
    initialize_distributed("cpu")
    rank, size = world()
    result = {"rank": rank}
    trainer = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None, dp=True)
    no_dropout(trainer.model)
    result["acc"], result["f1"], _ = trainer.eval_network(eval_loader(rank, size))
    result["loss"] = trainer._train_step_impl(step_batch(rank, size), LR).item()
    np.savez(work / f"plain_grads{rank}.npz", **{n: p.grad.numpy() for n, p in
                                                 trainer.model.named_parameters()
                                                 if p.grad is not None})
    np.savez(work / f"params{rank}.npz", **{n: p.detach().numpy() for n, p in
                                            trainer.model.named_parameters()})
    result["dead"] = sorted(n for n, p in trainer.model.named_parameters() if p.grad is None)
    nce = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None, dp=True,
                       infonce=INFONCE)
    no_dropout(nce.model)
    result["nce_loss"] = nce._train_step_impl(step_batch(rank, size), LR).item()
    np.savez(work / f"nce_grads{rank}.npz", **{n: p.grad.numpy() for n, p in
                                               nce.model.named_parameters()
                                               if p.grad is not None})

    trainer.save_train_state(work / "two.state", 1)
    dist.barrier()
    own = trainer.generator.get_state()
    resumed = ModelTrainer(device="cpu", seed=SEED + 1, lr=LR, res_csv_path=None, dp=True)
    result["resumed_epoch"] = resumed.load_train_state(work / "two.state")
    result["resumed_params_equal"] = all(
        torch.equal(p, q) for p, q in zip(resumed.model.parameters(),
                                          trainer.model.parameters()))
    result["resumed_own_generator"] = torch.equal(resumed.generator.get_state(), own)
    try:
        resumed.load_train_state(one_state)
        result["one_process_file"] = "loaded"
    except ValueError as e:
        result["one_process_file"] = str(e)

    train_cli.main(train_cli.parser_args(
        ["--dp", "--epoch", "1", "--batch_size", "16", "--synthetic", "--device", "cpu",
         "--num_workers", "0", "--save_path", str(work / "cli")]))
    print("RESULT " + json.dumps(result), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), Path(sys.argv[2]))
