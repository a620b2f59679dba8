"""Tensor parallelism in the port (``--tp``, ``ser_tpu_torch/parallel/tp.py``)
on the CPU, against the JAX package's rule and the one-process trainer.

- In process: ``shard_dims`` of the six models of ``tests/test_tp.py`` at
  n_tp 2 and 4 shards the leaves that JAX's ``param_spec`` shards, on the
  dim their sharded axis lands on in the port's layout (the JAX shapes from
  ``jax.eval_shape`` of the init); ``param_spec`` is JAX's on a set of
  shapes; the train CLI's two ``SystemExit`` messages, ``train.py``'s.
- Four processes (gloo, the ``torchrun`` environment variables, a free
  port, each running this file as a script), the (dp 2, tp 2) grid,
  MARN1_onlysp at [9, 4], dropout off: the step equals the one-process
  step at the train-step contract (loss rtol 1e-5; gradients within 1e-3 of
  a tensor's largest entry plus 1e-6 of the step's largest; parameters
  within 2.05 lr), the dead set is onlysp's 38, and each process holds the
  rule's parameter and Adam-state elements; a leaf with one shard's
  gradient all zero is updated where JAX's whole-leaf rule updates it; the
  six models' eval on the gathered weights equals one-process eval at
  JAX's rtol 2e-5, atol 1e-6, and onlysp's ``eval_network`` the
  one-process Acc and F1; ``--infonce`` at weight 1e4 meets the step
  contract; a train-state file resumes at 2 x 2 and refuses another
  layout; ``python -m ser_tpu_torch.train --tp 2 --epoch 1 --batch_size 16
  --synthetic --device cpu`` writes one record.
- Two processes at tp 2 with dropout on: one f32 and one bf16 step, loss
  and gathered parameters bit-equal to the one-process step.
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
from ser_tpu_torch.train import __main__ as train_cli  # noqa: E402
from ser_tpu_torch.train.trainer import ModelTrainer  # noqa: E402

L, B, LR, SEED, N_DP, N_TP = 9, 4, 1e-3, 3, 2, 2
INFONCE = 1e4  # at 0.1 the term's gradients lie below the tolerance
# tests/test_tp.py's models
EVAL_MODELS = ("MARN1_onlysp", "MARN1_nsps", "MARN1_sps", "DialogueRNN", "BiLSTM",
               "MARN_ATV")
EVAL_RTOL, EVAL_ATOL = 2e-5, 1e-6  # tests/test_tp.py's
# two leaves of onlysp the rule shards: the first gets a gradient that is
# zero on one shard only, the second an all-zero one
ZERO_SHARD, ZERO_LEAF = "linear_in.weight", "encoder_l.slf_attn.layer_norm.weight"
WD = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.dropout_rate = model.attn_dropout = 0.0
    return model


def step_batch(rank=0, world=1):
    """The [L, B] step batch, or dp row ``rank``'s rows of it."""
    batch = synthetic_batch(L=L, B=B, seed=0)
    if world == 1:
        return batch
    return EpochLoader([], [], B, process_index=rank, process_count=world)._local_rows(batch)


def eval_items(n=8, seed=3):
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


def eval_loader(rank=0, world=1):
    return EpochLoader(eval_items(), np.arange(8), 4, shuffle=False,
                       process_index=rank, process_count=world)


def eval_logp(trainer):
    """The model's eval log-probabilities of the [L, B] batch, on the
    gathered whole weights."""
    trainer.model.eval()
    with trainer.whole_parameters():
        return trainer.predictor.predict_batch(synthetic_batch(L=L, B=B, seed=4))[0].numpy()


def named_grads(model):
    return {n: None if p.grad is None else p.grad.clone() for n, p in model.named_parameters()}


# -- in process ---------------------------------------------------------------

def _jax_flat_shapes(name):
    """The JAX model's flat parameter names at its init's shapes, as zeros."""
    import jax
    import jax.numpy as jnp

    from ser_tpu.models.registry import get_model_spec as jget_model_spec
    from ser_tpu.train.checkpoint import flatten_params

    spec = jget_model_spec(name)
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(L=4, B=2, seed=0).items()
             if k != "vid"}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: spec.build(6, "IEMOCAP").init(
        {"params": key, "dropout": key}, *spec.make_inputs(batch),
        deterministic=True)["params"])
    return flatten_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))


def _mapped_dim(name, leaf, axis, n_tp):
    """The dim of the port tensor of JAX leaf ``name`` that its axis
    ``axis`` lands on: the port's layout of an index array, chunk for
    chunk."""
    from ser_tpu_torch.compat.from_jax import from_jax_params

    index = np.arange(leaf.size, dtype=np.float32).reshape(leaf.shape)
    ((key, port),) = from_jax_params({name: index}).items()
    port = port.numpy()
    want = [np.sort(c, axis=None) for c in np.split(index, n_tp, axis)]
    dims = [d for d in range(port.ndim) if port.shape[d] % n_tp == 0
            and all(np.array_equal(np.sort(c, axis=None), w)
                    for c, w in zip(np.split(port, n_tp, d), want))]
    assert len(dims) >= 1, (name, leaf.shape, port.shape)
    return key, dims[0]


@pytest.mark.parametrize("n_tp", [2, 4])
@pytest.mark.parametrize("name", EVAL_MODELS)
def test_shard_dims_follow_the_jax_rule(name, n_tp):
    from ser_tpu.parallel.tp import param_spec as jparam_spec
    from ser_tpu_torch.compat.from_jax import from_jax_params
    from ser_tpu_torch.models.registry import build_model
    from ser_tpu_torch.ops.init import generator
    from ser_tpu_torch.parallel import shard_dims

    flat = _jax_flat_shapes(name)
    got = shard_dims(build_model(name, generator(0), 6, "mha"), n_tp)
    assert sorted(got) == sorted(from_jax_params(flat))
    want = {}
    for leaf_name, leaf in flat.items():
        spec = tuple(jparam_spec(leaf, n_tp))
        if "tp" in spec:
            key, dim = _mapped_dim(leaf_name, leaf, spec.index("tp"), n_tp)
        else:
            ((key, _),) = from_jax_params({leaf_name: leaf}).items()
            dim = None
        want[key] = dim
    assert got == want
    assert any(d is not None for d in got.values())


def test_param_spec_is_the_jax_rule():
    from ser_tpu.parallel.tp import param_spec as jparam_spec
    from ser_tpu_torch.parallel import param_spec

    for shape in [(), (1,), (2,), (6,), (8,), (3, 4), (4, 6), (4, 3), (1, 8), (2, 2, 2)]:
        for n_tp in (2, 4):
            assert param_spec(shape, n_tp) == tuple(jparam_spec(np.zeros(shape), n_tp)), (
                shape, n_tp)


@pytest.mark.parametrize("argv,world_,message", [
    (["--tp", "2"], (0, 1), "--tp 2 does not divide 1 devices"),
    (["--tp", "2", "--batch_size", "3"], (0, 4),
     "--tp 2 needs batch_size divisible by 2 data-parallel ways"),
])
def test_cli_refuses_a_layout_as_train_py(argv, world_, message, tmp_path, monkeypatch):
    """``train.py``'s messages, word for word, before any file is written.
    Four processes are stood in for by the CLI's ``world``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(train_cli, "world", lambda: world_)
    with pytest.raises(SystemExit, match=message):
        train_cli.main(train_cli.parser_args(
            ["--synthetic", "--epoch", "1", "--device", "cpu", "--num_workers", "0",
             "--save_path", str(tmp_path / "exp")] + argv))
    assert not list(tmp_path.iterdir())


# -- the process launches -------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(work, n, mode):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(work), mode], cwd=str(work), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
    return sorted(results, key=lambda r: r["rank"])


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process steps, evals and train-state file the processes are
    held to."""
    out = tmp_path_factory.mktemp("one")
    trainer = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None)
    no_dropout(trainer.model)
    acc, f1, _ = trainer.eval_network(eval_loader())
    loss = trainer._train_step_impl(step_batch(), LR).item()
    params = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    grads = named_grads(trainer.model)
    trainer.save_train_state(out / "one.state", 1)
    nce = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None, infonce=INFONCE)
    no_dropout(nce.model)
    nce_loss = nce._train_step_impl(step_batch(), LR).item()
    dropout = {}
    for dtype in ("f32", "bf16"):  # dropout on
        t = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None,
                         compute_dtype=dtype)
        dropout[dtype] = (t._train_step_impl(step_batch(), LR).numpy(),
                          {n: p.detach().numpy().copy() for n, p in t.model.named_parameters()})
    logp = {name: eval_logp(ModelTrainer(device="cpu", seed=SEED, model=name,
                                         res_csv_path=None))
            for name in EVAL_MODELS}
    return dict(loss=loss, params=params, grads=grads, acc=acc, f1=f1,
                state=out / "one.state", nce_loss=nce_loss, nce_grads=named_grads(nce.model),
                dropout=dropout, logp=logp)


@pytest.fixture(scope="module")
def grid(one_process, tmp_path_factory):
    """The four processes of the (2, 2) grid: ``(work dir, results by rank)``."""
    work = tmp_path_factory.mktemp("grid")
    (work / "one.state").write_bytes(one_process["state"].read_bytes())
    return work, _launch(work, N_DP * N_TP, "grid")


@pytest.fixture(scope="module")
def tp_only(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    return work, _launch(work, N_TP, "tp")


def _assert_step_contract(got_loss, got_grads, got_params, want_loss, want_grads, want_params):
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    top = max(g.abs().max().item() for g in want_grads.values() if g is not None)
    assert set(got_grads) == {n for n, g in want_grads.items() if g is not None}
    for name, g in got_grads.items():
        w = want_grads[name].numpy()
        np.testing.assert_array_less(np.abs(g - w), 1e-3 * np.abs(w).max() + 1e-6 * top,
                                     err_msg=name)
    for name, p in got_params.items():
        np.testing.assert_array_less(np.abs(p - want_params[name].numpy()), 2.05 * LR,
                                     err_msg=name)


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind", ["plain", "nce"])
def test_grid_step_meets_the_train_step_contract(one_process, grid, kind):
    work, results = grid
    for r in results:
        got = _load(work / f"{kind}{r['rank']}.npz")
        grads = {k[5:]: v for k, v in got.items() if k.startswith("grad/")}
        params = {k[6:]: v for k, v in got.items() if k.startswith("param/")}
        if kind == "plain":
            _assert_step_contract(r["loss"], grads, params, one_process["loss"],
                                  one_process["grads"], one_process["params"])
        else:
            _assert_step_contract(r["nce_loss"], grads, params, one_process["nce_loss"],
                                  one_process["nce_grads"], one_process["params"])


def test_grid_dead_set_is_onlysps(one_process, grid):
    want = sorted(n for n, g in one_process["grads"].items() if g is None)
    assert len(want) == 38
    for r in grid[1]:
        assert r["dead"] == want


def test_each_process_holds_the_rules_elements(one_process, grid):
    """Parameters: a leaf JAX's ``param_spec`` shards at 1/n_tp of its
    elements, every other whole; Adam's moments the same for the live
    leaves."""
    from ser_tpu.parallel.tp import param_spec as jparam_spec
    from ser_tpu_torch.compat.from_jax import from_jax_params

    flat = _jax_flat_shapes("MARN1_onlysp")
    live = {n for n, g in one_process["grads"].items() if g is not None}
    params = moments = 0
    for name, leaf in flat.items():
        n = leaf.size // N_TP if "tp" in tuple(jparam_spec(leaf, N_TP)) else leaf.size
        params += n
        if next(iter(from_jax_params({name: leaf}))) in live:
            moments += 2 * n
    whole = sum(leaf.size for leaf in flat.values())
    assert params < whole
    for r in grid[1]:
        assert (r["param_elements"], r["moment_elements"]) == (params, moments)
        assert r["param_bytes"] == 4 * params
        assert r["sharded_shape"] == [100 // N_TP, 1024]  # linear_in.weight [100, 1024]


def test_a_zero_shard_of_a_live_leaf_is_updated_as_jax(grid):
    """``ZERO_SHARD``'s gradient is 0 on tp process 0 and 1 on 1, so the
    whole leaf's is not zero and JAX's ``_mask_dead_params`` updates all of
    it; ``ZERO_LEAF``'s is 0 on both, and JAX keeps it. The port's Adam
    moves exactly what JAX's moves, by JAX's amounts."""
    import jax.numpy as jnp
    import optax

    from ser_tpu.train.optim import torch_adam as jtorch_adam

    work, results = grid
    got = _load(work / "zero0.npz")
    params = {n: jnp.asarray(got[f"before/{n}"]) for n in (ZERO_SHARD, ZERO_LEAF)}
    grads = {n: jnp.asarray(got[f"grad/{n}"]) for n in (ZERO_SHARD, ZERO_LEAF)}
    tx = jtorch_adam(weight_decay=WD)
    state = tx.init(params)
    state.hyperparams["learning_rate"] = jnp.float32(LR)
    updates, _ = tx.update(grads, state, params)
    want = optax.apply_updates(params, updates)
    for n in (ZERO_SHARD, ZERO_LEAF):
        before, after, jax_after = got[f"before/{n}"], got[f"after/{n}"], np.asarray(want[n])
        np.testing.assert_array_equal(after != before, jax_after != before, err_msg=n)
        # optax and torch round the update of a parameter near 0.03 one ulp
        # (7.5e-9) apart: JAX's amounts within 1e-5 of lr
        np.testing.assert_allclose(after, jax_after, rtol=0, atol=1e-5 * LR, err_msg=n)
    assert (got[f"after/{ZERO_SHARD}"] != got[f"before/{ZERO_SHARD}"]).all()
    assert (got[f"after/{ZERO_LEAF}"] == got[f"before/{ZERO_LEAF}"]).all()
    for r in results:
        assert r["zero_shard_grad_zero"] == (r["rank"] % N_TP == 0)


@pytest.mark.parametrize("name", EVAL_MODELS)
def test_tp_eval_equals_one_process_eval(one_process, grid, name):
    work, results = grid
    for r in results:
        got = _load(work / f"eval{r['rank']}.npz")[name]
        np.testing.assert_allclose(got, one_process["logp"][name], rtol=EVAL_RTOL,
                                   atol=EVAL_ATOL)


def test_grid_eval_network_gives_the_one_process_metrics(one_process, grid):
    for r in grid[1]:
        assert (r["acc"], r["f1"]) == (one_process["acc"], one_process["f1"])


def test_grid_train_state_round_trip_and_layout(one_process, grid):
    work, results = grid
    for r in results:
        assert r["resumed_epoch"] == 1 and r["resumed_equal"]
        assert "was written by 1 process(es); this run has 4" in r["one_process_file"]
        assert "was written at tp=2; this run has tp=1" in r["dp_only"]
    saved = _load(work / "grid.state")
    assert int(saved["extra/world_size"]) == 4 and int(saved["extra/tp"]) == 2
    one = _load(one_process["state"])
    assert sorted(k for k in saved if not k.startswith("extra/")) == sorted(
        k for k in one if not k.startswith("extra/"))
    for k in one:
        if not k.startswith("extra/"):
            assert saved[k].shape == one[k].shape, k
    with pytest.raises(ValueError, match=r"written by 4 process\(es\); this run has 1"):
        ModelTrainer(device="cpu", seed=SEED, res_csv_path=None).load_train_state(
            work / "grid.state")


def test_grid_train_cli_writes_one_record(grid):
    work, results = grid
    text = (work / "cli" / "score.txt").read_text()
    assert text.count("Model: MARN1_onlysp") == 1
    assert len([line for line in text.splitlines() if " —— epoch 1," in line]) == 1
    assert (work / "cli" / "model" / "model_0001.model").exists()
    rows = (work / "res.csv").read_text().splitlines()
    assert rows[0] == "preds,labels,masks" and len(rows) > 1
    for r in results:
        assert "2-D mesh: dp=2 x tp=2" in r["out"]
        assert f"process {r['rank']}/4: loading 8 of 16 dialogues per batch" in r["out"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_step_with_dropout_is_the_one_process_step(one_process, tp_only, dtype):
    work, results = tp_only
    want_loss, want_params = one_process["dropout"][dtype]
    for r in results:
        got = _load(work / f"dropout_{dtype}{r['rank']}.npz")
        assert got["loss"].view(np.uint32) == want_loss.view(np.uint32)
        assert sorted(k for k in got if k != "loss") == sorted(want_params)
        for name, p in want_params.items():
            assert np.array_equal(got[name].view(np.uint32), p.view(np.uint32)), name


# -- a worker process ---------------------------------------------------------

def _whole_grads(trainer):
    """The live gradients, whole (the shards' gathered)."""
    from ser_tpu_torch.parallel import gather_shards

    named = {n: p.grad for n, p in trainer.model.named_parameters() if p.grad is not None}
    names = [n for n in named if n in trainer.shards]
    with torch.no_grad():
        named.update(zip(names, gather_shards([named[n] for n in names],
                                              [trainer.shards[n] for n in names],
                                              trainer.grid)))
    return named


def _save_step(path, trainer):
    params = trainer._whole_train_state()[0]
    np.savez(path, **{f"grad/{n}": g.numpy() for n, g in _whole_grads(trainer).items()},
             **{f"param/{n}": p.detach().numpy() for n, p in params.items()})


def _grid_worker(work, rank, result):
    import torch.distributed as dist

    trainer = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None, tp=N_TP)
    no_dropout(trainer.model)
    dp_index = trainer.grid.dp_index
    result["acc"], result["f1"], _ = trainer.eval_network(eval_loader(dp_index, N_DP))
    result["loss"] = trainer._train_step_impl(step_batch(dp_index, N_DP), LR).item()
    _save_step(work / f"plain{rank}.npz", trainer)
    result["dead"] = sorted(n for n, p in trainer.model.named_parameters() if p.grad is None)
    result["param_elements"] = sum(p.numel() for p in trainer.model.parameters())
    result["param_bytes"] = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    result["moment_elements"] = sum(s[k].numel() for s in trainer.optimizer.state.values()
                                    for k in ("exp_avg", "exp_avg_sq"))
    result["sharded_shape"] = list(dict(trainer.model.named_parameters())[ZERO_SHARD].shape)

    # one shard of a live leaf with an all-zero gradient, and a leaf all zero
    zero = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None, tp=N_TP)
    named = dict(zero.model.named_parameters())
    before = zero._whole_train_state()[0]
    for p in zero.model.parameters():
        p.grad = None
    named[ZERO_SHARD].grad = torch.full_like(named[ZERO_SHARD], float(zero.grid.tp_index))
    named[ZERO_LEAF].grad = torch.zeros_like(named[ZERO_LEAF])
    result["zero_shard_grad_zero"] = bool((named[ZERO_SHARD].grad == 0).all())
    grads = _whole_grads(zero)
    zero.optimizer.step()
    after = zero._whole_train_state()[0]
    if rank == 0:
        np.savez(work / "zero0.npz", **{f"{k}/{n}": v[n].detach().numpy()
                                        for k, v in (("before", before), ("after", after),
                                                     ("grad", grads))
                                        for n in (ZERO_SHARD, ZERO_LEAF)})

    np.savez(work / f"eval{rank}.npz", **{
        name: eval_logp(ModelTrainer(device="cpu", seed=SEED, model=name,
                                     res_csv_path=None, tp=N_TP))
        for name in EVAL_MODELS})

    nce = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None, tp=N_TP,
                       infonce=INFONCE)
    no_dropout(nce.model)
    result["nce_loss"] = nce._train_step_impl(step_batch(dp_index, N_DP), LR).item()
    _save_step(work / f"nce{rank}.npz", nce)

    trainer.save_train_state(work / "grid.state", 1)
    dist.barrier()
    resumed = ModelTrainer(device="cpu", seed=SEED + 1, lr=LR, res_csv_path=None, tp=N_TP)
    result["resumed_epoch"] = resumed.load_train_state(work / "grid.state")
    result["resumed_equal"] = torch.equal(resumed.generator.get_state(),
                                          trainer.generator.get_state()) and all(
        torch.equal(p, q) for p, q in zip(resumed.model.parameters(),
                                          trainer.model.parameters())) and all(
        torch.equal(resumed.optimizer.state[q][k], trainer.optimizer.state[p][k])
        for p, q in zip(trainer.model.parameters(), resumed.model.parameters())
        if p in trainer.optimizer.state for k in ("exp_avg", "exp_avg_sq", "step"))
    for key, path, kw in (("one_process_file", work / "one.state", dict(tp=N_TP)),
                          ("dp_only", work / "grid.state", dict(dp=True))):
        try:
            ModelTrainer(device="cpu", seed=SEED, res_csv_path=None, **kw).load_train_state(path)
            result[key] = "loaded"
        except ValueError as e:
            result[key] = str(e)

    train_cli.main(train_cli.parser_args(
        ["--tp", str(N_TP), "--epoch", "1", "--batch_size", "16", "--synthetic", "--device",
         "cpu", "--num_workers", "0", "--save_path", str(work / "cli")]))


def _tp_worker(work, rank, result):
    for dtype in ("f32", "bf16"):  # dropout on
        t = ModelTrainer(device="cpu", seed=SEED, lr=LR, res_csv_path=None, tp=N_TP,
                         compute_dtype=dtype)
        loss = t._train_step_impl(step_batch(), LR).numpy()
        params = t._whole_train_state()[0]
        np.savez(work / f"dropout_{dtype}{rank}.npz", loss=loss,
                 **{n: p.detach().numpy() for n, p in params.items()})


def _worker(work: Path, mode: str) -> None:
    """One process of a launch (the module docstring)."""
    import torch.distributed as dist

    from ser_tpu_torch.parallel import initialize_distributed, world

    torch.set_num_threads(1)
    initialize_distributed("cpu")
    rank = world()[0]
    result = {"rank": rank}
    (_grid_worker if mode == "grid" else _tp_worker)(work, rank, result)
    print("RESULT " + json.dumps(result), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), sys.argv[2])
