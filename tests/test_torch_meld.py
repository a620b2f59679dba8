"""MELD in the port against the JAX package, on the CPU: 9 parties, 3 or 7
classes.

- ``generate_meld_pickles`` writes the JAX generator's pickles byte for
  byte; ``MELDDataset`` items and ``get_loaders(dataset="MELD")`` batches
  equal the JAX package's field by field, in the same order, at 7 and 3
  classes; 6 classes raise on both sides; after ``advance_epochs(n)`` the
  loaders shuffle as the JAX loader does after its ``advance_epochs(n)``.
- The whole eval forward at P = 9 with 1324-wide inputs, variable lengths, a
  dialogue of length 1 and a fully padded row, weights from a JAX init
  through ``from_jax_params``: log-probs at rtol 1e-3, atol 1e-4 (the
  port's logit contract). The port runs its plain recurrence here; the JAX
  package runs P = 9 through ``lax.scan``.
- One train step at [9, 3], P = 9, 7 classes, dropout off, against the JAX
  trainer's, under ``tests/test_torch_train_step.py``'s contract, with the
  constant-initialised parameters made random on both sides
  (``randomize_constants`` says why).
- ``python -m ser_tpu_torch.predict --dataset MELD`` on generated pickles
  and a JAX checkpoint: its JSON and ``res.csv`` equal the JAX
  ``predict.py``'s byte for byte.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predict as jpredict
from ser_tpu.data import loaders as jloaders
from ser_tpu.data import synthetic as jsynthetic
from ser_tpu.data.datasets import MELDDataset as JMELDDataset
from ser_tpu.models.marn_onlysp import MARN1OnlySP as JMARN1OnlySP
from ser_tpu.train.checkpoint import flatten_params, save_parameters, unflatten_into
from ser_tpu_torch import predict as tpredict
from ser_tpu_torch.compat.from_jax import from_jax_params
from ser_tpu_torch.data import loaders as tloaders
from ser_tpu_torch.data import synthetic as tsynthetic
from ser_tpu_torch.data.datasets import MELDDataset
from ser_tpu_torch.models.registry import get_model_spec
from ser_tpu_torch.serving import Predictor
from test_torch_train_step import LR, grad_tolerance, port_grads, run_step

SMALL = dict(n_train=10, n_test=3, min_len=3, max_len=9, seed=4)
PICKLES = ("MELD_features_raw.pkl", "meld_features_roberta.pkl")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The train step is thousands of small eager ops: one intra-op thread
    runs them faster while other test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def feature_paths(tmp_path_factory):
    """``(port's, JAX package's)`` feature path prefixes, same arguments."""
    return (tsynthetic.generate_meld_pickles(str(tmp_path_factory.mktemp("tm")), **SMALL),
            jsynthetic.generate_meld_pickles(str(tmp_path_factory.mktemp("jm")), **SMALL))


def _assert_same(a, b, where):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("name", PICKLES)
def test_meld_pickles_equal_the_jax_generators(feature_paths, name):
    ours, theirs = (open(p + "MELD_features/" + name, "rb").read() for p in feature_paths)
    assert ours == theirs


@pytest.mark.parametrize("n_classes", [7, 3])
def test_meld_items_equal_the_jax_packages(feature_paths, n_classes):
    path = feature_paths[0] + "MELD_features/MELD_features_raw.pkl"
    for train in (True, False):
        ours = MELDDataset(path, n_classes, train=train)
        theirs = JMELDDataset(path, n_classes, train=train)
        assert len(ours) == len(theirs) == (SMALL["n_train"] if train else SMALL["n_test"])
        for i in range(len(ours)):
            item = ours[i]
            _assert_same(item, theirs[i], f"item {i}")
            assert len(item) == 10
            T = item[8].shape[0]
            assert [f.shape for f in item[4:7]] == [(T, 600), (T, 300), (T, 9)]
            assert item[8].max() < n_classes


def test_meld_refuses_six_classes(feature_paths):
    path = feature_paths[0] + "MELD_features/MELD_features_raw.pkl"
    for cls in (MELDDataset, JMELDDataset):
        with pytest.raises(ValueError, match="3 or 7 classes"):
            cls(path, 6)


@pytest.mark.parametrize("n_classes", [7, 3])
def test_meld_loader_batches_equal_the_jax_packages(feature_paths, n_classes):
    kw = dict(dataset="MELD", batch_size=4, valid=0.2, n_classes=n_classes, seed=3)
    ours = tloaders.get_loaders(feature_paths[0], **kw)
    theirs = jloaders.get_loaders(feature_paths[0], **kw)
    for split, o, t in zip(("train", "valid", "test"), ours, theirs):
        assert len(o) == len(t) and o.num_examples() == t.num_examples()
        for epoch in range(2):  # the second epoch reshuffles
            batches = list(zip(o, t))
            assert len(batches) == len(o)
            for i, (ob, tb) in enumerate(batches):
                assert ob["qmask"].shape[1:] == (4, 9) and ob["acouf"].shape[2] == 300
                _assert_same(ob, tb, f"{split} epoch {epoch} batch {i}")


@pytest.mark.parametrize("n", [1, 3])
def test_advance_epochs_shuffles_as_the_jax_loader(feature_paths, n):
    """After ``advance_epochs(n)`` the port's train loader, bare and behind
    ``PrefetchLoader``, yields the JAX loader's order after its own
    ``advance_epochs(n)``: the order a loader gives in its epoch n + 1."""
    kw = dict(dataset="MELD", batch_size=3, valid=0.2, n_classes=7, seed=5)
    vids = lambda loader: [v for b in loader for v in b["vid"]]
    theirs = jloaders.get_loaders(feature_paths[0], **kw)[0]
    theirs.advance_epochs(n)
    want = vids(theirs)
    unstopped = tloaders.get_loaders(feature_paths[0], **kw)[0]
    for _ in range(n):
        vids(unstopped)
    assert vids(unstopped) == want
    bare = tloaders.get_loaders(feature_paths[0], **kw)[0]
    bare.advance_epochs(n)
    prefetch = tloaders.PrefetchLoader(tloaders.get_loaders(feature_paths[0], **kw)[0])
    prefetch.advance_epochs(n)
    assert vids(bare) == vids(prefetch) == want


def _p9_inputs(n_classes):
    """A MELD-shaped request at [14, 4]: 1324-wide x, a 9-party one-hot
    qmask, lengths 14, 9, 1 and 0 (a fully padded row)."""
    L, lengths = 14, np.array([14, 9, 1, 0])
    batch = tsynthetic.synthetic_batch(L=L, B=4, n_classes=n_classes, seed=9,
                                       d_audio=300, d_visual=600, n_parties=9)
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    rng = np.random.default_rng(10)
    qmask = np.eye(9, dtype=np.float32)[rng.integers(0, 9, size=(L, 4))]
    batch["qmask"] = qmask * umask.T[:, :, None]
    batch["umask"] = umask
    for k in ("r1", "r2", "r3", "r4", "visuf", "acouf"):
        batch[k] = batch[k] * umask.T[:, :, None]
    return get_model_spec("MARN1_onlysp").make_inputs(batch)


@pytest.mark.parametrize("n_classes", [7, 3])
def test_eval_at_nine_parties_matches_jax(n_classes):
    x, qmask, umask = _p9_inputs(n_classes)
    assert x.shape == (14, 4, 1324) and qmask.shape == (14, 4, 9)
    model = JMARN1OnlySP(n_classes=n_classes)
    key = jax.random.PRNGKey(2)
    jx = tuple(map(jnp.asarray, (x, qmask, umask)))
    params = model.init({"params": key, "dropout": key}, *jx,
                        deterministic=True)["params"]
    ref = np.asarray(model.apply({"params": params}, *jx, deterministic=True)[0])
    pred = Predictor(state_dict=from_jax_params(flatten_params(params)),
                     device="cpu", n_classes=n_classes)
    logp, labels = pred.predict(x, qmask, umask)
    assert logp.shape == (4 * 14, n_classes) and labels.shape == (4, 14)
    assert torch.isfinite(logp).all()  # the fully padded row too
    valid = umask.reshape(-1) > 0
    assert valid.sum() == 24
    np.testing.assert_allclose(logp.numpy()[valid], ref[valid], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(labels.numpy().reshape(-1)[valid],
                                  ref.argmax(-1)[valid])


def randomize_constants(params):
    """Seeded random values for the parameters the reference initialises to
    a constant (the sequence attentions' W, the rank-1 wq and wk, LayerNorm,
    the fusion scalars), as ``chip_smoke.py::randomize_constants`` gives
    them: a matrix N(0, 1/fan_in), the rest its constant plus 0.1 N(0, 1).
    At the reference's init the fusion scalars' gradients are cancelling
    sums: at P = 9 the JAX package's f32 gradient of ``v`` lies 3.3e-6 from
    an f64 step, beyond the contract's 3.2e-6 floor, while the port's lies
    1e-6 from it. A trained model has no such constants."""
    rng = np.random.default_rng(1)
    flat = flatten_params(params)
    for name, value in flat.items():
        if value.size > 1 and value.std() > 0:
            continue
        flat[name] = (rng.standard_normal(value.shape) / np.sqrt(value.shape[0])
                      if value.ndim == 2 and value.shape[0] > 1
                      else value + 0.1 * rng.standard_normal(value.shape)
                      ).astype(np.float32)
    return unflatten_into(params, flat)


@pytest.fixture(scope="module")
def meld_step(tmp_path_factory):
    batch = tsynthetic.synthetic_batch(L=9, B=3, n_classes=7, seed=0, min_len=4,
                                       d_audio=300, d_visual=600, n_parties=9)
    assert batch["qmask"].shape == (9, 3, 9)
    return run_step(str(tmp_path_factory.mktemp("meld_step") / "res.csv"), batch,
                    n_classes=7, init=randomize_constants)


def test_train_step_at_nine_parties_loss(meld_step):
    np.testing.assert_allclose(meld_step["loss"].item(), meld_step["jloss"], rtol=1e-5)


def test_train_step_at_nine_parties_gradients(meld_step):
    grads = port_grads(meld_step["pt"].model)
    assert sorted(grads) == sorted(meld_step["jgrads"])
    tol = grad_tolerance(meld_step["jgrads"])
    for name, g in grads.items():
        if g is not None:
            want = np.asarray(meld_step["jgrads"][name])
            np.testing.assert_array_less(np.abs(g - want), tol[name], err_msg=name)


def test_train_step_at_nine_parties_dead_set(meld_step):
    grads = port_grads(meld_step["pt"].model)
    dead = {n for n, g in grads.items() if g is None}
    jax_zero = {n for n, g in meld_step["jgrads"].items() if not np.any(np.asarray(g))}
    assert dead == jax_zero and len(dead) == 38


def test_train_step_at_nine_parties_updates(meld_step):
    from ser_tpu_torch.compat.from_jax import to_jax_params

    after = to_jax_params(meld_step["pt"].model.state_dict())
    assert after["nn_out_3/kernel"].shape == (32, 7)
    for name, want in meld_step["new_params"].items():
        np.testing.assert_array_less(np.abs(after[name] - np.asarray(want)), 2.05 * LR,
                                     err_msg=name)


def _last_json(out: str) -> dict:
    lines = out.splitlines()
    start = len(lines) - 1 - lines[::-1].index("{")
    return json.loads("\n".join(lines[start:]))


@pytest.mark.parametrize("n_classes", [7, 3])
def test_predict_cli_on_meld_matches_jax(feature_paths, n_classes, tmp_path, capsys):
    x, qmask, umask = _p9_inputs(n_classes)
    key = jax.random.PRNGKey(6)
    params = JMARN1OnlySP(n_classes=n_classes).init(
        {"params": key, "dropout": key}, *map(jnp.asarray, (x, qmask, umask)),
        deterministic=True)["params"]
    ckpt = str(tmp_path / "meld.npz")
    save_parameters(params, ckpt)
    common = ["--initial_model", ckpt, "--feature_path", feature_paths[0],
              "--dataset", "MELD", "--n_classes", str(n_classes), "--batch_size", "4"]
    jpredict.main(common + ["--res_csv", str(tmp_path / "jax.csv")])
    theirs = _last_json(capsys.readouterr().out)
    tpredict.main(common + ["--res_csv", str(tmp_path / "torch.csv"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "is not in the model" not in out and "Wrong parameter" not in out
    ours = _last_json(out)
    assert ours.pop("res_csv") == str(tmp_path / "torch.csv")
    assert theirs.pop("res_csv") == str(tmp_path / "jax.csv")
    assert ours == theirs and ours["n_examples"] == SMALL["n_test"]
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
