"""``--infonce``, the extra losses and ``--debug_nans`` in the port against
the JAX package, on the CPU.

- ``masked_mse_loss``, ``unmasked_weighted_nll_loss`` (its unweighted raw
  sum too) and ``info_nce`` under every negative mode and reduction, on the
  same numpy inputs, at rtol 1e-5;
- ``ModelSpec.feature_outputs`` equal to the JAX registry's for all 15
  names;
- the trainer's term, held to the contract of ``tests/test_infonce_hook.py``
  for MARN1_onlysp and MARN1_newz: from one generator state, a step's loss
  with weight 0.5 less the loss without it is 0.5·``info_nce`` of that
  forward's features; for each of the seven models without feature outputs
  the JAX trainer's skip line and a loss equal to the one without the term;
- one ``--infonce`` train step of MARN1_onlysp and MARN1_newz (the latter
  from ``randomize_constants``) against the JAX trainer's with the same
  weight, under ``tests/test_torch_train_step.py``'s contract: the loss,
  every gradient, the dead set and the Adam update. That holds the
  ``[L, B, D]`` to ``[B, L·D]`` flattening and newz's ``(x_a, x_l)`` order to
  ``ser_tpu/train/trainer.py``. The query is its own positive, so the term
  is the negatives' share of the softmax, about 1.4e-4 at [9, 3]: at the
  reference's 0.1 it would lie far below the gradients' tolerance. The
  steps take weight ``STEP_W`` = 1e4, at which the term is a third of the
  loss or more, and a test pins that it moves the gradients well past
  their tolerance;
- ``--debug_nans``: a NaN in one valid row's ``acouf`` raises
  ``FloatingPointError`` in the first train step of both packages, a NaN
  that only the backward makes raises it too, a step on finite data is
  bit-equal with the checks on and off, and the train CLI under the three
  flags writes a checkpoint with the zoo's parameters.

``jax_debug_nans`` and the port's checks are process-global, and ``--dist
loadfile`` shares a worker's process between files, so fixtures turn both
off and ``ser_tpu.config.ENCODER_ATTENTION`` back to ``"mha"``. One intra-op
thread in the train cases, as the other train test files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu import config
from ser_tpu.models.registry import available_models, get_model_spec as jget_model_spec
from ser_tpu.train import losses as jlosses
from ser_tpu_torch.compat.from_jax import from_jax_params, to_jax_params
from ser_tpu_torch.data.synthetic import generate_iemocap_pickles, synthetic_batch
from ser_tpu_torch.models.registry import build_model, get_model_spec
from ser_tpu_torch.train import __main__ as train_cli
from ser_tpu_torch.train import losses
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.train.trainer import ModelTrainer
from ser_tpu_torch.utils import profiling
from test_torch_marn_rest_train import port_grads
from test_torch_meld import randomize_constants
from test_torch_train_step import grad_tolerance, no_dropout, run_step

LR = 1e-3
NO_FEATURES = ("MARN1_azs", "MARN1_mf", "MARN1_la", "MARN", "MARN_AT", "MARN_ATV",
               "DialogueRNN")


@pytest.fixture(autouse=True)
def restore_globals():
    yield
    config.ENCODER_ATTENTION = "mha"
    jax.config.update("jax_debug_nans", False)
    profiling.enable_nan_checks(False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("mode", ["unpaired", "paired", "in_batch"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_info_nce_matches_jax(mode, reduction):
    q, p, neg_u, neg_p = _rng_arrays(7, (5, 12), (5, 12), (9, 12), (5, 4, 12))
    neg = {"unpaired": neg_u, "paired": neg_p, "in_batch": None}[mode]
    neg_mode = "paired" if mode == "paired" else "unpaired"
    want = jlosses.info_nce(jnp.asarray(q), jnp.asarray(p),
                            None if neg is None else jnp.asarray(neg),
                            negative_mode=neg_mode, reduction=reduction)
    got = losses.info_nce(torch.from_numpy(q), torch.from_numpy(p),
                          None if neg is None else torch.from_numpy(neg),
                          negative_mode=neg_mode, reduction=reduction)
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_info_nce_refuses_an_unknown_mode():
    q, = _rng_arrays(1, (3, 4))
    t = torch.from_numpy(q)
    with pytest.raises(ValueError, match="unknown negative_mode: pairs"):
        losses.info_nce(t, t, t, negative_mode="pairs")


def test_masked_mse_loss_matches_jax():
    pred, target = _rng_arrays(3, (20,), (20,))
    mask = (np.arange(20) % 3 != 0).astype(np.float32)
    want = jlosses.masked_mse_loss(*map(jnp.asarray, (pred, target, mask)))
    got = losses.masked_mse_loss(*map(torch.from_numpy, (pred, target, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_unmasked_weighted_nll_loss_matches_jax(weighted):
    logits, = _rng_arrays(4, (15, 6))
    logp = np.asarray(jax.nn.log_softmax(logits, -1))
    target = np.random.default_rng(5).integers(0, 6, 15)
    weight = np.linspace(0.5, 2.0, 6).astype(np.float32) if weighted else None
    want = jlosses.unmasked_weighted_nll_loss(
        jnp.asarray(logp), jnp.asarray(target), None if weight is None else jnp.asarray(weight))
    got = losses.unmasked_weighted_nll_loss(
        torch.from_numpy(logp), torch.from_numpy(target),
        None if weight is None else torch.from_numpy(weight))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    if not weighted:  # the raw sum, no normalisation
        np.testing.assert_allclose(got.numpy(), -logp[np.arange(15), target].sum(), rtol=1e-5)


@pytest.mark.parametrize("name", available_models())
def test_feature_outputs_is_the_jax_registrys(name):
    assert get_model_spec(name).feature_outputs == jget_model_spec(name).feature_outputs


def _trainer(name, **kw):
    return ModelTrainer(device="cpu", model=name, seed=111, lr=LR, res_csv_path=None, **kw)


@pytest.mark.parametrize("name", ["MARN1_onlysp", "MARN1_newz"])
def test_infonce_term_changes_loss_and_matches_formula(name):
    """``tests/test_infonce_hook.py``'s contract: from one generator state,
    the step's loss with weight 0.5 less the loss without it is 0.5 times
    ``info_nce(q, q, neg, "unpaired")`` of that forward's features
    (dropout on, the same masks on both sides)."""
    batch = synthetic_batch(L=6, B=3, seed=5)
    base, with_nce = _trainer(name), _trainer(name, infonce=0.5)
    # the term of the forward both steps will run, from a copy of the
    # generator's state
    g = torch.Generator().set_state(base.generator.get_state())
    base.model.train()
    x, qmask, umask = base.predictor.batch_inputs(batch)
    with torch.no_grad():
        aux = 0.5 * ModelTrainer.infonce_term(base.model(x, qmask, umask, generator=g)).item()
    l0 = base._train_step_impl(batch, LR).item()
    l1 = with_nce._train_step_impl(batch, LR).item()
    assert np.isfinite(l0) and np.isfinite(l1) and aux > 0
    np.testing.assert_allclose(l1 - l0, aux, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", NO_FEATURES)
def test_infonce_skipped_for_models_without_features(name, capsys):
    assert not get_model_spec(name).feature_outputs
    batch = synthetic_batch(L=5, B=2, seed=6)
    plain = _trainer(name)._train_step_impl(batch, LR)
    capsys.readouterr()
    t = _trainer(name, infonce=1.0)
    assert (f"[infonce] {name} has no modality-feature outputs; the InfoNCE term is "
            "skipped") in capsys.readouterr().out
    torch.testing.assert_close(t._train_step_impl(batch, LR), plain, rtol=0, atol=0)


def test_infonce_term_is_the_jax_trainers_formula():
    """``ModelTrainer.infonce_term`` against ``ser_tpu/train/trainer.py``'s
    lines: L and B swapped, each dialogue flattened, ``out[1]`` the query and
    positive, ``out[2]`` the negatives. The features have few dimensions and
    each dialogue's two lie close, so their cosines are large and swapping
    the roles or flattening without the swap changes the value by percents."""
    f1, noise = _rng_arrays(11, (3, 5, 2), (3, 5, 2))
    f2 = f1 + 0.5 * noise
    q = jnp.swapaxes(jnp.asarray(f1), 0, 1).reshape(5, -1)
    neg = jnp.swapaxes(jnp.asarray(f2), 0, 1).reshape(5, -1)
    want = float(jlosses.info_nce(q, q, neg, negative_mode="unpaired"))
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    np.testing.assert_allclose(ModelTrainer.infonce_term((None, t1, t2)).item(), want,
                               rtol=1e-5)
    for other in (ModelTrainer.infonce_term((None, t2, t1)).item(),
                  losses.info_nce(t1.reshape(5, -1), t1.reshape(5, -1),
                                  t2.reshape(5, -1)).item()):
        assert abs(other - want) > 5e-3 * want


@pytest.mark.parametrize("name", ["MARN1_onlysp", "MARN1_newz", "BiLSTM"])
def test_feature_outputs_are_jaxs_in_order(name):
    """The features the term reads, ``out[1]`` and ``out[2]`` ``[L, B, D]``,
    are the JAX model's at the same index (newz's ``(x_a, x_l)``), padded
    positions included, at the port's logit tolerance."""
    from ser_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
    from ser_tpu.train.checkpoint import flatten_params

    spec = jget_model_spec(name)
    batch = jsynthetic_batch(L=6, B=2, seed=4)
    batch["umask"][1, 4:] = 0.0
    args = spec.make_inputs({k: jnp.asarray(v) for k, v in batch.items() if k != "vid"})
    model = spec.build(6, "IEMOCAP")
    key = jax.random.PRNGKey(1)
    params = model.init({"params": key, "dropout": key}, *args, deterministic=True)["params"]
    want = model.apply({"params": params}, *args, deterministic=True)
    port = build_model(name, generator(0)).eval()
    port.load_state_dict(from_jax_params(flatten_params(params)), strict=True)
    with torch.no_grad():
        got = port(*(torch.tensor(np.asarray(a)) for a in args))
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-3, atol=1e-4,
                                   err_msg=f"out[{i}]")


STEP_W = 1e4
STEP_INIT = {"MARN1_onlysp": None, "MARN1_newz": randomize_constants}
# the parameters outside the loss's graph: onlysp's 38 (as without the
# term); newz's 26 (encoder_v, fc, g_attention.trans, the pos_ffn.fc)
STEP_DEAD = {"MARN1_onlysp": 38, "MARN1_newz": 26}


@pytest.fixture(scope="module")
def nce_steps(tmp_path_factory):
    """``run_step``'s result for each model with ``infonce=STEP_W``, and the
    port's plain step from the same weights (its loss and gradients), made
    at first use."""
    cache = {}

    def get(name):
        if name not in cache:
            res_csv = str(tmp_path_factory.mktemp(name) / "res.csv")
            step = run_step(res_csv, model=name, init=STEP_INIT[name], infonce=STEP_W)
            plain = ModelTrainer(device="cpu", model=name, seed=3, lr=LR, res_csv_path=None)
            plain.model.load_state_dict(from_jax_params(step["params"]), strict=True)
            no_dropout(plain.model)
            step["plain_loss"] = plain._train_step_impl(step["batch"], LR).item()
            step["plain_grads"] = port_grads(plain.model)
            cache[name] = step
        return cache[name]
    return get


@pytest.mark.parametrize("name", STEP_INIT)
def test_infonce_step_loss_matches_jax(nce_steps, name):
    step = nce_steps(name)
    np.testing.assert_allclose(step["loss"].item(), step["jloss"], rtol=1e-5)
    term = step["loss"].item() - step["plain_loss"]
    assert term > 0.3 * step["plain_loss"]  # the term is no rounding-level share


@pytest.mark.parametrize("name", STEP_INIT)
def test_infonce_step_gradients_match_jax(nce_steps, name):
    step = nce_steps(name)
    grads = port_grads(step["pt"].model)
    assert sorted(grads) == sorted(step["jgrads"])
    tol = grad_tolerance(step["jgrads"])
    for n, g in grads.items():
        if g is not None:
            np.testing.assert_array_less(np.abs(g - np.asarray(step["jgrads"][n])), tol[n],
                                         err_msg=n)
    # the term moves the encoders' gradients far past the tolerance
    moved = {n for n, g in grads.items() if g is not None and step["plain_grads"][n] is not None
             and np.abs(g - step["plain_grads"][n]).max() > 10 * tol[n]}
    assert any(n.startswith("encoder_l/") for n in moved), sorted(moved)
    assert any(n.startswith("encoder_a/") for n in moved), sorted(moved)


@pytest.mark.parametrize("name", STEP_INIT)
def test_infonce_step_dead_set_is_jaxs(nce_steps, name):
    step = nce_steps(name)
    dead = {n for n, g in port_grads(step["pt"].model).items() if g is None}
    assert dead == {n for n, g in step["jgrads"].items() if not np.any(np.asarray(g))}
    assert len(dead) == STEP_DEAD[name]


@pytest.mark.parametrize("name", STEP_INIT)
def test_infonce_step_updates_within_two_lr(nce_steps, name):
    step = nce_steps(name)
    after = to_jax_params(step["pt"].model.state_dict())
    for n, want in step["new_params"].items():
        np.testing.assert_array_less(np.abs(after[n] - np.asarray(want)), 2.05 * LR, err_msg=n)
    for n, g in port_grads(step["pt"].model).items():  # dead ones did not move
        if g is None:
            np.testing.assert_array_equal(after[n], np.asarray(step["params"][n]))


def _nan_batch():
    batch = synthetic_batch(L=5, B=2, seed=8)
    batch["acouf"][1, 0, 3] = np.nan  # a valid row of dialogue 0
    assert batch["umask"][0, 1] == 1
    return batch


def test_debug_nans_raises_in_the_first_step_of_both_packages():
    from ser_tpu.train.trainer import ModelTrainer as JModelTrainer
    from ser_tpu.train.trainer import _device_batch

    batch = _nan_batch()
    jax.config.update("jax_debug_nans", True)
    jt = JModelTrainer(model="MARN1_onlysp", seed=3, res_csv_path=None)
    with pytest.raises(FloatingPointError):
        jt._train_step(jt.params, jt.opt_state, _device_batch(batch), jnp.float32(LR),
                       jax.random.PRNGKey(0))
    profiling.enable_nan_checks(True)
    with pytest.raises(FloatingPointError, match="the forward's outputs"):
        _trainer("MARN1_onlysp")._train_step_impl(batch, LR)
    profiling.enable_nan_checks(False)  # without the checks the step goes on
    assert not np.isfinite(_trainer("MARN1_onlysp")._train_step_impl(batch, LR).item())


def test_debug_nans_catches_a_nan_only_the_backward_makes():
    w = torch.zeros(3, requires_grad=True)
    loss = (torch.sqrt(w) * 0).sum()  # finite forward, 0 * inf in the backward
    profiling.enable_nan_checks(True)
    profiling.check_finite("the loss", loss)
    with pytest.raises(FloatingPointError, match="nan"):
        profiling.backward(loss)


def test_debug_nans_changes_no_number():
    batch = synthetic_batch(L=6, B=3, seed=9)
    trainers = [_trainer("MARN1_onlysp", encoder_attention="muse", infonce=0.1)
                for _ in range(2)]
    profiling.enable_nan_checks(True)
    checked = trainers[0]._train_step_impl(batch, LR)
    profiling.enable_nan_checks(False)
    plain = trainers[1]._train_step_impl(batch, LR)
    torch.testing.assert_close(checked, plain, rtol=0, atol=0)
    for (name, a), b in zip(trainers[0].model.state_dict().items(),
                            trainers[1].model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_train_cli_takes_the_three_flags(tmp_path, capsys, monkeypatch):
    feats = generate_iemocap_pickles(str(tmp_path / "feats"), seed=1, n_train=6, n_test=3,
                                     min_len=3, max_len=8)
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "exp"
    train_cli.main(train_cli.parser_args([
        "--feature_path", feats, "--epoch", "1", "--batch_size", "4", "--num_workers", "0",
        "--save_path", str(exp), "--device", "cpu", "--encoder_attention", "external",
        "--infonce", "0.1", "--debug_nans"]))
    out = capsys.readouterr().out
    assert "Encoder self-attention: external (attention-zoo surface)" in out
    assert not profiling.nan_checks_enabled()  # the caller's setting restored
    with np.load(exp / "model" / "model_0001.model") as z:
        assert {"encoder_l/slf_attn/op/mk", "encoder_a/slf_attn/op/mv"} <= set(z.files)
    assert "Fscore" in (exp / "score.txt").read_text()


def test_profiling_trace_annotate_and_step_timer(tmp_path):
    """``utils/profiling.py``'s trace, as the JAX module's: a trace of an
    annotated region written under its directory, the span in it."""
    with profiling.trace(str(tmp_path / "trace")):
        for _ in range(2):
            with profiling.annotate("ser#forward"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    (written,) = (tmp_path / "trace").iterdir()
    assert written.read_text().count('"ser#forward"') >= 2
