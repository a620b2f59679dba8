"""One train step of DialogueRNN, BiLSTM, MARN, MARN_AT and MARN_ATV against
the JAX package's, on the CPU, and their train-mode dropouts.

At full width, [9, 3]: the same JAX-initialised weights on both sides
through ``from_jax_params``, the parameters the reference initialises to a
constant re-seeded on both sides (``tests/test_torch_meld.py::
randomize_constants``), dropout off on both sides
(``tests/test_torch_train_step.py::run_step``). The contract is PERF.md
§2's: the loss at rtol 1e-5; every gradient within 1e-3 of its tensor's
largest entry plus 1e-6 of the step's largest; the port's dead set
(``.grad`` None) equal to the JAX package's all-zero set; the updated
parameters within 2.05 lr. The probability-output models' loss is the same
masked loss (log-softmax of the probabilities), and MARN_AT's and
MARN_ATV's labels and mask go time-major, as the JAX trainer's
``_flat_targets`` orders them.

With dropout on: a train forward is finite, reproducible from the
generator's seed and, but for MARN (whose path has no dropout), differs
from eval; DialogueRNN's four dropouts a step keep 0.9 of their draws and
MARN_AT's one a step 0.7, within 6 standard deviations. A MELD label 6
adds 0 to BiLSTM's loss at 7 classes (its 6 outputs are fewer), and raises
for MARN at 6 classes. One intra-op thread, as the other train test files.
"""

import numpy as np
import pytest
import torch

from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.models import dialogue_rnn, hybrid_rnn
from ser_tpu_torch.models.registry import build_model, get_model_spec
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.train.trainer import ModelTrainer
from test_torch_marn_rest_train import port_grads
from test_torch_meld import randomize_constants
from test_torch_train_step import LR, grad_tolerance, no_dropout, run_step

MODELS = ("DialogueRNN", "BiLSTM", "MARN", "MARN_AT", "MARN_ATV")
L, B = 9, 3
# the JAX package's all-zero gradients of a step: the parameters the
# reference declares and never uses (the encoders' pos_ffn.fc; MARN's whole
# attention form: LSTHMs, att, reduces, fc and both encoders)
DEAD = {"DialogueRNN": 0, "BiLSTM": 4, "MARN": 50, "MARN_AT": 4, "MARN_ATV": 6}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """``run_step``'s result for each model, made at first use."""
    cache = {}

    def get(name):
        if name not in cache:
            res_csv = str(tmp_path_factory.mktemp(name) / "res.csv")
            cache[name] = run_step(res_csv, model=name, init=randomize_constants)
        return cache[name]
    return get


@pytest.mark.parametrize("name", MODELS)
def test_loss_matches_jax(steps, name):
    step = steps(name)
    np.testing.assert_allclose(step["loss"].item(), step["jloss"], rtol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_every_gradient_matches_jax(steps, name):
    step = steps(name)
    grads = port_grads(step["pt"].model)
    assert sorted(grads) == sorted(step["jgrads"])
    tol = grad_tolerance(step["jgrads"])
    for key, g in grads.items():
        if g is not None:
            want = np.asarray(step["jgrads"][key])
            assert g.shape == want.shape, key
            np.testing.assert_array_less(np.abs(g - want), tol[key], err_msg=key)


@pytest.mark.parametrize("name", MODELS)
def test_dead_set_is_jaxs_all_zero_set(steps, name):
    step = steps(name)
    grads = port_grads(step["pt"].model)
    dead = {n for n, g in grads.items() if g is None}
    jax_zero = {n for n, g in step["jgrads"].items() if not np.any(np.asarray(g))}
    assert dead == jax_zero
    assert len(dead) == DEAD[name]


@pytest.mark.parametrize("name", MODELS)
def test_updated_parameters_within_two_lr(steps, name):
    step = steps(name)
    after = _to_jax(step["pt"].model)
    for key, want in step["new_params"].items():
        np.testing.assert_array_less(np.abs(after[key] - np.asarray(want)), 2.05 * LR,
                                     err_msg=key)
    for key, g in port_grads(step["pt"].model).items():  # dead ones did not move
        if g is None:
            np.testing.assert_array_equal(after[key], np.asarray(step["params"][key]))


def _to_jax(model):
    from ser_tpu_torch.compat.from_jax import to_jax_params

    return to_jax_params(model.state_dict())


def _inputs(name, seed=1):
    batch = synthetic_batch(L=L, B=B, seed=seed, min_len=4)
    return tuple(map(torch.as_tensor, get_model_spec(name).make_inputs(batch)))


@pytest.mark.parametrize("name", MODELS)
def test_train_forward_is_seeded_and_differs_from_eval(name):
    spec = get_model_spec(name)
    model = build_model(name, generator(0)).train()
    inputs = _inputs(name)
    run = lambda seed: spec.extract_logp(  # noqa: E731
        model(*inputs, generator=torch.Generator().manual_seed(seed)))
    a, b, c = run(5), run(5), run(6)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    model.eval()
    e = spec.extract_logp(model(*inputs))
    if name == "MARN":  # no dropout on its path
        torch.testing.assert_close(a, e, rtol=0, atol=0)
        torch.testing.assert_close(c, e, rtol=0, atol=0)
    else:
        assert not torch.equal(a, c) and not torch.equal(a, e)
    model.train()
    no_dropout(model)
    torch.testing.assert_close(spec.extract_logp(model(*inputs, generator=torch.Generator())),
                               e, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="eval"):
        model(*inputs)


@pytest.mark.parametrize("name, module, per_step, p", [
    ("DialogueRNN", dialogue_rnn, 4, 0.1), ("MARN_AT", hybrid_rnn, 1, 0.3)])
def test_kept_fractions_of_the_loop_dropouts(name, module, per_step, p, monkeypatch):
    """The recurrence's dropouts a step (DialogueRNN: g, the party rows,
    the listener rows, e; MARN_AT: after fc's ReLU) keep 1 - p of their
    draws (counted where the input was nonzero); none in eval."""
    drawn = []

    def recording_dropout(x, p, generator):
        out = real_dropout(x, p, generator)
        live = x != 0
        drawn.append((p, int(live.sum()), int((live & (out != 0)).sum())))
        return out

    real_dropout = module.dropout
    monkeypatch.setattr(module, "dropout", recording_dropout)
    model = build_model(name, generator(0)).train()
    inputs = _inputs(name)
    model(*inputs, generator=torch.Generator().manual_seed(3))
    assert len(drawn) == per_step * L and all(d[0] == p for d in drawn)
    n, k = sum(d[1] for d in drawn), sum(d[2] for d in drawn)
    assert abs(k / n - (1 - p)) < 6 * np.sqrt(p * (1 - p) / n)
    model.eval()
    model(*inputs)
    assert len(drawn) == per_step * L


@pytest.mark.parametrize("name, n_classes, raises", [("BiLSTM", 7, False), ("MARN", 6, True),
                                                     ("MARN_AT", 7, True)])
def test_label_past_the_outputs_adds_zero_only_where_they_are_fewer(name, n_classes, raises):
    """BiLSTM has 6 outputs whatever n_classes says: at MELD's 7 classes a
    label 6 is a zero row of the loss, as in the JAX package; where the
    outputs are as many as the classes (MARN takes n_classes, MARN_AT has 7)
    such a label raises."""
    trainer = ModelTrainer(device="cpu", model=name, n_classes=n_classes, seed=0)
    batch = synthetic_batch(L=4, B=2, seed=0, min_len=4)
    batch["label"][0, 1] = 6 if n_classes == 7 and name == "BiLSTM" else n_classes
    if raises:
        with pytest.raises((IndexError, RuntimeError)):
            trainer._train_step_impl(batch, LR)
    else:
        assert np.isfinite(trainer._train_step_impl(batch, LR).item())
