"""One train step of MARN1_mf, MARN1_la and MARN1_newz against the JAX
package's, on the CPU, and their train-mode dropouts.

At full width, [9, 3]: the same JAX-initialised weights on both sides
through ``from_jax_params``, the parameters the reference initialises to a
constant re-seeded on both sides (``tests/test_torch_meld.py::
randomize_constants``), dropout off on both sides
(``tests/test_torch_train_step.py::run_step``). The contract is PERF.md
§2's: the loss at rtol 1e-5; every gradient within 1e-3 of its tensor's
largest entry plus 1e-6 of the step's largest; the port's dead set
(``.grad`` None) equal to the JAX package's all-zero set; the updated
parameters within 2.05 lr. newz's raw logits go through the loss's
log-softmax, as in the JAX trainer.

With dropout on: a train forward is finite, reproducible from the
generator's seed and differs from eval; mf's and la's loops draw nothing
(no dropout and no attention in their cells); newz's three 0.3 dropouts a
step keep 0.7 of their draws, within 6 standard deviations. A label
outside newz's 6 logits (MELD at 7 classes) adds 0 to the loss, as in the
JAX package; a label outside the logits of a model whose width is the class
count still raises. One intra-op thread, as the other train test files.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.train.losses import masked_loss as jmasked_loss
from ser_tpu_torch.compat.from_jax import to_jax_params
from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.models import marn_newz, marn_variants
from ser_tpu_torch.models.registry import build_model, get_model_spec
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.train.losses import masked_loss
from ser_tpu_torch.train.trainer import ModelTrainer
from test_torch_meld import randomize_constants
from test_torch_train_step import LR, grad_tolerance, no_dropout, run_step

MODELS = ("MARN1_mf", "MARN1_la", "MARN1_newz")
L, B = 9, 3
# the JAX package's all-zero gradients of a step: the parameters the
# reference declares and never uses (mf: the cell encoders' pos_ffn.fc and
# linear; la: also the cell encoders, sequence attentions and V entire;
# newz: encoder_v, fc, g_attention.trans and the encoders' pos_ffn.fc)
DEAD = {"MARN1_mf": 10, "MARN1_la": 78, "MARN1_newz": 26}


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


def port_grads(model):
    """The port's gradients under the JAX package's flat names (None for a
    parameter outside the graph)."""
    params = dict(model.named_parameters())
    names = to_jax_params({k: torch.zeros_like(p) if p.grad is None else p.grad
                           for k, p in params.items()})
    return {name: None if p.grad is None else v
            for (name, v), p in zip(names.items(), params.values())}


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
    after = to_jax_params(step["pt"].model.state_dict())
    for key, want in step["new_params"].items():
        np.testing.assert_array_less(np.abs(after[key] - np.asarray(want)), 2.05 * LR,
                                     err_msg=key)
    for key, g in port_grads(step["pt"].model).items():  # dead ones did not move
        if g is None:
            np.testing.assert_array_equal(after[key], np.asarray(step["params"][key]))


def _inputs(name, seed=1):
    batch = synthetic_batch(L=L, B=B, seed=seed, min_len=4)
    return tuple(map(torch.as_tensor, get_model_spec(name).make_inputs(batch)))


@pytest.mark.parametrize("name", MODELS)
def test_train_forward_is_seeded_and_differs_from_eval(name):
    model = build_model(name, generator(0)).train()
    inputs = _inputs(name)
    run = lambda seed: model(*inputs, generator=torch.Generator().manual_seed(seed))[0]  # noqa: E731
    a, b, c = run(5), run(5), run(6)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    model.eval()
    e = model(*inputs)[0]
    assert not torch.equal(a, e)
    model.train()
    no_dropout(model)
    torch.testing.assert_close(run(5), e, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="eval"):
        model(*inputs)


@pytest.mark.parametrize("name", ["MARN1_mf", "MARN1_la"])
def test_no_attention_loop_draws_nothing(name, monkeypatch):
    """mf's and la's recurrences run ``fused_directions`` without the
    rank-1 attention: nothing is bound and no dropout is drawn in the loop,
    in train as in eval."""
    calls = []
    monkeypatch.setattr(marn_variants, "rank1_bind", lambda *a: calls.append("bind"))
    monkeypatch.setattr(marn_variants, "dropout", lambda *a, **k: calls.append("drop"))
    model = build_model(name, generator(0)).train()
    assert "rank1_seed" not in dict(model.named_buffers())
    out = model(*_inputs(name), generator=torch.Generator().manual_seed(3))[0]
    assert torch.isfinite(out).all() and calls == []


def test_kept_fractions_of_newz_dropouts(monkeypatch):
    """Three dropouts a step at 0.3 (after att_l, att_a and
    att_cross_modal) keep 0.7 of their draws (counted where the ReLU before
    them left the input nonzero); none in eval."""
    drawn = []

    def recording_dropout(x, p, generator):
        out = real_dropout(x, p, generator)
        live = x != 0
        drawn.append((p, int(live.sum()), int((live & (out != 0)).sum())))
        return out

    real_dropout = marn_newz.dropout
    monkeypatch.setattr(marn_newz, "dropout", recording_dropout)
    model = build_model("MARN1_newz", generator(0)).train()
    inputs = _inputs("MARN1_newz")
    model(*inputs, generator=torch.Generator().manual_seed(3))
    assert len(drawn) == 3 * L and all(p == 0.3 for p, _, _ in drawn)
    n, k = sum(d[1] for d in drawn), sum(d[2] for d in drawn)
    assert abs(k / n - 0.7) < 6 * np.sqrt(0.21 / n)
    model.eval()
    model(*inputs)
    assert len(drawn) == 3 * L


def test_label_outside_the_logits_adds_zero_as_in_jax():
    """newz has 6 logits whatever --n_classes says; a 7-class MELD label 6
    gets an all-zero one-hot in the JAX package's loss, so its row adds 0
    to the sum and 1 to the mask's sum."""
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((8, 6)).astype(np.float32)
    target = np.array([0, 6, 5, 6, 2, 1, 6, 3])
    mask = np.array([[1, 1, 1, 1, 1, 1, 0, 0]], np.float32)
    want = jmasked_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    args = tuple(map(torch.as_tensor, (pred, target, mask)))
    got = masked_loss(*args, outside_adds_zero=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    inside = masked_loss(*map(torch.as_tensor, (pred[:1], target[:1], mask[:, :1])),
                         outside_adds_zero=True)
    logp = torch.log_softmax(torch.as_tensor(pred[:1]), -1)
    torch.testing.assert_close(inside, -logp[0, 0], rtol=0, atol=0)
    with pytest.raises((IndexError, RuntimeError)):
        masked_loss(*args)


@pytest.mark.parametrize("name, n_classes, raises", [
    ("MARN1_onlysp", 6, True), ("MARN1_mf", 6, True), ("MARN1_newz", 7, False)])
def test_trainer_keeps_the_label_guard_where_the_logits_match(name, n_classes, raises):
    """A label of 6 raises in a train step of a model with 6 logits at 6
    classes; only newz, whose 6 logits differ from MELD's 7 classes, takes
    it as a zero row of the loss."""
    trainer = ModelTrainer(device="cpu", model=name, n_classes=n_classes, seed=0)
    batch = synthetic_batch(L=4, B=2, seed=0, min_len=4)
    batch["label"][0, 1] = 6
    if raises:
        with pytest.raises((IndexError, RuntimeError)):
            trainer._train_step_impl(batch, LR)
    else:
        assert np.isfinite(trainer._train_step_impl(batch, LR).item())
