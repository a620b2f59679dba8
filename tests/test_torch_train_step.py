"""One train step of the port against the JAX package's, on the CPU.

MARN1_onlysp at full width, [9, 3], the same JAX-initialised weights on both
sides through ``from_jax_params``, dropout off on both sides (the port's
rates set to 0; the JAX package's dropout monkeypatched away as
``tests/test_trainer_trajectory_parity.py`` does, nothing in ``ser_tpu``
changes). Compared with ``ModelTrainer._train_step_impl`` of both packages:

- the loss, at rtol 1e-5;
- every gradient, by the name map of ``compat/from_jax.py``, at
  |Δ| <= 1e-3·max|jax of that tensor| + 1e-6·max|jax of all tensors|: f32 CPU
  against XLA CPU, summed in other orders over 9 recurrent steps and two
  encoder passes. The second term is the noise floor of the step's largest
  gradient; it holds the tensors whose gradient is itself a cancelling sum
  (the fusion scalars w, v1, v2: 6e-7 with 2e-6 of disagreement);
- the dead set: the port's ``.grad`` is None exactly where the JAX gradient
  is all zero;
- the updated parameters, within 2.05·lr (Adam's first step is
  ``lr·sign(g)``, so noise-level gradients may take either sign).

Also, with dropout on: the train forward is finite, reproducible from the
generator's seed and differs from eval; ``state_dict`` keys are unchanged by
the dropout modules.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.train.checkpoint import flatten_params
from ser_tpu.train.trainer import ModelTrainer as JModelTrainer
from ser_tpu.train.trainer import _device_batch
from ser_tpu_torch.compat.from_jax import from_jax_params, to_jax_params
from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.ops.layers import Dropout
from ser_tpu_torch.train.trainer import ModelTrainer

L, B, LR = 9, 3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's eager train loop is thousands of small ops: one intra-op
    thread runs it several times faster than many, above all while other
    test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def no_dropout(model):
    """Every dropout rate of the port's model set to 0."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.dropout_rate = model.attn_dropout = 0.0
    return model


def _disable_jax_dropout(monkeypatch):
    import ser_tpu.ops.attention as attention
    import ser_tpu.ops.layers as layers

    orig = layers.dropout
    ident = lambda x, rate, deterministic, rng: x  # noqa: E731
    for mod in list(sys.modules.values()):
        if getattr(mod, "dropout", None) is orig:
            monkeypatch.setattr(mod, "dropout", ident)
    monkeypatch.setattr(layers.Dropout, "__call__", lambda self, x, deterministic: x)
    r1 = attention.rank1_cross_attention

    def r1_det(x1, x2, wq, wk, attn_dropout=0.2, deterministic=True, rng=None):
        return r1(x1, x2, wq, wk, 0.0, True, None)

    for mod in list(sys.modules.values()):
        if getattr(mod, "rank1_cross_attention", None) is r1:
            monkeypatch.setattr(mod, "rank1_cross_attention", r1_det)


def run_step(res_csv, batch=None, n_classes=6, init=None, model="MARN1_onlysp",
             **trainer_kwargs):
    """Both packages' step of ``model`` from one init, dropout off: the JAX
    loss, gradients and updated parameters from one jitted call of the JAX
    trainer's ``_train_step_impl`` (its gradients caught from its
    ``jax.value_and_grad``); the port's trainer after its step. ``batch``
    defaults to an IEMOCAP-shaped one at [L, B]; ``init`` maps the JAX
    trainer's initial parameters to the ones both sides start from;
    ``trainer_kwargs`` (``infonce``, ``encoder_attention``) go to both
    trainers, the kind to the JAX package as its ``config.ENCODER_ATTENTION``
    for the step."""
    if batch is None:
        batch = synthetic_batch(L=L, B=B, seed=0, min_len=4)
    mp = pytest.MonkeyPatch()
    try:
        _disable_jax_dropout(mp)
        if "encoder_attention" in trainer_kwargs:
            from ser_tpu import config
            mp.setattr(config, "ENCODER_ATTENTION", trainer_kwargs["encoder_attention"])
        jt = JModelTrainer(model=model, seed=3, n_classes=n_classes,
                           res_csv_path=res_csv, **trainer_kwargs)
        caught = {}
        value_and_grad = jax.value_and_grad

        def catching(fn, *a, **k):
            inner = value_and_grad(fn, *a, **k)

            def run(*args):
                caught["grads"] = inner(*args)[1]
                return inner(*args)
            return run

        mp.setattr(jax, "value_and_grad", catching)
        params = jt.params if init is None else init(jt.params)
        (new_params, _, jloss), jgrads = jax.jit(
            lambda *a: (jt._train_step_impl(*a), caught["grads"]))(
                params, jt.tx.init(params), _device_batch(batch),
                jnp.float32(LR), jax.random.PRNGKey(7))
    finally:
        mp.undo()

    pt = ModelTrainer(device="cpu", model=model, seed=3, lr=LR, n_classes=n_classes,
                      res_csv_path=res_csv, **trainer_kwargs)
    pt.model.load_state_dict(from_jax_params(flatten_params(params)), strict=True)
    no_dropout(pt.model)
    loss = pt._train_step_impl(batch, LR)
    return dict(batch=batch, jloss=float(jloss), jgrads=flatten_params(jgrads),
                params=flatten_params(params), new_params=flatten_params(new_params),
                pt=pt, loss=loss)


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    return run_step(str(tmp_path_factory.mktemp("step") / "res.csv"))


def port_grads(model):
    """The port's gradients under the JAX package's flat names (None for a
    parameter outside the graph)."""
    out = {}
    for key, p in model.named_parameters():
        value = torch.zeros_like(p) if p.grad is None else p.grad
        ((name, v),) = to_jax_params({key: value}).items()
        out[name] = None if p.grad is None else v
    return out


def test_loss_matches_jax(step):
    np.testing.assert_allclose(step["loss"].item(), step["jloss"], rtol=1e-5)


def grad_tolerance(want: dict) -> dict:
    """Per tensor: 1e-3 of its largest |gradient| plus 1e-6 of the largest
    over all tensors."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    return {n: 1e-3 * float(np.abs(np.asarray(w)).max()) + 1e-6 * top
            for n, w in want.items()}


def test_every_gradient_matches_jax(step):
    grads = port_grads(step["pt"].model)
    assert sorted(grads) == sorted(step["jgrads"])
    tol = grad_tolerance(step["jgrads"])
    for name, g in grads.items():
        if g is None:
            continue
        want = np.asarray(step["jgrads"][name])
        assert g.shape == want.shape, name
        np.testing.assert_array_less(np.abs(g - want), tol[name], err_msg=name)


def test_dead_set_is_jaxs_all_zero_set(step):
    grads = port_grads(step["pt"].model)
    dead = {n for n, g in grads.items() if g is None}
    jax_zero = {n for n, g in step["jgrads"].items() if not np.any(np.asarray(g))}
    assert dead == jax_zero
    assert len(dead) == 38  # crossatt_l2a_Wv, crossatt_a2l_*, lstm_q0/q1/s, pos_ffn.fc, linear
    assert any("pos_ffn/fc" in n for n in dead) and "linear/kernel" in dead


def test_updated_parameters_within_two_lr(step):
    after = to_jax_params(step["pt"].model.state_dict())
    before = step["params"]
    for name, want in step["new_params"].items():
        want = np.asarray(want)
        np.testing.assert_array_less(np.abs(after[name] - want), 2.05 * LR,
                                     err_msg=name)
    grads = port_grads(step["pt"].model)
    for name, g in grads.items():  # dead parameters did not move at all
        if g is None:
            np.testing.assert_array_equal(after[name], np.asarray(before[name]))
            np.testing.assert_array_equal(np.asarray(step["new_params"][name]),
                                          np.asarray(before[name]))


def _train_forward(model, batch, seed):
    from ser_tpu_torch.models.registry import get_model_spec

    x, qmask, umask = map(torch.as_tensor,
                          get_model_spec("MARN1_onlysp").make_inputs(batch))
    g = torch.Generator().manual_seed(seed)
    return model(x, qmask, umask, generator=g)[0]


def test_train_forward_with_dropout_is_seeded_and_differs_from_eval():
    from ser_tpu_torch.models.registry import build_model
    from ser_tpu_torch.ops.init import generator

    model = build_model("MARN1_onlysp", generator(0)).train()
    batch = synthetic_batch(L=L, B=B, seed=1)
    a = _train_forward(model, batch, 5)
    b = _train_forward(model, batch, 5)
    c = _train_forward(model, batch, 6)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    model.eval()
    e = _train_forward(model, batch, 5)
    assert not torch.equal(a, e)
    model.train()
    no_dropout(model)
    torch.testing.assert_close(_train_forward(model, batch, 5), e, rtol=1e-5,
                               atol=1e-5)


def test_dropout_modules_leave_state_dict_keys_unchanged(step):
    """The keys are the JAX package's export keys (``from_jax_params`` of
    its 128 flat names, pinned equal to ``export_state_dict`` in
    ``tests/test_torch_marn_onlysp.py``); no dropout module adds one."""
    model = step["pt"].model
    drops = [n for n, m in model.named_modules() if isinstance(m, Dropout)]
    assert len(drops) == 2 * 3 + 4 + 3  # 3 an encoder, 4 sequence attentions, rec x2, head
    assert "nn_out.2" in drops
    assert sorted(model.state_dict()) == sorted(from_jax_params(step["params"]))
    assert not any("drop" in k for k in model.state_dict())


def test_dropout_is_inverted_seeded_and_keeps_one_minus_p():
    """The port's ``dropout`` against the JAX package's: the same rule
    (kept entries scaled by 1/(1-p), dropped ones 0), a kept fraction within
    6 standard deviations of 1 - p on both sides (the random bits differ by
    design), reproducible from the generator's seed; rate 0, no generator
    and eval mode are the identity."""
    from ser_tpu.ops.layers import dropout as jdropout
    from ser_tpu_torch.ops.layers import dropout

    p, n = 0.1, 200_000
    x = torch.from_numpy(np.random.default_rng(0).uniform(1, 2, n).astype(np.float32))
    a = dropout(x, p, torch.Generator().manual_seed(4))
    assert torch.equal(a, dropout(x, p, torch.Generator().manual_seed(4)))
    j = np.asarray(jdropout(jnp.asarray(x.numpy()), p, False, jax.random.PRNGKey(4)))
    sd = np.sqrt(p * (1 - p) / n)
    for out in (a.numpy(), j):
        kept = out != 0
        assert abs(kept.mean() - (1 - p)) < 6 * sd
        np.testing.assert_array_equal(out[kept], (x.numpy() / np.float32(1 - p))[kept])
    assert dropout(x, 0.0, torch.Generator()) is x and dropout(x, p, None) is x
    layer = Dropout(p).eval()
    assert layer(x, torch.Generator()) is x
