"""The DialogueRNN suite's extras and ``TorchGRU`` against the JAX package,
on the CPU.

At ``[L, B] = [6, 3]`` (``tests/test_dialogue_rnn_extras.py``'s shape),
narrow widths, the JAX module's init loaded through ``from_jax_params``:

- every model's output against the JAX module at rtol 1e-3, atol 1e-4 on
  valid rows: ``DialogueRNNModel`` over the three context attentions x
  listener state on and off x ``att2``, ``AVECModel`` (flat, batch-major),
  ``DailyDialogueModel`` with ``att2`` on and off, ``E2EModel`` and
  ``BiE2EModel`` with ``att2`` on and off; ``TorchGRU`` with and without h0;
- the key round trip ``to_jax_params(from_jax_params(·))`` for every leaf
  of every model, the values bit for bit;
- one train step of ``DialogueRNNModel`` ('simple', no listener) and
  ``BiE2EModel`` against ``jax.value_and_grad`` and the JAX package's Adam,
  dropout off: the loss at rtol 1e-5, every gradient within 1e-3 of its
  tensor's largest entry plus 1e-6 of the step's largest, the port's dead
  set (``.grad`` None: the unused ``matchatt`` without ``att2``) and its
  all-zero gradients the JAX package's all-zero set, the updates within
  2.05 lr;
- the dropout placement of each model in train mode (rates and draws);
- the CNN zeroes padded utterances, and fewer words than its widest
  kernel raise in both packages.

The registry's ``BiModel`` is held unchanged by ``test_torch_dialogue_rnn.py``.
One intra-op thread, as the other train test files.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ser_tpu.models import dialogue_rnn_extras as J
from ser_tpu.ops.rnn import TorchGRU as JTorchGRU
from ser_tpu.train.checkpoint import flatten_params
from ser_tpu.train.losses import masked_mse_loss as jmasked_mse_loss
from ser_tpu.train.losses import masked_nll_loss as jmasked_nll_loss
from ser_tpu.train.optim import torch_adam as jtorch_adam
from ser_tpu_torch.compat.from_jax import from_jax_params, to_jax_params
from ser_tpu_torch.models import dialogue_rnn
from ser_tpu_torch.models import dialogue_rnn_extras as T
from ser_tpu_torch.ops import layers
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.ops.rnn import TorchGRU
from ser_tpu_torch.train.losses import masked_mse_loss, masked_nll_loss
from ser_tpu_torch.train.optim import torch_adam
from test_torch_marn_rest_train import port_grads
from test_torch_train_step import LR, grad_tolerance, no_dropout

L, B = 6, 3
RTOL, ATOL = 1e-3, 1e-4
D_M, WIDTHS = 20, (16, 16, 12, 10)  # D_m; D_g, D_p, D_e, D_h
V, W, D_EMB = 40, 8, 12
KEY = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dialogue(seed=0):
    """U ``[L, B, D_M]``, a one-hot qmask and umask with row 2 padded from
    step 4 (U and qmask zero there, as the loaders pad)."""
    rng = np.random.default_rng(seed)
    umask = np.ones((B, L), np.float32)
    umask[2, 4:] = 0.0
    U = rng.standard_normal((L, B, D_M)).astype(np.float32) * umask.T[:, :, None]
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (L, B))] * umask.T[:, :, None]
    return U, qmask, umask


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, V, size=shape).astype(np.int32)


def _turns(seed=4):
    return [_tokens((W, B), seed + i) for i in range(3)]


def _word_embeddings():
    return np.random.default_rng(9).standard_normal((V, D_EMB)).astype(np.float32)


# name -> (JAX module, port module (a function of the generator), inputs,
# apply kwargs); the inputs are numpy, the port's as tensors
def _setups():
    U, qmask, umask = _dialogue()
    ids = _tokens((L, B, W), 3)
    turns = _turns()
    return {
        "DialogueRNNModel": (J.DialogueRNNModel(D_M, *WIDTHS),
                             lambda g, **kw: T.DialogueRNNModel(D_M, *WIDTHS, generator=g, **kw),
                             (U, qmask, umask)),
        "AVECModel": (J.AVECModel(D_M, *WIDTHS),
                      lambda g, **kw: T.AVECModel(D_M, *WIDTHS, generator=g, **kw), (U, qmask)),
        "CNNFeatureExtractor": (J.CNNFeatureExtractor(V, 16, 10, 4),
                                lambda g, **kw: T.CNNFeatureExtractor(V, 16, 10, 4, generator=g, **kw),
                                (ids, umask)),
        "DailyDialogueModel": (J.DailyDialogueModel(100, *WIDTHS, vocab_size=V),
                               lambda g, **kw: T.DailyDialogueModel(100, *WIDTHS, vocab_size=V,
                                                                    generator=g, **kw),
                               (ids, qmask, umask)),
        "E2EModel": (J.E2EModel(D_EMB, 16, *WIDTHS[:3], 8),
                     lambda g, **kw: T.E2EModel(D_EMB, 16, *WIDTHS[:3], 8, generator=g, **kw),
                     (*turns, _word_embeddings())),
        "BiE2EModel": (J.BiE2EModel(D_EMB, 16, *WIDTHS[:3], 8, vocab_size=V),
                       lambda g, **kw: T.BiE2EModel(D_EMB, 16, *WIDTHS[:3], 8, vocab_size=V,
                                                    generator=g, **kw),
                       tuple(turns)),
    }


MODELS = tuple(_setups())


@functools.lru_cache(maxsize=None)
def _jax_params(name, **config):
    """The JAX module's params (and the module) for ``name`` under
    ``config`` (module fields), from one seed."""
    jmod, _, inputs = _setups()[name]
    jmod = jmod.clone(**config)
    return jmod, jax.jit(jmod.init)(KEY, *map(jnp.asarray, inputs))["params"]


def _apply(jmod, params, inputs, **kw):
    """The JAX module's output on numpy ``inputs``, jitted."""
    return jax.jit(functools.partial(jmod.apply, **kw))({"params": params},
                                                         *map(jnp.asarray, inputs))


def _port(name, params, **config):
    """The port's module for ``name`` in eval with the JAX params loaded
    strictly."""
    model = _setups()[name][1](generator(0), **config)
    model.load_state_dict(from_jax_params(flatten_params(params)), strict=True)
    return model.eval()


def _tensors(inputs):
    return tuple(torch.as_tensor(a).long() if a.dtype == np.int32 else torch.as_tensor(a)
                 for a in inputs)


def _check(got, want, valid=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if valid is not None:
        got, want = got[valid], want[valid]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("att2", [False, True])
@pytest.mark.parametrize("listener_state", [False, True])
@pytest.mark.parametrize("kind", ["simple", "general", "general2"])
def test_dialogue_rnn_model_matches_jax(kind, listener_state, att2):
    config = dict(listener_state=listener_state, context_attention=kind)
    jmod, params = _jax_params("DialogueRNNModel", **config)
    inputs = _setups()["DialogueRNNModel"][2]
    want = _apply(jmod, params, inputs, att2=att2)
    with torch.inference_mode():
        got = _port("DialogueRNNModel", params, **config)(*_tensors(inputs), att2=att2)
    _check(got, want, inputs[2].T > 0)


def test_avec_model_matches_jax():
    jmod, params = _jax_params("AVECModel")
    inputs = _setups()["AVECModel"][2]
    want = _apply(jmod, params, inputs)
    with torch.inference_mode():
        got = _port("AVECModel", params)(*_tensors(inputs))
    assert got.shape == (B * L,)
    _check(got, want, _dialogue()[2].reshape(-1) > 0)  # batch-major rows


@pytest.mark.parametrize("att2", [True, False])
def test_daily_dialogue_model_matches_jax(att2):
    jmod, params = _jax_params("DailyDialogueModel", att2=att2)
    inputs = _setups()["DailyDialogueModel"][2]
    want = _apply(jmod, params, inputs)
    model = _port("DailyDialogueModel", params)
    model.att2 = att2
    with torch.inference_mode():
        got = model(*_tensors(inputs))
    valid = inputs[2].T > 0
    assert (got[1] is None) == (not att2)
    for g_, w_, what in zip(got, want, ("log_prob", "alpha", "alpha_f", "alpha_b")):
        if g_ is not None:
            _check(g_, w_, valid)


@pytest.mark.parametrize("att2", [False, True])
@pytest.mark.parametrize("name", ["E2EModel", "BiE2EModel"])
def test_e2e_models_match_jax(name, att2):
    jmod, params = _jax_params(name)
    inputs = _setups()[name][2]
    want = _apply(jmod, params, inputs, att2=att2)
    with torch.inference_mode():
        got = _port(name, params)(*_tensors(inputs), att2=att2)
    assert got.shape == (B, 7)
    _check(got, want)


@pytest.mark.parametrize("with_h0", [False, True])
def test_torch_gru_matches_jax(with_h0):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, B, 6)).astype(np.float32)
    h0 = rng.standard_normal((B, 4)).astype(np.float32) if with_h0 else None
    jmod = JTorchGRU(4)
    args = (jnp.asarray(x),) + ((jnp.asarray(h0),) if with_h0 else ())
    params = jmod.init(KEY, *args)["params"]
    want_y, want_h = jmod.apply({"params": params}, *args)
    gru = TorchGRU(6, 4, generator=generator(0))
    assert sorted(gru.state_dict()) == ["bias_hh_l0", "bias_ih_l0", "weight_hh_l0",
                                        "weight_ih_l0"]
    sd = {k.split(".", 1)[1]: v for k, v in from_jax_params(
        {f"turn_rnn/{k}": v for k, v in flatten_params(params).items()}).items()}
    gru.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        y, h = gru(torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    _check(y, want_y)
    _check(h, want_h)
    torch.testing.assert_close(h, y[-1], rtol=0, atol=0)


@pytest.mark.parametrize("name", MODELS)
def test_keys_round_trip_every_leaf(name):
    _, params = _jax_params(name)
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    model = _port(name, params)
    assert len(model.state_dict()) == len(flat)
    back = to_jax_params(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# ---- one train step against jax.grad, dropout off -------------------------

def _labels(seed=5):
    return np.random.default_rng(seed).integers(0, 7, size=(B, L)).astype(np.int32)


def _step_setup(name):
    """``(inputs, loss of the JAX module's output, loss of the port's)``:
    DialogueRNNModel's [L, B, C] taken batch-major with its umask,
    BiE2EModel's [B, C] with a label a dialogue and every row valid."""
    inputs = _setups()[name][2]
    labels = _labels()
    if name == "DialogueRNNModel":
        umask = inputs[2]

        def jloss(out):
            rows = jnp.swapaxes(out, 0, 1).reshape(-1, out.shape[-1])
            return jmasked_nll_loss(rows, jnp.asarray(labels.reshape(-1)), jnp.asarray(umask))

        def loss(out):
            rows = out.transpose(0, 1).reshape(-1, out.shape[-1])
            return masked_nll_loss(rows, torch.as_tensor(labels.reshape(-1)),
                                   torch.as_tensor(umask))
    else:
        ones = np.ones(B, np.float32)
        jloss = lambda out: jmasked_nll_loss(out, jnp.asarray(labels[:, 0]),  # noqa: E731
                                             jnp.asarray(ones))
        loss = lambda out: masked_nll_loss(out, torch.as_tensor(labels[:, 0]),  # noqa: E731
                                           torch.as_tensor(ones))
    return inputs, jloss, loss


@functools.lru_cache(maxsize=None)
def _step(name):
    jmod, params = _jax_params(name)
    inputs, jloss, loss = _step_setup(name)
    jins = tuple(map(jnp.asarray, inputs))
    jl, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(jmod.apply({"params": p}, *jins, deterministic=True))))(params)
    opt = jtorch_adam()
    state = opt.init(params)
    state.hyperparams["learning_rate"] = LR
    updates, _ = jax.jit(opt.update)(jgrads, state, params)
    new_params = optax.apply_updates(params, updates)

    model = no_dropout(_port(name, params).train())
    out = model(*_tensors(inputs), generator=torch.Generator())
    step_loss = loss(out)
    step_loss.backward()
    grads = port_grads(model)
    torch_adam(model.parameters(), lr=LR).step()
    return dict(jloss=float(jl), loss=step_loss.item(), grads=grads,
                jgrads={k: np.asarray(v) for k, v in flatten_params(jgrads).items()},
                new_params={k: np.asarray(v) for k, v in flatten_params(new_params).items()},
                params={k: np.asarray(v) for k, v in flatten_params(params).items()},
                after=to_jax_params(model.state_dict()))


STEP_MODELS = ("DialogueRNNModel", "BiE2EModel")


@pytest.mark.parametrize("name", STEP_MODELS)
def test_step_loss_matches_jax(name):
    step = _step(name)
    np.testing.assert_allclose(step["loss"], step["jloss"], rtol=1e-5)


@pytest.mark.parametrize("name", STEP_MODELS)
def test_step_gradients_match_jax(name):
    step = _step(name)
    assert sorted(step["grads"]) == sorted(step["jgrads"])
    tol = grad_tolerance(step["jgrads"])
    for key, g in step["grads"].items():
        if g is not None:
            np.testing.assert_array_less(np.abs(g - step["jgrads"][key]), tol[key], err_msg=key)


@pytest.mark.parametrize("name", STEP_MODELS)
def test_step_dead_set_is_jaxs_all_zero_set(name):
    """The port's parameters outside the graph (``.grad`` None: the unused
    ``matchatt``) and those with an all-zero gradient are together the
    JAX package's all-zero set; Adam freezes both in either package.
    BiE2E's output reads the backward direction's first step alone, so its
    g cell, state-side kernels and context attention get all-zero
    gradients, through the stacked directions in the port."""
    step = _step(name)
    dead = {k for k, g in step["grads"].items() if g is None}
    zero = {k for k, g in step["grads"].items() if g is not None and not g.any()}
    assert dead | zero == {k for k, g in step["jgrads"].items() if not g.any()}
    assert dead == {"matchatt_transform_kernel", "matchatt_transform_bias"}
    assert len(zero) == (0 if name == "DialogueRNNModel" else 7)


@pytest.mark.parametrize("name", STEP_MODELS)
def test_step_updates_within_two_lr(name):
    step = _step(name)
    for key, want in step["new_params"].items():
        np.testing.assert_array_less(np.abs(step["after"][key] - want), 2.05 * LR, err_msg=key)
        if step["grads"][key] is None:  # a dead parameter does not move
            np.testing.assert_array_equal(step["after"][key], step["params"][key])


def test_avec_regression_loss_matches_jax():
    """AVEC's flat predictions through ``masked_mse_loss`` on both sides."""
    jmod, params = _jax_params("AVECModel")
    inputs = _setups()["AVECModel"][2]
    umask = _dialogue()[2].reshape(-1)
    target = np.random.default_rng(6).standard_normal(B * L).astype(np.float32)
    want = jmasked_mse_loss(_apply(jmod, params, inputs),
                            jnp.asarray(target), jnp.asarray(umask))
    with torch.inference_mode():
        got = masked_mse_loss(_port("AVECModel", params)(*_tensors(inputs)),
                              torch.as_tensor(target), torch.as_tensor(umask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# ---- dropout placement ----------------------------------------------------

# the rates of the placement test, distinct so that the runs read the
# places: the cells' dropout_rec, the models' dropout, dropout + 0.15, and
# the CNN's own default
REC, DROP, CNN_DROP = 0.3, 0.4, 0.5
# (rate, draws) runs in call order; the cells draw 3 a step (g, the party
# rows, e; no listener state), both directions in one draw
PLACEMENT = {
    "DialogueRNNModel": [(REC, 3 * L), (DROP + 0.15, 1), (DROP, 1)],
    "AVECModel": [(REC, 3 * L), (DROP, 2)],
    "DailyDialogueModel": [(CNN_DROP, 1), (REC, 3 * L + 2), (DROP, 1)],
    "E2EModel": [(REC, 3 * 3), (DROP + 0.15, 1), (DROP, 1)],
    "BiE2EModel": [(REC, 3 * 3), (DROP, 2)],
}


@pytest.mark.parametrize("name", sorted(PLACEMENT))
def test_dropout_placement(name, monkeypatch):
    """Train mode draws each dropout at the JAX module's rate and place:
    E2E's and DialogueRNNModel's emotions at dropout + 0.15,
    DailyDialogue's each direction once at dropout_rec, BiE2E's
    ``dropout`` on the forward emotions and again on the concatenation, no
    dropout on its hidden layer; eval draws none."""
    drawn = []
    real = layers.dropout

    def recording(x, p, generator):
        drawn.append(p)
        return real(x, p, generator)

    monkeypatch.setattr(layers, "dropout", recording)
    monkeypatch.setattr(dialogue_rnn, "dropout", recording)
    _, make, inputs = _setups()[name]
    model = make(generator(0), dropout_rec=REC, dropout=DROP).train()
    out = model(*_tensors(inputs), generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(out[0] if isinstance(out, tuple) else out).all()
    assert [(p, len(list(run))) for p, run in itertools.groupby(drawn)] == PLACEMENT[name]
    model.eval()
    model(*_tensors(inputs))
    assert len(drawn) == sum(n for _, n in PLACEMENT[name])
    with pytest.raises(RuntimeError, match="eval"):
        model.train()(*_tensors(inputs))


# ---- the CNN --------------------------------------------------------------

def test_cnn_masks_padding_and_matches_jax():
    jmod, params = _jax_params("CNNFeatureExtractor")
    ids, umask = _setups()["CNNFeatureExtractor"][2]
    want = jmod.apply({"params": params}, jnp.asarray(ids), jnp.asarray(umask))
    with torch.inference_mode():
        got = _port("CNNFeatureExtractor", params)(*_tensors((ids, umask)))
    assert got.shape == (L, B, 10)
    assert not got[4:, 2].any() and got[:4, 2].any()  # the padded utterances
    _check(got, want)


def test_cnn_refuses_fewer_words_than_its_widest_kernel():
    ids = _tokens((L, B, 4), 8)
    umask = np.ones((B, L), np.float32)
    model = T.CNNFeatureExtractor(V, 16, 10, 4, generator=generator(0)).eval()
    with pytest.raises(ValueError, match="at least 5 tokens"):
        model(*_tensors((ids, umask)))
    jmod = J.CNNFeatureExtractor(V, 16, 10, 4)
    with pytest.raises(Exception):  # a max over no window
        jmod.init(KEY, jnp.asarray(ids), jnp.asarray(umask))


def test_unknown_context_attention_raises_as_in_jax():
    with pytest.raises(ValueError, match="unknown context_attention: dot"):
        T.DialogueRNNModel(D_M, *WIDTHS, context_attention="dot", generator=generator(0))
    U, qmask, umask = map(jnp.asarray, _dialogue())
    with pytest.raises(ValueError, match="unknown context_attention: dot"):
        J.DialogueRNNModel(D_M, *WIDTHS, context_attention="dot").init(KEY, U, qmask, umask)
