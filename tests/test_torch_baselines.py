"""The port's BiLSTM, MARN, MARN_AT and MARN_ATV in eval against the JAX
package, on the CPU, and the registry and weight mapping of all 15 models.

Weights come from a JAX init through ``from_jax_params``; both sides see the
same synthetic batch at the same padded L = 10, B = 3, row 2 fully padded
(as ``tests/test_torch_marn_rest.py``). The outputs (probabilities: the
four emit softmax) of the valid rows match at rtol 1e-3, atol 1e-4 and every
row is finite; MARN_AT's and MARN_ATV's rows are time-major, as the JAX
package orders them. On MELD's widths (P = 9, 300-d audio, 600-d visual)
each behaves as the JAX package: BiLSTM keeps 6 outputs, MARN_AT 7, MARN
takes ``n_classes``, MARN_ATV runs on the 1000-wide trimodal input with its
v slice across audio and visual dims. ``TorchBiLSTM`` matches the JAX
package's scan over padded input. For every registry name the state-dict
keys equal ``export_state_dict(.., prefix="")`` and ``to_jax_params``
inverts ``from_jax_params`` (parameter shapes from ``jax.eval_shape``, no
JAX init). One JAX init and apply a (model, P), shared through a
module-scope fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.compat.torch_export import export_state_dict
from ser_tpu.models.registry import available_models as javailable_models
from ser_tpu.models.registry import get_model_spec as jget_model_spec
from ser_tpu.ops.rnn import TorchBiLSTM as JTorchBiLSTM
from ser_tpu.train.checkpoint import flatten_params, unflatten_into
from ser_tpu_torch.compat.from_jax import from_jax_params, jax_layout, to_jax_params
from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.models.registry import available_models, build_model, get_model_spec
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.ops.rnn import TorchBiLSTM
from ser_tpu_torch.serving import Predictor

MODELS = ("BiLSTM", "MARN", "MARN_AT", "MARN_ATV")
L, B = 10, 3
# the JAX registry's output widths at IEMOCAP's 6 classes and MELD's 7
WIDTH = {"BiLSTM": (6, 6), "MARN": (6, 7), "MARN_AT": (7, 7), "MARN_ATV": (6, 6)}


def _batch(P):
    meld = dict(n_parties=9, d_audio=300, d_visual=600, n_classes=7) if P == 9 else {}
    batch = synthetic_batch(L=L, B=B, seed=4, min_len=4, **meld)
    batch["umask"][2] = 0.0  # row 2 fully padded
    batch["qmask"][:, 2] = 0.0
    for k in ("r1", "r2", "r3", "r4", "visuf", "acouf"):
        batch[k][:, 2] = 0.0
    return batch


@pytest.fixture(scope="module")
def jax_runs():
    """``(params, inputs, outputs)`` of a JAX init and eval apply for a
    (model, P), made at first use."""
    cache = {}

    def get(name, P=2):
        if (name, P) not in cache:
            inputs = get_model_spec(name).make_inputs(_batch(P))
            spec = jget_model_spec(name)
            args = tuple(map(jnp.asarray, inputs))
            model = spec.build(7 if P == 9 else 6, "MELD" if P == 9 else "IEMOCAP")
            key = jax.random.PRNGKey(1)
            params = model.init({"params": key, "dropout": key}, *args,
                                deterministic=True)["params"]
            ref = np.asarray(spec.extract_logp(
                model.apply({"params": params}, *args, deterministic=True)))
            cache[name, P] = params, inputs, ref
        return cache[name, P]
    return get


def _check_eval(jax_runs, name, P):
    params, (x, qmask, umask), ref = jax_runs(name, P)
    spec = get_model_spec(name)
    pred = Predictor(name, state_dict=from_jax_params(flatten_params(params)), device="cpu",
                     n_classes=7 if P == 9 else 6)
    out, labels = pred.predict(x, qmask, umask)
    assert out.shape == (B * L, WIDTH[name][P == 9]) == ref.shape
    assert labels.shape == (B, L)
    assert torch.isfinite(out).all()  # the fully padded row too
    valid = spec.rows(umask) > 0
    np.testing.assert_allclose(out.numpy()[valid], ref[valid], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(spec.rows(labels.numpy())[valid], ref.argmax(-1)[valid])
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, rtol=1e-5)  # probabilities
    return out


@pytest.mark.parametrize("name", MODELS)
def test_eval_matches_jax(jax_runs, name):
    _check_eval(jax_runs, name, 2)


@pytest.mark.parametrize("name", MODELS)
def test_meld_behaves_as_jax(jax_runs, name):
    """MELD's widths: BiLSTM 6 outputs, MARN_AT 7, MARN n_classes; MARN_ATV
    reads its 512-wide v slice from dims 200:712 of the 1000-wide input,
    the last 200 audio dims and the first 312 visual ones."""
    _check_eval(jax_runs, name, 9)
    x = jax_runs(name, 9)[1][0]
    assert x.shape[-1] == (1000 if name == "MARN_ATV" else 1324)


@pytest.mark.parametrize("name", ["MARN_AT", "MARN_ATV"])
def test_rows_are_time_major(jax_runs, name):
    """Row t·B + b is dialogue b's step t: each dialogue alone gives the
    rows of its column, and ``Predictor``'s labels come back ``[B, L]``."""
    params, (x, qmask, umask), _ = jax_runs(name)
    spec = get_model_spec(name)
    assert spec.logp_layout == "tb"
    pred = Predictor(name, state_dict=from_jax_params(flatten_params(params)), device="cpu")
    out, labels = pred.predict(x, qmask, umask)
    for b in range(B):
        alone, alone_labels = pred.predict(x[:, b:b + 1], qmask[:, b:b + 1], umask[b:b + 1])
        torch.testing.assert_close(out.reshape(L, B, -1)[:, b], alone, rtol=1e-5, atol=1e-6)
        assert torch.equal(labels[b], alone_labels[0])
    assert torch.equal(spec.grid(spec.rows(labels), B, L), labels)


def test_torch_bilstm_matches_jax_scan():
    """``nn.LSTM(bidirectional=True)`` over padded input against the JAX
    package's two scans (the backward one over the padding too), with the
    reference's parameter names; its init draws nothing from the global
    generator and is U(+-1/sqrt(hidden))."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 3, 20)).astype(np.float32)
    x[5:, 1] = 0.0  # padding, run through as torch runs unpacked input
    jmod = JTorchBiLSTM(16)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    state = {k[len("m."):]: v for k, v in from_jax_params(
        {f"lstm_l/{k}": v for k, v in flatten_params(params).items()}).items()}
    before = torch.random.get_rng_state()
    mod = TorchBiLSTM(20, 16, generator=generator(0))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert max(p.abs().max().item() for p in mod.parameters()) <= 16 ** -0.5
    assert sorted(mod.state_dict()) == sorted(k.split(".", 1)[1] for k in state)
    mod.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (7, 3, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_registry_has_every_jax_model_with_its_class_counts():
    assert available_models() == javailable_models() and len(available_models()) == 15
    head = lambda name, n: build_model(name, generator(0), n).nn_out[3].weight.shape[0]  # noqa: E731
    assert [head(n, 7) for n in ("BiLSTM", "MARN", "MARN_AT", "MARN_ATV")] == [6, 7, 7, 6]
    assert [head(n, 6) for n in ("BiLSTM", "MARN", "MARN_AT", "MARN_ATV")] == [6, 6, 7, 6]
    assert build_model("DialogueRNN", generator(0), 7).smax_fc.weight.shape[0] == 6
    with pytest.raises(KeyError, match="available"):
        get_model_spec("MARN2")


def _jax_params_of_shape(name):
    """The JAX model's parameter tree at its init's shapes (``eval_shape``),
    filled with seeded normal values."""
    spec = jget_model_spec(name)
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(L=4, B=2, seed=0).items()
             if k != "vid"}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: spec.build(6, "IEMOCAP").init(
        {"params": key, "dropout": key}, *spec.make_inputs(batch),
        deterministic=True)["params"])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    rng = np.random.default_rng(0)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_params(zeros).items()}
    return unflatten_into(zeros, flat), flat


@pytest.mark.parametrize("name", javailable_models())
def test_state_dict_keys_equal_export_state_dict(name):
    params, flat = _jax_params_of_shape(name)
    ported = from_jax_params(flat)
    exported = export_state_dict(params, name, prefix="", log=lambda *_: None)
    assert sorted(ported) == sorted(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(ported[k].numpy(), v, err_msg=k)
    model = build_model(name, generator(0))
    model.load_state_dict(ported, strict=True)
    assert sorted(model.state_dict()) == sorted(exported)
    back = to_jax_params(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    layouts = {"MARN1_la": "cells", "MARN1_mf": "cells", "MARN1_newz": "leaves", "MARN": "leaves",
               "MARN_AT": "leaves", "MARN_ATV": "leaves", "DialogueRNN": "leaves"}
    assert jax_layout(ported) == layouts.get(name, "flat")
