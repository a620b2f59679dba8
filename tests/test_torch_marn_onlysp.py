"""The port's MARN1_onlysp eval forward against the JAX package, on the CPU.

Weights come from a JAX init through ``from_jax_params``; both sides see the
same synthetic batch at the same padded L. Log-probs match at rtol 1e-3,
atol 1e-4, the port's logit contract with the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ser_tpu.compat.torch_export import export_state_dict
from ser_tpu.data import synthetic as jsynthetic
from ser_tpu.models.marn_onlysp import MARN1OnlySP as JMARN1OnlySP
from ser_tpu.train.checkpoint import flatten_params
from ser_tpu_torch.compat.from_jax import from_jax_params
from ser_tpu_torch.data import synthetic
from ser_tpu_torch.models.registry import build_model, get_model_spec
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.serving import Predictor

L, B = 9, 3


def _batch(padded_row):
    batch = synthetic.synthetic_batch(L=L, B=B, seed=4)
    if padded_row:  # row 2 fully padded, as tests/test_padded_rows.py builds it
        batch["umask"][2] = 0.0
        batch["qmask"][:, 2] = 0.0
        for k in ("r1", "r2", "r3", "r4", "visuf", "acouf"):
            batch[k][:, 2] = 0.0
    return get_model_spec("MARN1_onlysp").make_inputs(batch)


@pytest.fixture(scope="module")
def jax_params():
    x, qmask, umask = map(jnp.asarray, _batch(False))
    key = jax.random.PRNGKey(1)
    return JMARN1OnlySP(n_classes=6).init(
        {"params": key, "dropout": key}, x, qmask, umask,
        deterministic=True)["params"]


@pytest.mark.parametrize("padded_row", [False, True])
def test_predictor_matches_jax(jax_params, padded_row):
    x, qmask, umask = _batch(padded_row)
    ref = np.asarray(JMARN1OnlySP(n_classes=6).apply(
        {"params": jax_params}, *map(jnp.asarray, (x, qmask, umask)),
        deterministic=True)[0])
    pred = Predictor(state_dict=from_jax_params(flatten_params(jax_params)),
                     device="cpu")
    logp, labels = pred.predict(x, qmask, umask)
    assert logp.shape == (B * L, 6) and labels.shape == (B, L)
    assert torch.isfinite(logp).all()
    valid = umask.reshape(-1) > 0
    np.testing.assert_allclose(logp.numpy()[valid], ref[valid],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(labels.numpy().reshape(-1)[valid],
                                  ref.argmax(-1)[valid])
    assert pred.n_requests == 1


def test_from_jax_params_equals_export_state_dict(jax_params):
    flat = flatten_params(jax_params)
    assert len(flat) == 128
    ported = from_jax_params(flat)
    exported = export_state_dict(jax_params, "MARN1_onlysp", prefix="",
                                 log=lambda *_: None)
    assert sorted(ported) == sorted(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(ported[k].numpy(), v, err_msg=k)
    model = build_model("MARN1_onlysp", generator(0))
    model.load_state_dict(ported, strict=True)
    assert sorted(model.state_dict()) == sorted(exported)


def test_from_jax_params_rejects_unknown_name():
    with pytest.raises(KeyError, match="no MARN1_onlysp home"):
        from_jax_params({"marn_cell_f/lsthm_q_W_kernel": np.zeros((2, 2))})


def test_synthetic_batches_equal_the_jax_packages():
    ours = synthetic.synthetic_batch(L=12, B=4, seed=3, min_len=5)
    theirs = jsynthetic.synthetic_batch(L=12, B=4, seed=3, min_len=5)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]))
    (ours, n_ours), (theirs, n_theirs) = (synthetic.iemocap_eval_batch(0),
                                          bench.iemocap_eval_batch(0))
    assert n_ours == n_theirs == 1606
    for k in ("qmask", "umask", "acouf", "r1"):
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_registry_lists_models_on_unknown_name():
    with pytest.raises(KeyError, match="MARN1_onlysp"):
        get_model_spec("MARN1_nope")


def test_model_refuses_train_mode():
    model = build_model("MARN1_onlysp", generator(0))
    with pytest.raises(RuntimeError, match="eval"):
        model(*map(torch.as_tensor, _batch(False)))
