"""The port's rank-1 MARN1 variants (sp, cf, azs, sps, nsps, no_en) in eval
against the JAX package, on the CPU.

Weights come from a JAX init through ``from_jax_params``; both sides see the
same synthetic batch at the same padded L = 10, B = 3, with row 2 fully
padded and row 0's qmask all zero at step 5 (it takes party 0 on both
sides). Log-probs of the valid rows match at rtol 1e-3, atol 1e-4 (the
port's logit contract) and every row is finite. At P = 9 (MELD's width,
1324 inputs, 7 classes) the same for sp, nsps and sps. The state-dict keys
equal the JAX package's ``export_state_dict(.., prefix="")`` and
``to_jax_params`` inverts ``from_jax_params``. One JAX init and apply a
(model, P), shared through a module-scope fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.compat.torch_export import export_state_dict
from ser_tpu.models.marn_variants import _sps_orders as jsps_orders
from ser_tpu.models.registry import get_model_spec as jget_model_spec
from ser_tpu.train.checkpoint import flatten_params
from ser_tpu_torch.compat.from_jax import from_jax_params, to_jax_params
from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.models import marn_variants
from ser_tpu_torch.models.registry import build_model, get_model_spec
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.serving import Predictor

VARIANTS = ("MARN1_sp", "MARN1_cf", "MARN1_azs", "MARN1_sps", "MARN1_nsps", "MARN1_no_en")
L, B = 10, 3


def _batch(P):
    meld = dict(n_parties=9, d_audio=300, d_visual=600, n_classes=7) if P == 9 else {}
    batch = synthetic_batch(L=L, B=B, seed=4, min_len=4, **meld)
    batch["qmask"][5, 0] = 0.0  # an all-zero qmask row mid-sequence
    batch["umask"][2] = 0.0  # row 2 fully padded
    batch["qmask"][:, 2] = 0.0
    for k in ("r1", "r2", "r3", "r4", "visuf", "acouf"):
        batch[k][:, 2] = 0.0
    return batch


@pytest.fixture(scope="module")
def jax_runs():
    """``(params, inputs, log-probs)`` of a JAX init and eval apply for a
    (model, P), made at first use."""
    cache = {}

    def get(name, P=2):
        if (name, P) not in cache:
            inputs = get_model_spec(name).make_inputs(_batch(P))
            spec = jget_model_spec(name)
            model = spec.build(7 if P == 9 else 6, "MELD" if P == 9 else "IEMOCAP")
            args = tuple(map(jnp.asarray, inputs))
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
    C = 7 if P == 9 else 6
    pred = Predictor(name, state_dict=from_jax_params(flatten_params(params)),
                     device="cpu", n_classes=C)
    logp, labels = pred.predict(x, qmask, umask)
    assert logp.shape == (B * L, C) and labels.shape == (B, L)
    assert torch.isfinite(logp).all()  # the fully padded row too
    valid = umask.reshape(-1) > 0
    np.testing.assert_allclose(logp.numpy()[valid], ref[valid], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(labels.numpy().reshape(-1)[valid], ref.argmax(-1)[valid])


@pytest.mark.parametrize("name", VARIANTS)
def test_eval_matches_jax(jax_runs, name):
    _check_eval(jax_runs, name, 2)


@pytest.mark.parametrize("name", ["MARN1_sp", "MARN1_nsps", "MARN1_sps"])
def test_eval_matches_jax_at_nine_parties(jax_runs, name):
    _check_eval(jax_runs, name, 9)
    qmask = jax_runs(name, 9)[1][1]
    assert qmask.shape[-1] == 9 and (qmask.argmax(-1)[qmask.sum(-1) > 0] >= 2).any()


@pytest.mark.parametrize("name", VARIANTS)
def test_state_dict_keys_equal_export_state_dict(jax_runs, name):
    params = jax_runs(name)[0]
    ported = from_jax_params(flatten_params(params))
    exported = export_state_dict(params, name, prefix="", log=lambda *_: None)
    assert sorted(ported) == sorted(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(ported[k].numpy(), v, err_msg=k)
    model = build_model(name, generator(0))
    model.load_state_dict(ported, strict=True)
    assert sorted(model.state_dict()) == sorted(exported)  # no buffer, no dropout


@pytest.mark.parametrize("name", VARIANTS)
def test_to_jax_params_inverts_from_jax_params(jax_runs, name):
    flat = flatten_params(jax_runs(name)[0])
    back = to_jax_params(from_jax_params(flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_nsps_listener_wraps_at_nine_parties():
    """The listener is party (1 - speaker) mod P: 1 for 0, 0 for 1, and at
    P = 9 party 8 for speaker 2 and 7 for speaker 3; a padded row (all-zero
    qmask, party 0 by argmax) reads party 1."""
    P = 9
    q = torch.arange(P, dtype=torch.float32)[None, :, None].expand(6, P, 4)
    speaker = torch.tensor([0, 1, 2, 3, 8, -1])
    qmask = torch.zeros(6, P)
    qmask[torch.arange(5), speaker[:5]] = 1.0
    got = marn_variants.listener(q, qmask)[:, 0]
    torch.testing.assert_close(got, torch.tensor([1.0, 0.0, 8.0, 7.0, 2.0, 1.0]))
    two = marn_variants.listener(q[:, :2], qmask[:, :2])[:2, 0]
    torch.testing.assert_close(two, torch.tensor([1.0, 0.0]))


def test_sps_orders_match_jax_and_leave_parties_from_two_out():
    rng = np.random.default_rng(0)
    speaker = rng.integers(0, 9, size=(7, 12))
    qmask = np.eye(9, dtype=np.float32)[speaker]
    qmask[3, 4] = 0.0  # a padded row counts as party 0
    ours = marn_variants.sps_orders(torch.from_numpy(qmask))
    theirs = jsps_orders(jnp.asarray(qmask))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    order0, order1, n0, n1 = (t.numpy() for t in ours)
    party = qmask.argmax(-1)
    others = (party >= 2).sum(1)
    assert (others > 0).all() and (n0 + n1 + others == 12).all()
    for t in range(7):
        assert (party[t, order0[t, :n0[t]]] == 0).all()
        assert (party[t, order1[t, :n1[t]]] == 1).all()
        assert list(order0[t, :n0[t]]) == sorted(order0[t, :n0[t]])  # batch order


@pytest.mark.parametrize("name", VARIANTS)
def test_eval_binds_the_rank1_attention_once_and_calls_it_a_step(name, monkeypatch):
    """One binding a forward, at p = 0 with the module's constant seed (not
    a parameter, not in the state dict), and one call a step for both
    directions, each on [2, B, 128] cell states."""
    calls, bind = [], marn_variants.rank1_bind

    def counting_bind(wq, wk, seed, p):
        attend = bind(wq, wk, seed, p)
        calls.append(("bind", tuple(wq.shape), int(seed), p))

        def counted(x1, x2, step):
            calls.append(("call", tuple(x1.shape), step))
            return attend(x1, x2, step)
        return counted

    monkeypatch.setattr(marn_variants, "rank1_bind", counting_bind)
    model = build_model(name, generator(0)).eval()
    x, qmask, umask = map(torch.as_tensor, get_model_spec(name).make_inputs(_batch(2)))
    with torch.inference_mode():
        model(x, qmask, umask)
    assert calls[0] == ("bind", (2, 128), 0, 0.0)
    assert calls[1:] == [("call", (2, B, 128), t) for t in range(L)]
    assert "rank1_seed" in dict(model.named_buffers())
    assert "rank1_seed" not in model.state_dict()
