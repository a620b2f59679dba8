"""The port's MARN1_mf, MARN1_la and MARN1_newz in eval against the JAX
package, on the CPU, and the ops they added.

Weights come from a JAX init through ``from_jax_params``; both sides see the
same synthetic batch at the same padded L = 10, B = 3, with row 2 fully
padded and row 0's qmask all zero at step 5 (it takes party 0 on both
sides). Outputs of the valid rows match at rtol 1e-3, atol 1e-4 (the port's
logit contract; newz's are raw logits) and every row is finite. At P = 9
(MELD's width, 1324 inputs) the same for mf and newz; newz also with
``causal_encoder=True`` against the JAX causal forward. The state-dict keys
equal ``export_state_dict(.., prefix="")`` and ``to_jax_params`` inverts
``from_jax_params``. ``lsthm_mf_gates`` and the masked encoder match the
JAX functions; the encoder with no mask runs the unmasked op sequence bit
for bit. One JAX init and apply a (model, P, causal), shared through a
module-scope fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.compat.torch_export import export_state_dict
from ser_tpu.models.marn_newz import MARN1NewZ as JMARN1NewZ
from ser_tpu.models.registry import get_model_spec as jget_model_spec
from ser_tpu.ops.cells import lsthm_mf_gates as jlsthm_mf_gates
from ser_tpu.ops.encoder import EncoderLayer as JEncoderLayer
from ser_tpu.train.checkpoint import flatten_params
from ser_tpu_torch.compat.from_jax import from_jax_params, jax_layout, to_jax_params
from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.models.marn_newz import MARN1NewZ
from ser_tpu_torch.models.registry import available_models, build_model, get_model_spec
from ser_tpu_torch.ops.cells import lsthm_mf_gates
from ser_tpu_torch.ops.encoder import EncoderLayer
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.serving import Predictor

MODELS = ("MARN1_mf", "MARN1_la", "MARN1_newz")
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
    """``(params, inputs, outputs)`` of a JAX init and eval apply for a
    (model, P), and with ``causal`` newz's causal forward on those params,
    made at first use."""
    cache = {}

    def get(name, P=2, causal=False):
        if (name, P, causal) not in cache:
            inputs = get_model_spec(name).make_inputs(_batch(P))
            spec = jget_model_spec(name)
            args = tuple(map(jnp.asarray, inputs))
            if causal:
                params = get(name, P)[0]
                model = JMARN1NewZ(n_classes=6, causal_encoder=True)
            else:
                model = spec.build(7 if P == 9 else 6, "MELD" if P == 9 else "IEMOCAP")
                key = jax.random.PRNGKey(1)
                params = model.init({"params": key, "dropout": key}, *args,
                                    deterministic=True)["params"]
            ref = np.asarray(spec.extract_logp(
                model.apply({"params": params}, *args, deterministic=True)))
            cache[name, P, causal] = params, inputs, ref
        return cache[name, P, causal]
    return get


def _check_eval(jax_runs, name, P, causal=False):
    params, (x, qmask, umask), ref = jax_runs(name, P, causal)
    C = 6 if name == "MARN1_newz" else 7 if P == 9 else 6  # newz has 6 whatever the flag
    state = from_jax_params(flatten_params(params))
    if causal:
        model = MARN1NewZ(generator=generator(0), causal_encoder=True).eval()
        model.load_state_dict(state, strict=True)
        with torch.inference_mode():
            out = model(*map(torch.as_tensor, (x, qmask, umask)))[0]
    else:
        pred = Predictor(name, state_dict=state, device="cpu", n_classes=7 if P == 9 else 6)
        out, labels = pred.predict(x, qmask, umask)
        assert labels.shape == (B, L)
    assert out.shape == (B * L, C) == ref.shape
    assert torch.isfinite(out).all()  # the fully padded row too
    valid = umask.reshape(-1) > 0
    np.testing.assert_allclose(out.numpy()[valid], ref[valid], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(out.numpy().argmax(-1)[valid], ref.argmax(-1)[valid])


@pytest.mark.parametrize("name", MODELS)
def test_eval_matches_jax(jax_runs, name):
    _check_eval(jax_runs, name, 2)


@pytest.mark.parametrize("name", ["MARN1_mf", "MARN1_newz"])
def test_eval_matches_jax_at_nine_parties(jax_runs, name):
    _check_eval(jax_runs, name, 9)
    qmask = jax_runs(name, 9)[1][1]
    assert qmask.shape[-1] == 9 and (qmask.argmax(-1)[qmask.sum(-1) > 0] >= 2).any()


def test_newz_causal_encoder_matches_jax(jax_runs):
    _check_eval(jax_runs, "MARN1_newz", 2, causal=True)
    # the causal forward is another function than the reference one
    assert not np.allclose(jax_runs("MARN1_newz", 2, True)[2], jax_runs("MARN1_newz")[2])


@pytest.mark.parametrize("name", MODELS)
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
    assert jax_layout(ported) == {"MARN1_newz": "leaves"}.get(name, "cells")


@pytest.mark.parametrize("name", MODELS)
def test_to_jax_params_inverts_from_jax_params(jax_runs, name):
    flat = flatten_params(jax_runs(name)[0])
    back = to_jax_params(from_jax_params(flat))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_registry_takes_the_three_out_of_the_queue():
    for name in MODELS:
        assert get_model_spec(name).name == name and name in available_models()
    # newz has 6 outputs whatever n_classes says, as the JAX registry builds it
    assert build_model("MARN1_newz", generator(0), n_classes=7).nn_out[3].weight.shape[0] == 6
    assert build_model("MARN1_mf", generator(0), n_classes=7).nn_out[3].weight.shape[0] == 7


def test_lsthm_mf_gates_matches_jax():
    rng = np.random.default_rng(0)
    sums, zg, c = (3 * rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 5, 512), (2, 5, 128), (2, 5, 128)))
    want = jlsthm_mf_gates(jnp.asarray(sums), jnp.asarray(zg), jnp.asarray(c))
    got = lsthm_mf_gates(*map(torch.from_numpy, (sums, zg, c)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # the memory-fusion gate lets c grow: f + sigmoid(V z) can exceed 1
    assert (np.abs(got[0].numpy()) > np.abs(c)).any()


@pytest.mark.parametrize("mask_kind", ["causal", "padding"])
def test_masked_encoder_matches_jax(mask_kind):
    """``EncoderLayer(100, 50, 8, 40, 40)`` with a ``[1, L, L]`` causal mask
    and a ``[B, 1, L]`` padding mask, on JAX-initialised weights."""
    rng = np.random.default_rng(1)
    Bm, Lm = 3, 7
    x = rng.standard_normal((Bm, Lm, 100)).astype(np.float32)
    if mask_kind == "causal":
        mask = np.tril(np.ones((1, Lm, Lm), np.float32))
    else:
        mask = np.ones((Bm, 1, Lm), np.float32)
        mask[1, :, 4:] = 0.0
        mask[2, :, :] = 0.0  # every key masked: a uniform row, not NaN
    jenc = JEncoderLayer(100, 50, 8, 40, 40)
    params = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x),
                                 slf_attn_mask=jnp.asarray(mask))[0])
    enc = EncoderLayer(100, 50, 8, 40, 40, generator=generator(0)).eval()
    enc.load_state_dict({k[len("e."):]: v for k, v in from_jax_params(
        {f"e/{k}": v for k, v in flatten_params(params).items()}).items()})
    got = enc(torch.from_numpy(x), None, torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    unmasked = enc(torch.from_numpy(x)).detach().numpy()
    assert not np.allclose(got.detach().numpy(), unmasked)


def test_encoder_without_mask_runs_the_unmasked_ops_bit_for_bit():
    """onlysp's and the six variants' encoders take no mask: their output is
    the unmasked op sequence's, bit for bit."""
    torch.manual_seed(0)
    enc = build_model("MARN1_onlysp", generator(0)).encoder_l.eval()
    x = torch.randn(4, 9, 100)
    att, ffn = enc.slf_attn, enc.pos_ffn
    q = att.w_qs(x).reshape(4, 9, 8, 40)
    k = att.w_ks(x).reshape(4, 9, 8, 40)
    v = att.w_vs(x).reshape(4, 9, 8, 40)
    attn = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q / 40 ** 0.5, k), dim=-1)
    out = att.layer_norm(att.fc(torch.einsum("bnqk,bknd->bqnd", attn, v).reshape(4, 9, -1)) + x)
    want = ffn.layer_norm(ffn.w_2(torch.relu(ffn.w_1(out))) + out)
    with torch.no_grad():
        torch.testing.assert_close(enc(x), want, rtol=0, atol=0)
        torch.testing.assert_close(enc(x, None, None), want, rtol=0, atol=0)
