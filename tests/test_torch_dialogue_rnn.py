"""The port's DialogueRNN in eval against the JAX package, on the CPU.

- ``drnn_step`` against the JAX package's per-step ``_drnn_step`` at narrow
  widths and P = 3, both directions with their own weights, at t = 0 (an
  empty history) and t = 3 (the JAX buffer's rows past t hold junk, which
  its mask hides), with an all-zero qmask row (party 0 by argmax);
- ``matching_attention_general2`` against the JAX function, a fully padded
  row included (finite, zero);
- ``BiModel`` at narrow widths (D_m 32, D_g 24, D_p 20, D_e 16, D_h 12) at
  L = 10, at L = 34, where the JAX package's default is its chunked
  online-softmax step (``config.drnn_chunk``), and at P = 9: the
  log-probabilities, the pooling attention and both directions' context
  attentions on valid rows;
- the registry's full-width DialogueRNN (712 inputs, D_g = D_p = 500) at
  [6, 2] through ``Predictor``;
- on MELD's 1000-wide trimodal input the port raises ``ValueError``, where
  the JAX package raises ``TypeError`` (ROADMAP §C).

Valid rows only (the JAX package's P = 2 kept-rows path differs on padded
suffix steps, which no valid step reads), rtol 1e-3, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu import config as jconfig
from ser_tpu.models.dialogue_rnn import BiModel as JBiModel
from ser_tpu.models.dialogue_rnn import _drnn_step as jdrnn_step
from ser_tpu.models.dialogue_rnn import matching_attention_general2 as jmatching
from ser_tpu.models.registry import get_model_spec as jget_model_spec
from ser_tpu.train.checkpoint import flatten_params
from ser_tpu_torch.compat.from_jax import from_jax_params
from ser_tpu_torch.data.synthetic import synthetic_batch
from ser_tpu_torch.models.dialogue_rnn import BiModel, drnn_step, matching_attention_general2
from ser_tpu_torch.models.registry import get_model_spec
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.serving import Predictor

NARROW = dict(D_m=32, D_g=24, D_p=20, D_e=16, D_h=12)
RTOL, ATOL = 1e-3, 1e-4


def _inputs(L, B, P, D, seed):
    """Random time-major inputs with ragged lengths, the last row fully
    padded and an all-zero qmask row mid-sequence on row 0."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(L // 2, L + 1, size=B)
    lengths[0], lengths[-1] = L, 0
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    x = rng.standard_normal((L, B, D)).astype(np.float32) * umask.T[:, :, None]
    qmask = np.eye(P, dtype=np.float32)[rng.integers(0, P, size=(L, B))] * umask.T[:, :, None]
    qmask[L // 2, 0] = 0.0
    return x, qmask, umask


def test_step_matches_jax():
    rng = np.random.default_rng(0)
    B, P, t, L = 4, 3, 3, 6
    D_g, D_p, D_e = 24, 20, 16
    r = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    shapes = {"gWih_q": (D_p, 3 * D_g), "gWhh": (D_g, 3 * D_g), "gbhh": (3 * D_g,),
              "pWih_c": (D_g, 3 * D_p), "pWhh": (D_p, 3 * D_p), "pbhh": (3 * D_p,),
              "eWih": (D_p, 3 * D_e), "ebih": (3 * D_e,), "eWhh": (D_e, 3 * D_e),
              "ebhh": (3 * D_e,), "lWih_s": (D_p, 3 * D_p), "lWhh": (D_p, 3 * D_p),
              "lbhh": (3 * D_p,)}
    consts = {k: r(2, *s) for k, s in shapes.items()}  # a set a direction
    qm = np.eye(P, dtype=np.float32)[rng.integers(0, P, size=(2, B))]
    qm[0, 1] = 0.0  # all zero: party 0
    xs = {"qm": qm, "g_x": r(2, B, 3 * D_g), "p_x": r(2, B, 3 * D_p),
          "l_x": r(2, B, 3 * D_p), "att_x": r(2, B, D_g)}
    q, e, g = r(2, B, P, D_p), r(2, B, D_e), r(2, B, D_g)
    hist = r(2, L, B, D_g)  # rows >= t are junk the JAX mask hides
    for steps in (0, t):
        port_consts = [torch.from_numpy(consts[k][:, None] if consts[k].ndim == 2
                                        else consts[k]) for k in shapes]
        carry = (torch.from_numpy(q), torch.from_numpy(e), torch.from_numpy(g),
                 [torch.from_numpy(hist[:, j]) for j in range(steps)])
        (q_, e_, g_, h_), (e_out, alpha) = drnn_step(
            port_consts, carry, [torch.from_numpy(xs[k]) for k in xs], lambda v: v)
        assert len(h_) == steps + 1 and torch.equal(h_[-1], g_)
        assert alpha.shape == (2, B, steps) and torch.equal(e_out, e_)
        for d in range(2):
            jc = {k: jnp.asarray(v[d]) for k, v in consts.items()}
            (jq, je, jg, _, jt), (jeo, jalpha) = jdrnn_step(
                jc, (jnp.asarray(q[d]), jnp.asarray(e[d]), jnp.asarray(g[d]),
                     jnp.asarray(hist[d]), jnp.asarray(steps, jnp.int32)),
                {k: jnp.asarray(v[d]) for k, v in xs.items()}, listener_state=True,
                context_attention="general", dropout_rate=0.0, training=False)
            assert int(jt) == steps + 1
            for got, want in ((q_[d], jq), (e_[d], je), (g_[d], jg),
                              (alpha[d], np.asarray(jalpha)[:, :steps])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
            assert not np.asarray(jalpha)[:, steps:].any()


def test_matching_attention_general2_matches_jax():
    rng = np.random.default_rng(1)
    Lm, B, D = 7, 3, 10
    M = rng.standard_normal((Lm, B, D)).astype(np.float32)
    mask = (np.arange(Lm)[None, :] < np.array([7, 4, 0])[:, None]).astype(np.float32)
    W = rng.standard_normal((D, D)).astype(np.float32) / 3
    b = rng.standard_normal(D).astype(np.float32)
    want_pool, want_alpha = jmatching(jnp.asarray(M), jnp.asarray(M), jnp.asarray(mask),
                                      jnp.asarray(W), jnp.asarray(b))
    lin = torch.nn.Linear(D, D)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(W.T))
        lin.bias.copy_(torch.from_numpy(b))
        pool, alpha = matching_attention_general2(
            torch.from_numpy(M), torch.from_numpy(M), torch.from_numpy(mask), lin)
    assert torch.isfinite(pool).all() and not alpha[:, 2].any()  # the padded row
    np.testing.assert_allclose(pool.numpy(), np.asarray(want_pool), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_alpha), rtol=1e-5, atol=1e-6)


def _check_bimodel(L, B, P, seed):
    x, qmask, umask = _inputs(L, B, P, NARROW["D_m"], seed)
    jmodel = JBiModel(**NARROW, n_classes=6, listener_state=True, context_attention="general",
                      dropout_rec=0.1, dropout=0.1)
    args = tuple(map(jnp.asarray, (x, qmask, umask)))
    key = jax.random.PRNGKey(seed)
    params = jmodel.init({"params": key, "dropout": key}, *args, deterministic=True)["params"]
    want = [np.asarray(a) for a in jmodel.apply({"params": params}, *args, deterministic=True)]
    model = BiModel(**NARROW, generator=generator(0)).eval()
    model.load_state_dict(from_jax_params(flatten_params(params)), strict=True)
    with torch.inference_mode():
        got = [a.numpy() for a in model(*map(torch.from_numpy, (x, qmask, umask)))]
    assert [a.shape for a in got] == [a.shape for a in want]
    assert all(np.isfinite(a).all() for a in got)  # the fully padded row too
    valid = umask.T > 0  # [L, B]
    for g_, w_, what in zip(got, want, ("log_prob", "alpha", "alpha_f", "alpha_b")):
        np.testing.assert_allclose(g_[valid], w_[valid], rtol=RTOL, atol=ATOL, err_msg=what)
    return got


@pytest.mark.parametrize("L,B,P", [(10, 3, 2), (12, 4, 9)])
def test_bimodel_matches_jax_per_step(L, B, P):
    assert jconfig.drnn_chunk(L) is None
    alpha_f = _check_bimodel(L, B, P, seed=L)[2]
    # the context attention at step t covers steps 0..t-1 only
    assert not (alpha_f * np.triu(np.ones((L, L)))[:, None, :]).any()


def test_bimodel_matches_jax_chunked_default_at_34_steps():
    assert jconfig.drnn_chunk(34) == 16
    _check_bimodel(34, 3, 2, seed=5)


def test_registry_dialogue_rnn_matches_jax_at_full_width():
    batch = synthetic_batch(L=6, B=2, seed=2, min_len=3)
    spec = get_model_spec("DialogueRNN")
    x, qmask, umask = spec.make_inputs(batch)
    assert x.shape == (6, 2, 712)
    jspec = jget_model_spec("DialogueRNN")
    jmodel = jspec.build(6, "IEMOCAP")
    args = tuple(map(jnp.asarray, (x, qmask, umask)))
    key = jax.random.PRNGKey(3)
    params = jmodel.init({"params": key, "dropout": key}, *args, deterministic=True)["params"]
    want = np.asarray(jspec.extract_logp(jmodel.apply({"params": params}, *args,
                                                      deterministic=True)))
    pred = Predictor("DialogueRNN", state_dict=from_jax_params(flatten_params(params)),
                     device="cpu")
    out, labels = pred.predict(x, qmask, umask)
    assert out.shape == want.shape == (12, 6) and labels.shape == (2, 6)
    valid = umask.reshape(-1) > 0
    np.testing.assert_allclose(out.numpy()[valid], want[valid], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(labels.numpy().reshape(-1)[valid], want.argmax(-1)[valid])


def test_meld_trimodal_input_is_refused_as_in_jax():
    """MELD's trimodal input is 100 + 300 + 600 = 1000 wide against D_m =
    712: the JAX package fails in its first product (a ``TypeError``), the
    port names the widths (a ``ValueError``)."""
    batch = synthetic_batch(L=5, B=2, seed=0, n_parties=9, d_audio=300, d_visual=600,
                            n_classes=7)
    x, qmask, umask = get_model_spec("DialogueRNN").make_inputs(batch)
    assert x.shape[-1] == 1000
    with pytest.raises(ValueError, match="712.*1000"):
        Predictor("DialogueRNN", device="cpu", n_classes=7).predict(x, qmask, umask)
    jmodel = jget_model_spec("DialogueRNN").build(7, "MELD")
    key = jax.random.PRNGKey(0)
    with pytest.raises(TypeError, match="1000"):
        jmodel.init({"params": key, "dropout": key},
                    *map(jnp.asarray, (x, qmask, umask)), deterministic=True)
