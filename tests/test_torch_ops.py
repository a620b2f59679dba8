"""The port's ops (``ser_tpu_torch.ops``) against their JAX counterparts on
the same seeded numpy inputs, on the CPU. Tolerance rtol 1e-5, atol 1e-5:
both sides are f32 and differ only in summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import attention as jattn
from ser_tpu.ops import cells as jcells
from ser_tpu.ops import masking as jmask
from ser_tpu.ops.encoder import EncoderLayer as JEncoderLayer
from ser_tpu.train.checkpoint import flatten_params
from ser_tpu_torch.compat.from_jax import from_jax_params
from ser_tpu_torch.ops import attention as tattn
from ser_tpu_torch.ops import cells as tcells
from ser_tpu_torch.ops import masking as tmask
from ser_tpu_torch.ops.encoder import EncoderLayer
from ser_tpu_torch.ops.init import generator

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def test_lsthm_gates():
    rng = np.random.default_rng(0)
    sums, c = _rand(rng, 5, 4 * 16, scale=3.0), _rand(rng, 5, 16)
    for p, r in zip(tcells.lsthm_gates(torch.from_numpy(sums), torch.from_numpy(c)),
                    jcells.lsthm_gates(jnp.asarray(sums), jnp.asarray(c))):
        _close(p, r)


def test_gru_step():
    rng = np.random.default_rng(1)
    x, h = _rand(rng, 4, 3 * 16), _rand(rng, 4, 16)
    W, b = _rand(rng, 16, 3 * 16, scale=0.3), _rand(rng, 3 * 16)
    _close(tcells.gru_step(*map(torch.from_numpy, (x, h, W, b))),
           jcells.gru_step(*map(jnp.asarray, (x, h, W, b))))


def _qmask(rng, L, B, P=2):
    qm = np.eye(P, dtype=np.float32)[rng.integers(0, P, size=(L, B))]
    qm[:, -1] = 0.0  # a padded row: all-zero qmask
    return qm


def test_reverse_seq():
    rng = np.random.default_rng(2)
    L, B = 7, 4
    x = _rand(rng, L, B, 5)
    umask = (np.arange(L)[None, :] < np.array([7, 3, 1, 0])[:, None]).astype(np.float32)
    _close(tmask.reverse_seq(torch.from_numpy(x), torch.from_numpy(umask)),
           jmask.reverse_seq(jnp.asarray(x), jnp.asarray(umask)))


def test_select_parties_zero_row_picks_party_0():
    rng = np.random.default_rng(3)
    q, qm = _rand(rng, 5, 2, 8), _qmask(rng, 1, 5)[0]
    got = tmask.select_parties(torch.from_numpy(q), torch.from_numpy(qm))
    _close(got, jmask.select_parties(jnp.asarray(q), jnp.asarray(qm)))
    np.testing.assert_array_equal(got[-1].numpy(), q[-1, 0])


def test_scatter_parties():
    rng = np.random.default_rng(4)
    q, qm, s = _rand(rng, 5, 2, 8), _qmask(rng, 1, 5)[0], _rand(rng, 5, 8)
    got = tmask.scatter_parties(*map(torch.from_numpy, (q, qm, s)))
    _close(got, jmask.scatter_parties(*map(jnp.asarray, (q, qm, s))))
    np.testing.assert_array_equal(got[-1].numpy(), q[-1])  # padded: untouched


@pytest.mark.parametrize("oracle", ["fused", "naive"])
def test_rank1_cross_attention(oracle):
    rng = np.random.default_rng(5)
    x1, x2 = _rand(rng, 3, 32), _rand(rng, 3, 32)
    wq, wk = _rand(rng, 32), _rand(rng, 32)
    got = tattn.rank1_cross_attention(*map(torch.from_numpy, (x1, x2, wq, wk)))
    args = tuple(map(jnp.asarray, (x1, x2, wq, wk)))
    ref = (jattn.rank1_cross_attention(*args, 0.0, True, None)
           if oracle == "fused" else jattn.rank1_cross_attention_naive(*args))
    _close(got, ref)


def test_encoder_layer():
    """``EncoderLayer(100, 40, 8, 40, 40)`` with JAX-initialised weights
    carried over by ``from_jax_params``."""
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 7, 100)
    jenc = JEncoderLayer(100, 40, 8, 40, 40)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref, _ = jenc.apply({"params": params}, jnp.asarray(x))
    flat = {f"encoder_l/{k}": v for k, v in flatten_params(params).items()}
    sd = {k.removeprefix("encoder_l."): v
          for k, v in from_jax_params(flat).items()}
    enc = EncoderLayer(100, 40, 8, 40, 40, generator=generator(0))
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        _close(enc(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("kind", ["seq", "reseq"])
def test_cross_attention_seq(kind):
    """Sequence cross attentions with random (not ones) weights, time-major
    ``[L, B, D]`` and unmasked."""
    rng = np.random.default_rng(7)
    L1, L2, B = 5, 6, 2
    d2 = 100 if kind == "seq" else 128
    x1, x2 = _rand(rng, L1, B, 100, scale=0.2), _rand(rng, L2, B, d2, scale=0.2)
    w = {"Wq": _rand(rng, 100, 128, scale=0.1), "Wk": _rand(rng, d2, 128, scale=0.1),
         "Wv": _rand(rng, d2, 128, scale=0.1)}
    jmod = jattn.CrossAttentionSeq() if kind == "seq" else jattn.CrossAttentionReSeq()
    ref = jmod.apply({"params": {k: jnp.asarray(v) for k, v in w.items()}},
                     jnp.asarray(x1), jnp.asarray(x2))
    mod = tattn.CrossAttentionSeq() if kind == "seq" else tattn.CrossAttentionReSeq()
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()}, strict=True)
    with torch.no_grad():
        _close(mod(torch.from_numpy(x1), torch.from_numpy(x2)), ref)
