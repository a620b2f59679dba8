"""The port's ``NewZStream`` and ``python -m ser_tpu_torch.serve stream`` on
the CPU.

One 12-utterance dialogue (the trainer's 1124-wide rows, two parties)
through the port's stream, the port's ``MARN1NewZ(causal_encoder=True)``
batch forward and the JAX package's ``NewZStream``, all on the same
JAX-initialised weights: every appended utterance's raw logits match both
at rtol 1e-4, atol 1e-5 (the JAX package's own limits in
``tests/test_streaming.py``). ``reset`` reproduces the session; an append
past ``max_len`` raises ``ValueError``. The CLI prints the JSON keys of the
JAX ``serve.py stream`` and refuses another model with the JAX message and
another class count; the port's ``export``, ``run`` and ``bench``, as the
JAX ones, refuse to run without their required flags.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve as jserve
from ser_tpu.models.marn_newz import MARN1NewZ as JMARN1NewZ
from ser_tpu.streaming import NewZStream as JNewZStream
from ser_tpu.train.checkpoint import flatten_params
from ser_tpu_torch import serve as tserve
from ser_tpu_torch.compat.from_jax import from_jax_params
from ser_tpu_torch.models.marn_newz import MARN1NewZ
from ser_tpu_torch.ops.init import generator
from ser_tpu_torch.streaming import NewZStream

L, MAX_LEN = 12, 16


@pytest.fixture(scope="module")
def dialogue():
    """``(x, qmask, JAX params, JAX stream logits)`` of one dialogue."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((L, 1124)).astype(np.float32)
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=L)]
    key = jax.random.PRNGKey(3)
    params = JMARN1NewZ(n_classes=6).init(
        {"params": key, "dropout": key}, jnp.asarray(x[:, None]),
        jnp.asarray(qmask[:, None]), deterministic=True)["params"]
    stream = JNewZStream(params, max_len=MAX_LEN)
    want = np.stack([stream.append(x[t], qmask[t]) for t in range(L)])
    return x, qmask, params, want


def _model(params, causal=False):
    model = MARN1NewZ(generator=generator(0), causal_encoder=causal).eval()
    model.load_state_dict(from_jax_params(flatten_params(params)), strict=True)
    return model


def test_stream_matches_causal_batch_forward_and_jax_stream(dialogue):
    x, qmask, params, want = dialogue
    stream = NewZStream(_model(params), max_len=MAX_LEN)
    got = np.stack([stream.append(x[t], qmask[t]) for t in range(L)])
    assert got.shape == (L, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with torch.inference_mode():
        batch = _model(params, causal=True)(torch.from_numpy(x[:, None]),
                                            torch.from_numpy(qmask[:, None]))[0]
    np.testing.assert_allclose(got, batch.numpy(), rtol=1e-4, atol=1e-5)
    with torch.inference_mode():  # the reference encoder is another function
        bidir = _model(params)(torch.from_numpy(x[:, None]), torch.from_numpy(qmask[:, None]))[0]
    assert not np.allclose(got, bidir.numpy(), rtol=1e-4, atol=1e-5)
    # a pre-sliced 200-wide row is the same row
    stream.reset()
    np.testing.assert_array_equal(stream.append(x[0, :200], qmask[0]), got[0])


def test_reset_reproduces_the_session_and_max_len_raises(dialogue):
    x, qmask, params, _ = dialogue
    stream = NewZStream(_model(params), max_len=L)
    first = [stream.append(x[t], qmask[t]) for t in range(L)]
    with pytest.raises(ValueError, match=f"max_len={L}"):
        stream.append(x[0], qmask[0])
    stream.reset()
    again = [stream.append(x[t], qmask[t]) for t in range(L)]
    np.testing.assert_array_equal(np.stack(first), np.stack(again))


def _json(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def test_serve_stream_cli_prints_the_jax_keys(capsys):
    jserve.main(["stream", "--n_utts", "6"])
    theirs = _json(capsys.readouterr().out)
    tserve.main(["stream", "--n_utts", "6", "--device", "cpu"])
    ours = _json(capsys.readouterr().out)
    assert sorted(ours) == sorted(theirs)
    assert ours["model"] == "MARN1_newz" and ours["n_utterances"] == 6
    assert ours["contract"].startswith("equals MARN1NewZ(causal_encoder=True)")
    assert 0 <= ours["argmax_agreement_vs_bidirectional"] <= 1
    assert 0 < ours["max_logit_drift_vs_bidirectional"] < np.inf
    assert 0 < ours["ms_per_new_utterance_median"] <= ours["ms_per_new_utterance_p90"]


def test_serve_cli_refusals(capsys):
    with pytest.raises(SystemExit) as theirs:
        jserve.main(["stream", "--model", "MARN1_onlysp"])
    with pytest.raises(SystemExit) as ours:
        tserve.main(["stream", "--model", "MARN1_onlysp", "--device", "cpu"])
    assert str(ours.value) == str(theirs.value) and "MARN1_newz only" in str(ours.value)
    with pytest.raises(ValueError, match="6 logits whatever --n_classes"):
        tserve.main(["stream", "--n_classes", "7", "--device", "cpu"])
    for cmd in ("export", "run", "bench"):  # their required flags
        for main in (jserve.main, tserve.main):
            with pytest.raises(SystemExit) as refused:
                main([cmd])
            assert refused.value.code == 2
    assert "the following arguments are required" in capsys.readouterr().err
