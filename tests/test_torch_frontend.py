"""The port's ``MFCCFrontend`` on the CPU against the JAX package's
``MFCCFrontend(use_pallas=False)``, on padded ``[L, B, T]`` waveforms.

Tolerance rtol 1e-4, atol 1e-4 (f32, pooled over frames in another order).
Cases: plain pooling; frame-masked pooling with per-dialogue ``wav_len``;
all-zero rows (batch padding); a dialogue shorter than one frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.data.frontend import MFCCFrontend as JMFCCFrontend
from ser_tpu_torch.data.frontend import FRONTENDS, MFCCFrontend, make_frontend

L, B, T = 3, 4, 2048


def _wav():
    rng = np.random.default_rng(2)
    wav = rng.standard_normal((L, B, T)).astype(np.float32)
    wav[:, 3] = 0.0  # a padded dialogue: all-zero rows
    wav[2, 1] = 0.0  # a padded utterance slot
    wav[:, 2, 1200:] = 0.0  # a dialogue that ends inside the bucket
    wav[:, 0, 300:] = 0.0  # a dialogue shorter than one frame
    return wav


WAV_LENS = {"no_wav_len": None, "wav_len": np.array([300, 2048, 1200, 0], np.int32)}


@pytest.mark.parametrize("wav_len", WAV_LENS.values(), ids=WAV_LENS.keys())
def test_frontend_matches_jax(wav_len):
    wav = _wav()
    ours = MFCCFrontend()(torch.from_numpy(wav),
                          None if wav_len is None else torch.from_numpy(wav_len))
    theirs = np.asarray(JMFCCFrontend(use_pallas=False)(
        jnp.asarray(wav), None if wav_len is None else jnp.asarray(wav_len)))
    assert ours.shape == (L, B, 100)
    assert torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)
    # all-zero rows: std 0 up to rounding, one constant vector
    zero = ours[:, 3].numpy()
    np.testing.assert_allclose(zero[:, 50:], 0.0, atol=1e-6)
    np.testing.assert_array_equal(zero, np.broadcast_to(zero[0], zero.shape))
    if wav_len is not None:  # shorter than one frame: no frame pooled
        np.testing.assert_array_equal(ours[:, 0].numpy(), 0.0)


def test_frontend_two_dimensional_input():
    wav = _wav()[0]
    np.testing.assert_array_equal(MFCCFrontend()(torch.from_numpy(wav)).numpy(),
                                  MFCCFrontend()(torch.from_numpy(wav[None]))[0].numpy())


def test_make_frontend_names():
    assert all(make_frontend(n) is None for n in (None, "", "none"))
    fe = make_frontend("mfcc")
    assert isinstance(fe, MFCCFrontend) and sorted(FRONTENDS) == ["mfcc"]
    assert (fe.cfg.n_mels, fe.cfg.n_mfcc) == (64, 50)
    with pytest.raises(KeyError, match="mfcc"):
        make_frontend("fbank")
    with pytest.raises(ValueError, match="even"):
        MFCCFrontend(out_dim=99)
