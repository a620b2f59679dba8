"""The port's MFCC front end on the CPU against the JAX package's.

``mfcc_ref`` (the kernel's plain version) against ``mfcc_xla`` and against
the Pallas kernel ``mfcc_pallas`` in interpret mode, at [2, 8000], with the
``MFCCConfig()`` default (40 mels, 13 coefficients) and the front end's
64 mels, 50 coefficients. Tolerance rtol 1e-4, atol 1e-4: f32 on both
sides, products summed in another order. The constant matrices are equal
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu.ops import dsp as jdsp
from ser_tpu.ops.pallas import mfcc as jmfcc
from ser_tpu_torch.ops import mfcc as tmfcc
from ser_tpu_torch.ops.dsp import pre_emphasis
from ser_tpu_torch.ops.kernels import LAUNCHES
from ser_tpu_torch.ops.kernels import mfcc as kmfcc

CONFIGS = {"default_40_13": {}, "frontend_64_50": {"n_mels": 64, "n_mfcc": 50}}


@pytest.fixture(scope="module")
def wav():
    return np.random.default_rng(1).standard_normal((2, 8000)).astype(np.float32)


@pytest.mark.parametrize("kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_mfcc_ref_matches_jax(wav, kw):
    jcfg, tcfg = jmfcc.MFCCConfig(**kw), tmfcc.MFCCConfig(**kw)
    before = sum(LAUNCHES.values())
    ours = tmfcc.mfcc(torch.from_numpy(wav), tcfg).numpy()
    assert sum(LAUNCHES.values()) == before  # the CPU runs the plain version
    xla = np.asarray(jmfcc.mfcc_xla(jnp.asarray(wav), jcfg))
    pallas = np.asarray(jmfcc.mfcc_pallas(jnp.asarray(wav), jcfg, interpret=True))
    assert ours.shape == xla.shape == (2, tcfg.n_frames(8000), tcfg.n_mfcc)
    np.testing.assert_allclose(ours, xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours, pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_constant_matrices_equal_jax(kw):
    jcfg, tcfg = jmfcc.MFCCConfig(**kw), tmfcc.MFCCConfig(**kw)
    for name in ("dft_cos", "dft_sin", "mel", "dct"):
        ours, theirs = getattr(tcfg, name), np.asarray(getattr(jcfg, name))
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    assert tcfg.dft_cos.shape == (400, 257)
    assert tcfg.mel.shape == (257, tcfg.n_mels)
    assert tcfg.tensors("cpu") is tcfg.tensors("cpu")  # copied once per device


def test_pre_emphasis_matches_jax(wav):
    np.testing.assert_array_equal(
        pre_emphasis(torch.from_numpy(wav)).numpy(),
        np.asarray(jdsp.pre_emphasis(jnp.asarray(wav))))


def test_frame_count_and_short_waveform():
    cfg = tmfcc.MFCCConfig()
    assert cfg.n_frames(16000) == 1 + (16000 - 400) // 160
    assert cfg.n_frames(400) == 1 and cfg.n_frames(399) == 0
    assert tmfcc.mfcc(torch.zeros(3, 400), cfg).shape == (3, 1, 13)
    with pytest.raises(ValueError, match="too short for one frame"):
        tmfcc.mfcc(torch.zeros(2, 399), cfg)


def test_kernel_wrapper_checks_run_before_any_build():
    cfg = tmfcc.MFCCConfig()
    consts = cfg.tensors("cpu")
    for x, match in ((torch.zeros(2, 800, dtype=torch.float64), "float32"),
                     (torch.zeros(800, 2).t(), "contiguous"),
                     (torch.zeros(2, 399), "too short"),
                     (torch.zeros(0, 800), "N>=1"),
                     (torch.zeros(2, 800), "CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            kmfcc._check(x, consts, cfg)
    with pytest.raises(ValueError, match="win_length 400 and n_fft 512"):
        kmfcc._check(torch.zeros(2, 800), consts, tmfcc.MFCCConfig(n_fft=1024))
    with pytest.raises(ValueError, match="mel: shape"):
        kmfcc._check(torch.zeros(2, 800), consts[:2] + consts[3:] + consts[2:3], cfg)
    # a CPU tensor handed to the kernel is refused before nvcc is looked for
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmfcc.mfcc_kernel(torch.zeros(2, 800), cfg)
    assert dict(LAUNCHES) == before
