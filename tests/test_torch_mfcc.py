"""The port's MFCC front end on the CPU against the JAX package's.

``mfcc_ref`` (the kernel's plain version) against ``mfcc_xla`` and against
the Pallas kernel ``mfcc_pallas`` in interpret mode, at [2, 8000], with the
``MFCCConfig()`` default (40 mels, 13 coefficients) and the front end's
64 mels, 50 coefficients. Tolerance rtol 1e-4, atol 1e-4: f32 on both
sides, products summed in another order. The constant matrices are equal
bit for bit.

What the CUDA kernel is fed is checked here too, without a card: the banded
filterbank, the twiddle and window tables, the kernel's algebra (even/odd
packing, a 256-point complex FFT, the split to 257 real bins, banded mel
sums, log, DCT) in numpy on those tables against ``mfcc_ref`` at the
kernel's own tolerance (rtol 1e-5, atol 2e-4: the spectrum is summed in
another order and the window is applied before, not inside, the transform),
and the wrapper's constants against the ``.cu`` source.
"""

import re


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
    consts = kmfcc.kernel_constants(cfg, "cpu")
    assert len(consts) == 5 and consts is kmfcc.kernel_constants(cfg, "cpu")
    for x, match in ((torch.zeros(2, 800, dtype=torch.float64), "float32"),
                     (torch.zeros(800, 2).t(), "contiguous"),
                     (torch.zeros(2, 399), "too short"),
                     (torch.zeros(0, 800), "N>=1"),
                     (torch.zeros(2, 800), "CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            kmfcc._check(x, consts, cfg)
    with pytest.raises(ValueError, match="win_length 400 and n_fft 512"):
        kmfcc._check(torch.zeros(2, 800), consts, tmfcc.MFCCConfig(n_fft=1024))
    with pytest.raises(ValueError, match="mel_bands: shape"):
        kmfcc._check(torch.zeros(2, 800), consts[:2] + consts[3:] + consts[2:3], cfg)
    with pytest.raises(ValueError, match="dct: shape"):
        kmfcc._check(torch.zeros(2, 800), consts[:4] + (consts[4].t(),), cfg)
    with pytest.raises(ValueError, match="mel_bands: dtype"):
        kmfcc._check(torch.zeros(2, 800),
                     consts[:2] + (consts[2].float(),) + consts[3:], cfg)
    assert consts[2].shape == (4, 64)  # 40 columns and the idle lanes of round 2
    # a CPU tensor handed to the kernel is refused before nvcc is looked for,
    # and the kernel's constants hold no DFT matrix
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmfcc.mfcc_kernel(torch.zeros(2, 800), cfg)
    assert dict(LAUNCHES) == before
    assert sum(t.numel() for t in consts) < 8192  # the DFT matrices were 205,600


def _unband_filterbank(bands: np.ndarray, weights: np.ndarray, n_bins: int,
                      n_mels: int) -> np.ndarray:
    """The dense ``[n_bins, n_mels]`` filterbank of ``band_filterbank``'s
    output, every weight placed at the bin its lane reads at that step."""
    mel = np.zeros((n_bins, n_mels), np.float32)
    base = 0
    for m0 in range(0, bands.shape[1], kmfcc.ROUND):
        steps = int(bands[3, m0])
        block = weights[base:base + steps * kmfcc.ROUND].reshape(steps, kmfcc.ROUND)
        for m in range(m0, min(m0 + kmfcc.ROUND, n_mels)):
            bins = bands[0, m] + np.arange(steps)
            keep = bins < n_bins
            mel[bins[keep], m] = block[keep, m - m0]
        base += steps * kmfcc.ROUND
    return mel


BANKS = {**CONFIGS, "mels_80": {"n_mels": 80}, "mels_23": {"n_mels": 23}}


@pytest.mark.parametrize("kw", BANKS.values(), ids=BANKS.keys())
def test_banded_filterbank_rebuilds_the_dense_one(kw):
    cfg = tmfcc.MFCCConfig(**kw)
    bands, weights = kmfcc.band_filterbank(cfg.mel)
    n_lanes = -(-cfg.n_mels // kmfcc.ROUND) * kmfcc.ROUND
    assert bands.dtype == np.int32 and bands.shape == (4, n_lanes)
    start, first, length, steps = bands
    assert (length[:cfg.n_mels] >= 1).all() and (length[cfg.n_mels:] == 0).all()
    assert int(length.sum()) == np.count_nonzero(cfg.mel)
    real = np.arange(n_lanes) < cfg.n_mels
    assert (start[real] <= first[real]).all()  # a lane covers its whole band
    assert (first[real] + length[real] <= start[real] + steps[real]).all()
    assert (start >= 0).all() and (start + steps <= kmfcc.SCRATCH_FLOATS).all()
    for m0 in range(0, n_lanes, kmfcc.ROUND):  # one trip count a round
        rnd = slice(m0, m0 + kmfcc.ROUND)
        assert (steps[rnd] == steps[m0]).all()
        assert length[rnd].max() <= steps[m0] <= length[rnd].max() * 5 // 4
    assert weights.dtype == np.float32
    assert weights.size == kmfcc.ROUND * int(steps[::kmfcc.ROUND].sum())
    # what is not a column's own band is zero: nothing but cfg.mel's nonzeros
    assert np.count_nonzero(weights) == np.count_nonzero(cfg.mel)
    np.testing.assert_array_equal(
        _unband_filterbank(bands, weights, 257, cfg.n_mels), cfg.mel)


def test_banded_filterbank_keeps_the_lanes_banks_apart():
    """The front end's 64 mels: the long round (21 steps) reads 32 different
    banks at every step; the short one shares at most two lanes a bank."""
    bands, _ = kmfcc.band_filterbank(tmfcc.MFCCConfig(n_mels=64, n_mfcc=50).mel)
    lanes_a_bank = [int(np.bincount(bands[0, m0:m0 + 32] % 32, minlength=32).max())
                    for m0 in (0, 32)]
    assert bands[3, ::32].tolist() == [6, 21] and lanes_a_bank == [2, 1]
    starts, shared = kmfcc._distinct_banks([0, 0, 0], [0, 0, 33])
    assert shared == 1 and sorted(s % 32 for s in starts) == [0, 0, 1]
    starts, shared = kmfcc._distinct_banks([0, 30, 0], [0, 32, 33])
    assert shared == 0 and len({s % 32 for s in starts}) == 3


def test_banded_filterbank_refuses_a_gap_and_takes_an_empty_column():
    mel = tmfcc.MFCCConfig().mel.copy()
    col = int(np.argmax((mel != 0).sum(axis=0)))
    nz = np.flatnonzero(mel[:, col])
    assert nz.size >= 3
    mel[nz[1], col] = 0.0
    with pytest.raises(ValueError, match=f"mel column {col} is not one contiguous band"):
        kmfcc.band_filterbank(mel)
    mel[:, col] = 0.0
    bands, weights = kmfcc.band_filterbank(mel)
    assert bands[2, col] == 0
    np.testing.assert_array_equal(_unband_filterbank(bands, weights, 257, 40), mel)
    wide = np.zeros((1200, 2), np.float32)  # a band past a warp's scratch
    wide[500:1100, 1] = 1.0
    with pytest.raises(ValueError, match="past the kernel's scratch"):
        kmfcc.band_filterbank(wide)


def test_twiddle_and_window_tables_are_float64_rounded_once():
    cfg = tmfcc.MFCCConfig()
    k = np.arange(256, dtype=np.float64)
    tw = kmfcc.twiddle_table(512)
    assert tw.dtype == np.float32 and tw.shape == (256, 2)
    np.testing.assert_array_equal(tw[:, 0], np.cos(-2 * np.pi * k / 512).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], np.sin(-2 * np.pi * k / 512).astype(np.float32))
    assert tw[0].tolist() == [1.0, 0.0] and tw[128, 1] == -1.0
    n = np.arange(400, dtype=np.float64)
    assert cfg.window.dtype == np.float32
    np.testing.assert_array_equal(
        cfg.window, (0.54 - 0.46 * np.cos(2 * np.pi * n / 399)).astype(np.float32))
    window, twiddle = kmfcc.kernel_constants(cfg, "cpu")[:2]
    np.testing.assert_array_equal(window.numpy(), cfg.window)
    np.testing.assert_array_equal(twiddle.numpy(), tw)
    # the window folded into the plain version's matrices is this window
    np.testing.assert_array_equal(cfg.dft_cos[:, 0], cfg.window)


def _kernel_algebra(x: np.ndarray, cfg) -> np.ndarray:
    """The kernel's steps in numpy f32 on the kernel's own tables; the
    256-point complex FFT itself comes from ``np.fft.fft`` (complex64 in,
    rounded to complex64 out)."""
    f32 = np.float32
    window, twiddle, bands, weights, dct = (
        t.numpy() for t in kmfcc.kernel_constants(cfg, "cpu"))
    p = f32(cfg.preemph)
    prev = np.concatenate([x[:, 1:2], x[:, :-1]], axis=1)
    y = x - p * prev
    F = cfg.n_frames(x.shape[1])
    idx = np.arange(F)[:, None] * cfg.hop + np.arange(cfg.win_length)
    v = np.zeros((x.shape[0], F, cfg.n_fft), f32)
    v[..., :cfg.win_length] = y[:, idx] * window
    z = (v[..., 0::2] + 1j * v[..., 1::2]).astype(np.complex64)
    Z = np.fft.fft(z, axis=-1).astype(np.complex64)
    k = np.arange(129)
    a, b = Z[..., k], np.conj(Z[..., (256 - k) % 256])
    xe, xo = f32(0.5) * (a + b), f32(-0.5) * 1j * (a - b)  # the kernel halves the window instead
    u = (twiddle[k, 0] + 1j * twiddle[k, 1]).astype(np.complex64) * xo
    lo, hi = (xe + u).astype(np.complex64), (xe - u).astype(np.complex64)
    power = np.zeros(Z.shape[:-1] + (257,), f32)
    power[..., 256 - k] = hi.real ** 2 + hi.imag ** 2
    power[..., k] = lo.real ** 2 + lo.imag ** 2
    logmel = np.zeros(power.shape[:-1] + (cfg.n_mels,), f32)
    scratch = np.zeros(power.shape[:-1] + (kmfcc.SCRATCH_FLOATS,), f32)
    scratch[..., :257] = power  # a lane reads on past its band, at zero weight
    scratch[..., 257:] = 1e30  # what lies past the spectrum meets zero weights only
    base = 0
    for m in range(cfg.n_mels):
        start, steps = bands[0, m], bands[3, m]
        acc = np.zeros(power.shape[:-1], f32)
        for i in range(steps):  # ascending k, as the kernel sums
            acc = acc + scratch[..., start + i] * weights[base + kmfcc.ROUND * i + m % kmfcc.ROUND]
        logmel[..., m] = np.log(acc + f32(cfg.eps))
        if m % kmfcc.ROUND == kmfcc.ROUND - 1:
            base += kmfcc.ROUND * steps
    return logmel @ dct


def _tone(T=8000, hz=440.0):
    return np.sin(2 * np.pi * hz * np.arange(T) / 16000)[None].astype(np.float32)


@pytest.mark.parametrize("kw", CONFIGS.values(), ids=CONFIGS.keys())
@pytest.mark.parametrize("signal", ["noise", "tone_440hz", "zeros"])
def test_kernel_algebra_matches_plain_version(wav, kw, signal):
    cfg = tmfcc.MFCCConfig(**kw)
    x = {"noise": wav, "tone_440hz": _tone(), "zeros": np.zeros((1, 4096), np.float32)}[signal]
    want = tmfcc.mfcc_ref(torch.from_numpy(x), cfg).numpy()
    got = _kernel_algebra(x, cfg)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
    if signal == "zeros":  # padded rows: log(eps) through the DCT, every frame alike
        assert (got == got[:, :1]).all()
        np.testing.assert_allclose(  # the orthonormal DCT's coefficient 0
            got[0, 0, 0], np.log(1e-6) * np.sqrt(cfg.n_mels), rtol=1e-5)


def test_kernel_algebra_with_another_hop(wav):
    cfg = tmfcc.MFCCConfig(hop=200, n_mels=64, n_mfcc=50)
    want = tmfcc.mfcc_ref(torch.from_numpy(wav), cfg).numpy()
    assert want.shape == (2, 39, 50)
    np.testing.assert_allclose(_kernel_algebra(wav, cfg), want, rtol=1e-5, atol=2e-4)


def test_wrapper_constants_match_the_kernel_source():
    """The wrapper's frame width, FFT length and tile height are the
    kernel's; the source forms no dense DFT product and calls no library."""
    from ser_tpu_torch.ops.kernels.build import CSRC

    src = (CSRC / f"{kmfcc.NAME}.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("WIN") == kmfcc.WIN == tmfcc.MFCCConfig().win_length
    assert const("NFFT") == kmfcc.NFFT == tmfcc.MFCCConfig().n_fft
    assert const("R") == kmfcc.TILE_FRAMES
    # the power spectrum and the Z it overwrites: 256 complex slots of SCR
    assert kmfcc.SCRATCH_FLOATS == const("NFFT") <= 2 * const("SCR")
    assert "m0 += 32" in src and kmfcc.ROUND == 32  # a round is a warp wide
    code = re.sub(r"//.*", "", src)
    for gone in ("dcos", "dsin", "dft_cos", "dft_sin", "cufft", "cublas", "sincos",
                 "sinf", "cosf", "atomic"):
        assert gone not in code, gone
    # both C entry points take the same arguments, as the wrapper declares them
    entries = re.findall(r'extern "C" int (mfcc_forward|mfcc_bytes_floor)\(([^)]*)\)', src)
    assert [e[0] for e in entries] == ["mfcc_forward", "mfcc_bytes_floor"]
    assert all(len(e[1].split(",")) == len(kmfcc._LAUNCH_ARGTYPES) for e in entries)
