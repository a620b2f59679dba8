"""Fused MFCC front end: constants, the plain PyTorch version and the entry
point (counterpart of ``ser_tpu/ops/pallas/mfcc.py``).

The pipeline is pre-emphasis -> frames of ``win_length`` at ``hop`` ->
window+DFT as two products with ``[win_length, n_bins]`` cos and sin
matrices (the Hamming window and the zero pad to ``n_fft`` folded in) ->
power -> mel filterbank product -> log(. + eps) -> DCT-II product. The
constant matrices are numpy copies of the JAX package's, so both packages
compute with the same numbers. ``mfcc`` launches the CUDA kernel
(``ops/kernels/mfcc.py``) on a CUDA tensor and runs ``mfcc_ref`` on a CPU
tensor. The kernel computes the same function by an FFT and reads neither
DFT matrix: its constants (``window``, a twiddle table, the filterbank as
bands, ``dct``) are made by its wrapper.
"""

from __future__ import annotations

import numpy as np
import torch

from ser_tpu_torch.ops.dsp import pre_emphasis
from ser_tpu_torch.ops.kernels.mfcc import mfcc_kernel


def hamming_window(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return (0.54 - 0.46 * np.cos(2 * np.pi * n / (win_length - 1))).astype(
        np.float32)


def dft_matrices(n_fft: int):
    """Real/imag DFT analysis matrices [n_fft, n_bins] for rfft bins."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """HTK-style triangular mel filterbank [n_bins, n_mels]."""
    if fmax is None:
        fmax = sr / 2.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_freqs = np.arange(n_bins) * sr / n_fft

    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, mid, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(mid - lo, 1e-10)
        down = (hi - bin_freqs) / max(hi - mid, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_mels, n_mfcc]."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    mat = np.cos(np.pi / n_mels * (n + 0.5) * k) * np.sqrt(2.0 / n_mels)
    mat[:, 0] /= np.sqrt(2.0)
    return mat.astype(np.float32)


class MFCCConfig:
    """The constant matrices of one front-end configuration, as numpy
    arrays, and their copies on each device they are asked for."""

    def __init__(self, sr=16000, n_fft=512, win_length=400, hop=160,
                 n_mels=40, n_mfcc=13, preemph=0.97, eps=1e-6):
        self.sr, self.n_fft, self.win_length = sr, n_fft, win_length
        self.hop, self.n_mels, self.n_mfcc = hop, n_mels, n_mfcc
        self.preemph, self.eps = preemph, eps
        self.window = window = hamming_window(win_length)
        cos_m, sin_m = dft_matrices(n_fft)
        # the window and the zero pad (win_length -> n_fft) folded into the
        # DFT matrices: frames stay win_length wide
        self.dft_cos = window[:, None] * cos_m[:win_length]
        self.dft_sin = window[:, None] * sin_m[:win_length]
        self.mel = mel_filterbank(sr, n_fft, n_mels)
        self.dct = dct_matrix(n_mels, n_mfcc)
        self._on: dict[torch.device, tuple[torch.Tensor, ...]] = {}
        # the CUDA kernel's own constants by device (``ops/kernels/mfcc.py``)
        self.kernel_on: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    def n_frames(self, n_samples: int) -> int:
        return max(0, 1 + (n_samples - self.win_length) // self.hop)

    def tensors(self, device) -> tuple[torch.Tensor, ...]:
        """``(dft_cos, dft_sin, mel, dct)`` on ``device``, copied there once."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.dft_cos, self.dft_sin, self.mel, self.dct))
        return self._on[device]


def _frame(x: torch.Tensor, cfg: MFCCConfig) -> torch.Tensor:
    """[B, T] -> pre-emphasized frames [B, F, win_length]."""
    F = cfg.n_frames(x.shape[1])
    y = pre_emphasis(x, cfg.preemph)
    idx = (torch.arange(F, device=x.device) * cfg.hop)[:, None] \
        + torch.arange(cfg.win_length, device=x.device)
    return y[:, idx]


def mfcc_ref(x: torch.Tensor, cfg: MFCCConfig) -> torch.Tensor:
    """Plain PyTorch version (of ``mfcc_xla``). x: [B, T] -> [B, F, n_mfcc]."""
    dft_cos, dft_sin, mel, dct = cfg.tensors(x.device)
    frames = _frame(x, cfg)
    re = torch.matmul(frames, dft_cos)
    im = torch.matmul(frames, dft_sin)
    power = re * re + im * im
    logmel = torch.log(torch.matmul(power, mel) + cfg.eps)
    return torch.matmul(logmel, dct)


def mfcc(x: torch.Tensor, cfg: MFCCConfig | None = None) -> torch.Tensor:
    """x: [B, T] waveforms -> [B, F, n_mfcc]. On a CUDA tensor this launches
    the kernel (or raises); on a CPU tensor it runs the plain version."""
    if cfg is None:
        cfg = MFCCConfig()
    if cfg.n_frames(x.shape[-1]) == 0:
        raise ValueError("waveform too short for one frame")
    if x.device.type == "cuda":
        return mfcc_kernel(x, cfg)
    if x.device.type == "cpu":
        return mfcc_ref(x, cfg)
    raise ValueError(f"no MFCC front end for device {x.device}")
