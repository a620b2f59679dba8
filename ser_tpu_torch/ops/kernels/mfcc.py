"""Fused MFCC front end: the CUDA kernel's wrapper.

Counterpart of ``ser_tpu/ops/pallas/mfcc.py::mfcc_pallas`` with the same
contract, ``x [N, T] f32 -> [N, F, n_mfcc] f32``, F = 1 + (T - win) // hop.
The kernel is ``csrc/mfcc.cu``; its source note gives the design and what
bounds it on the card. The plain version is ``ser_tpu_torch.ops.mfcc.mfcc_ref``,
and ``ser_tpu_torch.ops.mfcc.mfcc`` picks between the two by device.
"""

from __future__ import annotations

import ctypes

import torch

from ser_tpu_torch.ops.kernels import LAUNCHES

NAME = "mfcc"


def _check(x: torch.Tensor, consts, cfg) -> None:
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be [N>=1, T], got {tuple(x.shape)}")
    if x.shape[1] < max(cfg.win_length, 2):
        raise ValueError("waveform too short for one frame")
    if (cfg.win_length, cfg.n_fft) != (400, 512):
        raise ValueError("kernel takes win_length 400 and n_fft 512, got "
                         f"{cfg.win_length} and {cfg.n_fft}")
    nbins = cfg.n_fft // 2 + 1
    want = {"x": None, "dft_cos": (cfg.win_length, nbins),
            "dft_sin": (cfg.win_length, nbins), "mel": (nbins, cfg.n_mels),
            "dct": (cfg.n_mels, cfg.n_mfcc)}
    for (name, shape), t in zip(want.items(), (x, *consts)):
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, kernel takes float32")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"x on {x.device}, kernel takes a CUDA tensor")


def _library() -> ctypes.CDLL:
    from ser_tpu_torch.ops.kernels.build import load

    lib = load(NAME)
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.mfcc_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 7
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.mfcc_forward.restype = ctypes.c_int
    return lib


def mfcc_kernel(x: torch.Tensor, cfg) -> torch.Tensor:
    """Launch the kernel on CUDA tensor ``x`` [N, T] with the constants of
    ``cfg`` (an ``ops.mfcc.MFCCConfig``); returns ``[N, F, n_mfcc]``."""
    consts = cfg.tensors(x.device)
    _check(x, consts, cfg)
    N, T = x.shape
    F = cfg.n_frames(T)
    nbins = cfg.n_fft // 2 + 1
    out = torch.empty((N, F, cfg.n_mfcc), dtype=torch.float32, device=x.device)
    fn = _library().mfcc_forward
    ptrs = [t.data_ptr() for t in (x, *consts, out)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, N, T, F, cfg.win_length, cfg.hop, nbins, cfg.n_mels,
                 cfg.n_mfcc, cfg.preemph, cfg.eps, stream)
    if err != 0:
        raise RuntimeError(f"mfcc_forward launch failed: CUDA error {err}")
    LAUNCHES[NAME] += 1
    return out
