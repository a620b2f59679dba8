"""Fused MFCC front end: the CUDA kernel's wrapper.

Counterpart of ``ser_tpu/ops/pallas/mfcc.py::mfcc_pallas`` with the same
contract, ``x [N, T] f32 -> [N, F, n_mfcc] f32``, F = 1 + (T - win) // hop.
The kernel is ``csrc/mfcc.cu``; its source note gives the design and what
bounds it on the card. It computes the spectrum by an FFT in shared memory,
so its constants are not the plain version's DFT matrices: the Hamming
window, a twiddle table and the mel filterbank as bands, all made here with
numpy in float64 and rounded once. The plain version is
``ser_tpu_torch.ops.mfcc.mfcc_ref``, and ``ser_tpu_torch.ops.mfcc.mfcc`` picks
between the two by device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ser_tpu_torch.ops.kernels import LAUNCHES

NAME = "mfcc"
WIN, NFFT = 400, 512  # the frame width and FFT length the kernel is written for
TILE_FRAMES = 24      # frames of one row a block takes at a time
ROUND = 32            # mel columns a warp sums side by side, a lane a column
SCRATCH_FLOATS = NFFT  # floats of a warp's scratch that every frame writes anew
EXTRA_STEPS_DIV = 4   # a mel round may grow by 1/4 of its steps to keep its lanes' banks apart


def twiddle_table(n_fft: int) -> np.ndarray:
    """``[n_fft // 2, 2]`` f32: cos and sin of ``-2 pi k / n_fft``, k < n_fft/2.
    The other half of the circle is its negative."""
    ang = -2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def _distinct_banks(lo: list[int], hi: list[int]) -> tuple[list[int], int]:
    """A start in ``[lo[c], hi[c]]`` for every column c, as many as possible
    all different modulo ``ROUND`` (a maximum bipartite matching by
    augmenting paths, each start as close to ``hi[c]`` as the others allow).
    Returns the starts and how many columns found no bank of their own;
    those start at ``hi[c]``."""
    owner: dict[int, int] = {}  # bank -> column
    start = list(hi)

    def place(c: int, seen: set[int]) -> bool:
        for s in range(hi[c], max(lo[c], hi[c] - ROUND + 1) - 1, -1):
            bank = s % ROUND
            if bank in seen:
                continue
            seen.add(bank)
            if bank not in owner or place(owner[bank], seen):
                owner[bank], start[c] = c, s
                return True
        return False

    # the columns with the fewest choices first
    order = sorted(range(len(lo)), key=lambda c: hi[c] - lo[c])
    return start, sum(not place(c, set()) for c in order)


def band_filterbank(mel: np.ndarray):
    """The filterbank ``[n_bins, n_mels]`` as the kernel reads it:
    ``(bands, weights)``. Columns go in rounds of ``ROUND``, a lane a column,
    and every lane of a round takes the same number of steps.

    ``bands`` is int32 ``[4, rounds * ROUND]``: the bin a lane starts reading
    at, its column's first nonzero bin, the length of the column's band, and
    the round's steps. ``weights`` holds, round after round, ``[steps,
    ROUND]`` floats: step i of lane j is the weight of bin ``start + i`` of
    column ``round * ROUND + j``, zero before and past the column's own band
    and for the lanes past the last column. A lane may start before its
    band: the starts of a round are chosen all different modulo ``ROUND``,
    so that the lanes' reads of the power spectrum fall into 32 different
    shared-memory banks at every step; if that needs more steps than the
    longest band, up to a quarter more are taken, and failing that as many
    lanes as possible get a bank of their own at the longest band's steps.
    ``start + steps`` stays inside the part of a warp's scratch that every
    frame writes anew (``SCRATCH_FLOATS``). A column whose nonzeros are not
    one contiguous run is refused; an all-zero column is a band of length 0."""
    n_bins, n_mels = mel.shape
    n_lanes = -(-n_mels // ROUND) * ROUND
    bands = np.zeros((4, n_lanes), np.int32)
    for m in range(n_mels):
        nz = np.flatnonzero(mel[:, m])
        if nz.size:
            first, length = int(nz[0]), int(nz[-1] - nz[0] + 1)
            if length != nz.size:
                raise ValueError(f"mel column {m} is not one contiguous band: "
                                 f"{nz.size} nonzeros over bins {first}..{int(nz[-1])}")
            bands[1:3, m] = first, length
    weights = []
    for m0 in range(0, n_lanes, ROUND):
        first, length = bands[1, m0:m0 + ROUND], bands[2, m0:m0 + ROUND]
        longest = int(length.max())
        if int((first + length).max()) > SCRATCH_FLOATS or longest > SCRATCH_FLOATS:
            raise ValueError(f"mel columns {m0}..{m0 + ROUND - 1}: a band ends past "
                             f"the kernel's scratch of {SCRATCH_FLOATS} floats")
        best = None
        for steps in range(longest, min(longest + longest // EXTRA_STEPS_DIV,
                                        SCRATCH_FLOATS) + 1):
            # a lane with no band of its own may start anywhere
            lo = [max(0, int(f + n) - steps) if n else 0 for f, n in zip(first, length)]
            hi = [min(int(f), SCRATCH_FLOATS - steps) if n else SCRATCH_FLOATS - steps
                  for f, n in zip(first, length)]
            start, shared = _distinct_banks(lo, hi)
            if best is None or not shared:
                best = (start, steps)
            if not shared:
                break
        start, steps = best  # all banks apart, or the most that can be at `longest`
        bands[0, m0:m0 + ROUND], bands[3, m0:m0 + ROUND] = start, steps
        block = np.zeros((steps, ROUND), np.float32)
        for j, m in enumerate(range(m0, min(m0 + ROUND, n_mels))):
            lead = int(first[j]) - start[j]
            block[lead:lead + length[j], j] = mel[first[j]:first[j] + length[j], m]
        weights.append(block.ravel())
    return bands, np.concatenate(weights) if weights else np.zeros(0, np.float32)


def kernel_constants(cfg, device) -> tuple[torch.Tensor, ...]:
    """``(window, twiddle, mel_bands, mel_weights, dct)`` of ``cfg`` on
    ``device``, made and copied there once per configuration and device."""
    device = torch.device(device)
    cache = cfg.kernel_on
    if device not in cache:
        bands, weights = band_filterbank(cfg.mel)
        cache[device] = tuple(
            torch.from_numpy(a).to(device)
            for a in (cfg.window, twiddle_table(cfg.n_fft), bands, weights, cfg.dct))
    return cache[device]


def _check(x: torch.Tensor, consts, cfg) -> None:
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be [N>=1, T], got {tuple(x.shape)}")
    if x.shape[1] < max(cfg.win_length, 2):
        raise ValueError("waveform too short for one frame")
    if (cfg.win_length, cfg.n_fft) != (WIN, NFFT):
        raise ValueError(f"kernel takes win_length {WIN} and n_fft {NFFT}, got "
                         f"{cfg.win_length} and {cfg.n_fft}")
    if cfg.hop < 1:
        raise ValueError(f"hop must be positive, got {cfg.hop}")
    want = {"x": (None, torch.float32),
            "window": ((WIN,), torch.float32),
            "twiddle": ((NFFT // 2, 2), torch.float32),
            "mel_bands": ((4, -(-cfg.n_mels // ROUND) * ROUND), torch.int32),
            "mel_weights": (tuple(consts[3].shape[:1]), torch.float32),  # any length, 1-D
            "dct": ((cfg.n_mels, cfg.n_mfcc), torch.float32)}
    for (name, (shape, dtype)), t in zip(want.items(), (x, *consts), strict=True):
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {shape}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, kernel takes "
                             f"{str(dtype).removeprefix('torch.')}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"x on {x.device}, kernel takes a CUDA tensor")


_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8
                    + [ctypes.c_float] * 2 + [ctypes.c_void_p])


@functools.cache
def _library() -> ctypes.CDLL:
    from ser_tpu_torch.ops.kernels.build import load

    lib = load(NAME)
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.mfcc_forward.argtypes = _LAUNCH_ARGTYPES
    lib.mfcc_bytes_floor.argtypes = _LAUNCH_ARGTYPES
    lib.mfcc_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
    for fn in (lib.mfcc_forward, lib.mfcc_bytes_floor, lib.mfcc_occupancy):
        fn.restype = ctypes.c_int
    return lib


def _launch(entry: str, x: torch.Tensor, cfg) -> torch.Tensor:
    consts = kernel_constants(cfg, x.device)
    _check(x, consts, cfg)
    N, T = x.shape
    F = cfg.n_frames(T)
    out = torch.empty((N, F, cfg.n_mfcc), dtype=torch.float32, device=x.device)
    fn = getattr(_library(), entry)
    ptrs = [t.data_ptr() for t in (x, *consts, out)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, N, T, F, cfg.win_length, cfg.hop, cfg.n_fft, cfg.n_mels,
                 cfg.n_mfcc, consts[3].shape[0], cfg.preemph, cfg.eps, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def mfcc_kernel(x: torch.Tensor, cfg) -> torch.Tensor:
    """Launch the kernel on CUDA tensor ``x`` [N, T] with the constants of
    ``cfg`` (an ``ops.mfcc.MFCCConfig``); returns ``[N, F, n_mfcc]``."""
    out = _launch("mfcc_forward", x, cfg)
    LAUNCHES[NAME] += 1
    return out


def launch_bytes_floor(x: torch.Tensor, cfg) -> torch.Tensor:
    """The kernel's grid, loads and stores with no arithmetic between them:
    timed, it gives the kernel's bytes floor. The output is not an MFCC."""
    return _launch("mfcc_bytes_floor", x, cfg)


def occupancy(cfg) -> tuple[int, int]:
    """``(dynamic shared memory of a block in bytes, blocks an SM holds at
    once)`` for ``cfg`` on the current device."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    n_weights = band_filterbank(cfg.mel)[1].shape[0]
    err = _library().mfcc_occupancy(cfg.hop, cfg.n_mels, cfg.n_mfcc, n_weights,
                                    ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"mfcc_occupancy: CUDA error {err}")
    return smem.value, blocks.value
