"""The host data path's padded-batch assembly in C (counterpart of
``ser_tpu/native``): ``collate.c`` built at first use with ``cc -O3 -shared
-fPIC`` into ``build/kernels/`` (``ops/kernels/build.py::build_c``) and
bound with ctypes. ``data/collate.py::collate`` scatters every batch
through it. There is no fallback: where the library cannot be built, the
first call raises and names the command.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ser_tpu_torch.ops.kernels.build import build_c

SOURCE = Path(__file__).with_name("collate.c")

_lib = None
_lock = threading.Lock()  # a loader's prefetch thread may be the first caller
_PTRS = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32)]


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_c(SOURCE)))
            lib.pad_time_major.argtypes = _PTRS + [ctypes.c_int32] * 4 + [ctypes.c_void_p]
            for fn in (lib.pad_batch_first_f32, lib.pad_batch_first_i32):
                fn.argtypes = _PTRS + [ctypes.c_int32] * 2 + [ctypes.c_void_p]
            for fn in (lib.pad_time_major, lib.pad_batch_first_f32, lib.pad_batch_first_i32):
                fn.restype = None
            _lib = lib
    return _lib


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])


def _lens(arrays, L, B, ndim):
    """The rows' lengths and a pointer to them, after the checks that keep
    the C loops inside the buffers: at most B rows of ``ndim`` dimensions,
    none longer than L."""
    lens = np.asarray([a.shape[0] for a in arrays], dtype=np.int32)
    if len(arrays) > B or any(a.ndim != ndim for a in arrays) or lens.max(initial=0) > L:
        raise ValueError(f"{len(arrays)} rows of lengths up to {lens.max(initial=0)} and "
                         f"{sorted({a.ndim for a in arrays})} dimensions do not fit "
                         f"[{L}, {B}] ({ndim} dimensions a row)")
    return lens, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def pad_time_major(arrays, L: int, B: int) -> np.ndarray:
    """Ragged ``[T_b, D]`` float32 arrays -> zero-padded ``[L, B, D]``."""
    lib = _library()
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    lens, lens_p = _lens(arrays, L, B, 2)
    if len({a.shape[1] for a in arrays}) != 1:
        raise ValueError(f"rows of widths {sorted({a.shape[1] for a in arrays})}; one is needed")
    out = np.empty((L, B, arrays[0].shape[1]), dtype=np.float32)  # C writes every byte
    lib.pad_time_major(_ptrs(arrays), lens_p, len(arrays), B, out.shape[2], L,
                       out.ctypes.data_as(ctypes.c_void_p))
    return out


def pad_batch_first(arrays, L: int, B: int, dtype=np.float32) -> np.ndarray:
    """Ragged ``[T_b]`` rows -> zero-padded ``[B, L]``, float32 or int32."""
    lib = _library()
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.int32):
        raise ValueError(f"pad_batch_first takes float32 or int32, not {dtype}")
    arrays = [np.ascontiguousarray(a, dtype=dtype) for a in arrays]
    lens, lens_p = _lens(arrays, L, B, 1)
    out = np.zeros((B, L), dtype=dtype)
    fn = lib.pad_batch_first_f32 if dtype == np.float32 else lib.pad_batch_first_i32
    fn(_ptrs(arrays), lens_p, len(arrays), L, out.ctypes.data_as(ctypes.c_void_p))
    return out
