"""Bidirectional onlysp eval recurrence: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``ser_tpu/ops/pallas/lsthm.py::lsthm_onlysp_recurrence_bidir``
with the same contract::

    seqs   = (xl_proj, xa_proj, gru_x, qmask), each [T, 2, B, .]
    consts = (K_l, b_l, K_a, b_a, gWhh, gbhh, wq, wk), each [2, .]
    returns  [T, 2, B, 4H] per-step outputs [h_l | h_a | z | h_s], f32

The kernel is ``csrc/lsthm_onlysp.cu``; its source note gives the design and
what bounds it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ser_tpu_torch.ops.attention import rank1_cross_attention
from ser_tpu_torch.ops.cells import gru_step, lsthm_gates
from ser_tpu_torch.ops.kernels import LAUNCHES
from ser_tpu_torch.ops.masking import scatter_parties, select_parties

NAME = "lsthm_onlysp"
H = 128
P = 2


def lsthm_onlysp_recurrence_bidir_ref(seqs, consts) -> torch.Tensor:
    """Plain PyTorch version: a loop over T of the ported ops, batched over
    the direction axis (the JAX package's direction-vmapped ``_eval_step``)."""
    xl_proj, xa_proj, gru_x, qmask = seqs
    K_l, b_l, K_a, b_a, gWhh, gbhh, wq, wk = (c.unsqueeze(1) if c.ndim == 2
                                              else c for c in consts)
    T, _, B = xl_proj.shape[:3]
    Hd = K_l.shape[-1] // 4
    zeros = lambda *s: xl_proj.new_zeros(s)
    h_l, c_l, h_a, c_a, z = (zeros(2, B, Hd) for _ in range(5))
    q = zeros(2, B, qmask.shape[-1], gWhh.shape[-2])
    ys = []
    for t in range(T):
        qm = qmask[t]
        h_s = gru_step(gru_x[t], select_parties(q, qm), gWhh, gbhh)
        q = scatter_parties(q, qm, h_s)
        sums_l = xl_proj[t] + torch.matmul(
            torch.cat([h_l, z, h_s], -1), K_l) + b_l
        c_l, h_l = lsthm_gates(sums_l, c_l)
        sums_a = xa_proj[t] + torch.matmul(
            torch.cat([h_a, z, h_s], -1), K_a) + b_a
        c_a, h_a = lsthm_gates(sums_a, c_a)
        z = rank1_cross_attention(c_l, c_a, wq, wk)
        ys.append(torch.cat([h_l, h_a, z, h_s], -1))
    return torch.stack(ys)


def _check(seqs, consts):
    xl_proj = seqs[0]
    T, D2, B = xl_proj.shape[:3]
    want = {
        "xl_proj": (T, 2, B, 4 * H), "xa_proj": (T, 2, B, 4 * H),
        "gru_x": (T, 2, B, 3 * H), "qmask": (T, 2, B, P),
        "K_l": (2, 3 * H, 4 * H), "b_l": (2, 4 * H),
        "K_a": (2, 3 * H, 4 * H), "b_a": (2, 4 * H),
        "gWhh": (2, H, 3 * H), "gbhh": (2, 3 * H), "wq": (2, H), "wk": (2, H),
    }
    if D2 != 2 or B < 1:
        raise ValueError(f"seqs must be [T, 2, B>=1, .], got {tuple(xl_proj.shape)}")
    for (name, shape), t in zip(want.items(), (*seqs, *consts)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, kernel takes float32")
        if t.device != xl_proj.device:
            raise ValueError(f"{name} on {t.device}, xl_proj on {xl_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _launch(seqs, consts) -> torch.Tensor:
    _check(seqs, consts)
    T, _, B = seqs[0].shape[:3]
    out = torch.empty((T, 2, B, 4 * H), dtype=torch.float32,
                      device=seqs[0].device)
    fn = _library().lsthm_onlysp_bidir
    ptrs = [t.data_ptr() for t in (*seqs, *consts, out)]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, T, B, stream)
    if err != 0:
        raise RuntimeError(f"lsthm_onlysp_bidir launch failed: CUDA error {err}")
    LAUNCHES[NAME] += 1
    return out


def _library() -> ctypes.CDLL:
    from ser_tpu_torch.ops.kernels.build import load

    lib = load(NAME)
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.lsthm_onlysp_bidir.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.lsthm_onlysp_bidir.restype = ctypes.c_int
    return lib


def lsthm_onlysp_recurrence_bidir(seqs, consts) -> torch.Tensor:
    """Both directions of the onlysp eval recurrence. On a CUDA tensor this
    launches the kernel (or raises); on a CPU tensor it runs the plain
    version."""
    dev = seqs[0].device
    if dev.type == "cuda":
        return _launch(seqs, consts)
    if dev.type == "cpu":
        return lsthm_onlysp_recurrence_bidir_ref(seqs, consts)
    raise ValueError(f"no recurrence for device {dev}")
