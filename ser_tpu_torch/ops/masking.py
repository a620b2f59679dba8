"""Mask-aware sequence ops (counterpart of ``ser_tpu/ops/masking.py``)."""

from __future__ import annotations

import torch


def reverse_seq(x: torch.Tensor, umask: torch.Tensor) -> torch.Tensor:
    """Flip the first ``sum(umask[b])`` steps of each sequence and zero the
    padded tail.

    x ``[L, B, ...]`` time-major, umask ``[B, L]``; returns ``[L, B, ...]``.
    """
    L, B = x.shape[0], x.shape[1]
    lengths = umask.sum(1).to(torch.int64)
    t = torch.arange(L, device=x.device)[:, None]
    c = lengths[None, :]
    idx = torch.where(t < c, c - 1 - t, t)  # [L, B]
    tail = (1,) * (x.ndim - 2)
    gathered = torch.gather(x, 0, idx.reshape(idx.shape + tail).expand(x.shape))
    valid = (t < c).to(x.dtype).reshape((L, B) + tail)
    return gathered * valid


def select_parties(q: torch.Tensor, qmask_t: torch.Tensor) -> torch.Tensor:
    """Each row's current speaker memory, through a one-hot of
    ``argmax(qmask)``: an all-zero (padded) row picks party 0.

    q ``[..., P, D]``, qmask_t ``[..., P]``; returns ``[..., D]``.
    """
    idx = qmask_t.argmax(-1)
    onehot = (idx[..., None] == torch.arange(q.shape[-2], device=q.device)
              ).to(q.dtype)
    return torch.einsum("...p,...pd->...d", onehot, q)


def scatter_parties(q: torch.Tensor, qmask_t: torch.Tensor,
                    new_state: torch.Tensor) -> torch.Tensor:
    """``q * (1 - qmask) + new_state * qmask`` with the raw qmask, so a
    padded step leaves q untouched.

    q ``[..., P, D]``, qmask_t ``[..., P]``, new_state ``[..., D]``.
    """
    m = qmask_t[..., None]
    return q * (1.0 - m) + new_state[..., None, :] * m
