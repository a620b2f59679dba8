"""Cross-modal attention in eval form (counterpart of
``ser_tpu/ops/attention.py``): the per-step rank-1 attention and the two
sequence cross attentions of the MARN1 head. All weights are ones at init,
as in the reference."""

from __future__ import annotations

import torch
from torch import nn


def rank1_cross_attention(x1: torch.Tensor, x2: torch.Tensor,
                          wq: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """Collapsed per-step cross attention, eval form.

    The logits are rank 1, ``alpha[b, i] * wk[k]`` with
    ``alpha = x1 * (x2 . wq) / sqrt(D)``, so the exact row max is
    ``alpha * max(wk)`` where alpha > 0, else ``alpha * min(wk)``.

    x1, x2 ``[..., B, D]``; wq, wk ``[D]`` or broadcastable ``[..., 1, D]``.
    Returns ``[..., B, D]``.
    """
    D = x1.shape[-1]
    s = (x2 * wq).sum(-1, keepdim=True) * (1.0 / D ** 0.5)
    alpha = x1 * s
    m = torch.where(alpha > 0, alpha * wk.amax(-1, keepdim=True),
                    alpha * wk.amin(-1, keepdim=True))
    e = torch.exp(alpha[..., :, None] * wk[..., None, :] - m[..., None])
    return (e * x2[..., None, :]).sum(-1) / e.sum(-1)


class Rank1Weights(nn.Module):
    """The reference's per-step ``CrossAttention`` vectors, ``[1, D]`` ones."""

    def __init__(self, D: int):
        super().__init__()
        self.Wq = nn.Parameter(torch.ones(1, D))
        self.Wk = nn.Parameter(torch.ones(1, D))
        self.Wv = nn.Parameter(torch.ones(1, D))


class CrossAttentionSeq(nn.Module):
    """Sequence cross attention ``CrossAttention2``; time-major
    ``[L, B, D]`` in and out. Attends over padding, unmasked, as the
    reference does. ``CrossAttentionReSeq`` is the same with K and V
    projecting from the dk/dv-wide output of a first attention."""

    def __init__(self, dh: int = 100, dk: int = 128, dv: int = 128,
                 d_kv_in: int | None = None):
        super().__init__()
        d_kv_in = dh if d_kv_in is None else d_kv_in
        self.dk = dk
        self.Wq = nn.Parameter(torch.ones(dh, dk))
        self.Wk = nn.Parameter(torch.ones(d_kv_in, dk))
        self.Wv = nn.Parameter(torch.ones(d_kv_in, dv))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1b, x2b = x1.transpose(0, 1), x2.transpose(0, 1)
        q = torch.matmul(x1b, self.Wq)
        k = torch.matmul(x2b, self.Wk)
        v = torch.matmul(x2b, self.Wv)
        attn = torch.softmax(
            torch.einsum("bqd,bkd->bqk", q / self.dk ** 0.5, k), dim=-1)
        return torch.einsum("bqk,bkd->bqd", attn, v).transpose(0, 1)


class CrossAttentionReSeq(CrossAttentionSeq):
    """Re-attention over an attention output ``CrossAttention3``."""

    def __init__(self, dh: int = 100, dk: int = 128, dv: int = 128):
        super().__init__(dh, dk, dv, d_kv_in=dk)
