"""Cross-modal attention (counterpart of ``ser_tpu/ops/attention.py``): the
per-step rank-1 attention in eval and train form, the sequence cross
attentions of the MARN1 heads with their train-mode dropout (rate 0.2) on the
attention map, and the head's two attention chains (``attention_tail``).
All weights are ones at init, as in the reference."""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.layers import Dropout, TorchLayerNorm


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


def rank1_cross_attention_train(x1: torch.Tensor, x2: torch.Tensor,
                                wq: torch.Tensor, wk: torch.Tensor,
                                keep: torch.Tensor | None, p: float
                                ) -> torch.Tensor:
    """Train form with attention dropout, differentiable by autograd
    (``_rank1_fused_impl``): the normaliser ``den = sum_k e`` is taken
    before dropout, ``u = where(keep, e / (1 - p), 0)`` and
    ``z = sum_k u * x2 / den``. The row max ``m`` is detached, as JAX's
    ``stop_gradient``: the shift cancels in exact arithmetic, not in floats.

    x1, x2 ``[..., B, D]``; wq, wk ``[..., D]``; ``keep`` a boolean mask
    ``[..., B, D, D]`` (i, k) or None for no dropout. Returns ``[..., B, D]``
    in x1's dtype. bf16 inputs (a ``--compute_dtype bf16`` step) are widened
    to f32, the function is computed in f32 and z is rounded to bf16 once:
    the port's definition of the bf16 step's rank-1 attention, which the
    bf16 CUDA kernel computes. Its ``[B, D, D]`` contractions stay f32, as
    the JAX package keeps its backward's (``_rank1_vjp_bwd``).
    """
    out_dtype = x1.dtype
    wide = torch.promote_types(out_dtype, torch.float32)  # f64 stays f64
    x1, x2, wq, wk = (t.to(wide) for t in (x1, x2, wq, wk))
    D = x1.shape[-1]
    wq, wk = wq[..., None, :], wk[..., None, :]
    s = (x2 * wq).sum(-1, keepdim=True) * (1.0 / D ** 0.5)
    alpha = x1 * s
    m = torch.where(alpha > 0, alpha * wk.amax(-1, keepdim=True),
                    alpha * wk.amin(-1, keepdim=True)).detach()
    e = torch.exp(alpha[..., :, None] * wk[..., None, :] - m[..., None])
    den = e.sum(-1)
    u = e if keep is None else torch.where(keep, e / (1.0 - p), 0.0)
    return ((u * x2[..., None, :]).sum(-1) / den).to(out_dtype)


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
        self.drop = Dropout(0.2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x1b, x2b = x1.transpose(0, 1), x2.transpose(0, 1)
        q = torch.matmul(x1b, self.Wq)
        k = torch.matmul(x2b, self.Wk)
        v = torch.matmul(x2b, self.Wv)
        attn = torch.softmax(
            torch.einsum("bqd,bkd->bqk", q / self.dk ** 0.5, k), dim=-1)
        attn = self.drop(attn, generator)
        return torch.einsum("bqk,bkd->bqd", attn, v).transpose(0, 1)


class CrossAttentionReSeq(CrossAttentionSeq):
    """Re-attention over an attention output ``CrossAttention3``."""

    def __init__(self, dh: int = 100, dk: int = 128, dv: int = 128):
        super().__init__(dh, dk, dv, d_kv_in=dk)


class CrossAttentionSeqLN(CrossAttentionSeq):
    """MARN1_nsps's ``CrossAttention2`` with a residual and LayerNorm
    (eps 1e-6) after the add: ``LN(attend(x1, x2) + x1)``. Its widths come
    from the constructor (nsps builds it at 100, 100, 100)."""

    def __init__(self, dh: int = 100, dk: int = 128, dv: int = 128):
        super().__init__(dh, dk, dv)
        self.layer_norm = TorchLayerNorm(dh)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.layer_norm(super().forward(x1, x2, generator) + x1)


def attention_tail(seq, reseq, x_first, x_second, v1, v2,
                   generator: torch.Generator | None = None):
    """The MARN1_onlysp and MARN1_sps head's two attention chains, the math
    of the JAX package's ``paired_attention_tail`` run chain by chain::

        attn1 = reseq[0](x_second, v1 * seq[0](x_first, x_second))
        attn2 = reseq[1](x_first, v2 * seq[1](x_second, x_first))

    ``seq`` the two ``CrossAttentionSeq`` (l2a, a2l), ``reseq`` the two
    ``CrossAttentionReSeq``; x_first = w * x_l, x_second = v * x_a,
    time-major ``[L, B, 100]``. Returns ``(attn1, attn2)``, ``[L, B, 128]``.
    In train mode the four maps draw their dropouts from ``generator`` in
    that order."""
    attn1 = seq[0](x_first, x_second, generator)
    attn2 = seq[1](x_second, x_first, generator)
    return (reseq[0](x_second, v1 * attn1, generator),
            reseq[1](x_first, v2 * attn2, generator))
