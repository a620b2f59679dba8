"""Transformer encoder block, ``mha`` branch (counterpart of
``ser_tpu/ops/encoder.py``). Batch-first ``[B, L, d_model]``; eval only, so
the dropouts are the identity and have no module."""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.layers import TorchLayerNorm, TorchLinear


class MultiHeadAttention(nn.Module):
    """Bias-free q/k/v/out projections, q scaled before the contraction,
    residual and LayerNorm. No mask: MARN1_onlysp passes none."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        lin = lambda i, o: TorchLinear(i, o, bias=False, generator=generator)
        self.w_qs = lin(d_model, n_head * d_k)
        self.w_ks = lin(d_model, n_head * d_k)
        self.w_vs = lin(d_model, n_head * d_v)
        self.fc = lin(n_head * d_v, d_model)
        self.layer_norm = TorchLayerNorm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L = x.shape[:2]
        n = self.n_head
        q = self.w_qs(x).reshape(B, L, n, self.d_k)
        k = self.w_ks(x).reshape(B, L, n, self.d_k)
        v = self.w_vs(x).reshape(B, L, n, self.d_v)
        attn = torch.softmax(
            torch.einsum("bqnd,bknd->bnqk", q / self.d_k ** 0.5, k), dim=-1)
        out = torch.einsum("bnqk,bknd->bqnd", attn, v).reshape(B, L, -1)
        return self.layer_norm(self.fc(out) + x)


class PositionwiseFeedForward(nn.Module):
    """Two-layer FFN with residual and LayerNorm. ``fc`` is declared and never
    used, as in the reference, for parameter-count parity."""

    def __init__(self, d_in: int, d_hid: int, *, generator: torch.Generator):
        super().__init__()
        self.w_1 = TorchLinear(d_in, d_hid, generator=generator)
        self.w_2 = TorchLinear(d_hid, d_in, generator=generator)
        self.layer_norm = TorchLayerNorm(d_in)
        self.fc = TorchLinear(d_in, 100, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.w_2(torch.relu(self.w_1(x))) + x)


class EncoderLayer(nn.Module):
    """MHA then FFN; MARN1_onlysp builds ``EncoderLayer(100, 40, 8, 40, 40)``."""

    def __init__(self, d_model: int, d_inner: int, n_head: int, d_k: int,
                 d_v: int, *, generator: torch.Generator):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                           generator=generator)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner,
                                               generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pos_ffn(self.slf_attn(x))
