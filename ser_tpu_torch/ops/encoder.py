"""Transformer encoder block (counterpart of ``ser_tpu/ops/encoder.py``).
Its self-attention is the reference's MHA or, under another
``--encoder_attention`` kind, a zoo op (``ops/encoder_attention.py``).
Batch-first ``[B, L, d_model]``. In train mode
the reference's three dropouts (rate 0.1: the attention map, after ``fc``,
in the FFN) draw from the generator passed to ``forward``; in eval they are
the identity. An optional self-attention mask ``[B or 1, Lq, Lk]`` (0 masks
out) sets those logits to -1e9 before the softmax, as the JAX package does;
MARN1_newz's causal encoder passes a lower-triangular one, which a zoo op
does not read."""

from __future__ import annotations

import torch
from torch import nn

from ser_tpu_torch.ops.encoder_attention import ZooSelfAttention, check_kind
from ser_tpu_torch.ops.layers import Dropout, TorchLayerNorm, TorchLinear


class MultiHeadAttention(nn.Module):
    """Bias-free q/k/v/out projections, q scaled before the contraction,
    residual and LayerNorm. ``mask`` (``[B or 1, Lq, Lk]``, 0 masks out)
    puts -1e9, not -inf, on the masked logits, so no row becomes NaN; with
    none the op sequence is the unmasked one."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int, *,
                 generator: torch.Generator, dropout: float = 0.1):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        lin = lambda i, o: TorchLinear(i, o, bias=False, generator=generator)
        self.w_qs = lin(d_model, n_head * d_k)
        self.w_ks = lin(d_model, n_head * d_k)
        self.w_vs = lin(d_model, n_head * d_v)
        self.fc = lin(n_head * d_v, d_model)
        self.layer_norm = TorchLayerNorm(d_model)
        self.attn_dropout = Dropout(dropout)
        self.out_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        B, L = x.shape[:2]
        n = self.n_head
        q = self.w_qs(x).reshape(B, L, n, self.d_k)
        k = self.w_ks(x).reshape(B, L, n, self.d_k)
        v = self.w_vs(x).reshape(B, L, n, self.d_v)
        logits = torch.einsum("bqnd,bknd->bnqk", q / self.d_k ** 0.5, k)
        if mask is not None:
            logits = logits.masked_fill(mask[:, None] == 0, -1e9)
        attn = torch.softmax(logits, dim=-1)
        attn = self.attn_dropout(attn, generator)
        out = torch.einsum("bnqk,bknd->bqnd", attn, v).reshape(B, L, -1)
        out = self.out_dropout(self.fc(out), generator)
        return self.layer_norm(out + x)


class PositionwiseFeedForward(nn.Module):
    """Two-layer FFN with residual and LayerNorm. ``fc`` is declared and never
    used, as in the reference, for parameter-count parity."""

    def __init__(self, d_in: int, d_hid: int, *, generator: torch.Generator,
                 dropout: float = 0.1):
        super().__init__()
        self.w_1 = TorchLinear(d_in, d_hid, generator=generator)
        self.w_2 = TorchLinear(d_hid, d_in, generator=generator)
        self.layer_norm = TorchLayerNorm(d_in)
        self.fc = TorchLinear(d_in, 100, generator=generator)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.drop(self.w_2(torch.relu(self.w_1(x))), generator)
        return self.layer_norm(h + x)


class EncoderLayer(nn.Module):
    """Self-attention then FFN; MARN1_onlysp builds ``EncoderLayer(100, 40,
    8, 40, 40)``, mf, la and newz ``EncoderLayer(100, 50, 8, 40, 40)``.
    ``attention`` is ``"mha"`` (``MultiHeadAttention``) or another kind of
    ``SEQUENCE_KINDS`` (``ZooSelfAttention``, which ignores n_head, d_k and
    d_v); an unknown kind raises ``ValueError``."""

    def __init__(self, d_model: int, d_inner: int, n_head: int, d_k: int,
                 d_v: int, *, generator: torch.Generator, attention: str = "mha"):
        super().__init__()
        if check_kind(attention) == "mha":
            self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v,
                                               generator=generator)
        else:
            self.slf_attn = ZooSelfAttention(attention, d_model, generator=generator)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner,
                                               generator=generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                slf_attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        return self.pos_ffn(self.slf_attn(x, generator, slf_attn_mask), generator)
