"""The five sequence ops of the attention zoo that ``--encoder_attention``
offers (counterpart of those classes in ``ser_tpu/ops/attention_zoo.py``,
which port the reference's vendored External-Attention-pytorch modules).

Each takes ``[B, N, D]`` and keeps the vendored module's parameter names
and torch layouts (``fc_q.weight [out, in]``, MUSE's
``conv3.depth_conv.weight [h·d_v, 1, 3]`` and
``conv3.pointwise_conv.weight [D, h·d_v, 1]``). Parameters are drawn from
the caller's generator: the Linears N(0, 0.001²) with zero bias, as the
vendored ``init_weights`` does; MUSE's convolutions torch's Conv1d default,
U(±1/√fan_in), and its ``dy_paras`` ones. The attention-map dropout
(``self``, ``simplified_self`` and ``muse``) draws from the generator given
to ``forward`` in train mode. No op syncs with the host, so a served
bucket's CUDA graph captures it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ser_tpu_torch.ops.init import normal_, uniform_
from ser_tpu_torch.ops.layers import Dropout


class ZooLinear(nn.Module):
    """``nn.Linear`` with the zoo's init: weight ``[out, in]`` N(0, 0.001²),
    bias zeros (or none)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(normal_(torch.empty(d_out, d_in), 1e-3, generator))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class ConvParams(nn.Module):
    """A Conv1d's ``weight [out, in/groups, k]`` and ``bias [out]``, drawn
    U(±1/√fan_in) as torch's default init does; the op computes with them."""

    def __init__(self, shape, *, generator: torch.Generator):
        super().__init__()
        bound = (shape[1] * shape[2]) ** -0.5
        self.weight = nn.Parameter(uniform_(torch.empty(shape), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(shape[0]), bound, generator))


class DepthPointwiseConv1d(nn.Module):
    """``Depth_Pointwise_Conv1d``: for k > 1 a depthwise conv (padding k//2)
    then a pointwise one; for k = 1 the pointwise one alone. Input
    ``[B, C, n]``; the depthwise conv is the sum of k shifted products, in
    the JAX package's order."""

    def __init__(self, in_ch: int, out_ch: int, k: int, *, generator: torch.Generator):
        super().__init__()
        self.k = k
        if k > 1:
            self.depth_conv = ConvParams((in_ch, 1, k), generator=generator)
        self.pointwise_conv = ConvParams((out_ch, in_ch, 1), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.k > 1:
            w, pad, n = self.depth_conv.weight[:, 0], self.k // 2, x.shape[-1]
            xp = F.pad(x, (pad, pad))
            x = sum(w[:, i, None] * xp[:, :, i:i + n] for i in range(self.k)) \
                + self.depth_conv.bias[:, None]
        pw = self.pointwise_conv
        return torch.einsum("bcn,oc->bon", x, pw.weight[:, :, 0]) + pw.bias[:, None]


class ExternalAttention(nn.Module):
    """External attention with two memories of S slots, ``mk`` and ``mv``
    (bias-free). The softmax runs over the sequence axis, padded rows
    included, then each row is divided by its sum over S, as vendored."""

    def __init__(self, d_model: int, S: int = 64, *, generator: torch.Generator):
        super().__init__()
        self.mk = ZooLinear(d_model, S, bias=False, generator=generator)
        self.mv = ZooLinear(S, d_model, bias=False, generator=generator)

    def forward(self, queries: torch.Tensor) -> torch.Tensor:
        attn = torch.softmax(self.mk(queries), dim=1)  # [B, N, S], over N
        attn = attn / attn.sum(-1, keepdim=True)
        return self.mv(attn)


def _attend(q, k, v, d_k, drop, generator):
    """``softmax(q·k / √d_k)`` over the keys, dropped, times v; q, k, v
    ``[B, n, h, d]`` -> ``[B, nq, h·d_v]``."""
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / d_k ** 0.5
    att = drop(torch.softmax(att, dim=-1), generator)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v)
    return out.reshape(*out.shape[:2], -1)


class ScaledDotProductAttention(nn.Module):
    """Multi-head attention with biased q, k, v and output projections."""

    def __init__(self, d_model: int, d_k: int, d_v: int, h: int, dropout: float = 0.1,
                 *, generator: torch.Generator):
        super().__init__()
        self.d_k, self.d_v, self.h = d_k, d_v, h
        g = generator
        self.fc_q = ZooLinear(d_model, h * d_k, generator=g)
        self.fc_k = ZooLinear(d_model, h * d_k, generator=g)
        self.fc_v = ZooLinear(d_model, h * d_v, generator=g)
        self.fc_o = ZooLinear(h * d_v, d_model, generator=g)
        self.dropout = Dropout(dropout)

    def forward(self, queries, keys, values, generator: torch.Generator | None = None):
        (B, nq), nk, h = queries.shape[:2], keys.shape[1], self.h
        q = self.fc_q(queries).reshape(B, nq, h, self.d_k)
        k = self.fc_k(keys).reshape(B, nk, h, self.d_k)
        v = self.fc_v(values).reshape(B, nk, h, self.d_v)
        return self.fc_o(_attend(q, k, v, self.d_k, self.dropout, generator))


class SimplifiedScaledDotProductAttention(nn.Module):
    """Multi-head attention without q, k, v projections; the output
    projection ``fc_o`` stays, as in the vendored module."""

    def __init__(self, d_model: int, h: int, dropout: float = 0.1, *,
                 generator: torch.Generator):
        super().__init__()
        self.h = h
        self.fc_o = ZooLinear(d_model, d_model, generator=generator)
        self.dropout = Dropout(dropout)

    def forward(self, queries, keys, values, generator: torch.Generator | None = None):
        (B, nq, d_model), nk, h = queries.shape, keys.shape[1], self.h
        d = d_model // h
        q = queries.reshape(B, nq, h, d)
        k = keys.reshape(B, nk, h, d)
        v = values.reshape(B, nk, h, d)
        return self.fc_o(_attend(q, k, v, d, self.dropout, generator))


class MobileViTv2Attention(nn.Module):
    """Separable self-attention: a softmax over the sequence of one score a
    position (``fc_i``) pools ``fc_k(x)`` into a context vector that scales
    ``fc_v(x)``."""

    def __init__(self, d_model: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.fc_i = ZooLinear(d_model, 1, generator=g)
        self.fc_k = ZooLinear(d_model, d_model, generator=g)
        self.fc_v = ZooLinear(d_model, d_model, generator=g)
        self.fc_o = ZooLinear(d_model, d_model, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight_i = torch.softmax(self.fc_i(x), dim=1)  # [B, n, 1]
        context = (weight_i * self.fc_k(x)).sum(1, keepdim=True)
        return self.fc_o(self.fc_v(x) * context)


class MUSEAttention(nn.Module):
    """MUSE: multi-head attention plus three convolution branches over the
    projected V (pointwise; depthwise k = 3 and 5 then pointwise), weighed
    by ``softmax(dy_paras)``. V is projected once; the branches read it in
    h-major channel order ``[B, h·d_v, n]``."""

    def __init__(self, d_model: int, d_k: int, d_v: int, h: int, dropout: float = 0.1,
                 *, generator: torch.Generator):
        super().__init__()
        self.d_k, self.d_v, self.h = d_k, d_v, h
        g = generator
        self.fc_q = ZooLinear(d_model, h * d_k, generator=g)
        self.fc_k = ZooLinear(d_model, h * d_k, generator=g)
        self.fc_v = ZooLinear(d_model, h * d_v, generator=g)
        self.fc_o = ZooLinear(h * d_v, d_model, generator=g)
        self.dropout = Dropout(dropout)
        self.conv1 = DepthPointwiseConv1d(h * d_v, d_model, 1, generator=g)
        self.conv3 = DepthPointwiseConv1d(h * d_v, d_model, 3, generator=g)
        self.conv5 = DepthPointwiseConv1d(h * d_v, d_model, 5, generator=g)
        self.dy_paras = nn.Parameter(torch.ones(3))

    def forward(self, queries, keys, values, generator: torch.Generator | None = None):
        (B, nq), nk, h = queries.shape[:2], keys.shape[1], self.h
        q = self.fc_q(queries).reshape(B, nq, h, self.d_k)
        k = self.fc_k(keys).reshape(B, nk, h, self.d_k)
        v = self.fc_v(values).reshape(B, nk, h, self.d_v)
        out = self.fc_o(_attend(q, k, v, self.d_k, self.dropout, generator))
        v2 = v.reshape(B, nk, h * self.d_v).transpose(1, 2)  # [B, h·d_v, nk]
        w = torch.softmax(self.dy_paras, 0)
        out2 = w[0] * self.conv1(v2) + w[1] * self.conv3(v2) + w[2] * self.conv5(v2)
        return out + out2.transpose(1, 2)
