"""The attention zoo of ``ser_tpu/ops/attention_zoo.py``, which ports the
reference's vendored External-Attention-pytorch modules: the five sequence
ops that ``--encoder_attention`` offers, and the channel, spatial and
sequence classes that no flag reaches.

Sequence ops take ``[B, N, D]``, the others NCHW ``[B, C, H, W]``. Each class
keeps the vendored module's parameter names and torch layouts
(``fc_q.weight [out, in]``, ``convs.0.conv.weight [out, in/groups, k, k]``,
``convs.0.bn.running_mean``, MUSE's ``conv3.depth_conv.weight [h·d_v, 1,
3]``); ``compat.from_jax.zoo_from_jax`` carries a JAX class's parameters
across. Parameters are drawn from the caller's generator as the JAX
package draws them: the zoo's Linears N(0, 0.001²) with zero bias, as the
vendored ``init_weights`` does; the convolutions and the torch-default
Linears U(±1/√fan_in); BatchNorm, LayerNorm and GroupNorm ones and zeros,
with running statistics 0 and 1. BatchNorm is the eval form, normalising by
the stored statistics (buffers). The math follows the JAX package, not the
vendored code where the two part: S2Attention's shifts are the JAX
functional ones (the vendored in-place writes to overlapping slices
collapse slabs A and C to the boundary slice, which the JAX form keeps),
and its GELU is the tanh form of ``jax.nn.gelu``. The contractions run in
f32 (TF32 off on the card) with autograd's backward. Every ReLU goes
through ``torch.relu``. The attention-map dropout (``self``,
``simplified_self``, ``muse``, EMSA) draws from the generator given to
``forward`` in train mode; DAModule's two attentions never drop, as in the
JAX package. No op syncs with the host, so a served bucket's CUDA graph
captures it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ser_tpu_torch.ops.init import normal_, uniform_
from ser_tpu_torch.ops.layers import Dropout, TorchLayerNorm, TorchLinear


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


# --- the channel, spatial and sequence classes no flag reaches ---------------


class Conv2d(nn.Module):
    """``nn.Conv2d`` with the zoo's init drawn from ``generator``: weight
    ``[out, in/groups, k, k]`` and bias U(±1/√fan_in), torch's default, or
    with ``std`` the weight N(0, std²) (CBAM's shared MLP)."""

    def __init__(self, cin: int, cout: int, k: int = 1, *, stride: int = 1, padding: int = 0,
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 std: float | None = None, generator: torch.Generator):
        super().__init__()
        self.conv_args = (stride, padding, dilation, groups)
        weight = torch.empty(cout, cin // groups, k, k)
        bound = (cin // groups * k * k) ** -0.5
        self.weight = nn.Parameter(uniform_(weight, bound, generator) if std is None
                                   else normal_(weight, std, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(cout), bound, generator)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, *self.conv_args)

    def pointwise(self, v: torch.Tensor) -> torch.Tensor:
        """A 1x1 convolution of ``[B, C]`` descriptors, as a product."""
        return F.linear(v, self.weight[:, :, 0, 0], self.bias)


class BatchNorm(nn.Module):
    """Eval-mode ``nn.BatchNorm{1,2}d(c)``: ``(x - running_mean) *
    rsqrt(running_var + 1e-5) * weight + bias`` over axis 1, in the JAX
    ``_declare_bn``'s order. The statistics are buffers."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(self.running_var.view(shape) + 1e-5)
        return (x - self.running_mean.view(shape)) * inv * self.weight.view(shape) \
            + self.bias.view(shape)


class ZooLayerNorm(TorchLayerNorm):
    """``nn.LayerNorm(d)`` (eps 1e-5) in the ``(x-mean)*rsqrt(var+eps)`` form."""

    eps = 1e-5


def _spatial_norm(x: torch.Tensor) -> torch.Tensor:
    """Each (row, channel) map normalised over H and W (eps 1e-5, no affine):
    InstanceNorm, and GroupNorm with a group a channel."""
    mu = x.mean((2, 3), keepdim=True)
    var = (x - mu).square().mean((2, 3), keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def _indexed(**modules) -> nn.ModuleDict:
    """A Sequential's parametrised members under their indices (``_0=``
    is ``0``), so that the keys are the vendored ones (``fc.0.weight``)."""
    return nn.ModuleDict({k.lstrip("_"): m for k, m in modules.items()})


class SEAttention(nn.Module):
    """Squeeze and excitation: the spatial mean through a bias-free
    bottleneck MLP (``fc.0``, ``fc.2``) to a sigmoid gate per channel."""

    def __init__(self, channel: int = 512, reduction: int = 16, *, generator: torch.Generator):
        super().__init__()
        g, cr = generator, channel // reduction
        self.fc = _indexed(_0=ZooLinear(channel, cr, bias=False, generator=g),
                           _2=ZooLinear(cr, channel, bias=False, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.fc["0"](x.mean((2, 3))))
        return x * torch.sigmoid(self.fc["2"](y))[:, :, None, None]


class ECAAttention(nn.Module):
    """Efficient channel attention: a k-tap 1-D convolution (zero padded)
    over the channels' spatial means, a sigmoid gate per channel."""

    def __init__(self, kernel_size: int = 3, *, generator: torch.Generator):
        super().__init__()
        self.k = kernel_size
        self.conv = ConvParams((1, 1, kernel_size), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean((2, 3))
        pad, w, C = (self.k - 1) // 2, self.conv.weight[0, 0], y.shape[1]
        yp = F.pad(y, (pad, pad))
        conv = sum(w[i] * yp[:, i:i + C] for i in range(self.k)) + self.conv.bias
        return x * torch.sigmoid(conv)[:, :, None, None]


class CBAMChannelGate(nn.Module):
    """CBAM's channel half: one bias-free MLP (1x1 convolutions ``se.0``,
    ``se.2``, N(0, 0.001²)) on the max- and the mean-pooled descriptors,
    ``x * sigmoid(mlp(mean) + mlp(max))``."""

    def __init__(self, channel: int = 512, reduction: int = 16, *,
                 generator: torch.Generator):
        super().__init__()
        g, cr = generator, channel // reduction
        self.se = _indexed(_0=Conv2d(channel, cr, bias=False, std=1e-3, generator=g),
                           _2=Conv2d(cr, channel, bias=False, std=1e-3, generator=g))

    def gate(self, x: torch.Tensor) -> torch.Tensor:
        mlp = lambda v: self.se["2"].pointwise(torch.relu(self.se["0"].pointwise(v)))  # noqa: E731
        return torch.sigmoid(mlp(x.mean((2, 3))) + mlp(x.amax((2, 3))))[:, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gate(x)


class CBAMSpatialGate(nn.Module):
    """CBAM's spatial half: the channels' max and mean maps through a KxK
    convolution to a sigmoid map ``[B, 1, H, W]`` (the gate, not its
    product)."""

    def __init__(self, kernel_size: int = 7, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv2d(2, 1, kernel_size, padding=kernel_size // 2, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stacked = torch.cat([x.amax(1, keepdim=True), x.mean(1, keepdim=True)], 1)
        return torch.sigmoid(self.conv(stacked))


class CBAMBlock(nn.Module):
    """CBAM: the channel gate, then the spatial gate, plus the input."""

    def __init__(self, channel: int = 512, reduction: int = 16, kernel_size: int = 7, *,
                 generator: torch.Generator):
        super().__init__()
        self.ca = CBAMChannelGate(channel, reduction, generator=generator)
        self.sa = CBAMSpatialGate(kernel_size, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.ca(x)
        return out * self.sa(out) + x


class SpatialGroupEnhance(nn.Module):
    """SGE: in each of ``groups`` channel groups, the map of a position's
    agreement with the group's mean feature, standardised over the
    positions (std with ddof 1, plus 1e-5), scaled and shifted per group
    (``weight``, ``bias``, zeros at init), gates the group."""

    def __init__(self, groups: int = 8, *, generator: torch.Generator | None = None):
        super().__init__()
        del generator  # constant init
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(1, groups, 1, 1))
        self.bias = nn.Parameter(torch.zeros(1, groups, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        g = self.groups
        xg = x.reshape(B * g, C // g, H, W)
        t = (xg * xg.mean((2, 3), keepdim=True)).sum(1).reshape(B * g, -1)
        t = t - t.mean(1, keepdim=True)
        t = (t / (t.std(1, keepdim=True) + 1e-5)).reshape(B, g, H, W)
        t = (t * self.weight + self.bias).reshape(B * g, 1, H, W)
        return (xg * torch.sigmoid(t)).reshape(B, C, H, W)


class CoordAttention(nn.Module):
    """Coordinate attention: the H-wise and W-wise means through one shared
    1x1 bottleneck (``conv1``, ``bn1``, h-swish), then a sigmoid gate per
    axis (``conv_h``, ``conv_w``)."""

    def __init__(self, inp: int = 512, oup: int = 512, reduction: int = 32, *,
                 generator: torch.Generator):
        super().__init__()
        g, mip = generator, max(8, inp // reduction)
        self.conv1 = Conv2d(inp, mip, generator=g)
        self.bn1 = BatchNorm(mip)
        self.conv_h = Conv2d(mip, oup, generator=g)
        self.conv_w = Conv2d(mip, oup, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H = x.shape[2]
        y = torch.cat([x.mean(3, keepdim=True), x.mean(2, keepdim=True).transpose(2, 3)], 2)
        y = self.bn1(self.conv1(y))
        y = y * torch.clamp(y + 3.0, 0.0, 6.0) / 6.0  # h-swish
        a_h = torch.sigmoid(self.conv_h(y[:, :, :H]))
        a_w = torch.sigmoid(self.conv_w(y[:, :, H:].transpose(2, 3)))
        return x * a_w * a_h


class _BasicConv(nn.Module):
    """A bias-free convolution and its BatchNorm (``conv``, ``bn``)."""

    def __init__(self, cin: int, cout: int, k: int, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2, bias=False, generator=generator)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class _TripletGate(nn.Module):
    """One branch of triplet attention: the max and mean over axis 1, a 7x7
    convolution and BatchNorm, a sigmoid gate."""

    def __init__(self, *, generator: torch.Generator):
        super().__init__()
        self.conv = _BasicConv(2, 1, 7, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = torch.cat([x.amax(1, keepdim=True), x.mean(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.conv(z))


class TripletAttention(nn.Module):
    """Triplet attention: gates over (C, W), (H, C) and, unless
    ``no_spatial``, (H, W), each on the input rotated to put that pair last,
    averaged."""

    def __init__(self, no_spatial: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.no_spatial = no_spatial
        self.cw = _TripletGate(generator=generator)
        self.hc = _TripletGate(generator=generator)
        if not no_spatial:
            self.hw = _TripletGate(generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.cw(x.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        out2 = self.hc(x.permute(0, 3, 2, 1)).permute(0, 3, 2, 1)
        if self.no_spatial:
            return 0.5 * (out1 + out2)
        return (self.hw(x) + out1 + out2) / 3.0


class _GroupNormParams(nn.Module):
    """GroupNorm's ``weight`` and ``bias`` (ones, zeros)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class ShuffleAttention(nn.Module):
    """Shuffle attention: in each of G groups, half the channels gated by
    their scaled means (``cweight``, ``cbias``), half by their GroupNorm
    (a group a channel; ``gn``) scaled (``sweight``, ``sbias``); then the
    two halves of the channels interleaved."""

    def __init__(self, channel: int = 512, G: int = 8, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        del generator  # constant init
        self.G, half = G, channel // (2 * G)
        shape = (1, half, 1, 1)
        self.cweight = nn.Parameter(torch.zeros(shape))
        self.cbias = nn.Parameter(torch.ones(shape))
        self.sweight = nn.Parameter(torch.zeros(shape))
        self.sbias = nn.Parameter(torch.ones(shape))
        self.gn = _GroupNormParams(half)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        half = self.cweight.shape[1]
        xg = x.reshape(B * self.G, C // self.G, H, W)
        x0, x1 = xg[:, :half], xg[:, half:]
        xc = x0 * torch.sigmoid(self.cweight * x0.mean((2, 3), keepdim=True) + self.cbias)
        xn = _spatial_norm(x1) * self.gn.weight[None, :, None, None] \
            + self.gn.bias[None, :, None, None]
        xs = x1 * torch.sigmoid(self.sweight * xn + self.sbias)
        out = torch.cat([xc, xs], 1).reshape(B, 2, C // 2, H, W).transpose(1, 2)
        return out.reshape(B, C, H, W)


class _ConvBN(nn.Module):
    """A biased convolution and its BatchNorm (``conv``, ``bn``), ReLU'd."""

    def __init__(self, c: int, k: int, groups: int, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv2d(c, c, k, padding=k // 2, groups=groups, generator=generator)
        self.bn = BatchNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class SKAttention(nn.Module):
    """Selective kernel: one convolution branch a kernel size, the branches'
    sum pooled through ``fc`` and one ``fcs`` Linear a branch, a softmax
    over the branches weighs them."""

    def __init__(self, channel: int = 512, kernels=(1, 3, 5, 7), reduction: int = 16,
                 group: int = 1, L: int = 32, *, generator: torch.Generator):
        super().__init__()
        g, d = generator, max(L, channel // reduction)
        self.kernels = tuple(kernels)
        self.convs = nn.ModuleList(_ConvBN(channel, k, group, generator=g) for k in kernels)
        self.fc = TorchLinear(channel, d, generator=g)
        self.fcs = nn.ModuleList(TorchLinear(d, channel, generator=g) for _ in kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = torch.stack([conv(x) for conv in self.convs])  # [K, B, C, H, W]
        Z = self.fc(feats.sum(0).mean((2, 3)))
        w = torch.softmax(torch.stack([fc(Z) for fc in self.fcs]), 0)  # [K, B, C]
        return (w[:, :, :, None, None] * feats).sum(0)


class BAMBlock(nn.Module):
    """Bottleneck attention: ``(1 + sigmoid(channel + spatial)) * x``. The
    channel branch: the spatial mean through ``num_layers`` Linear,
    BatchNorm, ReLU blocks and ``last_fc``; the spatial branch: a 1x1
    reduction, ``num_layers`` dilated 3x3 convolutions with padding 1 (a
    7x7 map shrinks to 1x1, as vendored) and a 1x1 convolution to one map."""

    def __init__(self, channel: int = 512, reduction: int = 16, num_layers: int = 3,
                 dia_val: int = 2, *, generator: torch.Generator):
        super().__init__()
        g, C, cr = generator, channel, channel // reduction
        self.num_layers = num_layers
        dims = [C] + [cr] * num_layers + [C]
        ca = {}
        for i in range(num_layers):
            ca[f"fc{i}"] = TorchLinear(dims[i], dims[i + 1], generator=g)
            ca[f"bn{i}"] = BatchNorm(dims[i + 1])
        ca["last_fc"] = TorchLinear(dims[-2], dims[-1], generator=g)
        sa = {"conv_reduce1": Conv2d(C, cr, generator=g), "bn_reduce1": BatchNorm(cr)}
        for i in range(num_layers):
            sa[f"conv_{i}"] = Conv2d(cr, cr, 3, padding=1, dilation=dia_val, generator=g)
            sa[f"bn_{i}"] = BatchNorm(cr)
        sa["last_conv"] = Conv2d(cr, 1, generator=g)
        self.ca = nn.ModuleDict({"ca": nn.ModuleDict(ca)})
        self.sa = nn.ModuleDict({"sa": nn.ModuleDict(sa)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ca, sa = self.ca["ca"], self.sa["sa"]
        y = x.mean((2, 3))
        for i in range(self.num_layers):
            y = torch.relu(ca[f"bn{i}"](ca[f"fc{i}"](y)))
        c_att = ca["last_fc"](y)[:, :, None, None]
        s = torch.relu(sa["bn_reduce1"](sa["conv_reduce1"](x)))
        for i in range(self.num_layers):
            s = torch.relu(sa[f"bn_{i}"](sa[f"conv_{i}"](s)))
        s_att = sa["last_conv"](s)
        return (1.0 + torch.sigmoid(s_att.expand_as(x) + c_att.expand_as(x))) * x


class PSA(nn.Module):
    """Pyramid squeeze attention: S channel groups, group i convolved with
    kernel 2i + 3, each with an SE gate (bias-free 1x1 convolutions
    ``se_blocks.i.1``, ``.3``); a softmax over the groups weighs them."""

    def __init__(self, channel: int = 512, reduction: int = 4, S: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        g, cs, mid = generator, channel // S, channel // (S * reduction)
        self.S = S
        self.convs = nn.ModuleList(Conv2d(cs, cs, 2 * (i + 1) + 1, padding=i + 1, generator=g)
                                   for i in range(S))
        self.se_blocks = nn.ModuleList(
            _indexed(_1=Conv2d(cs, mid, bias=False, generator=g),
                     _3=Conv2d(mid, cs, bias=False, generator=g)) for _ in range(S))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        groups = x.reshape(B, self.S, C // self.S, H, W)
        spc, se = [], []
        for i, (conv, block) in enumerate(zip(self.convs, self.se_blocks)):
            f = conv(groups[:, i])
            spc.append(f)
            se.append(torch.sigmoid(block["3"].pointwise(
                torch.relu(block["1"].pointwise(f.mean((2, 3)))))))
        soft = torch.softmax(torch.stack(se, 1), 1)[:, :, :, None, None]  # [B, S, cs, 1, 1]
        return (torch.stack(spc, 1) * soft).reshape(B, C, H, W)


class CoTAttention(nn.Module):
    """Contextual transformer attention: a grouped KxK key embedding
    (``key_embed``), a 1x1 value embedding (``value_embed``) and, from the
    keys beside the input, a two-layer attention (``attention_embed``)
    averaged over its K² taps, whose softmax over the positions weighs the
    values; keys plus weighted values."""

    def __init__(self, dim: int = 512, kernel_size: int = 3, *, generator: torch.Generator):
        super().__init__()
        g, C, ks, factor = generator, dim, kernel_size, 4
        self.ks = ks
        self.key_embed = _indexed(_0=Conv2d(C, C, ks, padding=ks // 2, groups=4, bias=False,
                                            generator=g), _1=BatchNorm(C))
        self.value_embed = _indexed(_0=Conv2d(C, C, bias=False, generator=g), _1=BatchNorm(C))
        mid = 2 * C // factor
        self.attention_embed = _indexed(_0=Conv2d(2 * C, mid, bias=False, generator=g),
                                        _1=BatchNorm(mid),
                                        _3=Conv2d(mid, ks * ks * C, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        key, value, att = self.key_embed, self.value_embed, self.attention_embed
        k1 = torch.relu(key["1"](key["0"](x)))
        v = value["1"](value["0"](x)).reshape(B, C, -1)
        a = torch.relu(att["1"](att["0"](torch.cat([k1, x], 1))))
        a = att["3"](a).reshape(B, C, self.ks * self.ks, H, W).mean(2).reshape(B, C, -1)
        return k1 + (torch.softmax(a, -1) * v).reshape(B, C, H, W)


class DoubleAttention(nn.Module):
    """A²-Net double attention: ``c_n`` global descriptors gathered from the
    ``c_m`` features (``convA``) by the softmax maps of ``convB``, then
    distributed to the positions by the softmax of ``convV`` (both over
    the c_n channels), and with ``reconstruct`` back to the input's width.
    The 1x1 convolutions run as products, as in the JAX package."""

    def __init__(self, in_channels: int, c_m: int, c_n: int, reconstruct: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        g, C = generator, in_channels
        self.reconstruct = reconstruct
        self.convA = Conv2d(C, c_m, generator=g)
        self.convB = Conv2d(C, c_n, generator=g)
        self.convV = Conv2d(C, c_n, generator=g)
        if reconstruct:
            self.conv_reconstruct = Conv2d(c_m, C, generator=g)

    @staticmethod
    def _product(conv: Conv2d, flat: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bcn,mc->bmn", flat, conv.weight[:, :, 0, 0]) \
            + conv.bias[None, :, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        flat = x.reshape(B, C, H * W)
        A = self._product(self.convA, flat)
        attn_maps = torch.softmax(self._product(self.convB, flat), 1)
        attn_vecs = torch.softmax(self._product(self.convV, flat), 1)
        gd = torch.einsum("bmn,bcn->bmc", A, attn_maps)  # [B, c_m, c_n]
        z = torch.einsum("bmc,bcn->bmn", gd, attn_vecs).reshape(B, -1, H, W)
        if self.reconstruct:
            rec = self.conv_reconstruct
            z = torch.einsum("bmhw,cm->bchw", z, rec.weight[:, :, 0, 0]) \
                + rec.bias[None, :, None, None]
        return z


class _DABranch(nn.Module):
    """A DANet branch: a KxK convolution (``cnn``) and an attention (``pa``)."""

    def __init__(self, C: int, k: int, pa: nn.Module, *, generator: torch.Generator):
        super().__init__()
        self.cnn = Conv2d(C, C, k, padding=(k - 1) // 2, generator=generator)
        self.pa = pa


class DAModule(nn.Module):
    """Dual attention (DANet): one-head attention over the positions of a
    convolved map (``position_attention_module``) plus projection-free
    attention over its channels (``channel_attention_module``, its width
    the H·W positions). Neither attention drops, in train mode either."""

    def __init__(self, d_model: int = 512, kernel_size: int = 3, H: int = 7, W: int = 7, *,
                 generator: torch.Generator):
        super().__init__()
        g, k = generator, kernel_size
        self.position_attention_module = _DABranch(
            d_model, k, ScaledDotProductAttention(d_model, d_model, d_model, 1, dropout=0.0,
                                                  generator=g), generator=g)
        self.channel_attention_module = _DABranch(
            d_model, k, SimplifiedScaledDotProductAttention(H * W, 1, dropout=0.0, generator=g),
            generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        pam, cam = self.position_attention_module, self.channel_attention_module
        y = pam.cnn(x).reshape(B, C, H * W).transpose(1, 2)  # [B, N, C]
        p_out = pam.pa(y, y, y).transpose(1, 2).reshape(B, C, H, W)
        z = cam.cnn(x).reshape(B, C, H * W)  # [B, C, N]
        return p_out + cam.pa(z, z, z).reshape(B, C, H, W)


class PolarizedSelfAttention(nn.Module):
    """Polarized self-attention: a channel-only branch (a softmax-pooled
    position query, LayerNorm ``ln`` and a sigmoid gate per channel) and a
    spatial-only branch (a softmax-pooled channel query, a sigmoid gate per
    position), added, or with ``sequential`` the channel branch's output
    fed to the spatial one."""

    def __init__(self, channel: int = 512, sequential: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        g, C, half = generator, channel, channel // 2
        self.sequential = sequential
        self.ch_wv = Conv2d(C, half, generator=g)
        self.ch_wq = Conv2d(C, 1, generator=g)
        self.ch_wz = Conv2d(half, C, generator=g)
        self.ln = ZooLayerNorm(C)
        self.sp_wv = Conv2d(C, half, generator=g)
        self.sp_wq = Conv2d(C, half, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        wv = self.ch_wv(x).reshape(B, C // 2, -1)
        wq = torch.softmax(self.ch_wq(x).reshape(B, -1, 1), 1)
        z = self.ch_wz(torch.matmul(wv, wq)[:, :, :, None]).reshape(B, C)
        channel_out = torch.sigmoid(self.ln(z))[:, :, None, None] * x
        sp_in = channel_out if self.sequential else x
        swv = self.sp_wv(sp_in).reshape(B, C // 2, -1)
        swq = torch.softmax(self.sp_wq(sp_in).mean((2, 3)), -1)[:, None, :]
        spatial_out = torch.sigmoid(torch.matmul(swq, swv).reshape(B, 1, H, W)) * sp_in
        return spatial_out if self.sequential else spatial_out + channel_out


def _spatial_shift1(x: torch.Tensor) -> torch.Tensor:
    """S2-MLP's shift pattern 1 on ``[B, W, H, C]``, the JAX package's
    functional form: slab A is row 0 along W everywhere, slab C column 0
    along H (what the vendored in-place writes leave), B and D shift by one
    and keep the last row and column."""
    b, w, h, c = x.shape
    s = c // 4
    return torch.cat([
        x[:, :1, :, :s].expand(b, w, h, s),
        torch.cat([x[:, 1:, :, s:2 * s], x[:, -1:, :, s:2 * s]], 1),
        x[:, :, :1, 2 * s:3 * s].expand(b, w, h, s),
        torch.cat([x[:, :, 1:, 3 * s:], x[:, :, -1:, 3 * s:]], 2)], 3)


def _spatial_shift2(x: torch.Tensor) -> torch.Tensor:
    """Pattern 2: pattern 1 with the W and H axes swapped."""
    b, w, h, c = x.shape
    s = c // 4
    return torch.cat([
        x[:, :, :1, :s].expand(b, w, h, s),
        torch.cat([x[:, :, 1:, s:2 * s], x[:, :, -1:, s:2 * s]], 2),
        x[:, :1, :, 2 * s:3 * s].expand(b, w, h, s),
        torch.cat([x[:, 1:, :, 3 * s:], x[:, -1:, :, 3 * s:]], 1)], 3)


class _SplitAttention(nn.Module):
    """S2Attention's split attention: two bias-free Linears."""

    def __init__(self, C: int, *, generator: torch.Generator):
        super().__init__()
        self.mlp1 = TorchLinear(C, C, bias=False, generator=generator)
        self.mlp2 = TorchLinear(C, 3 * C, bias=False, generator=generator)


class S2Attention(nn.Module):
    """S2-MLP spatial-shift attention: ``mlp1`` to three copies, two of
    them shifted, weighed by a split attention (softmax over the copies of
    an MLP of their sum, GELU in its tanh form), then ``mlp2``."""

    def __init__(self, channels: int = 512, *, generator: torch.Generator):
        super().__init__()
        g, C = generator, channels
        self.mlp1 = TorchLinear(C, 3 * C, generator=g)
        self.mlp2 = TorchLinear(C, C, generator=g)
        self.split_attention = _SplitAttention(C, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, W, H = x.shape
        xp = self.mlp1(x.permute(0, 2, 3, 1))  # [B, W, H, 3C]
        flat = torch.stack([_spatial_shift1(xp[..., :C]), _spatial_shift2(xp[..., C:2 * C]),
                            xp[..., 2 * C:]], 1).reshape(B, 3, -1, C)
        sa = self.split_attention
        hat_a = sa.mlp2(F.gelu(sa.mlp1(flat.sum((1, 2))), approximate="tanh"))
        bar_a = torch.softmax(hat_a.reshape(B, 3, C), 1)
        out = (bar_a[:, :, None, :] * flat).sum(1)  # [B, N, C]
        return self.mlp2(out.reshape(B, W, H, C)).permute(0, 3, 1, 2)


class AFTFull(nn.Module):
    """Attention-free transformer, full: ``sigmoid(q) * Σ_j e^(k_j + w_tj)
    v_j / Σ_j e^(k_j + w_tj)`` with learned position biases ``w``
    ``[n, n]`` in the sequence length (ones at init; with ``simple`` zeros,
    and no parameter)."""

    def __init__(self, d_model: int, n: int = 49, simple: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        g, D = generator, d_model
        self.simple = simple
        self.fc_q = ZooLinear(D, D, generator=g)
        self.fc_k = ZooLinear(D, D, generator=g)
        self.fc_v = ZooLinear(D, D, generator=g)
        if simple:
            self.register_buffer("position_biases", torch.zeros(n, n), persistent=False)
        else:
            self.position_biases = nn.Parameter(torch.ones(n, n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.fc_q(x), self.fc_k(x), self.fc_v(x)
        ek = torch.exp(k[:, None, :, :] + self.position_biases[None, :, :, None])  # [B, n, n, D]
        return torch.sigmoid(q) * ((ek * v[:, None]).sum(2) / ek.sum(2))


class UFOAttention(nn.Module):
    """UFO attention (softmax-free): ``XNorm(q) · XNorm(kᵀv)`` a head, where
    ``XNorm(t) = t · gamma / ‖t‖`` over the last axis, with no epsilon: a
    zero row gives NaN, as in the JAX package. ``gamma [1, h, 1, 1]`` is
    drawn N(0, 1)."""

    def __init__(self, d_model: int, d_k: int, d_v: int, h: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.d_k, self.d_v, self.h = d_k, d_v, h
        self.fc_q = ZooLinear(d_model, h * d_k, generator=g)
        self.fc_k = ZooLinear(d_model, h * d_k, generator=g)
        self.fc_v = ZooLinear(d_model, h * d_v, generator=g)
        self.fc_o = ZooLinear(h * d_v, d_model, generator=g)
        self.gamma = nn.Parameter(normal_(torch.empty(1, h, 1, 1), 1.0, g))

    def _xnorm(self, t: torch.Tensor) -> torch.Tensor:
        return t * self.gamma / torch.linalg.vector_norm(t, dim=-1, keepdim=True)

    def forward(self, queries, keys, values):
        (B, nq), nk, h = queries.shape[:2], keys.shape[1], self.h
        q = self.fc_q(queries).reshape(B, nq, h, self.d_k).transpose(1, 2)
        k = self.fc_k(keys).reshape(B, nk, h, self.d_k)
        v = self.fc_v(values).reshape(B, nk, h, self.d_v)
        kv = torch.einsum("bkhd,bkhe->bhde", k, v)  # [B, h, d_k, d_v]
        out = torch.matmul(self._xnorm(q), self._xnorm(kv))  # [B, h, nq, d_v]
        return self.fc_o(out.transpose(1, 2).reshape(B, nq, h * self.d_v))


class _Transform(nn.Module):
    """EMSA's head mixing: a 1x1 convolution over the heads (``conv``)."""

    def __init__(self, h: int, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv2d(h, h, generator=generator)


class EMSA(nn.Module):
    """Efficient multi-head self-attention: with ``ratio`` above 1 the keys
    and values come from the queries' H x W map reduced by a strided
    depthwise convolution (``sr_conv``) and LayerNorm (``sr_ln``), and the
    ``keys``, ``values`` arguments are not read; with ``apply_transform``
    and more than one head the scores are mixed over the heads
    (``transform.conv``), softmaxed and instance-normalised. The map then
    drops in train mode."""

    def __init__(self, d_model: int, d_k: int, d_v: int, h: int, H: int = 7, W: int = 7,
                 ratio: int = 3, apply_transform: bool = True, dropout: float = 0.1, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.d_k, self.d_v, self.h, self.H, self.W = d_k, d_v, h, H, W
        self.ratio, self.apply_transform = ratio, apply_transform and h > 1
        self.fc_q = ZooLinear(d_model, h * d_k, generator=g)
        self.fc_k = ZooLinear(d_model, h * d_k, generator=g)
        self.fc_v = ZooLinear(d_model, h * d_v, generator=g)
        self.fc_o = ZooLinear(h * d_v, d_model, generator=g)
        if ratio > 1:
            self.sr_conv = Conv2d(d_model, d_model, ratio + 1, stride=ratio, padding=ratio // 2,
                                  groups=d_model, generator=g)
            self.sr_ln = ZooLayerNorm(d_model)
        if self.apply_transform:
            self.transform = _Transform(h, generator=g)
        self.dropout = Dropout(dropout)

    def forward(self, queries, keys, values, generator: torch.Generator | None = None):
        B, nq, c = queries.shape
        h = self.h
        q = self.fc_q(queries).reshape(B, nq, h, self.d_k).transpose(1, 2)  # [B, h, nq, d_k]
        if self.ratio > 1:
            xi = queries.transpose(1, 2).reshape(B, c, self.H, self.W)
            keys = values = self.sr_ln(self.sr_conv(xi).reshape(B, c, -1).transpose(1, 2))
        nk = keys.shape[1]
        k = self.fc_k(keys).reshape(B, nk, h, self.d_k).permute(0, 2, 3, 1)  # [B, h, d_k, nk]
        v = self.fc_v(values).reshape(B, nk, h, self.d_v).transpose(1, 2)  # [B, h, nk, d_v]
        att = torch.matmul(q, k) / self.d_k ** 0.5
        if self.apply_transform:
            att = _spatial_norm(torch.softmax(self.transform.conv(att), -1))
        else:
            att = torch.softmax(att, -1)
        att = self.dropout(att, generator)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, nq, h * self.d_v)
        return self.fc_o(out)
