"""The attention zoo's vision blocks, ``ser_tpu/ops/attention_zoo_vision.py``:
ResidualAttention, ParNet, CrissCross, ViP (WeightedPermuteMLP), Outlook,
MobileViT (v1), GFNet, Halo, ACmix, Axial and CoAtNet with its MBConv.

The conventions are ``attention_zoo``'s: the vendored modules' parameter
names and torch layouts (``conv1x1.0.weight``, ``trans.layers.0.0.fn.to_qkv
.weight``, ``rel_pos_emb.rel_height``), the parameters drawn from the
caller's generator as the JAX package draws them (convolutions and Linears
U(±1/√fan_in), CrissCross's ``gamma`` zero, GFNet's filters N(0, 0.02²),
Halo's position tables N(0, 1/dim_head), ACmix's rates 0.5 and its shift
convolution the identity shift), eval-form BatchNorm, f32 contractions with
autograd's backward, no host sync. Inputs are NCHW, but ViP and Outlook take
NHWC as vendored. The math follows the JAX package where it and the
vendored code part: HaloAttention's padding mask is the vendored inverted
one (the VALID positions are filled with ``-finfo.max``, so an interior
block attends uniformly); ACmix's shift convolution has no bias (the
vendored ``reset_parameters`` sets it to None); CoAtNet's MBConv is the
standard EfficientNet block the JAX package assumes (the vendored import
exists nowhere). ViP's and GFNet's GELU is the tanh form of
``jax.nn.gelu``. CoAtNet's two attentions drop in train mode from the
generator given to ``forward``; nothing else drops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ser_tpu_torch.ops.attention_zoo import (BatchNorm, Conv2d, ScaledDotProductAttention,
                                             ZooLayerNorm, _indexed)
from ser_tpu_torch.ops.init import normal_
from ser_tpu_torch.ops.layers import TorchLinear, train_generator


class ResidualAttention(nn.Module):
    """Residual attention head: a bias-free 1x1 convolution to class maps,
    their spatial mean plus ``la`` times their max. NCHW -> [B, num_class]."""

    def __init__(self, channel: int = 512, num_class: int = 1000, la: float = 0.2, *,
                 generator: torch.Generator):
        super().__init__()
        self.la = la
        self.fc = Conv2d(channel, num_class, bias=False, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(x).flatten(2)
        return y.mean(2) + self.la * torch.amax(y, 2)


class ParNetAttention(nn.Module):
    """ParNet block: ``silu(bn(conv1x1) + bn(conv3x3) + sigmoid(sse) * x)``,
    the SSE gate a 1x1 convolution of the spatial mean."""

    def __init__(self, channel: int = 512, *, generator: torch.Generator):
        super().__init__()
        g, C = generator, channel
        self.sse = _indexed(_1=Conv2d(C, C, generator=g))
        self.conv1x1 = _indexed(_0=Conv2d(C, C, generator=g), _1=BatchNorm(C))
        self.conv3x3 = _indexed(_0=Conv2d(C, C, 3, padding=1, generator=g), _1=BatchNorm(C))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.sse["1"](x.mean((2, 3), keepdim=True)))
        x1 = self.conv1x1["1"](self.conv1x1["0"](x))
        x2 = self.conv3x3["1"](self.conv3x3["0"](x))
        return F.silu(x1 + x2 + gate * x)


class CrissCrossAttention(nn.Module):
    """Criss-cross attention: one softmax over the column and the row of each
    pixel, the pixel itself left out of the column (a -inf diagonal), scaled
    by ``gamma`` (zero at init) and added to the input."""

    def __init__(self, in_dim: int, *, generator: torch.Generator):
        super().__init__()
        g, C = generator, in_dim
        self.query_conv = Conv2d(C, C // 8, generator=g)
        self.key_conv = Conv2d(C, C // 8, generator=g)
        self.value_conv = Conv2d(C, C, generator=g)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H = x.shape[2]
        q, k, v = self.query_conv(x), self.key_conv(x), self.value_conv(x)
        energy_h = torch.einsum("bchw,bcgw->bhwg", q, k)
        diag = torch.eye(H, dtype=torch.bool, device=x.device)[None, :, None, :]
        energy_h = energy_h.masked_fill(diag, float("-inf"))
        energy_w = torch.einsum("bchw,bchv->bhwv", q, k)
        att = torch.softmax(torch.cat([energy_h, energy_w], 3), 3)
        out_h = torch.einsum("bcgw,bhwg->bchw", v, att[..., :H])
        out_w = torch.einsum("bchv,bhwv->bchw", v, att[..., H:])
        return self.gamma * (out_h + out_w) + x


class _ViPReweight(nn.Module):
    """ViP's reweighting MLP (``fc1``, ``fc2``)."""

    def __init__(self, C: int, *, generator: torch.Generator):
        super().__init__()
        self.fc1 = TorchLinear(C, C // 4, generator=generator)
        self.fc2 = TorchLinear(C // 4, 3 * C, generator=generator)


class WeightedPermuteMLP(nn.Module):
    """ViP's permute-MLP on NHWC input: a channel, a height and a width
    branch, each a Linear over C values (the height branch over the H x
    C/seg_dim slab of ``seg_dim`` channel segments, so H = W = seg_dim),
    weighed by a softmax over the branches of an MLP of their mean."""

    def __init__(self, dim: int, seg_dim: int = 8, qkv_bias: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        g, C = generator, dim
        self.seg_dim = seg_dim
        self.mlp_c = TorchLinear(C, C, bias=qkv_bias, generator=g)
        self.mlp_h = TorchLinear(C, C, bias=qkv_bias, generator=g)
        self.mlp_w = TorchLinear(C, C, bias=qkv_bias, generator=g)
        self.reweighting = _ViPReweight(C, generator=g)
        self.proj = TorchLinear(C, C, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        seg, S = self.seg_dim, C // self.seg_dim
        c_embed = self.mlp_c(x)
        segs = x.reshape(B, H, W, seg, S)
        h_in = segs.permute(0, 3, 2, 1, 4).reshape(B, seg, W, H * S)
        h_embed = self.mlp_h(h_in).reshape(B, seg, W, H, S).permute(0, 3, 2, 1, 4)
        w_in = segs.permute(0, 3, 1, 2, 4).reshape(B, seg, H, W * S)
        w_embed = self.mlp_w(w_in).reshape(B, seg, H, W, S).permute(0, 2, 3, 1, 4)
        h_embed, w_embed = h_embed.reshape(B, H, W, C), w_embed.reshape(B, H, W, C)
        pooled = (c_embed + h_embed + w_embed).reshape(B, -1, C).mean(1)
        rw = self.reweighting
        weight = rw.fc2(F.gelu(rw.fc1(pooled), approximate="tanh"))
        weight = torch.softmax(weight.reshape(B, C, 3).permute(2, 0, 1), 0)[:, :, None, None]
        return self.proj(c_embed * weight[0] + w_embed * weight[1] + h_embed * weight[2])


def _unfold(x: torch.Tensor, k: int, pad: int, stride: int = 1):
    """torch ``nn.Unfold``: NCHW -> ``[B, C·k·k, L]``, channels (c, ki, kj)
    major, and ``(h_out, w_out)``."""
    H, W = x.shape[2:]
    h_out = (H + 2 * pad - k) // stride + 1
    w_out = (W + 2 * pad - k) // stride + 1
    return F.unfold(x, k, padding=pad, stride=stride), (h_out, w_out)


def _fold(cols: torch.Tensor, out_hw, k: int, pad: int, stride: int = 1) -> torch.Tensor:
    """torch ``F.fold``: ``[B, C·k·k, L]`` -> NCHW, overlapping taps added."""
    return F.fold(cols, tuple(out_hw), k, padding=pad, stride=stride)


class OutlookAttention(nn.Module):
    """Outlook attention on NHWC input: a k x k attention map a pixel and
    head, predicted by a Linear from the pixel, applied to its unfolded
    neighbourhood of values and folded back. Stride 1 only, as in the JAX
    package."""

    def __init__(self, dim: int, num_heads: int = 1, kernel_size: int = 3, padding: int = 1,
                 stride: int = 1, *, generator: torch.Generator):
        super().__init__()
        if stride != 1:
            raise ValueError(f"OutlookAttention runs at stride 1 only, not {stride}")
        g, C, k = generator, dim, kernel_size
        self.num_heads, self.k, self.padding = num_heads, k, padding
        self.v_pj = TorchLinear(C, C, bias=False, generator=g)
        self.attn = TorchLinear(C, k ** 4 * num_heads, generator=g)
        self.proj = TorchLinear(C, C, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        k, nh, kk = self.k, self.num_heads, self.k * self.k
        hd = C // nh
        cols, (h, w) = _unfold(self.v_pj(x).permute(0, 3, 1, 2), k, self.padding)
        v = cols.reshape(B, nh, hd, kk, h * w).permute(0, 1, 4, 3, 2)  # [B, nh, hw, kk, hd]
        attn = self.attn(x).reshape(B, H * W, nh, kk, kk).transpose(1, 2)
        attn = torch.softmax(attn * hd ** -0.5, -1)
        out = torch.matmul(attn, v).permute(0, 1, 4, 3, 2).reshape(B, C * kk, h * w)
        return self.proj(_fold(out, (H, W), k, self.padding).permute(0, 2, 3, 1))


class _PreNorm(nn.Module):
    """MobileViT's ``PreNorm``: LayerNorm ``ln`` before ``fn``."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.ln = ZooLayerNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.ln(x))


class _MViTAttention(nn.Module):
    """MobileViT's multi-head attention over the patches of one position:
    bias-free ``to_qkv``, ``to_out.0``."""

    def __init__(self, dim: int, heads: int, head_dim: int, *, generator: torch.Generator):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_qkv = TorchLinear(dim, 3 * inner, bias=False, generator=generator)
        self.to_out = _indexed(_0=TorchLinear(inner, dim, generator=generator))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        B, P, N = t.shape[:3]
        shape = (B, P, N, self.heads, self.head_dim)
        q, k, v = (a.reshape(shape).transpose(2, 3) for a in self.to_qkv(t).chunk(3, -1))
        att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * self.head_dim ** -0.5, -1)
        out = torch.matmul(att, v).transpose(2, 3).reshape(B, P, N, -1)
        return self.to_out["0"](out)


class _MViTFeedForward(nn.Module):
    """MobileViT's MLP: ``net.0``, SiLU, ``net.3``."""

    def __init__(self, dim: int, mlp_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.net = _indexed(_0=TorchLinear(dim, mlp_dim, generator=generator),
                            _3=TorchLinear(mlp_dim, dim, generator=generator))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.net["3"](F.silu(self.net["0"](t)))


class _MViTTransformer(nn.Module):
    """``depth`` pre-norm attention and MLP pairs (``layers.i.0``, ``.1``)."""

    def __init__(self, dim: int, depth: int, heads: int, head_dim: int, mlp_dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.layers = nn.ModuleList(nn.ModuleList([
            _PreNorm(dim, _MViTAttention(dim, heads, head_dim, generator=g)),
            _PreNorm(dim, _MViTFeedForward(dim, mlp_dim, generator=g))]) for _ in range(depth))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for attn, ffn in self.layers:
            y = y + attn(y)
            y = y + ffn(y)
        return y


class MobileViTAttention(nn.Module):
    """MobileViT (v1) block: local convolutions, a transformer over the
    p x p patch grid (the patches at one offset attend to each other), a
    1x1 convolution back, and a convolution of it beside the input."""

    def __init__(self, in_channel: int = 3, dim: int = 512, kernel_size: int = 3,
                 patch_size: int = 7, depth: int = 3, heads: int = 8, head_dim: int = 64,
                 mlp_dim: int = 1024, *, generator: torch.Generator):
        super().__init__()
        g, C, ks = generator, in_channel, kernel_size
        self.dim, self.p = dim, patch_size
        self.conv1 = Conv2d(C, C, ks, padding=ks // 2, generator=g)
        self.conv2 = Conv2d(C, dim, generator=g)
        self.trans = _MViTTransformer(dim, depth, heads, head_dim, mlp_dim, generator=g)
        self.conv3 = Conv2d(dim, C, generator=g)
        self.conv4 = Conv2d(2 * C, C, ks, padding=ks // 2, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        p, D = self.p, self.dim
        nh, nw = H // p, W // p
        y = self.conv2(self.conv1(x))
        # 'bs dim (nh ph) (nw pw) -> bs (ph pw) (nh nw) dim'
        y = y.reshape(B, D, nh, p, nw, p).permute(0, 3, 5, 2, 4, 1).reshape(B, p * p, nh * nw, D)
        y = self.trans(y)
        y = y.reshape(B, p, p, nh, nw, D).permute(0, 5, 3, 1, 4, 2).reshape(B, D, H, W)
        return self.conv4(torch.cat([x, self.conv3(y)], 1))


class _PatchEmbed(nn.Module):
    """A strided patch convolution (``proj``)."""

    def __init__(self, cin: int, dim: int, p: int, *, generator: torch.Generator):
        super().__init__()
        self.proj = Conv2d(cin, dim, p, stride=p, generator=generator)


class _GlobalFilter(nn.Module):
    """GFNet's filter: ``complex_weight [a, a//2+1, D, 2]`` (real, imaginary)."""

    def __init__(self, a: int, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.complex_weight = nn.Parameter(normal_(torch.empty(a, a // 2 + 1, dim, 2), 0.02,
                                                   generator))


class _Mlp(nn.Module):
    """A two-Linear MLP (``fc1``, ``fc2``) with the tanh-form GELU."""

    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator):
        super().__init__()
        self.fc1 = TorchLinear(dim, hidden, generator=generator)
        self.fc2 = TorchLinear(hidden, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class _GFBlock(nn.Module):
    """``norm1``, the global filter, ``norm2``, the MLP, one residual."""

    def __init__(self, a: int, dim: int, mlp_ratio: int, *, generator: torch.Generator):
        super().__init__()
        self.a = a
        self.norm1 = ZooLayerNorm(dim)
        self.filter = _GlobalFilter(a, dim, generator=generator)
        self.norm2 = ZooLayerNorm(dim)
        self.mlp = _Mlp(dim, dim * mlp_ratio, generator=generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        B, _, D = y.shape
        a = self.a
        f = torch.fft.rfft2(self.norm1(y).reshape(B, a, a, D), dim=(1, 2), norm="ortho")
        f = f * torch.view_as_complex(self.filter.complex_weight)
        t = torch.fft.irfft2(f, s=(a, a), dim=(1, 2), norm="ortho").reshape(B, -1, D)
        return y + self.mlp(self.norm2(t))


class GFNet(nn.Module):
    """Global-filter network: patch embedding, ``depth`` blocks of a
    spectral filter and an MLP, the patches' mean, a softmaxed head. NCHW
    images -> [B, num_classes]. The vendored ``embedding`` Linear is declared
    and never used (its gradient stays None)."""

    def __init__(self, embed_dim: int = 384, img_size: int = 224, patch_size: int = 16,
                 mlp_ratio: int = 4, depth: int = 4, num_classes: int = 1000, in_chans: int = 3,
                 *, generator: torch.Generator):
        super().__init__()
        g, D, p = generator, embed_dim, patch_size
        a = img_size // p
        self.patch_embed = _PatchEmbed(in_chans, D, p, generator=g)
        self.embedding = TorchLinear(p * p * in_chans, D, generator=g)
        self.blocks = nn.ModuleList(_GFBlock(a, D, mlp_ratio, generator=g) for _ in range(depth))
        self.head = TorchLinear(D, num_classes, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # [B, N, D]
        for block in self.blocks:
            y = block(y)
        return torch.softmax(self.head(y.mean(1)), 1)


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """Relative -> absolute positions: ``[b, l, 2r - 1]`` -> ``[b, l, r]``
    by the pad-and-reshape trick."""
    b, l, m = x.shape
    r = (m + 1) // 2
    x = torch.cat([x, x.new_zeros(b, l, 1)], 2)
    flat = torch.cat([x.reshape(b, -1), x.new_zeros(b, m - l)], 1)
    return flat.reshape(b, l + 1, m)[:, :l, -r:]


def _relative_logits_1d(q: torch.Tensor, rel_k: torch.Tensor) -> torch.Tensor:
    """``q [b, h, w, d]`` against the relative table ``[2r - 1, d]`` ->
    ``[b, h, r, w, r]`` (the logits broadcast over the other axis)."""
    b, h, w, _ = q.shape
    r = (rel_k.shape[0] + 1) // 2
    logits = _rel_to_abs(torch.einsum("bxyd,rd->bxyr", q, rel_k).reshape(b * h, w, -1))
    return logits.reshape(b, h, w, r)[:, :, None].expand(b, h, r, w, r)


class _RelPosEmb(nn.Module):
    """Halo's relative position tables ``rel_height``, ``rel_width``."""

    def __init__(self, rel_size: int, dim_head: int, *, generator: torch.Generator):
        super().__init__()
        scale = dim_head ** -0.5
        self.rel_height = nn.Parameter(normal_(torch.empty(2 * rel_size - 1, dim_head), scale,
                                               generator))
        self.rel_width = nn.Parameter(normal_(torch.empty(2 * rel_size - 1, dim_head), scale,
                                              generator))


class HaloAttention(nn.Module):
    """Blocked local attention: each block x block block of queries attends
    to its block widened by ``halo`` on every side, with relative position
    logits. The vendored padding mask is inverted (its VALID positions are
    filled with ``-finfo.max``), and so is this one."""

    def __init__(self, dim: int, block_size: int, halo_size: int, dim_head: int = 64,
                 heads: int = 8, *, generator: torch.Generator):
        super().__init__()
        g, inner = generator, dim_head * heads
        self.block, self.halo, self.heads, self.dim_head = block_size, halo_size, heads, dim_head
        self.rel_size = block_size + 2 * halo_size
        self.to_q = TorchLinear(dim, inner, bias=False, generator=g)
        self.to_kv = TorchLinear(dim, 2 * inner, bias=False, generator=g)
        self.to_out = TorchLinear(inner, dim, generator=g)
        self.rel_pos_emb = _RelPosEmb(self.rel_size, dim_head, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        block, halo, heads, dh, rs = self.block, self.halo, self.heads, self.dim_head, self.rel_size
        nh, nw = H // block, W // block
        nb, bb, rr = nh * nw, block * block, rs * rs
        q_inp = x.reshape(B, C, nh, block, nw, block).permute(0, 2, 4, 3, 5, 1).reshape(
            B * nb, bb, C)
        kv_cols, _ = _unfold(x, rs, halo, stride=block)
        kv_inp = kv_cols.reshape(B, C, rr, nb).permute(0, 3, 2, 1).reshape(B * nb, rr, C)

        def merge_heads(t):
            n = t.shape[1]
            return t.reshape(-1, n, heads, dh).transpose(1, 2).reshape(-1, n, dh)

        k, v = self.to_kv(kv_inp).chunk(2, -1)
        q, k, v = merge_heads(self.to_q(q_inp)), merge_heads(k), merge_heads(v)
        q = q * dh ** -0.5
        sim = torch.einsum("bid,bjd->bij", q, k)
        qb = q.reshape(-1, block, block, dh)
        emb = self.rel_pos_emb
        rl_w = _relative_logits_1d(qb, emb.rel_width).permute(0, 1, 3, 2, 4).reshape(-1, bb, rr)
        rl_h = _relative_logits_1d(qb.transpose(1, 2), emb.rel_height).permute(
            0, 3, 1, 4, 2).reshape(-1, bb, rr)
        sim = sim + rl_w + rl_h
        # the vendored mask: unfold of ones is 1 at the valid positions, and
        # those are the ones filled
        ones = torch.ones(1, 1, H, W, dtype=x.dtype, device=x.device)
        valid = _unfold(ones, rs, halo, stride=block)[0].reshape(rr, nb).T > 0  # [nb, rr]
        mask = valid[None, :, None, None, :].expand(B, nb, heads, 1, rr).reshape(-1, 1, rr)
        sim = sim.masked_fill(mask, -torch.finfo(sim.dtype).max)
        out = torch.einsum("bij,bjd->bid", torch.softmax(sim, -1), v)
        out = out.reshape(-1, heads, bb, dh).transpose(1, 2).reshape(-1, bb, heads * dh)
        out = self.to_out(out).reshape(B, nh, nw, block, block, C)
        return out.permute(0, 5, 1, 3, 2, 4).reshape(B, C, H, W)


class ACmix(nn.Module):
    """ACmix: shared 1x1 q, k, v feeding a local-window attention (reflect
    padded, with a learned encoding of the ``linspace`` positions) and a
    shift convolution (``fc`` over the heads, then the grouped ``dep_conv``,
    the identity shift at init, no bias), mixed by ``rate1``, ``rate2``
    (0.5 at init). Stride 1."""

    def __init__(self, in_planes: int, out_planes: int, kernel_att: int = 7, head: int = 4,
                 kernel_conv: int = 3, dilation: int = 1, *, generator: torch.Generator):
        super().__init__()
        g, C, kc = generator, in_planes, kernel_conv
        self.head, self.hd, self.out_planes = head, out_planes // head, out_planes
        self.kernel_att, self.kernel_conv, self.dilation = kernel_att, kc, dilation
        self.rate1 = nn.Parameter(torch.full((1,), 0.5))
        self.rate2 = nn.Parameter(torch.full((1,), 0.5))
        self.conv1 = Conv2d(C, out_planes, generator=g)
        self.conv2 = Conv2d(C, out_planes, generator=g)
        self.conv3 = Conv2d(C, out_planes, generator=g)
        self.conv_p = Conv2d(2, self.hd, generator=g)
        self.fc = Conv2d(3 * head, kc * kc, bias=False, generator=g)
        self.dep_conv = Conv2d(kc * kc * self.hd, out_planes, kc, padding=1, groups=self.hd,
                               bias=False, generator=g)
        with torch.no_grad():
            shift = torch.zeros(kc * kc, kc, kc)
            for i in range(kc * kc):
                shift[i, i // kc, i % kc] = 1.0
            self.dep_conv.weight.copy_(shift.expand(out_planes, -1, -1, -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        head, hd, ka = self.head, self.hd, self.kernel_att
        q, k, v = self.conv1(x), self.conv2(x), self.conv3(x)
        loc_w = torch.linspace(-1.0, 1.0, W, device=x.device)[None].expand(H, W)
        loc_h = torch.linspace(-1.0, 1.0, H, device=x.device)[:, None].expand(H, W)
        pe = self.conv_p(torch.stack([loc_w, loc_h])[None])  # [1, hd, H, W]
        pad = (self.dilation * (ka - 1) + 1) // 2

        def unfold_reflect(t):
            cols, _ = _unfold(F.pad(t, (pad,) * 4, mode="reflect"), ka, 0)
            return cols.reshape(t.shape[0], t.shape[1], ka * ka, H, W)

        q_att = q.reshape(B * head, hd, H, W) * hd ** -0.5
        unfold_k = unfold_reflect(k.reshape(B * head, hd, H, W))
        att = (q_att[:, :, None] * (unfold_k + pe[:, :, None] - unfold_reflect(pe))).sum(1)
        att = torch.softmax(att, 1)  # [B·head, ka², H, W]
        out_att = (att[:, None] * unfold_reflect(v.reshape(B * head, hd, H, W))).sum(2)
        out_att = out_att.reshape(B, self.out_planes, H, W)

        f_all = torch.cat([t.reshape(B, head, hd, H * W) for t in (q, k, v)], 1)
        f_all = torch.einsum("bchn,oc->bohn", f_all, self.fc.weight[:, :, 0, 0])
        out_conv = self.dep_conv(f_all.transpose(1, 2).reshape(B, -1, H, W))
        return self.rate1 * out_att + self.rate2 * out_conv


class _AxialSelfAttention(nn.Module):
    """Multi-head self-attention along a sequence: bias-free ``to_q`` and
    ``to_kv``, ``to_out``."""

    def __init__(self, dim: int, heads: int, dim_heads: int, *, generator: torch.Generator):
        super().__init__()
        inner = heads * dim_heads
        self.heads, self.dim_heads = heads, dim_heads
        self.to_q = TorchLinear(dim, inner, bias=False, generator=generator)
        self.to_kv = TorchLinear(dim, 2 * inner, bias=False, generator=generator)
        self.to_out = TorchLinear(inner, dim, generator=generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        n, L, _ = t.shape
        h, e = self.heads, self.dim_heads

        def mh(a):
            return a.reshape(n, L, h, e).transpose(1, 2).reshape(n * h, L, e)

        k, v = self.to_kv(t).chunk(2, -1)
        q, k, v = mh(self.to_q(t)), mh(k), mh(v)
        dots = torch.softmax(torch.einsum("bie,bje->bij", q, k) * e ** -0.5, -1)
        out = torch.einsum("bij,bje->bie", dots, v).reshape(n, h, L, e).transpose(1, 2)
        return self.to_out(out.reshape(n, L, h * e))


class _PermuteToFrom(nn.Module):
    """The vendored wrapper of one axis's attention (``fn``)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class AxialAttention(nn.Module):
    """Axial attention on NCHW input: self-attention along H and along W
    (``axial_attentions.0``, ``.1``), the two summed. Two axes only, as in
    the JAX package."""

    def __init__(self, dim: int, num_dimensions: int = 2, heads: int = 8,
                 dim_heads: int | None = None, *, generator: torch.Generator):
        super().__init__()
        if num_dimensions != 2:
            raise ValueError(f"AxialAttention attends over 2 axes, not {num_dimensions}")
        e = dim // heads if dim_heads is None else dim_heads
        self.axial_attentions = nn.ModuleList(
            _PermuteToFrom(_AxialSelfAttention(dim, heads, e, generator=generator))
            for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        along_h, along_w = (a.fn for a in self.axial_attentions)
        out_h = along_h(x.permute(0, 3, 2, 1).reshape(B * W, H, C))
        out_w = along_w(x.permute(0, 2, 3, 1).reshape(B * H, W, C))
        return out_h.reshape(B, W, H, C).permute(0, 3, 2, 1) \
            + out_w.reshape(B, H, W, C).permute(0, 3, 1, 2)


class MBConvBlock(nn.Module):
    """The EfficientNet MBConv block: a 1x1 expansion (unless the ratio is
    1), a depthwise convolution, squeeze and excitation, a 1x1 projection,
    each convolution bias-free with its BatchNorm and SiLU, plus the input
    where the widths agree."""

    def __init__(self, ksize: int, input_filters: int, output_filters: int,
                 expand_ratio: int = 1, se_ratio: float = 0.25, *, generator: torch.Generator):
        super().__init__()
        g, cin = generator, input_filters
        mid = cin * expand_ratio
        self.expand = expand_ratio != 1
        self.residual = input_filters == output_filters
        if self.expand:
            self._expand_conv = Conv2d(cin, mid, bias=False, generator=g)
            self._bn0 = BatchNorm(mid)
        self._depthwise_conv = Conv2d(mid, mid, ksize, padding=ksize // 2, groups=mid, bias=False,
                                      generator=g)
        self._bn1 = BatchNorm(mid)
        se_c = max(1, int(cin * se_ratio))
        self._se_reduce = Conv2d(mid, se_c, generator=g)
        self._se_expand = Conv2d(se_c, mid, generator=g)
        self._project_conv = Conv2d(mid, output_filters, bias=False, generator=g)
        self._bn2 = BatchNorm(output_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self._bn0(self._expand_conv(x))) if self.expand else x
        y = F.silu(self._bn1(self._depthwise_conv(y)))
        s = F.silu(self._se_reduce(y.mean((2, 3), keepdim=True)))
        y = y * torch.sigmoid(self._se_expand(s))
        y = self._bn2(self._project_conv(y))
        return y + x if self.residual else y


def _conv_mlp(cin: int, cout: int, k: int, pad: int, *, generator: torch.Generator):
    """CoAtNet's convolution pair (``0``, ``2``) with a ReLU between."""
    return _indexed(_0=Conv2d(cin, cout, k, padding=pad, generator=generator),
                    _2=Conv2d(cout, cout, k, padding=pad, generator=generator))


class CoAtNet(nn.Module):
    """CoAtNet: a convolution stem, two MBConv stages and two attention
    stages (``s3``, ``s4``: 8 heads each), with 2x2 max pools between the
    convolution stages and a max pool of pairs of the sequence after each
    attention stage (an odd last token dropped). NCHW images -> ``[B,
    out_chs[4], side, side]``. In train mode the attentions drop from the
    generator given to ``forward``."""

    def __init__(self, in_ch: int, image_size: int, out_chs=(64, 96, 192, 384, 768), *,
                 generator: torch.Generator):
        super().__init__()
        g, oc = generator, tuple(out_chs)
        self.s0 = _conv_mlp(in_ch, in_ch, 3, 1, generator=g)
        self.mlp0 = _conv_mlp(in_ch, oc[0], 1, 0, generator=g)
        self.s1 = MBConvBlock(3, oc[0], oc[0], generator=g)
        self.mlp1 = _conv_mlp(oc[0], oc[1], 1, 0, generator=g)
        self.s2 = MBConvBlock(3, oc[1], oc[1], generator=g)
        self.mlp2 = _conv_mlp(oc[1], oc[2], 1, 0, generator=g)
        self.s3 = ScaledDotProductAttention(oc[2], oc[2] // 8, oc[2] // 8, 8, generator=g)
        self.mlp3 = _indexed(_0=TorchLinear(oc[2], oc[3], generator=g),
                             _2=TorchLinear(oc[3], oc[3], generator=g))
        self.s4 = ScaledDotProductAttention(oc[3], oc[3] // 8, oc[3] // 8, 8, generator=g)
        self.mlp4 = _indexed(_0=TorchLinear(oc[3], oc[4], generator=g),
                             _2=TorchLinear(oc[4], oc[4], generator=g))

    @staticmethod
    def _pair(mlp, t):
        return mlp["2"](torch.relu(mlp["0"](t)))

    @staticmethod
    def _pool_sequence(t):
        """``MaxPool1d(2)`` along the sequence of ``[B, N, C]``."""
        return F.max_pool1d(t.transpose(1, 2), 2).transpose(1, 2)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        gen = train_generator(self, generator)
        y = self._pair(self.s0, x)
        y = F.max_pool2d(self._pair(self.mlp0, y), 2)
        y = F.max_pool2d(self._pair(self.mlp1, self.s1(y)), 2)
        y = F.max_pool2d(self._pair(self.mlp2, self.s2(y)), 2)
        B = y.shape[0]
        y = y.flatten(2).transpose(1, 2)  # [B, N, C]
        y = self._pool_sequence(self._pair(self.mlp3, self.s3(y, y, y, gen)))
        y = self._pool_sequence(self._pair(self.mlp4, self.s4(y, y, y, gen)))
        side = int(y.shape[1] ** 0.5)
        return y.transpose(1, 2).reshape(B, -1, side, side)
