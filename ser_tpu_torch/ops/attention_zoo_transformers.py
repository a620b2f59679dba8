"""The attention zoo's Swin-family backbones,
``ser_tpu/ops/attention_zoo_transformers.py``: CrossFormer, MOATransformer
and DAT (deformable attention), and their shared helpers (window partition
and reverse, the Swin relative position index, bilinear ``grid_sample``).

The conventions are ``attention_zoo``'s: the vendored modules' parameter
names and torch layouts (``layers.0.blocks.1.attn.pos.pos1.2.weight``,
``stages.2.attns.1.conv_offset.0.weight``), the parameters drawn from the
caller's generator as the JAX package draws them (Linears and convolutions
U(±1/√fan_in), LayerNorms ones and zeros, the relative position tables
N(0, 0.01²)), f32 contractions with autograd's backward, every ReLU through
``torch.relu``, no host sync: the relative position indices and DAT's shift
masks are buffers made on the host once, at construction, for the
resolutions ``img_size`` gives each stage. The math follows the JAX package,
which keeps the vendored quirks: MOA's global attention unfolds its keys at
a stride of 14 whatever the window, and reads ``[B, HW, C]`` tokens as
``[B, C, H, W]`` by raw reshapes, as vendored. The MLPs' GELU is the tanh
form of ``jax.nn.gelu``; DAT's offset network's is the exact form. None
drops: the JAX classes run the eval path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ser_tpu_torch.ops.attention_zoo import Conv2d, ZooLayerNorm, _indexed
from ser_tpu_torch.ops.attention_zoo_vision import _Mlp, _unfold
from ser_tpu_torch.ops.init import normal_
from ser_tpu_torch.ops.layers import TorchLinear


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B·nW, ws·ws, C]`` (the Swin layout)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(w: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """``[B·nW, ws·ws, C]`` -> ``[B, H, W, C]``."""
    C = w.shape[-1]
    B = w.shape[0] // (H * W // ws // ws)
    x = w.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def relative_position_index(Wh: int, Ww: int) -> np.ndarray:
    """The Swin pair-wise relative position index ``[Wh·Ww, Wh·Ww]`` into a
    ``(2Wh - 1)(2Ww - 1)`` table."""
    coords = np.stack(np.meshgrid(np.arange(Wh), np.arange(Ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += Wh - 1
    rel[:, :, 1] += Ww - 1
    rel[:, :, 0] *= 2 * Ww - 1
    return rel.sum(-1)


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``x [B, C, H, W]`` sampled at ``grid [B, Hg, Wg, 2]`` ((x, y) order over
    [-1, 1], corners aligned, zero outside) -> ``[B, C, Hg, Wg]``."""
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def _bias_gather(table: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """``table [(2G-1)², heads]`` gathered by a relative index -> ``[heads, n, n]``."""
    return table[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)


def _index_buffer(module: nn.Module, G: int) -> None:
    module.register_buffer("relative_position_index",
                           torch.from_numpy(relative_position_index(G, G)), persistent=False)


def _table(rows: int, heads: int, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(normal_(torch.empty(rows, heads), 0.01, generator))


def _attend(q, k, v, bias):
    """``softmax(q·kᵀ + bias)·v`` over heads ``[b, h, n, d]`` -> ``[b, n, h·d]``."""
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + bias, -1)
    out = torch.matmul(attn, v).transpose(1, 2)
    return out.reshape(*out.shape[:2], -1)


class _WindowAttention(nn.Module):
    """Attention inside G x G groups with a relative position bias (``qkv``,
    ``proj``); the bias comes from ``bias()``, which the subclass gives."""

    def __init__(self, dim: int, heads: int, G: int, *, generator: torch.Generator):
        super().__init__()
        self.heads, self.G = heads, G
        self.qkv = TorchLinear(dim, 3 * dim, generator=generator)
        self.proj = TorchLinear(dim, dim, generator=generator)
        _index_buffer(self, G)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B_, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.qkv(x).reshape(B_, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        return self.proj(_attend(q * hd ** -0.5, k, v, self.bias()[None]))


# --- CrossFormer ---------------------------------------------------------------


class _DynamicPosBias(nn.Module):
    """CrossFormer's position MLP (residual off): ``pos_proj`` from the (dy,
    dx) offsets, then three LayerNorm, ReLU, Linear blocks (``pos1``-``pos3``,
    the last to a bias a head). Its width is dim // 16, as vendored."""

    def __init__(self, dim: int, heads: int, *, generator: torch.Generator):
        super().__init__()
        g, pd = generator, dim // 16
        self.pos_proj = TorchLinear(2, pd, generator=g)
        for i, d_out in ((1, pd), (2, pd), (3, heads)):
            setattr(self, f"pos{i}", _indexed(_0=ZooLayerNorm(pd),
                                              _2=TorchLinear(pd, d_out, generator=g)))

    def forward(self, biases: torch.Tensor) -> torch.Tensor:
        pos = self.pos_proj(biases)
        for block in (self.pos1, self.pos2, self.pos3):
            pos = block["2"](torch.relu(block["0"](pos)))
        return pos  # [(2G-1)², heads]


class _CrossAttention(_WindowAttention):
    """Group attention with the dynamic position bias (``pos``)."""

    def __init__(self, dim: int, heads: int, G: int, *, generator: torch.Generator):
        super().__init__(dim, heads, G, generator=generator)
        self.pos = _DynamicPosBias(dim, heads, generator=generator)
        ph = np.arange(1 - G, G)
        grid = np.stack(np.meshgrid(ph, ph, indexing="ij")).reshape(2, -1).T
        self.register_buffer("biases", torch.tensor(grid, dtype=torch.float32), persistent=False)

    def bias(self) -> torch.Tensor:
        return _bias_gather(self.pos(self.biases), self.relative_position_index, self.G ** 2)


class _CrossFormerBlock(nn.Module):
    """LayerNorm, attention in short-distance (contiguous, SDA) or
    long-distance (dilated, LDA) G x G groups, LayerNorm, MLP. A stage whose
    side is at most G runs SDA with G its side."""

    def __init__(self, dim: int, res: int, heads: int, G: int, lsda: bool, mlp_ratio: float, *,
                 generator: torch.Generator):
        super().__init__()
        if res <= G:
            lsda, G = False, res
        self.res, self.G, self.lsda = res, G, lsda
        self.norm1 = ZooLayerNorm(dim)
        self.attn = _CrossAttention(dim, heads, G, generator=generator)
        self.norm2 = ZooLayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        H = W = self.res
        G = self.G
        t = self.norm1(x).reshape(B, H, W, C)
        if self.lsda:
            t = t.reshape(B, G, H // G, G, W // G, C).permute(0, 2, 4, 1, 3, 5)
        else:
            t = t.reshape(B, H // G, G, W // G, G, C).permute(0, 1, 3, 2, 4, 5)
        t = self.attn(t.reshape(-1, G * G, C)).reshape(B, H // G, W // G, G, G, C)
        t = t.permute(0, 3, 1, 4, 2, 5) if self.lsda else t.permute(0, 1, 3, 2, 4, 5)
        x = x + t.reshape(B, L, C)
        return x + self.mlp(self.norm2(x))


def _split_widths(total: int, n: int) -> list[int]:
    """CrossFormer's widths of n kernels' outputs: total/2, total/4, ...,
    the last kernel the rest."""
    return [total // 2 ** i if i == n - 1 else total // 2 ** (i + 1) for i in range(n)]


class _CrossPatchEmbed(nn.Module):
    """Multi-kernel patch embedding: one strided convolution a kernel size
    (``projs``), their outputs side by side, LayerNorm (``norm``)."""

    def __init__(self, patch_size, in_chans: int, dim: int, *, generator: torch.Generator):
        super().__init__()
        s = patch_size[0]
        self.projs = nn.ModuleList(
            Conv2d(in_chans, d, ps, stride=s, padding=(ps - s) // 2, generator=generator)
            for ps, d in zip(patch_size, _split_widths(dim, len(patch_size))))
        self.norm = ZooLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(torch.cat([p(x).flatten(2).transpose(1, 2) for p in self.projs], 2))


class _CrossPatchMerging(nn.Module):
    """Multi-kernel patch merging: LayerNorm, one stride-2 convolution a
    kernel size (``reductions``) to 2·dim channels in all."""

    def __init__(self, dim: int, res: int, patch_sizes, *, generator: torch.Generator):
        super().__init__()
        self.res = res
        self.norm = ZooLayerNorm(dim)
        self.reductions = nn.ModuleList(
            Conv2d(dim, d, ps, stride=2, padding=(ps - 2) // 2, generator=generator)
            for ps, d in zip(patch_sizes, _split_widths(2 * dim, len(patch_sizes))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, C = x.shape
        t = self.norm(x).reshape(B, self.res, self.res, C).permute(0, 3, 1, 2)
        return torch.cat([r(t).flatten(2).transpose(1, 2) for r in self.reductions], 2)


class _Stage(nn.Module):
    """A stage's ``blocks`` and its ``downsample`` (None in the last)."""

    def __init__(self, blocks, downsample: nn.Module | None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            y = block(y)
        return y if self.downsample is None else self.downsample(y)


def _head(model: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """The final LayerNorm, the tokens' mean, the class head."""
    return model.head(model.norm(y).mean(1))


class CrossFormer(nn.Module):
    """CrossFormer: multi-kernel patch embedding, stages of SDA and LDA
    blocks in turn, multi-kernel patch merging between stages. NCHW images
    -> ``[B, num_classes]``."""

    def __init__(self, img_size: int = 224, patch_size=(4, 8), in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), group_size=(7, 7, 7, 7), mlp_ratio: float = 4.0,
                 merge_size=((2, 4), (2, 4), (2, 4)), *, generator: torch.Generator):
        super().__init__()
        g, D, n = generator, embed_dim, len(depths)
        res = img_size // patch_size[0]
        self.patch_embed = _CrossPatchEmbed(patch_size, in_chans, D, generator=g)
        self.layers = nn.ModuleList()
        for i in range(n):
            dim, r = D * 2 ** i, res // 2 ** i
            blocks = [_CrossFormerBlock(dim, r, num_heads[i], group_size[i], d % 2 == 1,
                                        mlp_ratio, generator=g) for d in range(depths[i])]
            down = _CrossPatchMerging(dim, r, merge_size[i], generator=g) if i < n - 1 else None
            self.layers.append(_Stage(blocks, down))
        nf = D * 2 ** (n - 1)
        self.norm = ZooLayerNorm(nf)
        self.head = TorchLinear(nf, num_classes, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.patch_embed(x)
        for layer in self.layers:
            y = layer(y)
        return _head(self, y)


# --- MOATransformer ------------------------------------------------------------


class _TableAttention(_WindowAttention):
    """Window attention with a learned relative position table
    (``relative_position_bias_table``, N(0, 0.01²))."""

    def __init__(self, dim: int, heads: int, ws: int, *, generator: torch.Generator):
        super().__init__(dim, heads, ws, generator=generator)
        self.relative_position_bias_table = _table((2 * ws - 1) ** 2, heads, generator)

    def bias(self) -> torch.Tensor:
        return _bias_gather(self.relative_position_bias_table, self.relative_position_index,
                            self.G ** 2)


class _SwinBlock(nn.Module):
    """LayerNorm, window attention (windows of ``ws``), LayerNorm, MLP."""

    def __init__(self, dim: int, res: int, heads: int, ws: int, mlp_ratio: float, *,
                 generator: torch.Generator):
        super().__init__()
        self.res, self.ws = res, ws
        self.norm1 = ZooLayerNorm(dim)
        self.attn = _TableAttention(dim, heads, ws, generator=generator)
        self.norm2 = ZooLayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        t = window_partition(self.norm1(x).reshape(B, self.res, self.res, C), self.ws)
        x = x + window_reverse(self.attn(t), self.ws, self.res, self.res).reshape(B, L, C)
        return x + self.mlp(self.norm2(x))


class _GlobalAttention(nn.Module):
    """MOA's global attention: a 1x1 reduction (``pre_conv``), one query a
    window from its raw-viewed patch (``q``), keys and values from the
    window widened by one on each side (``kv``; unfolded at stride 14, as
    vendored), a relative position table over the windows."""

    def __init__(self, dim: int, res: int, heads: int, ws: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.dim, self.res, self.heads, self.ws = dim, res, heads, ws
        self.seq, red = res // ws, max(1, dim // 32)
        self.red = red
        self.pre_conv = Conv2d(dim, red, generator=g)
        self.relative_position_bias_table = _table((2 * self.seq - 1) ** 2, heads, g)
        self.q = TorchLinear(red * ws * ws, dim, generator=g)
        self.kv = TorchLinear(red * (ws + 2) ** 2, 2 * dim, generator=g)
        self.proj = TorchLinear(dim, dim, generator=g)
        _index_buffer(self, self.seq)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        H = W = self.res
        dim, heads, ws, seq, red = self.dim, self.heads, self.ws, self.seq, self.red
        hd = dim // heads
        t = self.pre_conv(x.reshape(B, dim, H, W))  # the raw reshape of [B, HW, C]
        # 'b c (h p1) (w p2) -> b (p1 p2 c) h w', then a raw view as [B, nW, ·]
        qe = t.reshape(B, red, seq, ws, seq, ws).permute(0, 3, 5, 1, 2, 4).reshape(
            B, seq * seq, -1)
        N = seq * seq
        q = self.q(qe).reshape(B, N, heads, hd).transpose(1, 2) * hd ** -0.5
        key = _unfold(t, ws + 2, 1, stride=14)[0].reshape(B, N, -1)  # a raw view
        k, v = self.kv(key).reshape(B, N, 2, heads, hd).permute(2, 0, 3, 1, 4)
        bias = _bias_gather(self.relative_position_bias_table, self.relative_position_index, N)
        return self.proj(_attend(q, k, v, bias[None]))


class _PatchEmbedNorm(nn.Module):
    """A strided patch convolution (``proj``) to tokens, LayerNorm (``norm``)."""

    def __init__(self, cin: int, dim: int, p: int, *, generator: torch.Generator):
        super().__init__()
        self.proj = Conv2d(cin, dim, p, stride=p, generator=generator)
        self.norm = ZooLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class _SwinPatchMerging(nn.Module):
    """Swin patch merging: each 2x2 neighbourhood's four tokens side by side,
    LayerNorm (``norm``), a bias-free ``reduction`` to 2·dim."""

    def __init__(self, dim: int, res: int, *, generator: torch.Generator):
        super().__init__()
        self.res = res
        self.norm = ZooLayerNorm(4 * dim)
        self.reduction = TorchLinear(4 * dim, 2 * dim, bias=False, generator=generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        B, _, dim = y.shape
        t = y.reshape(B, self.res, self.res, dim)
        t = torch.cat([t[:, 0::2, 0::2], t[:, 1::2, 0::2], t[:, 0::2, 1::2], t[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(t.reshape(B, -1, 4 * dim)))


class _MOAStage(_Stage):
    """A MOA stage: its Swin ``blocks``, then (where the side is at least a
    window) the global attention broadcast over the windows with ``norm1``,
    ``norm2`` and ``post_conv``, then Swin patch merging (``downsample``)."""

    def __init__(self, blocks, dim: int, res: int, heads: int, ws: int, last: bool, *,
                 generator: torch.Generator):
        super().__init__(blocks, None if last else _SwinPatchMerging(dim, res,
                                                                     generator=generator))
        self.dim, self.res, self.ws = dim, res, ws
        self.glb_attn = None
        if not last and res >= ws:
            self.norm1 = ZooLayerNorm(dim)
            self.norm2 = ZooLayerNorm(dim)
            self.post_conv = Conv2d(dim, dim, 3, padding=1, generator=generator)
            self.glb_attn = _GlobalAttention(dim, res, heads, ws, generator=generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            y = block(y)
        if self.downsample is None:
            return y
        if self.glb_attn is not None:
            B, HW, dim = y.shape
            ws = self.ws
            t = self.norm1(y)
            nw = HW // ws ** 2
            glb = self.glb_attn(t).reshape(B, nw, 1, 1, dim)
            # the windows are a raw reshape of the tokens, as vendored
            y = y + (t.reshape(B, nw, ws, ws, dim) + glb).reshape(B, HW, dim)
            y = self.norm2(y)
            y = y + self.post_conv(y.reshape(B, dim, self.res, self.res)).reshape(B, HW, dim)
        return self.downsample(y)


class MOATransformer(nn.Module):
    """MOA transformer: Swin window-attention stages with the multi-resolution
    overlapped (global) attention at each stage boundary. NCHW images ->
    ``[B, num_classes]``. As vendored, only window 14 is self-consistent."""

    def __init__(self, img_size: int = 224, patch_size: int = 4, in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 96, depths=(2, 2, 6),
                 num_heads=(3, 6, 12), window_size: int = 14, mlp_ratio: float = 4.0, *,
                 generator: torch.Generator):
        super().__init__()
        g, D, n = generator, embed_dim, len(depths)
        res = img_size // patch_size
        self.patch_embed = _PatchEmbedNorm(in_chans, D, patch_size, generator=g)
        self.layers = nn.ModuleList()
        for i in range(n):
            dim, r = D * 2 ** i, res // 2 ** i
            ws = min(window_size, r)
            blocks = [_SwinBlock(dim, r, num_heads[i], ws, mlp_ratio, generator=g)
                      for _ in range(depths[i])]
            self.layers.append(_MOAStage(blocks, dim, r, num_heads[i], window_size, i == n - 1,
                                         generator=g))
        nf = D * 2 ** (n - 1)
        self.norm = ZooLayerNorm(nf)
        self.head = TorchLinear(nf, num_classes, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.patch_embed(x)
        for layer in self.layers:
            y = layer(y)
        return _head(self, y)


# --- DAT -----------------------------------------------------------------------


class _LayerNormProxy(nn.Module):
    """A channel-last LayerNorm (``norm``) on NCHW maps."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = ZooLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _shift_mask(H: int, W: int, ws: int, shift: int) -> torch.Tensor:
    """The Swin shifted-window mask ``[nW, ws², ws²]``: -100 between tokens
    of different regions."""
    img = torch.zeros(1, H, W, 1)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl] = cnt
            cnt += 1
    mw = window_partition(img, ws)[..., 0]
    return torch.where(mw[:, None, :] - mw[:, :, None] != 0, -100.0, 0.0)


class _LocalAttention(nn.Module):
    """DAT's local (``L``) or shifted-window (``S``) attention on NCHW maps:
    ``proj_qkv``, ``proj_out``, a relative position table; the shifted form
    rolls by ``shift`` and masks across the rolled regions (-100)."""

    def __init__(self, dim: int, heads: int, ws: int, res: int, shift: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads, self.ws, self.shift = heads, ws, shift
        self.relative_position_bias_table = _table((2 * ws - 1) ** 2, heads, generator)
        self.proj_qkv = TorchLinear(dim, 3 * dim, generator=generator)
        self.proj_out = TorchLinear(dim, dim, generator=generator)
        _index_buffer(self, ws)
        if shift:
            self.register_buffer("attn_mask", _shift_mask(res, res, ws, shift), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        ws, heads, s = self.ws, self.heads, self.shift
        hd = C // heads
        if s:
            x = torch.roll(x, (-s, -s), (2, 3))
        xw = window_partition(x.permute(0, 2, 3, 1), ws)
        q, k, v = (t.reshape(t.shape[0], ws * ws, heads, hd).transpose(1, 2)
                   for t in self.proj_qkv(xw).chunk(3, 2))
        bias = _bias_gather(self.relative_position_bias_table, self.relative_position_index,
                            ws * ws)[None]
        if s:  # the windows of one image in turn, each with its mask
            bias = bias + self.attn_mask.repeat(B, 1, 1)[:, None]
        out = self.proj_out(_attend(q * hd ** -0.5, k, v, bias))
        out = window_reverse(out, ws, H, W).permute(0, 3, 1, 2)
        return torch.roll(out, (s, s), (2, 3)) if s else out


def _reference_points(hk: int, wk: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """The sample grid's cell centres in [-1, 1], ``[n, hk, wk, 2]`` (y, x)."""
    ry = torch.linspace(0.5, hk - 0.5, hk, device=like.device) / hk * 2 - 1
    rx = torch.linspace(0.5, wk - 0.5, wk, device=like.device) / wk * 2 - 1
    return torch.stack(torch.meshgrid(ry, rx, indexing="ij"), -1)[None].expand(n, hk, wk, 2)


class _DeformableAttention(nn.Module):
    """DAT's deformable attention: offsets predicted from the grouped queries
    (a depthwise convolution of kernel ``[9, 7, 5, 3][stage]``, LayerNorm,
    exact GELU, a 1x1 convolution to (dy, dx); ``tanh``-bounded where
    ``offset_range_factor`` is positive), keys and values projected from the
    map bilinearly sampled at the deformed points, and with ``use_pe`` a
    bias sampled from ``rpe_table`` at each query's displacement."""

    def __init__(self, dim: int, heads: int, n_groups: int, stride: int, off_factor: float,
                 use_pe: bool, stage: int, res: int, *, generator: torch.Generator):
        super().__init__()
        g, gc, kk = generator, dim // n_groups, (9, 7, 5, 3)[stage]
        self.heads, self.n_groups = heads, n_groups
        self.off_factor, self.use_pe = off_factor, use_pe
        self.proj_q = Conv2d(dim, dim, generator=g)
        self.proj_k = Conv2d(dim, dim, generator=g)
        self.proj_v = Conv2d(dim, dim, generator=g)
        self.proj_out = Conv2d(dim, dim, generator=g)
        self.conv_offset = _indexed(
            _0=Conv2d(gc, gc, kk, stride=stride, padding=kk // 2, groups=gc, generator=g),
            _1=_LayerNormProxy(gc), _3=Conv2d(gc, 2, bias=False, generator=g))
        if use_pe:
            self.rpe_table = nn.Parameter(normal_(torch.empty(heads, 2 * res - 1, 2 * res - 1),
                                                  0.01, g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        heads, ng = self.heads, self.n_groups
        hd, gc, gh = C // heads, C // ng, heads // ng
        q = self.proj_q(x)
        co = self.conv_offset
        off = co["1"](co["0"](q.reshape(B * ng, gc, H, W)))
        off = co["3"](F.gelu(off))
        Hk, Wk = off.shape[2:]
        n = Hk * Wk
        if self.off_factor > 0:
            rng = off.new_empty(1, 2, 1, 1)
            rng[:, 0], rng[:, 1] = 1.0 / Hk, 1.0 / Wk
            off = torch.tanh(off) * rng * self.off_factor
        off = off.permute(0, 2, 3, 1)  # [B·g, Hk, Wk, 2] (y, x)
        reference = _reference_points(Hk, Wk, B * ng, x)
        pos = off + reference if self.off_factor >= 0 else torch.tanh(off + reference)
        sampled = grid_sample_bilinear(x.reshape(B * ng, gc, H, W), pos.flip(-1))
        sampled = sampled.reshape(B, C, 1, n)
        qf = q.reshape(B * heads, hd, H * W)
        kf = self.proj_k(sampled).reshape(B * heads, hd, n)
        vf = self.proj_v(sampled).reshape(B * heads, hd, n)
        attn = torch.einsum("bcm,bcn->bmn", qf, kf) * hd ** -0.5
        if self.use_pe:
            rpe = self.rpe_table[None].expand(B, -1, -1, -1).reshape(B * ng, gh, 2 * H - 1,
                                                                     2 * W - 1)
            q_grid = _reference_points(H, W, B * ng, x).reshape(B * ng, H * W, 1, 2)
            disp = (q_grid - pos.reshape(B * ng, 1, n, 2)) * 0.5
            attn = attn + grid_sample_bilinear(rpe, disp.flip(-1)).reshape(B * heads, H * W, n)
        out = torch.einsum("bmn,bcn->bcm", torch.softmax(attn, 2), vf).reshape(B, C, H, W)
        return self.proj_out(out)


class _DATMlp(nn.Module):
    """DAT's token MLP on NCHW maps (``chunk.linear1``, ``chunk.linear2``)."""

    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator):
        super().__init__()
        self.chunk = nn.ModuleDict({"linear1": TorchLinear(dim, hidden, generator=generator),
                                    "linear2": TorchLinear(hidden, dim, generator=generator)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        t = x.reshape(B, C, -1).transpose(1, 2)
        t = self.chunk["linear2"](F.gelu(self.chunk["linear1"](t), approximate="tanh"))
        return t.transpose(1, 2).reshape(B, C, H, W)


class _DATStage(nn.Module):
    """A DAT stage: ``proj`` where the width changes, then a block a letter
    of its spec (``layer_norms.2d``, ``attns.d``, ``layer_norms.2d+1``,
    ``mlps.d``), each part residual."""

    def __init__(self, dim_in: int, dim: int, attns, expansion: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.proj = Conv2d(dim_in, dim, generator=generator) if dim_in != dim else None
        self.layer_norms = nn.ModuleList(_LayerNormProxy(dim) for _ in range(2 * len(attns)))
        self.attns = nn.ModuleList(attns)
        self.mlps = nn.ModuleList(_DATMlp(dim, dim * expansion, generator=generator)
                                  for _ in attns)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        if self.proj is not None:
            y = self.proj(y)
        for d, (attn, mlp) in enumerate(zip(self.attns, self.mlps)):
            y = attn(self.layer_norms[2 * d](y)) + y
            y = mlp(self.layer_norms[2 * d + 1](y)) + y
        return y


class DAT(nn.Module):
    """DAT (vision transformer with deformable attention): four stages of
    local (``L``), shifted-window (``S``) and deformable (``D``) attention
    blocks, each followed by an MLP, with 2x2 strided downsampling between
    them. NCHW images -> ``[B, num_classes]``. A stage has a block a letter
    of ``stage_spec``; ``depths`` is kept for the signature and unused, as
    in the JAX package."""

    def __init__(self, img_size: int = 224, patch_size: int = 4, num_classes: int = 1000,
                 expansion: int = 4, dim_stem: int = 96, dims=(96, 192, 384, 768),
                 depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), window_sizes=(7, 7, 7, 7),
                 strides=(-1, -1, 1, 1), offset_range_factor=(-1, -1, 2, 2),
                 stage_spec=(("L", "S"), ("L", "S"), ("L", "D"), ("L", "D")),
                 groups=(-1, -1, 3, 6), use_pes=(False, False, True, True), *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.patch_proj = _indexed(_0=Conv2d(3, dim_stem, patch_size, stride=patch_size,
                                             generator=g), _1=_LayerNormProxy(dim_stem))
        res = img_size // patch_size
        self.stages = nn.ModuleList()
        for i in range(4):
            dim, ws, r = dims[i], window_sizes[i], res // 2 ** i
            attns = []
            for spec in stage_spec[i]:
                if spec in ("L", "S"):
                    shift = math.ceil(ws / 2) if spec == "S" else 0
                    attns.append(_LocalAttention(dim, heads[i], ws, r, shift, generator=g))
                elif spec == "D":
                    attns.append(_DeformableAttention(
                        dim, heads[i], groups[i], strides[i], offset_range_factor[i],
                        use_pes[i], i, r, generator=g))
                else:
                    raise ValueError(f"DAT stage_spec letter {spec!r}, not L, S or D")
            dim_in = dim_stem if i == 0 else dims[i - 1] * 2
            self.stages.append(_DATStage(dim_in, dim, attns, expansion, generator=g))
        self.down_projs = nn.ModuleList(
            _indexed(_0=Conv2d(dims[i], dims[i + 1], 2, stride=2, bias=False, generator=g),
                     _1=_LayerNormProxy(dims[i + 1])) for i in range(3))
        self.cls_norm = _LayerNormProxy(dims[-1])
        self.cls_head = TorchLinear(dims[-1], num_classes, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.patch_proj["1"](self.patch_proj["0"](x))
        for i, stage in enumerate(self.stages):
            y = stage(y)
            if i < 3:
                y = self.down_projs[i]["1"](self.down_projs[i]["0"](y))
        return self.cls_head(self.cls_norm(y).mean((2, 3)))
