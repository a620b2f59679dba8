"""Per-step rank-1 cross attention of the train recurrence, with dropout:
the CUDA kernel's wrapper, its autograd binding and its plain version.

Counterpart of ``ser_tpu/ops/attention.py::_rank1_fused_impl`` (fused XLA
under ``jax.checkpoint`` in the JAX package) and its analytic backward
``_rank1_vjp_bwd``, for both recurrence directions at once::

    x1 = c_l, x2 = c_a   [2, B, D] f32, D = 128
    wq, wk               [2, D] f32
    seed                 [1] int32 on the same device; step an int; p a float
    returns z            [2, B, D]

The kernel is ``csrc/rank1_attention.cu``; its source note gives the design
and what bounds it. Its forward saves only x1, x2, wq, wk and the seed: the
backward recomputes ``e`` and regenerates the dropout mask, so no
``[2, B, D, D]`` tensor is kept for a step. The mask is a pure function of
(seed, step, direction, b, i, k), a murmur3 ``fmix32`` hash that
``keep_mask`` computes here bit for bit with int64 ops, so the kernel and its
plain version drop the same entries on the card and on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ser_tpu_torch.ops.attention import rank1_cross_attention_train
from ser_tpu_torch.ops.kernels import LAUNCHES

NAME = "rank1_attention"
D = 128
FMIX_M1 = 0x85EBCA6B
FMIX_M2 = 0xC2B2AE35
SALT = 0x9E3779B9
SCALE = 1.0 / D ** 0.5
_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``h * c`` for int64 ``h`` in [0, 2^32): the product
    taken in 16-bit halves of ``c``, so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, FMIX_M1)
    h = h ^ (h >> 13)
    h = _mul32(h, FMIX_M2)
    return h ^ (h >> 16)


def keep_threshold(p: float) -> int:
    """An entry is kept where its hash is at least ``floor(p * 2^32)``."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} is not in [0, 1)")
    return int(p * 2 ** 32)


def mask_hashes(seed: torch.Tensor, step: int, B: int) -> torch.Tensor:
    """The kernel's 32-bit hashes, int64 ``[2, B, D, D]`` over (direction,
    b, i, k) for ``seed`` (an int32 tensor of one element) at ``step``."""
    dev = seed.device
    seed = seed.reshape(()).to(torch.int64) & _MASK32
    d = torch.arange(2, device=dev)
    step_key = fmix32((seed + fmix32((2 * step + d + SALT) & _MASK32)) & _MASK32)
    row = (torch.arange(B, device=dev)[:, None] * D
           + torch.arange(D, device=dev)[None, :])
    row_key = fmix32((step_key[:, None, None] + fmix32((row + SALT) & _MASK32))
                     & _MASK32)
    return fmix32(row_key[..., None] ^ torch.arange(D, device=dev))


def keep_mask(seed: torch.Tensor, step: int, B: int, p: float) -> torch.Tensor:
    """The kernel's keep mask, bool ``[2, B, D, D]`` (direction, b, i, k)."""
    return mask_hashes(seed, step, B) >= keep_threshold(p)


def rank1_attention_ref(x1, x2, wq, wk, seed, step: int, p: float):
    """Plain PyTorch version, differentiable by autograd: the train form
    ``ops.attention.rank1_cross_attention_train`` on the kernel's mask."""
    keep = None if p == 0.0 else keep_mask(seed, step, x1.shape[1], p)
    return rank1_cross_attention_train(x1, x2, wq, wk, keep, p)


def rank1_attention_bwd_ref(x1, x2, wq, wk, seed, step: int, p: float, g):
    """The kernel's backward algebra in PyTorch (``_rank1_vjp_bwd`` over the
    direction axis): ``(dx1, dx2, dwq, dwk)`` from the output gradient g,
    with e recomputed and the mask regenerated."""
    wq_, wk_ = wq[:, None, :], wk[:, None, :]
    s = (x2 * wq_).sum(-1, keepdim=True) * SCALE
    alpha = x1 * s
    m = torch.where(alpha > 0, alpha * wk_.amax(-1, keepdim=True),
                    alpha * wk_.amin(-1, keepdim=True))
    e = torch.exp(alpha[..., None] * wk[:, None, None, :] - m[..., None])
    den = e.sum(-1)
    u = e if p == 0.0 else torch.where(
        keep_mask(seed, step, x1.shape[1], p), e / (1.0 - p), 0.0)
    out = (u * x2[..., None, :]).sum(-1) / den
    gn = g / den
    gd = -g * out / den
    A2 = (u * (x2 * wk_)[..., None, :]).sum(-1)
    A3 = (e * wk[:, None, None, :]).sum(-1)
    dalpha = gn * A2 + gd * A3
    B1 = (gn[..., None] * u).sum(-2)
    B2 = ((gn * alpha)[..., None] * u).sum(-2)
    B3 = ((gd * alpha)[..., None] * e).sum(-2)
    ds = (dalpha * x1).sum(-1, keepdim=True)
    return (dalpha * s, B1 + ds * (SCALE * wq_), SCALE * (ds * x2).sum(1),
            (x2 * B2 + B3).sum(1))


def _check(x1, x2, wq, wk, seed, g=None):
    B = x1.shape[1] if x1.ndim == 3 else 0
    want = {"x1": ((2, B, D), torch.float32), "x2": ((2, B, D), torch.float32),
            "wq": ((2, D), torch.float32), "wk": ((2, D), torch.float32),
            "seed": ((1,), torch.int32)}
    tensors = [x1, x2, wq, wk, seed]
    if g is not None:
        want["g"] = ((2, B, D), torch.float32)
        tensors.append(g)
    if B < 1:
        raise ValueError(f"x1 must be [2, B>=1, {D}], got {tuple(x1.shape)}")
    for (name, (shape, dtype)), t in zip(want.items(), tensors):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, kernel takes "
                             f"{dtype} {shape}")
        if t.device != x1.device:
            raise ValueError(f"{name} on {t.device}, x1 on {x1.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _launch_fwd(x1, x2, wq, wk, seed, step, p):
    _check(x1, x2, wq, wk, seed)
    z = torch.empty_like(x1)
    with torch.cuda.device(x1.device):
        err = _library().rank1_attention_fwd(
            *(t.data_ptr() for t in (x1, x2, wq, wk, seed)), step, x1.shape[1],
            keep_threshold(p), 1.0 - p, z.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rank1_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES[NAME] += 1
    return z


def _launch_bwd(x1, x2, wq, wk, seed, step, p, g):
    _check(x1, x2, wq, wk, seed, g)
    B = x1.shape[1]
    dx1, dx2 = torch.empty_like(x1), torch.empty_like(x2)
    dwq, dwk = torch.empty_like(wq), torch.empty_like(wk)
    part = torch.empty((2, 2, B, D), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        err = _library().rank1_attention_bwd(
            *(t.data_ptr() for t in (x1, x2, wq, wk, seed)), step, B,
            keep_threshold(p), 1.0 - p,
            *(t.data_ptr() for t in (g, dx1, dx2, part, dwq, dwk)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rank1_attention_bwd launch failed: CUDA error {err}")
    LAUNCHES[NAME] += 1
    return dx1, dx2, dwq, dwk


class Rank1Attention(torch.autograd.Function):
    """The kernel under autograd: the forward saves x1, x2, wq, wk and the
    seed; the backward is the kernel's backward."""

    @staticmethod
    def forward(ctx, x1, x2, wq, wk, seed, step, p):
        ctx.save_for_backward(x1, x2, wq, wk, seed)
        ctx.step, ctx.p = step, p
        return _launch_fwd(x1, x2, wq, wk, seed, step, p)

    @staticmethod
    def backward(ctx, g):
        x1, x2, wq, wk, seed = ctx.saved_tensors
        grads = _launch_bwd(x1, x2, wq, wk, seed, ctx.step, ctx.p,
                            g.contiguous())
        return (*grads, None, None, None)


@functools.cache
def _library() -> ctypes.CDLL:
    from ser_tpu_torch.ops.kernels.build import load

    lib = load(NAME)
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    lib.rank1_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                                 ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    lib.rank1_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                                 ctypes.c_float] + [ctypes.c_void_p] * 7)
    for fn in (lib.rank1_attention_fwd, lib.rank1_attention_bwd):
        fn.restype = ctypes.c_int
    return lib


def rank1_attention(x1, x2, wq, wk, seed, step: int, p: float) -> torch.Tensor:
    """The train-step rank-1 attention of both directions, differentiable.
    On CUDA tensors this launches the kernel (forward here, backward under
    autograd) or raises; on CPU tensors it runs the plain version."""
    dev = x1.device
    if dev.type == "cuda":
        return Rank1Attention.apply(x1, x2, wq, wk, seed, step, p)
    if dev.type == "cpu":
        return rank1_attention_ref(x1, x2, wq, wk, seed, step, p)
    raise ValueError(f"no rank-1 attention for device {dev}")
