"""Per-step rank-1 cross attention of the recurrences, with dropout in
train: the CUDA kernel's wrapper, its autograd binding and its plain
version.

Counterpart of ``ser_tpu/ops/attention.py::_rank1_fused_impl`` (fused XLA
under ``jax.checkpoint`` in the JAX package) and its analytic backward
``_rank1_vjp_bwd``, for both recurrence directions at once::

    x1 = c_l, x2 = c_a   [2, B, D] f32 or bf16, D = 128
    wq, wk               [2, D], of x1's dtype
    seed                 [1] int32 on the same device; step an int; p a float
    returns z            [2, B, D], of x1's dtype

The kernel is ``csrc/rank1_attention.cu``, one launch each way; its source
note gives the design and what bounds it. It is built for f32 and for bf16
(a ``--compute_dtype bf16`` train step), each counted under its own name in
``LAUNCHES`` (``NAME``, ``NAME_BF16``); the bf16 form widens its inputs to
f32, computes as the f32 one and rounds each output once, as the plain bf16
form (``ops.attention.rank1_cross_attention_train``) does. Any other dtype,
or dtypes that differ between the tensors, raises. ``bind`` checks wq, wk, the seed
and p once for a whole train recurrence (``Rank1Kernel``), so a step checks
only x1 and x2. Its forward keeps only x1, x2, wq, wk and the seed: the
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
NAME_BF16 = "rank1_attention_bf16"
# dtype -> (launch counter, C symbol suffix)
_FORMS = {torch.float32: (NAME, ""), torch.bfloat16: (NAME_BF16, "_bf16")}
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
    ``ops.attention.rank1_cross_attention_train`` on the kernel's mask (for
    bf16 inputs its bf16 form: f32 inside, z rounded once)."""
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


def _refuse(name, t, shape, dtype, device):
    """Raise ValueError naming what of ``t`` the kernel does not take."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, kernel takes "
                         f"{dtype} {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the kernel's tensors on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _takes(t, shape, device, dtype) -> bool:
    return (t.dtype is dtype and t.shape == shape and t.device == device
            and t.is_contiguous())


def _form_dtype(name, t) -> torch.dtype:
    """``t``'s dtype if the kernel is built for it; raises ValueError else."""
    if t.dtype not in _FORMS:
        raise ValueError(f"{name}: {t.dtype}, the kernel takes torch.float32 or "
                         "torch.bfloat16")
    return t.dtype


def check_consts(wq, wk, seed) -> None:
    """wq, wk [2, D] of one dtype, f32 or bf16, and the seed [1] int32,
    contiguous, on one device; raises ValueError on anything else."""
    dtype = _form_dtype("wq", wq)
    for name, t, shape, want in (("wq", wq, (2, D), dtype), ("wk", wk, (2, D), dtype),
                                 ("seed", seed, (1,), torch.int32)):
        _refuse(name, t, shape, want, wq.device)


def check_inputs(x1, x2, g=None, device=None, dtype=None) -> int:
    """B of ``x1``, which with x2 and g must be [2, B, D] of ``dtype`` (x1's
    when None, f32 or bf16), contiguous and on ``device`` (x1's when None);
    raises ValueError on anything else."""
    shape = x1.shape
    if not (len(shape) == 3 and shape[0] == 2 and shape[2] == D and shape[1] >= 1):
        raise ValueError(f"x1 must be [2, B>=1, {D}], got {tuple(shape)}")
    device = x1.device if device is None else device
    dtype = _form_dtype("x1", x1) if dtype is None else dtype
    for name, t in (("x1", x1), ("x2", x2), ("g", g)):
        if t is not None and not _takes(t, shape, device, dtype):
            _refuse(name, t, shape, dtype, device)
    return shape[1]


# the backward's scratch (dwq, dwk parts [2, 2, B, D], f32 in both forms) and
# its two-int ticket, made once per (device, B, dtype); the kernel leaves the
# ticket at 0
_SCRATCH: dict[tuple[int, int, torch.dtype], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, B: int, dtype: torch.dtype):
    key = (device.index, B, dtype)
    if key not in _SCRATCH:
        _SCRATCH[key] = (torch.empty((2, 2, B, D), dtype=torch.float32, device=device),
                         torch.zeros(2, dtype=torch.int32, device=device))
    return _SCRATCH[key]


class Rank1Kernel:
    """The kernel bound to one train recurrence's wq, wk, seed and p, which
    are checked once here; wq's dtype (f32 or bf16) picks the kernel's form,
    and x1, x2 and g must have it too. A call checks only x1 and x2 (and g
    in the backward) and launches one kernel each way. Differentiable
    through ``__call__``. The backward's scratch is shared by every binding
    of a device, B and dtype, so two backwards of one shape must not run at
    once on two streams."""

    def __init__(self, wq, wk, seed, p: float):
        self.device = wq.device
        if self.device.type != "cuda":
            raise ValueError(f"the rank-1 kernel takes CUDA tensors, wq is on {wq.device}")
        check_consts(wq, wk, seed)
        self.wq, self.wk, self.seed, self.p = wq, wk, seed, p
        self.dtype = wq.dtype
        self.name, suffix = _FORMS[self.dtype]
        self._itemsize = wq.element_size()
        self.threshold, self.keep = keep_threshold(p), 1.0 - p
        self._consts = (wq.data_ptr(), wk.data_ptr(), seed.data_ptr())
        lib = _library()
        self._fwd = getattr(lib, f"rank1_attention_fwd{suffix}")
        self._bwd = getattr(lib, f"rank1_attention_bwd{suffix}")
        # the current stream as a raw handle (CUDA builds of torch), without
        # making a Stream object a call
        index, raw = self.device.index, torch._C._cuda_getCurrentRawStream
        self._stream = lambda: raw(index)

    def check(self, x1, x2, g=None) -> int:
        return check_inputs(x1, x2, g, self.device, self.dtype)

    def _launch(self, fn, *args) -> None:
        if torch.cuda.current_device() == self.device.index:
            err = fn(*args, self._stream())
        else:
            with torch.cuda.device(self.device):
                err = fn(*args, self._stream())
        if err != 0:
            raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
        LAUNCHES[self.name] += 1

    def launch_fwd(self, x1, x2, step: int, z) -> None:
        """The forward into ``z``, with no checks: for inputs ``check`` took."""
        self._launch(self._fwd, x1.data_ptr(), x2.data_ptr(), *self._consts, step,
                     x1.shape[1], self.threshold, self.keep, z.data_ptr())

    def forward(self, x1, x2, step: int):
        """z [2, B, D], one launch."""
        self.check(x1, x2)
        z = torch.empty_like(x1)
        self.launch_fwd(x1, x2, step, z)
        return z

    def launch_bwd(self, x1, x2, step: int, g, dx, dw) -> None:
        """The backward into ``dx`` [2 (dx1, dx2), 2, B, D] and ``dw``
        [2 (dwq, dwk), 2, D], with no checks: for inputs ``check`` took."""
        B, size = x1.shape[1], self._itemsize
        part, ticket = _scratch(self.device, B, self.dtype)
        dx_ptr, dw_ptr = dx.data_ptr(), dw.data_ptr()
        self._launch(self._bwd, x1.data_ptr(), x2.data_ptr(), *self._consts, step, B,
                     self.threshold, self.keep, g.data_ptr(), dx_ptr,
                     dx_ptr + 2 * B * D * size, part.data_ptr(), ticket.data_ptr(),
                     dw_ptr, dw_ptr + 2 * D * size)

    def backward(self, x1, x2, step: int, g):
        """(dx1, dx2, dwq, dwk) from the output gradient g, one launch."""
        B = self.check(x1, x2, g)
        dx = torch.empty((2, 2, B, D), dtype=self.dtype, device=self.device)
        dw = torch.empty((2, 2, D), dtype=self.dtype, device=self.device)
        self.launch_bwd(x1, x2, step, g, dx, dw)
        return (*dx.unbind(0), *dw.unbind(0))

    def __call__(self, x1, x2, step: int) -> torch.Tensor:
        if not torch.is_grad_enabled():  # eval: the forward alone, no graph
            return self.forward(x1, x2, step)
        return _Rank1Function.apply(x1, x2, self.wq, self.wk, self, step)


class _Rank1Function(torch.autograd.Function):
    """The kernel under autograd: the forward saves x1 and x2 (wq, wk and the
    seed stay with the binding); the backward is the kernel's backward."""

    @staticmethod
    def forward(ctx, x1, x2, wq, wk, kernel, step):
        ctx.save_for_backward(x1, x2)
        ctx.kernel, ctx.step = kernel, step
        return kernel.forward(x1, x2, step)

    @staticmethod
    def backward(ctx, g):
        x1, x2 = ctx.saved_tensors
        return (*ctx.kernel.backward(x1, x2, ctx.step, g.contiguous()), None, None)


@functools.cache
def _library() -> ctypes.CDLL:
    from ser_tpu_torch.ops.kernels.build import load

    lib = load(NAME)
    # every pointer and the stream as c_void_p, or ctypes cuts them to 32 bits
    for _, suffix in _FORMS.values():
        getattr(lib, f"rank1_attention_fwd{suffix}").argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                                     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        getattr(lib, f"rank1_attention_bwd{suffix}").argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                                     ctypes.c_float] + [ctypes.c_void_p] * 8)
        for way in ("fwd", "bwd"):
            getattr(lib, f"rank1_attention_{way}{suffix}").restype = ctypes.c_int
    lib.rank1_attention_occupancy.argtypes = [ctypes.c_void_p]
    lib.rank1_attention_occupancy.restype = ctypes.c_int
    return lib


def occupancy() -> dict[str, int]:
    """The kernels' launch shape on the current device: the forward's threads
    a block and blocks a (row, direction), the backward's threads a block
    (one block a row and direction) and dynamic shared memory, and the
    blocks an SM holds of each kernel."""
    out = (ctypes.c_int * 6)()
    err = _library().rank1_attention_occupancy(out)
    if err != 0:
        raise RuntimeError(f"rank1_attention_occupancy failed: CUDA error {err}")
    return {"fwd_threads": out[0], "fwd_split": out[1], "bwd_threads": out[2],
            "bwd_split": 1, "bwd_smem": out[3], "fwd_blocks": out[4],
            "bwd_blocks": out[5]}


def bind(wq, wk, seed, p: float):
    """``attend(x1, x2, step) -> z`` for one recurrence: the kernel
    (``Rank1Kernel``) where wq lies on the card, the plain version on the
    CPU. At p = 0 the train form is the eval form (``den = sum_k e``,
    ``u = e``), so an eval recurrence binds with p = 0 and any constant
    seed; under ``no_grad`` or ``inference_mode`` a call launches the
    forward alone."""
    if wq.device.type == "cuda":
        return Rank1Kernel(wq, wk, seed, p)
    if wq.device.type == "cpu":
        return bind_ref(wq, wk, seed, p)
    raise ValueError(f"no rank-1 attention for device {wq.device}")


def bind_ref(wq, wk, seed, p: float):
    """The plain version bound as ``bind`` binds the kernel, on any device."""
    return lambda x1, x2, step: rank1_attention_ref(x1, x2, wq, wk, seed, step, p)


def rank1_attention(x1, x2, wq, wk, seed, step: int, p: float) -> torch.Tensor:
    """The train-step rank-1 attention of both directions, differentiable.
    On CUDA tensors this launches the kernel (forward here, backward under
    autograd) or raises; on CPU tensors it runs the plain version."""
    dev = x1.device
    if dev.type == "cuda":
        return Rank1Kernel(wq, wk, seed, p)(x1, x2, step)
    if dev.type == "cpu":
        return rank1_attention_ref(x1, x2, wq, wk, seed, step, p)
    raise ValueError(f"no rank-1 attention for device {dev}")
