"""FLOP counts of a computation and their share of the H100's peak
(counterpart of ``ser_tpu/utils/flops.py``).

``count_flops(fn, *args)`` runs ``fn(*args)`` once under
``torch.utils.flop_counter.FlopCounterMode`` and returns the floating-point
operations it counted, the backward's too where ``fn`` runs one. The counter
counts matrix products (``mm``, ``bmm``, ``addmm``, ``matmul``'s forms),
convolutions and attention (``scaled_dot_product_attention``): 2 FLOPs a
multiply-add. It does not count elementwise ops, reductions or softmaxes,
which XLA's cost analysis (the JAX function's source) does count, and it
counts every step of a loop, where XLA's counts a scan's body once whatever
its length; so on a whole model the two packages' totals differ by design.
On matmul-only functions without loops they agree.

The count is taken on the plain path: ``fn``'s tensors must lie on the CPU,
where every wrapper of a hand-written kernel runs its plain PyTorch version
(a ctypes kernel is invisible to the counter). So the count is the same work
whichever implementation runs it on the card, and a time measured on the
card divides it. A CUDA tensor among the arguments raises ``ValueError``.

The peaks are the NVIDIA H100 SXM5's dense rates from its data sheet, the
card that ``nvidia-smi`` names NVIDIA H100 80GB HBM3, at its 700 W limit:
FP32 66.9 TFLOP/s (no tensor cores, the port's parity setting: TF32 off),
TF32 494.7 and BF16 989.4 (tensor cores, dense).
"""

from __future__ import annotations

import torch

# NVIDIA H100 80GB HBM3 (SXM5) at 700 W, dense, data sheet
H100_SXM_F32_PEAK_TFLOPS = 66.9
H100_SXM_TF32_PEAK_TFLOPS = 494.7
H100_SXM_BF16_PEAK_TFLOPS = 989.4


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def count_flops(fn, *args) -> int:
    """The FLOPs ``FlopCounterMode`` counts in one call of ``fn(*args)``,
    run on the CPU (see the module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    if any(t.is_cuda for t in _tensors(args)):
        raise ValueError("count_flops runs the plain path: give it CPU tensors (a "
                         "hand-written kernel's work is invisible to the counter)")
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def efficiency(flops, seconds, peak_tflops=H100_SXM_F32_PEAK_TFLOPS):
    """``{flops_per_pass, tflops_effective, pct_f32_peak}`` of one pass of
    ``flops`` in ``seconds`` against ``peak_tflops``, or ``{}`` where either
    is unknown."""
    if not flops or not seconds or seconds <= 0:
        return {}
    tf = flops / seconds / 1e12
    return {
        "flops_per_pass": flops,
        "tflops_effective": round(tf, 3),
        "pct_f32_peak": round(100.0 * tf / peak_tflops, 2),
    }
